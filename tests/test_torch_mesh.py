"""Twins of ``tests/test_mesh.py``'s ``test_device_count`` and
``test_resolve_mesh_shape`` for the port's mesh (``trlx_tpu_torch.parallel.mesh``),
the process groups of every axis against the JAX mesh's device order, and
``ppo_long_config.yml``'s own [1, 2, 2, -1] accepted."""

import os

import jax
import numpy as np
import pytest

from trlx_tpu.parallel.mesh import resolve_mesh_shape as jax_resolve
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.parallel import mesh as port_mesh
from trlx_tpu_torch.trainer.base import refuse_unported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_count():
    """The JAX tests run on 8 virtual CPU devices; the port's devices are
    the processes of its group: one here, and a prebuilt LocalSpGroup mesh
    counts its own ranks."""
    assert jax.device_count() == 8
    assert port_mesh.world_size() == 1 and port_mesh.process_rank() == 0 and port_mesh.is_main_process()
    mesh = port_mesh.make_mesh((1, 1, 1, -1), sp_group=port_mesh.LocalSpGroup(8))
    assert mesh.shape == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 8} and mesh.size == 8
    assert port_mesh.make_mesh().shape == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}


def test_resolve_mesh_shape():
    r = port_mesh.resolve_mesh_shape
    assert r((-1, 1, 1, 1), 8) == (8, 1, 1, 1)
    assert r((2, -1, 2, 1), 8) == (2, 2, 2, 1)
    with pytest.raises(ValueError):
        r((3, 1, 1, 1), 8)
    with pytest.raises(ValueError):
        r((-1, -1, 1, 1), 8)
    for shape in ((-1, 1, 1, 1), (1, 1, 1, -1), (2, -1, 2, 1), (1, 2, 2, -1), (4, 1, 1, 2)):
        assert r(shape, 8) == jax_resolve(shape, 8)
    assert r((-1, 1, 1, 1)) == (1, 1, 1, 1)  # this process alone


@pytest.mark.parametrize("shape", [(2, 1, 1, 1), (1, 2, 1, 1), (1, 1, 2, 1), (2, 1, 1, 2), (-1, 1, 1, 1)])
def test_make_mesh_lays_out_every_axis(shape):
    """Every axis builds: the process groups of each axis are the JAX
    mesh's device ids along it (the ranks a process mesh of that shape
    joins; ``tests/test_torch_dist.py`` runs them), and a LocalSpGroup, which
    plays sp ranks in one process, takes no other axis."""
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh

    n = int(np.prod(shape)) if -1 not in shape else 4
    resolved = port_mesh.resolve_mesh_shape(shape, n)
    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(resolved, devices=jax.devices()[:n]).devices)
    lines = port_mesh.axis_lines(resolved)
    for i, axis in enumerate(port_mesh.MESH_AXES):
        if resolved[i] > 1:
            assert sorted(lines[axis]) == sorted(np.moveaxis(ids, i, -1).reshape(-1, resolved[i]).tolist()), axis
    if any(s > 1 for s in resolved[:3]):
        with pytest.raises(ValueError, match="LocalSpGroup"):
            port_mesh.make_mesh(shape, sp_group=port_mesh.LocalSpGroup(n))


def test_ppo_long_config_mesh_is_accepted():
    """``ppo_long_config.yml`` asks for dp 1, fsdp 2, tp 2: accepted before
    anything is built (the port shards over every axis), and its sp-only
    form too."""
    config = TRLConfig.load_yaml(os.path.join(ROOT, "trlx_tpu_torch", "configs", "ppo_long_config.yml"))
    assert tuple(config.train.mesh) == (1, 2, 2, -1)
    refuse_unported(config)
    assert port_mesh.resolve_mesh_shape(config.train.mesh, 8) == jax_resolve(config.train.mesh, 8) == (1, 2, 2, 2)
    config.train.mesh = (1, 1, 1, -1)
    refuse_unported(config)


def test_host_collectives_are_identities_for_one_process():
    x = np.arange(6).reshape(3, 2)
    assert port_mesh.broadcast_host({"a": 1}) == {"a": 1}
    np.testing.assert_array_equal(port_mesh.allgather_host(x), x)
    port_mesh.barrier()
    port_mesh.init_distributed()  # no WORLD_SIZE: a no-op
    assert port_mesh.world_size() == 1
