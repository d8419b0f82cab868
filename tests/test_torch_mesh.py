"""Twins of ``tests/test_mesh.py``'s ``test_device_count`` and
``test_resolve_mesh_shape`` for the port's mesh (``trlx_tpu_torch.parallel.mesh``),
and the port's refusal of every mesh axis but sp: ``train.mesh`` is read,
not ignored, so ``ppo_long_config.yml``'s own [1, 2, 2, -1] raises and names
ROADMAP §A11."""

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
def test_make_mesh_refuses_every_axis_but_sp(shape):
    group = port_mesh.LocalSpGroup(int(np.prod([s for s in shape if s > 0])) if -1 not in shape else 4)
    with pytest.raises(NotImplementedError, match="§A11"):
        port_mesh.make_mesh(shape, sp_group=group)


def test_ppo_long_config_mesh_is_refused():
    """``ppo_long_config.yml`` asks for dp 1, fsdp 2, tp 2: refused by name
    before anything is built; its sp-only form passes the check."""
    config = TRLConfig.load_yaml(os.path.join(ROOT, "trlx_tpu", "configs", "ppo_long_config.yml"))
    assert tuple(config.train.mesh) == (1, 2, 2, -1)
    with pytest.raises(NotImplementedError, match=r"train\.mesh dp/fsdp/tp > 1 \(ROADMAP §A11\)"):
        refuse_unported(config)
    config.train.mesh = (1, 1, 1, -1)
    refuse_unported(config)


def test_host_collectives_are_identities_for_one_process():
    x = np.arange(6).reshape(3, 2)
    assert port_mesh.broadcast_host({"a": 1}) == {"a": 1}
    np.testing.assert_array_equal(port_mesh.allgather_host(x), x)
    port_mesh.barrier()
    port_mesh.init_distributed()  # no WORLD_SIZE: a no-op
    assert port_mesh.world_size() == 1
