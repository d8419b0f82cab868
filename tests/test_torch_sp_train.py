"""``train()`` with ``train.mesh = [1, 1, 1, 2]``: sequence parallelism end to
end, against the port's single-device run and the JAX package's sp = 2 run.

The same tiny config (3 layers, remat, train sequences of 16 tokens: the
zig-zag ring at sp = 2), token prompts, forced-bigram logit mask (one
allowed successor a token, so sampling takes the same path in both
packages though their random streams differ) and initial weights (the JAX
trainer's) go through

- ``trlx_tpu.train`` on a (4, 1, 1, 2) mesh of the conftest's 8 CPU devices;
- ``trlx_tpu_torch.train`` on one device (mesh [1, 1, 1, 1]);
- ``trlx_tpu_torch.train`` on a ``LocalSpGroup(2)`` mesh (both ranks in this
  process);
- ``trlx_tpu_torch.train`` on a gloo group of 2 processes
  (``tests/torch_sp_worker.py``, ``tests/torch_sp_train_case.py``), whose
  ranks must end with bit-equal parameters (every rank's optimizer step is
  the same: the ring's entry all-gathers the gradients, nothing is summed).

2 PPO steps: step 1's loss and statistics agree within 1e-5, step 2's within
2e-4 (``tests/test_torch_train.py``'s tolerances: the runs' float32
differences compound over the update). One ILQL run on the same gloo mesh
(the twin of ``tests/test_e2e.py::test_ilql_e2e_on_sharded_mesh``, 3 steps)
against the port's single-device ILQL run, the same tolerances.
"""

import jax
import numpy as np
import pytest
import torch

import torch_sp_train_case as case
import torch_sp_worker
import trlx_tpu
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.parallel import mesh as port_mesh

torch.set_num_threads(1)

SPAWN_TIMEOUT = 300.0


def _tol(step):
    return 1e-5 if step == 1 else 2e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp_train")
    t = case.task()
    jax_cfg = case.ppo_config(str(root / "jax"), (4, 1, 1, 2))
    init = JaxPPOTrainer(JaxTRLConfig.from_dict(jax_cfg))
    data = dict(task=t, params=jax.device_get(init.state.params), extras=jax.device_get(init.state.extras),
                dir=str(root))
    del init
    jax_model = trlx_tpu.train(reward_fn=case.reward_fn, prompts=t["prompts"], eval_prompts=t["eval_prompts"],
                               config=JaxTRLConfig.from_dict(jax_cfg), logit_mask=t["logit_mask"])
    out = {"jax": {"stats": case.step_stats(str(root / "jax" / "metrics.jsonl"), case.PPO_STAT_KEYS),
                   "iter_count": jax_model.iter_count}}
    prior = port_mesh.peek_mesh()
    try:
        out["single"] = case.run_ppo(data, str(root / "single"), (1, 1, 1, 1))
        out["local2"] = case.run_ppo(data, str(root / "local2"), (1, 1, 1, 2),
                                     mesh=port_mesh.make_mesh((1, 1, 1, 2), sp_group=port_mesh.LocalSpGroup(2)))
        out["ilql_single"] = case.run_ilql(data, str(root / "ilql_single"), (1, 1, 1, 1))
    finally:
        port_mesh.set_mesh(prior)
    out["gloo2"] = torch_sp_worker.spawn("train", 2, data, str(root / "gloo"), SPAWN_TIMEOUT)
    return out


def _close_stats(got, ref, keys, steps):
    assert sorted(got) == sorted(ref) == list(range(1, steps + 1))
    for step in range(1, steps + 1):
        for k in keys:
            np.testing.assert_allclose(got[step][k], ref[step][k], rtol=_tol(step), atol=_tol(step),
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("variant", ["local2", "gloo2"])
def test_ppo_sp2_matches_single_device_and_jax(runs, variant):
    got = runs[variant] if variant == "local2" else runs[variant][0]["ppo"]
    assert got["iter_count"] == runs["single"]["iter_count"] == runs["jax"]["iter_count"] == case.STEPS
    _close_stats(got["stats"], runs["single"]["stats"], case.PPO_STAT_KEYS, case.STEPS)
    _close_stats(got["stats"], runs["jax"]["stats"], case.PPO_STAT_KEYS, case.STEPS)
    assert got["stats"][2]["learning_rate"] > 0 and got["stats"][2]["loss"] != got["stats"][1]["loss"]


def test_ranks_hold_equal_parameters(runs):
    """Both gloo ranks end with the same parameters bit for bit, each step
    was logged once (``step_stats`` raises on a second writer), and the
    parameters sit within 2e-4 of the single-device run's."""
    r0, r1 = (r["ppo"] for r in runs["gloo2"])
    assert r0["stats"] == r1["stats"]  # both read the main process's one file
    for name, p in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][name], p, err_msg=name)
        np.testing.assert_allclose(p, runs["single"]["params"][name], rtol=2e-4, atol=2e-4, err_msg=name)


def test_ilql_on_sp_mesh(runs):
    """ILQL inherits the mesh through the trainer base: 3 steps on the gloo
    mesh, ranks bit-equal, statistics as the single-device run's."""
    r0, r1 = (r["ilql"] for r in runs["gloo2"])
    assert r0["iter_count"] == r1["iter_count"] == runs["ilql_single"]["iter_count"] == 3
    for name, p in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][name], p, err_msg=name)
    _close_stats(r0["stats"], runs["ilql_single"]["stats"], case.ILQL_STAT_KEYS, 3)
