"""The trainer's progress line (``BaseTrainer.progress_line``) against the
JAX package's (``JaxBaseTrainer.progress_line``).

- For the same ``iter_count``, ``total_steps``, phase window and
  ``stats_host``, on a terminal the port writes the JAX line byte for byte;
  the fleet part (``hosts=… skew=…ms``) is the port's own with several
  processes.
- On a file or a pipe each logged step writes one line.
- ``TRLX_TPU_NO_PROGRESS`` silences it, a non-main rank prints nothing, and
  no tensor is read.
- ``train()`` on the CPU prints one line per logged step.
"""

import io
import sys
import types

import numpy as np
import pytest
import torch

from trlx_tpu.trainer.base import JaxBaseTrainer
from trlx_tpu_torch.trainer import base as torch_base
from trlx_tpu_torch.trainer.base import BaseTrainer


class _Tty(io.StringIO):
    def isatty(self):
        return True


PHASE = {"time/rollout_s": 12.25, "time/score_s": 0.5, "time/train_s": 6.0, "time/overlap_fraction": 0.375,
         "exp_per_sec": 1.2345678, "train_tokens_per_s": 20480.0, "obs/bubble_fraction": 0.112}
CASES = {
    "step_only": (None, {"loss": 0.123456, "samples_per_sec": 12.9, "step_time": 0.62}),
    "with_window": (PHASE, {"loss": -1.5e-5, "samples_per_sec": 12.9}),
    "eval_step": (PHASE, {"loss": 2.0, "mean_reward": -0.75, "mean_kl": 0.0123, "metrics/optimality": 0.8125,
                          "samples_per_sec": 3.0, "train_batch_fill": 0.96, "obs/bubble_fraction": 0.5}),
    "overrides_window": (PHASE, {"loss": 1.0, "exp_per_sec": 9.0, "time/train_s": 1.0}),
}


def _trainer(phase, fleet=None, iter_count=7, total_steps=16):
    return types.SimpleNamespace(iter_count=iter_count, total_steps=total_steps, _last_phase_stats=phase,
                                 _fleet=fleet)


def _line(cls, trainer, stats, stream, monkeypatch):
    monkeypatch.setattr(sys, "stderr", stream)
    cls.progress_line(trainer, dict(stats))
    return stream.getvalue()


@pytest.mark.parametrize("case", sorted(CASES))
def test_progress_line_equals_the_jax_line_byte_for_byte(case, monkeypatch):
    monkeypatch.delenv("TRLX_TPU_NO_PROGRESS", raising=False)
    phase, stats = CASES[case]
    port, ref = _trainer(phase), _trainer(phase)
    got = _line(BaseTrainer, port, stats, _Tty(), monkeypatch)
    want = _line(JaxBaseTrainer, ref, stats, _Tty(), monkeypatch)
    assert got == want and got.startswith("step 7/16  ") and got.endswith("\x1b[K\r")
    assert port._progress_open and ref._progress_open


@pytest.mark.parametrize("case", sorted(CASES))
def test_progress_line_on_a_file_is_one_line_a_step(case, monkeypatch):
    monkeypatch.delenv("TRLX_TPU_NO_PROGRESS", raising=False)
    phase, stats = CASES[case]
    want = _line(JaxBaseTrainer, _trainer(phase), stats, _Tty(), monkeypatch)
    stream = io.StringIO()
    port = _trainer(phase)
    _line(BaseTrainer, port, stats, stream, monkeypatch)
    port.iter_count += 1
    _line(BaseTrainer, port, stats, stream, monkeypatch)
    lines = stream.getvalue().split("\n")
    assert lines[0] + "\x1b[K\r" == want and lines[1] == want[:-4].replace("step 7/", "step 8/") and lines[2] == ""
    assert not getattr(port, "_progress_open", False)
    BaseTrainer.end_progress(port)  # a file's lines are already ended
    assert stream.getvalue().count("\n") == 2


def test_the_fleet_part_with_several_processes(monkeypatch):
    monkeypatch.delenv("TRLX_TPU_NO_PROGRESS", raising=False)
    phase, stats = CASES["with_window"]
    want = _line(JaxBaseTrainer, _trainer(phase), stats, _Tty(), monkeypatch)
    one = types.SimpleNamespace(process_count=1, last_skew_ms=5.0)
    assert _line(BaseTrainer, _trainer(phase, fleet=one), stats, _Tty(), monkeypatch) == want
    two = types.SimpleNamespace(process_count=2, last_skew_ms=3.6)
    got = _line(BaseTrainer, _trainer(phase, fleet=two), stats, _Tty(), monkeypatch)
    assert got == want[:-4] + "  hosts=2 skew=4ms\x1b[K\r"


def test_end_progress_ends_an_open_line(monkeypatch):
    monkeypatch.delenv("TRLX_TPU_NO_PROGRESS", raising=False)
    stream = _Tty()
    port = _trainer(None)
    _line(BaseTrainer, port, {"loss": 1.0}, stream, monkeypatch)
    BaseTrainer.end_progress(port)
    BaseTrainer.end_progress(port)
    assert stream.getvalue().endswith("\x1b[K\r\n") and not port._progress_open


def test_no_progress_switch_and_other_ranks_print_nothing(monkeypatch):
    stream = _Tty()
    monkeypatch.setenv("TRLX_TPU_NO_PROGRESS", "1")
    assert _line(BaseTrainer, _trainer(PHASE), {"loss": 1.0}, stream, monkeypatch) == ""
    monkeypatch.delenv("TRLX_TPU_NO_PROGRESS")
    monkeypatch.setattr(torch_base, "is_main_process", lambda: False)
    assert _line(BaseTrainer, _trainer(PHASE), {"loss": 1.0}, stream, monkeypatch) == ""


def test_progress_line_reads_no_tensor(monkeypatch):
    """Only host floats are formatted: a tensor in the phase window under a
    key the line does not print is never read, and no sync runs."""
    monkeypatch.delenv("TRLX_TPU_NO_PROGRESS", raising=False)

    def refuse(*a, **k):
        raise AssertionError("the progress line read a tensor")

    for name in ("item", "tolist", "cpu", "numpy", "__float__", "__format__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    phase = dict(PHASE, **{"engine/decode_s": torch.ones(())})
    out = _line(BaseTrainer, _trainer(phase), {"loss": 0.5, "samples_per_sec": 2.0}, _Tty(), monkeypatch)
    assert "loss=0.5" in out and "exp/s=1.235" in out


def test_train_prints_one_line_per_logged_step(tmp_path, capsys, monkeypatch):
    """``train()`` on the CPU (randomwalks' PPO, cut to 4 steps of which
    2 log): stderr, a capture here and not a terminal, holds one line per
    logged step, and none under ``TRLX_TPU_NO_PROGRESS``."""
    from trlx_tpu_torch.examples import randomwalks

    def config():
        c = randomwalks.base_config("ppo", 21, 10)
        c.train.total_steps, c.train.batch_size, c.train.epochs = 4, 8, 2
        c.train.log_interval, c.train.eval_interval = 2, 4
        c.train.checkpoint_interval, c.train.checkpoint_dir = 10**6, str(tmp_path)
        c.method.num_rollouts, c.method.chunk_size, c.method.ppo_epochs = 16, 16, 1
        return c

    monkeypatch.delenv("TRLX_TPU_NO_PROGRESS", raising=False)
    capsys.readouterr()
    randomwalks.main("ppo", device="cpu", config=config())
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["2/4", "4/4"]
    assert all("loss=" in ln and "samples/s=" in ln for ln in lines)
    assert "reward=" in lines[1] and "optimality=" in lines[1] and "reward=" not in lines[0]
    assert "exp/s=" in lines[1]
    monkeypatch.setenv("TRLX_TPU_NO_PROGRESS", "1")
    randomwalks.main("ppo", device="cpu", config=config())
    assert not [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("step ")]
    assert np.isfinite(float(lines[0].split("loss=")[1].split()[0]))
