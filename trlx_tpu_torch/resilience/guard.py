"""Non-finite guard for the train step (the counterpart of
``trlx_tpu.resilience.guard``).

A single bad batch (an inf reward, an overflow, a host feeding NaN) must not
poison the parameters or the Adam moments: ``guarded_update`` applies the
optimizer only when the loss and every gradient are finite, and otherwise
leaves parameters, moments and the optimizer's step counts untouched — the
JAX package's ``where``-select — and counts the consecutive skips.
"""

from typing import Iterable

import torch


class TrainingDiverged(RuntimeError):
    """Raised after ``train.max_bad_steps`` consecutive non-finite steps."""


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor: every element of every floating tensor is finite."""
    checks = [torch.isfinite(t).all() for t in tensors if t is not None and t.is_floating_point()]
    if not checks:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(checks).all()


def guarded_update(optimizer, params, grads, loss: torch.Tensor, bad_steps: int):
    """Apply ``optimizer.step(params, grads)`` only when the loss and the
    gradients are finite. Returns ``(bad_steps, finite)``: the consecutive
    skip count (0 after an applied step) and whether the step was applied.

    The finite flag is read on the host once per step: a branch in Python
    is the plain way to leave the state untouched, and the device queue
    drains at each step in exchange."""
    finite = bool(all_finite([loss, *grads]).item())
    if not finite:
        return bad_steps + 1, False
    optimizer.step(params, grads)
    return 0, True


def check_bad_steps(bad_steps: int, max_bad_steps: int, step: int):
    """Stop after ``max_bad_steps`` consecutive skipped updates (0 never
    stops)."""
    if max_bad_steps > 0 and bad_steps >= max_bad_steps:
        raise TrainingDiverged(
            f"{bad_steps} consecutive non-finite train steps (>= train.max_bad_steps={max_bad_steps}) "
            f"around step {step} — persistent numeric blow-up, not a one-off bad batch. Lower the "
            "learning rate, tighten train.grad_clip, or inspect the data; raise train.max_bad_steps "
            "only if skips are expected."
        )
