"""Non-finite guard for the train step (the counterpart of
``trlx_tpu.resilience.guard``).

A single bad batch (an inf reward, an overflow, a host feeding NaN) must not
poison the parameters or the Adam moments: ``guarded_update`` applies the
optimizer only when the loss and every gradient are finite, and otherwise
leaves parameters, moments and the optimizer's step counts untouched — the
JAX package's ``where``-select — and counts the consecutive skips; the
trainer's resilience flush stops the run after ``train.max_bad_steps``.
"""

from typing import Iterable

import torch


class TrainingDiverged(RuntimeError):
    """Raised when training cannot continue: ``train.max_bad_steps``
    consecutive non-finite steps, or a divergence past
    ``train.max_rollbacks`` watchdog rollbacks."""


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor: every element of every floating tensor is finite."""
    checks = [torch.isfinite(t).all() for t in tensors if t is not None and t.is_floating_point()]
    if not checks:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(checks).all()


def guarded_update(optimizer, params, grads, loss: torch.Tensor, bad_steps: int, group=None):
    """Apply ``optimizer.step(params, grads)`` only when the loss and the
    gradients are finite. Returns ``(bad_steps, finite)``: the consecutive
    skip count (0 after an applied step) and whether the step was applied.
    With ``group`` (every process of a sharded or data-parallel mesh, each
    holding pieces) the flag is the minimum over it, so every rank applies
    or skips together.

    The finite flag is read on the host once per step: a branch in Python
    is the plain way to leave the state untouched, and the device queue
    drains at each step in exchange."""
    flag = all_finite([loss, *grads])
    if group is not None and group.size > 1:
        from trlx_tpu_torch.parallel.collectives import all_reduce

        flag = all_reduce(flag.float(), group, op="min") > 0
    finite = bool(flag.item())
    if not finite:
        return bad_steps + 1, False
    optimizer.step(params, grads)
    return 0, True
