"""graftlint for the port — its stdlib-ast static-analysis suite (the
counterpart of ``trlx_tpu.analysis``).

CLI:  ``python -m trlx_tpu_torch.analysis [paths...] [--json] [--select GL001,...] [--list-rules]``

The rule ids are the JAX package's, GL000–GL011, and mean the same hazard;
where the hazard is JAX's the port checks its PyTorch twin (``--list-rules``
shows each title; GL002 is refused by name). Importing this package never
imports torch, jax or anything of the JAX package.
"""

from trlx_tpu_torch.analysis.core import (  # noqa: F401
    REFUSED,
    RULE_TITLES,
    Finding,
    Module,
    lint_paths,
    render_json,
    render_text,
)

__all__ = [
    "Finding",
    "Module",
    "REFUSED",
    "RULE_TITLES",
    "lint_paths",
    "render_json",
    "render_text",
]
