"""The repo's static analysis over the port, with the port's own linter
(``trlx_tpu_torch.analysis``; ``tests/test_torch_lint.py`` holds the linter
itself against the JAX package's).

- Every rule of the port's linter reports nothing unsuppressed over
  ``trlx_tpu_torch``, and every suppression states its reason.
- GL004, collective guard: every ``torch.distributed`` collective outside
  ``parallel/collectives.py`` (the port's one collectives module) must run
  under a ``collective_guard`` deadline, so a dead peer ends the process
  with exit 117 instead of hanging it.
"""

import os
import textwrap

import pytest

from trlx_tpu_torch.analysis import REFUSED, RULE_TITLES, lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = tuple(r for r in RULE_TITLES if r not in REFUSED)


@pytest.fixture(scope="module")
def port_findings():
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return lint_paths(["trlx_tpu_torch"])
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("rule", RULES)
def test_port_is_clean_under_the_non_jax_rules(rule, port_findings):
    findings, n_files = port_findings
    assert n_files > 70
    mine = [f for f in findings if f.rule == rule]
    assert [f.render() for f in mine if not f.suppressed] == []
    assert all(f.reason for f in mine if f.suppressed)


def bare_collectives(tmp_path, source: str) -> list:
    """``line name`` of every torch.distributed collective call in
    ``source`` that no ``with collective_guard(...)`` lexically wraps: GL004
    of the port's linter."""
    path = tmp_path / "src.py"
    path.write_text(textwrap.dedent(source))
    findings, _ = lint_paths([str(path)], select=["GL004"])
    return [f"{f.line} {f.message.split(chr(39))[1]}" for f in findings if not f.suppressed]


def test_checker_sees_bare_and_guarded_calls(tmp_path):
    src = (
        "import torch.distributed as dist\n"
        "from trlx_tpu_torch.resilience.distributed import collective_guard\n"
        "def f(x):\n"
        "    dist.all_reduce(x)\n"
        "    with collective_guard('g'):\n"
        "        dist.barrier()\n"
        "    torch.distributed.broadcast(x, 0)\n"
        "    dist.get_rank()\n"
    )
    assert bare_collectives(tmp_path, src) == ["4 all_reduce", "7 broadcast"]
    aliased = "from torch import distributed as d\ndef g():\n    d.barrier()\n"
    assert bare_collectives(tmp_path, aliased) == ["3 barrier"]


def test_no_bare_torch_collective_outside_the_collectives_module(port_findings):
    """GL004 over the port (the sp ring's exchange lives in the collectives
    module too, so its step runs under the train step's guard)."""
    findings, scanned = port_findings
    assert scanned > 70
    assert [f.render() for f in findings if f.rule == "GL004" and not f.suppressed] == []
