"""The repo's static analysis over the port (``trlx_tpu.analysis``, the
reference's own linter, run on ``trlx_tpu_torch``).

- The rules that are not about JAX (GL005 knob defaults, GL007 metric
  names, GL008–GL011 the concurrency rules) report nothing unsuppressed,
  and every suppression states its reason.
- GL004's torch twin: the reference's rule names JAX's raw host
  collectives; here every ``torch.distributed`` collective outside
  ``parallel/collectives.py`` (the port's one collectives module) must run
  under a ``collective_guard`` deadline, so a dead peer ends the process
  with exit 117 instead of hanging it.
"""

import ast
import os

import pytest

from trlx_tpu.analysis import lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "trlx_tpu_torch")
RULES = ("GL005", "GL007", "GL008", "GL009", "GL010", "GL011")

# torch.distributed calls that block until every process of the group
# takes part (point-to-point ops wait for their peer).
TORCH_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "gather", "gather_object", "scatter", "scatter_object_list", "barrier",
    "monitored_barrier", "send", "recv", "isend", "irecv", "batch_isend_irecv", "send_object_list",
    "recv_object_list",
})
COLLECTIVES_HOME = os.path.join("parallel", "collectives.py")


@pytest.mark.parametrize("rule", RULES)
def test_port_is_clean_under_the_non_jax_rules(rule, monkeypatch):
    monkeypatch.chdir(REPO)
    findings, n_files = lint_paths(["trlx_tpu_torch"], select=[rule])
    assert n_files > 70
    active = [f.render() for f in findings if not f.suppressed]
    assert active == []
    assert all(f.reason for f in findings if f.suppressed)


def _dist_aliases(tree: ast.AST) -> set:
    """Names bound to ``torch.distributed`` in a module."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed":
                    names.add(a.asname or "torch.distributed")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    names.add(a.asname or "distributed")
    return names


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def bare_collectives(source: str, relpath: str = "<src>") -> list:
    """``path:line name`` of every torch.distributed collective call in
    ``source`` that no ``with collective_guard(...)`` lexically wraps."""
    tree = ast.parse(source)
    aliases = _dist_aliases(tree) | {"torch.distributed"}
    parents = {child: parent for parent in ast.walk(tree) for child in ast.iter_child_nodes(parent)}

    def guarded(node):
        while node in parents:
            node = parents[node]
            if isinstance(node, ast.With) and any(
                    isinstance(i.context_expr, ast.Call) and _dotted(i.context_expr.func).split(".")[-1]
                    == "collective_guard" for i in node.items):
                return True
        return False

    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr in TORCH_COLLECTIVES and _dotted(node.func.value) in aliases and not guarded(node):
            out.append(f"{relpath}:{node.lineno} {node.func.attr}")
    return out


def test_checker_sees_bare_and_guarded_calls():
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
    assert bare_collectives(src) == ["<src>:4 all_reduce", "<src>:7 broadcast"]


def test_no_bare_torch_collective_outside_the_collectives_module():
    """GL004's torch twin over the port (the sp ring's exchange lives in the
    collectives module too, so its step runs under the train step's guard)."""
    found, scanned = [], 0
    for root, _, files in os.walk(PORT):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, PORT)
            if rel == COLLECTIVES_HOME:
                continue
            with open(path) as f:
                src = f.read()
            scanned += 1
            found.extend(bare_collectives(src, rel))
    assert scanned > 70
    assert found == []
