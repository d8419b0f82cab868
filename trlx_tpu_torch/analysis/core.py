"""graftlint core for the port: file walking, suppression parsing, rule
running, reporting (the counterpart of ``trlx_tpu.analysis.core``).

stdlib-only by contract: importing :mod:`trlx_tpu_torch.analysis` pulls in
neither torch nor jax nor anything of the JAX package, so the lint runs on a
machine with no accelerator stack at all. The rules live in
:mod:`trlx_tpu_torch.analysis.rules` and :mod:`.concurrency`; this module
owns everything rule-agnostic:

- walking the target paths into parsed :class:`Module` units,
- inline suppressions (``# graftlint: disable=GL001 -- reason``): the reason
  is REQUIRED — a disable comment without one is itself a finding (GL000),
- rendering findings as text (``path:line:col: GLxxx message``) or JSON.

Findings carry ``suppressed``/``reason`` so the JSON output still shows what
was waived and why; only unsuppressed findings affect the exit code.

The rule ids mean the same hazard in both packages; where the hazard is
JAX's, the port checks its PyTorch twin (the titles below). GL002 has no
twin and is refused by name (``REFUSED``).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import asdict, dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=(?P<rules>GL\d{3}(?:\s*,\s*GL\d{3})*)"
    r"(?:\s*--\s*(?P<reason>\S.*?))?\s*$"
)

#: rule id → one-line title, kept here (not in rules.py) so `--list-rules`
#: works even if a rule module grows optional imports later.
RULE_TITLES = {
    "GL000": "malformed suppression (disable comment without a reason)",
    "GL001": "graph-capture home: CUDA-graph capture outside ops/cuda_graph.py, or not thread_local under launch_lock",
    "GL002": "use-after-donate: refused (PyTorch has no buffer donation)",
    "GL003": "capture purity: host sync or host side effect in a callable captured by StepGraph",
    "GL004": "collective-guard: bare torch.distributed collective outside collective_guard",
    "GL005": "knob defaults: undeclared config knob read, or truthy feature default",
    "GL006": "kernel provenance: C entry unbound or of another arity, launch unchecked, fallen back or uncounted",
    "GL007": "metric-name conformance: key unsafe under sanitize_metric_name or colliding",
    "GL008": "shared-write-without-lock: cross-thread attribute write with no common lock",
    "GL009": "lock-order inversion: cycle in the static lock-acquisition graph",
    "GL010": "unjoined/unregistered thread: leaks at exit or invisible to teardown checks",
    "GL011": "blocking-call-under-launch-lock: sleep/IO/untimed wait/device sync starves launchers",
}

#: rule id → why the port has no such check. A refused rule is listed, but
#: has no check and cannot be selected.
REFUSED = {
    "GL002": "PyTorch has no buffer donation, so no donated buffer can be read back",
}

#: rule family → member ids, for the grouped `--list-rules` view. GL000 is
#: the suppression meta-rule and belongs to the invariant family.
RULE_FAMILIES = {
    "invariant (graftlint)": tuple(f"GL00{i}" for i in range(8)),
    "concurrency (graftrace)": ("GL008", "GL009", "GL010", "GL011"),
}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        tag = f" [suppressed: {self.reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"


@dataclass
class Suppression:
    line: int
    rules: frozenset
    reason: str


class Module:
    """One parsed python file plus the derived lookups rules need."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.suppressions: Dict[int, Suppression] = {}
        for i, ln in enumerate(self.lines, 1):
            m = SUPPRESS_RE.search(ln)
            if m:
                rules = frozenset(r.strip() for r in m.group("rules").split(","))
                self.suppressions[i] = Suppression(i, rules, (m.group("reason") or "").strip())
        # Every node once, in ast.walk order: the rules iterate this list
        # rather than walking the tree again each.
        self.nodes: List[ast.AST] = list(ast.walk(self.tree))
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in self.nodes:
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # ---------------------------------------------------------- AST lookups

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_stmt_line(self, node: ast.AST) -> int:
        """First line of the statement containing ``node`` (suppression
        comments may sit on the statement head of a multi-line call)."""
        line = getattr(node, "lineno", 1)
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = self._parents.get(cur)
        if cur is not None:
            line = cur.lineno
        return line

    # ------------------------------------------------------------- findings

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        sup = self._suppression_for(rule, line, self.enclosing_stmt_line(node))
        if sup is not None:
            return Finding(rule, self.relpath, line, col, message, True, sup.reason)
        return Finding(rule, self.relpath, line, col, message)

    def _suppression_for(self, rule: str, *lines: int) -> Optional[Suppression]:
        for ln in lines:
            sup = self.suppressions.get(ln)
            # A reasonless disable is malformed (GL000) and waives nothing.
            if sup is not None and rule in sup.rules and sup.reason:
                return sup
        return None


# ------------------------------------------------------------------ walking

_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache", "node_modules"}


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def load_modules(paths: Sequence[str]) -> Tuple[List[Module], List[Finding]]:
    """Parse every target file; syntax errors become findings, not crashes."""
    modules: List[Module] = []
    errors: List[Finding] = []
    cwd = os.getcwd()
    for path in iter_python_files(paths):
        rel = os.path.relpath(path, cwd) if os.path.isabs(path) else path
        if rel.startswith(".."):
            rel = path  # outside the cwd: keep the absolute path readable
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            modules.append(Module(path, rel, source))
        except (SyntaxError, UnicodeDecodeError) as e:
            line = getattr(e, "lineno", 1) or 1
            errors.append(Finding("GL000", rel, line, 0, f"unparseable file: {e}"))
    return modules, errors


# ------------------------------------------------------------------ running


def lint_paths(paths: Sequence[str], select: Optional[Sequence[str]] = None):
    """Run every rule over ``paths``. Returns (findings, n_files)."""
    from trlx_tpu_torch.analysis import concurrency as conc_mod
    from trlx_tpu_torch.analysis import rules as rules_mod

    per_module_rules = rules_mod.PER_MODULE_RULES + conc_mod.PER_MODULE_RULES
    global_rules = rules_mod.GLOBAL_RULES + conc_mod.GLOBAL_RULES

    modules, findings = load_modules(paths)
    wanted = set(select) if select else None

    def keep(rule: str) -> bool:
        return wanted is None or rule in wanted

    for module in modules:
        # GL000: every disable comment must carry a reason after " -- ".
        if keep("GL000"):
            for sup in module.suppressions.values():
                if not sup.reason:
                    findings.append(Finding(
                        "GL000", module.relpath, sup.line, 0,
                        "suppression without a reason: use '# graftlint: disable=GLxxx -- <why>'"))
        for rule_id, check in per_module_rules:
            if keep(rule_id):
                findings.extend(check(module))
    for rule_id, check in global_rules:
        if keep(rule_id):
            findings.extend(check(modules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, len(modules)


def render_text(findings: Sequence[Finding], n_files: int) -> str:
    out = [f.render() for f in findings]
    active = [f for f in findings if not f.suppressed]
    waived = len(findings) - len(active)
    out.append(f"graftlint: {len(active)} finding(s) ({waived} suppressed) in {n_files} file(s)")
    return "\n".join(out)


def render_json(findings: Sequence[Finding], n_files: int) -> str:
    return json.dumps(
        {
            "tool": "graftlint",
            "files": n_files,
            "findings": [f.to_dict() for f in findings],
            "rules": RULE_TITLES,
        },
        indent=2,
        sort_keys=True,
    )
