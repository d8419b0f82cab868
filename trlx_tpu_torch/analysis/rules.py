"""The graftlint rules of the port (GL001–GL007): its conventions as machine
checks. The ids are the JAX package's (``trlx_tpu.analysis.rules``); where
the JAX hazard has a PyTorch twin, the rule checks the twin:

- GL001, graph-capture home. The JAX rule keeps jitted dispatches under the
  dispatch lock. The port has no dispatch lock; its cross-thread hazard is a
  CUDA-graph capture: in torch's default ``global`` capture mode, a launch
  by the overlap producer or the score worker during a capture fails it.
  So ``torch.cuda.graph(``, ``torch.cuda.CUDAGraph(`` and ``.capture_begin(``
  appear only in ``ops/cuda_graph.py``, where the capture is
  ``thread_local`` and runs under ``cuda_lib.launch_lock`` (``StepGraph``).
- GL002, use-after-donate: refused (PyTorch has no buffer donation).
- GL003, capture purity. The JAX rule bans host effects in traced bodies.
  The port's twin is the callable a ``StepGraph`` captures: a host sync
  raises during capture, and a host effect runs once at capture and never at
  replay. A ``StepGraph(`` whose callable the rule cannot resolve is itself a
  finding, so no capture site slips past.
- GL004, collective guard: every ``torch.distributed`` collective outside
  ``parallel/collectives.py`` (the port's one collectives module) runs under
  ``collective_guard``, so a dead peer ends the process instead of hanging.
- GL005, knob defaults: the JAX logic over the port's ``data/configs.py``
  and ``data/method_configs.py``.
- GL006, kernel provenance. The JAX rule ties Pallas tiles to
  ``ops/tiling.py``. The port's kernels are C entry points: each
  ``cuda_lib.lib().<entry>(...)`` call names a key of
  ``cuda_lib._SIGNATURES`` whose arity equals the ``extern "C"`` definition
  in ``csrc/*.cu`` (and no entry is left unbound), hands its return value to
  ``cuda_lib.check(err, "<entry>")``, sits under no ``try`` whose handler
  falls back to a ``*_plain`` function (the no-fallback rule), and lives in
  a module that defines its ``*_plain`` counterpart and counts its launches.
- GL007, metric names: ``_sanitize`` mirrors the port's
  ``observability/export.sanitize_metric_name``.

Everything here is stdlib ``ast`` (and ``re`` over the CUDA sources): no
imports of the checked modules, no torch, no jax.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from trlx_tpu_torch.analysis.core import Finding, Module

# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def last_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def own_statements(fn: ast.AST) -> Iterator[ast.stmt]:
    """Statements of ``fn`` (a function or the module) in source order,
    descending into compound statements but NOT into nested function/class
    scopes."""

    def walk(body: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
        for stmt in body:
            yield stmt
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                yield from walk(getattr(stmt, field, []) or [])
            for handler in getattr(stmt, "handlers", []) or []:
                yield from walk(handler.body)

    body = fn.body if isinstance(fn.body, list) else []
    yield from walk(body)


def enclosing_function(module: Module, node: ast.AST) -> Optional[ast.AST]:
    for anc in module.ancestors(node):
        if isinstance(anc, _SCOPES):
            return anc
    return None


def _with_items_under(module: Module, node: ast.AST, boundary: Optional[ast.AST] = None) -> Iterator[ast.AST]:
    """Context expressions of the ``with`` statements lexically around
    ``node``, up to (not past) the enclosing function ``boundary``."""
    for anc in module.ancestors(node):
        if anc is boundary or isinstance(anc, _SCOPES):
            break
        if isinstance(anc, ast.With):
            for item in anc.items:
                yield item.context_expr


# --------------------------------------------------------------------------
# GL001 — graph-capture home
# --------------------------------------------------------------------------

GRAPH_HOME = "ops/cuda_graph.py"
#: the capture API of torch.cuda (dotted suffixes), and the lock a capture
#: holds (``ops/cuda_lib.py``: a wrapper counts its launches under it).
_CAPTURE_API = ("cuda.graph", "cuda.CUDAGraph")
LAUNCH_LOCK = "launch_lock"


def _capture_names(module: Module) -> Set[str]:
    """Local names bound to torch.cuda's capture API by ``from torch.cuda
    import graph, CUDAGraph``."""
    names = set()
    for node in module.nodes:
        if isinstance(node, ast.ImportFrom) and node.module == "torch.cuda":
            for a in node.names:
                if a.name in ("graph", "CUDAGraph"):
                    names.add(a.asname or a.name)
    return names


def _capture_api_call(call: ast.Call, local: Set[str]) -> Optional[str]:
    d = dotted(call.func)
    if d is not None and (d.endswith(_CAPTURE_API) or d in local):
        return d
    if isinstance(call.func, ast.Attribute) and call.func.attr == "capture_begin":
        return ".capture_begin"
    return None


def _under_launch_lock(module: Module, node: ast.AST) -> bool:
    return any(last_attr(e) == LAUNCH_LOCK for e in _with_items_under(module, node))


def check_gl001(module: Module) -> Iterator[Finding]:
    local = _capture_names(module)
    home = module.relpath.endswith(GRAPH_HOME)
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        api = _capture_api_call(node, local)
        if api is not None and not home:
            yield module.finding(
                "GL001", node,
                f"CUDA-graph capture API {api!r} outside {GRAPH_HOME}: capture through "
                "ops.cuda_graph.StepGraph / CudaGraph, whose capture is thread_local and holds "
                "cuda_lib.launch_lock (a global-mode capture fails when another thread launches)")
            continue
        if not home:
            continue
        if api is not None and api.endswith("cuda.graph"):
            mode = next((kw.value for kw in node.keywords if kw.arg == "capture_error_mode"), None)
            if const_str(mode) != "thread_local":
                yield module.finding(
                    "GL001", node,
                    "torch.cuda.graph(...) without capture_error_mode='thread_local': the default "
                    "'global' mode refuses every other thread's allocations and syncs during the capture")
        # A capture that starts here (a with-item capture, or capture_begin)
        # holds the launch lock, so launch counts taken back stay exact and
        # two captures never overlap.
        parent = module.parent(node)
        starts = api == ".capture_begin" or (
            isinstance(parent, ast.withitem) and parent.context_expr is node
            and (last_attr(node.func) == "capture" or (api or "").endswith("cuda.graph")))
        if starts and not _under_launch_lock(module, node):
            yield module.finding(
                "GL001", node,
                f"graph capture started outside 'with cuda_lib.{LAUNCH_LOCK}': another thread's launches "
                "would be counted into the capture and replayed")


# --------------------------------------------------------------------------
# GL003 — capture purity
# --------------------------------------------------------------------------

#: the class whose first argument is captured into a CUDA graph.
CAPTURE_ENTRIES = {"StepGraph": 0}

_HOST_BUILTINS = {"print", "open", "input", "breakpoint"}
_HOST_MODULE_PREFIXES = (("time",), ("logging",), ("random",), ("np", "random"), ("numpy", "random"))
#: tensor methods that read the device back to the host (a sync).
_HOST_READS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: torch factories that allocate on the CPU unless given device= (a
#: host-to-device copy follows, which a capture cannot hold).
_FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange", "rand", "randn", "randint",
              "randperm", "linspace", "eye"}


def _banned_capture_call(call: ast.Call) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
        return f"{func.id}()"
    d = dotted(func)
    if d is not None:
        parts = tuple(d.split("."))
        for prefix in _HOST_MODULE_PREFIXES:
            if parts[: len(prefix)] == prefix and len(parts) > len(prefix):
                return d
        if "tracker" in (p.lower() for p in parts[:-1]):
            return d
        if len(parts) == 2 and parts[0] == "torch" and parts[1] in _FACTORIES and not any(
                kw.arg == "device" for kw in call.keywords):
            return f"{d}() without device="
    if isinstance(func, ast.Attribute) and func.attr in _HOST_READS:
        return f".{func.attr}()"
    return None


def _scope_chain(module: Module, node: ast.AST) -> List[ast.AST]:
    """The scopes a name at ``node`` resolves in: enclosing functions,
    innermost first, then the module."""
    return [a for a in module.ancestors(node) if isinstance(a, _SCOPES)] + [module.tree]


def _defs_in(scope: ast.AST, name: str) -> List[ast.AST]:
    if isinstance(scope, ast.Lambda):
        return []
    return [s for s in own_statements(scope) if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
            and s.name == name]


def _assigned(scope: ast.AST, match) -> List[ast.AST]:
    """Values assigned in ``scope`` (its own statements) to a target that
    ``match(target)`` accepts."""
    if isinstance(scope, ast.Lambda):
        return []
    out = []
    for s in own_statements(scope):
        if isinstance(s, ast.Assign):
            if any(match(t) for t in s.targets):
                out.append(s.value)
        elif isinstance(s, ast.AnnAssign) and s.value is not None and match(s.target):
            out.append(s.value)
    return out


def _class_of(module: Module, node: ast.AST) -> Optional[ast.ClassDef]:
    for anc in module.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc
    return None


def resolve_callable(module: Module, expr: ast.AST, depth: int = 0) -> Optional[List[ast.AST]]:
    """The function or lambda nodes ``expr`` can evaluate to, or None when
    any branch of it cannot be resolved. Follows local and module names,
    ``self.<method>`` and ``self.<attr> = ...``, ``d["key"] = ...``, a call
    of a function that returns a closure, ``a or b`` and ``a if c else b``."""
    if depth > 8:
        return None
    if isinstance(expr, ast.Lambda):
        return [expr]
    if isinstance(expr, ast.Constant) and expr.value is None:
        return []
    if isinstance(expr, (ast.BoolOp, ast.IfExp)):
        branches = expr.values if isinstance(expr, ast.BoolOp) else [expr.body, expr.orelse]
        out: List[ast.AST] = []
        for b in branches:
            got = resolve_callable(module, b, depth + 1)
            if got is None:
                return None
            out += got
        return out
    if isinstance(expr, ast.Name):
        for scope in _scope_chain(module, expr):
            defs = _defs_in(scope, expr.id)
            if defs:
                return defs
            values = _assigned(scope, lambda t: isinstance(t, ast.Name) and t.id == expr.id)
            if values:
                return _resolve_all(module, values, depth)
        return None
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) and expr.value.id == "self":
        cls = _class_of(module, expr)
        if cls is None:
            return None
        methods = [s for s in cls.body if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and s.name == expr.attr]
        if methods:
            return methods
        values = [n.value for n in ast.walk(cls) if isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Attribute) and dotted(t) == f"self.{expr.attr}" for t in n.targets)]
        return _resolve_all(module, values, depth) if values else None
    if isinstance(expr, ast.Subscript) and const_str(expr.slice) is not None and dotted(expr.value):
        base, key = dotted(expr.value), const_str(expr.slice)

        def same_slot(t):
            return isinstance(t, ast.Subscript) and dotted(t.value) == base and const_str(t.slice) == key

        for scope in _scope_chain(module, expr):
            values = _assigned(scope, same_slot)
            if values:
                return _resolve_all(module, values, depth)
        return None
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
        fns = resolve_callable(module, expr.func, depth + 1)
        if not fns:
            return None
        returned = [s.value for fn in fns if not isinstance(fn, ast.Lambda)
                    for s in own_statements(fn) if isinstance(s, ast.Return) and s.value is not None]
        return _resolve_all(module, returned, depth) if returned else None
    return None


def _resolve_all(module: Module, values: Sequence[ast.AST], depth: int) -> Optional[List[ast.AST]]:
    out: List[ast.AST] = []
    for v in values:
        got = resolve_callable(module, v, depth + 1)
        if got is None:
            return None
        out += got
    return out


def check_gl003(module: Module) -> Iterator[Finding]:
    for node in module.nodes:
        if not (isinstance(node, ast.Call) and last_attr(node.func) in CAPTURE_ENTRIES):
            continue
        entry = last_attr(node.func)
        pos = CAPTURE_ENTRIES[entry]
        arg = node.args[pos] if pos < len(node.args) else None
        bodies = resolve_callable(module, arg) if arg is not None else None
        if not bodies:
            yield module.finding(
                "GL003", node,
                f"{entry}(...) captures a callable this rule cannot resolve to a def or lambda in this "
                "module: bind it to a local def, a method or a closure-returning function so its "
                "purity can be checked")
            continue
        seen: Set[int] = set()
        for body in bodies:
            if id(body) in seen:
                continue
            seen.add(id(body))
            name = getattr(body, "name", "<lambda>")
            for sub in ast.walk(body):
                if not isinstance(sub, ast.Call):
                    continue
                banned = _banned_capture_call(sub)
                if banned is not None:
                    yield module.finding(
                        "GL003", sub,
                        f"host sync or host effect {banned!r} in {name!r}, which {entry} captures as a CUDA "
                        "graph: it raises during the capture or runs once there and never at replay — "
                        "hoist it out of the captured step")


# --------------------------------------------------------------------------
# GL004 — collective-guard
# --------------------------------------------------------------------------

#: torch.distributed calls that block until every process of the group
#: takes part (point-to-point ops wait for their peer).
TORCH_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "gather", "gather_object", "scatter", "scatter_object_list", "barrier",
    "monitored_barrier", "send", "recv", "isend", "irecv", "batch_isend_irecv", "send_object_list",
    "recv_object_list",
})

#: the port's one collectives module may call torch.distributed freely: its
#: callers hold the guard.
COLLECTIVES_HOME = "parallel/collectives.py"


def dist_aliases(tree: ast.AST) -> Set[str]:
    """Names bound to ``torch.distributed`` in a module (plus the dotted
    name itself)."""
    names = {"torch.distributed"}
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


def _under_collective_guard(module: Module, node: ast.AST) -> bool:
    for anc in module.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                e = item.context_expr
                if isinstance(e, ast.Call) and last_attr(e.func) == "collective_guard":
                    return True
    return False


def check_gl004(module: Module) -> Iterator[Finding]:
    if module.relpath.endswith(COLLECTIVES_HOME):
        return
    aliases = dist_aliases(module.tree)
    for node in module.nodes:
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr not in TORCH_COLLECTIVES or dotted(node.func.value) not in aliases:
            continue
        if not _under_collective_guard(module, node):
            yield module.finding(
                "GL004", node,
                f"bare torch.distributed collective {node.func.attr!r}: a dead peer hangs this forever — "
                "wrap it in collective_guard(...) or go through parallel/collectives.py")


# --------------------------------------------------------------------------
# GL005 — knob defaults
# --------------------------------------------------------------------------

#: Fields that predate the off-by-default convention (baseline hyperparams
#: and deliberately-on safety defaults), the JAX package's list: the port's
#: schema is the JAX package's field for field.
BASELINE_TRUTHY_FIELDS = frozenset(
    {
        # ModelConfig
        "model_type", "num_layers_unfrozen", "dtype", "param_dtype",
        "remat_policy",
        # TrainConfig baseline hyperparams / deliberately-on safety nets
        "opt_betas", "checkpoint_interval", "eval_interval", "log_interval",
        "pipeline", "orchestrator", "project_name", "checkpoint_dir", "seed",
        "mesh", "loss_dtype", "grad_clip", "async_checkpointing",
        "nonfinite_guard", "max_bad_steps", "watchdog_patience",
        "watchdog_ema_alpha", "watchdog_warmup", "watchdog_lr_decay",
        "max_rollbacks", "reward_fn_retries", "reward_fn_backoff",
        "anomaly_window", "max_incidents", "health_warmup",
        "health_warn_streak", "health_crit_streak",
        # method configs: PPO/ILQL/softprompt hyperparameters
        "name", "ppo_epochs", "num_rollouts", "chunk_size", "init_kl_coef",
        "target", "horizon", "gamma", "lam", "cliprange", "cliprange_value",
        "vf_coef", "fused_rollout_stats", "score_queue_depth",
        "prefetch_depth", "prefill_batch", "engine_steps_per_sync",
        "tau", "cql_scale", "awac_scale", "alpha", "steps_for_target_q_sync",
        "betas", "two_qs", "n_soft_tokens", "initialize_from_vocab",
        # a PARAMETER of the paged-KV feature, read only when paged_kv (off)
        # is on, so the serial path stays byte-identical with it truthy.
        "kv_block_size",
    }
)

_CONFIG_FILES = ("data/configs.py", "data/method_configs.py")

#: attributes that are API of the config objects, not knobs.
_CONFIG_API = {"to_dict", "from_dict", "replace", "__dict__", "name"}


def _is_off_default(node: Optional[ast.AST]) -> Optional[bool]:
    """True if the default keeps the feature off; None if undecidable."""
    if node is None:
        return None  # required field
    if isinstance(node, ast.Constant):
        return not bool(node.value)
    if isinstance(node, (ast.Tuple, ast.List, ast.Dict, ast.Set)):
        return not bool(getattr(node, "elts", None) or getattr(node, "keys", None))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = node.operand
        if isinstance(inner, ast.Constant):
            return not bool(inner.value)
    if isinstance(node, ast.Call) and last_attr(node.func) == "field":
        for kw in node.keywords:
            if kw.arg == "default":
                return _is_off_default(kw.value)
            if kw.arg == "default_factory":
                if isinstance(kw.value, ast.Name) and kw.value.id in {"dict", "list", "tuple", "set"}:
                    return True
                return None
    return None


def _config_fields_of(tree: ast.AST) -> Dict[str, List[Tuple[str, ast.AnnAssign]]]:
    """class name → [(field name, AnnAssign node)] for *Config dataclasses."""
    out: Dict[str, List[Tuple[str, ast.AnnAssign]]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        decorated = any(last_attr(d) == "register_method" for d in node.decorator_list)
        if not (node.name.endswith("Config") or decorated):
            continue
        fields = []
        for st in node.body:
            if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name):
                fields.append((st.target.id, st))
        out[node.name] = fields
    return out


class _ConfigRegistry:
    """Declared train/method field names, anchored at the port's config
    files so fixture trees still validate reads against the live schema."""

    def __init__(self) -> None:
        self.train: Set[str] = set()
        self.method: Set[str] = set()
        here = os.path.dirname(os.path.abspath(__file__))
        data_dir = os.path.join(os.path.dirname(here), "data")
        for fname in ("configs.py", "method_configs.py"):
            path = os.path.join(data_dir, fname)
            if not os.path.exists(path):
                continue
            with open(path, "r", encoding="utf-8") as fh:
                try:
                    tree = ast.parse(fh.read())
                except SyntaxError:
                    continue
            self.add_tree(tree, fname)

    def add_tree(self, tree: ast.AST, fname: str) -> None:
        for cls, fields in _config_fields_of(tree).items():
            names = {n for n, _ in fields}
            if cls == "TrainConfig":
                self.train |= names
            elif fname.endswith("method_configs.py") or cls.startswith(("PPO", "ILQL", "Method")):
                self.method |= names


_REGISTRY: Optional[_ConfigRegistry] = None


def _registry() -> _ConfigRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _ConfigRegistry()
    return _REGISTRY


def _method_train_aliases(fn: ast.AST) -> Dict[str, str]:
    """local name → 'method'|'train' for ``m = <...>.method`` style aliases."""
    aliases: Dict[str, str] = {}
    for stmt in own_statements(fn):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if isinstance(t, ast.Name) and isinstance(stmt.value, ast.Attribute):
                if stmt.value.attr in {"method", "train"}:
                    aliases[t.id] = stmt.value.attr
    return aliases


def check_gl005(module: Module) -> Iterator[Finding]:
    registry = _registry()
    if any(module.relpath.endswith(s) for s in _CONFIG_FILES):
        # definition-site check: new knobs must default to off/0/False.
        registry.add_tree(module.tree, module.relpath)
        for cls, fields in _config_fields_of(module.tree).items():
            for fname, st in fields:
                off = _is_off_default(st.value)
                if off is False and fname not in BASELINE_TRUTHY_FIELDS:
                    yield module.finding(
                        "GL005", st,
                        f"{cls}.{fname} defaults ON: feature knobs must default to off/0/False so the "
                        "serial path stays byte-identical (add to BASELINE_TRUTHY_FIELDS only with a "
                        "reviewed reason)")
        return

    declared = {"method": registry.method, "train": registry.train}
    alias_by_fn = {
        id(fn): _method_train_aliases(fn)
        for fn in module.nodes
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
    }

    def enclosing_aliases(node: ast.AST) -> Dict[str, str]:
        for anc in module.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return alias_by_fn.get(id(anc), {})
        return {}

    for node in module.nodes:
        # direct reads: <...>.method.X / <...>.train.X
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Attribute):
            kind = node.value.attr
            if kind in declared and node.attr not in _CONFIG_API and node.attr not in declared[kind]:
                yield module.finding(
                    "GL005", node,
                    f"config read '.{kind}.{node.attr}' has no declared field in the {kind} config schema "
                    "(undeclared knobs read via getattr fallbacks silently disable features)")
        # getattr(<alias-or-.method>, "X", default)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "getattr"
                and len(node.args) >= 2):
            obj, attr = node.args[0], const_str(node.args[1])
            if attr is None or attr in _CONFIG_API:
                continue
            kind = None
            if isinstance(obj, ast.Attribute) and obj.attr in declared:
                kind = obj.attr
            elif isinstance(obj, ast.Name):
                kind = enclosing_aliases(node).get(obj.id)
            if kind is not None and attr not in declared[kind]:
                yield module.finding(
                    "GL005", node,
                    f"getattr read of undeclared {kind} knob {attr!r}: declare it in the config schema "
                    "(with an off default) instead of a silent fallback")


# --------------------------------------------------------------------------
# GL006 — kernel provenance (global: the C interface spans files)
# --------------------------------------------------------------------------

KERNEL_LIB = "ops/cuda_lib.py"
SIGNATURES_NAME = "_SIGNATURES"
#: C entry points that launch nothing (no check, no count, no plain twin),
#: each with what it does instead.
C_HELPERS = {
    "w8a16_max_clusters": "asks the occupancy API how many clusters of the W8 kernel's tiling fit; launches nothing",
}
_EXTERN_RE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def c_entries(csrc_dir: str) -> Dict[str, Tuple[int, str, int]]:
    """name → (parameter count, file name, line) of every ``extern "C" int
    name(...)`` definition in ``csrc_dir``'s ``.cu`` files."""
    out: Dict[str, Tuple[int, str, int]] = {}
    if not os.path.isdir(csrc_dir):
        return out
    for fname in sorted(os.listdir(csrc_dir)):
        if not fname.endswith(".cu"):
            continue
        with open(os.path.join(csrc_dir, fname), "r", encoding="utf-8") as fh:
            text = fh.read()
        for m in _EXTERN_RE.finditer(text):
            params = re.sub(r"/\*.*?\*/|//[^\n]*", "", m.group(2), flags=re.S).strip()
            n = 0 if params in ("", "void") else len([p for p in params.split(",") if p.strip()])
            out[m.group(1)] = (n, fname, text.count("\n", 0, m.start()) + 1)
    return out


def _signatures(module: Module) -> Optional[Tuple[ast.AST, Dict[str, Tuple[int, ast.AST]]]]:
    """(the assignment, {entry → (argtype count, key node)}) of a module's
    ``_SIGNATURES`` dict, or None."""
    for node in module.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == SIGNATURES_NAME and isinstance(node.value, ast.Dict)):
            sigs = {}
            for k, v in zip(node.value.keys, node.value.values):
                name = const_str(k) if k is not None else None
                if name is not None and isinstance(v, (ast.List, ast.Tuple)):
                    sigs[name] = (len(v.elts), k)
            return node, sigs
    return None


def _signatures_for(module: Module, libs: Dict[str, dict]) -> Optional[dict]:
    """The signatures a launch in ``module`` is bound by: those of the
    linted ``cuda_lib`` beside it, else of the one linted (None: unknown, so
    condition (a) is not checked)."""
    here = os.path.dirname(os.path.abspath(module.path))
    if here in libs:
        return libs[here]
    return next(iter(libs.values())) if len(libs) == 1 else None


def _launch_sites(module: Module) -> Iterator[Tuple[ast.Call, str]]:
    """(call, entry) for every ``<...>.lib().<entry>(...)`` call, and every
    ``<name>.<entry>(...)`` on a name bound to ``<...>.lib()`` in its
    function."""
    lib_names: Dict[int, Set[str]] = {}
    for node in module.nodes:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and last_attr(node.value.func) == "lib" and not node.value.args:
            scope = enclosing_function(module, node)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    lib_names.setdefault(id(scope), set()).add(t.id)
    for node in module.nodes:
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        recv = node.func.value
        if isinstance(recv, ast.Call) and last_attr(recv.func) == "lib" and not recv.args:
            yield node, node.func.attr
        elif isinstance(recv, ast.Name) and recv.id in lib_names.get(id(enclosing_function(module, node)), ()):
            yield node, node.func.attr


def _is_checked(module: Module, call: ast.Call, entry: str) -> bool:
    """The launch's return value reaches ``check(<it>, "<entry>")``."""
    parent = module.parent(call)
    if isinstance(parent, ast.Call) and last_attr(parent.func) == "check" and parent.args \
            and parent.args[0] is call:
        return len(parent.args) > 1 and const_str(parent.args[1]) == entry
    if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1 and isinstance(parent.targets[0], ast.Name)):
        return False
    err = parent.targets[0].id
    scope = enclosing_function(module, call) or module.tree
    for node in ast.walk(scope):
        if (isinstance(node, ast.Call) and last_attr(node.func) == "check" and len(node.args) > 1
                and isinstance(node.args[0], ast.Name) and node.args[0].id == err
                and const_str(node.args[1]) == entry):
            return True
    return False


def _plain_names(node: ast.AST) -> List[str]:
    return [n for n in (last_attr(x) for x in ast.walk(node) if isinstance(x, (ast.Name, ast.Attribute)))
            if n and n.endswith("_plain")]


def _fallback_try(module: Module, call: ast.Call) -> Optional[str]:
    """The ``*_plain`` name a ``try`` around ``call`` falls back to."""
    child: ast.AST = call
    for anc in module.ancestors(call):
        if isinstance(anc, _SCOPES):
            return None
        if isinstance(anc, ast.Try) and child in anc.body:
            for handler in anc.handlers:
                names = _plain_names(handler)
                if names:
                    return names[0]
        child = anc
    return None


def _defines_plain_and_counts(module: Module) -> Tuple[bool, bool]:
    plain = counts = False
    for node in module.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.endswith("_plain"):
            plain = True
        if isinstance(node, ast.Call) and last_attr(node.func) == "count_launch":
            counts = True
    return plain, counts


def check_gl006(modules: Sequence[Module]) -> Iterator[Finding]:
    libs: Dict[str, dict] = {}
    for module in modules:
        if module.relpath.endswith(KERNEL_LIB):
            found = _signatures(module)
            if found is not None:
                libs[os.path.dirname(os.path.abspath(module.path))] = found[1]
                yield from _check_c_interface(module, *found)
    for module in modules:
        sites = list(_launch_sites(module))
        if not sites:
            continue
        sigs = _signatures_for(module, libs)
        plain, counts = _defines_plain_and_counts(module)
        for call, entry in sites:
            if sigs is not None and entry not in sigs:
                yield module.finding(
                    "GL006", call,
                    f"C entry {entry!r} is not a key of cuda_lib.{SIGNATURES_NAME}: its argtypes are unset, "
                    "so ctypes passes every argument as a C int")
            if entry in C_HELPERS:
                continue
            if not _is_checked(module, call, entry):
                yield module.finding(
                    "GL006", call,
                    f"launch of {entry!r} whose return value does not reach cuda_lib.check(err, {entry!r}): "
                    "a launch error would pass silently")
            fallback = _fallback_try(module, call)
            if fallback is not None:
                yield module.finding(
                    "GL006", call,
                    f"launch of {entry!r} inside a try whose handler falls back to {fallback!r}: no fallback "
                    "from a kernel to its plain version — launch or raise")
            if not (plain and counts):
                missing = [w for w, ok in (("a *_plain counterpart", plain), ("cuda_lib.count_launch", counts))
                           if not ok]
                yield module.finding(
                    "GL006", call,
                    f"launch of {entry!r} in a module without {' and '.join(missing)}: every kernel keeps "
                    "its plain version beside its wrapper and counts its launches")


def _check_c_interface(module: Module, assign: ast.AST, sigs: Dict[str, Tuple[int, ast.AST]]) -> Iterator[Finding]:
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(module.path))), "csrc")
    entries = c_entries(csrc)
    for name, (n_args, key) in sorted(sigs.items()):
        if name not in entries:
            yield module.finding(
                "GL006", key,
                f"{SIGNATURES_NAME}[{name!r}] has no extern \"C\" int {name}(...) in csrc/*.cu")
        elif entries[name][0] != n_args:
            n_c, fname, line = entries[name]
            yield module.finding(
                "GL006", key,
                f"{SIGNATURES_NAME}[{name!r}] lists {n_args} argtypes but csrc/{fname}:{line} takes {n_c} "
                "parameters: the call would corrupt its arguments on the card")
    for name, (_, fname, line) in sorted(entries.items()):
        if name not in sigs:
            yield module.finding(
                "GL006", assign,
                f"extern \"C\" entry {name!r} (csrc/{fname}:{line}) is not bound in {SIGNATURES_NAME}")


# --------------------------------------------------------------------------
# GL007 — metric-name conformance (global: collisions are cross-file)
# --------------------------------------------------------------------------

_ILLEGAL = re.compile(r"[^a-zA-Z0-9_:]")
#: the repo's namespacing characters, which sanitize_metric_name folds to _.
_CANONICAL = re.compile(r"[/.\-]")


def _sanitize(name: str) -> str:
    """Mirror observability/export.sanitize_metric_name with stdlib re only
    (tests assert parity so the two cannot drift)."""
    out = _ILLEGAL.sub("_", name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _canonical(name: str) -> str:
    out = _CANONICAL.sub("_", name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _metric_key_sites(module: Module) -> Iterator[Tuple[str, ast.AST]]:
    for node in module.nodes:
        if isinstance(node, ast.Call):
            attr = last_attr(node.func)
            if attr in {"log_histogram", "log_table"} and node.args:
                key = const_str(node.args[0])
                if key is not None:
                    yield key, node.args[0]
            if attr == "log" and node.args and isinstance(node.args[0], ast.Dict):
                for k in node.args[0].keys:
                    key = const_str(k) if k is not None else None
                    if key is not None:
                        yield key, k
        # namespaced literal keys anywhere a dict is built or stored into:
        # these flow into stats/gauge dicts that reach the Tracker/exporter.
        if isinstance(node, ast.Dict):
            for k in node.keys:
                key = const_str(k) if k is not None else None
                if key is not None and "/" in key:
                    yield key, k
        if isinstance(node, ast.Subscript) and isinstance(getattr(node, "ctx", None), ast.Store):
            key = const_str(node.slice)
            if key is not None and "/" in key:
                yield key, node


def check_gl007(modules: Sequence[Module]) -> Iterator[Finding]:
    by_sanitized: Dict[str, Dict[str, Tuple[Module, ast.AST]]] = {}
    for module in modules:
        for key, node in _metric_key_sites(module):
            san = _sanitize(key)
            if san != _canonical(key):
                yield module.finding(
                    "GL007", node,
                    f"metric key {key!r} does not survive sanitize_metric_name cleanly (becomes {san!r}): "
                    "use only [a-zA-Z0-9_:] plus '/' namespacing")
                continue
            by_sanitized.setdefault(san, {}).setdefault(key, (module, node))
    for san, variants in sorted(by_sanitized.items()):
        if len(variants) > 1:
            keys = sorted(variants)
            for key in keys:
                module, node = variants[key]
                others = [k for k in keys if k != key]
                yield module.finding(
                    "GL007", node,
                    f"metric key {key!r} collides with {others!r} after sanitize_metric_name (both export "
                    f"as {san!r}) — the exporter keeps only the last writer")


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

PER_MODULE_RULES = [
    ("GL001", check_gl001),
    ("GL003", check_gl003),
    ("GL004", check_gl004),
    ("GL005", check_gl005),
]

GLOBAL_RULES = [
    ("GL006", check_gl006),
    ("GL007", check_gl007),
]
