"""graftrace static half for the port: the concurrency rules (GL008–GL011),
the counterpart of ``trlx_tpu.analysis.concurrency``.

The port runs long-lived threads beside the main one: the overlap
pipeline's rollout producer, score worker and prefetch iterator, the
heartbeat writer, the metrics exporter, graftscope's drain, the checkpoint
writer, the collective guard's timers. These rules check their shared
mutable state:

- GL008 shared-write-without-lock, GL009 lock-order inversion and GL010
  unjoined/unregistered thread keep the JAX package's logic: per-class
  thread entry points from every ``threading.Thread(target=...)`` /
  ``threading.Timer`` site, ``self.<attr>`` read/write sets (helpers and
  callbacks one level deep) that must share a lock or be a handoff type;
  the static lock graph with one-level helper resolution; threads that are
  neither daemonized nor joined, or stored on ``self`` without a
  ``name="trlx-..."``. The one difference: ``cuda_lib.launch_lock`` is one
  process-wide node of the lock graph (as the JAX dispatch lock is), since
  every module that takes it takes the same lock.
- GL011 blocking-call-under-launch-lock: the twin of the JAX rule, whose
  lock is the dispatch lock. The port's cross-thread lock is
  ``cuda_lib.launch_lock``: every kernel wrapper takes it to count a launch,
  and a graph capture holds it throughout (``ops/cuda_graph.py``), so a
  ``time.sleep``, file I/O, a zero-arg ``.get()``/``.join()``/``.wait()``,
  a device sync (``torch.cuda.synchronize``, ``.synchronize()``) or a
  collective lexically inside ``with <...>launch_lock`` stalls every other
  thread's launches.

Same contract as rules.py: stdlib ``ast`` over source text only, no torch,
no jax, no imports of the checked modules. Runtime enforcement of the same
model lives in trlx_tpu_torch/utils/sanitize.py (``TRLX_TPU_SANITIZE=race``).
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from trlx_tpu_torch.analysis.core import Finding, Module
from trlx_tpu_torch.analysis.rules import LAUNCH_LOCK, TORCH_COLLECTIVES, dotted, last_attr

# --------------------------------------------------------------------------
# shared lock / handoff vocabulary
# --------------------------------------------------------------------------

#: with-item names treated as the process-wide dispatch lock (shared between
#: trainer and engine by construction, so GL009 gives them ONE graph node).
_DISPATCH_LOCK_CALLS = {"_dispatch", "dispatch_lock"}

#: constructors whose product is a safe cross-thread handoff/sync primitive:
#: an attribute assigned from one of these needs no further lock discipline.
_HANDOFF_CALLS = {
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "Event", "Lock", "RLock", "Condition", "Semaphore",
    "BoundedSemaphore", "Barrier",
    # the sanitize registry: race-mode tracked primitives (plain ones unarmed)
    "make_dispatch_lock", "make_lock", "make_condition", "make_event",
}

#: method names that mutate their receiver: ``self.x.append(...)`` is a
#: write to the shared structure even though the attribute node loads.
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "clear", "update", "setdefault",
    "sort", "reverse",
}


def _is_lockish_name(name: Optional[str]) -> bool:
    if not name:
        return False
    n = name.lower()
    return n.endswith(("lock", "mutex")) or n in {"_cv", "cv"} or "cond" in n


def _lock_name(expr: ast.AST) -> Optional[str]:
    """Canonical lock name for a with-item context expression, or None."""
    if isinstance(expr, ast.Call):
        if last_attr(expr.func) in _DISPATCH_LOCK_CALLS:
            return "_dispatch_lock"
        return None
    name = last_attr(expr)
    if name == "_dispatch_lock":
        return name
    if _is_lockish_name(name):
        return name
    return None


def _with_locks(item_source: ast.With) -> List[str]:
    return [
        n for n in (_lock_name(i.context_expr) for i in item_source.items)
        if n is not None
    ]


def _held_locks_at(module: Module, node: ast.AST, boundary: ast.AST) -> FrozenSet[str]:
    """Lock names lexically held at ``node``, scanning ancestors up to (and
    not past) the enclosing function ``boundary``."""
    held: Set[str] = set()
    for anc in module.ancestors(node):
        if anc is boundary:
            break
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            break
        if isinstance(anc, ast.With):
            held.update(_with_locks(anc))
    return frozenset(held)


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _enclosing_class(module: Module, node: ast.AST) -> Optional[ast.ClassDef]:
    for anc in module.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc
    return None


# --------------------------------------------------------------------------
# thread-entry discovery (shared by GL008 / GL010)
# --------------------------------------------------------------------------


class _ThreadSite:
    """One ``threading.Thread(...)`` / ``threading.Timer(...)`` call."""

    def __init__(self, call: ast.Call):
        self.call = call
        self.is_timer = last_attr(call.func) == "Timer"
        self.target: Optional[ast.AST] = None
        self.name: Optional[str] = None
        self.daemon = False
        if self.is_timer and len(call.args) >= 2:
            self.target = call.args[1]
        for kw in call.keywords:
            if kw.arg == "target":
                self.target = kw.value
            elif kw.arg == "name":
                if isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
                    self.name = kw.value.value
                elif (
                    isinstance(kw.value, ast.JoinedStr)
                    and kw.value.values
                    and isinstance(kw.value.values[0], ast.Constant)
                ):
                    self.name = str(kw.value.values[0].value)
            elif kw.arg == "daemon":
                if isinstance(kw.value, ast.Constant):
                    self.daemon = bool(kw.value.value)


def _thread_sites(scope: ast.AST) -> Iterator[_ThreadSite]:
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and last_attr(node.func) in {"Thread", "Timer"}:
            yield _ThreadSite(node)


def _resolve_entry(
    site: _ThreadSite,
    methods: Dict[str, ast.FunctionDef],
    enclosing_fn: Optional[ast.AST],
) -> Optional[Tuple[str, ast.AST]]:
    """(entry name, entry function node) for a Thread target, when the
    target is ``self.<method>`` or a nested def in the constructing method."""
    target = site.target
    if target is None:
        return None
    attr = _self_attr(target)
    if attr is not None and attr in methods:
        return attr, methods[attr]
    if isinstance(target, ast.Name) and enclosing_fn is not None:
        for node in ast.walk(enclosing_fn):
            if isinstance(node, ast.FunctionDef) and node.name == target.id:
                return f"<nested {target.id}>", node
    return None


# --------------------------------------------------------------------------
# GL008 — shared-write-without-lock
# --------------------------------------------------------------------------


class _Access:
    __slots__ = ("attr", "write", "locks", "node", "entry")

    def __init__(self, attr: str, write: bool, locks: FrozenSet[str], node: ast.AST, entry: str):
        self.attr = attr
        self.write = write
        self.locks = locks
        self.node = node
        self.entry = entry


def _fn_accesses(
    module: Module,
    fn: ast.AST,
    entry: str,
    extra_locks: FrozenSet[str] = frozenset(),
) -> List[_Access]:
    """All ``self.<attr>`` accesses inside ``fn`` (descending into nested
    defs — closures run on the same thread), with the lock set lexically held
    at each site (plus ``extra_locks`` held at the call site for helpers)."""
    out: List[_Access] = []

    def add(attr: str, write: bool, node: ast.AST) -> None:
        locks = _held_locks_at(module, node, fn) | extra_locks
        out.append(_Access(attr, write, frozenset(locks), node, entry))

    for node in ast.walk(fn):
        attr = _self_attr(node)
        if attr is None:
            continue
        ctx = getattr(node, "ctx", None)
        if isinstance(ctx, (ast.Store, ast.Del)):
            add(attr, True, node)
            continue
        parent = module.parent(node)
        # self.x += 1 — AugAssign target loads in some py versions; normalize.
        if isinstance(parent, ast.AugAssign) and parent.target is node:
            add(attr, True, node)
            continue
        # self.x.append(...) / self.x.update(...) — mutation through a load.
        if (
            isinstance(parent, ast.Attribute)
            and parent.attr in _MUTATORS
            and isinstance(module.parent(parent), ast.Call)
            and module.parent(parent).func is parent  # type: ignore[union-attr]
        ):
            add(attr, True, node)
            continue
        # self.x[k] = ... — subscript store through a load.
        if isinstance(parent, ast.Subscript) and isinstance(
            getattr(parent, "ctx", None), ast.Store
        ):
            add(attr, True, node)
            continue
        add(attr, False, node)
    return out


def _entry_accesses(
    module: Module,
    entry_name: str,
    entry_fn: ast.AST,
    methods: Dict[str, ast.FunctionDef],
) -> List[_Access]:
    """Entry accesses plus one-level helper resolution: ``self.m(...)``
    calls AND ``self.m`` callback references both pull in ``m``'s accesses
    (the producer passes ``self._should_stop`` as a poll callback)."""
    out = _fn_accesses(module, entry_fn, entry_name)
    seen: Set[str] = set()
    for node in ast.walk(entry_fn):
        attr = _self_attr(node)
        if attr is None or attr not in methods or attr in seen:
            continue
        seen.add(attr)
        call_locks = _held_locks_at(module, node, entry_fn)
        out.extend(_fn_accesses(module, methods[attr], entry_name, call_locks))
    return out


def check_gl008(module: Module) -> Iterator[Finding]:
    for cls in module.nodes:
        if not isinstance(cls, ast.ClassDef):
            continue
        methods: Dict[str, ast.FunctionDef] = {
            st.name: st for st in cls.body if isinstance(st, ast.FunctionDef)
        }
        # handoff attrs: self.x = Queue()/Event()/deque(maxlen=...)/...
        handoff: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                attr = _self_attr(node.targets[0])
                v = node.value
                if attr is not None and isinstance(v, ast.Call):
                    fname = last_attr(v.func)
                    if fname in _HANDOFF_CALLS:
                        handoff.add(attr)
                    elif fname == "deque" and any(
                        kw.arg == "maxlen" for kw in v.keywords
                    ):
                        handoff.add(attr)
        # worker entry points: Thread/Timer targets resolving into the class.
        entries: Dict[str, ast.AST] = {}
        for mname, mfn in methods.items():
            for site in _thread_sites(mfn):
                resolved = _resolve_entry(site, methods, mfn)
                if resolved is not None:
                    entries[resolved[0]] = resolved[1]
        if not entries:
            continue
        entry_fns = {id(fn) for fn in entries.values()}
        accesses: List[_Access] = []
        for ename, efn in entries.items():
            accesses.extend(_entry_accesses(module, ename, efn, methods))
        for mname, mfn in methods.items():
            if mname == "__init__" or id(mfn) in entry_fns:
                continue  # __init__ runs before the thread starts
            accesses.extend(_fn_accesses(module, mfn, "<main>"))

        by_attr: Dict[str, List[_Access]] = {}
        for acc in accesses:
            by_attr.setdefault(acc.attr, []).append(acc)
        for attr in sorted(by_attr):
            if attr in handoff or _is_lockish_name(attr) or attr in methods:
                continue
            accs = by_attr[attr]
            writer_entries = {a.entry for a in accs if a.write}
            all_entries = {a.entry for a in accs}
            worker_writes = bool(writer_entries - {"<main>"})
            cross_thread = len(all_entries) >= 2 and writer_entries and (
                len(writer_entries) >= 2 or worker_writes or "<main>" in writer_entries
            )
            if not cross_thread:
                continue
            common = frozenset.intersection(*(a.locks for a in accs))
            if common:
                continue
            bad = next(
                (a for a in accs if a.write and not a.locks),
                next((a for a in accs if not a.locks), accs[0]),
            )
            entries_desc = ", ".join(sorted(all_entries))
            yield module.finding(
                "GL008",
                bad.node,
                f"attribute 'self.{attr}' of {cls.name} is shared across "
                f"thread entry points ({entries_desc}) with writes, but no "
                "common lock covers every access — hold one lock at every "
                "site, or hand the value off via queue.Queue / "
                "threading.Event / deque(maxlen=...) / the sanitize lock "
                "registry",
            )


# --------------------------------------------------------------------------
# GL009 — lock-order inversion (global: the graph spans modules)
# --------------------------------------------------------------------------


#: locks that are one object process-wide, whoever takes them.
_PROCESS_LOCKS = {"_dispatch_lock", LAUNCH_LOCK}


def _lock_node_name(module: Module, with_node: ast.With, lock: str) -> str:
    """Graph node for an acquired lock. The dispatch lock and the launch
    lock are each ONE process-wide node (every taker shares the object);
    other locks are scoped by class so
    unrelated ``self._lock``s in different classes never merge."""
    if lock in _PROCESS_LOCKS:
        return lock
    cls = _enclosing_class(module, with_node)
    if cls is not None:
        return f"{cls.name}.{lock}"
    return f"{module.relpath}:{lock}"


def _module_functions(module: Module) -> Dict[str, ast.FunctionDef]:
    out: Dict[str, ast.FunctionDef] = {}
    for node in module.nodes:
        if isinstance(node, ast.FunctionDef):
            out.setdefault(node.name, node)
    return out


def _lock_edges(module: Module) -> Iterator[Tuple[str, str, ast.AST]]:
    """(held-node, acquired-node, site) edges from lexical nesting plus
    one-level resolution of ``self.m()`` / ``m()`` calls made under a lock."""
    functions = _module_functions(module)
    for fn in list(functions.values()):
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                acquired = _with_locks(node)
                if not acquired:
                    continue
                held = _held_locks_at(module, node, fn)
                held_nodes = {
                    _lock_node_name(module, node, h) for h in held
                }
                for lock in acquired:
                    to = _lock_node_name(module, node, lock)
                    for frm in held_nodes:
                        if frm != to:
                            yield frm, to, node
                # one-level helper resolution: calls under this with
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = _self_attr(sub.func) or (
                        sub.func.id if isinstance(sub.func, ast.Name) else None
                    )
                    helper = functions.get(callee or "")
                    if helper is None or helper is fn:
                        continue
                    for inner in ast.walk(helper):
                        if isinstance(inner, ast.With):
                            for ilock in _with_locks(inner):
                                to = _lock_node_name(module, inner, ilock)
                                for lock in acquired:
                                    frm = _lock_node_name(module, node, lock)
                                    if frm != to:
                                        yield frm, to, sub


def check_gl009(modules: Sequence[Module]) -> Iterator[Finding]:
    graph: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[Module, ast.AST]] = {}
    for module in modules:
        for frm, to, node in _lock_edges(module):
            graph.setdefault(frm, set()).add(to)
            sites.setdefault((frm, to), (module, node))

    # DFS cycle detection with canonicalized dedup.
    reported: Set[Tuple[str, ...]] = set()

    def visit(start: str) -> Iterator[List[str]]:
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for nxt in sorted(graph.get(cur, ())):
                if nxt == start:
                    yield path + [nxt]
                elif nxt not in path and len(path) < 8:
                    stack.append((nxt, path + [nxt]))

    for start in sorted(graph):
        for cycle in visit(start):
            ring = cycle[:-1]
            pivot = ring.index(min(ring))
            canon = tuple(ring[pivot:] + ring[:pivot])
            if canon in reported:
                continue
            reported.add(canon)
            module, node = sites[(cycle[0], cycle[1])]
            yield module.finding(
                "GL009",
                node,
                "lock-order inversion: acquisition cycle "
                f"{' -> '.join(canon + (canon[0],))} — two threads entering "
                "the cycle from different edges deadlock; pick one global "
                "order (dispatch lock outermost) and restructure the inner "
                "acquisition",
            )


# --------------------------------------------------------------------------
# GL010 — unjoined / unregistered thread
# --------------------------------------------------------------------------


def _owner_key(assign_target: ast.AST) -> Optional[str]:
    attr = _self_attr(assign_target)
    if attr is not None:
        return attr
    if isinstance(assign_target, ast.Name):
        return assign_target.id
    return None


def check_gl010(module: Module) -> Iterator[Finding]:
    # joined/cancelled names and post-hoc daemon assignments, module-wide.
    joined: Set[str] = set()
    daemonized: Set[str] = set()
    for node in module.nodes:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in {"join", "cancel"}:
                key = last_attr(node.func.value)
                if key is not None:
                    joined.add(key)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (
                isinstance(t, ast.Attribute)
                and t.attr == "daemon"
                and isinstance(node.value, ast.Constant)
                and node.value.value is True
            ):
                key = last_attr(t.value)
                if key is not None:
                    daemonized.add(key)

    for node in module.nodes:
        if not (isinstance(node, ast.Call) and last_attr(node.func) in {"Thread", "Timer"}):
            continue
        site = _ThreadSite(node)
        if site.target is None and not site.is_timer:
            continue  # Thread subclassing / partial construction: out of scope
        parent = module.parent(node)
        owner = None
        stored_on_self = False
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            owner = _owner_key(parent.targets[0])
            stored_on_self = _self_attr(parent.targets[0]) is not None
        daemon = site.daemon or (owner is not None and owner in daemonized)
        is_joined = owner is not None and owner in joined
        if not daemon and not is_joined:
            yield module.finding(
                "GL010",
                node,
                "thread is neither daemonized nor joined/cancelled anywhere "
                "in this module — it outlives teardown and blocks interpreter "
                "exit; set daemon=True AND join it on the shutdown path",
            )
        # naming contract: long-lived workers stored on self must be visible
        # to the trlx-* teardown leak assertions. Timers cannot take name=.
        if stored_on_self and not site.is_timer:
            if not (site.name or "").startswith("trlx-"):
                yield module.finding(
                    "GL010",
                    node,
                    "worker thread stored on self without a name='trlx-...' "
                    "constant — the teardown leak checks (tests assert no "
                    "live trlx-* threads) cannot see it; name it trlx-<role>",
                )

# --------------------------------------------------------------------------
# GL011 — blocking call under the launch lock
# --------------------------------------------------------------------------

_ZERO_ARG_BLOCKERS = {"get", "join", "wait"}


def _is_launch_with(node: ast.With) -> bool:
    return LAUNCH_LOCK in _with_locks(node)


def _blocking_reason(node: ast.AST) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    name = last_attr(func)
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        if func.value.id == "time" and func.attr == "sleep":
            return "time.sleep() sleeps while holding the launch lock"
    if isinstance(func, ast.Name) and func.id == "open":
        return "file I/O under the launch lock stalls every launcher"
    if isinstance(func, ast.Attribute) and func.attr in _ZERO_ARG_BLOCKERS and not node.args and not node.keywords:
        return f".{func.attr}() with no timeout blocks indefinitely while holding the launch lock"
    if isinstance(func, ast.Attribute) and func.attr == "synchronize":
        return (f"{dotted(func) or '.synchronize'}() waits for the device's queue while holding the launch "
                "lock, so every other thread's launches wait for it too")
    base = dotted(func.value) if isinstance(func, ast.Attribute) else None
    if (name in TORCH_COLLECTIVES and base is not None and base.split(".")[-1] in ("distributed", "dist")) \
            or name == "collective_guard":
        return (f"{name!r} under the launch lock: a slow/dead peer holds the lock up to the collective "
                "deadline and starves every other launcher")
    return None


def check_gl011(module: Module) -> Iterator[Finding]:
    for node in module.nodes:
        if not (isinstance(node, ast.With) and _is_launch_with(node)):
            continue
        for sub in ast.walk(node):
            if sub is node:
                continue
            reason = _blocking_reason(sub)
            if reason is not None:
                yield module.finding(
                    "GL011",
                    sub,
                    f"blocking call under the launch lock: {reason} — move it outside the lock (it guards "
                    "launch counts and graph captures, which must stay short)",
                )


# --------------------------------------------------------------------------
# registry (merged with rules.py by core.lint_paths)
# --------------------------------------------------------------------------

PER_MODULE_RULES = [
    ("GL008", check_gl008),
    ("GL010", check_gl010),
    ("GL011", check_gl011),
]

GLOBAL_RULES = [
    ("GL009", check_gl009),
]
