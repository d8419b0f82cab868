"""The port's own graftlint (``trlx_tpu_torch.analysis``): twins of
``tests/test_analysis.py`` and ``tests/test_concurrency.py``.

- The shared rules (GL000, GL005, GL007–GL010) keep the JAX logic: every
  fixture source of the JAX package's two lint test files goes through both
  linters and gives the same (rule, line) findings, and the port's linter
  run over ``trlx_tpu/`` gives the JAX linter's findings there.
- The torch twins (GL001 graph-capture home, GL003 capture purity, GL004
  torch collectives, GL006 kernel provenance, GL011 blocking under the
  launch lock) fire on their fixtures and come back clean on the fixed ones.
- The CLI's exit codes and JSON, the refused GL002, the stdlib-only import,
  and the real tree (the port and ``chip_smoke.py``) clean under every rule.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from trlx_tpu.analysis import lint_paths as jax_lint_paths
from trlx_tpu_torch.analysis import REFUSED, RULE_TITLES, lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("GL000", "GL005", "GL007", "GL008", "GL009", "GL010")


def _lint_source(tmp_path, source, relpath="fixture.py", select=None, lint=lint_paths):
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    findings, _ = lint([str(path)], select=select)
    return findings


def _active(findings, rule):
    return [f for f in findings if not f.suppressed and f.rule == rule]


def _keys(findings):
    return sorted((f.rule, f.line, f.col, f.suppressed, f.reason) for f in findings)


# ------------------------------------------------- shared rules: JAX twins


def _jax_fixture_sources():
    """Every multi-line string assigned in the JAX package's lint tests that
    parses as Python: the fixture sources, module constants and inline."""
    out = []
    for name in ("test_analysis.py", "test_concurrency.py"):
        path = os.path.join(REPO, "tests", name)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str) and "\n" in node.value.value):
                continue
            src = textwrap.dedent(node.value.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.append(pytest.param(src, id=f"{name[5:-3]}:{node.lineno}"))
    return out


FIXTURES = _jax_fixture_sources()


@pytest.mark.parametrize("relpath", ["fixture.py", "data/configs.py"])
@pytest.mark.parametrize("source", FIXTURES)
def test_shared_rules_agree_with_the_jax_linter(tmp_path, source, relpath):
    port = _lint_source(tmp_path / "port", source, relpath, select=SHARED)
    ref = _lint_source(tmp_path / "jax", source, relpath, select=SHARED, lint=jax_lint_paths)
    assert [(f.rule, f.line) for f in port] == [(f.rule, f.line) for f in ref]
    assert _keys(port) == _keys(ref)


def test_the_shared_fixtures_exercise_every_shared_rule(tmp_path):
    """The agreement above is not vacuous: between them the fixtures make
    each shared rule fire."""
    assert len(FIXTURES) > 40
    fired = set()
    for i, p in enumerate(FIXTURES):
        for relpath in ("fixture.py", "data/configs.py"):
            fired |= {f.rule for f in _lint_source(tmp_path / str(i), p.values[0], relpath, select=SHARED)}
    assert fired == set(SHARED)


def test_port_linter_over_the_jax_package_matches_the_jax_linter(monkeypatch):
    monkeypatch.chdir(REPO)
    port, n_port = lint_paths(["trlx_tpu"], select=SHARED)
    ref, n_ref = jax_lint_paths(["trlx_tpu"], select=SHARED)
    assert n_port == n_ref > 50
    assert [(f.rule, f.path, f.line, f.col, f.suppressed) for f in port] == \
        [(f.rule, f.path, f.line, f.col, f.suppressed) for f in ref]


def test_gl007_sanitize_mirror_matches_the_ports_exporter():
    from trlx_tpu_torch.analysis.rules import _sanitize
    from trlx_tpu_torch.observability.export import sanitize_metric_name

    for name in ["ppo/policy_loss", "engine.tps", "a b", "9lives", "watchdog-fires", "nested/a.b-c", "ok_name",
                 ":colon", "Ünïcode/x"]:
        assert _sanitize(name) == sanitize_metric_name(name), name


# ------------------------------------------------- GL001 graph-capture home

GL001_VIOLATION = """
import torch

def time_it(fn):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.capture_begin()
"""

GL001_HOME_CLEAN = """
import torch
from trlx_tpu_torch.ops import cuda_lib

class CudaGraph:
    def __init__(self):
        self._graph = torch.cuda.CUDAGraph()

    def capture(self):
        return torch.cuda.graph(self._graph, capture_error_mode="thread_local")

class StepGraph:
    def __init__(self, fn, graph):
        with cuda_lib.launch_lock:
            with graph.capture():
                fn()
"""

GL001_HOME_VIOLATION = """
import torch

class CudaGraph:
    def capture(self):
        return torch.cuda.graph(self._graph)

class StepGraph:
    def __init__(self, fn, graph):
        with graph.capture():
            fn()
"""


def test_gl001_fires_outside_the_capture_home(tmp_path):
    hits = _active(_lint_source(tmp_path, GL001_VIOLATION, "engine/timer.py"), "GL001")
    assert [h.line for h in hits] == [5, 6, 8]
    assert all("ops/cuda_graph.py" in h.message for h in hits)


def test_gl001_home_is_clean_when_thread_local_under_the_launch_lock(tmp_path):
    assert _active(_lint_source(tmp_path, GL001_HOME_CLEAN, "ops/cuda_graph.py"), "GL001") == []


def test_gl001_home_fires_on_global_mode_and_an_unlocked_capture(tmp_path):
    hits = _active(_lint_source(tmp_path, GL001_HOME_VIOLATION, "ops/cuda_graph.py"), "GL001")
    assert [h.line for h in hits] == [6, 10]
    assert "thread_local" in hits[0].message and "launch_lock" in hits[1].message


def test_gl001_sees_from_imports_and_waives_with_a_reason(tmp_path):
    src = """
    from torch.cuda import CUDAGraph as G

    def f():
        return G()

    def g():
        return G()  # graftlint: disable=GL001 -- a probe that runs with no other thread
    """
    findings = _lint_source(tmp_path, src, "probe.py")
    assert [h.line for h in _active(findings, "GL001")] == [5]
    assert [f.reason for f in findings if f.suppressed] == ["a probe that runs with no other thread"]


# ------------------------------------------------- GL003 capture purity

GL003_VIOLATION = """
import time
import torch
from trlx_tpu_torch.ops.cuda_graph import CudaGraph, StepGraph

def _make_step(buf):
    def step_fn():
        n = buf["step"].item()
        buf["x"].add_(torch.zeros(4))
        time.perf_counter()
        torch.cuda.synchronize()
        print(n)
    return step_fn

def generate(buf):
    if buf.get("step_fn") is None:
        buf["step_fn"] = _make_step(buf)
    buf["step_fn"]()
    buf["graph"] = StepGraph(buf["step_fn"], CudaGraph())
"""

GL003_CLEAN = """
import torch
from trlx_tpu_torch.ops.cuda_graph import CudaGraph, StepGraph

class Engine:
    def __init__(self, spec):
        self._verify = self._verify_call if spec else None

    def _decode(self):
        call = self._verify or self._decode_call
        call()
        self._graph = StepGraph(call, CudaGraph())

    def _decode_call(self):
        ones = torch.ones((4, 1), dtype=torch.int32, device=self.dev)
        self.state.add_(ones)

    def _verify_call(self):
        self.state.mul_(torch.arange(4, device=self.dev))
"""


def test_gl003_fires_on_host_effects_in_a_captured_closure(tmp_path):
    """The callable reaches StepGraph through a dict slot assigned from a
    closure-returning function (ops/generate.py's shape)."""
    hits = _active(_lint_source(tmp_path, GL003_VIOLATION), "GL003")
    assert [h.line for h in hits] == [8, 9, 10, 11, 12]
    assert "step_fn" in hits[0].message and ".item()" in hits[0].message
    assert "without device=" in hits[1].message


def test_gl003_resolves_methods_through_an_or_and_is_clean(tmp_path):
    """``self._verify or self._decode_call`` (the engine's shape), with the
    attribute bound to a method or None."""
    assert _lint_source(tmp_path, GL003_CLEAN, select=["GL003"]) == []


def test_gl003_an_unresolvable_capture_is_itself_a_finding(tmp_path):
    src = """
    from trlx_tpu_torch.ops.cuda_graph import CudaGraph, StepGraph

    def capture(fn):
        return StepGraph(fn, CudaGraph())
    """
    hits = _active(_lint_source(tmp_path, src), "GL003")
    assert len(hits) == 1 and "cannot resolve" in hits[0].message


def test_gl003_host_calls_outside_the_captured_callable_are_fine(tmp_path):
    src = """
    import torch
    from trlx_tpu_torch.ops.cuda_graph import CudaGraph, StepGraph

    def run(x):
        step = lambda: x.add_(1)
        g = StepGraph(step, CudaGraph())
        g.replay()
        torch.cuda.synchronize()
        return x.item()
    """
    assert _active(_lint_source(tmp_path, src), "GL003") == []


# ------------------------------------------------- GL004 torch collectives

GL004_SOURCE = """
import torch.distributed as dist
from trlx_tpu_torch.resilience.distributed import collective_guard

def f(x):
    dist.all_reduce(x)
    with collective_guard('g'):
        dist.barrier()
    torch.distributed.broadcast(x, 0)
    dist.get_rank()
"""


def test_gl004_fires_on_bare_torch_collectives(tmp_path):
    hits = _active(_lint_source(tmp_path, GL004_SOURCE, "trainer/x.py"), "GL004")
    assert [(h.line, h.message.split("'")[1]) for h in hits] == [(6, "all_reduce"), (9, "broadcast")]


def test_gl004_the_collectives_module_is_exempt(tmp_path):
    assert _active(_lint_source(tmp_path, GL004_SOURCE, "parallel/collectives.py"), "GL004") == []


# ------------------------------------------------- GL006 kernel provenance

CUDA_LIB = """
import ctypes
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "scale_kernel": [_P, _P, _I, _P],  # x y n stream
    "occupancy": [_I],
}
"""

KERNEL_CU = """
#include <cuda_runtime.h>
extern "C" int scale_kernel(const void* x, void* y,
                            int n,  // elements
                            void* stream) {
  return 0;
}
extern "C" int occupancy(int bx) { return bx; }
"""

WRAPPER = """
import torch
from trlx_tpu_torch.ops import cuda_lib

def scale_plain(x):
    return x * 2

def scale(x):
    if x.device.type == "cpu":
        return scale_plain(x)
    y = torch.empty_like(x)
    err = cuda_lib.lib().scale_kernel(x.data_ptr(), y.data_ptr(), x.numel(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "scale_kernel")
    cuda_lib.count_launch(scale)
    return y

def fits(bx):
    lib = cuda_lib.lib()
    return lib.occupancy(bx)
"""


def _kernel_tree(tmp_path, wrapper=WRAPPER, cuda_lib=CUDA_LIB, cu=KERNEL_CU):
    (tmp_path / "ops").mkdir(parents=True)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "ops" / "cuda_lib.py").write_text(textwrap.dedent(cuda_lib))
    (tmp_path / "ops" / "scale.py").write_text(textwrap.dedent(wrapper))
    (tmp_path / "csrc" / "scale.cu").write_text(textwrap.dedent(cu))
    findings, _ = lint_paths([str(tmp_path)], select=["GL006"])
    return findings


@pytest.fixture
def occupancy_helper(monkeypatch):
    from trlx_tpu_torch.analysis import rules

    monkeypatch.setitem(rules.C_HELPERS, "occupancy", "returns an occupancy; launches nothing")


def test_gl006_clean_kernel_tree(tmp_path, occupancy_helper):
    assert _kernel_tree(tmp_path) == []


def test_gl006_an_unnamed_helper_is_a_launch_without_check(tmp_path):
    hits = _active(_kernel_tree(tmp_path), "GL006")
    assert len(hits) == 1 and "'occupancy'" in hits[0].message and "check" in hits[0].message


def test_gl006_fires_on_an_arity_mismatch(tmp_path, occupancy_helper):
    bad = CUDA_LIB.replace("[_P, _P, _I, _P]", "[_P, _P, _P]")
    hits = _active(_kernel_tree(tmp_path, cuda_lib=bad), "GL006")
    assert len(hits) == 1
    assert "lists 3 argtypes" in hits[0].message and "scale.cu:3 takes 4" in hits[0].message


def test_gl006_fires_on_an_unbound_entry_and_on_a_missing_definition(tmp_path, occupancy_helper):
    cu = KERNEL_CU + 'extern "C" int stray(void) { return 0; }\n'
    lib = CUDA_LIB.replace('    "occupancy": [_I],\n', '    "occupancy": [_I],\n    "gone": [_P],\n')
    msgs = [f.message for f in _active(_kernel_tree(tmp_path, cuda_lib=lib, cu=cu), "GL006")]
    assert len(msgs) == 2
    assert any("'gone'" in m and "no extern" in m for m in msgs)
    assert any("'stray'" in m and "not bound" in m for m in msgs)


def test_gl006_fires_on_a_launch_of_an_unknown_entry(tmp_path, occupancy_helper):
    wrapper = WRAPPER.replace("return lib.occupancy(bx)", "return lib.occupancy_v2(bx)")
    msgs = [f.message for f in _active(_kernel_tree(tmp_path, wrapper=wrapper), "GL006")]
    assert any("'occupancy_v2' is not a key of cuda_lib._SIGNATURES" in m for m in msgs)


def test_gl006_fires_on_an_unchecked_launch(tmp_path, occupancy_helper):
    wrapper = WRAPPER.replace('    cuda_lib.check(err, "scale_kernel")\n', "")
    hits = _active(_kernel_tree(tmp_path, wrapper=wrapper), "GL006")
    assert len(hits) == 1 and "does not reach cuda_lib.check" in hits[0].message
    wrong = WRAPPER.replace('cuda_lib.check(err, "scale_kernel")', 'cuda_lib.check(err, "scale")')
    assert len(_active(_kernel_tree(tmp_path / "w", wrapper=wrong), "GL006")) == 1


def test_gl006_fires_on_a_fallback_to_the_plain_version(tmp_path, occupancy_helper):
    """The no-fallback rule: ``try: launch / except: return x_plain(...)``."""
    wrapper = WRAPPER.replace(
        '    err = cuda_lib.lib().scale_kernel(x.data_ptr(), y.data_ptr(), x.numel(), cuda_lib.stream_ptr(x.device))\n'
        '    cuda_lib.check(err, "scale_kernel")\n',
        '    try:\n'
        '        err = cuda_lib.lib().scale_kernel(x.data_ptr(), y.data_ptr(), x.numel(), 0)\n'
        '        cuda_lib.check(err, "scale_kernel")\n'
        '    except RuntimeError:\n'
        '        return scale_plain(x)\n')
    hits = _active(_kernel_tree(tmp_path, wrapper=wrapper), "GL006")
    assert len(hits) == 1 and "falls back to 'scale_plain'" in hits[0].message
    # A try whose handler re-raises is no fallback.
    reraise = wrapper.replace("        return scale_plain(x)\n", "        raise\n")
    assert _active(_kernel_tree(tmp_path / "r", wrapper=reraise), "GL006") == []


def test_gl006_fires_without_a_plain_twin_or_a_launch_count(tmp_path, occupancy_helper):
    wrapper = WRAPPER.replace("    cuda_lib.count_launch(scale)\n", "").replace("scale_plain", "scale_ref")
    hits = _active(_kernel_tree(tmp_path, wrapper=wrapper), "GL006")
    assert len(hits) == 1
    assert "*_plain counterpart and cuda_lib.count_launch" in hits[0].message


def test_gl006_the_ports_c_interface_is_parsed_whole():
    """Every ``_SIGNATURES`` entry of the port has its ``extern "C"``
    definition with as many parameters (multi-line lists included), and the
    one C helper is named."""
    from trlx_tpu_torch.analysis.core import load_modules
    from trlx_tpu_torch.analysis.rules import C_HELPERS, _signatures, c_entries

    (module,), _ = load_modules([os.path.join(REPO, "trlx_tpu_torch", "ops", "cuda_lib.py")])
    _, sigs = _signatures(module)
    entries = c_entries(os.path.join(REPO, "trlx_tpu_torch", "csrc"))
    assert len(sigs) == 15 and set(sigs) == set(entries)
    assert {k: n for k, (n, _) in sigs.items()} == {k: n for k, (n, _, _) in entries.items()}
    assert entries["paged_decode_attn_int8"][0] == 29 and entries["w8a16_max_clusters"][0] == 3
    assert set(C_HELPERS) == {"w8a16_max_clusters"}


# ------------------------------------------------- GL011 launch lock

GL011_VIOLATION = """
import time
import torch
from trlx_tpu_torch.ops import cuda_lib

def capture(q, fn):
    with cuda_lib.launch_lock:
        time.sleep(0.1)
        item = q.get()
        torch.cuda.synchronize()
        with open("trace.json", "w") as f:
            f.write(fn())
"""

GL011_CLEAN = """
import time
import torch
from trlx_tpu_torch.ops import cuda_lib

def count(fn, q):
    torch.cuda.synchronize()
    with cuda_lib.launch_lock:
        fn.launches += 1
        item = q.get(timeout=1.0)
    time.sleep(0.1)
    with fn._lock:
        time.sleep(0.1)
"""


def test_gl011_fires_on_blocking_calls_under_the_launch_lock(tmp_path):
    hits = _active(_lint_source(tmp_path, GL011_VIOLATION), "GL011")
    assert [h.line for h in hits] == [8, 9, 10, 11]
    assert "synchronize" in hits[2].message


def test_gl011_clean_outside_the_lock_and_with_timeouts(tmp_path):
    assert _active(_lint_source(tmp_path, GL011_CLEAN), "GL011") == []


def test_gl009_the_launch_lock_is_one_node_across_modules(tmp_path):
    """Two modules take ``launch_lock`` and a lock of their own in opposite
    orders: one cycle, although neither module sees it alone."""
    a = ("from trlx_tpu_torch.ops import cuda_lib\n"
         "class A:\n"
         "    def f(self):\n"
         "        with cuda_lib.launch_lock:\n"
         "            with self.state_lock:\n"
         "                pass\n")
    b = ("from trlx_tpu_torch.ops import cuda_lib\n"
         "class A:\n"
         "    def g(self):\n"
         "        with self.state_lock:\n"
         "            with cuda_lib.launch_lock:\n"
         "                pass\n")
    (tmp_path / "a.py").write_text(a)
    (tmp_path / "b.py").write_text(b)
    findings, _ = lint_paths([str(tmp_path)], select=["GL009"])
    assert len(findings) == 1 and "launch_lock" in findings[0].message


# --------------------------------------------------------- tree-wide gates


def test_real_tree_lints_clean_under_every_rule(monkeypatch):
    monkeypatch.chdir(REPO)
    findings, n_files = lint_paths(["trlx_tpu_torch", "chip_smoke.py"])
    assert n_files > 75
    assert [f.render() for f in findings if not f.suppressed] == []
    assert all(f.reason for f in findings if f.suppressed)


def test_rule_titles_cover_the_registered_rules_and_the_refused_one():
    from trlx_tpu_torch.analysis import concurrency, rules

    registered = {rid for rid, _ in rules.PER_MODULE_RULES + rules.GLOBAL_RULES + concurrency.PER_MODULE_RULES
                  + concurrency.GLOBAL_RULES}
    assert registered | {"GL000"} | set(REFUSED) == set(RULE_TITLES)
    assert not registered & set(REFUSED)


# --------------------------------------------------------------------- CLI


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "trlx_tpu_torch.analysis", *args], cwd=REPO,
                          capture_output=True, text=True)


def test_cli_json_output_and_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GL004_SOURCE))
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent(GL003_CLEAN))
    proc = _cli(str(bad), "--json")
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload["tool"] == "graftlint" and payload["files"] == 1
    assert set(payload["rules"]) == set(RULE_TITLES)
    assert sorted(f["line"] for f in payload["findings"] if f["rule"] == "GL004") == [6, 9]
    assert set(payload["findings"][0]) == {"rule", "path", "line", "col", "message", "suppressed", "reason"}
    proc = _cli(str(good))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("graftlint: 0 finding(s) (0 suppressed) in 1 file(s)")


def test_cli_rejects_an_unknown_and_a_refused_selector(tmp_path):
    proc = _cli("--select", "GL999", str(tmp_path))
    assert proc.returncode == 2 and "GL999" in proc.stderr
    proc = _cli("--select", "GL004,GL002", str(tmp_path))
    assert proc.returncode == 2 and "GL002 is refused: PyTorch has no buffer donation" in proc.stderr


def test_list_rules_shows_the_families_and_gl002_refused():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    out = proc.stdout
    assert "invariant (graftlint):" in out and "concurrency (graftrace):" in out
    assert "refused (no check in the port):\n  GL002  PyTorch has no buffer donation" in out
    for rule in RULE_TITLES:
        assert rule in out
    assert "REQUIRED" in out


def test_the_lint_imports_neither_torch_nor_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "for name in ('torch', 'jax', 'jaxlib', 'numpy'):\n"
        "    sys.modules[name] = None\n"
        "import importlib.abc\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'trlx_tpu' or name.startswith('trlx_tpu.'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import trlx_tpu_torch.analysis.__main__ as cli\n"
        "from trlx_tpu_torch.analysis import lint_paths\n"
        "findings, n = lint_paths(['trlx_tpu_torch/analysis', 'trlx_tpu_torch/ops/cuda_lib.py'])\n"
        "assert n == 6 and not [f for f in findings if not f.suppressed]\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax') and sys.modules[m]]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
