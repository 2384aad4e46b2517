"""The port's ffcheck (``dlrm_flexflow_tpu_torch/analysis``) held to the
JAX package's analyzer.

* the framework-neutral passes give the JAX analyzer's findings on the
  same source: the ``scripts/check_analysis.py`` scenarios and their
  silent counterparts, compared as ``(path, line, code, waiver_key)``;
* each JAX-specific pass fires with the JAX code at the corresponding
  line of a transliterated pair (a JAX snippet and its torch twin), and
  each silent twin stays silent;
* the engine behaves as JAX's: waivers, stale waivers, the JSON
  document, SARIF, the baseline update, ``--changed-only``;
* the port's own tree is clean or waived with the committed
  ``analysis/waivers.txt``, and the analyzer imports nothing of JAX.

Stdlib trees under ``tmp_path``; nothing is imported or executed from
them.  No wall-clock assertion (the analyzer's time is measured on an
unloaded host by ``chip_smoke.py`` phase 36).
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import dlrm_flexflow_tpu.analysis as J  # noqa: E402
import dlrm_flexflow_tpu_torch.analysis as T  # noqa: E402
from dlrm_flexflow_tpu.analysis.__main__ import main as j_main  # noqa: E402
from dlrm_flexflow_tpu_torch.analysis.__main__ import main as t_main  # noqa: E402
from dlrm_flexflow_tpu_torch.analysis.passes import PASSES as T_PASSES  # noqa: E402
from dlrm_flexflow_tpu_torch.analysis.passes._entries import (  # noqa: E402
    all_capture_entries, capture_reach)
from scripts import check_analysis as smoke  # noqa: E402

NEUTRAL = ["lock-discipline", "blocking-under-lock", "thread-lifecycle",
           "bounded-growth", "shared-state", "barrier-protocol"]
PKG = "dlrm_flexflow_tpu_torch"


# ------------------------------------------------------------------ helpers
def _tree(root, files):
    """Write a fixture tree; every package dir gets an __init__.py."""
    for rel, src in files.items():
        path = os.path.join(root, rel)
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        while os.path.relpath(d, root) != ".":
            init = os.path.join(d, "__init__.py")
            if not os.path.exists(init):
                open(init, "w").close()
            d = os.path.dirname(d)
        with open(path, "w") as f:
            f.write(src)
    return str(root)


def _roots(files):
    return sorted({rel.split("/")[0] for rel in files})


def _keys(result):
    return [(f.path, f.line, f.code, f.waiver_key) for f in result.findings]


def _run(mod, root, files, passes, **kw):
    return mod.run_analysis(repo=root, roots=_roots(files),
                            pass_names=passes, **kw)


# -------------------------------------------------- neutral-pass parity
#: the check_analysis.py scenarios on framework-neutral passes (each
#: snippet holds the bad shape next to its sanctioned twin), plus
#: silent-only counterparts; the blocking scenario's device sync becomes
#: an Event wait, the neutral spelling of "blocking through a helper"
SCENARIOS = {
    "emit-under-lock": smoke.BAD_SNIPPET,
    "emit-outside-lock": smoke.BAD_SNIPPET.replace(
        "        with self._lock:\n            self.n += 1\n"
        "            emit(", "        with self._lock:\n"
        "            self.n += 1\n        emit("),
    "blocking-through-helper": smoke.BLOCKING_SNIPPET.replace(
        "y.block_until_ready()", "y.wait()"),
    "thread-without-join": smoke.LIFECYCLE_SNIPPET,
    "uncapped-growth": smoke.GROWTH_SNIPPET,
    "fence-retry-and-manifest": smoke.BARRIER_SNIPPET,
    "podshard-protocol-only": smoke.BARRIER_SNIPPET[
        smoke.BARRIER_SNIPPET.index("class GoodMgr"):].replace(
        "class GoodMgr", "import json\nimport os\nimport shutil\n"
        "import time\n\n\nclass GoodMgr"),
    "shared-attr-no-lock": (
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.count = 0\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._run, daemon=True)\n"
        "        self._t.start()\n"
        "    def _run(self):\n"
        "        with self._lock:\n"
        "            self.count += 1\n"
        "    def read(self):\n"
        "        return self.count\n"
        "    def stop(self):\n"
        "        self._t.join()\n"),
    "lock-order-inversion": (
        "import threading\n"
        "A = threading.Lock()\n"
        "B = threading.Lock()\n"
        "def f():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
        "def g():\n"
        "    with B:\n"
        "        with A:\n"
        "            pass\n"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_neutral_passes_match_jax(tmp_path, name):
    files = {"pkg/serving/injected.py": SCENARIOS[name]}
    root = _tree(tmp_path, files)
    jax_res = _run(J, root, files, NEUTRAL)
    port_res = _run(T, root, files, NEUTRAL)
    assert _keys(port_res) == _keys(jax_res)
    silent_only = name in ("emit-outside-lock", "podshard-protocol-only")
    assert bool(jax_res.findings) != silent_only, _keys(jax_res)


# --------------------------------------------------- transliterated pairs
#: (pass, JAX snippet, torch twin, code, line) — both must fire ``code``
#: at ``line``; the silent pairs below must stay silent in both
FIRING_PAIRS = {
    "blocking-device-sync": (
        "blocking-under-lock",
        "import threading\n"
        "class E:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def _wait(self, y):\n"
        "        return y.block_until_ready()\n"
        "    def step(self, y):\n"
        "        with self._lock:\n"
        "            self._wait(y)\n",
        "import threading\n"
        "class E:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def _wait(self, y):\n"
        "        return y.item()\n"
        "    def step(self, y):\n"
        "        with self._lock:\n"
        "            self._wait(y)\n",
        "device-sync-under-lock", 6),
    "purity-host-sync": (
        "trace-purity",
        "import jax\n"
        "def f(x):\n"
        "    y = x * 2\n"
        "    y.block_until_ready()\n"
        "    return y\n"
        "g = jax.jit(f)\n",
        "from graphs import GraphRunner\n"
        "def f(static, state):\n"
        "    y = static['x'] * 2\n"
        "    y.item()\n"
        "    return y\n"
        "def build(x):\n"
        "    return GraphRunner(f, {'x': x})\n",
        "host-sync-in-trace", 4),
    "purity-host-clock": (
        "trace-purity",
        "import time\n"
        "import jax\n"
        "def f(x):\n"
        "    return x * time.perf_counter()\n"
        "g = jax.jit(f)\n",
        "import time\n"
        "from graphs import GraphRunner\n"
        "def f(static, state):\n"
        "    return static['x'] * time.perf_counter()\n"
        "def build(x):\n"
        "    return GraphRunner(f, {'x': x})\n",
        "host-clock-in-trace", 4),
    "staleness-attr": (
        "trace-staleness",
        "import jax\n"
        "class Op:\n"
        "    def __init__(self):\n"
        "        self.scale = 1.0\n"
        "    def retune(self, s):\n"
        "        self.scale = s\n"
        "    def forward(self, x):\n"
        "        return x * self.scale\n",
        "import torch\n"
        "class Op:\n"
        "    def __init__(self):\n"
        "        self.scale = 1.0\n"
        "    def retune(self, s):\n"
        "        self.scale = s\n"
        "    def forward(self, x):\n"
        "        return x * self.scale\n",
        "stale-attr-read", 8),
    "recompile-per-call": (
        "recompile-hazard",
        "import jax\n"
        "def f(x):\n"
        "    return x\n"
        "def serve(x):\n"
        "    return jax.jit(f)(x)\n",
        "from graphs import GraphRunner\n"
        "def f(static, state):\n"
        "    return static['x']\n"
        "def serve(x):\n"
        "    return GraphRunner(f, {'x': x}).run({'x': x})\n",
        "jit-per-call", 5),
    "recompile-data-key": (
        "recompile-hazard",
        "import jax\n"
        "def f(x, n):\n"
        "    return x[:n]\n"
        "def serve(x):\n"
        "    g = jax.jit(f, static_argnums=(1,))\n"
        "    return g(x, x.sum().item())\n",
        "from graphs import GraphRunner\n"
        "\n"
        "class S:\n"
        "    def serve(self, x):\n"
        "        n = x.sum().item()\n"
        "        self._graphs[n] = GraphRunner(self.f, {'x': x})\n",
        "data-derived-static", 6),
    "donation-reuse": (
        "donation-safety",
        "import jax\n"
        "def step(s, x):\n"
        "    return s\n"
        "def train(state, x):\n"
        "    g = jax.jit(step, donate_argnums=(0,))\n"
        "    new = g(state, x)\n"
        "    return state, new\n",
        "def step(s, x):\n"
        "    return s\n"
        "\n"
        "\n"
        "def train(model, state, x):\n"
        "    new = model.train_step(state, x, x)\n"
        "    return state, new\n",
        "donated-arg-reuse", 7),
    "divergence-gated-barrier": (
        "collective-divergence",
        "import jax\n"
        "from jax.experimental import multihost_utils\n"
        "def commit(path):\n"
        "    if jax.process_index() == 0:\n"
        "        multihost_utils.sync_global_devices('commit')\n",
        "import torch.distributed as dist\n"
        "\n"
        "def commit(path):\n"
        "    if dist.get_rank() == 0:\n"
        "        dist.barrier()\n",
        "collective-in-divergent-branch", 5),
    "divergence-early-return": (
        "collective-divergence",
        "import jax\n"
        "from jax.experimental import multihost_utils\n"
        "def commit(path, pidx):\n"
        "    if pidx != 0:\n"
        "        return\n"
        "    multihost_utils.sync_global_devices('commit')\n",
        "import torch.distributed as dist\n"
        "\n"
        "def commit(path, rank):\n"
        "    if rank != 0:\n"
        "        return\n"
        "    dist.barrier()\n",
        "collective-after-divergent-return", 6),
}

SILENT_PAIRS = {
    "blocking-wait-outside": (
        "blocking-under-lock",
        "import threading\n"
        "class E:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def step(self, x):\n"
        "        with self._lock:\n"
        "            y = x * 2\n"
        "        y.block_until_ready()\n"
        "        return y\n",
        "import threading\n"
        "class E:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def step(self, runner, x):\n"
        "        with self._lock:\n"
        "            out = runner.run_locked(x)\n"
        "        return out.cpu().numpy()\n"),
    "purity-clean-body": (
        "trace-purity",
        "import jax\n"
        "def f(x):\n"
        "    return x * 2\n"
        "g = jax.jit(f)\n"
        "def host(x):\n"
        "    return g(x).block_until_ready()\n",
        "from graphs import GraphRunner\n"
        "def f(static, state):\n"
        "    return static['x'] * 2\n"
        "def host(x):\n"
        "    return GraphRunner(f, {'x': x}).static['x'].item()\n"),
    "staleness-setup-only": (
        "trace-staleness",
        "import jax\n"
        "class Op:\n"
        "    def __init__(self):\n"
        "        self.scale = 1.0\n"
        "    def forward(self, x):\n"
        "        return x * self.scale\n",
        "import torch\n"
        "class Op:\n"
        "    def __init__(self):\n"
        "        self.scale = 1.0\n"
        "    def forward(self, x):\n"
        "        return x * self.scale\n"),
    "recompile-keyed-cache": (
        "recompile-hazard",
        "import jax\n"
        "def f(x):\n"
        "    return x\n"
        "fns = {}\n"
        "def warm(buckets):\n"
        "    for b in buckets:\n"
        "        fns[b] = jax.jit(f)\n",
        "from graphs import GraphRunner\n"
        "class S:\n"
        "    def _ensure(self, b, dummy):\n"
        "        runner = GraphRunner(self.f, dummy)\n"
        "        self._graphs[b] = runner\n"
        "        return runner\n"),
    "donation-rebound": (
        "donation-safety",
        "import jax\n"
        "def step(s, x):\n"
        "    return s\n"
        "def train(state, x):\n"
        "    g = jax.jit(step, donate_argnums=(0,))\n"
        "    state = g(state, x)\n"
        "    return state\n",
        "def train(model, state, x, y):\n"
        "    state, m = model.train_step(state, x, y)\n"
        "    kept, m2 = model.train_step(state, x, y, False)\n"
        "    return state, kept\n"),
    "divergence-commit-after-barrier": (
        "collective-divergence",
        "from jax.experimental import multihost_utils\n"
        "def commit(path, pidx):\n"
        "    multihost_utils.sync_global_devices('written')\n"
        "    if pidx == 0:\n"
        "        with open(path, 'w') as f:\n"
        "            f.write('{}')\n",
        "import torch.distributed as dist\n"
        "def commit(path, rank):\n"
        "    dist.barrier()\n"
        "    if rank == 0:\n"
        "        with open(path, 'w') as f:\n"
        "            f.write('{}')\n"),
}


#: each pair runs in its own package's ops unit (op forwards are capture
#: entries in both analyzers)
_PKGS = {"j": "dlrm_flexflow_tpu", "t": PKG}


@pytest.mark.parametrize("name", sorted(FIRING_PAIRS))
def test_transliterated_pair_fires_alike(tmp_path, name):
    pass_name, jax_src, torch_src, code, line = FIRING_PAIRS[name]
    got = []
    for mod, src, sub in ((J, jax_src, "j"), (T, torch_src, "t")):
        files = {f"{_PKGS[sub]}/ops/m.py": src}
        root = _tree(tmp_path / sub, files)
        res = _run(mod, root, files, [pass_name])
        got.append([(f.line, f.code) for f in res.findings])
    assert got[0] == got[1] == [(line, code)], got


@pytest.mark.parametrize("name", sorted(SILENT_PAIRS))
def test_transliterated_twin_stays_silent(tmp_path, name):
    pass_name, jax_src, torch_src = SILENT_PAIRS[name]
    for mod, src, sub in ((J, jax_src, "j"), (T, torch_src, "t")):
        files = {f"{_PKGS[sub]}/ops/m.py": src}
        root = _tree(tmp_path / sub, files)
        res = _run(mod, root, files, [pass_name])
        assert res.findings == [], (mod.__name__, _keys(res))


def test_mesh_axis_pair(tmp_path):
    """A misspelled axis fires undeclared-axis in both; the port's raw
    collective outside parallel/collectives.py fires direct-collective
    as JAX's direct shard_map import fires direct-shard-map."""
    files = {"pkg/m.py": smoke.AXIS_SNIPPET}
    jres = _run(J, _tree(tmp_path / "j", files), files, ["mesh-axis"])
    assert sorted(f.code for f in jres.findings) == \
        ["direct-shard-map", "undeclared-axis"]
    tfiles = {
        f"{PKG}/parallel/mesh.py": 'DATA_AXIS = "data"\n'
                                   'MODEL_AXIS = "model"\n',
        f"{PKG}/parallel/collectives.py": (
            "import torch.distributed as dist\n"
            "def psum(x, mesh, axes):\n"
            "    pg, ranks, _ = mesh.group(axes)\n"
            "    dist.all_reduce(x, group=pg)\n"
            "    return x\n"),
        f"{PKG}/ops/lookup.py": (
            "import torch.distributed as dist\n"
            "from ..parallel import collectives\n"
            "from ..parallel.mesh import MODEL_AXIS\n"
            "def lookup(t, mesh):\n"
            "    a = collectives.psum(t, mesh, ('modell',))\n"
            "    b = collectives.psum(t, mesh, (MODEL_AXIS,))\n"
            "    n = mesh.axis_size(('data', 'seq'))\n"
            "    dist.broadcast(t, src=0)\n"
            "    return a, b, n\n"),
    }
    tres = _run(T, _tree(tmp_path / "t", tfiles), tfiles, ["mesh-axis"])
    got = sorted((f.path.split("/")[-1], f.line, f.code)
                 for f in tres.findings)
    assert got == [("lookup.py", 5, "undeclared-axis"),
                   ("lookup.py", 7, "undeclared-axis"),
                   ("lookup.py", 8, "direct-collective")], got


def test_layering_pair(tmp_path):
    """An upward module-level import fires upward-import in both
    packages' DAGs; the downward one stays silent."""
    for mod, pkg, sub in ((J, "dlrm_flexflow_tpu", "j"), (T, PKG, "t")):
        files = {f"{pkg}/tensor.py": "from .model import FFModel\n",
                 f"{pkg}/model.py": "from .tensor import Tensor\n"}
        res = _run(mod, _tree(tmp_path / sub, files), files,
                   ["import-layering"])
        assert [(f.path, f.line, f.code) for f in res.findings] == \
            [(f"{pkg}/tensor.py", 1, "upward-import")]


# ------------------------------------------------ port-specific behaviour
def _port(tmp_path, files, passes):
    return _run(T, _tree(tmp_path, files), files, passes)


def test_capture_vocabulary_fires(tmp_path):
    """Every spelling chip_smoke.py phase 36 holds against the card
    fires trace-purity or trace-staleness inside a captured function."""
    body = ["        y = static['x']",
            "        a = y.item()",
            "        b = y.cpu()",
            "        torch.cuda.synchronize()",
            "        c = y.nonzero()",
            "        d = y.to('cpu')",
            "        e = time.perf_counter()",
            "        return y * self.scale",
            ""]
    src = ("import time\nimport torch\nfrom graphs import GraphRunner\n"
           "class M:\n"
           "    def __init__(self, x):\n"
           "        self.scale = 1.0\n"
           "        self.r = GraphRunner(self.fwd, {'x': x})\n"
           "    def set_scale(self, s):\n"
           "        self.scale = s\n"
           "    def fwd(self, static, state):\n" + "\n".join(body))
    res = _port(tmp_path, {"pkg/m.py": src},
                ["trace-purity", "trace-staleness"])
    got = sorted((f.line, f.code) for f in res.findings)
    assert got == [(12, "host-sync-in-trace"), (13, "host-sync-in-trace"),
                   (14, "host-sync-in-trace"), (15, "host-sync-in-trace"),
                   (16, "host-sync-in-trace"),
                   (17, "host-clock-in-trace"),
                   (18, "stale-attr-read")], got


def test_capture_block_and_counters(tmp_path):
    """A ``with torch.cuda.graph(...)`` body is captured code; a kernel
    wrapper's launch counter under a capture is sanctioned only when
    graphs.COUNTED names the wrapper."""
    files = {
        f"{PKG}/graphs.py": (
            "from .ops.k import counted_cuda\n"
            "COUNTED = (counted_cuda,)\n"),
        f"{PKG}/ops/k.py": (
            "def counted_cuda(x):\n"
            "    counted_cuda.launches += 1\n"
            "    return x\n"
            "counted_cuda.launches = 0\n"
            "def loose_cuda(x):\n"
            "    loose_cuda.launches += 1\n"
            "    return x\n"
            "loose_cuda.launches = 0\n"),
        f"{PKG}/tools/t.py": (
            "import torch\n"
            "from ..ops.k import counted_cuda, loose_cuda\n"
            "def timed(x):\n"
            "    g = torch.cuda.CUDAGraph()\n"
            "    with torch.cuda.graph(g):\n"
            "        counted_cuda(x)\n"
            "        loose_cuda(x)\n"
            "        print('captured')\n"
            "    return g\n"),
    }
    res = _port(tmp_path, files, ["trace-purity"])
    got = sorted((f.path.split("/")[-1], f.line, f.code)
                 for f in res.findings)
    assert got == [("k.py", 6, "side-effect-in-trace"),
                   ("t.py", 8, "side-effect-in-trace")], got


def test_capture_reach_crosses_imports(tmp_path):
    """The captured step reaches a helper in another module through a
    plain import (the JAX engine's resolver stops at the module); a call
    on an outside package's name never resolves to a project method."""
    files = {
        "pkg/helpers.py": ("def sync(y):\n"
                           "    return y.item()\n"),
        "pkg/saver.py": ("class Saver:\n"
                         "    def save(self, a, b):\n"
                         "        print(a)\n"),
        "pkg/m.py": ("import torch\n"
                     "from graphs import GraphRunner\n"
                     "from .helpers import sync\n"
                     "def f(static, state):\n"
                     "    torch.save(static, 'x')\n"
                     "    return sync(static['x'])\n"
                     "def build(x):\n"
                     "    return GraphRunner(f, {'x': x})\n"),
    }
    res = _port(tmp_path, files, ["trace-purity"])
    assert [(f.path, f.line, f.code) for f in res.findings] == \
        [("pkg/helpers.py", 2, "host-sync-in-trace")]


def test_staleness_setup_helpers_and_optimizer_tensors(tmp_path):
    """A helper only compile() calls is setup phase (compile drops the
    captured steps); a value kept as a device tensor (optim.py's lr and
    step) is updated in place, never rebound, so nothing fires."""
    files = {"pkg/m.py": (
        "from graphs import GraphRunner\n"
        "class Model:\n"
        "    def compile(self, mesh):\n"
        "        self._resolve(mesh)\n"
        "    def _resolve(self, mesh):\n"
        "        self.mesh = mesh\n"
        "    def body(self, static, state):\n"
        "        state['lr'].mul_(0.5)\n"
        "        return static['x'] * state['lr'] + (self.mesh is None)\n"
        "    def step(self, x, state):\n"
        "        return GraphRunner(self.body, {'x': x}, state)\n")}
    assert _port(tmp_path, files, ["trace-staleness"]).findings == []


def test_divergence_follows_values(tmp_path):
    """``rank, world = _identity()`` taints the rank only; a property
    returning ``get_rank() == 0`` and an attribute built from the rank
    are rank-local; a rank-dependent ARGUMENT to a collective every rank
    reaches is not divergence (ops/hetero.py::HostComm.scatter)."""
    files = {"pkg/m.py": (
        "import torch.distributed as dist\n"
        "def _identity():\n"
        "    return int(dist.get_rank()), int(dist.get_world_size())\n"
        "class Comm:\n"
        "    def __init__(self, owner):\n"
        "        self.is_owner = dist.get_rank() == owner\n"
        "    @property\n"
        "    def is_leader(self):\n"
        "        return dist.get_rank() == 0\n"
        "    def scatter(self, out, parts):\n"
        "        dist.scatter(out, parts if self.is_owner else None, src=0)\n"
        "    def stop(self):\n"
        "        if self.is_leader:\n"
        "            dist.broadcast(self.t, src=0)\n"
        "    def owner_sum(self, x):\n"
        "        if self.is_owner:\n"
        "            dist.all_reduce(x)\n"
        "def save(x):\n"
        "    rank, world = _identity()\n"
        "    if world > 1:\n"
        "        dist.all_reduce(x)\n"
        "    if _identity()[1] > 1:\n"
        "        dist.barrier()\n"
        "    if rank == 0:\n"
        "        dist.barrier()\n"
        "    n = len(x)\n"
        "    if n == 1:\n"
        "        return x\n"
        "    dist.all_reduce(x)\n")}
    res = _port(tmp_path, files, ["collective-divergence"])
    got = sorted((f.line, f.code) for f in res.findings)
    assert got == [(14, "collective-in-divergent-branch"),
                   (17, "collective-in-divergent-branch"),
                   (25, "collective-in-divergent-branch")], got


def test_donation_compile_off_and_flag(tmp_path):
    """``compile(donate_state=False)`` turns donation off for that
    model; ``donate=`` not literally False keeps it on."""
    files = {"pkg/m.py": (
        "def a(model, state, x, y):\n"
        "    model.compile(donate_state=False)\n"
        "    new, m = model.train_step(state, x, y)\n"
        "    return state, new\n"
        "def b(model, state, x, y, d):\n"
        "    new, m = model.train_step(state, x, y, donate=d)\n"
        "    return state\n")}
    res = _port(tmp_path, files, ["donation-safety"])
    assert [(f.line, f.code, f.detail) for f in res.findings] == \
        [(7, "donated-arg-reuse", "b.state")]


def test_recompile_loop_and_varying_slice(tmp_path):
    files = {"pkg/m.py": (
        "from graphs import GraphRunner\n"
        "class S:\n"
        "    def each(self, xs):\n"
        "        for x in xs:\n"
        "            g = GraphRunner(self.f, {'x': x})\n"
        "            g.run({'x': x})\n"
        "    def chunks(self, x, b):\n"
        "        runner = self._graphs[b]\n"
        "        for lo in range(0, len(x), b):\n"
        "            runner.run({'x': x[lo:min(lo + b, len(x))]})\n")}
    res = _port(tmp_path, files, ["recompile-hazard"])
    assert sorted((f.line, f.code) for f in res.findings) == \
        [(5, "jit-in-loop"), (10, "varying-shape-arg")]


def test_blocking_torch_syncs_and_collective(tmp_path):
    """torch's syncs and a raw collective under a lock fire; ``.tolist()``
    of a numpy value is host work and stays silent."""
    files = {"pkg/m.py": (
        "import threading\n"
        "import numpy as np\n"
        "import torch\n"
        "import torch.distributed as dist\n"
        "class E:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def step(self, t, ev):\n"
        "        with self._lock:\n"
        "            a = t.to('cpu')\n"
        "            ev.synchronize()\n"
        "            dist.broadcast(t, src=0)\n"
        "            u = np.unique(np.asarray([1, 2]))\n"
        "            return u[u > 1].tolist(), a\n")}
    res = _port(tmp_path, files, ["blocking-under-lock"])
    assert sorted((f.line, f.code) for f in res.findings) == \
        [(10, "device-sync-under-lock"), (11, "device-sync-under-lock"),
         (12, "wait-under-lock")]


# -------------------------------------------------------- engine behaviour
WAIVER_FILES = {"pkg/a.py": (
    "import threading\n"
    "from x import emit\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def f(self):\n"
    "        with self._lock:\n"
    "            emit('step', wall_s=0.0)\n")}
WAIVER_KEY = "lock-discipline:pkg/a.py:C.f:emit-under-lock"


@pytest.mark.parametrize("mod", [J, T], ids=["jax", "port"])
def test_waivers_behave_alike(tmp_path, mod):
    root = _tree(tmp_path, WAIVER_FILES)
    wf = tmp_path / "w.txt"
    for bad in (f"{WAIVER_KEY} |\n", f"{WAIVER_KEY}\n",
                f"{WAIVER_KEY} | a\n{WAIVER_KEY} | b\n"):
        wf.write_text(bad)
        with pytest.raises(mod.WaiverError):
            mod.Waivers.load(str(wf))
    wf.write_text(f"# why\n{WAIVER_KEY} | deliberate fixture\n"
                  "lock-discipline:pkg/gone.py:D.g:emit-under-lock | stale\n")
    res = _run(mod, root, WAIVER_FILES, ["lock-discipline"],
               waivers=mod.Waivers.load(str(wf)))
    assert res.findings == [] and not res.ok
    assert [k for k, _, _ in res.unused_waivers] == \
        ["lock-discipline:pkg/gone.py:D.g:emit-under-lock"]
    assert "unused-waiver" in res.format_text()


def test_json_and_sarif_match_jax(tmp_path):
    root = _tree(tmp_path, WAIVER_FILES)
    docs, sarifs = [], []
    for mod in (J, T):
        res = _run(mod, root, WAIVER_FILES, ["lock-discipline"])
        doc = json.loads(json.dumps(res.to_dict()))
        back = [mod.Finding.from_dict(d) for d in doc["findings"]]
        assert [f.waiver_key for f in back] == \
            [f.waiver_key for f in res.findings]
        docs.append(doc)
        sarifs.append(json.loads(json.dumps(mod.to_sarif(res))))
    assert docs[0] == docs[1]
    assert docs[1]["version"] == 1 and docs[1]["tool"] == "ffcheck"

    def keys(d):
        if isinstance(d, dict):
            return {k: keys(v) for k, v in d.items()}
        if isinstance(d, list):
            return [keys(v) for v in d]
        return None

    assert keys(sarifs[0]) == keys(sarifs[1])
    assert sarifs[0]["runs"][0]["results"] == sarifs[1]["runs"][0]["results"]


@pytest.mark.parametrize("mod", [J, T], ids=["jax", "port"])
def test_update_baseline_keeps_and_refuses(tmp_path, mod):
    root = _tree(tmp_path, WAIVER_FILES)
    wf = tmp_path / "W.txt"
    wf.write_text(f"# why\n{WAIVER_KEY} | deliberate fixture\n")
    w = mod.Waivers.load(str(wf))
    res = _run(mod, root, WAIVER_FILES, ["lock-discipline"], waivers=w)
    assert mod.update_baseline(res, w, str(wf)) == [WAIVER_KEY]
    text = wf.read_text()
    assert "deliberate fixture" in text and "# why" in text
    res = _run(mod, root, WAIVER_FILES, ["lock-discipline"])
    with pytest.raises(mod.BaselineError):
        mod.update_baseline(res, None, str(wf))


def test_changed_only_scope_matches_jax(tmp_path):
    """The CLIs' ``--changed-only`` (in-process, vs HEAD of a temp git
    repo) report the same scope and the same findings."""
    files = dict(WAIVER_FILES)
    files["pkg/clean.py"] = "x = 1\n"
    root = _tree(tmp_path, files)
    git = ["git", "-c", "user.email=t@t", "-c", "user.name=t"]
    for cmd in (["init", "-q"], ["add", "-A"], ["commit", "-q", "-m", "a"]):
        subprocess.run(git + cmd, cwd=root, check=True,
                       capture_output=True)
    with open(os.path.join(root, "pkg", "a.py"), "a") as f:
        f.write("# touched\n")
    docs = []
    for main, sub in ((j_main, "j"), (t_main, "t")):
        sink = tmp_path / sub / "analysis_1.json"
        rc = main(["--root", root, "--pass", "lock-discipline",
                   "--changed-only", "--format", "json", "-o", str(sink),
                   "pkg"])
        assert rc == 1
        docs.append(json.loads(sink.read_text()))
    assert docs[0] == docs[1]
    assert docs[1]["changed_only"] == ["pkg/a.py"]
    assert [f["waiver_key"] for f in docs[1]["findings"]] == [WAIVER_KEY]


def test_cli_list_and_usage(tmp_path, capsys):
    assert t_main(["--list-passes"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == \
        sorted(p.name for p in T_PASSES)
    assert t_main(["--pass", "nope", "--root", str(tmp_path)]) == 2
    assert "unknown pass" in capsys.readouterr().err
    assert t_main(["--explain", "garbage"]) == 2


def test_cli_module_entry_exits_nonzero(tmp_path):
    """``python -m dlrm_flexflow_tpu_torch.analysis`` on a seeded
    violation exits 1 naming path:line and the pass."""
    _tree(tmp_path, WAIVER_FILES)
    r = subprocess.run(
        [sys.executable, "-m", "dlrm_flexflow_tpu_torch.analysis",
         "--root", str(tmp_path), "--pass", "lock-discipline", "pkg"],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "pkg/a.py:8: [lock-discipline/emit-under-lock]" in r.stdout


def test_catalog_in_jax_order():
    from dlrm_flexflow_tpu.analysis.passes import PASSES as J_PASSES
    assert [p.name for p in T_PASSES] == [p.name for p in J_PASSES]


# --------------------------------------------------------- the port's tree
@pytest.fixture(scope="module")
def port_modules():
    """One parse of the port's tree, shared by the tests that read it."""
    return T.load_modules(repo=REPO)


@pytest.fixture(scope="module")
def port_result(port_modules):
    """One all-passes run over the port with its committed waivers."""
    return T.run_analysis(modules=port_modules,
                          waivers=T.default_waivers(REPO))


def test_port_tree_clean_or_waived(port_result):
    assert port_result.findings == [], \
        "\n".join(f.format() for f in port_result.findings)
    assert port_result.unused_waivers == []
    assert port_result.ok and port_result.waived
    assert port_result.waivers_path.endswith(
        os.path.join(PKG, "analysis", "waivers.txt"))


def test_port_tree_layering_mapped_and_serving_donation_free(port_result):
    every = list(port_result.findings) + [f for f, _ in port_result.waived]
    assert [f for f in every if f.code == "unmapped-module"] == []
    assert [f for f in every if f.pass_name == "donation-safety"
            and f.path.startswith(f"{PKG}/serving/")] == []
    assert port_result.by_pass()["import-layering"] == \
        {"findings": 0, "waived": 0}


def test_port_capture_entries_are_the_real_sites(port_modules):
    mods = port_modules
    index = T.FunctionIndex(mods)
    quals = sorted(index.owner[n][1]
                   for n in all_capture_entries(mods, index))
    assert "FFModel._step_body" in quals
    assert "InferenceEngine._forward" in quals
    reach = capture_reach(mods, index)
    step = [n for n in reach if index.owner[n][1] == "FFModel._step_body"]
    assert step, "the train step is not a capture entry"


def test_waivers_each_carry_a_reason():
    path = os.path.join(REPO, PKG, "analysis", "waivers.txt")
    w = T.Waivers.load(path)
    assert w.entries
    for key, just, _ln in w.entries:
        assert len(just.split()) >= 6, key
        assert not key.startswith(("*", "all:")), key


def test_port_analysis_imports_no_jax():
    pkg_dir = os.path.join(REPO, PKG, "analysis")
    for dirpath, _dirs, files in os.walk(pkg_dir):
        for name in files:
            if not name.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, name)).read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                for m in mods:
                    top = m.split(".")[0]
                    assert top not in ("jax", "jaxlib",
                                       "dlrm_flexflow_tpu", "torch"), \
                        (name, m)


# ------------------------------------------------- faults the first run found
def test_c10_serving_warmup_builds_every_kernel(monkeypatch):
    """C10 (lock-discipline's emit-under-lock in InferenceEngine._dispatch:
    _dispatch -> _remap_deferred -> _install_locked -> row_set_cuda ->
    _cuda.load -> build): warmup() on the card builds every kernel, so a
    tiered store's first miss never runs nvcc under the engine's lock."""
    import torch

    import dlrm_flexflow_tpu_torch as fft
    from dlrm_flexflow_tpu_torch import _cuda
    from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.serving import InferenceEngine
    model = build_dlrm(
        DLRMConfig(sparse_feature_size=4, embedding_size=[16, 16],
                   mlp_bot=[13, 8, 4], mlp_top=[12, 8, 1],
                   arch_interaction_op="cat"),
        fft.FFConfig(batch_size=8))
    model.compile(optimizer=fft.SGDOptimizer(lr=0.1))
    state = model.init(seed=0, device="cpu")
    engine = InferenceEngine(model, state, (8,), True, False, device="cpu")
    built = []
    monkeypatch.setattr(_cuda, "build", lambda names=None: built.append(1))
    engine.warmup()  # on the CPU: nothing to build
    assert built == []
    engine.buckets = []  # the card's device, no bucket to capture here
    engine.device = torch.device("cuda")
    engine.warmup()
    assert built == [1]
