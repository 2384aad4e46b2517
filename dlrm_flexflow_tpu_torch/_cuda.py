"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<digest>.so``,
then loaded with ``ctypes``.  The digest covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt
and a built one is reused.  Nothing here
runs at import: the first CUDA call of a kernel's wrapper builds and
loads its library, and :func:`build` builds several at once (one ``nvcc``
per source, all started together).  A machine without ``nvcc`` gets an
error at that first call, never a silent fallback.  Each library built
is one ``compile`` telemetry event (``kind="nvcc"``, ``torch_hooks``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

from .telemetry.torch_hooks import record_compile

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> (build seconds, compiler output) of the builds this process ran
build_log: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "csrc/ on the machine with the card")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a digest of that source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all of ``csrc/*.cu``) whose
    library is missing, one ``nvcc`` process per source, all in flight
    together.  Returns the build seconds of each library compiled here;
    raises with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    times = {}
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        build_log[n] = (secs, log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial .so
        times[n] = secs
        record_compile("nvcc", secs, fn=f"csrc/{n}.cu", backend="cuda")
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(name: str, signatures: Dict[str, Tuple[object, Sequence[object]]]
         ) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``restype``/``argtypes`` declared from ``signatures``
    (function name -> (restype, argtypes))."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _libs[name] = lib
        return lib
