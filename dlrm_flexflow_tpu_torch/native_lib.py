"""Loader for the native C++ libraries (counterpart of
``dlrm_flexflow_tpu/native_lib.py``).

The sources are the repo's ``native/*.cpp``, shared with the JAX
package and never written here.  Each is compiled by ``g++`` with the
flags of ``native/Makefile`` (so that both packages run the same code)
into ``dlrm_flexflow_tpu_torch/_build/<stem>-<digest>.so``, then loaded
with ``ctypes``.  The digest covers the source, the flags, the
compiler's ``--version`` and the target ``-march=native`` resolves to on
this host, so a library is reused only where the same compiler built it
for the same CPU.  The JAX loader runs ``make`` inside ``native/``; this
one builds into the port's own build directory under an ``fcntl`` lock,
so that processes started together (pytest-xdist workers) never race on
one output: the first builds, the others wait and load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: ``native/Makefile``'s CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
             "-Wall")
LD_FLAGS = ("-shared", "-fopenmp")


def compilers():
    """The C++ compilers to try, in order: ``$CXX`` (the Makefile's
    ``CXX ?= g++``), then ``g++`` on the PATH.  A ``$CXX`` may come from
    an installation without OpenMP's runtime: its driver then stops on
    every ``-fopenmp`` build with "cannot read spec file 'libgomp.spec'",
    and the next compiler builds the library."""
    out = []
    for cand in (os.environ.get("CXX"), "g++"):
        path = cand and shutil.which(cand)
        if path and path not in out:
            out.append(path)
    return out


@functools.lru_cache(maxsize=None)
def compiler_identity(cxx: str) -> str:
    """``cxx --version`` and the machine options ``-march=native``
    expands to on this host (the ``-m`` options and ``--param`` values
    of the driver's ``cc1plus`` line under ``-###``).  Raises
    ``subprocess.CalledProcessError`` when the compiler cannot answer."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    probe = subprocess.run(
        [cxx, "-###", "-march=native", "-x", "c++", "-c", os.devnull,
         "-o", os.devnull], capture_output=True, text=True, check=True)
    target = []
    for line in probe.stderr.splitlines():
        if "cc1plus" not in line:
            continue
        toks = [t.strip('"') for t in line.split()]
        target += [t for i, t in enumerate(toks) if t.startswith("-m")
                   or (i and toks[i - 1] == "--param")]
    return version + " ".join(target)


def library_path(src_name: str, cxx: str) -> Path:
    """The library ``cxx`` builds of ``native/<src_name>`` on this host."""
    src = NATIVE_DIR / src_name
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode()
        + compiler_identity(cxx).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(src_name).stem}-{digest}.so"


def _build(cxx: str, src: Path, so: Path):
    """Build ``so`` with ``cxx``; None, or the compiler's error."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, str(src), *LD_FLAGS, "-o",
                            str(tmp)], capture_output=True, text=True)
        if r.returncode == 0:
            os.replace(tmp, so)  # a reader never sees a partial .so
            return None
        return (f"{cxx} (exit {r.returncode}):\n"
                f"{(r.stderr or r.stdout)[-2000:]}")
    finally:
        if tmp.exists():
            tmp.unlink()


def load_native_lib(so_name: str, src_name: str) -> ctypes.CDLL:
    """Load the library of ``native/<src_name>``, built by the first of
    :func:`compilers` that builds it unless that build is already there.
    ``so_name`` is the JAX package's name for the library
    (``libffsim.so``), kept for the messages.

    Raises OSError, with each compiler's output, when no compiler builds
    the library or it does not load: the callers decide whether native
    support is optional."""
    src = NATIVE_DIR / src_name
    failures = []
    for cxx in compilers():
        try:
            so = library_path(src_name, cxx)
        except subprocess.CalledProcessError as e:
            failures.append(f"{cxx} (exit {e.returncode}):\n"
                            f"{(e.stderr or e.stdout or '')[-2000:]}")
            continue
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / f".{so.stem}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                # another process may have built it while this one waited
                err = None if so.exists() else _build(cxx, src, so)
            if err is not None:
                failures.append(err)
                continue
        return ctypes.CDLL(str(so))
    raise OSError(f"could not build {so_name} from {src}: "
                  + ("\n".join(failures) or "no C++ compiler found"))
