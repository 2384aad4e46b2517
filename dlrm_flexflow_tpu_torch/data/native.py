"""ctypes binding of the native runtime, ``native/ffruntime.cpp``
(counterpart of ``dlrm_flexflow_tpu/data/native.py``).

The same functions over the same C ABI: the bag lookup and its
scatter-add gradient on the host (the reference's
``embedding_avx2.cc``), the batch gather, and a double-buffered
prefetching loader.  The library is built from the repo's source by
``native_lib.load_native_lib`` into the port's build directory (with
``$CXX``, else ``g++`` on the PATH), never by ``make`` in ``native/``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from ..native_lib import load_native_lib

_LIB: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded ``ffruntime`` library (built at the first call), with
    the JAX binding's argument types.  Raises OSError when it cannot be
    built or loaded."""
    global _LIB
    if _LIB is None:
        lib = load_native_lib("libffruntime.so", "ffruntime.cpp")
        i64 = ctypes.c_int64
        p = ctypes.c_void_p
        lib.ff_embedding_bag_fwd_f32.argtypes = [p, p, p, i64, i64, i64,
                                                 ctypes.c_int]
        lib.ff_embedding_bag_bwd_f32.argtypes = [p, p, p, i64, i64, i64,
                                                 ctypes.c_int]
        lib.ff_gather_rows_f32.argtypes = [p, p, p, i64, i64]
        lib.ff_gather_rows_i64.argtypes = [p, p, p, i64, i64]
        lib.ff_loader_create.argtypes = [i64, i64]
        lib.ff_loader_create.restype = p
        lib.ff_loader_add_tensor.argtypes = [p, p, p, p, i64, ctypes.c_int32]
        lib.ff_loader_start.argtypes = [p, p]
        lib.ff_loader_next.argtypes = [p]
        lib.ff_loader_next.restype = ctypes.c_int32
        lib.ff_loader_destroy.argtypes = [p]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    try:
        get_lib()
        return True
    except OSError:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ------------------------------------------------------------- CPU embedding
def embedding_bag_cpu(weight: np.ndarray, indices: np.ndarray,
                      mode: str = "sum") -> np.ndarray:
    """``(B, d)`` f32: each bag of ``indices`` ``(B, bag)`` summed over
    ``weight``'s rows in bag order (``avg``: times ``1/bag``)."""
    lib = get_lib()
    weight = np.ascontiguousarray(weight, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    b, bag = indices.shape
    dim = weight.shape[1]
    out = np.empty((b, dim), np.float32)
    lib.ff_embedding_bag_fwd_f32(_ptr(weight), _ptr(indices), _ptr(out),
                                 b, bag, dim, 1 if mode == "avg" else 0)
    return out


def embedding_bag_cpu_grad(grad_out: np.ndarray, indices: np.ndarray,
                           num_rows: int, mode: str = "sum") -> np.ndarray:
    """The dense ``(num_rows, d)`` table gradient of the bag: each
    ``grad_out[b]`` (``avg``: times ``1/bag``) added to the rows of bag
    ``b``, in ``(b, j)`` order, into zeros."""
    lib = get_lib()
    grad_out = np.ascontiguousarray(grad_out, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    b, bag = indices.shape
    dim = grad_out.shape[1]
    gw = np.zeros((num_rows, dim), np.float32)
    lib.ff_embedding_bag_bwd_f32(_ptr(grad_out), _ptr(indices), _ptr(gw),
                                 b, bag, dim, 1 if mode == "avg" else 0)
    return gw


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` by the parallel native gather for f32 and int64
    arrays, by numpy for any other dtype."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int64)
    src = np.ascontiguousarray(src)
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64))
    out = np.empty((idx.shape[0],) + src.shape[1:], src.dtype)
    if src.dtype == np.float32:
        lib.ff_gather_rows_f32(_ptr(src), _ptr(idx), _ptr(out),
                               idx.shape[0], row_elems)
    elif src.dtype == np.int64:
        lib.ff_gather_rows_i64(_ptr(src), _ptr(idx), _ptr(out),
                               idx.shape[0], row_elems)
    else:
        return src[idx]
    return out


# --------------------------------------------------------- prefetching loader
class NativeDataLoader:
    """Double-buffered loader over host arrays: a native thread gathers
    the next batch into one staging buffer while the caller reads the
    other.

    The yielded arrays are views of the staging buffers, valid until the
    next batch is taken: ``train_step`` copies them when it places a
    batch, so the training loop is safe; any other consumer copies what
    it keeps."""

    def __init__(self, inputs: Dict[str, np.ndarray], labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0):
        self.lib = get_lib()
        self.batch_size = int(batch_size)
        self.num_samples = labels.shape[0]
        self.num_batches = self.num_samples // self.batch_size
        if self.num_batches <= 0:
            raise ValueError(f"{self.num_samples} samples make no batch of "
                             f"{self.batch_size}")
        arrays = dict(inputs)
        arrays["__labels__"] = labels
        self._arrays = {k: np.ascontiguousarray(v)
                        for k, v in arrays.items()}
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._staging = {}
        self.handle = self.lib.ff_loader_create(self.num_samples,
                                                self.batch_size)
        for name, arr in self._arrays.items():
            if arr.dtype not in (np.float32, np.int64):
                raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
            kind = 1 if arr.dtype == np.int64 else 0
            s0 = np.empty((self.batch_size,) + arr.shape[1:], arr.dtype)
            s1 = np.empty_like(s0)
            self._staging[name] = (s0, s1)
            row = int(np.prod(arr.shape[1:], dtype=np.int64))
            self.lib.ff_loader_add_tensor(self.handle, _ptr(arr), _ptr(s0),
                                          _ptr(s1), row, kind)
        self._order = None
        self._started = False

    def _new_order(self):
        order = np.arange(self.num_samples, dtype=np.int64)
        if self.shuffle:
            self._rng.shuffle(order)
        return np.ascontiguousarray(order)

    def __iter__(self):
        if not self._started:
            self._order = self._new_order()  # kept alive: the worker reads it
            self.lib.ff_loader_start(self.handle, _ptr(self._order))
            self._started = True
        for _ in range(self.num_batches):
            slot = self.lib.ff_loader_next(self.handle)
            batch = {k: st[slot] for k, st in self._staging.items()}
            labels = batch.pop("__labels__")
            yield batch, labels

    def peek(self):
        idx = np.arange(self.batch_size, dtype=np.int64)
        batch = {k: gather_rows(v, idx) for k, v in self._arrays.items()}
        labels = batch.pop("__labels__")
        return batch, labels

    def __len__(self):
        return self.num_batches

    def close(self):
        if self.handle:
            self.lib.ff_loader_destroy(self.handle)
            self.handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
