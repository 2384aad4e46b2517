"""Keras-compatible utils + preprocessing (counterpart of
``dlrm_flexflow_tpu/frontends/keras_utils.py``, the same code: it needs
numpy and the standard library only).

The reference's keras utility surface (reference:
python/flexflow/keras/utils/np_utils.py:9-70 to_categorical/
normalize; utils/data_utils.py:123-303 get_file/validate_file and the
``Sequence`` batch-source protocol :305-340; preprocessing/sequence.py
pad_sequences re-export).

``get_file`` is local-cache only: it never downloads, and a missing
cache entry raises ``FileNotFoundError`` with instructions.  ``HDF5Matrix``
imports ``h5py`` only when one is built.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np


# ------------------------------------------------------------------ np_utils
def to_categorical(y, num_classes: Optional[int] = None, dtype="float32"):
    """Class vector -> one-hot matrix (reference np_utils.py:9-56)."""
    y = np.asarray(y, dtype="int64").ravel()
    if not num_classes:
        num_classes = int(np.max(y)) + 1
    out = np.zeros((y.shape[0], num_classes), dtype=dtype)
    out[np.arange(y.shape[0]), y] = 1
    return out


def normalize(x, axis=-1, order=2):
    """L-``order`` normalization along ``axis`` (reference
    np_utils.py:58-70)."""
    x = np.asarray(x, dtype="float64")
    norm = np.atleast_1d(np.linalg.norm(x, order, axis))
    norm[norm == 0] = 1
    return x / np.expand_dims(norm, axis)


# ------------------------------------------------------------- preprocessing
def pad_sequences(sequences, maxlen: Optional[int] = None, dtype="int32",
                  padding="pre", truncating="pre", value=0.0):
    """Pad/truncate variable-length sequences into a dense (n, maxlen)
    array (the keras_preprocessing function the reference re-exports via
    preprocessing/sequence.py)."""
    lengths = [len(s) for s in sequences]
    if maxlen is None:
        maxlen = max(lengths) if lengths else 0
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, s in enumerate(sequences):
        if not len(s):
            continue
        if truncating == "pre":
            trunc = s[-maxlen:]
        elif truncating == "post":
            trunc = s[:maxlen]
        else:
            raise ValueError(f"unknown truncating {truncating!r}")
        trunc = np.asarray(trunc, dtype=dtype)
        if padding == "post":
            out[i, :len(trunc)] = trunc
        elif padding == "pre":
            out[i, -len(trunc):] = trunc
        else:
            raise ValueError(f"unknown padding {padding!r}")
    return out


# --------------------------------------------------------------- data_utils
def _hash_file(fpath, algorithm="sha256", chunk_size=65535):
    """reference data_utils.py:247-277."""
    hasher = hashlib.sha256() if algorithm == "sha256" else hashlib.md5()
    with open(fpath, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            hasher.update(chunk)
    return hasher.hexdigest()


def validate_file(fpath, file_hash, algorithm="auto", chunk_size=65535):
    """reference data_utils.py:279-303."""
    if algorithm == "auto":
        algorithm = "sha256" if len(str(file_hash)) == 64 else "md5"
    return _hash_file(fpath, algorithm, chunk_size) == str(file_hash)


def _extract_archive(file_path, path=".", archive_format="auto"):
    """Extract tar/zip archives (reference data_utils.py:76-121)."""
    import tarfile
    import zipfile

    if archive_format is None:
        return False
    formats = (["tar", "zip"] if archive_format == "auto"
               else [archive_format] if isinstance(archive_format, str)
               else list(archive_format))
    for fmt in formats:
        opener, is_match = ((tarfile.open, tarfile.is_tarfile)
                            if fmt == "tar"
                            else (zipfile.ZipFile, zipfile.is_zipfile))
        if is_match(file_path):
            with opener(file_path) as archive:
                if fmt == "tar":
                    # refuse tar-slip members (absolute paths, "..",
                    # links outside the target)
                    try:
                        archive.extractall(path, filter="data")
                    except TypeError:  # Python without the filter backport
                        target = os.path.realpath(path)
                        for m in archive.getmembers():
                            dest = os.path.realpath(
                                os.path.join(path, m.name))
                            if not (dest == target
                                    or dest.startswith(target + os.sep)):
                                raise ValueError(
                                    f"tar member {m.name!r} escapes "
                                    f"{path!r}")
                        archive.extractall(path)
                else:
                    target = os.path.realpath(path)
                    for name in archive.namelist():
                        dest = os.path.realpath(os.path.join(path, name))
                        if not (dest == target
                                or dest.startswith(target + os.sep)):
                            raise ValueError(
                                f"zip member {name!r} escapes {path!r}")
                    archive.extractall(path)
            return True
    return False


def get_file(fname, origin=None, untar=False, cache_subdir="datasets",
             cache_dir=None, file_hash=None, extract=False,
             archive_format="auto", **_ignored):
    """Resolve a dataset file from the local keras cache (reference
    data_utils.py:123-245).  Nothing is downloaded: if the file is not
    already cached, raise with the manual-download instruction instead
    of fetching ``origin``."""
    cache_dir = cache_dir or os.path.join(os.path.expanduser("~"), ".keras")
    base = os.path.join(cache_dir, cache_subdir)
    if untar:
        untar_path = os.path.join(base, fname)
        path = untar_path + ".tar.gz"
        if os.path.exists(untar_path):
            return untar_path
    else:
        path = os.path.join(base, fname)
    if os.path.exists(path):
        if file_hash and not validate_file(path, file_hash):
            raise IOError(f"{path} exists but its hash does not match")
        if untar:
            _extract_archive(path, base, "tar")
            return untar_path
        if extract:
            _extract_archive(path, base, archive_format)
        return path
    raise FileNotFoundError(
        f"{path} not found and this environment has no network access; "
        f"place the file there manually (origin: {origin})")


class Progbar:
    """Terminal progress bar (reference utils/generic_utils.py Progbar):
    ``update(current, values)`` prints ``current/target`` plus running
    averages of the named values; ``add(n, values)`` advances by ``n``."""

    def __init__(self, target, width=30, verbose=1, interval=0.05,
                 stateful_metrics=None):
        self.target = target
        self.width = width
        self.verbose = verbose
        self.interval = interval
        self.stateful_metrics = set(stateful_metrics or [])
        self._values = {}
        self._seen_so_far = 0
        self._last_print = 0.0

    def update(self, current, values=None):
        import time
        for name, v in values or []:
            if name in self.stateful_metrics:
                self._values[name] = (float(v), 1)
            else:
                tot, cnt = self._values.get(name, (0.0, 0))
                step = current - self._seen_so_far
                self._values[name] = (tot + float(v) * max(step, 1),
                                      cnt + max(step, 1))
        self._seen_so_far = current
        if not self.verbose:
            return
        final = bool(self.target) and current >= self.target
        now = time.monotonic()
        if not final and now - self._last_print < self.interval:
            return
        self._last_print = now
        if self.target:
            frac = min(current / self.target, 1.0)
            filled = int(self.width * frac)
            bar = "=" * filled + "." * (self.width - filled)
            head = f"{current}/{self.target} [{bar}]"
        else:
            head = f"{current}/?"
        stats = " - ".join(f"{k}: {tot / max(cnt, 1):.4f}"
                           for k, (tot, cnt) in self._values.items())
        end = "\n" if self.target and current >= self.target else "\r"
        print(f"{head} {stats}", end=end, flush=True)

    def add(self, n, values=None):
        self.update(self._seen_so_far + n, values)


class Sequence:
    """Batch-source protocol (reference data_utils.py:305-340): implement
    __getitem__(batch_idx) -> (x, y) and __len__."""

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def on_epoch_end(self):
        pass

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class Tokenizer:
    """Word-id sequence vectorizer (reference
    python/flexflow/keras/preprocessing/text.py Tokenizer — the reuters
    example only uses ``sequences_to_matrix``; ``fit_on_texts`` is included
    for API completeness)."""

    def __init__(self, num_words=None, oov_token=None, split=" ",
                 lower=True, **_ignored):
        self.num_words = num_words
        self.oov_token = oov_token
        self.split = split
        self.lower = lower
        self.word_index = {}
        self.word_counts = {}
        self.document_count = 0

    def fit_on_texts(self, texts):
        for text in texts:
            self.document_count += 1
            if self.lower:
                text = text.lower()
            for w in text.split(self.split):
                if not w:
                    continue
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        offset = 1 + (1 if self.oov_token else 0)
        by_freq = sorted(self.word_counts, key=self.word_counts.get,
                         reverse=True)
        self.word_index = {w: i + offset for i, w in enumerate(by_freq)}
        if self.oov_token:
            self.word_index[self.oov_token] = 1

    def texts_to_sequences(self, texts):
        out = []
        nw = self.num_words
        for text in texts:
            if self.lower:
                text = text.lower()
            seq = []
            for w in text.split(self.split):
                i = self.word_index.get(w)
                if i is None:
                    if self.oov_token:
                        seq.append(1)
                    continue
                if nw and i >= nw:
                    if self.oov_token:
                        seq.append(1)
                    continue
                seq.append(i)
            out.append(seq)
        return out

    def sequences_to_matrix(self, sequences, mode="binary"):
        if not self.num_words and not self.word_index:
            raise ValueError("specify num_words or fit_on_texts first")
        num_words = self.num_words or (max(self.word_index.values()) + 1)
        m = np.zeros((len(sequences), num_words), dtype=np.float32)
        for r, seq in enumerate(sequences):
            ids, counts = np.unique(
                [i for i in seq if 0 <= i < num_words], return_counts=True)
            ids = ids.astype(np.intp)
            if mode == "binary":
                m[r, ids] = 1.0
            elif mode == "count":
                m[r, ids] = counts
            elif mode == "freq":
                m[r, ids] = counts / max(len(seq), 1)
            else:
                raise ValueError(f"unsupported mode {mode!r}")
        return m


# ---------------------------------------------------------------------------
# generic_utils parity (reference python/flexflow/keras/utils/
# generic_utils.py) — custom-object registry, serialization helpers,
# function pickling, small list/shape utilities.

_GLOBAL_CUSTOM_OBJECTS: dict = {}


class CustomObjectScope:
    """Scope that temporarily registers custom classes/functions for
    ``deserialize_keras_object`` lookups."""

    def __init__(self, *args):
        self.custom_objects = args
        self.backup = None

    def __enter__(self):
        self.backup = _GLOBAL_CUSTOM_OBJECTS.copy()
        for objs in self.custom_objects:
            _GLOBAL_CUSTOM_OBJECTS.update(objs)
        return self

    def __exit__(self, *exc):
        _GLOBAL_CUSTOM_OBJECTS.clear()
        _GLOBAL_CUSTOM_OBJECTS.update(self.backup)


def custom_object_scope(*args):
    return CustomObjectScope(*args)


def get_custom_objects() -> dict:
    return _GLOBAL_CUSTOM_OBJECTS


def serialize_keras_object(instance):
    if instance is None:
        return None
    if hasattr(instance, "get_config"):
        return {"class_name": type(instance).__name__,
                "config": instance.get_config()}
    if hasattr(instance, "__name__"):
        return instance.__name__
    raise ValueError(f"cannot serialize {instance!r}")


def deserialize_keras_object(identifier, module_objects=None,
                             custom_objects=None,
                             printable_module_name="object"):
    if identifier is None:
        return None
    module_objects = module_objects or {}
    custom_objects = custom_objects or {}
    if isinstance(identifier, dict):
        class_name = identifier["class_name"]
        config = identifier.get("config", {})
        cls = (custom_objects.get(class_name)
               or _GLOBAL_CUSTOM_OBJECTS.get(class_name)
               or module_objects.get(class_name))
        if cls is None:
            raise ValueError(
                f"unknown {printable_module_name}: {class_name}")
        if hasattr(cls, "from_config"):
            return cls.from_config(config)
        return cls(**config)
    if isinstance(identifier, str):
        obj = (custom_objects.get(identifier)
               or _GLOBAL_CUSTOM_OBJECTS.get(identifier)
               or module_objects.get(identifier))
        if obj is None:
            raise ValueError(
                f"unknown {printable_module_name}: {identifier}")
        return obj
    return identifier


def func_dump(func):
    """Serialize a function to (bytecode, defaults, closure)."""
    import codecs
    import marshal

    code = codecs.encode(marshal.dumps(func.__code__), "base64").decode(
        "ascii")
    defaults = func.__defaults__
    closure = (tuple(c.cell_contents for c in func.__closure__)
               if func.__closure__ else None)
    return code, defaults, closure


def func_load(code, defaults=None, closure=None, globs=None):
    """Inverse of ``func_dump``."""
    import codecs
    import marshal
    import types

    if isinstance(code, (tuple, list)):
        code, defaults, closure = code
        if isinstance(defaults, list):
            defaults = tuple(defaults)

    def ensure_cell(value):
        def dummy():
            return value

        return dummy.__closure__[0]

    if closure is not None:
        closure = tuple(ensure_cell(v) for v in closure)
    raw = marshal.loads(codecs.decode(code.encode("ascii"), "base64"))
    if globs is None:
        globs = globals()
    return types.FunctionType(raw, globs, name=raw.co_name,
                              argdefs=defaults, closure=closure)


def getargspec(fn):
    import inspect

    return inspect.getfullargspec(fn)


def has_arg(fn, name, accept_all=False):
    """Whether ``fn`` accepts a keyword argument ``name``."""
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    if name in sig.parameters:
        return True
    if accept_all:
        return any(p.kind == inspect.Parameter.VAR_KEYWORD
                   for p in sig.parameters.values())
    return False


def to_list(x, allow_tuple=False):
    if isinstance(x, list):
        return x
    if allow_tuple and isinstance(x, tuple):
        return list(x)
    return [x]


def unpack_singleton(x):
    if len(x) == 1:
        return x[0]
    return x


def object_list_uid(object_list):
    return ", ".join(str(abs(id(x))) for x in to_list(object_list))


def is_all_none(iterable_or_element):
    for e in to_list(iterable_or_element):
        if e is not None:
            return False
    return True


def slice_arrays(arrays, start=None, stop=None):
    """Slice arrays (or a list of arrays) like keras fit's batching."""
    if arrays is None:
        return [None]
    if isinstance(start, list) and stop is not None:
        raise ValueError("cannot give both a list `start` and `stop`")
    single = not isinstance(arrays, list)
    arrs = [arrays] if single else arrays
    if isinstance(start, list):
        out = [None if x is None else
               (x[start] if hasattr(x, "shape") else [x[i] for i in start])
               for x in arrs]
    else:
        out = [None if x is None else x[start:stop] for x in arrs]
    return out[0] if single else out


def transpose_shape(shape, target_format, spatial_axes):
    """Convert a shape tuple between channels_first/last orderings."""
    if target_format == "channels_first" and len(shape) > 2:
        axes = [0, -1] + list(spatial_axes)
        new_values = [shape[a] for a in axes]
        if isinstance(shape, tuple):
            return tuple(new_values)
        return new_values
    if target_format in ("channels_first", "channels_last"):
        return shape
    raise ValueError(f"unknown target_format: {target_format}")


def check_for_unexpected_keys(name, input_dict, expected_values):
    unknown = set(input_dict.keys()) - set(expected_values)
    if unknown:
        raise ValueError(
            f"Unknown entries in {name} dictionary: {sorted(unknown)}. "
            f"Only expected following keys: {expected_values}")


# ---------------------------------------------------------------------------
# data_utils parity — background batch producers (reference
# data_utils.py SequenceEnqueuer/OrderedEnqueuer/GeneratorEnqueuer,
# thread-based here: the arrays feed a jitted step, so the GIL is
# released during device execution and threads suffice).


class SequenceEnqueuer:
    """Base: run a producer on worker threads, consume via ``get()``."""

    def __init__(self, sequence, use_multiprocessing=False):
        self.sequence = sequence
        self.use_multiprocessing = use_multiprocessing
        self._threads = []
        self._queue = None
        self._stop_event = None

    def is_running(self):
        return (self._stop_event is not None
                and not self._stop_event.is_set())

    def start(self, workers=1, max_queue_size=10):
        import queue as _q
        import threading

        self._queue = _q.Queue(max_queue_size)
        self._stop_event = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def stop(self, timeout=None):
        if self._stop_event is not None:
            self._stop_event.set()
        # drain so a producer blocked on a full queue can observe the
        # stop event (its puts time out and re-check) and exit
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except Exception:
                pass
        for t in self._threads:
            t.join(timeout)
        self._threads = []

    def _put(self, item) -> bool:
        """put() that never blocks past a stop(): retries with a timeout
        and gives up once the stop event is set."""
        import queue as _q

        while not self._stop_event.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except _q.Full:
                continue
        return False

    def _run(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def get(self):
        raise NotImplementedError


class OrderedEnqueuer(SequenceEnqueuer):
    """Yields Sequence batches in order, prefetched by worker threads."""

    def __init__(self, sequence, use_multiprocessing=False, shuffle=False):
        super().__init__(sequence, use_multiprocessing)
        self.shuffle = shuffle

    def _run(self):
        import numpy as _np

        order = list(range(len(self.sequence)))
        while not self._stop_event.is_set():
            if self.shuffle:
                _np.random.shuffle(order)
            for i in order:
                if not self._put(self.sequence[i]):
                    return
            self.sequence.on_epoch_end()

    def start(self, workers=1, max_queue_size=10):
        # ordering requires a single producer
        super().start(workers=1, max_queue_size=max_queue_size)

    def get(self):
        import queue as _q

        while self.is_running():
            try:
                yield self._queue.get(timeout=0.05)
            except _q.Empty:
                continue


class GeneratorEnqueuer(SequenceEnqueuer):
    """Prefetches from a (possibly finite) generator."""

    _SENTINEL = object()

    def __init__(self, generator, use_multiprocessing=False,
                 random_seed=None):
        super().__init__(generator, use_multiprocessing)

    def _run(self):
        try:
            for item in self.sequence:
                if not self._put(item):
                    return
        finally:
            self._put(self._SENTINEL)

    def start(self, workers=1, max_queue_size=10):
        super().start(workers=1, max_queue_size=max_queue_size)

    def get(self):
        import queue as _q

        while True:
            try:
                item = self._queue.get(timeout=0.05)
            except _q.Empty:
                if not self.is_running():
                    return
                continue
            if item is self._SENTINEL:
                return
            yield item


class HDF5Matrix:
    """Array-like view over an HDF5 dataset (keras io_utils surface; the
    reference's loaders read Criteo HDF5 the same way, dlrm.cc:266-382).
    Slices lazily — the file stays on disk until indexed."""

    refs: dict = {}

    def __init__(self, datapath, dataset, start=0, end=None,
                 normalizer=None):
        import h5py  # gated optional dependency

        if datapath not in self.refs:
            self.refs[datapath] = h5py.File(datapath, "r")
        self.data = self.refs[datapath][dataset]
        self.start = start
        self.end = self.data.shape[0] if end is None else end
        self.normalizer = normalizer

    def __len__(self):
        return self.end - self.start

    def __getitem__(self, key):
        import numpy as _np

        n = len(self)
        if isinstance(key, slice):
            start = min(self.start + (key.start or 0), self.end)
            stop = (self.end if key.stop is None
                    else min(self.start + max(key.stop, 0), self.end))
            idx = slice(start, max(stop, start))
        elif isinstance(key, (int, _np.integer)):
            if not 0 <= int(key) < n:
                raise IndexError(
                    f"index {key} out of range for view of length {n}")
            idx = self.start + int(key)
        else:
            key = _np.asarray(key)
            if key.size and (key.min() < 0 or key.max() >= n):
                raise IndexError(
                    f"indices out of range for view of length {n}")
            # h5py wants strictly increasing selections: read the unique
            # sorted rows once, then expand duplicates via the inverse
            # (duplicate ids are the norm for DLRM sparse batches)
            uniq, inv = _np.unique(key + self.start, return_inverse=True)
            out = self.data[uniq][inv].reshape(key.shape +
                                               self.data.shape[1:])
            return self.normalizer(out) if self.normalizer else out
        out = self.data[idx]
        return self.normalizer(out) if self.normalizer else out

    @property
    def shape(self):
        return (len(self),) + self.data.shape[1:]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self):
        return self.data.ndim
