"""Asynchronous batch prefetch (counterpart of
``dlrm_flexflow_tpu/data/prefetch.py``): overlap the host's input work
with the step in flight on the device.

:class:`PrefetchLoader` runs a background thread that pulls batches from
the wrapped loader, applies a placement function, and parks up to
``depth`` ready batches in a bounded queue while the current step runs.

Resume stays bit-identical: the wrapped loader's cursor advances as
batches are FETCHED, but :meth:`PrefetchLoader.state_dict` reports the
position of the last batch *consumed* — each batch travels through the
queue with the cursor snapshot taken at its fetch, and the snapshot
becomes current only when the training loop takes the batch.  A
checkpoint cut at step k therefore resumes at batch k+1 however many
batches the prefetcher had in flight.

Placement.  ``place_fn`` is either a callable applied to every input
array and the labels (the JAX package's contract: ``model.shard_batch``),
or a :class:`BatchPlacer` (``FFModel.batch_placer()``, what ``fit`` uses),
which places a whole batch.  On the card a ``BatchPlacer`` casts the
batch to the graph's dtypes on the host, copies it into pinned staging
buffers and from there to the device with non-blocking copies on a
stream of its own, and records one CUDA event per batch.  Two rules keep
that correct:

* a staging buffer is rewritten only after the event of its last copy
  has completed (the worker waits on it), so a copy still reading the
  buffer never sees the next batch;
* the consuming thread's current stream waits on the batch's event
  before the batch is handed out, and the batch's device tensors are
  marked as used on that stream (``record_stream``).  The training step,
  eager or a replayed CUDA graph copying the batch into its static
  buffers, runs on that stream, so it reads the batch only after the
  copies land, and the allocator never hands the tensors' memory to the
  prefetch stream while the step may still read it.

Thread discipline: the worker is a module-level function that touches
no loader attributes — everything it needs arrives as arguments, and
results and errors travel back through the thread-safe queue.  The close
protocol is :class:`~dlrm_flexflow_tpu_torch.concurrency.CloseOnce`.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..concurrency import CloseOnce
from ..tensor import numpy_dtype

#: queue item tags — batches, the natural end of an epoch, and a
#: producer-side error re-raised in the consumer.
_BATCH, _DONE, _ERROR = "batch", "done", "error"

#: worker put/get poll interval: long enough to stay off the CPU,
#: short enough that close() never waits noticeably.
_POLL_S = 0.05

#: pinned staging buffers per input in a BatchPlacer's ring: one being
#: filled while the last batch's copy may still read the other
_SLOTS = 2


class BatchPlacer:
    """Places whole batches on ``device``: each input cast to its dtype in
    ``dtypes`` (input name -> torch dtype), the labels to ``label_dtype``.

    ``place_batch(inputs, labels)`` returns ``(inputs, labels, ready)``:
    tensors on the device, and ``ready`` None or a callable the consuming
    thread runs before it uses them (module docstring).  On the CPU it
    converts and returns ``ready=None``.  On the card it stages through a
    ring of pinned buffers per input; the CUDA stream is made at the
    first batch, in the worker thread.  The inputs named in ``host`` (the
    ids of host-placed tables) are converted and copied on the host and
    stay there."""

    def __init__(self, device, dtypes: Dict[str, torch.dtype],
                 label_dtype: torch.dtype, *, host=()):
        self.device = torch.device(device)
        self.dtypes = dict(dtypes)
        self.label_dtype = label_dtype
        self.host = frozenset(host)
        self._stream = None
        # name -> ring of [pinned buffer or None, event of its last copy]
        self._rings: Dict[str, list] = {}
        self._turn: Dict[str, int] = {}

    def _host(self, value, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(dtype=dtype)
        return torch.from_numpy(np.asarray(value, dtype=numpy_dtype(dtype)))

    def _to_device(self, name: str, value, dtype: torch.dtype):
        """``value`` through the next staging slot of ``name`` onto the
        device, on the prefetch stream; returns (device tensor, slot)."""
        host = self._host(value, dtype)
        ring = self._rings.setdefault(
            name, [[None, None] for _ in range(_SLOTS)])
        turn = self._turn.get(name, 0)
        self._turn[name] = (turn + 1) % _SLOTS
        slot = ring[turn]
        if slot[1] is not None:
            slot[1].synchronize()  # its last copy has read the buffer
        buf = slot[0]
        if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
            buf = slot[0] = torch.empty(host.shape, dtype=host.dtype,
                                        pin_memory=True)
        buf.copy_(host)
        return buf.to(self.device, non_blocking=True), slot

    def place_batch(self, inputs, labels):
        if self.device.type != "cuda":
            return ({k: self._host(v, self.dtypes.get(k, torch.float32)
                                   ).to(self.device)
                     for k, v in inputs.items()},
                    self._host(labels, self.label_dtype).to(self.device),
                    None)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        slots, placed = [], {}
        with torch.cuda.stream(self._stream):
            for k, v in inputs.items():
                if k in self.host:
                    # a copy: a loader's batch may be a view it reuses
                    placed[k] = self._host(
                        v, self.dtypes.get(k, torch.float32)).clone()
                    continue
                placed[k], slot = self._to_device(
                    k, v, self.dtypes.get(k, torch.float32))
                slots.append(slot)
            lab, slot = self._to_device("\0labels", labels, self.label_dtype)
            slots.append(slot)
            done = torch.cuda.Event()
            done.record(self._stream)
        for slot in slots:
            slot[1] = done
        tensors = [v for k, v in placed.items() if k not in self.host] + [lab]

        def ready():
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in tensors:
                t.record_stream(current)

        return placed, lab, ready


def _produce(src, q: "queue.Queue", stop: threading.Event,
             place: Optional[Callable], snapshot: Callable) -> None:
    """Worker body: fetch, place, enqueue — until the epoch ends, an
    error occurs, or ``stop`` is set.  Every ``put`` polls the stop
    event so a closing consumer never deadlocks against a full queue."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    place_batch = getattr(place, "place_batch", None)
    try:
        for inputs, labels in src:
            if stop.is_set():
                return
            ready = None
            if place_batch is not None:
                inputs, labels, ready = place_batch(inputs, labels)
            elif place is not None:
                inputs = {k: place(v) for k, v in inputs.items()}
                labels = place(labels)
            if not put((_BATCH, inputs, labels, snapshot(), ready)):
                return
        put((_DONE, None, None, None, None))
    except BaseException as e:  # re-raised at the consumer's next take
        put((_ERROR, e, None, None, None))


class PrefetchLoader:
    """Wrap any batch loader (``ArrayDataLoader``, ``SyntheticDLRMLoader``,
    or anything yielding ``(inputs_dict, labels)``) with ``depth``-deep
    asynchronous prefetch and optional device placement (``place_fn``:
    a per-array callable or a :class:`BatchPlacer`, module docstring);
    ``place_fn=None`` prefetches host arrays only.

    The wrapped loader must not be iterated or mutated elsewhere while
    an epoch is active: the worker owns it between ``__iter__`` and the
    epoch's end.  ``state_dict``/``load_state_dict`` proxy the inner
    loader's resume contract with consumed-exact semantics; the loader
    shape attributes (``num_batches``, ``batch_size``, ``inputs``,
    ``labels``, ``drop_last``, ``shuffle``) pass through so ``fit`` sees
    the wrapped loader exactly like the bare one.
    """

    def __init__(self, loader, depth: int = 2,
                 place_fn: Optional[Callable] = None,
                 snapshot: bool = True):
        if int(depth) < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._inner = loader
        self.depth = int(depth)
        self._place = place_fn
        # snapshot=False skips the per-fetch deepcopy of the inner
        # loader's resume state, for wrap sites that never call
        # state_dict (plain fit's own wrap, sentinel-only resilient
        # runs); state_dict then proxies the inner loader's LIVE cursor
        # (fetch position, not consumed-exact), correct between epochs
        self._snapshot = bool(snapshot)
        self._closer = CloseOnce()
        self._closed = threading.Event()
        # (queue, stop event, thread) of the active epoch, if any —
        # written and read only by the consuming thread
        self._epoch = None
        # cursor snapshot of the last CONSUMED batch (None = nothing
        # consumed since construction / the last load_state_dict)
        self._consumed = None

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        # not a generator: the closed check and the worker start happen
        # at iter() time, so iter-after-close raises at once
        if self._closed.is_set():
            raise RuntimeError("PrefetchLoader is closed")
        self._stop_epoch()  # a re-iter abandons any half-consumed epoch
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        sd = getattr(self._inner, "state_dict", None)
        if self._snapshot and callable(sd):
            def snapshot(sd=sd):
                return copy.deepcopy(sd())
        else:
            def snapshot():
                return None
        src = iter(self._inner)
        # seed the consumed cursor with the epoch-start snapshot BEFORE
        # the worker starts: a state_dict() between iter() and the first
        # consumed batch must say "nothing consumed this epoch", never
        # the worker's in-flight fetch cursor
        seed = snapshot()
        if seed is not None:
            self._consumed = seed
        t = threading.Thread(
            target=_produce,
            args=(src, q, stop, self._place, snapshot),
            name="dlrm-prefetch", daemon=True)
        self._epoch = (q, stop, t)
        t.start()
        return self._consume(q, stop, t)

    def _consume(self, q: "queue.Queue", stop: threading.Event,
                 t: threading.Thread):
        try:
            while True:
                while True:
                    try:
                        kind, a, b, snap, ready = q.get(timeout=_POLL_S)
                        break
                    except queue.Empty:
                        if not t.is_alive():
                            # the worker may have parked its sentinel and
                            # exited between the Empty and this check:
                            # drain once before concluding it died
                            try:
                                kind, a, b, snap, ready = q.get_nowait()
                                break
                            except queue.Empty:
                                raise RuntimeError(
                                    "prefetch worker died without a "
                                    "sentinel") from None
                if kind is _DONE:
                    return
                if kind is _ERROR:
                    raise a
                # consumed-exact cursor: the snapshot taken at this
                # batch's FETCH becomes current when the loop takes it
                if snap is not None:
                    self._consumed = snap
                if ready is not None:
                    ready()  # this thread's stream waits for the copies
                yield a, b
        finally:
            stop.set()
            t.join()
            # clear the registration only if it is still OURS: a
            # late-finalized abandoned generator must not clobber the
            # epoch a subsequent iter() registered
            if self._epoch is not None and self._epoch[1] is stop:
                self._epoch = None

    def peek(self):
        return self._inner.peek()

    # -------------------------------------------------------------- resume
    def state_dict(self) -> Optional[dict]:
        """The wrapped loader's resume state at the last batch CONSUMED —
        not the (further-advanced) fetch cursor.  None when the wrapped
        loader has no resume contract of its own."""
        if self._consumed is not None:
            return copy.deepcopy(self._consumed)
        sd = getattr(self._inner, "state_dict", None)
        return sd() if callable(sd) else None

    def load_state_dict(self, sd: dict) -> None:
        self._stop_epoch()  # in-flight batches predate the restore
        self._inner.load_state_dict(sd)
        self._consumed = None

    # --------------------------------------------------------------- close
    def _stop_epoch(self) -> None:
        if self._epoch is None:
            return
        _q, stop, t = self._epoch
        stop.set()
        t.join()
        self._epoch = None

    def close(self) -> dict:
        """Stop any active worker and refuse further iteration.
        Idempotent and safe under concurrent callers (CloseOnce)."""

        def shutdown():
            self._closed.set()
            self._stop_epoch()
            return {"closed": True}

        return self._closer.run(shutdown)

    # ------------------------------------------------- shape passthroughs
    @property
    def num_batches(self) -> int:
        return self._inner.num_batches

    @property
    def batch_size(self) -> int:
        return self._inner.batch_size

    @property
    def inputs(self):
        return getattr(self._inner, "inputs", None)

    @property
    def labels(self):
        return getattr(self._inner, "labels", None)

    @property
    def drop_last(self):
        return getattr(self._inner, "drop_last", False)

    @property
    def shuffle(self):
        return getattr(self._inner, "shuffle", False)

    def __len__(self):
        return len(self._inner)
