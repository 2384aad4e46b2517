"""Deterministic fault injection for resilience testing (counterpart of
``dlrm_flexflow_tpu/resilience/faultinject.py``, the same specs, sites
and events).

Large-scale training failures are rare in small tests, so each recovery
path (atomic checkpoint commit, retry-on-I/O-error, NaN rollback,
preemption resume) gets a *deterministic* injection point it can be
driven through end-to-end.  Faults are declared as a spec string —
programmatically via :func:`install`, through ``FFConfig.faults``, or
the ``FF_FAULTS`` environment variable — and consumed at fixed sites:

    nan_grads@step=K    poison the step-K batch with NaN — float labels
                        when possible (NaN loss + NaN grads at every
                        parameter), else float inputs (the sentinel's
                        rollback path; see poison_batch; numpy arrays
                        and tensors alike)
    preempt@step=K      raise :class:`Preemption` at the top of global
                        step K (a mid-epoch kill — the resume path)
    preempt@save        raise :class:`Preemption` between the state
                        write and the manifest/rename commit (a kill
                        mid-save — the crash-consistency path)
    io_error@save=N     raise OSError on the next N checkpoint write
                        attempts (the retry-with-backoff path)
    preempt+reshape@step=K:mesh=DxM
                        raise :class:`Reshape` at the top of global
                        step K carrying the TARGET mesh shape
                        {"data": D, "model": M} — a preemption after
                        which the fleet comes back with a different
                        device topology (the normal preemptible-pod
                        case; docs/elastic.md).  The launcher catching it
                        reads ``e.mesh_shape``, recompiles under the
                        new mesh, and resumes elastically.  ``:mesh=``
                        may be omitted when the resuming launcher picks
                        its own shape.
    host_crash@step=K   kill THIS process dead at the top of global
                        step K — ``os._exit`` with :data:`CRASH_EXIT`,
                        no unwinding, no atexit: the host-loss case
                        survivors must detect by heartbeat age and
                        recover from (docs/resilience.md)
    host_hang@step=K    block at the top of global step K (for
                        ``FF_HANG_S`` seconds, default effectively
    host_hang@barrier   forever), then raise :class:`HostLost` — a
                        wedged host the fleet's watchdogs must catch:
                        the stall watchdog at a step, the barrier
                        deadline (``FleetBarrierTimeout``) mid-save

Entries are separated by ``,`` or ``;``.  Every firing decrements the
fault's remaining count (specs without ``=N`` fire once) and emits a
``fault`` telemetry event, so injected faults are visible in
``telemetry report`` next to the recovery actions they triggered.
Injection is deterministic by construction — a spec names the exact
step/site, never a probability — so recovery tests replay bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch


class Preemption(BaseException):
    """An injected kill (TPU slice preemption, SIGKILL mid-save).

    Subclasses BaseException — like KeyboardInterrupt — so generic
    ``except Exception`` recovery code (e.g. the checkpoint manager's
    never-abort save) cannot swallow a simulated death: it must
    propagate out of the run exactly as a real kill would end it.
    """


class Reshape(Preemption):
    """A preemption after which the fleet returns with a DIFFERENT
    device topology (``preempt+reshape`` — docs/elastic.md).
    ``mesh_shape`` is the target ``{axis: size}`` dict the spec carried
    (None when the spec left the resuming shape to the launcher)."""

    def __init__(self, msg: str, mesh_shape: Optional[Dict[str, int]] = None):
        super().__init__(msg)
        self.mesh_shape = mesh_shape


class HostLost(Preemption):
    """A host waking from a hang the fleet already declared dead.

    ``host_hang`` faults block, then raise this: the fleet's watchdogs
    fired long ago, survivors may already be resuming at a reduced
    process count — a late riser must NOT rejoin and keep training.
    Preemption-family (BaseException) so no recovery path swallows it.
    """


#: process exit code of a ``host_crash`` firing (``os._exit``; distinct
#: so launchers can assert the victim died by injection, not by accident)
CRASH_EXIT = 17

_KINDS = ("nan_grads", "io_error", "preempt", "preempt+reshape",
          "host_crash", "host_hang")
_POINTS = ("step", "save", "restore", "barrier")


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """``"DxM"`` -> ``{"data": D, "model": M}`` (the two named axes of the
    JAX package's parallel/mesh.py; a trailing ``x1`` may be omitted:
    ``"2"`` means data=2).  A launcher that catches :class:`Reshape`
    compiles its model under ``make_mesh(e.mesh_shape)`` and resumes:
    ``resilient_fit`` reshards the checkpoint onto it."""
    parts = [p.strip() for p in spec.lower().split("x")]
    if not (1 <= len(parts) <= 2) or not all(p.isdigit() for p in parts):
        raise ValueError(
            f"bad mesh shape {spec!r}: want DxM (data x model), e.g. "
            f"mesh=2x1")
    d = int(parts[0])
    m = int(parts[1]) if len(parts) == 2 else 1
    if d < 1 or m < 1:
        raise ValueError(f"bad mesh shape {spec!r}: sizes must be >= 1")
    return {"data": d, "model": m}


@dataclasses.dataclass
class _Fault:
    kind: str                  # one of _KINDS
    point: str                 # one of _POINTS
    value: Optional[int]       # step number (point="step"), else None
    remaining: int             # firings left
    mesh: Optional[Dict[str, int]] = None  # preempt+reshape target shape

    def spec(self) -> str:
        tail = f"={self.value}" if self.value is not None else ""
        if self.mesh is not None:
            tail += (f":mesh={self.mesh.get('data', 1)}"
                     f"x{self.mesh.get('model', 1)}")
        return f"{self.kind}@{self.point}{tail}"


_faults: List[_Fault] = []
_env_consumed = False


def parse(spec: str) -> List[_Fault]:
    """Parse a fault spec string into fault entries (see module doc)."""
    out: List[_Fault] = []
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "@" not in entry:
            raise ValueError(
                f"bad fault spec {entry!r}: want kind@point[=value]")
        kind, _, rest = entry.partition("@")
        kind = kind.strip()
        value: Optional[int] = None
        mesh: Optional[Dict[str, int]] = None
        point, _, val = rest.partition("=")
        point = point.strip()
        # a reshape spec's value may carry the target topology:
        # preempt+reshape@step=5:mesh=2x1
        val, _, mesh_spec = val.partition(":mesh=")
        if mesh_spec:
            if kind != "preempt+reshape":
                raise ValueError(
                    f"{entry!r}: only preempt+reshape faults carry a "
                    f"target mesh shape")
            mesh = parse_mesh_shape(mesh_spec)
        if val:
            value = int(val)
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {_KINDS})")
        if point not in _POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(known: {_POINTS})")
        if kind == "preempt+reshape" and point != "step":
            raise ValueError(
                f"{entry!r}: preempt+reshape fires at a step boundary "
                f"(kind@step=K[:mesh=DxM]) — a reshape lands between "
                f"runs, not inside a save")
        if point == "barrier" and kind != "host_hang":
            raise ValueError(
                f"{entry!r}: only host_hang faults fire at a barrier "
                f"(host_hang@barrier — the peer that never arrives)")
        if kind == "host_crash" and point != "step":
            raise ValueError(
                f"{entry!r}: host_crash fires at a step boundary "
                f"(host_crash@step=K) — an os._exit kill, detected by "
                f"heartbeat age, not observable at a site it never "
                f"reaches")
        if kind == "host_hang" and point not in ("step", "barrier"):
            raise ValueError(
                f"{entry!r}: host_hang fires at a step boundary "
                f"(host_hang@step=K) or a commit barrier "
                f"(host_hang@barrier) — the only sites the watchdog "
                f"layer guards")
        if point == "step":
            if value is None:
                raise ValueError(
                    f"{entry!r}: step faults need a step number "
                    f"(kind@step=K)")
            out.append(_Fault(kind, point, value, 1, mesh))
        else:
            # value at a site point is a firing count (io_error@save=2)
            out.append(_Fault(kind, point, None,
                              value if value is not None else 1))
    return out


def install(spec: str) -> None:
    """Activate the faults in ``spec`` (additive; see module doc)."""
    _faults.extend(parse(spec))


def install_from_env() -> None:
    """Install ``FF_FAULTS`` once per process (idempotent until
    :func:`clear`)."""
    global _env_consumed
    if _env_consumed:
        return
    _env_consumed = True
    spec = os.environ.get("FF_FAULTS", "").strip()
    if spec:
        install(spec)


def clear() -> None:
    """Remove all installed faults and re-arm env loading (tests)."""
    global _env_consumed
    _faults.clear()
    _env_consumed = False


def active() -> bool:
    return any(f.remaining > 0 for f in _faults)


def save_counts() -> List[int]:
    """Remaining-firings snapshot of every installed fault.  The lag-1
    training loop (resilience/loop.py, docs/pipeline.md) takes one
    before each speculative dispatch: when a rejection of the PREVIOUS
    step discards that in-flight dispatch, any fault that fired inside
    it is un-consumed via :func:`restore_counts` so it re-fires when
    the batch is re-dispatched — exactly the eager loop's semantics,
    where the discarded dispatch never happened."""
    return [f.remaining for f in _faults]


def restore_counts(snap: List[int]) -> None:
    """Restore a :func:`save_counts` snapshot (see there).  Faults
    installed after the snapshot keep their current counts."""
    for f, r in zip(_faults, snap):
        f.remaining = r


def _fire(f: _Fault, step: Optional[int] = None) -> None:
    f.remaining -= 1
    from ..telemetry import emit
    emit("fault", kind=f.kind, point=f.point, step=step,
         remaining=f.remaining)


def _match(kind: str, point: str, step: Optional[int]) -> Optional[_Fault]:
    for f in _faults:
        if f.remaining <= 0 or f.kind != kind or f.point != point:
            continue
        if f.point == "step" and f.value != step:
            continue
        return f
    return None


def _float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _nan_like(x):
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, float("nan"))
    return np.full_like(np.asarray(x), np.nan)


def poison_batch(inputs: Dict[str, object], labels, step: int):
    """``nan_grads@step=K``: return a ``(inputs, labels)`` pair that
    produces a NaN loss AND NaN gradients when the fault fires at this
    step — COPIES; the caller's originals stay clean so a retry after
    rollback trains on the real batch.  Numpy arrays and tensors (a
    prefetched batch already on the device) alike.

    Float LABELS are the poison of choice: activations stay finite, so
    the NaN enters only through the loss cotangent and reaches EVERY
    parameter's gradient.  Poisoning the float INPUTS instead — the
    fallback for integer class-id labels — still yields a NaN loss, but
    relu-family backwards evaluate ``NaN > 0`` as False and ZERO the
    cotangent, so downstream grads may come out finite."""
    f = _match("nan_grads", "step", step)
    if f is None:
        return inputs, labels
    _fire(f, step=step)
    if _float(labels):
        return inputs, _nan_like(labels)
    out = dict(inputs)
    for k, v in out.items():
        if _float(v):
            out[k] = _nan_like(v)
    return out, labels


def maybe_preempt(point: str, step: Optional[int] = None) -> None:
    """Raise :class:`Preemption` when a ``preempt@<point>`` fault fires,
    or :class:`Reshape` (carrying the target mesh shape) for a
    ``preempt+reshape`` fault — the elastic recovery path's kill."""
    f = _match("preempt", point, step)
    if f is not None:
        _fire(f, step=step)
        raise Preemption(f"injected preemption at {point}"
                         + (f" step {step}" if step is not None else ""))
    f = _match("preempt+reshape", point, step)
    if f is not None:
        _fire(f, step=step)
        raise Reshape(
            f"injected preemption+reshape at {point}"
            + (f" step {step}" if step is not None else "")
            + (f" (fleet returns as {f.mesh})" if f.mesh else ""),
            mesh_shape=dict(f.mesh) if f.mesh else None)


def maybe_io_error(point: str, step: Optional[int] = None) -> None:
    """Raise OSError when an ``io_error@<point>`` fault fires."""
    f = _match("io_error", point, step)
    if f is not None:
        _fire(f, step=step)
        raise OSError(f"injected I/O error at {point}")


def maybe_host_fault(point: str, step: Optional[int] = None) -> None:
    """Fire ``host_crash`` / ``host_hang`` faults at ``point`` — the
    host-loss injections the watchdog layer is tested against:

    * ``host_crash``: print a marker, then ``os._exit(CRASH_EXIT)``.
      No exception, no unwinding, no atexit — a crashed host does not
      run cleanup, and survivors must detect it purely by heartbeat
      age / barrier absence.
    * ``host_hang``: block for ``FF_HANG_S`` seconds (default 3600 —
      effectively forever next to any watchdog deadline), then raise
      :class:`HostLost`.  The sleep IS the fault; the raise only stops
      a late-woken host from rejoining a fleet that declared it dead.
    """
    import sys
    import time
    f = _match("host_crash", point, step)
    if f is not None:
        _fire(f, step=step)
        print(f"# faultinject: host_crash at {point}"
              + (f" step {step}" if step is not None else "")
              + f" — exiting {CRASH_EXIT}", file=sys.stderr)
        sys.stderr.flush()
        os._exit(CRASH_EXIT)
    f = _match("host_hang", point, step)
    if f is not None:
        _fire(f, step=step)
        hang_s = float(os.environ.get("FF_HANG_S", "3600"))
        print(f"# faultinject: host_hang at {point}"
              + (f" step {step}" if step is not None else "")
              + f" — blocking {hang_s:g}s", file=sys.stderr)
        sys.stderr.flush()
        time.sleep(hang_s)
        raise HostLost(
            f"injected host hang at {point}"
            + (f" step {step}" if step is not None else "")
            + " woke up — the fleet has long declared this host dead")
