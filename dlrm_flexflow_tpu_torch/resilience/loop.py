"""The fault-tolerant training loop behind ``FFModel.fit(...)``'s
resilience options (counterpart of ``dlrm_flexflow_tpu/resilience/loop.py``).

``fit``'s default path trains staged epochs; survival needs a host
decision point around every step, so a step can be checkpointed,
rejected, or resumed mid-epoch.  When any resilience option is active,
``fit`` delegates here: a per-batch loop that

* checkpoints through a :class:`..resilience.CheckpointManager` every
  ``every_n_steps`` global steps and/or ``every_n_epochs`` epochs, with
  the dataloader's shuffle/cursor state and the epoch position riding
  in the checkpoint's ``extra.json``;
* auto-resumes (``resume=True``) from the newest VALID checkpoint:
  params + optimizer state + PRNG key + step come from the TrainState
  and the dataloader replays the exact batch sequence from its restored
  cursor, so a killed run continues bit for bit as the run that never
  died; a checkpoint of another topology (a ``preempt+reshape`` kill,
  relaunched under ``make_mesh(e.mesh_shape)``) resumes through
  ``elastic.reshard_restore``, to the tolerance of the new reduction
  order;
* arms a :class:`..resilience.NaNSentinel` at lag 1: each step's loss is
  read on the host while the NEXT step is already in flight.  An
  anomalous step is rejected one step late — the pre-dispatch state is
  still live (the step runs with ``donate=False`` while a sentinel is
  armed), the speculative in-flight step computed from the poisoned
  state is discarded (its injected faults are un-consumed), a hetero
  model's host tables are put back as they were before the rejected
  step, and the batch is skipped or retried at a backed-off learning
  rate;
* honors the fault-injection harness (``FF_FAULTS`` / ``FFConfig.faults``
  / ``faultinject.install``) at its step boundary;
* prefetches input batches (``FFConfig.prefetch_depth`` > 0,
  ``data/prefetch.py``), with checkpoint cursors staying consumed-exact.

The port's donated step updates the tables in place, where the JAX
package's arrays are immutable.  So a cadence save of step k must finish
its device-to-host copy before step k+1 is enqueued, or the checkpoint
silently holds a later step's rows: the loop settles (and saves) a step
due for a save before it dispatches the next one, and the save's
``.cpu()`` copies return only once the values are on the host.  The
epoch-cadence save runs at the epoch's end, before the next dispatch.

The loop bypasses the epoch row cache (``_last_fit_used_scan = False``),
so every step, adopted or retried, runs the row-sparse step and its
row-update kernel on the card.  It records ``model._fit_loss_trace`` /
``model._fit_loss_steps`` (the loss of every adopted step and its global
step number), the observable the recovery tests compare bit for bit
against an uninterrupted run.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import mesh_topology, same_topology, saved_topology
from ..data.prefetch import PrefetchLoader
from ..metrics import MetricsAccumulator
from ..telemetry import active_log, sample_memory
from ..telemetry import metrics as _tmetrics
from ..telemetry import rowfreq
from ..telemetry.fleet import dump_flight_record, predicted_sync_ms
from ..telemetry.trace import pop_span, push_span, start_span
from . import faultinject
from .manager import CheckpointManager
from .sentinel import NaNSentinel


def _loader_state(dataloader) -> Optional[dict]:
    sd = getattr(dataloader, "state_dict", None)
    return sd() if callable(sd) else None


class _Pending:
    """One dispatched-but-unverified training step: everything needed
    to adopt it (record loss/metrics, cadence-save), reject it (restore
    the pre-dispatch world), or retry its batch at a backed-off rate."""

    __slots__ = ("pre_state", "new_state", "mets", "step", "lr", "span",
                 "inputs", "labels", "host_snap", "loader_sd", "n_samples",
                 "data_wait_s", "dispatch_wall_s")

    def __init__(self, pre_state, new_state, mets, step, lr, span,
                 inputs, labels, host_snap, loader_sd, n_samples,
                 data_wait_s=0.0, dispatch_wall_s=0.0):
        self.pre_state = pre_state
        self.new_state = new_state
        self.mets = mets
        self.step = step
        self.lr = lr
        self.span = span
        self.inputs = inputs
        self.labels = labels
        self.host_snap = host_snap
        self.loader_sd = loader_sd
        self.n_samples = n_samples
        self.data_wait_s = data_wait_s
        self.dispatch_wall_s = dispatch_wall_s


def resilient_fit(model, state, dataloader, epochs: int, verbose: bool,
                  callbacks, manager: Optional[CheckpointManager],
                  every_n_steps: Optional[int],
                  every_n_epochs: Optional[int], resume: bool,
                  sentinel: Optional[NaNSentinel],
                  show_throughput: bool = True):
    """See module docstring.  Returns ``(state, samples_per_second)`` —
    the same contract as ``FFModel.fit``.  ``callbacks`` are objects with
    the keras hooks (``on_train_begin``, ``on_epoch_begin``,
    ``on_batch_begin``, ... ``on_train_end``); any makes the loop settle
    every step at once instead of at lag 1."""
    model._require_compiled()
    faultinject.install_from_env()
    cfg_faults = getattr(model.config, "faults", "") or ""
    if cfg_faults and not getattr(model, "_cfg_faults_installed", False):
        faultinject.install(cfg_faults)
        model._cfg_faults_installed = True

    acc = MetricsAccumulator(model.metrics)
    model._last_metrics = acc
    model._pending_lr = None
    model._last_fit_used_scan = False  # survival trades the staged epochs
    cbs = list(callbacks or [])
    for cb in cbs:
        if getattr(cb, "model", None) is None:
            cb.set_model(model)
        cb.on_train_begin()

    # the asynchronous input pipeline: wrap the loader unless the caller
    # already did; batches arrive placed on the device
    depth = int(getattr(model.config, "prefetch_depth", 0) or 0)
    own_prefetch = None
    if depth > 0 and not isinstance(dataloader, PrefetchLoader):
        # consumed-exact fetch snapshots cost a deepcopy per batch —
        # pay it only when a checkpoint could actually store one
        own_prefetch = PrefetchLoader(dataloader, depth=depth,
                                      place_fn=model.batch_placer(),
                                      snapshot=manager is not None)
        dataloader = own_prefetch

    # span chain: fit -> epoch -> dispatch, with ckpt.save/ckpt.restore
    # spans emitted inside the manager under the ambient span.  Parenting
    # is explicit except for the manager calls, which read the thread's
    # current span; those pushes are scoped by try/finally
    fit_span = start_span("train.fit", attrs={"epochs": int(epochs),
                                              "resume": bool(resume)})

    start_epoch = 0
    if resume and manager is not None and manager.latest() is not None:
        push_span(fit_span)  # parents the manager's ckpt.restore span
        try:
            # elastic recovery: when the newest checkpoint was saved on
            # another topology than this model runs (the fleet reshaped
            # across the kill — preempt+reshape), route through
            # reshard_restore: the saved leaves, reassembled to
            # host-logical arrays, re-placed under THIS model's partition
            # rules.  Same-topology resumes keep the plain restore
            saved = saved_topology(manager.latest())
            if saved is not None and not same_topology(
                    saved, mesh_topology(getattr(model, "mesh", None))):
                from ..elastic.reshard import reshard_restore
                state, extra, _path = reshard_restore(manager, model)
            else:
                state, extra, _path = manager.restore_latest(model=model)
        except BaseException as e:
            # a failed resume dies with its last events on record too
            dump_flight_record(e)
            raise
        finally:
            pop_span(fit_span)
        if extra.get("loader") is not None \
                and hasattr(dataloader, "load_state_dict"):
            dataloader.load_state_dict(extra["loader"])
        start_epoch = int(extra.get("epoch", 0))

    global_step = int(state.step)
    donate = sentinel is None  # rejection needs the pre-dispatch state live
    # hetero host tables take their SGD step inside the dispatch
    # (train_step), so a rejection rolls them back too.  apply_host_sgd
    # rebinds each table's array, so the pre-dispatch snapshot holds
    # references, not copies: restoring a two-step-old snapshot undoes
    # the rejected step and the discarded in-flight one.  Across the
    # ranks of a mesh only the owner rank holds the tables, so only it
    # snapshots and rolls back (the verdict reads the global loss, the
    # same on every rank)
    hetero_ops = [op for op in getattr(model, "_hetero_ops", [])
                  if getattr(op, "host_table", None) is not None
                  ] if sentinel else []

    def host_snapshot():
        return {op.name: op.host_table.array for op in hetero_ops}

    def host_restore(snap):
        for op in hetero_ops:
            op.host_table.array = snap[op.name]
    losses, loss_steps = [], []
    samples = [0]
    epochs_run = 0
    # lag-1 pipelining is on whenever no per-batch callbacks demand an
    # eager host decision point; with callbacks the loop settles each
    # dispatch at once (the same adopted trajectory, bit for bit)
    lag1 = not cbs
    pending: list = [None]      # the one unverified dispatch, or None
    stall_s = [0.0]             # host wall waiting on the dataloader
    dispatch_s = [0.0]          # host wall issuing train_step dispatches
    sync_s = [0.0]              # host wall blocked on the losses' reads
    t0 = time.perf_counter()
    last_adopt = [t0]           # adopt-to-adopt wall = one step's wall
    step_wall = [0.0]           # the most recent adopt-to-adopt wall

    # step-level stall watchdog (resilience/watchdog.py): off unless
    # FF_STALL_MULTIPLE (or a config field of that name) is set
    stall_mult = float(getattr(model.config, "stall_abort_multiple", 0)
                       or os.environ.get("FF_STALL_MULTIPLE", 0) or 0)
    stall_wd = None
    if stall_mult > 0:
        from .watchdog import StallWatchdog
        stall_wd = StallWatchdog(
            last_adopt, step_wall, multiple=stall_mult,
            floor_s=float(getattr(model.config, "stall_abort_floor_s", 0)
                          or os.environ.get("FF_STALL_FLOOR_S", 0)
                          or 5.0))
        stall_wd.start()

    cur_ep = [fit_span]  # the ambient parent for cadence saves

    def save(state_, step_, loader_sd, mark):
        if manager is None:
            return
        push_span(cur_ep[0])  # parents the manager's ckpt.save span
        try:
            manager.save(state_, model=model, step=step_,
                         extra={"epoch": mark, "loader": loader_sd,
                                "epochs_requested": int(epochs)})
        finally:
            pop_span(cur_ep[0])

    def adopt(p: _Pending, loss_f: float, ep: int, wait_s: float = 0.0):
        """Commit one verified dispatch: loss trace, metrics fold,
        throughput counters, phase attribution, cadence checkpoint.
        ``wait_s`` is the host wall settle() spent blocked on this
        dispatch's loss: at lag 1 the device window overlapped host
        work, so blocking beyond it is exposed wait."""
        step_no = p.step + 1
        _tmetrics.TRAIN_STEPS.inc()
        samples[0] += p.n_samples
        losses.append(loss_f)
        loss_steps.append(step_no)
        acc.update({k: v for k, v in p.mets.items() if k != "loss"})
        model._fit_state = p.new_state
        now = time.perf_counter()
        step_wall[0] = now - last_adopt[0]
        log = active_log()
        if log is not None:
            log.emit("phase_time", step=step_no, phase="step",
                     step_wall_ms=step_wall[0] * 1e3,
                     data_wait_ms=p.data_wait_s * 1e3,
                     dispatch_ms=p.dispatch_wall_s * 1e3,
                     sync_wait_ms=wait_s * 1e3,
                     samples=p.n_samples)
        last_adopt[0] = now
        if every_n_steps and step_no % every_n_steps == 0:
            # a save at the epoch's final batch marks the NEXT epoch
            # (the loader cursor has wrapped to 0 already)
            sd = p.loader_sd
            mark = ep + 1 if (sd is not None
                              and sd.get("batch", 0) == 0) else ep
            save(p.new_state, step_no, sd, mark)

    def retry_backed_off(p: _Pending, ep: int):
        """lr_backoff after a rejection: re-dispatch the REJECTED batch
        eagerly (each attempt fenced — rejections are rare) until the
        sentinel adopts it or raises TrainingDiverged."""
        nonlocal state, global_step
        retry_state = model.set_learning_rate(p.pre_state,
                                              p.lr * sentinel.lr_factor)
        while True:
            lr = float(getattr(model.optimizer, "lr", 0.0))
            rspan = start_span("train.dispatch", parent=cur_ep[0],
                               attrs={"step": p.step, "retry": True})
            faultinject.maybe_preempt("step", step=p.step)
            faultinject.maybe_host_fault("step", step=p.step)
            binputs, blabels = faultinject.poison_batch(
                p.inputs, p.labels, step=p.step)
            host_snap = host_snapshot()
            td = time.perf_counter()
            new_state, mets = model.train_step(retry_state, binputs,
                                               blabels, donate=False)
            dispatch_s[0] += time.perf_counter() - td
            tw = time.perf_counter()
            loss_f = float(mets["loss"])
            wait = time.perf_counter() - tw
            sync_s[0] += wait
            if sentinel.observe(loss_f, new_state, step=p.step, lr=lr):
                rspan.end()
                state = new_state
                global_step = p.step + 1
                adopt(_Pending(retry_state, new_state, mets, p.step, lr,
                               rspan, p.inputs, p.labels, host_snap,
                               p.loader_sd, p.n_samples, p.data_wait_s,
                               p.dispatch_wall_s),
                      loss_f, ep, wait_s=wait)
                return
            rspan.set_attr("policy", sentinel.policy)
            rspan.end(status="rejected")
            host_restore(host_snap)
            retry_state = model.set_learning_rate(
                retry_state, lr * sentinel.lr_factor)

    def settle(ep: int, discard=None) -> bool:
        """Read the pending dispatch's loss (the device is usually past
        it already) and adopt or reject it.  Returns True when the world
        is unchanged (nothing pending / adopted); False after a rejection
        rolled ``state``/``global_step`` back (the caller must
        re-dispatch whatever it had in flight).  ``discard`` undoes the
        caller's speculative in-flight dispatch on rejection, BEFORE any
        retry re-fires its faults."""
        nonlocal state, global_step
        p, pending[0] = pending[0], None
        if p is None:
            return True
        tw = time.perf_counter()
        loss_f = float(p.mets["loss"])
        wait = time.perf_counter() - tw
        sync_s[0] += wait
        if sentinel is None or sentinel.observe(loss_f, p.new_state,
                                                step=p.step, lr=p.lr):
            p.span.end()
            adopt(p, loss_f, ep, wait_s=wait)
            return True
        # rejected one step late: p.pre_state is still live (the step
        # ran on a clone of it)
        p.span.set_attr("policy", sentinel.policy)
        p.span.end(status="rejected")
        state = p.pre_state
        global_step = p.step
        host_restore(p.host_snap)
        if discard is not None:
            discard()
        if sentinel.policy == "lr_backoff":
            retry_backed_off(p, ep)
        # skip: p's batch is dropped entirely
        return False

    ep = start_epoch
    try:
        while ep < epochs:
            ep_span = start_span("train.epoch", parent=fit_span,
                                 attrs={"epoch": ep})
            cur_ep[0] = ep_span
            for cb in cbs:
                cb.on_epoch_begin(ep)
            if model._pending_lr is not None:
                state = model.set_learning_rate(state, model._pending_lr)
                model._pending_lr = None
            acc.reset()
            batches = iter(dataloader)
            it = -1
            while True:
                ts = time.perf_counter()
                try:
                    inputs, labels = next(batches)
                except StopIteration:
                    break
                bstall = time.perf_counter() - ts
                stall_s[0] += bstall
                it += 1
                rowfreq.observe_batch(inputs)  # ~0 when telemetry off
                # cursor at FETCH time = resume position after this batch
                # (a prefetching loader reports consumed-exact state);
                # snapshotting copies the RNG state, so skip it unless a
                # step-cadence save could consume it
                loader_sd = (_loader_state(dataloader)
                             if manager is not None and every_n_steps
                             else None)
                n_samples = int(labels.shape[0])
                for cb in cbs:
                    cb.on_batch_begin(it)
                while True:  # re-dispatch loop for THIS batch
                    # fence point: a cadence save due on the pending step
                    # settles BEFORE the next dispatch — a checkpoint must
                    # never hold an unverified state, and the next
                    # (in-place) dispatch would change the rows the save
                    # reads
                    if pending[0] is not None and every_n_steps and \
                            (pending[0].step + 1) % every_n_steps == 0:
                        settle(ep)
                        continue  # re-check (a rejection moved steps)
                    dspan = start_span("train.dispatch", parent=ep_span,
                                       attrs={"step": global_step})
                    fault_snap = faultinject.save_counts()
                    faultinject.maybe_preempt("step", step=global_step)
                    faultinject.maybe_host_fault("step", step=global_step)
                    binputs, blabels = faultinject.poison_batch(
                        inputs, labels, step=global_step)
                    host_snap = host_snapshot()
                    td = time.perf_counter()
                    new_state, mets = model.train_step(
                        state, binputs, blabels, donate=donate)
                    dwall = time.perf_counter() - td
                    dispatch_s[0] += dwall
                    lr = float(getattr(model.optimizer, "lr", 0.0))
                    cur = _Pending(state, new_state, mets, global_step,
                                   lr, dspan, inputs, labels, host_snap,
                                   loader_sd, n_samples, bstall, dwall)
                    # speculatively advance so the PREVIOUS dispatch's
                    # loss check overlaps this one's device window
                    state = new_state
                    global_step += 1

                    def discard(dspan=dspan, fault_snap=fault_snap):
                        # cur was computed from the rejected state: drop
                        # it and un-consume the faults that fired inside
                        # it (the re-dispatch must re-fire them)
                        dspan.end(status="discarded")
                        faultinject.restore_counts(fault_snap)

                    if pending[0] is not None \
                            and not settle(ep, discard=discard):
                        continue  # prev rejected: re-dispatch this batch
                    pending[0] = cur
                    if not lag1:
                        # eager mode (per-batch callbacks): verdict now.
                        # A skip-rejection drops THIS batch; lr_backoff
                        # already retried it to adoption inside settle.
                        settle(ep)
                    break
                for cb in cbs:
                    cb.on_batch_end(it)
            # epoch boundary: the last dispatch settles before the
            # epoch's host work (and its save) runs
            while not settle(ep):
                pass
            epochs_run += 1
            if verbose:
                print(f"epoch {ep}: {acc.report()}")
            if every_n_epochs and (ep + 1) % every_n_epochs == 0:
                save(state, global_step, _loader_state(dataloader),
                     ep + 1)
            early_stop = False
            for cb in cbs:
                if cb.on_epoch_end(ep) is True:
                    early_stop = True
            ep_span.end()
            cur_ep[0] = fit_span
            ep += 1
            if early_stop:
                print(f"Accuracy reached, early stop, epoch: {ep - 1}")
                break
    except BaseException as e:
        # flight recorder: TrainingDiverged, a cadence-save error,
        # injected Preemption faults and any unhandled exception dump the
        # EventLog ring + open spans before the raise continues (best
        # effort; the original exception always propagates unchanged)
        dump_flight_record(e)
        raise
    finally:
        if stall_wd is not None:
            stall_wd.stop()
        if own_prefetch is not None:
            own_prefetch.close()

    dev = state.step.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    thpt = samples[0] / max(elapsed, 1e-9)
    fit_span.set_attr("samples", int(samples[0]))
    fit_span.end()
    _tmetrics.TRAIN_SAMPLES_PER_S.set(thpt)
    _tmetrics.DATA_STALL_PCT.set(100.0 * stall_s[0] / max(elapsed, 1e-9))
    model._fit_state = state
    model._fit_loss_trace = np.asarray(losses, dtype=np.float64)
    model._fit_loss_steps = np.asarray(loss_steps, dtype=np.int64)
    last_loss = losses[-1] if losses else None
    log = active_log()
    if log is not None:
        log.emit("step", wall_s=elapsed, samples=int(samples[0]),
                 samples_per_s=thpt, epochs=epochs_run, fenced=True,
                 phase="resilient_fit", metrics=acc.finalized_means(),
                 loss=last_loss,
                 data_stall_ms=round(stall_s[0] * 1e3, 3),
                 dispatch_ms=round(dispatch_s[0] * 1e3, 3))
        # whole-stretch phase attribution: the host wall blocked on the
        # losses at lag 1, beside the predicted grad-sync wall (None on
        # one device)
        exposed = 100.0 * sync_s[0] / max(elapsed, 1e-9)
        pred = predicted_sync_ms(getattr(state, "params", None))
        log.emit("phase_time", step=global_step, phase="resilient_fit",
                 steps=len(loss_steps), step_wall_ms=elapsed * 1e3,
                 data_wait_ms=stall_s[0] * 1e3,
                 dispatch_ms=dispatch_s[0] * 1e3,
                 sync_wait_ms=sync_s[0] * 1e3,
                 exposed_comm_pct=exposed,
                 predicted_sync_ms=(None if pred is None
                                    else pred * max(len(loss_steps), 1)),
                 samples=int(samples[0]))
        _tmetrics.EXPOSED_COMM_PCT.set(exposed)
        rowfreq.emit_all(log)
        sample_memory(phase="resilient_fit", log=log)
    if verbose and show_throughput:
        print(f"ELAPSED TIME = {elapsed:.4f}s, "
              f"THROUGHPUT = {thpt:.2f} samples/s")
    err = None
    for cb in cbs:
        try:
            cb.on_train_end()
        except Exception as e:  # run every hook, re-raise the first
            err = err or e
    if err is not None:
        raise err
    return state, thpt
