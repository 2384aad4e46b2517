"""Atomic, verified, retained checkpointing (counterpart of
``dlrm_flexflow_tpu/resilience/manager.py``, its single-process path).

``checkpoint.save_checkpoint`` writes files in place — a kill mid-save
leaves a directory that looks like a checkpoint but isn't, and the next
resume dies inside it.  :class:`CheckpointManager` supplies the
production contract on top:

* **atomic commit** — every save lands in ``tmp-<step>-<pid>/`` first,
  each file is fsync'd, and one ``os.rename`` publishes the finished
  ``ckpt-<step>/``; readers can never observe a partial checkpoint;
* **verification** — a ``manifest.json`` with the per-file SHA-256 of
  everything in the directory, re-checked on restore and by
  :func:`latest_checkpoint` (corrupt entries are skipped, never
  returned);
* **retention** — the newest ``keep_n`` valid checkpoints survive;
  older ones, stale ``tmp-*`` debris of killed saves, and unverifiable
  ``ckpt-*`` directories are garbage-collected after each commit;
* **never aborts the run** — transient I/O errors retry with
  exponential backoff; a save that still fails logs a ``checkpoint``
  telemetry event and returns ``None`` (training continues; losing one
  checkpoint must not lose the run).

The manifest is written byte for byte as the JAX package writes it
(``json.dump(..., indent=1, sort_keys=True)`` of the step and the
per-file SHA-256 table), so either package's :func:`verify_checkpoint`
accepts the other's directories, and either package resumes from them.

Single-writer per directory: concurrent managers on one directory are
not coordinated.

**Ranks** (``multihost``; None: on when the process group has more than
one rank, as JAX reads ``process_count() > 1``).  The pod commit is the
JAX package's protocol with a rank for a process: every rank writes its
``shard-pNNN`` pair (``checkpoint.save_pod_shards``) into one shared
``tmp-<step>-mh/``, rank 0 writes the manifest over ALL files and
publishes with the one atomic rename, and three fenced phases keep the
manifest from hashing a shard still being written and every rank from
returning before the commit is visible.  The fences are file barriers in
the shared directory (``.barrier-<tag>/pN`` markers), never a
collective: after a peer dies gloo and NCCL may be wedged.  Each barrier
has a deadline (``barrier_timeout_s``): past it the save raises
:class:`~.watchdog.FleetBarrierTimeout` naming the absent ``pN``, after a
``recovery`` ``phase="barrier_timeout"`` event and a flight record, and
never retries.  A pod save is a single attempt; a non-pod save under
more than one rank gathers the state once on every rank (a collective)
and rank 0 alone writes it, with its retries.  A pod save's stages are
spans under its ``ckpt.save``: ``ckpt.d2h``, ``ckpt.write``,
``ckpt.fsync``, ``ckpt.sha256`` (rank 0) and each ``ckpt.barrier``
wait (its ``phase`` attribute names the fence).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ..checkpoint import (CheckpointError, restore_checkpoint,
                          save_checkpoint)
from ..distributed import _identity
from ..telemetry import emit
from ..telemetry import metrics as _tmetrics
from ..telemetry.fleet import dump_flight_record
from ..telemetry.trace import pop_span, push_span, span, start_span
from . import faultinject
from .watchdog import FleetBarrierTimeout

_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
MANIFEST = "manifest.json"
EXTRA = "extra.json"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(root: str) -> List[str]:
    """Relative paths of every regular file under ``root`` (sorted —
    manifests must be byte-stable for identical content)."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            out.append(os.path.relpath(os.path.join(dirpath, f), root))
    return sorted(out)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # e.g. platforms where dirs cannot be opened — best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def verify_checkpoint(path: str) -> List[str]:
    """Errors for one committed checkpoint directory (empty = valid):
    the manifest must parse and every listed file must exist with a
    matching SHA-256; files not in the manifest are also flagged (a
    manifest is a complete inventory, not a sample)."""
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        return [f"{path!r}: missing {MANIFEST}"]
    except (json.JSONDecodeError, OSError) as e:
        return [f"{mpath!r}: unreadable manifest ({e})"]
    files = manifest.get("files")
    if not isinstance(files, dict):
        return [f"{mpath!r}: manifest has no 'files' table"]
    errs = []
    for rel, want in sorted(files.items()):
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            errs.append(f"{path!r}: missing file {rel!r}")
            continue
        got = _sha256(fp)
        if got != want:
            errs.append(f"{path!r}: {rel!r} hash mismatch "
                        f"(manifest {want[:12]}…, file {got[:12]}…)")
    extra = set(_walk_files(path)) - set(files) - {MANIFEST}
    if extra:
        errs.append(f"{path!r}: files not in manifest: {sorted(extra)}")
    return errs


def _quick_corrupt(path: str) -> bool:
    """Cheap structural check for gc's sweep: a committed checkpoint
    whose manifest is missing or unparseable can never restore.  Full
    per-file hash verification stays at discovery/restore
    (latest_checkpoint / restore_latest) — gc runs after EVERY save and
    must not re-read O(keep_n x checkpoint-bytes) from disk each time.
    A bit-rotted dir (manifest fine, hashes stale) is therefore retained
    by gc but still skipped at restore."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            json.load(f)
        return False
    except (OSError, json.JSONDecodeError):
        return True


def _list_ckpts(directory: str) -> List[Tuple[int, str]]:
    """(step, path) of every committed ``ckpt-<step>`` dir, newest first."""
    out = []
    try:
        names = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest checkpoint in ``directory`` that VERIFIES
    (manifest present, all hashes match), or None.  Partial ``tmp-*``
    directories and corrupt entries are skipped — a killed save can
    never be handed to restore."""
    for _step, path in _list_ckpts(directory):
        if not verify_checkpoint(path):
            return path
    return None


class CheckpointManager:
    """See module docstring.  ``directory`` holds the run's checkpoints;
    ``keep_n`` newest valid ones are retained; failed writes retry
    ``retries`` times with ``backoff_s * 2**attempt`` sleeps."""

    def __init__(self, directory: str, keep_n: int = 3, retries: int = 2,
                 backoff_s: float = 0.05, use_orbax: Optional[bool] = None,
                 fsync: bool = True, multihost: Optional[bool] = None,
                 barrier_timeout_s: float = 300.0):
        self.directory = str(directory)
        self.keep_n = max(1, int(keep_n))
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        if use_orbax:
            raise NotImplementedError(
                "the port writes npz checkpoints only (use_orbax=None or "
                "False)")
        self.use_orbax = use_orbax
        self.fsync = fsync
        # deadline on every podshard commit barrier: past it the save
        # raises FleetBarrierTimeout (BaseException — see _barrier)
        # naming the absent ranks, instead of parking this rank forever
        # behind a dead peer
        self.barrier_timeout_s = float(barrier_timeout_s)
        # pod mode: every rank writes its own shard files into one
        # shared directory, rank 0 commits the one manifest.  None =
        # on when the process group has more than one rank.  Pod saves
        # are single-attempt: the write is fenced by barriers, and a
        # per-rank retry loop would deadlock the peers parked at them
        self.multihost = multihost

    def _is_multihost(self) -> bool:
        if self.multihost is not None:
            return bool(self.multihost)
        return _identity()[1] > 1

    # ------------------------------------------------------------------ save
    def save(self, state, model=None, extra: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None) -> Optional[str]:
        """Atomically write one checkpoint; returns the committed path or
        None when every attempt failed.  NEVER raises on I/O failure —
        a failed save logs a ``checkpoint`` telemetry event and the
        training run continues.  Only the BaseException family escapes:
        :class:`faultinject.Preemption` (a simulated or real kill) and
        :class:`FleetBarrierTimeout` (a pod commit barrier whose peers
        never arrived: a dead fleet must abort loudly, not log "save
        failed" and park at the next collective).  A non-pod save under
        more than one rank returns None on every rank but 0, which alone
        writes."""
        if step is None:
            step = int(state.step)
        t0 = time.perf_counter()
        # ckpt.save span parents to the caller's ambient span (the
        # resilient loop's epoch/fit span) — the training trace shows
        # where checkpoint wall time lands.  A Preemption mid-save
        # abandons it, like every other bookkeeping of a killed run.
        sspan = start_span("ckpt.save", attrs={"step": step})
        last_err: Optional[BaseException] = None

        # one success and one failure epilogue, so the save telemetry
        # (event, counter, span) cannot drift between paths
        def committed(final: str, attempt: int,
                      sweep: bool = True) -> str:
            if sweep:
                self.gc()
            emit("checkpoint", action="save", step=step, path=final,
                 duration_s=time.perf_counter() - t0, attempt=attempt,
                 files=len(_walk_files(final)))
            _tmetrics.note_checkpoint_save()
            sspan.set_attr("attempt", attempt)
            sspan.end()
            return final

        def failed(err: BaseException, attempt: int,
                   what: str) -> None:
            emit("checkpoint", action="save_failed", step=step,
                 attempt=attempt, error=repr(err),
                 duration_s=time.perf_counter() - t0)
            sspan.set_attr("error", repr(err))
            sspan.end(status="error")
            import sys
            print(f"# {what} checkpoint save failed, continuing "
                  f"without it: {err!r}", file=sys.stderr)
            return None

        rank, world = _identity()
        if self._is_multihost():
            # one attempt, barrier-fenced (see __init__) — a failure
            # logs and returns None like an exhausted retry; its stage
            # spans parent to ckpt.save
            push_span(sspan)
            try:
                final = self._write_and_commit_multihost(state, model,
                                                         extra, step)
            except Exception as e:  # noqa: BLE001 — never abort the run
                return failed(e, 0, "multihost")
            finally:
                pop_span(sspan)
            # one sweeper (rank 0): concurrent rmtree would race
            return committed(final, 0, sweep=rank == 0)
        if world > 1:
            # the gathered save: every rank joins the gather ONCE, outside
            # rank 0's retry loop (a retry must not re-enter a
            # collective the other ranks have left)
            from ..elastic.reshard import gather_state
            state = gather_state(state)
            if rank != 0:
                sspan.end()
                return None
        for attempt in range(self.retries + 1):
            if attempt:
                emit("checkpoint", action="retry", step=step,
                     attempt=attempt, error=repr(last_err))
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                final = self._write_and_commit(state, model, extra, step)
            except Exception as e:  # noqa: BLE001 — never abort the run.
                # Preemption (a simulated kill) subclasses BaseException,
                # like KeyboardInterrupt — it propagates past this
                # handler by construction, leaving its tmp debris for
                # gc()/latest_checkpoint() to tolerate.
                last_err = e
                continue
            return committed(final, attempt)
        return failed(
            last_err, self.retries,
            f"(after {self.retries + 1} attempts)")

    def _write_and_commit(self, state, model, extra, step: int) -> str:
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f"tmp-{step}-{os.getpid()}")
        final = os.path.join(self.directory, f"ckpt-{step}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        # on any exception below, tmp is left behind — a retry re-runs
        # the rmtree above; a kill's debris is exactly what gc() and
        # latest_checkpoint() are built to tolerate
        save_checkpoint(tmp, state, step=step,
                        use_orbax=self.use_orbax, model=model)
        # injection points: a transient write error (retried) or a kill
        # landing between the state write and the commit — the window
        # an atomic rename exists to make harmless
        faultinject.maybe_io_error("save", step=step)
        faultinject.maybe_preempt("save", step=step)
        if extra is not None:
            with open(os.path.join(tmp, EXTRA), "w") as f:
                json.dump(extra, f)
        files = _walk_files(tmp)
        manifest = {"step": step,
                    "files": {rel: _sha256(os.path.join(tmp, rel))
                              for rel in files}}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        if self.fsync:
            for rel in files + [MANIFEST]:
                _fsync_file(os.path.join(tmp, rel))
            _fsync_dir(tmp)
        if os.path.isdir(final):
            # re-save at the same step (e.g. a resumed run whose cadence
            # revisits a boundary): NEVER un-publish a valid checkpoint
            # — a kill between "move old aside" and "publish new" would
            # leave ZERO restorable copies.  Same step = same training
            # state, so the existing valid commit already IS this save;
            # only a corrupt leftover is replaced (removing it loses
            # nothing — it was never restorable).
            if not verify_checkpoint(final):
                shutil.rmtree(tmp)
                return final
            shutil.rmtree(final)
        os.rename(tmp, final)  # THE commit
        if self.fsync:
            _fsync_dir(self.directory)
        return final

    def _barrier(self, tag: str, pidx: int, nproc: int,
                 timeout_s: Optional[float] = None) -> None:
        """Shared-filesystem barrier: each rank drops a marker file
        ``p<rank>`` under ``.barrier-<tag>/`` and waits until all
        ``nproc`` are present.  Every rank creates its marker BEFORE
        polling, so once anyone counts ``nproc`` the set is complete — a
        later sweep of the directory (gc, or the next save) therefore
        reads as "barrier passed" to stragglers still polling.
        File-based, never a collective: the checkpoint directory is
        already assumed shared, and after a peer dies the process group
        (gloo or NCCL) may be wedged.

        Deadlined: past ``timeout_s`` (default ``barrier_timeout_s``)
        the wait raises :class:`FleetBarrierTimeout` NAMING the absent
        ranks (``pN``), after emitting a ``recovery`` event and dumping a
        flight record — a peer that will never arrive must end this
        save loudly, not park the survivor forever.  BaseException by
        the Preemption precedent: ``save()``'s never-abort ``except
        Exception`` must not turn a dead fleet into "save failed,
        continuing".  Single-attempt semantics hold — the timeout
        aborts, it NEVER retries (a retry would re-fence survivors at
        a barrier the dead can't fill)."""
        faultinject.maybe_host_fault("barrier")  # the peer that hangs
        if timeout_s is None:
            timeout_s = self.barrier_timeout_s
        bdir = os.path.join(self.directory, f".barrier-{tag}")
        os.makedirs(bdir, exist_ok=True)
        with open(os.path.join(bdir, f"p{pidx}"), "w"):
            pass
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                present = set(os.listdir(bdir))
            except FileNotFoundError:
                return  # swept by a process that counted everyone
            if len(present) >= nproc:
                return
            if time.monotonic() > deadline:
                missing = sorted(
                    {f"p{i}" for i in range(nproc)} - present,
                    key=lambda s: int(s[1:]))
                err = FleetBarrierTimeout(tag, missing, timeout_s,
                                          arrived=len(present),
                                          expected=nproc)
                emit("recovery", phase="barrier_timeout", tag=tag,
                     missing=list(missing), arrived=len(present),
                     expected=nproc, deadline_s=float(timeout_s))
                dump_flight_record(err)  # best-effort (None w/o a log)
                raise err
            time.sleep(0.01)

    def _write_and_commit_multihost(self, state, model, extra,
                                    step: int) -> str:
        """The pod commit protocol: every rank writes its own
        ``shard-pNNN`` pair into ONE shared tmp dir (the directory must
        be a shared filesystem), then rank 0 alone writes the manifest
        over ALL files and publishes with the one atomic rename.
        Barriers fence the three phases so the manifest can never hash
        a shard still being written and no rank returns before the
        commit is visible.  ``save`` is a COLLECTIVE call (of files, not
        of the process group): every rank must call it for the same
        step, in the same order."""
        pidx, nproc = _identity()

        def fence(phase: str) -> None:
            with span("ckpt.barrier", attrs={"phase": phase}):
                self._barrier(f"{tag}-{phase}", pidx, nproc)

        self._mh_saves = getattr(self, "_mh_saves", 0) + 1
        tag = f"{step}-{self._mh_saves}"
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f"tmp-{step}-mh")
        final = os.path.join(self.directory, f"ckpt-{step}")
        if pidx == 0:
            # sweep fences of PAST saves only (tag-mismatched): this
            # save's -tmp fence may already hold a fast peer's marker
            for name in os.listdir(self.directory):
                if name.startswith(".barrier-") \
                        and not name.startswith(f".barrier-{tag}-"):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        fence("tmp")
        save_checkpoint(tmp, state, step=step, model=model,
                        multihost=True)
        # the same injection window as the single-host path: a kill
        # here leaves tmp debris the (rank-0) gc sweeps
        faultinject.maybe_io_error("save", step=step)
        faultinject.maybe_preempt("save", step=step)
        if self.fsync:
            with span("ckpt.fsync"):
                for name in os.listdir(tmp):
                    if name.startswith(f"shard-p{pidx:03d}") \
                            or (pidx == 0
                                and not name.startswith("shard-")):
                        _fsync_file(os.path.join(tmp, name))
        fence("written")
        if pidx == 0:
            if extra is not None:
                with open(os.path.join(tmp, EXTRA), "w") as f:
                    json.dump(extra, f)
            files = _walk_files(tmp)
            with span("ckpt.sha256"):
                manifest = {"step": step,
                            "files": {rel: _sha256(os.path.join(tmp, rel))
                                      for rel in files}}
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            if self.fsync:
                for rel in [EXTRA] * bool(extra is not None) + [MANIFEST]:
                    _fsync_file(os.path.join(tmp, rel))
                _fsync_dir(tmp)
            if os.path.isdir(final):
                # same never-un-publish rule as the single-host commit
                if not verify_checkpoint(final):
                    shutil.rmtree(tmp)
                else:
                    shutil.rmtree(final)
            if os.path.isdir(tmp):
                os.rename(tmp, final)  # THE commit
            if self.fsync:
                _fsync_dir(self.directory)
        fence("commit")
        if pidx == 0:
            # sweep THIS save's fences: safe once everyone reached the
            # commit barrier (a straggler still polling reads a missing
            # dir as "passed"), and the next save's fences carry a
            # different tag — so the LAST save of a run leaves no
            # .barrier-* debris behind (the prologue sweep above only
            # covers runs that save again)
            for phase in ("tmp", "written", "commit"):
                shutil.rmtree(
                    os.path.join(self.directory,
                                 f".barrier-{tag}-{phase}"),
                    ignore_errors=True)
        return final

    # --------------------------------------------------------------- restore
    def latest(self) -> Optional[str]:
        return latest_checkpoint(self.directory)

    def restore_latest(self, model=None, inference_only: bool = False,
                       on_mesh_change: str = "error", *, device=None
                       ) -> Tuple[Any, Dict[str, Any], str]:
        """(state, extra, path) from the newest VALID checkpoint.
        ``inference_only=True`` loads params without optimizer slots
        (the serving engine's restore — checkpoint.py);
        ``on_mesh_change="reshard"`` is the elastic cross-topology
        restore; ``device`` goes to ``checkpoint.restore_checkpoint``,
        whose stage spans parent to ``ckpt.restore``.  Raises
        :class:`CheckpointError` when the directory holds none."""
        path = self.latest()
        if path is None:
            raise CheckpointError(
                f"no valid checkpoint under {self.directory!r}")
        t0 = time.perf_counter()
        with span("ckpt.restore", attrs={"path": path}):
            state = restore_checkpoint(path, model=model,
                                       inference_only=inference_only,
                                       on_mesh_change=on_mesh_change,
                                       device=device)
            extra: Dict[str, Any] = {}
            epath = os.path.join(path, EXTRA)
            if os.path.isfile(epath):
                with open(epath) as f:
                    extra = json.load(f)
        emit("checkpoint", action="restore", path=path,
             step=int(state.step),
             duration_s=time.perf_counter() - t0)
        return state, extra, path

    # -------------------------------------------------------------------- gc
    def gc(self) -> Tuple[int, int]:
        """Retention + debris sweep: keep the ``keep_n`` newest
        structurally-sound checkpoints; remove older ones, ``ckpt-*``
        directories with no readable manifest (never restorable), and
        stale ``tmp-*`` dirs left by killed saves.  Structural check
        only — full hash verification lives at discovery/restore (see
        ``_quick_corrupt``).  Returns (ckpts_removed, tmp_removed) and
        emits one ``checkpoint`` gc event when anything was swept."""
        removed_ckpt = removed_tmp = 0
        valid_seen = 0
        for _step, path in _list_ckpts(self.directory):
            if _quick_corrupt(path) or valid_seen >= self.keep_n:
                shutil.rmtree(path, ignore_errors=True)
                removed_ckpt += 1
            else:
                valid_seen += 1
        try:
            names = os.listdir(self.directory)
        except (FileNotFoundError, NotADirectoryError):
            names = []
        # .barrier-* dirs are the pod commit fences.  Sweeping them here
        # is safe only when no pod save can be in flight (a peer may have
        # pre-created the NEXT save's fence; deleting a fence that has
        # not collected every marker would let a straggler read "missing
        # = passed" early) — in pod mode the save prologue sweeps stale
        # fences by tag
        sweep_barriers = not self._is_multihost()
        for name in names:
            if name.startswith("tmp-") or name.endswith(".old") \
                    or (sweep_barriers and name.startswith(".barrier-")):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                removed_tmp += 1
        if removed_ckpt or removed_tmp:
            emit("checkpoint", action="gc", kept=valid_seen,
                 removed_ckpts=removed_ckpt, removed_tmp=removed_tmp)
        return removed_ckpt, removed_tmp
