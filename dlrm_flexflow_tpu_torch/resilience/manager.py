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
not coordinated.  The multi-host pod commit (every process writing its
shard files under cross-host barriers) is not ported: ``multihost=True``
raises ``NotImplementedError`` naming ROADMAP.md item 8, part 2.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ..checkpoint import (_ITEM8, CheckpointError, restore_checkpoint,
                          save_checkpoint)
from ..telemetry import emit
from ..telemetry import metrics as _tmetrics
from ..telemetry.trace import start_span
from . import faultinject

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
        # the podshard barrier's deadline (kept for the JAX signature;
        # the multi-host commit is not ported)
        self.barrier_timeout_s = float(barrier_timeout_s)
        # multi-host pod mode: not ported (ROADMAP.md item 8, part 2).
        # None means one process, which the port always is
        self.multihost = multihost

    def _is_multihost(self) -> bool:
        return bool(self.multihost)

    # ------------------------------------------------------------------ save
    def save(self, state, model=None, extra: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None) -> Optional[str]:
        """Atomically write one checkpoint; returns the committed path or
        None when every attempt failed.  NEVER raises on I/O failure —
        a failed save logs a ``checkpoint`` telemetry event and the
        training run continues.  Only the BaseException family escapes
        (:class:`faultinject.Preemption`, a simulated or real kill), and
        the ``NotImplementedError`` of a multi-host manager."""
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
        def committed(final: str, attempt: int) -> str:
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

        if self._is_multihost():
            # not ported: its NotImplementedError is no I/O failure to
            # log and continue past
            return committed(self._write_and_commit_multihost(
                state, model, extra, step), 0)
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
        """The JAX package's shared-filesystem commit barrier, with its
        deadline (``FleetBarrierTimeout``): not ported."""
        raise NotImplementedError(
            f"the multi-host checkpoint barrier is not ported: {_ITEM8}")

    def _write_and_commit_multihost(self, state, model, extra,
                                    step: int) -> str:
        """The JAX package's pod commit protocol (every process writes
        its shard files, process 0 commits the manifest): not ported."""
        raise NotImplementedError(
            f"the multi-host checkpoint commit is not ported: {_ITEM8}")

    # --------------------------------------------------------------- restore
    def latest(self) -> Optional[str]:
        return latest_checkpoint(self.directory)

    def restore_latest(self, model=None, inference_only: bool = False,
                       on_mesh_change: str = "error"
                       ) -> Tuple[Any, Dict[str, Any], str]:
        """(state, extra, path) from the newest VALID checkpoint.
        ``inference_only=True`` loads params without optimizer slots
        (the serving engine's restore — checkpoint.py);
        ``on_mesh_change`` is checked by
        ``checkpoint.restore_checkpoint`` (a changed topology raises).
        Raises :class:`CheckpointError` when the directory holds
        none."""
        path = self.latest()
        if path is None:
            raise CheckpointError(
                f"no valid checkpoint under {self.directory!r}")
        t0 = time.perf_counter()
        with start_span("ckpt.restore", attrs={"path": path}):
            state = restore_checkpoint(path, model=model,
                                       inference_only=inference_only,
                                       on_mesh_change=on_mesh_change)
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
        # .barrier-* dirs are the JAX package's multihost commit fences
        # (debris in a directory it wrote); the port never makes them
        for name in names:
            if name.startswith("tmp-") or name.endswith(".old") \
                    or name.startswith(".barrier-"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                removed_tmp += 1
        if removed_ckpt or removed_tmp:
            emit("checkpoint", action="gc", kept=valid_seen,
                 removed_ckpts=removed_ckpt, removed_tmp=removed_tmp)
        return removed_ckpt, removed_tmp
