"""What NCCL does to a rank whose peer is gone, on the cards of this
machine: the behaviours ``distributed.shutdown`` and
``InferenceEngine.follow`` are built around.

    python dlrm_flexflow_tpu_torch/tools/nccl_leave.py [--ranks 4]
        [--deadline 10]

Three groups of ``--ranks`` NCCL ranks, one a card (``distributed.
launch`` with no backend), each under the collective deadline
``--deadline`` (s).  In each the last rank (``waiting``: rank 0) stays
alive and silent for twice the deadline while the others:

- ``destroy``: after one all-reduce, call ``destroy_process_group()``
  on a thread and wait for it at most the deadline;
- ``abort``: the same through ``distributed.shutdown()`` (torch's
  abort of the group under NCCL);
- ``waiting``: wait in an NCCL broadcast from rank 0 and read it
  (``.item()``), which rank 0 never sends.

Prints the card's name and power limit, then one JSON line a case: each
rank's record (whether it left and its wall, or how its wait ended),
or, when a rank's process died, the group's error with the ranks' exit
and NCCL's watchdog line.  Needs two or more CUDA cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _record(out: str, rank: int, rec: dict) -> None:
    """Write this rank's record and end the process at once: a rank
    whose teardown is still blocked must not wait on it at exit."""
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rec, f)
    sys.stdout.flush()
    os._exit(0)


def leave_rank(out: str, mode: str, deadline_s: float) -> None:
    """``destroy`` / ``abort``: one all-reduce, then the last rank stays
    silent for twice the deadline while the others leave the group."""
    import torch
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch import distributed as fdist
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.ones(1, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    if rank == world - 1:
        time.sleep(2 * deadline_s)
        _record(out, rank, {"rank": rank, "silent_s": 2 * deadline_s})
    t0 = time.perf_counter()
    if mode == "destroy":
        t = threading.Thread(target=dist.destroy_process_group, daemon=True)
        t.start()
        t.join(deadline_s)
        left = not t.is_alive()
    else:
        left = fdist.shutdown(deadline_s)
    _record(out, rank, {"rank": rank, "mode": mode, "left": left,
                        "wall_s": time.perf_counter() - t0})


def waiting_rank(out: str, deadline_s: float) -> None:
    """Rank 0 stays silent for twice the deadline; every other rank waits
    for its broadcast and reads it."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    x = torch.zeros(1, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    if rank == 0:
        time.sleep(2 * deadline_s)
        _record(out, rank, {"rank": rank, "silent_s": 2 * deadline_s})
    t0 = time.perf_counter()
    try:
        dist.broadcast(x, src=0)
        x.item()
        raised = None
    except Exception as e:  # noqa: BLE001 — what NCCL does is the record
        raised = repr(e)[:400]
    _record(out, rank, {"rank": rank, "raised": raised,
                        "wall_s": time.perf_counter() - t0})


def _case(name: str, target: str, ranks: int, kwargs: dict,
          deadline_s: float, tmp: str) -> dict:
    from dlrm_flexflow_tpu_torch import distributed as fdist
    out = os.path.join(tmp, name)
    t0 = time.perf_counter()
    try:
        fdist.launch(f"dlrm_flexflow_tpu_torch.tools.nccl_leave:{target}",
                     ranks, kwargs={"out": out, **kwargs},
                     timeout_s=4 * deadline_s + 60,
                     collective_timeout_s=deadline_s)
        error = None
    except RuntimeError as e:
        text = str(e)
        error = {"first_line": text.splitlines()[0],
                 "watchdog": [ln.strip()[:300] for ln in text.splitlines()
                              if "Watchdog caught collective operation "
                              "timeout" in ln][:1]}
    records = []
    for r in range(ranks):
        path = f"{out}.{r}.json"
        if os.path.exists(path):
            with open(path) as f:
                records.append(json.load(f))
    return {"case": name, "ranks": ranks, "deadline_s": deadline_s,
            "group_wall_s": time.perf_counter() - t0, "records": records,
            "group_error": error}


def main(argv=None) -> int:
    import tempfile

    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--deadline", type=float, default=10.0)
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < max(2, args.ranks):
        print(f"nccl_leave: {args.ranks} ranks need as many CUDA cards; "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0], flush=True)
    tmp = tempfile.mkdtemp(prefix="nccl-leave-")
    for name, target, kw in (
            ("destroy", "leave_rank", {"mode": "destroy"}),
            ("abort", "leave_rank", {"mode": "abort"}),
            ("waiting", "waiting_rank", {})):
        kw = {**kw, "deadline_s": args.deadline}
        print(json.dumps(_case(name, target, args.ranks, kw, args.deadline,
                               tmp)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
