"""Leaving a rank group whose peer is gone, on the CPU (gloo ranks): the
repairs that running the mesh on four cards over NCCL forced, as far as
gloo can show them.

* A mesh engine's follower whose leader left without its stop leaves
  too: ``follow()`` waits for each header on the host group and raises
  "follow(): the leader ..." when the leader's process is gone or past
  the group's collective deadline while it is alive and silent; the
  follower's process then leaves its group and exits 0.
  ``distributed.launch(collective_timeout_s=)`` sets that deadline.
* ``distributed.shutdown`` under NCCL aborts the group (torch's own
  abort, which waits for no peer) instead of destroying it; gloo cannot
  run NCCL, so the choice is checked on a one-rank gloo group reported
  as NCCL.
"""

import glob
import json
import os
import threading

import pytest

from dlrm_flexflow_tpu_torch import distributed as fdist

TESTS = os.path.dirname(os.path.abspath(__file__))
#: the leave groups' collective deadline (s), and how long the silent
#: leader stays alive after its last answer
DEADLINE_S, SILENT_S = 5.0, 7.0
REQUESTS = 3


@pytest.fixture(scope="module")
def left(tmp_path_factory):
    """Both leave groups, run at once: ``{how: [rank records]}``."""
    tmp = tmp_path_factory.mktemp("leave")
    errs = {}

    def run(how):
        try:
            fdist.launch("torch_leave_ranks:serve_then_leave", 2, kwargs={
                "out": str(tmp / how), "how": how, "requests": REQUESTS,
                "silent_s": SILENT_S}, device="cpu", timeout_s=90,
                pythonpath=[TESTS], collective_timeout_s=DEADLINE_S)
        except BaseException as e:  # noqa: BLE001 — raised below
            errs[how] = e

    groups = [threading.Thread(target=run, args=(how,))
              for how in ("exits", "silent")]
    for g in groups:
        g.start()
    for g in groups:
        g.join()
    if errs:
        raise next(iter(errs.values()))
    return {how: [json.load(open(p)) for p in
                  sorted(glob.glob(str(tmp / f"{how}.rank*.json")))]
            for how in ("exits", "silent")}


@pytest.mark.parametrize("how", ["exits", "silent"])
def test_follower_leaves_after_its_leader_left_without_the_stop(left, how):
    """The follower's ``follow()`` raises the leader's loss (chained from
    gloo's error) instead of parking; its rank exits 0 (``launch``
    raised nothing).  A leader whose process ended frees it well before
    the deadline; a silent one at the deadline, not before."""
    leader, follower = left[how]
    assert leader["collective_timeout_s"] == DEADLINE_S
    assert follower["collective_timeout_s"] == DEADLINE_S
    assert follower["error"].startswith("follow(): the leader (rank 0)")
    served = int(follower["error"].split(" after ")[1].split()[0])
    assert served >= REQUESTS
    assert follower["cause"] != "None"
    waited = follower["left_at"] - leader["last_answer_at"]
    if how == "exits":
        assert waited < DEADLINE_S + 5.0
    else:
        assert DEADLINE_S - 0.5 <= waited < SILENT_S


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield dist
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_shutdown_aborts_an_nccl_group_and_destroys_a_gloo_one(
        one_rank_group, monkeypatch, tmp_path):
    """Under NCCL ``shutdown`` leaves through torch's abort of the group
    and never calls ``destroy_process_group`` (whose finalize waits for
    peers); under gloo it destroys the group."""
    from torch.distributed import distributed_c10d as c10d
    dist = one_rank_group
    calls = []
    real_abort, real_destroy = (c10d._abort_process_group,
                                dist.destroy_process_group)
    monkeypatch.setattr(c10d, "_abort_process_group",
                        lambda *a: (calls.append("abort"), real_abort())[1])
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: (calls.append("destroy"),
                                    real_destroy())[1])
    with monkeypatch.context() as m:
        m.setattr(dist, "get_backend", lambda *a: "nccl")
        assert fdist.shutdown(timeout_s=5.0) is True
    assert calls == ["abort"] and not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/again",
                            world_size=1, rank=0)
    assert fdist.shutdown(timeout_s=5.0) is True
    assert calls == ["abort", "destroy"] and not dist.is_initialized()
