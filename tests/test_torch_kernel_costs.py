"""The port's dispatch gates (dlrm_flexflow_tpu_torch/ops/kernel_costs.py)
against the JAX package's on the CPU.

The port keeps the JAX functions and formulas and replaces every
constant with one measured on an H100 (chip_smoke.py phase 20(a)).  So:
given the JAX package's own constants, each port gate decides as the JAX
gate does over a grid of shapes (the formulas are the same); the
structural refusals hold under the port's constants; and the port's
constants are the H100 readings, each with its source, with no v5e
number and no ICI collective model left.  The decisions the port's
constants give at the served shapes, which PERF.md states, are pinned
last.  JAX is imported here only.
"""

import inspect
import itertools
import re

import pytest

from dlrm_flexflow_tpu.ops import kernel_costs as jkc

from dlrm_flexflow_tpu_torch.ops import kernel_costs as pkc

#: the constants both modules define
SHARED = ("SET_KERNEL_NS_PER_ROW", "EMITTER_SWEEP_GBPS", "GATHER_NS_PER_ROW",
          "HBM_GBPS", "OP_BOUNDARY_NS", "DISPATCH_MARGIN", "HOST_LINK_GBPS",
          "HOST_LINK_LATENCY_NS")
MEASURED = tuple(k for k in SHARED if k != "DISPATCH_MARGIN")


@pytest.fixture
def jax_constants(monkeypatch):
    for k in SHARED:
        monkeypatch.setattr(pkc, k, getattr(jkc, k))


GRIDS = {
    "row_set_wins": list(itertools.product(
        [10_000, 400_000, 8_000_000], [16, 64, 128], [1, 100, 8192, 131_072],
        [2, 4])),
    "fused_interact_wins": [
        (b, t, bag, d, 4, inter) for b, t, bag, d, inter in itertools.product(
            [1, 2, 4, 8, 16, 64, 256, 1024], [1, 8, 26], [1, 3], [16, 64],
            ["cat", "dot"])],
    "tiered_storage_wins": [
        dict(num_rows=r, dim=64, itemsize=4, hot_rows=h, lookups=lk,
             hit_rate=hit)
        for r, h, lk, hit in itertools.product(
            [1000, 10**6, 8 * 10**6], [64, 4096, 32768, 2 * 10**6],
            [0, 16, 2048, 8192], [0.0, 0.3, 0.5, 0.8, 0.9, 0.99, 1.0])],
}


@pytest.mark.parametrize("fn", sorted(GRIDS))
def test_same_formula_as_jax_under_jax_constants(jax_constants, fn):
    port, jax_ = getattr(pkc, fn), getattr(jkc, fn)
    assert list(inspect.signature(port).parameters) == \
        list(inspect.signature(jax_).parameters)
    decisions = set()
    for args in GRIDS[fn]:
        if isinstance(args, dict):
            got, want = port(**args), jax_(**args)
        else:
            got, want = port(*args), jax_(*args)
        assert got == want, (fn, args)
        decisions.add(want)
    assert decisions == {True, False}  # the grid crosses each flip


@pytest.mark.parametrize("kw", [
    dict(num_rows=1000, hot_rows=1000, lookups=8, hit_rate=1.0),
    dict(num_rows=1000, hot_rows=5000, lookups=8, hit_rate=1.0),
    dict(num_rows=10**6, hot_rows=0, lookups=8, hit_rate=1.0),
    dict(num_rows=10**6, hot_rows=4096, lookups=0, hit_rate=1.0),
    dict(num_rows=10**6, hot_rows=64, lookups=128, hit_rate=1.0),
])
def test_structural_refusals_hold_under_the_h100_constants(kw):
    assert pkc.tiered_storage_wins(dim=64, itemsize=4, **kw) is False
    assert jkc.tiered_storage_wins(dim=64, itemsize=4, **kw) is False


def test_constants_are_h100_readings_with_their_source():
    """Every measured constant is positive and its comment names the
    chip_smoke.py phase and the card with its power limit; the margin is
    the JAX package's policy; no v5e number or ICI model is left.  The
    exchange gate (ported with the mesh) prices NVLink and the dense
    stack from the H100 data sheet, each constant marked unmeasured: one
    card cannot measure a rank-to-rank link."""
    src = inspect.getsource(pkc)
    assert "v5e" not in src and "TPU" not in src.split('"""')[2]
    assert pkc.DISPATCH_MARGIN == jkc.DISPATCH_MARGIN
    for k in MEASURED:
        v = getattr(pkc, k)
        assert isinstance(v, float) and v > 0, k
        m = re.search(r"((?:#:.*\n)+)" + k + " = ", src)
        assert m, k
        comment = " ".join(m.group(1).replace("#:", " ").split())
        assert "chip_smoke.py phase 20(a)" in comment, k
        assert "NVIDIA H100 80GB HBM3, 700.00 W" in comment, k
        assert v != getattr(jkc, k), k  # re-measured, not carried over
    for gone in ("ICI_GBPS", "MXU_F32_FLOPS_PER_NS"):
        assert not hasattr(pkc, gone), gone
    for k in ("NVLINK_GBPS", "DENSE_FLOPS_PER_NS"):
        m = re.search(r"((?:#:.*\n)+)" + k + " = ", src)
        assert m and "UNMEASURED" in m.group(1), k
        assert getattr(pkc, k) > 0, k


# the run_random.sh shapes the port serves and trains (PERF.md)
ROWS, T, D, HOT, TOP = 1_000_000, 8, 64, 4096, 256


def _tiered_flip_hit(lookups):
    """The hit rate above which ``tiered_storage_wins`` accepts, solved
    from its formula: the margin times the tiered cost (gather, one link
    latency, each miss its link bytes and install) equals streaming's."""
    row_link = D * 4 / pkc.HOST_LINK_GBPS
    m = pkc.DISPATCH_MARGIN
    stream = pkc.HOST_LINK_LATENCY_NS + lookups * (row_link
                                                   + pkc.GATHER_NS_PER_ROW)
    misses = ((stream - m * (lookups * pkc.GATHER_NS_PER_ROW
                             + pkc.HOST_LINK_LATENCY_NS))
              / (m * (row_link + pkc.SET_KERNEL_NS_PER_ROW)))
    return 1.0 - misses / lookups


def test_tiered_gate_flips_at_the_served_shape():
    """At 8 x 1M rows of 256 B, 4096 hot rows a table and the top bucket's
    2048 lookups the H100 gate refuses below the solved hit rate and
    accepts above it; the flip lies between 0.5 and 1 (PERF.md states
    it)."""
    flip = _tiered_flip_hit(TOP * T)
    assert 0.5 < flip < 1.0
    for hit, want in ((flip - 0.005, False), (flip + 0.005, True),
                      (0.0, False), (1.0, True)):
        assert pkc.tiered_storage_wins(
            num_rows=T * ROWS, dim=D, itemsize=4, hot_rows=T * HOT,
            lookups=TOP * T, hit_rate=hit) is want, hit


@pytest.mark.parametrize("parent,n", [
    (T * HOT, TOP * T),          # the tiered install
    (T * ROWS, 131_072),         # the staged epilogue writeback
    (T * ROWS, 16_384),          # the ladder block writeback
])
def test_row_set_gate_would_pick_the_library_at_the_paths_shapes(parent, n):
    """The JAX formula prices the library call as a sweep of the parent;
    ``index_copy_`` writes only its rows, so on the H100 the formula's
    answer is not a measurement of which is faster (PERF.md holds the
    measured lines).  Its answer at every shape the port launches B5 on
    is the library call."""
    assert not pkc.row_set_wins(parent, D, n, 4)


def _fused_flip_batch(interact):
    """The batch above which ``fused_interact_wins`` keeps the unfused
    chain (T tables, bag 1), solved from its formula; None when the
    kernel wins at every batch."""
    per_row = T * (pkc.SET_KERNEL_NS_PER_ROW * pkc.DISPATCH_MARGIN
                   - pkc.GATHER_NS_PER_ROW)
    inter = 2.0 * T * D * 4
    boundaries = 3
    if interact == "dot":
        inter += 2.0 * (T + 1) ** 2 * 4
        boundaries = 5
    slope = per_row - inter / pkc.HBM_GBPS
    if slope <= 0:
        return None
    return boundaries * pkc.OP_BOUNDARY_NS / slope


@pytest.mark.parametrize("interact", ["cat", "dot"])
@pytest.mark.parametrize("batch", [1, 8, 64, 256])
def test_fused_gate_picks_the_kernel_at_the_served_buckets(interact, batch):
    """At every serving bucket the fused kernel wins, as the port
    launches it."""
    assert pkc.fused_interact_wins(batch, T, 1, D, 4, interact)


@pytest.mark.parametrize("interact", ["cat", "dot"])
def test_fused_gate_flips_at_the_solved_batch(interact):
    """Above the batch solved from the formula the unfused chain wins
    (PERF.md states the batch), below it the kernel."""
    flip = _fused_flip_batch(interact)
    assert flip is not None and flip > 256
    assert pkc.fused_interact_wins(int(flip) - 1, T, 1, D, 4, interact)
    assert not pkc.fused_interact_wins(int(flip) + 2, T, 1, D, 4, interact)
