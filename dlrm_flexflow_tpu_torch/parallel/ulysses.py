"""Ulysses sequence parallelism: an all-to-all head/sequence swap
(counterpart of ``dlrm_flexflow_tpu/parallel/ulysses.py``).

q, k and v enter sequence-sharded, (B, H, S/p, D) on each rank; one
all-to-all over the "seq" axis re-shards them on the head dim, (B, H/p, S,
D), so every rank sees the whole sequence for its heads and runs plain
attention (exact causal masking included) with no per-step
communication; a second all-to-all swaps the output back.  It needs the
heads to divide the axis; ring attention (``parallel/ring_attention.py``)
never forms the full S x S scores.
"""

from __future__ import annotations

from ..ops.attention import sdpa
from .collectives import all_to_all, relayout
from .mesh import PartitionSpec
from .ring_attention import _seq_spec


def ulysses_attention(q, k, v, axis_name: str = "seq",
                      causal: bool = False, *, mesh):
    """The per-rank body: q, k and v are this rank's (B, H, S/p, D)
    blocks along ``axis_name`` of ``mesh``."""
    nheads = q.shape[1]
    p = mesh.shape[axis_name]
    assert nheads % p == 0, (
        f"ulysses needs heads ({nheads}) divisible by the '{axis_name}' "
        f"axis size ({p})")

    def swap(x):  # seq-sharded -> head-sharded
        return all_to_all(x, mesh, (axis_name,), split_dim=1, concat_dim=2)

    o = sdpa(swap(q), swap(k), swap(v), causal=causal)
    # head-sharded -> seq-sharded
    return all_to_all(o, mesh, (axis_name,), split_dim=2, concat_dim=1)


def ulysses_attention_sharded(q, k, v, mesh, seq_axis: str = "seq",
                              causal: bool = False):
    """Global (B, H, S, D) tensors in and out, as
    ``ring_attention_sharded``."""
    spec = _seq_spec(mesh, seq_axis)
    blocks = [relayout(x, PartitionSpec(), spec, mesh) for x in (q, k, v)]
    out = ulysses_attention(*blocks, seq_axis, causal=causal, mesh=mesh)
    return relayout(out, spec, PartitionSpec(), mesh)
