"""Multi-head attention (counterpart of ``dlrm_flexflow_tpu/ops/attention.py``;
the reference has no attention op).

``sdpa`` is the plain computation the JAX op runs on one device: the
logits product, an f32 softmax and the value product, each product
``ops/base.py::matmul``'s (f64 accumulation, one rounding to f32).  No
Pallas kernel stands behind it in the JAX package, and
``F.scaled_dot_product_attention``'s fused paths would sum in another
order.

``seq_parallel=True`` runs the core as ring attention
(``parallel/ring_attention.py``) when the model is compiled under a mesh
with a ``"seq"`` axis of more than one rank: the executor
(``parallel/spmd.py``) hands the forward each rank's sequence block of
q, k and v, and the K/V blocks travel around the ranks of ``"seq"``.
Without such a mesh the op computes plain ``sdpa``, as the JAX op does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..initializers import DEFAULT_KERNEL_INIT
from ..tensor import ParameterSpec
from .base import Op, matmul


def sdpa(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Scaled dot-product attention, (B, H, S, D) layout."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return matmul(probs, v).to(q.dtype)


class MultiHeadAttention(Op):
    """Self or cross attention: (B, S, E) query, key and value inputs ->
    (B, S, E)."""

    op_type = "MultiHeadAttention"

    def __init__(self, name, query, key, value, embed_dim: int, num_heads: int,
                 causal: bool = False, kernel_initializer=None,
                 seq_parallel: bool = False, compute_dtype=None):
        super().__init__(name, [query, key, value])
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.seq_parallel = seq_parallel
        self.compute_dtype = compute_dtype
        self.kernel_initializer = kernel_initializer or DEFAULT_KERNEL_INIT
        b, s, _ = query.shape
        self.outputs = [self._make_output((b, s, embed_dim), query.dtype)]

    def param_specs(self):
        e = self.embed_dim
        qdim = self.inputs[0].shape[-1]
        kdim = self.inputs[1].shape[-1]
        vdim = self.inputs[2].shape[-1]
        init = self.kernel_initializer
        return [
            ParameterSpec(self.name, "wq", (qdim, e), initializer=init,
                          sharded_dim=1),
            ParameterSpec(self.name, "wk", (kdim, e), initializer=init,
                          sharded_dim=1),
            ParameterSpec(self.name, "wv", (vdim, e), initializer=init,
                          sharded_dim=1),
            ParameterSpec(self.name, "wo", (e, e), initializer=init,
                          sharded_dim=0),
        ]

    def forward(self, params, xs, *, training=False, rng=None):
        q_in, k_in, v_in = xs
        cd = self.compute_dtype
        b, s, _ = q_in.shape
        h, d = self.num_heads, self.head_dim

        def heads(x, w):
            y = matmul(x, w, cd).reshape(b, -1, h, d).permute(0, 2, 1, 3)
            return y.to(torch.bfloat16) if cd in (
                "bfloat16", torch.bfloat16) else y

        q = heads(q_in, params["wq"])
        k = heads(k_in, params["wk"])
        v = heads(v_in, params["wv"])
        mesh = self._mesh
        if (self.seq_parallel and mesh is not None
                and mesh.shape.get("seq", 1) > 1):
            from ..parallel.ring_attention import ring_attention
            o = ring_attention(q, k, v, "seq", causal=self.causal,
                               mesh=mesh)
        else:
            o = sdpa(q, k, v, causal=self.causal)  # (b, h, s, d)
        o = o.permute(0, 2, 1, 3).reshape(b, s, self.embed_dim)
        return [matmul(o, params["wo"], cd).to(self.outputs[0].dtype)]

    def flops(self, batch):
        s = self.inputs[0].shape[1]
        e = self.embed_dim
        # 4 projections + 2 attention products
        return batch * (4 * 2 * s * e * e + 2 * 2 * s * s * e)
