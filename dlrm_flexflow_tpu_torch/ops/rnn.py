"""The LSTM operator, for NMT (counterpart of ``dlrm_flexflow_tpu/ops/rnn.py``;
reference nmt/lstm.cu).

The input projection of every timestep is one product hoisted out of the
time loop, as the JAX op hoists it out of its scan; the recurrence is a
Python loop of ``_gate_math`` steps (gate order i, f, g, o; the carry
always f32).  Both products are ``ops/base.py::matmul``'s: bf16 operands
under bf16 compute, f64 accumulation, one rounding to f32.  The
recurrent weight is cast once, outside the loop.

Gradients are autograd's over the loop.  The JAX op's hand-written
backward (``_lstm_core``) exists for XLA's fusion limits and computes the
same function; the tests hold the port against it and against JAX's
autodiff of the scan.  On the card a whole training step, loop included,
is captured as one CUDA graph, so the loop's launches are paid once at
capture.
"""

from __future__ import annotations

import torch

from ..initializers import DEFAULT_KERNEL_INIT, ZeroInitializer
from ..tensor import ParameterSpec
from .base import Op, matmul


def _recurrent_weight(wh, compute_dtype):
    """``wh`` as the recurrent product's f64 operand, cast once."""
    if compute_dtype in ("bfloat16", torch.bfloat16):
        wh = wh.to(torch.bfloat16)
    return wh.double()


def _gate_math(carry, xp, wh64, compute_dtype):
    """One timestep: ``xp`` is the step's projected input (bias
    included), ``wh64`` the recurrent weight from ``_recurrent_weight``;
    returns the new ``(h, c)``."""
    h, c = carry
    hx = h.to(torch.bfloat16) if compute_dtype in (
        "bfloat16", torch.bfloat16) else h
    gates = xp + torch.matmul(hx.double(), wh64).float()
    i_g, f_g, g_g, o_g = torch.chunk(gates, 4, dim=-1)
    i_g = torch.sigmoid(i_g)
    f_g = torch.sigmoid(f_g)
    g_g = torch.tanh(g_g)
    o_g = torch.sigmoid(o_g)
    c_new = f_g * c + i_g * g_g
    h_new = o_g * torch.tanh(c_new)
    return h_new, c_new


class LSTM(Op):
    """Single-layer LSTM: (B, T, I) -> (B, T, H), or (B, H) without
    ``return_sequences``; ``return_state`` adds the final h and c as two
    more outputs; ``initial_state`` (h0, c0) are two more inputs
    (zeros without them, as in the reference)."""

    op_type = "LSTM"

    def __init__(self, name, input_tensor, hidden_dim: int,
                 return_sequences: bool = True, reverse: bool = False,
                 kernel_initializer=None, initial_state=None,
                 return_state: bool = False, compute_dtype=None):
        inputs = [input_tensor]
        if initial_state is not None:
            h0, c0 = initial_state
            inputs += [h0, c0]
        super().__init__(name, inputs)
        self.compute_dtype = compute_dtype
        b, t, i = input_tensor.shape
        self.hidden_dim = int(hidden_dim)
        self.input_dim = i
        self.seq_len = t
        self.return_sequences = return_sequences
        self.return_state = return_state
        self.has_initial_state = initial_state is not None
        self.reverse = reverse
        self.kernel_initializer = kernel_initializer or DEFAULT_KERNEL_INIT
        out_shape = ((b, t, hidden_dim) if return_sequences
                     else (b, hidden_dim))
        self.outputs = [self._make_output(out_shape, input_tensor.dtype)]
        if return_state:
            for idx in (1, 2):
                self.outputs.append(self._make_output(
                    (b, hidden_dim), input_tensor.dtype, idx=idx))

    def param_specs(self):
        h, i = self.hidden_dim, self.input_dim
        # gate order (i, f, g, o), concatenated for one product
        return [
            ParameterSpec(self.name, "wx", (i, 4 * h),
                          initializer=self.kernel_initializer, sharded_dim=1),
            ParameterSpec(self.name, "wh", (h, 4 * h),
                          initializer=self.kernel_initializer, sharded_dim=1),
            ParameterSpec(self.name, "bias", (4 * h,),
                          initializer=ZeroInitializer(), sharded_dim=0),
        ]

    def forward(self, params, xs, *, training=False, rng=None):
        x = xs[0]
        if self.reverse:
            x = torch.flip(x, dims=(1,))
        # time-major before the hoisted projection: (T, B, 4H)
        x_proj = matmul(x.transpose(0, 1), params["wx"],
                        self.compute_dtype) + params["bias"]
        wh64 = _recurrent_weight(params["wh"], self.compute_dtype)
        b = x.shape[0]
        if self.has_initial_state:
            # the carry is f32 whatever the state's dtype
            h, c = xs[1].float(), xs[2].float()
        else:
            h = torch.zeros((b, self.hidden_dim), dtype=torch.float32,
                            device=x.device)
            c = torch.zeros_like(h)
        hs = []
        for t in range(x_proj.shape[0]):
            h, c = _gate_math((h, c), x_proj[t], wh64, self.compute_dtype)
            hs.append(h)
        seq = torch.stack(hs, dim=1)  # (B, T, H)
        if self.reverse:
            seq = torch.flip(seq, dims=(1,))
        dt = self.outputs[0].dtype
        out = (seq if self.return_sequences else seq[:, -1]).to(dt)
        if self.return_state:
            return [out, h.to(dt), c.to(dt)]
        return [out]

    def flops(self, batch):
        t, i, h = self.seq_len, self.input_dim, self.hidden_dim
        return 2 * batch * t * (i * 4 * h + h * 4 * h)
