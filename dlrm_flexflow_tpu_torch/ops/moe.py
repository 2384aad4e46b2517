"""Mixture of experts (counterpart of ``dlrm_flexflow_tpu/ops/moe.py``;
the reference has no expert routing).

Dense dispatch, as in the JAX op: every expert runs every token, and the
outputs are combined by the router's gates, kept for the top ``top_k``
by ``gates >= k-th largest`` (ties included) and renormalised.  The
products are ``ops/base.py::matmul``'s (f64 accumulation, one rounding).

Expert parallelism, as in the JAX op: a strategy that partitions a
non-batch dim of this op's output shards the expert axis of its weights
over the mesh's ``"model"`` axis (``sharded_dim=0``), and
``output_pspec`` keeps the combined output data-sharded or replicated.
Under a mesh each model rank runs its own experts and the gate-weighted
sums are added over ``"model"`` (``parallel/spmd.py``).
"""

from __future__ import annotations

import torch

from ..initializers import DEFAULT_KERNEL_INIT, ZeroInitializer
from ..tensor import ParameterSpec
from .base import Op, activation_fn, matmul


class MixtureOfExperts(Op):
    """(..., d) -> (..., d) with E gated expert MLPs (d -> hidden -> d).
    The forward leaves the load-balancing loss of its gates in
    ``_last_aux_loss``, as the JAX op does."""

    op_type = "MixtureOfExperts"

    def __init__(self, name, input_tensor, num_experts: int, hidden_dim: int,
                 top_k: int = 2, activation: str = "relu",
                 kernel_initializer=None):
        super().__init__(name, [input_tensor])
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} outside [1, {num_experts}]")
        self.num_experts = int(num_experts)
        self.hidden_dim = int(hidden_dim)
        self.top_k = int(top_k)
        self.activation = activation
        self.model_dim = input_tensor.shape[-1]
        self.kernel_initializer = kernel_initializer or DEFAULT_KERNEL_INIT
        self._last_aux_loss = None
        self.outputs = [self._make_output(input_tensor.shape,
                                          input_tensor.dtype)]

    def param_specs(self):
        e, d, h = self.num_experts, self.model_dim, self.hidden_dim
        init = self.kernel_initializer
        return [
            ParameterSpec(self.name, "router", (d, e), initializer=init),
            ParameterSpec(self.name, "w_in", (e, d, h), initializer=init,
                          sharded_dim=0),
            ParameterSpec(self.name, "b_in", (e, h),
                          initializer=ZeroInitializer(), sharded_dim=0),
            ParameterSpec(self.name, "w_out", (e, h, d), initializer=init,
                          sharded_dim=0),
            ParameterSpec(self.name, "b_out", (e, d),
                          initializer=ZeroInitializer(), sharded_dim=0),
        ]

    def _gates(self, xf, router):
        """The (N, E) gates: the router's softmax, kept for the top
        ``top_k`` (ties included) and renormalised."""
        gates = torch.softmax(matmul(xf, router), dim=-1)
        if self.top_k < self.num_experts:
            thresh = torch.topk(gates, self.top_k, dim=-1).values[:, -1:]
            masked = torch.where(gates >= thresh, gates,
                                 torch.zeros((), dtype=gates.dtype,
                                             device=gates.device))
            gates = masked / masked.sum(dim=-1, keepdim=True)
        return gates

    def _expert_sum(self, xf, gates, params):
        """The (N, d) gate-weighted sum, in f64, of the experts in
        ``params`` (every expert, or one rank's block of them with its
        columns of ``gates``)."""
        h = matmul(xf[None], params["w_in"]) + params["b_in"][:, None]
        h = activation_fn(self.activation)(h)             # (E, N, h)
        y = matmul(h, params["w_out"]) + params["b_out"][:, None]
        return torch.einsum("end,ne->nd", y.double(), gates.double())

    def forward(self, params, xs, *, training=False, rng=None):
        (x,) = xs
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])                   # (N, d)
        gates = self._gates(xf, params["router"])
        out = self._expert_sum(xf, gates, params).float()
        self._last_aux_loss = self._load_balance_loss(gates)
        return [out.reshape(lead + (x.shape[-1],)).to(self.outputs[0].dtype)]

    def output_pspec(self, pc, mesh):
        """The expert axis lives in the weights, not the output: a
        non-batch partition in this op's config means expert parallelism,
        and the combined output stays data-sharded or replicated."""
        from ..parallel.mesh import DATA_AXIS, PartitionSpec
        axes = [None] * self.outputs[0].ndim
        if pc.dims and pc.dims[0] > 1 and DATA_AXIS in mesh.axis_names:
            axes[0] = DATA_AXIS
        return PartitionSpec(*axes)

    @staticmethod
    def _load_balance_loss(gates):
        """The importance loss: the mean squared coefficient of variation
        of the per-expert gate mass."""
        importance = gates.reshape(-1, gates.shape[-1]).sum(dim=0)
        mean = importance.mean()
        return ((importance / (mean + 1e-9) - 1.0) ** 2).mean()

    def flops(self, batch):
        e, d, h = self.num_experts, self.model_dim, self.hidden_dim
        return 2 * batch * e * (d * h + h * d) + 2 * batch * d * e
