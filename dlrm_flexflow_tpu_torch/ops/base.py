"""Operator base class for the graph-builder.

Counterpart of ``dlrm_flexflow_tpu/ops/base.py``.  An op is a graph node:
it declares its parameters (``ParameterSpec``) and computes ``forward``
as a plain function of a parameter dictionary and input tensors;
autograd differentiates it, except where an op brings its own backward
(``ops/fused_interact.py``).

Each op carries a ``parallel_config`` (``parallel/``), set from the
model's strategy at ``compile``, and the geometry the simulator reads:
``flops`` and ``input_rect`` (the JAX package's cost-model hooks), over
``part_coords`` and ``rect_of_part``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..tensor import ParameterSpec, Tensor

# A float32 matmul on the card (the fused interaction's plain versions)
# must run in full f32, as XLA runs it: TF32 keeps about three decimal
# digits.  Off is PyTorch's default; the port states it here so that
# nothing relies on the default.
torch.backends.cuda.matmul.allow_tf32 = False


def part_coords(pc, ndim: int, idx: int):
    """Decompose a flat part index into per-dim coordinates of the op's
    N-D part grid (dim 0 fastest, as the simulator walks the rects)."""
    dims = list(pc.dims) + [1] * (ndim - len(pc.dims))
    coords, rem = [], idx
    for d in range(ndim):
        coords.append(rem % dims[d])
        rem //= dims[d]
    return coords


def rect_of_part(pc, shape, idx: int):
    """The (lo, hi) sub-rectangle of a ``shape``-shaped tensor owned by
    part ``idx`` under ParallelConfig ``pc`` (the reference's N-D block
    partitioning, config.h:41-50)."""
    dims = list(pc.dims) + [1] * (len(shape) - len(pc.dims))
    coords = part_coords(pc, len(shape), idx)
    lo, hi = [], []
    for d in range(len(shape)):
        nd = max(dims[d], 1)
        sz = shape[d] // nd
        c = coords[d]
        lo.append(c * sz)
        hi.append((c + 1) * sz if c < nd - 1 else shape[d])
    return tuple(lo), tuple(hi)


class Op:
    """One graph node.  Subclasses set ``self.outputs`` in ``__init__``
    and implement ``forward``; ``params`` is the dict param_name ->
    tensor stored under ``self.name`` in the model's params."""

    op_type: str = "op"
    # the mesh the model was compiled with (compile sets it; None: one
    # device), read by the ops with manual collectives
    _mesh = None
    # whether the op may launch its hand-written kernels: compile clears
    # it under a mesh of more than one rank, as the JAX package compiles
    # with allow_kernel=mesh is None
    _allow_kernel = True

    def __init__(self, name: str, inputs: Sequence[Tensor]):
        self.name = name
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        # the op's SOAP config from the model's strategy (compile); None
        # means the data-parallel default
        self.parallel_config = None

    def _make_output(self, shape, dtype=torch.float32, idx: int = 0
                     ) -> Tensor:
        return Tensor(shape=shape, dtype=dtype, owner_op=self,
                      owner_idx=idx, name=f"{self.name}:out{idx}")

    def param_specs(self) -> List[ParameterSpec]:
        return []

    def init_params(self, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        return {spec.param_name: spec.initializer(generator, spec.shape,
                                                  spec.dtype)
                for spec in self.param_specs()}

    def forward(self, params: Dict[str, torch.Tensor],
                xs: List[torch.Tensor], *, training: bool = False,
                rng=None) -> List[torch.Tensor]:
        """The op's outputs from its parameters and inputs.  ``training``
        selects the training-mode behaviour of the ops that have one
        (dropout, batch norm); ``rng`` is the op's dropout key
        (``ops/softmax.py::dropout_keep``), None outside training.  Ops
        without such behaviour take both and ignore them."""
        raise NotImplementedError

    # ---- cost model hooks (sim/) -------------------------------------------
    def flops(self, batch: int) -> int:
        """Approximate forward FLOPs for the simulator's analytic costs."""
        return 0

    def input_rect(self, pc, input_idx: int, part_idx: int):
        """The (lo, hi) sub-rectangle of input ``input_idx`` that output
        part ``part_idx`` reads under output ParallelConfig ``pc``: the
        hook the simulator sizes its transfers with (reference
        simulator.cc:200-233).

        Default: a batch (dim 0) partition maps through when the input
        shares the output's batch extent; every other input dim is read
        in full (a channel-parallel Linear part holds a column shard of
        the weight but reads the whole input row)."""
        ishape = self.inputs[input_idx].shape
        oshape = self.outputs[0].shape
        lo, hi = [0] * len(ishape), list(ishape)
        nd0 = pc.dims[0] if pc.dims else 1
        if (nd0 > 1 and ishape and oshape and ishape[0] == oshape[0]):
            c = part_coords(pc, len(oshape), part_idx)[0]
            sz = ishape[0] // nd0
            lo[0] = c * sz
            hi[0] = (c + 1) * sz if c < nd0 - 1 else ishape[0]
        return tuple(lo), tuple(hi)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


def _identity(x):
    return x


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": torch.nn.functional.elu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "exp": torch.exp,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "identity": _identity,
}


def activation_fn(name: Optional[str]):
    if name is None or name in ("none", "linear"):
        return _identity
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]


def matmul(x, w, compute_dtype=None):
    """``x @ w`` over the last dim of ``x``, with an f32 result.

    ``compute_dtype='bfloat16'`` means what the JAX package's
    ``preferred_element_type=float32`` means: bf16 operands, at least f32
    accumulation, f32 output.  Each operand is rounded to bf16 first.
    (``torch.matmul`` on two bf16 tensors would round the result to
    bf16.)

    The product accumulates in f64 and rounds once to f32.  BLAS
    libraries (MKL on the CPU, cuBLAS on the card) pick their kernel,
    blocking and K split by the row count and alignment, so an f32 sum
    over the same row changes its last bits with the batch it rides in,
    and the serving engine's padding contract (the first n rows of a
    padded bucket equal the unpadded forward bit for bit) would break.  A
    product of two f32 values is exact in f64, and the f64 sums of one
    row in any order lie within a few f64 ulps of each other, far below
    the f32 rounding step, so every order rounds to the same f32 value
    (short of a sum landing within those few ulps of an f32 midpoint)."""
    if compute_dtype in ("bfloat16", torch.bfloat16):
        x = x.to(torch.bfloat16)
        w = w.to(torch.bfloat16)
    return torch.matmul(x.double(), w.double()).float()
