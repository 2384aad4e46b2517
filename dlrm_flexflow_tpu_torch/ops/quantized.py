"""Row-quantized embedding tables for serving (counterpart of
``dlrm_flexflow_tpu/ops/quantized.py``).

Training keeps its tables; at ``InferenceEngine`` load the tables of a
COPY of the params can be re-encoded to cut their bytes on the card:

* ``int8``: symmetric per-row quantization, int8 codes plus one f32 scale
  per logical row (``scale = max|row| / 127``); the forward dequantizes
  only the gathered rows (``codes * scale``), so the table stays a quarter
  of its f32 size.
* ``bf16``: bf16 rows, no scale.

The math is the JAX package's numpy math (``quantize_table``,
``quantized.py:42-65``), done in torch on the table's device: the
division is a true division by a tensor (not ATen's reciprocal multiply
by a Python number) and ``torch.round`` rounds half to even like
``np.rint``, so the codes and scales are bit-identical to the JAX
package's on any device.  Quantized outputs are held to the f32 engine
at a tolerance (``INT8_ATOL``, ``BF16_ATOL``), never bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

QUANT_MODES = ("off", "int8", "bf16")

#: params key of the per-row f32 scale column beside the int8 codes in
#: "embedding"; an injected sidecar like "rows__", never a parameter spec
QSCALE_KEY = "qscale__"

#: the absolute tolerance the JAX package pins quantized serving to, on
#: the sigmoid outputs of the DLRM against the f32 engine
#: (``scripts/check_kernels.py:16-18``)
INT8_ATOL = 1e-2
BF16_ATOL = 1e-2


def quantize_table(table: torch.Tensor, mode: str, logical_dim: int
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One table, ``(R, d)`` or stacked ``(T, R, d)``, quantized on its
    device -> ``(stored, scale or None)``.  ``stored`` keeps the table's
    shape; the scale is ``(R_logical, 1)`` f32, indexed by the flat
    logical row ids every gather uses (``flat_ids``)."""
    if mode == "bf16":
        return table.to(torch.bfloat16), None
    if mode != "int8":
        raise ValueError(f"unknown quantize mode {mode!r} "
                         f"(have {QUANT_MODES})")
    arr = table.float()
    logical = arr.reshape(-1, logical_dim)
    amax = logical.abs().amax(dim=1, keepdim=True)
    big = torch.full((), 127.0, dtype=torch.float32, device=arr.device)
    scale = torch.where(amax > 0.0, amax / big, torch.ones_like(amax))
    codes = torch.round(logical / scale).to(torch.int8)
    return codes.reshape(arr.shape), scale


def dequant_rows(rows: torch.Tensor, qscale: torch.Tensor,
                 gids: torch.Tensor) -> torch.Tensor:
    """Gathered int8 codes ``(..., d)`` at flat logical ids ``gids``
    ``(...)`` -> f32 rows: the codes as f32 times ``qscale[gids]``, the
    scale read with ``jnp.take``'s rule (an id past the table reads NaN)."""
    from .embedding import take_rows
    return rows.float() * take_rows(qscale, gids)


def quantize_embedding_params(layers, params: Dict[str, dict], mode: str
                              ) -> Tuple[Dict[str, dict], dict]:
    """Quantize every table of a params tree: a new tree whose ops with an
    ``"embedding"`` param hold the stored table (and the int8 scale under
    ``QSCALE_KEY``); ``params`` and its tensors are left as they were.
    Returns ``(new_params, report)``, the report with the JAX package's
    keys: the mode, per-table and total bytes before and after."""
    if mode in (None, "", "off"):
        return params, {"mode": "off", "tables": {},
                        "bytes_before": 0, "bytes_after": 0}
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r} "
                         f"(have {QUANT_MODES})")
    out = dict(params)
    tables = {}
    before = after = 0
    for op in layers:
        p = params.get(op.name)
        if not isinstance(p, dict) or "embedding" not in p:
            continue
        d = int(getattr(op, "out_dim", 0))
        if d <= 0:
            continue
        table = p["embedding"]
        with torch.no_grad():
            stored, scale = quantize_table(table, mode, d)
        q = dict(p)
        q["embedding"] = stored
        nb_before = table.numel() * table.element_size()
        nb_after = stored.numel() * stored.element_size()
        if scale is not None:
            q[QSCALE_KEY] = scale
            nb_after += scale.numel() * 4
        out[op.name] = q
        tables[op.name] = {"bytes_before": int(nb_before),
                           "bytes_after": int(nb_after)}
        before += nb_before
        after += nb_after
    return out, {"mode": mode, "tables": tables,
                 "bytes_before": int(before), "bytes_after": int(after)}
