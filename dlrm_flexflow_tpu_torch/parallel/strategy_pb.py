"""Reference-compatible protobuf strategy files (a copy of
``dlrm_flexflow_tpu/parallel/strategy_pb.py``, which is pure Python; the
two write the same bytes).

The reference serializes strategies with proto2 (reference:
src/runtime/strategy.proto:5-23 — message Op {required string name = 1;
required DeviceType device_type = 2; repeated int32 dims = 3; repeated
int32 device_ids = 4; repeated MemoryType memory_types = 5}; message
Strategy {repeated Op ops = 1}; load/save strategy.cc:96-172).

This module reads/writes that exact wire format with a hand-rolled codec
(the schema is 5 fields; no protoc needed), so strategies exported by the
reference's generators (dlrm_strategy*.cc, prebuilt
dlrm_strategy_{8,16}embs_{8,16}gpus.pb) import directly, and strategies
searched here can be inspected with the reference tooling.

Note the dim-order conversion: reference dims are innermost-first with the
sample dim LAST; ours are batch-first (ParallelConfig.from_reference_dims).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from .parallel_config import ParallelConfig, Strategy

_WT_VARINT = 0
_WT_LEN = 2


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _tag(field: int, wt: int) -> bytes:
    return _encode_varint((field << 3) | wt)


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _decode_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            val, pos = _decode_varint(buf, pos)
        elif wt == _WT_LEN:
            ln, pos = _decode_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == 1:  # 64-bit
            val = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _decode_op(buf: bytes) -> Tuple[str, ParallelConfig]:
    name = ""
    device_type = 0
    dims: List[int] = []
    device_ids: List[int] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            device_type = val
        elif field == 3:
            if wt == _WT_LEN:  # packed
                p = 0
                while p < len(val):
                    v, p = _decode_varint(val, p)
                    dims.append(v)
            else:
                dims.append(val)
        elif field == 4:
            if wt == _WT_LEN:
                p = 0
                while p < len(val):
                    v, p = _decode_varint(val, p)
                    device_ids.append(v)
            else:
                device_ids.append(val)
        # field 5 memory_types: accepted, ignored (device memory only)
    pc = ParallelConfig.from_reference_dims(
        dims, device_type="cpu" if device_type == 1 else "tpu",
        device_ids=device_ids or None)
    return name, pc


def load_strategy_pb(path: str) -> Strategy:
    """reference FFConfig::load_strategies_from_file (strategy.cc:96-135)."""
    with open(path, "rb") as f:
        buf = f.read()
    s = Strategy()
    for field, wt, val in _iter_fields(buf):
        if field == 1 and wt == _WT_LEN:
            name, pc = _decode_op(val)
            s.configs[name] = pc
    return s


def _encode_op(name: str, pc: ParallelConfig) -> bytes:
    out = bytearray()
    nb = name.encode()
    out += _tag(1, _WT_LEN) + _encode_varint(len(nb)) + nb
    out += _tag(2, _WT_VARINT) + _encode_varint(
        1 if pc.device_type == "cpu" else 0)
    # reference writes dims innermost-first (sample last): reverse ours.
    for d in reversed(pc.dims):
        out += _tag(3, _WT_VARINT) + _encode_varint(d)
    for d in (pc.device_ids or []):
        out += _tag(4, _WT_VARINT) + _encode_varint(d)
    return bytes(out)


def save_strategy_pb(path: str, strategy: Strategy):
    """reference save_strategies_to_file (strategy.cc:137-172)."""
    out = bytearray()
    for name, pc in sorted(strategy.configs.items()):
        op = _encode_op(name, pc)
        out += _tag(1, _WT_LEN) + _encode_varint(len(op)) + op
    with open(path, "wb") as f:
        f.write(bytes(out))


# --------------------------------------------------------------------------
# DLRM strategy generators (reference src/runtime/dlrm_strategy.cc:242-296,
# dlrm_strategy_hetero.cc): embeddings placed one-table-per-device
# round-robin, MLPs data-parallel over all devices.
# --------------------------------------------------------------------------

def dlrm_strategy(num_tables: int, num_devices: int,
                  hetero_cpu_embeddings: bool = False,
                  stacked: bool = True) -> Strategy:
    """Build the reference's hybrid DLRM strategy.

    ``stacked=True`` targets the fused StackedEmbedding op ("emb"): the
    table axis of its (B, T, d) output is sharded over the devices.
    ``stacked=False`` emits per-table configs "emb_<i>" pinned round-robin
    (dims {1,1} one part on one device — dlrm_strategy.cc:251-256).
    """
    s = Strategy()
    dt = "cpu" if hetero_cpu_embeddings else "tpu"
    if stacked:
        shards = min(num_tables, num_devices)
        s["emb"] = ParallelConfig(dims=(1, shards, 1), device_type=dt,
                                  device_ids=list(range(shards)))
    else:
        for i in range(num_tables):
            s[f"emb_{i}"] = ParallelConfig(
                dims=(1, 1), device_type=dt,
                device_ids=[i % num_devices])
    # MLP layers data-parallel over all devices happens via default-DP
    # fallback (strategy.cc:28-94) — nothing to emit, matching the
    # reference generator's explicit DP entries semantically.
    return s
