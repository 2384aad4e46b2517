"""SOAP parallelization strategies (counterpart of
``dlrm_flexflow_tpu/parallel/parallel_config.py``; reference:
include/config.h:41-50 ``ParallelConfig`` {device_type, nDims, dim[],
device_ids[]}; src/runtime/strategy.proto:5-23 the serialized schema;
src/runtime/strategy.cc:28-94 the data-parallel fallback, :96-172
load and save).

``dims`` is batch-first, as the tensor shapes are; the reference's dim[]
is innermost-first with the sample dim last (``from_reference_dims``
converts).  ``device_ids`` routes each part to a device.

``device_type`` keeps the file format's two values: ``"tpu"`` means the
accelerator (here the CUDA card) and ``"cpu"`` host memory.  They stay as
they are so that strategy files move between the two packages unchanged
(``.json`` and the reference's ``.pb`` both).

The port honours a strategy on one device only (``FFModel.compile``): a
mesh that would execute a partitioned config comes with the scale-out
slice (ROADMAP.md item 8).  The simulator and the search
(``sim/``) read every field.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: ``"tpu"`` is the accelerator (the file format's name for it), ``"cpu"``
#: host memory
DEVICE_TYPES = ("tpu", "cpu")


@dataclass
class ParallelConfig:
    """Per-op N-D output partitioning (reference config.h:41-50)."""

    dims: Tuple[int, ...] = (1,)
    device_type: str = "tpu"
    device_ids: Optional[List[int]] = None

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        assert self.device_type in DEVICE_TYPES

    @property
    def num_parts(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @staticmethod
    def data_parallel(ndim: int, num_devices: int) -> "ParallelConfig":
        """Partition the sample (first) dim over all devices — the
        reference default (``Op::get_data_parallel_config``,
        model.cc:282-293, which splits the LAST Legion dim = sample)."""
        dims = (num_devices,) + (1,) * (ndim - 1)
        return ParallelConfig(dims=dims, device_ids=list(range(num_devices)))

    @staticmethod
    def from_reference_dims(ref_dims: Sequence[int], **kw) -> "ParallelConfig":
        """Convert a reference innermost-first dim[] (sample last) to
        batch-first order."""
        return ParallelConfig(dims=tuple(reversed(list(ref_dims))), **kw)

    def to_json(self) -> dict:
        return {"dims": list(self.dims), "device_type": self.device_type,
                "device_ids": self.device_ids}

    @staticmethod
    def from_json(d: dict) -> "ParallelConfig":
        return ParallelConfig(dims=tuple(d["dims"]),
                              device_type=d.get("device_type", "tpu"),
                              device_ids=d.get("device_ids"))


@dataclass
class Strategy:
    """A full model strategy: op name -> ParallelConfig
    (reference: map<MappingTagID, ParallelConfig> keyed by hashed op name,
    strategy.cc:96-135)."""

    configs: Dict[str, ParallelConfig] = field(default_factory=dict)

    def find(self, op_name: str, ndim: int,
             num_devices: int) -> ParallelConfig:
        """Lookup with default-DP fallback (reference
        FFConfig::find_parallel_config, strategy.cc:28-94)."""
        if op_name in self.configs:
            return self.configs[op_name]
        return ParallelConfig.data_parallel(ndim, num_devices)

    def __setitem__(self, k, v):
        self.configs[k] = v

    def __getitem__(self, k):
        return self.configs[k]

    def __contains__(self, k):
        return k in self.configs

    # ---- serialization (JSON superset of strategy.proto's fields; ``.pb``
    # paths use the reference-compatible proto2 wire format) -----------------
    def save(self, path: str):
        """reference save_strategies_to_file (strategy.cc:137-172)."""
        if path.endswith(".pb"):
            from .strategy_pb import save_strategy_pb

            save_strategy_pb(path, self)
            return
        data = {"ops": [{"name": k, **v.to_json()}
                        for k, v in sorted(self.configs.items())]}
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    @staticmethod
    def load(path: str) -> "Strategy":
        """reference load_strategies_from_file (strategy.cc:96-135)."""
        if path.endswith(".pb"):
            from .strategy_pb import load_strategy_pb

            return load_strategy_pb(path)
        with open(path) as f:
            data = json.load(f)
        if data.get("kind") == "strategy" and "strategy" in data:
            # a search-tune strategy artifact nests the op list under
            # provenance: accepted through the artifact validator, so an
            # unknown schema version or a doctored artifact is refused,
            # never misread
            from ..sim.tune import validate_strategy_artifact

            errs = validate_strategy_artifact(data)
            if errs:
                raise ValueError(f"{path}: invalid strategy artifact: "
                                 + "; ".join(errs))
            data = data["strategy"]
        s = Strategy()
        for op in data["ops"]:
            s.configs[op["name"]] = ParallelConfig.from_json(op)
        return s
