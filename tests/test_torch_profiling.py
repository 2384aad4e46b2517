"""The port's profiling utilities (dlrm_flexflow_tpu_torch/profiling.py) and
its CLI's telemetry and table flags, on the CPU.

``Timer``, ``OpTimer`` and ``device_fence`` run on CPU tensors here (the
fence has nothing to wait for); ``trace`` writes a torch.profiler trace,
and ``parse_device_trace`` refuses one with no device events, which is
what a trace taken without a card holds: a device time comes only from a
run on the card.  The CLI flags parse as the JAX package's do.
"""

import os

import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.telemetry.schema import validate_event

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import profiling
from dlrm_flexflow_tpu_torch import telemetry as pt
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.serving import InferenceEngine

D = 8
TABLES = [20, 30]


def _model(**cfg):
    m = build_dlrm(DLRMConfig(sparse_feature_size=D, embedding_size=TABLES,
                              mlp_bot=[13, 16, D],
                              mlp_top=[D + len(TABLES) * D, 16, 1],
                              arch_interaction_op="cat",
                              fused_interaction="on"),
                   fft.FFConfig(batch_size=8, **cfg))
    m.compile(optimizer=fft.SGDOptimizer(0.01), metrics=("accuracy",))
    return m


def test_device_fence_and_timer_on_the_cpu():
    m = _model()
    state = m.init(seed=0, device="cpu")
    assert profiling.device_fence(state) is state
    assert profiling.device_fence({"a": [torch.ones(2)], "b": 3})["b"] == 3
    with profiling.Timer() as t:
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        profiling.Timer.fence(x)
    assert t.elapsed > 0


def test_op_timer_times_every_op_and_emits_op_time_events():
    m = _model()
    state = m.init(seed=0, device="cpu")
    timer = profiling.OpTimer(m, iters=2)
    with pt.event_log() as log:
        times = timer.profile(state, None)
    assert list(times) == [op.name for op in m.layers]
    for t in times.values():
        assert t["forward_s"] > 0 and t["backward_s"] >= 0
    events = log.events("op_time")
    assert [e["op"] for e in events] == list(times)
    for e in events:
        assert validate_event(e) == []
    report = timer.report(times)
    assert report.splitlines()[0].startswith("op")
    assert len(report.splitlines()) == len(times) + 1


def test_trace_writes_a_profile_without_device_time(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json.gz")
    with pytest.raises(ValueError, match="no device events"):
        profiling.parse_device_trace(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.parse_device_trace(str(tmp_path / "none"))


def test_cli_flags_parse_as_in_jax():
    argv = ["--embedding-dtype", "bfloat16", "--serve-quantize", "int8",
            "--metrics-port", "9123", "--profiling", "-b", "8"]
    got, want = fft.FFConfig.parse_args(argv), JaxFFConfig.parse_args(argv)
    for field in ("embedding_dtype", "serve_quantize", "metrics_port",
                  "profiling", "batch_size"):
        assert getattr(got, field) == getattr(want, field), field
    assert fft.FFConfig().metrics_port == JaxFFConfig().metrics_port == 0
    assert fft.FFConfig().profiling is JaxFFConfig().profiling is False


def test_cli_dtype_flags_reach_the_tables_and_the_engine():
    cfg = fft.FFConfig.parse_args(["--embedding-dtype", "bfloat16",
                                   "--serve-quantize", "int8"])
    m = _model(embedding_dtype=cfg.embedding_dtype,
               serve_quantize=cfg.serve_quantize, serve_buckets="1,8")
    state = m.init(seed=0, device="cpu")
    assert state.params["emb"]["embedding"].dtype == torch.bfloat16
    eng = InferenceEngine(m, state, device="cpu")
    assert eng.quantization["mode"] == "int8"
    assert eng.quantization["bytes_after"] < eng.quantization["bytes_before"]
    rng = np.random.default_rng(0)
    req = {"dense": rng.standard_normal((3, 13)).astype(np.float32),
           "sparse": np.zeros((3, len(TABLES), 1), np.int64)}
    assert np.isfinite(eng.predict(req)).all()
    with pytest.raises(ValueError, match="serve_quantize"):
        _model(serve_quantize="int4")
