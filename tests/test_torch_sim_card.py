"""The measured cost model on the CUDA card (``sim/cost_model.py``'s
measured mode): every op of a small unfused and fused DLRM timed through
one CUDA graph per call set, with no fallback to the analytic estimate.
The tests here need the card and skip without one; this file imports no
JAX, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sim_card.py -q
"""

import warnings

import pytest
import torch

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.ops.fused_interact_kernel import \
    fused_interact_cuda
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import row_update_cuda
from dlrm_flexflow_tpu_torch.sim import CostModel


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["off", "on"])
def test_measured_costs_on_the_card(fused):
    """Each op's measured forward and backward are positive and finite,
    with no fallback warning; the embedding op's backward launches the
    row-update kernel, the fused op's forward the fused forward kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the measured costs time the "
                    "port's kernels on the card")
    model = build_dlrm(
        DLRMConfig(sparse_feature_size=16, embedding_size=[500, 300, 200],
                   mlp_bot=[13, 32, 16], mlp_top=[64, 32, 1],
                   fused_interaction=fused),
        fft.FFConfig(batch_size=64))
    cm = CostModel(measure=True, measure_iters=4)
    b2, b3 = row_update_cuda.launches, fused_interact_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for op in model.layers:
            for parts in (1, 4):
                f, b = cm.op_times(op, parts)
                assert 0 < f < 1 and 0 < b < 1, (op.name, parts, f, b)
    assert row_update_cuda.launches > b2
    assert (fused_interact_cuda.launches > b3) == (fused == "on")
