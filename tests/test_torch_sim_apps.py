"""The SOAP core on the five other apps (AlexNet, ResNet, Inception-v3,
Candle-Uno, NMT): the op geometry of the new ops (FLOPs, parameters, the
candidate configs and the input rectangle of every part), the analytic
op costs and the simulated steps, and the sim CLI's strategy file,
against the JAX package's on the CPU, bit for bit.  JAX is imported here
only.  tests/test_torch_sim.py holds the DLRM graphs the same way.

The geometry walks every config at 1, 2, 4 and 8 devices on the small
graphs (AlexNet at 67, ResNet 1/1/1/1 at 64, narrow Candle-Uno, a small
NMT) and on Inception-v3 at 299 (its only size).  The CLI runs at the
apps' full sizes.
"""

import dataclasses
import functools

import pytest

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import apps as japps
from dlrm_flexflow_tpu.sim import __main__ as jcli
from dlrm_flexflow_tpu.sim import cost_model as jcm
from dlrm_flexflow_tpu.sim import search as jsearch
from dlrm_flexflow_tpu.sim import simulator as jsim

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import apps as papps
from dlrm_flexflow_tpu_torch.sim import __main__ as pcli
from dlrm_flexflow_tpu_torch.sim import cost_model as pcm
from dlrm_flexflow_tpu_torch.sim import search as psearch
from dlrm_flexflow_tpu_torch.sim import simulator as psim

APPS = ["alexnet", "resnet", "inception", "candle_uno", "nmt"]


def _small(a, f, app):
    if app == "alexnet":
        return a.build_alexnet(f(batch_size=8), image_size=67)
    if app == "resnet":
        return a.build_resnet(f(batch_size=8), image_size=64,
                              stages=(1, 1, 1, 1))
    if app == "inception":
        return a.build_inception(f(batch_size=8))
    if app == "candle_uno":
        cfg = a.CandleConfig(dense_layers=[64, 64], dense_feature_layers=[64],
                             feature_shapes={"dose": 1, "cell.rnaseq": 50,
                                             "drug.descriptors": 80,
                                             "drug.fingerprints": 100})
        return a.build_candle_uno(cfg, f(batch_size=8))
    return a.build_nmt(a.NMTConfig(vocab_size=64, embed_size=16,
                                   hidden_size=12, src_len=6, tgt_len=5),
                       f(batch_size=8))


@functools.lru_cache(maxsize=None)
def _pair(app):
    j, p = _small(japps, ffj.FFConfig, app), _small(papps, fft.FFConfig, app)
    assert [(o.name, o.op_type) for o in p.layers] == \
        [(o.name, o.op_type) for o in j.layers]
    return j, p


def _pc(pc):
    return (tuple(pc.dims), pc.device_type,
            None if pc.device_ids is None else list(pc.device_ids))


def _machines():
    j = jcm.TPUMachineModel()
    p = pcm.H100MachineModel(
        name=j.name, peak_flops_bf16=j.peak_flops_bf16,
        peak_flops_f32=j.peak_flops_f32, hbm_bandwidth=j.hbm_bandwidth,
        hbm_bytes=j.hbm_bytes, nvlink_bandwidth=j.ici_bandwidth,
        nvlink_links_per_gpu=j.ici_links_per_chip,
        ib_bandwidth=j.dcn_bandwidth,
        kernel_launch_overhead=j.kernel_launch_overhead)
    return j, p


@pytest.mark.parametrize("app", APPS)
def test_op_geometry_matches_jax(app):
    """FLOPs, parameter shapes, the candidate configs and the input
    rectangle of every part of every config, every op and input."""
    j, p = _pair(app)
    for jo, po in zip(j.layers, p.layers):
        for b in (1, 8):
            assert po.flops(b) == jo.flops(b), po.name
        assert [(s.param_name, tuple(s.shape)) for s in po.param_specs()] \
            == [(s.param_name, tuple(s.shape)) for s in jo.param_specs()]
        for n in (1, 2, 4, 8):
            jc = jsearch.legal_configs(jo, n)
            assert [_pc(c) for c in psearch.legal_configs(po, n)] == \
                [_pc(c) for c in jc], (po.name, n)
            for c in jc:
                for part in range(c.num_parts):
                    for i in range(len(po.inputs)):
                        assert po.input_rect(c, i, part) == \
                            jo.input_rect(c, i, part), (po.name, c, i)


@pytest.mark.parametrize("app", APPS)
def test_analytic_costs_and_simulation_are_bit_equal(app):
    """Every op's analytic (forward, backward) at 1-8 parts, and the
    simulated data-parallel step at 4 and 8 devices, under the JAX
    machine's constants: equal to the bit."""
    j, p = _pair(app)
    jm, pm = _machines()
    jc, pc = jcm.CostModel(machine=jm), pcm.CostModel(machine=pm)
    for jo, po in zip(j.layers, p.layers):
        for parts in (1, 2, 4, 8):
            assert pc.op_times(po, parts) == jc.op_times(jo, parts), po.name
    for n in (4, 8):
        js = jsim.Simulator(j, n, jc)
        ps = psim.Simulator(p, n, pc)
        assert ps.simulate(psearch.data_parallel_strategy(p, n)) == \
            js.simulate(jsearch.data_parallel_strategy(j, n))


def _jax_valued_machine_class():
    _, pm = _machines()
    return dataclasses.make_dataclass(
        "H100MachineModel",
        [(f.name, f.type, dataclasses.field(default=getattr(pm, f.name)))
         for f in dataclasses.fields(pm) if f.name != "topology"],
        bases=(pcm.H100MachineModel,))


@pytest.mark.parametrize("app", APPS)
def test_sim_cli_writes_the_jax_file(app, tmp_path, monkeypatch):
    """``python -m dlrm_flexflow_tpu_torch.sim --app <app>`` at the app's
    full size, 4 devices, the Python search: the JAX CLI's file byte for
    byte under the JAX machine's values."""
    argv = ["--app", app, "--devices", "4", "--budget", "30",
            "--backend", "python"]
    assert jcli.main(argv + ["--export", str(tmp_path / "j.json")]) == 0
    with monkeypatch.context() as m:
        m.setattr(pcm, "H100MachineModel", _jax_valued_machine_class())
        assert pcli.main(argv + ["--export", str(tmp_path / "p.json")]) == 0
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
