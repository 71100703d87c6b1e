"""The port's serving core (hydragnn_tpu_torch/serving) and
`run_prediction` on the CPU, plus the package's import boundary: it and
chip_smoke.py load neither jax nor the JAX package.

The energy-force engine (`ef_forward=True`, LJ SchNet at its published
widths) is held against the JAX package's EF engine on the same requests
and weights: energies and forces within rtol 1e-4 / atol 1e-5, the
bound of the forward parity tests (tests/test_torch_schnet.py); the
forces are a backward through the same ops, summed in other orders.
"""
import ast
import copy
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu_torch import run_prediction
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                 synthetic_molecules)
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.serving.config import resolve_serving
from hydragnn_tpu_torch.serving.engine import InferenceEngine
from hydragnn_tpu_torch.utils.weights import load_jax_variables

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them (8
# threads per worker made these tests 30x slower under pytest-xdist).
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSCE = REPO / "examples" / "csce" / "csce_gap.json"


def _small_config():
    with open(CSCE) as f:
        cfg = json.load(f)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=16, num_conv_layers=2)
    arch["output_heads"]["graph"].update(dim_sharedlayers=8,
                                         dim_headlayers=[8, 8])
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 8
    return cfg


@pytest.fixture(scope="module")
def served():
    """A small PNA (csce config at width 16) with Flax-initialized weights,
    and its data split."""
    samples = synthetic_molecules(30, seed=9, min_atoms=3, max_atoms=15)
    splits = (samples[:18], samples[18:22], samples[22:])
    jsamples = [jbatch.GraphSample(x=s.x, pos=s.pos, senders=s.senders,
                                   receivers=s.receivers, y_graph=s.y_graph)
                for s in samples]
    jc = jcfg.update_config(_small_config(), jsamples[:18], jsamples[18:22],
                            jsamples[22:])
    jmodel = j_create_model(jcfg.build_model_config(jc))
    init = jbatch.collate(jsamples[:4])
    variables = jax.tree_util.tree_map(
        np.asarray, jax.device_get(dict(j_init_params(jmodel, init, 2))))
    tc = tcfg.update_config(_small_config(), *splits)
    mcfg = tcfg.build_model_config(tc)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return splits, variables, model, mcfg


@pytest.mark.parametrize("neighbor_format", [False, True])
def test_engine_results_equal_single_forwards_bitwise(served,
                                                      neighbor_format):
    (_, _, test), _, model, mcfg = served
    engine = InferenceEngine(model, mcfg, reference_samples=test,
                             max_batch_size=4, max_wait_ms=50.0,
                             neighbor_format=neighbor_format, device="cpu")
    try:
        assert engine.warmup() == len(engine.buckets)
        futs = [engine.submit(s) for s in test]
        results = [f.result(timeout=60) for f in futs]
        for s, fut, res in zip(test, futs, results):
            single = engine.forward_single(s, bucket=fut.bucket)
            assert len(res) == 1 and res[0].shape == (1,)
            assert np.isfinite(res[0]).all()
            np.testing.assert_array_equal(res[0], single[0])
        st = engine.stats()
        assert st["requests"] == len(test) and st["count"] == len(test)
        assert st["batches"] < len(test)          # requests were coalesced
        assert st["p99_ms"] >= st["p50_ms"] > 0
    finally:
        engine.shutdown()
    assert not engine._dispatcher.is_alive()
    with pytest.raises(RuntimeError):
        engine.submit(test[0])


def test_engine_rejects_oversized_and_mismatched_requests(served):
    (_, _, test), _, model, mcfg = served
    with InferenceEngine(model, mcfg, reference_samples=test,
                         max_batch_size=2, device="cpu") as engine:
        big = synthetic_molecules(1, seed=0, min_atoms=400,
                                  max_atoms=400)[0]
        with pytest.raises(ValueError, match="exceeds"):
            engine.submit(big).result(timeout=30)
        wrong = synthetic_molecules(1, seed=0, min_atoms=4, max_atoms=4,
                                    num_features=3)[0]
        with pytest.raises(ValueError, match="width"):
            engine.submit(wrong).result(timeout=30)
        assert engine.predict(test[:2])[0][0].shape == (1,)


def test_run_prediction_engine_and_loop_agree(served):
    splits, variables, _, _ = served
    out = {}
    for serve in (True, False):
        out[serve] = run_prediction(_small_config(), splits, variables,
                                    serve=serve, device="cpu")
    (t1, p1), (t0, p0) = out[True], out[False]
    n_test = len(splits[2])
    assert p1[0].shape == p0[0].shape == (n_test, 1)
    np.testing.assert_array_equal(t1[0], t0[0])
    np.testing.assert_array_equal(
        t1[0][:, 0], np.array([s.y_graph[0] for s in splits[2]]))
    # different padded shapes: the same arithmetic up to GEMM blocking
    np.testing.assert_allclose(p1[0], p0[0], rtol=1e-5, atol=1e-6)


def test_run_prediction_dense_and_edge_layouts_agree(served):
    splits, variables, _, _ = served
    cfg = _small_config()
    cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    _, edge = run_prediction(cfg, splits, variables, serve=False,
                             device="cpu")
    _, dense = run_prediction(_small_config(), splits, variables,
                              serve=False, device="cpu")
    np.testing.assert_allclose(edge[0], dense[0], rtol=1e-5, atol=1e-6)


def test_default_device_entry_points_raise_without_cuda(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    splits, variables, model, mcfg = served
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_prediction(_small_config(), splits, variables)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(mcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model, mcfg, reference_samples=splits[2])


def test_resolve_serving_defaults_env_and_precision(monkeypatch):
    from hydragnn_tpu.serving.config import resolve_serving as j_resolve
    for block in ({}, {"Serving": {"enabled": True, "max_batch_size": 64,
                                   "max_wait_ms": 2.0, "num_buckets": 3}}):
        t, j = resolve_serving(block), j_resolve(block)
        for name in ("enabled", "max_batch_size", "max_wait_ms",
                     "num_buckets", "bucket_multiple"):
            assert getattr(t, name) == getattr(j, name), name
    monkeypatch.setenv("HYDRAGNN_SERVE_MAX_BATCH", "12")
    monkeypatch.setenv("HYDRAGNN_SERVE", "ture")   # typo: warns, stays off
    cfg = resolve_serving({"Serving": {"precision": "float32"}})
    assert cfg.max_batch_size == 12 and cfg.enabled is False
    # every spelling resolves as in the JAX package, int8 (the serving
    # tier, quant/) included
    for precision in ("bf16", "bfloat16", "fp32", None, "int8", "i8"):
        block = {"Serving": {"precision": precision}}
        assert resolve_serving(block).precision == \
            j_resolve(block).precision
    assert resolve_serving({"Serving": {"precision": "i8"}}).precision == \
        "int8"


def test_port_and_chip_smoke_import_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import hydragnn_tpu_torch, chip_smoke; "
            "import hydragnn_tpu_torch.run_prediction, "
            "hydragnn_tpu_torch.serving.engine, "
            "hydragnn_tpu_torch.kernels.nbr, "
            "hydragnn_tpu_torch.kernels.fused_mp, "
            "hydragnn_tpu_torch.models.schnet, "
            "hydragnn_tpu_torch.train.loss, "
            "hydragnn_tpu_torch.graphs.radius, "
            "hydragnn_tpu_torch.ops.geometry, "
            "hydragnn_tpu_torch.ops.basis, "
            "hydragnn_tpu_torch.graphs.neighborlist, "
            "hydragnn_tpu_torch.md.integrator, "
            "hydragnn_tpu_torch.md.loop, "
            "hydragnn_tpu_torch.md.farm, "
            "hydragnn_tpu_torch.telemetry.registry, "
            "hydragnn_tpu_torch.telemetry.spans, "
            "hydragnn_tpu_torch.telemetry.http, "
            "hydragnn_tpu_torch.utils.faults, "
            "hydragnn_tpu_torch.serving.config, "
            "hydragnn_tpu_torch.run_training, "
            "hydragnn_tpu_torch.datasets.extxyz, "
            "hydragnn_tpu_torch.datasets.atomistic, "
            "hydragnn_tpu_torch.datasets.smiles, "
            "hydragnn_tpu_torch.datasets.xyzdataset, "
            "hydragnn_tpu_torch.utils.smiles_utils, "
            "hydragnn_tpu_torch.graphs.synthetic, "
            "hydragnn_tpu_torch.telemetry.session, "
            "hydragnn_tpu_torch.telemetry.mfu, "
            "hydragnn_tpu_torch.quant.calibrate, "
            "hydragnn_tpu_torch.quant.ptq, "
            "hydragnn_tpu_torch.quant.distill, "
            "hydragnn_tpu_torch.parallel.partition, "
            "hydragnn_tpu_torch.preprocess.sampling, "
            "hydragnn_tpu_torch.preprocess.cache, "
            "hydragnn_tpu_torch.datasets.async_loader, "
            "hydragnn_tpu_torch.telemetry.sampling, "
            "hydragnn_tpu_torch.train.train_step, "
            "hydragnn_tpu_torch.examples.ogbn; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) "
            "or m == 'hydragnn_tpu' or m.startswith('hydragnn_tpu.') "
            "or m == 'examples' or m.startswith('examples.')]; "
            "print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_new_serving_modules_import_no_jax():
    """The fleet, publisher, autoscaler, compile store and profiling
    modules load neither jax nor the JAX package."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "import hydragnn_tpu_torch.serving, "
            "hydragnn_tpu_torch.serving.fleet, "
            "hydragnn_tpu_torch.serving.publish, "
            "hydragnn_tpu_torch.serving.autoscale, "
            "hydragnn_tpu_torch.utils.devices, "
            "hydragnn_tpu_torch.utils.profiling, "
            "hydragnn_tpu_torch.kernels._build, "
            "hydragnn_tpu_torch.telemetry.http; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) "
            "or m == 'hydragnn_tpu' or m.startswith('hydragnn_tpu.')]; "
            "print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_have_no_jax_imports():
    files = sorted((REPO / "hydragnn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "hydragnn_tpu")
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


EF_TOL = dict(rtol=1e-4, atol=1e-5)
LJ = REPO / "examples" / "LennardJones" / "LJ.json"


@pytest.fixture(scope="module")
def lj_served():
    """LJ SchNet at its published widths with Flax-initialized weights
    and nontrivial BatchNorm statistics; 10 configurations."""
    from hydragnn_tpu.models.create import create_model as jcreate
    sys.path.insert(0, str(REPO))
    from examples.LennardJones.lj_data import generate_lj_dataset
    with open(LJ) as f:
        base = json.load(f)
    samples = lj_configurations(10, seed=6)
    jsamples = generate_lj_dataset(10, seed=6)
    jc = jcfg.update_config(copy.deepcopy(base), jsamples)
    jmcfg = jcfg.build_model_config(jc)
    jmodel = jcreate(jmcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(
        j_init_params(jmodel, jbatch.collate(jsamples[:4]), 4))))
    rng = np.random.RandomState(1)
    for stats in variables["batch_stats"].values():
        stats["mean"] = rng.randn(*stats["mean"].shape).astype(np.float32)
        stats["var"] = (0.5 + rng.rand(*stats["var"].shape)).astype(
            np.float32)
    mcfg = tcfg.build_model_config(
        tcfg.update_config(copy.deepcopy(base), samples))
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return samples, jsamples, jmodel, jmcfg, variables, model, mcfg


def test_ef_engine_matches_jax_ef_engine(lj_served):
    from hydragnn_tpu.serving.engine import InferenceEngine as JEngine
    samples, jsamples, jmodel, jmcfg, variables, model, mcfg = lj_served
    jvars = jax.tree_util.tree_map(jax.numpy.asarray, variables)
    jeng = JEngine(jmodel, jvars, jmcfg, reference_samples=jsamples,
                   max_batch_size=4, max_wait_ms=50.0, ef_forward=True)
    try:
        want = jeng.predict(jsamples[:6], timeout=300)
    finally:
        jeng.shutdown()
    with InferenceEngine(model, mcfg, reference_samples=samples,
                         max_batch_size=4, max_wait_ms=50.0,
                         ef_forward=True, device="cpu") as eng:
        got = eng.predict(samples[:6], timeout=300)
    for s, g, w in zip(samples, got, want):
        assert len(g) == 2
        assert g[0].shape == (1,) and g[1].shape == (s.num_nodes, 3)
        assert np.isfinite(g[1]).all() and np.abs(g[1]).max() > 0
        np.testing.assert_allclose(g[0], np.asarray(w[0]), **EF_TOL)
        np.testing.assert_allclose(g[1], np.asarray(w[1]), **EF_TOL)


def test_ef_engine_batched_equals_single_bitwise(lj_served):
    """Energies and forces of a coalesced batch equal each request run
    alone on the same bucket, bit for bit: the CPU path's sums (segment
    sums, filter-scatter, the gathers' gradients) add each graph's rows
    in the same order wherever it sits."""
    samples, *_, model, mcfg = lj_served
    engine = InferenceEngine(model, mcfg, reference_samples=samples,
                             max_batch_size=4, max_wait_ms=50.0,
                             ef_forward=True, device="cpu")
    try:
        futs = [engine.submit(s) for s in samples]
        results = [f.result(timeout=120) for f in futs]
        assert engine.stats()["batches"] < len(samples)
        for s, fut, res in zip(samples, futs, results):
            single = engine.forward_single(s, bucket=fut.bucket)
            for a, b in zip(res, single):
                np.testing.assert_array_equal(a, b)
    finally:
        engine.shutdown()


def test_ef_forward_requires_node_head(served, lj_served):
    (_, _, test), _, model, mcfg = served       # head 0 is a graph head
    with pytest.raises(ValueError, match="node-level energy head"):
        InferenceEngine(model, mcfg, reference_samples=test,
                        ef_forward=True, device="cpu")
    # the plain (non-EF) engine on the LJ model serves node energies
    samples, *_, lj_model, lj_mcfg = lj_served
    with InferenceEngine(lj_model, lj_mcfg, reference_samples=samples,
                         max_batch_size=2, device="cpu") as eng:
        res = eng.predict(samples[:2])
    assert res[0][0].shape == (samples[0].num_nodes, 1)
