"""The port's int8 serving tier (hydragnn_tpu_torch/quant/ and the
engine's ``compute_dtype="int8"``) against the JAX package's on the CPU:
the counterpart of tests/test_quant.py.

Models: the csce PNA config cut to hidden 16 and 2 layers (graph head
[16, 16]) on 12 synthetic molecules, and the JAX tests' PNA on the
deterministic BCC lattice, the Flax weights (with random running
statistics) carried across.

Bounds, all on real rows:

* calibration: the key sets equal; absmax and scales within rtol 1e-5 of
  JAX's (the activations they are taken from are float32 forwards of the
  two packages); the host-side helpers (`_calibration_shape`,
  `CalibrationScales.from_amax`, `merge_calibrations`, `scales_digest`)
  bitwise; the pass bitwise deterministic, and a 4-way merge bitwise the
  one-pass result;
* `int8_dense`: x_q, w_q, s_w and the int32 accumulator bitwise JAX's on
  identical inputs; y within 1 ulp;
* the quantized forward, on JAX's scales: within 2^-7 (atol + rtol |ref|)
  of JAX's quantized forward; within the 2^-3 serving contract of its
  own float32 forward;
* `distill_heads`: bitwise deterministic, the encoder bitwise the
  teacher's; against JAX's at 8 steps and lr 3e-3 the same best step
  (> 0), the head MSEs before and after within rtol 1e-4, each trained
  leaf's update within 1e-4 relative L2;
* the int8 engine: the 2^-3 contract against the float32 engine, batched
  = single bitwise, the breadcrumbs, a hot swap equal to a fresh int8
  engine on the new weights, distinct compile-store keys, JAX's two
  refusals; a tiered fleet of one int8 and one float32 replica routes by
  priority and quota, downgrades and falls back as counted, and loses no
  future.
"""
import copy
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.train.train_step import make_forward_fn as j_forward_fn
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.quant import (CalibrationScales, calibrate,
                                      distill_heads, int8_dense,
                                      make_quantized_forward,
                                      merge_calibrations, scales_digest)
from hydragnn_tpu_torch.quant.ptq import (int_mm, quantize_input,
                                          quantize_weight)
from hydragnn_tpu_torch.serving.engine import (SERVE_INT8_ATOL,
                                               SERVE_INT8_RTOL,
                                               InferenceEngine)
from hydragnn_tpu_torch.serving.fleet import ReplicaRouter, TierPolicy
from hydragnn_tpu_torch.telemetry.registry import get_registry
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables,
                                              random_flax_variables)
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_pna import randomize_batch_stats, to_jax_samples
from tests.test_torch_train import to_port_samples
from tests.utils import make_config

# the modules (each package's quant/__init__ exports functions of the
# same names)
jcal = importlib.import_module("hydragnn_tpu.quant.calibrate")
jdistill = importlib.import_module("hydragnn_tpu.quant.distill")
jptq = importlib.import_module("hydragnn_tpu.quant.ptq")
tcal = importlib.import_module("hydragnn_tpu_torch.quant.calibrate")

torch.set_num_threads(1)

CSCE = Path(__file__).resolve().parents[1] / "examples/csce/csce_gap.json"
SCALE_TOL = dict(rtol=1e-5, atol=0.0)
QFWD_BOUND = 2.0 ** -7


def csce_small():
    """csce_gap.json at hidden 16, 2 layers, graph head [16, 16]."""
    with open(CSCE) as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=16, num_conv_layers=2)
    head = arch["output_heads"]["graph"]
    head.update(dim_sharedlayers=16, dim_headlayers=[16, 16])
    return cfg


class Pair:
    """One config through both packages: the samples, the JAX model and
    Flax variables (random running statistics), the port's model with
    them carried across, and both model configs."""

    def __init__(self, cfg, samples, seed=0):
        self.samples = samples
        self.jsamples = to_jax_samples(samples)
        jc = jcfg.update_config(copy.deepcopy(cfg), self.jsamples)
        tc = tcfg.update_config(copy.deepcopy(cfg), samples)
        self.jm = jcfg.build_model_config(jc)
        self.tm = tcfg.build_model_config(tc)
        self.jmodel = j_create_model(self.jm)
        jb = jbatch.collate(self.jsamples[:4], np_out=True)
        self.variables = randomize_batch_stats(
            j_init_params(self.jmodel, jb, seed=seed), seed + 1)
        self.jvars = jax.tree_util.tree_map(jnp.asarray, self.variables)
        self.model = self.port_model()

    def port_model(self, variables=None):
        model = create_model(self.tm, device="cpu")
        model.load_state_dict(load_jax_variables(
            variables if variables is not None else self.variables))
        return model


@pytest.fixture(scope="module")
def csce():
    samples = synthetic_molecules(12, seed=5, min_atoms=6, max_atoms=16)
    return Pair(csce_small(), samples)


def without_isolated_atoms(samples):
    """The samples whose every atom has an in-edge."""
    return [s for s in samples
            if (np.bincount(s.receivers, minlength=s.num_nodes) > 0).all()]


@pytest.fixture(scope="module")
def csce_connected():
    """The csce pair on molecules without an isolated atom."""
    samples = without_isolated_atoms(
        synthetic_molecules(24, seed=5, min_atoms=6, max_atoms=16))[:12]
    assert len(samples) == 12
    return Pair(csce_small(), samples)


@pytest.fixture(scope="module")
def lattice():
    samples = to_port_samples(deterministic_graph_dataset(num_configs=12))
    return Pair(make_config("PNA"), samples)


def metric(name: str) -> float:
    """A label-less metric's value in the process registry (0 unset)."""
    vals = get_registry().snapshot().get(name, {}).get("values", {})
    return float(sum(vals.values())) if vals else 0.0


def scales_equal(a, b):
    return (sorted(a.scales) == sorted(b.scales)
            and all(np.array_equal(a.scales[k], b.scales[k])
                    for k in a.scales)
            and all(np.array_equal(a.amax[k], b.amax[k]) for k in a.amax)
            and a.digest == b.digest)


def from_jax(jres):
    """The port's CalibrationScales of JAX's result (its absmax)."""
    return CalibrationScales.from_amax(
        {k: np.asarray(v) for k, v in jres.amax.items()}, jres.num_samples)


# ------------------------------------------------------------ calibration

def float64_amax(pair, num_samples):
    """The port's calibration absmax of a float64 copy of the model on
    float64 samples: the reference the float32 floor is read against."""
    samples = []
    for s in pair.samples:
        t = copy.copy(s)
        t.x, t.pos = s.x.astype(np.float64), s.pos.astype(np.float64)
        samples.append(t)
    return calibrate(pair.port_model().double(), None, pair.tm, samples,
                     num_samples=num_samples).amax


@pytest.mark.parametrize("which", ["csce", "lattice"])
def test_calibration_keys_and_scales_match_jax(which, request):
    """The key set is JAX's ("/"-joined module paths); absmax and scales
    within rtol 1e-5, or, for a layer where JAX's own float32 absmax is
    further than that from the port's float64 pass, within twice that
    floor (csce's second layer, whose input runs through the first
    layer's sums, in both packages); the digest of JAX's own scale arrays is the same hex in both
    packages."""
    pair = request.getfixturevalue(which)
    want = jcal.calibrate(pair.jmodel, pair.jvars, pair.jm, pair.jsamples,
                          num_samples=8)
    got = calibrate(pair.model, None, pair.tm, pair.samples, num_samples=8)
    assert sorted(got.scales) == sorted(want.scales)
    assert got.num_samples == want.num_samples == 8
    ref64 = None

    def rel(a, b):
        b = np.asarray(b, np.float64)
        return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                            / np.maximum(np.abs(b), 1e-30)))
    for key in sorted(want.scales):
        gap = max(rel(got.amax[key], want.amax[key]),
                  rel(got.scales[key], want.scales[key]))
        if gap > SCALE_TOL["rtol"]:
            if ref64 is None:
                ref64 = float64_amax(pair, 8)
            floor = rel(want.amax[key], ref64[key])
            assert gap <= 2 * floor, (key, gap, floor)
    jscales = {k: np.asarray(v) for k, v in want.scales.items()}
    assert scales_digest(jscales) == jcal.scales_digest(jscales) == \
        want.digest
    # the weights as a Flax tree give the same pass
    again = calibrate(pair.model, pair.variables, pair.tm, pair.samples,
                      num_samples=8)
    assert scales_equal(got, again)


def test_calibration_bitwise_deterministic_and_worker_count_pinned(csce):
    """Two passes are bitwise equal; a merge of 4 shards is bitwise one
    pass over the whole set."""
    c1 = calibrate(csce.model, None, csce.tm, csce.samples)
    c2 = calibrate(csce.model, None, csce.tm, csce.samples)
    assert scales_equal(c1, c2)
    s = csce.samples
    four = merge_calibrations([calibrate(csce.model, None, csce.tm,
                                         s[i:i + 3])
                               for i in range(0, 12, 3)])
    assert scales_equal(c1, four)
    assert four.num_samples == 12
    # and the merge is the JAX helper's, bitwise
    parts = [calibrate(csce.model, None, csce.tm, s[:6]),
             calibrate(csce.model, None, csce.tm, s[6:])]
    jmerged = jcal.merge_calibrations([
        jcal.CalibrationScales.from_amax(p.amax, p.num_samples)
        for p in parts])
    assert scales_equal(merge_calibrations(parts), jmerged)


def test_host_helpers_bitwise_jax():
    """from_amax (silent channels take the layer's largest scale, an
    all-silent layer 1.0), merge's shape refusal, _calibration_shape and
    scales_digest against the JAX package's copies."""
    rng = np.random.RandomState(3)
    amax = {"conv_0/pre_i": rng.rand(7).astype(np.float32),
            "conv_1/MLP_0/dense_1": np.array([1.27, 0.0, 2.54], np.float32),
            "conv_1/lin": np.zeros(3, np.float32)}
    got = CalibrationScales.from_amax(amax, 4)
    want = jcal.CalibrationScales.from_amax(amax, 4)
    assert scales_equal(got, want)
    s = got.scales["conv_1/MLP_0/dense_1"]
    assert s[1] == s[2] == np.float32(2.54 / 127)
    assert (got.scales["conv_1/lin"] == 1.0).all()
    a = CalibrationScales.from_amax({"conv_0/lin": np.ones(4, np.float32)}, 1)
    b = CalibrationScales.from_amax({"conv_0/lin": np.ones(8, np.float32)}, 1)
    with pytest.raises(ValueError, match="shape"):
        merge_calibrations([a, b])
    with pytest.raises(ValueError):
        merge_calibrations([])
    s7 = tbatch.GraphSample(x=rng.rand(7, 1).astype(np.float32),
                            pos=rng.rand(7, 3).astype(np.float32),
                            senders=np.arange(7, dtype=np.int32),
                            receivers=np.roll(np.arange(7, dtype=np.int32),
                                              1))
    assert tcal._calibration_shape([s7]) == (8, 16, 2)
    mols = synthetic_molecules(9, seed=2, min_atoms=3, max_atoms=30)
    assert tcal._calibration_shape(mols) == \
        jcal._calibration_shape(to_jax_samples(mols))
    assert tcal.encoder_param_key("feature_norm_3", 2)
    assert not tcal.encoder_param_key("conv_102", 2)
    assert tcal.encoder_conv_path(("conv_1", "lin"), 2)
    assert not tcal.encoder_conv_path(("conv_x",), 2)


def test_calibration_reports_telemetry(csce):
    """The quant.calibrate span and the three quant.* metrics."""
    from hydragnn_tpu_torch.telemetry import spans
    before = metric("quant.calibrations_total")
    samples_before = metric("quant.calibration_samples_total")
    rec = spans.SpanRecorder()
    prev = spans.install_recorder(rec)
    try:
        res = calibrate(csce.model, None, csce.tm, csce.samples,
                        num_samples=5)
    finally:
        spans.install_recorder(prev)
    assert metric("quant.calibrations_total") == before + 1
    assert metric("quant.calibration_samples_total") == samples_before + 5
    assert metric("quant.calibrated_layers") == len(res.scales)
    names = [e["name"] for e in rec.chrome_trace()["traceEvents"]]
    assert "quant.calibrate" in names


# --------------------------------------------------------------- int8_dense

def jax_int8_parts(x, kernel, s_x):
    """x_q, w_q, s_w and the int32 accumulator, as the JAX package's
    int8_dense computes them (hydragnn_tpu/quant/ptq.py:41-61)."""
    x = jnp.asarray(x)
    s_x = jnp.asarray(s_x)
    x_q = jnp.clip(jnp.round(x / s_x), -127.0, 127.0).astype(jnp.int8)
    w_fold = jnp.asarray(kernel) * s_x[:, None]
    s_w = jnp.max(jnp.abs(w_fold), axis=0) / jnp.float32(127.0)
    s_w = jnp.where(s_w > 0, s_w, jnp.float32(1.0))
    w_q = jnp.clip(jnp.round(w_fold / s_w[None, :]), -127.0,
                   127.0).astype(jnp.int8)
    acc = jax.lax.dot_general(x_q, w_q, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return [np.asarray(a) for a in (x_q, w_q, s_w, acc)]


@pytest.mark.parametrize("rows,cols,out", [(16, 8, 4), (9, 12, 5),
                                           (33, 200, 200), (64, 1, 8)])
def test_int8_dense_bitwise_against_jax(rows, cols, out):
    """On identical inputs: x_q, w_q (the port's [out, in] is the
    transpose of Flax's kernel), s_w and the accumulator bitwise; y within
    1 ulp; a scale/width mismatch raises the same ValueError."""
    rng = np.random.RandomState(rows + cols)
    x = (rng.randn(rows, cols) * 3).astype(np.float32)
    kernel = rng.randn(cols, out).astype(np.float32)
    bias = rng.randn(out).astype(np.float32)
    s_x = (np.abs(x).max(axis=0) / 127).astype(np.float32)
    s_x[0] = np.float32(np.abs(x).max() / 127)      # a silent-like channel
    jx_q, jw_q, js_w, jacc = jax_int8_parts(x, kernel, s_x)
    tx, tw, ts = (torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
                  torch.from_numpy(s_x))
    x_q = quantize_input(tx, ts)
    w_q, s_w = quantize_weight(tw, ts)
    acc = int_mm(x_q, w_q.t())
    np.testing.assert_array_equal(x_q.numpy(), jx_q)
    np.testing.assert_array_equal(w_q.numpy(), jw_q.T)
    np.testing.assert_array_equal(s_w.numpy(), js_w)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), jacc)
    y = int8_dense(tx, tw, torch.from_numpy(bias), ts).numpy()
    want = np.asarray(jptq.int8_dense(jnp.asarray(x), jnp.asarray(kernel),
                                      jnp.asarray(bias), jnp.asarray(s_x)))
    ulp = np.spacing(np.maximum(np.abs(y), np.abs(want)))
    assert (np.abs(y - want) <= ulp).all()
    # 3-D inputs (a vector channel) contract their last axis
    y3 = int8_dense(tx.reshape(1, rows, cols), tw, None, ts)
    assert y3.shape == (1, rows, out)
    with pytest.raises(ValueError, match="calibration scales cover"):
        int8_dense(tx, tw, None, ts[:cols - 1])
    with pytest.raises(ValueError, match="calibration scales cover"):
        jptq.int8_dense(jnp.asarray(x), jnp.asarray(kernel), None,
                        jnp.asarray(s_x[:cols - 1]))


# ------------------------------------------------------ quantized forward

def real_rows(batch, mcfg, ih):
    head = mcfg.heads[ih]
    mask = batch.node_mask if head.head_type == "node" else batch.graph_mask
    return np.asarray(mask, bool)


def within(got, want, bound):
    return bool((np.abs(got - want) <= bound + bound * np.abs(want)).all())


def contract_ratio(got, want):
    """The largest gap over the 2^-3 serving bound (atol + rtol |f32|)."""
    return float(np.max(np.abs(got - want)
                        / (SERVE_INT8_ATOL + SERVE_INT8_RTOL * np.abs(want))))


@pytest.mark.parametrize("which", ["csce", "lattice", "csce_connected"])
def test_quantized_forward_matches_jax_and_the_contract(which, request):
    """On JAX's scales, the port's int8 forward within 2^-7 of JAX's int8
    forward, on a batch of every sample. On the lattice, and on csce
    molecules without an isolated atom, both packages' are within the
    2^-3 serving contract of their own float32 forward. On csce
    molecules with one neither package's is (a reference quirk, ROADMAP
    C): a real atom without neighbours takes PNA's attenuation scaler at
    its 1e-6 floor, so its std aggregate reaches ~1e3-1e4 at post_nn's
    input, sets those layers' scales, and the other rows quantize to a
    few levels; the ratio of gap to bound is the same in both."""
    pair = request.getfixturevalue(which)
    jres = jcal.calibrate(pair.jmodel, pair.jvars, pair.jm, pair.jsamples,
                          num_samples=8)
    tb = tbatch.collate(pair.samples)
    jb = jax.tree_util.tree_map(
        jnp.asarray, jbatch.collate(pair.jsamples, np_out=True))
    want8, _ = jptq.make_quantized_forward(pair.jmodel, pair.jm, jres)(
        pair.jvars, jb, train=False)
    want32, _ = j_forward_fn(pair.jmodel, pair.jm, "float32")(
        pair.jvars, jb, train=False)
    forward = make_quantized_forward(pair.model, pair.tm, from_jax(jres))
    with torch.no_grad():
        got8, _ = forward(tb)
        got32, _ = pair.model(tb)
    for ih in range(len(pair.tm.heads)):
        real = real_rows(tb, pair.tm, ih)
        g8 = got8[ih].numpy()[real]
        w8 = np.asarray(want8[ih])[real]
        assert within(g8, w8, QFWD_BOUND), np.abs(g8 - w8).max()
        g32 = got32[ih].numpy()[real]
        assert not np.array_equal(g8, g32)     # the tier is really int8
        ratio = contract_ratio(g8, g32)
        jratio = contract_ratio(w8, np.asarray(want32[ih])[real])
        if which != "csce":
            assert ratio <= 1.0 and jratio <= 1.0, (ratio, jratio)
        else:
            assert ratio > 1.0 and jratio > 1.0, (ratio, jratio)
            np.testing.assert_allclose(ratio, jratio, rtol=0.05)


def test_quantized_forward_reads_the_live_weights(csce):
    """The weights are quantized in the forward: new values copied into
    the model give the forward of a model built on them."""
    calib = calibrate(csce.model, None, csce.tm, csce.samples)
    model = csce.port_model()
    forward = make_quantized_forward(model, csce.tm, calib)
    tb = tbatch.collate(csce.samples[:5])
    other = random_flax_variables(model, seed=9)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(load_jax_variables(other)[name])
        got, _ = forward(tb)
        fresh = csce.port_model(other)
        want, _ = make_quantized_forward(fresh, csce.tm, calib)(tb)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------ distillation

def test_distill_deterministic_never_worse_and_matches_jax(csce):
    """Two calls bitwise equal (student and report); the encoder and batch
    statistics bitwise the teacher's; the training held against JAX's
    `distill_heads` on the same scales, samples, steps and lr, at a
    setting where an update is kept (8 steps at lr 3e-3; best step 6 in
    both): the same best step, the head MSEs before and after within
    rtol 1e-4 of JAX's, strictly better than the teacher, and each
    trained leaf's update (student - teacher) within 1e-4 relative L2 of
    JAX's (the leaves' float32 rounding alone puts them ~1e-6 apart)."""
    jres = jcal.calibrate(csce.jmodel, csce.jvars, csce.jm, csce.jsamples,
                          num_samples=6)
    calib = from_jax(jres)
    kw = dict(steps=8, lr=3e-3, num_samples=6)
    s1, r1 = distill_heads(csce.model, csce.variables, csce.tm, calib,
                           csce.samples, **kw)
    s2, r2 = distill_heads(csce.model, csce.variables, csce.tm, calib,
                           csce.samples, **kw)
    assert r1 == r2
    flat1 = jax.tree_util.tree_leaves_with_path(s1)
    flat2 = jax.tree_util.tree_leaves_with_path(s2)
    assert [p for p, _ in flat1] == [p for p, _ in flat2]
    for (_, a), (_, b) in zip(flat1, flat2):
        assert np.array_equal(a, b)
    num_conv = int(csce.tm.num_conv_layers)
    for key, sub in csce.variables["params"].items():
        if tcal.encoder_param_key(key, num_conv):
            for (_, a), (_, b) in zip(
                    jax.tree_util.tree_leaves_with_path(sub),
                    jax.tree_util.tree_leaves_with_path(s1["params"][key])):
                assert np.array_equal(np.asarray(a), b)
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(csce.variables["batch_stats"]),
            jax.tree_util.tree_leaves_with_path(s1["batch_stats"])):
        assert np.array_equal(np.asarray(a), b)
    js, jr = jdistill.distill_heads(csce.jmodel, csce.jvars, csce.jm, jres,
                                    csce.jsamples, **kw)
    assert sorted(r1) == sorted(jr)
    assert r1["trained_param_keys"] == jr["trained_param_keys"]
    assert r1["best_step"] == jr["best_step"] > 0
    assert r1["improved"] and jr["improved"]
    for k in ("head_mse_vs_teacher_pre", "head_mse_vs_teacher_post"):
        np.testing.assert_allclose(r1[k], jr[k], rtol=1e-4)
    assert sum(r1["head_mse_vs_teacher_post"]) < sum(
        r1["head_mse_vs_teacher_pre"])
    assert r1["head_mse_vs_teacher_pre"][0] > 0
    for key in r1["trained_param_keys"]:
        paths = jax.tree_util.tree_leaves_with_path(
            csce.variables["params"][key])
        got = jax.tree_util.tree_leaves(s1["params"][key])
        want = jax.tree_util.tree_leaves(js["params"][key])
        for (path, t), g, w in zip(paths, got, want):
            t = np.asarray(t, np.float64)
            du = np.asarray(g, np.float64) - t
            dj = np.asarray(w, np.float64) - t
            assert np.linalg.norm(dj) > 0, (key, path)
            rel = np.linalg.norm(du - dj) / np.linalg.norm(dj)
            assert rel <= 1e-4, (key, jax.tree_util.keystr(path), rel)
    # the model handed in is left as it was
    again = export_jax_variables(csce.model)
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(again["params"]),
            jax.tree_util.tree_leaves_with_path(csce.variables["params"])):
        assert np.array_equal(a, np.asarray(b))


def test_distill_reports_telemetry(csce):
    before = metric("quant.distillations_total")
    calib = calibrate(csce.model, None, csce.tm, csce.samples, num_samples=4)
    _, rep = distill_heads(csce.model, None, csce.tm, calib, csce.samples,
                           steps=2, num_samples=4)
    assert metric("quant.distillations_total") == before + 1
    assert metric("quant.distill_mse_post") == float(
        sum(rep["head_mse_vs_teacher_post"]))


# ---------------------------------------------------------------- engine

def engine(pair, model=None, **kw):
    return InferenceEngine(
        model if model is not None else pair.port_model(), pair.tm,
        reference_samples=pair.samples, max_batch_size=4, max_wait_ms=1.0,
        num_buckets=1, device="cpu", **kw)


def test_int8_engine_contract_breadcrumbs_and_bitwise_batching(lattice):
    """Futures carry the 2^-3 bound and the tier; results within it of the
    float32 engine's on every real row; batched = single bitwise within a
    bucket; stats and health echo the tier; the engine calibrated itself
    on the first quant_calib_samples reference samples. On the lattice
    (JAX's own int8 test data: the contract holds there)."""
    engines = {dt: engine(lattice, compute_dtype=dt, quant_calib_samples=6)
               for dt in ("float32", "int8")}
    try:
        futs = {dt: [e.submit(s) for s in lattice.samples]
                for dt, e in engines.items()}
        res = {dt: [f.result(timeout=300) for f in fs]
               for dt, fs in futs.items()}
        for f in futs["int8"]:
            assert (f.parity, f.parity_rtol, f.parity_atol, f.tier) == (
                "tolerance", SERVE_INT8_RTOL, SERVE_INT8_ATOL, "int8")
        assert all(f.parity == "bitwise" and f.tier == "float32"
                   for f in futs["float32"])
        worst = 0.0
        for r32, r8 in zip(res["float32"], res["int8"]):
            for a, b in zip(r32, r8):
                assert within(b, a, SERVE_INT8_ATOL)
                worst = max(worst, float(np.abs(b - a).max()))
        assert worst > 0
        e8 = engines["int8"]
        for i, f in enumerate(futs["int8"]):
            single = e8.forward_single(lattice.samples[i], bucket=f.bucket)
            for a, b in zip(res["int8"][i], single):
                assert np.array_equal(a, b)
        assert e8.stats()["tier"] == e8.health()["tier"] == "int8"
        assert e8.quant_calibration.num_samples == 6
        want = calibrate(lattice.port_model(), None, lattice.tm, lattice.samples,
                         num_samples=6)
        assert scales_equal(e8.quant_calibration, want)
    finally:
        for e in engines.values():
            e.shutdown()


def test_int8_engine_swap_requantizes(csce):
    """swap_variables copies new weights in; the next batch is bitwise a
    fresh int8 engine's on them (same scales), with the new version."""
    calib = calibrate(csce.model, None, csce.tm, csce.samples)
    other = random_flax_variables(csce.model, seed=4)
    e1 = engine(csce, compute_dtype="int8", quant_calibration=calib)
    e2 = engine(csce, model=csce.port_model(other), compute_dtype="int8",
                quant_calibration=calib)
    try:
        before = e1.predict(csce.samples[:3], timeout=300)
        assert e1.swap_variables(other, "v1") == "v0"
        futs = [e1.submit(s) for s in csce.samples[:3]]
        after = [f.result(timeout=300) for f in futs]
        fresh = e2.predict(csce.samples[:3], timeout=300)
        assert all(f.model_version == "v1" for f in futs)
        for a, b, c in zip(after, fresh, before):
            assert np.array_equal(a[0], b[0])
            assert not np.array_equal(a[0], c[0])
    finally:
        e1.shutdown()
        e2.shutdown()


def test_int8_store_keys_and_refusals(csce, tmp_path):
    """int8 and float32 buckets get distinct compile-store keys, and two
    calibrations collide only if their scales are bitwise equal (the
    digest rides the key); ef_forward and num_shards > 1 are refused at
    int8 with the JAX package's ValueErrors; int8 without calibration or
    reference samples raises."""
    calib = calibrate(csce.model, None, csce.tm, csce.samples)
    other = calibrate(csce.model, None, csce.tm, csce.samples[:3])
    assert calib.digest != other.digest
    e32 = engine(csce, compute_dtype="float32")
    e8 = engine(csce, compute_dtype="int8", quant_calibration=calib)
    e8b = engine(csce, compute_dtype="int8", quant_calibration=other)
    e8c = engine(csce, compute_dtype="int8",
                 quant_calibration=copy.deepcopy(calib))
    try:
        b = e32.buckets[0]
        keys = [e._store_key(b) for e in (e32, e8, e8b, e8c)]
        assert len(set(keys[:3])) == 3
        assert keys[1] == keys[3]
    finally:
        for e in (e32, e8, e8b, e8c):
            e.shutdown()
    with pytest.raises(ValueError, match="ef_forward"):
        engine(csce, compute_dtype="int8", ef_forward=True)
    with pytest.raises(ValueError, match="single-shard"):
        engine(csce, compute_dtype="int8", num_shards=2)
    with pytest.raises(NotImplementedError, match="A8"):
        engine(csce, compute_dtype="float32", num_shards=2)
    with pytest.raises(ValueError, match="calibration"):
        InferenceEngine(csce.port_model(), csce.tm,
                        buckets=e32.buckets, proto_sample=csce.samples[0],
                        compute_dtype="int8", device="cpu")


def test_tiered_fleet_on_real_int8_replicas(csce):
    """One int8 and one float32 engine of the same weights behind a
    ReplicaRouter with a TierPolicy: priority requests land on the
    float32 tier within the quota and are downgraded over it (counted);
    each future's tier and bound are its replica's; with the int8
    replica killed, every request falls back to float32 (counted) and no
    future is lost."""
    calib = calibrate(csce.model, None, csce.tm, csce.samples)

    def factory(idx):
        return engine(csce, compute_dtype="int8" if idx == 0 else "float32",
                      quant_calibration=calib)

    policy = TierPolicy(fast="int8", accurate="float32", priority_min=1,
                        quota=0.5)
    router = ReplicaRouter(factory, 2, tier_policy=policy)
    try:
        lo = router.submit(csce.samples[0], priority=0)
        lo.result(timeout=300)
        assert (lo.tier, lo.replica, lo.parity_rtol) == (
            "int8", 0, SERVE_INT8_RTOL)
        tiers = []
        for i in range(4):
            fut = router.submit(csce.samples[i], priority=5)
            fut.result(timeout=300)
            tiers.append(fut.tier)
            want = SERVE_INT8_RTOL if fut.tier == "int8" else 0.0
            assert fut.parity_rtol == want
            assert fut.replica == (0 if fut.tier == "int8" else 1)
        # the accurate share stays within half of all dispatches
        assert tiers == ["float32", "int8", "float32", "int8"]
        st = router.stats()
        assert st["tier_downgrades"] == 2
        assert st["tier_dispatches"] == {"float32": 2, "int8": 3}
        router.kill_replica(0)
        futs = [router.submit(s, priority=0) for s in csce.samples]
        res = [f.result(timeout=300) for f in futs]
        assert all(f.tier == "float32" and f.parity == "bitwise"
                   for f in futs)
        assert len(res) == len(csce.samples)
        assert router.stats()["tier_fallbacks"] >= len(csce.samples)
    finally:
        router.shutdown()


def test_run_prediction_int8_calibrates_once_for_every_replica(
        lattice, monkeypatch, tmp_path):
    """run_prediction at Serving.precision "int8" through one engine and
    through a fleet of 2: one calibration each run, shared by the
    replicas; predictions within the 2^-3 contract of the float32
    engine's, the fleet's bitwise the single engine's on the one bucket
    they share; the loop (serving off) computes at float32, as in JAX."""
    from hydragnn_tpu_torch import run_prediction
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HYDRAGNN_SERVE_PRECISION", raising=False)
    cfg = make_config("PNA")
    splits = (lattice.samples[:6], lattice.samples[6:8],
              lattice.samples[8:])
    outs = {}
    for label, serving in (
            ("f32", {"max_batch_size": 4, "num_buckets": 1}),
            ("int8", {"max_batch_size": 4, "num_buckets": 1,
                      "precision": "int8", "quant_calib_samples": 3}),
            ("int8_fleet", {"max_batch_size": 4, "num_buckets": 1,
                            "precision": "i8", "quant_calib_samples": 3,
                            "fleet": {"replicas": 2}}),
            ("int8_loop", {"precision": "int8"})):
        c = copy.deepcopy(cfg)
        c["Serving"] = serving
        before = metric("quant.calibrations_total")
        outs[label] = run_prediction(c, splits, variables=lattice.variables,
                                     serve=label != "int8_loop",
                                     device="cpu")[1][0]
        calibrations = metric("quant.calibrations_total") - before
        assert calibrations == (0 if label in ("f32", "int8_loop") else 1)
    assert within(outs["int8"], outs["f32"], SERVE_INT8_ATOL)
    assert not np.array_equal(outs["int8"], outs["f32"])
    assert np.array_equal(outs["int8"], outs["int8_fleet"])
    np.testing.assert_allclose(outs["int8_loop"], outs["f32"], rtol=1e-5,
                               atol=1e-6)
