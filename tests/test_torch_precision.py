"""The port's mixed-precision policy (hydragnn_tpu_torch/train/precision.py,
the bf16 casting of train/train_step.py, ops/segment.py `_accum_f32`, the
bf16 plain versions of kernels 2-4 and the serving contract) against the
JAX package's on the CPU, where the port's kernels take their plain
versions and the JAX package's Pallas kernels run in interpret mode.

Bounds:
* precision resolution: equal, case by case;
* the bf16 plain versions against the JAX default route (the XLA
  formulation, float32 accumulation): counts, degrees, min and max
  bitwise; sums and the statistics past them within one bf16 ulp of the
  larger magnitude (at least 2^-10): both add the same bf16 values in
  float32 and round once, in orders that may differ (measured: bitwise);
  on the bf16-exact dyadic case everything bitwise;
* against the Pallas kernels in interpret mode, and port vs JAX for bf16
  forwards and losses: 2^-5 (atol + rtol |ref|, the serving bound); the
  Pallas neighbour kernel's std, which misses it, is held against the
  float64 statistic instead. That kernel accumulates in bf16 (ROADMAP
  C), and the JAX SchNet computes in float32 past its first shifted
  softplus (its `- np.log(2.0)` is a float32 constant), so neither is
  bitwise.
"""
import copy
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.kernels import fused_mp_pallas as jfm
from hydragnn_tpu.kernels.nbr_pallas import fused_neighbor_aggregate
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.ops import segment as jseg
from hydragnn_tpu.serving.config import resolve_serving as j_resolve_serving
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu.train.precision import resolve_precision as j_resolve
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                 tie_rich_edge_case,
                                                 tie_rich_neighbor_case)
from hydragnn_tpu_torch.kernels import fused_mp, nbr
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.ops import segment as tseg
from hydragnn_tpu_torch.serving.config import resolve_serving
from hydragnn_tpu_torch.serving.engine import (SERVE_REDUCED_ATOL,
                                               SERVE_REDUCED_RTOL,
                                               InferenceEngine,
                                               bucket_ladder)
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.train.precision import resolve_precision
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.deterministic_data import deterministic_graph_dataset
from tests.utils import make_config

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them.
torch.set_num_threads(1)

BOUND = 2.0 ** -5          # the serving bound, atol and rtol
ROOT = Path(__file__).resolve().parents[1]
LJ = ROOT / "examples" / "LennardJones" / "LJ.json"


def _t(a):
    return torch.from_numpy(np.array(a))


def _tb(a):
    """numpy float32 -> torch bf16; other arrays as they are."""
    a = np.asarray(a)
    return _t(a).to(torch.bfloat16) if a.dtype == np.float32 else _t(a)


def _jb(a):
    a = np.asarray(a)
    return (jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32
            else jnp.asarray(a))


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of max(|got|, |want|, 2^-10)."""
    g = np.asarray(got.float() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    scale = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -10)
    ulp = np.exp2(np.floor(np.log2(scale)) - 7)
    return float((np.abs(g - w) / ulp).max()) if g.size else 0.0


def within_bound(got, want):
    g = np.asarray(got.float() if torch.is_tensor(got) else got, np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    return float((np.abs(g - w) - (BOUND + BOUND * np.abs(w))).max())


# ------------------------------------------------ precision resolution --

@pytest.mark.parametrize("env", [None, "bf16", "float32", "bfloat",
                                 "FP32", " BF16 "])
@pytest.mark.parametrize("cfg_dtype,override", [
    (None, None), ("bf16", None), ("bfloat16", "f32"), (None, "fp32"),
    ("float32", "bf16"), (None, "bf17"), ("int8", None), ("i8", None),
    ("bfloat", None), (None, "i8")])
def test_resolve_precision_matches_jax(monkeypatch, env, cfg_dtype,
                                       override):
    """override > HYDRAGNN_PRECISION (strict: a typo warns and falls
    through) > Architecture.dtype > float32, spellings canonicalized;
    int8 in Architecture.dtype warns and trains float32."""
    if env is None:
        monkeypatch.delenv("HYDRAGNN_PRECISION", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_PRECISION", env)
    assert resolve_precision(cfg_dtype, override) == \
        j_resolve(cfg_dtype, override)


def test_pass_through_dtype_names_raise():
    """The JAX package passes other dtype names through (float16,
    float64); so does the port's resolution (C12), and where a resolved
    one is used the port, which computes in float32 and bfloat16 only,
    raises naming ROADMAP A5: `check_ported_precision` and the step
    factories' `_resolve_compute_dtype`, from the config's dtype and from
    an override alike."""
    from hydragnn_tpu_torch.train.precision import check_ported_precision
    assert j_resolve("float16") == "float16"
    for name in ("float16", "float64", "half"):
        assert resolve_precision(name) == j_resolve(name)
        assert resolve_precision(None, name) == j_resolve(None, name)
        with pytest.raises(NotImplementedError, match="A5"):
            check_ported_precision(resolve_precision(name))
        with pytest.raises(NotImplementedError, match="A5"):
            tstep._resolve_compute_dtype(None, name)
    with pytest.raises(ValueError, match="serving-only"):
        tstep._resolve_compute_dtype(None, "int8")


@pytest.mark.parametrize("env", [None, "float32", "bf16", "bf166", "i8"])
@pytest.mark.parametrize("block", [None, "bf16", "fp32", "bfloat16"])
def test_resolve_serving_precision_matches_jax(monkeypatch, env, block):
    """Serving.precision and HYDRAGNN_SERVE_PRECISION (env over config,
    strict: a typo keeps the config's value) resolve as in the JAX
    package, int8 included; an engine built at int8 is the int8 tier,
    which needs calibration scales or reference samples to take them
    from, with the JAX engine's message (the JAX package acts on int8
    only in its engine path)."""
    if env is None:
        monkeypatch.delenv("HYDRAGNN_SERVE_PRECISION", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_SERVE_PRECISION", env)
    cfg = {"Serving": {"precision": block}}
    want = j_resolve_serving(cfg).precision
    assert resolve_serving(cfg).precision == want
    if want == "int8":
        with pytest.raises(ValueError, match="int8 serving needs "
                                             "calibration"):
            InferenceEngine(
                torch.nn.Linear(1, 1), types.SimpleNamespace(heads=[]),
                buckets=bucket_ladder(np.array([2]), np.array([1]), 1),
                proto_sample=tbatch.GraphSample(
                    x=np.zeros((2, 1), np.float32),
                    pos=np.zeros((2, 3), np.float32),
                    senders=np.array([0], np.int32),
                    receivers=np.array([1], np.int32)),
                compute_dtype=want, device="cpu")


# -------------------------------------------------- float32 accumulation --

def test_long_bf16_segment_sum_is_the_float32_sum_rounded_once():
    """One segment of 4096 bf16 rows (JAX tests/test_precision.py): the
    port's segment sum equals the float32 sum rounded to bf16 once, and
    the JAX package's, bitwise; a bf16 running sum would be far off."""
    rng = np.random.RandomState(0)
    data = _t(rng.rand(4096, 4).astype(np.float32)).to(torch.bfloat16)
    ids = torch.zeros(4096, dtype=torch.int32)
    out = tseg.segment_sum(data, ids, 1)
    assert out.dtype == torch.bfloat16
    want = data.float().sum(0).to(torch.bfloat16)
    assert torch.equal(out[0], want)
    jout = jseg.segment_sum(jnp.asarray(data.float().numpy()).astype(
        jnp.bfloat16), jnp.zeros(4096, jnp.int32), 1)
    assert bf16_ulps(out, jout) == 0.0
    truth = data.double().sum(0)
    assert float(((out[0].double() - truth).abs() / truth).max()) < 2 ** -8
    pooled = tseg.neighbor_sum(data.view(1, 4096, 4),
                               torch.ones(1, 4096, dtype=torch.bool))
    assert torch.equal(pooled[0], want)


# ------------------------------------------- bf16 plain kernel versions --

def _nbr_case(seed, n=60, k=9, f=12):
    rng = np.random.RandomState(seed)
    pi = rng.randn(n, f).astype(np.float32)
    pj = rng.randn(n, f).astype(np.float32)
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    mask[4] = False
    return pi, pj, idx, mask


def _edge_case(seed, n=60, e=400, f=12):
    rng = np.random.RandomState(seed)
    pi, pj = (rng.randn(n, f).astype(np.float32) for _ in range(2))
    send = rng.randint(0, n, e).astype(np.int32)
    recv = rng.randint(0, n, e).astype(np.int32)
    recv[recv == 5] = 6
    return pi, pj, send, recv, rng.rand(e) > 0.2


@pytest.mark.parametrize("dyadic", [False, True])
def test_bf16_nbr_aggregate_plain_matches_jax(dyadic):
    """nbr_aggregate_plain in bf16 against ops/segment.neighbor_aggregate
    (the JAX default route) within one ulp, exact outputs bitwise; against
    the Pallas kernel in interpret mode within 2^-5, but for std: the std
    of bf16 data, sqrt(bf16(sq / c) - bf16(mean^2)), is off the float64
    statistic by more than 2^-5 where the variance is small on either
    route (measured 0.12 here, as the JAX default route's), and the Pallas
    kernel's bf16 accumulators add to that (0.20), so the port's std is
    held nearer the float64 statistic of the same bf16 messages than the
    Pallas kernel's."""
    args = (tie_rich_neighbor_case(2, n=40, k=8, f=6, bf16_exact=True)
            if dyadic else _nbr_case(1))
    pi, pj, idx, mask = args
    got = nbr.nbr_aggregate_plain(*(_tb(a) for a in args))
    h = _jb(pi)[:, None, :] + _jb(pj)[jnp.asarray(idx)]
    want = jseg.neighbor_aggregate(h, jnp.asarray(mask))
    pallas = fused_neighbor_aggregate(_jb(pi), _jb(pj), jnp.asarray(idx),
                                      jnp.asarray(mask), 8, True)
    for name, g, w, p in zip(("mean", "min", "max", "std", "deg"), got,
                             want, pallas):
        assert g.dtype == torch.bfloat16, name
        if dyadic or name in ("min", "max", "deg"):
            assert bf16_ulps(g, w) == 0.0, name
        else:
            assert bf16_ulps(g, w) <= 1.0, name
        if name != "std":
            assert within_bound(g, p) <= 0.0, name
    hm = np.asarray(h.astype(jnp.float32), np.float64) * mask[:, :, None]
    c = np.maximum(mask.sum(1), 1)[:, None]
    mean = hm.sum(1) / c
    std = np.sqrt(np.maximum((hm * hm).sum(1) / c - mean ** 2, 0) + 1e-5)
    port_err = np.abs(got[3].double().numpy() - std).max()
    pallas_err = np.abs(np.asarray(pallas[3], np.float64) - std).max()
    assert port_err < pallas_err, (port_err, pallas_err)


@pytest.mark.parametrize("dyadic", [False, True])
def test_bf16_pna_edge_accumulators_plain_match_jax(dyadic):
    """The accumulators (s, sq, cnt, min, max) in bf16 against the JAX
    unfused accumulators (f32 sums cast back to bf16, as the Pallas
    kernel hands them back) within one ulp, exact ones bitwise; against
    the Pallas kernel in interpret mode within 2^-5; and the shared
    epilogue on top."""
    args = (tie_rich_edge_case(2, n=40, f=6, bf16_exact=True) if dyadic
            else _edge_case(1))
    n = 40 if dyadic else 60
    got = fused_mp.pna_edge_accumulators_plain(*(_tb(a) for a in args), n)
    jargs = [_jb(a) for a in args] + [n]
    want = jfm._pna_accums_reference(*jargs)
    pallas = jfm._fused_pna_accums(*jargs, True)
    for name, g, w, p in zip(("s", "sq", "cnt", "min", "max"), got, want,
                             pallas):
        assert g.dtype == torch.bfloat16, name
        if dyadic or name in ("cnt", "min", "max"):
            assert bf16_ulps(g, w) == 0.0, name
        else:
            assert bf16_ulps(g, w) <= 1.0, name
        assert within_bound(g, p) <= 0.0, name
    stats = tseg.pna_stats_epilogue(*got)
    jstats = jseg.pna_stats_epilogue(*want)
    for g, w in zip(stats, jstats):
        assert within_bound(g, w) <= 0.0


@pytest.mark.parametrize("dyadic", [False, True])
def test_bf16_filter_scatter_plain_matches_jax(dyadic):
    """filter_scatter_plain in bf16 (bf16 products, float32 sum, stored
    once) against segment_sum(h[send] * w) of the JAX package within one
    ulp (bitwise on multiples of 2^-3, whose products and sums are
    exact), against the Pallas kernel in interpret mode within 2^-5."""
    rng = np.random.RandomState(3)
    n, e, f = 50, 500, 8
    if dyadic:
        h, w = ((rng.randint(-16, 17, s) / 8).astype(np.float32)
                for s in ((n, f), (e, f)))
    else:
        h, w = (rng.randn(*s).astype(np.float32) for s in ((n, f), (e, f)))
    send = rng.randint(0, n, e).astype(np.int32)
    recv = rng.randint(0, n, e).astype(np.int32)
    mask = rng.rand(e) > 0.2
    args = (h, w, send, recv, mask)
    got = fused_mp.filter_scatter_plain(*(_tb(a) for a in args), n)
    jargs = [_jb(a) for a in args] + [n]
    want = jfm._filter_reference(*jargs)
    pallas = jfm.fused_filter_scatter(*jargs, True)
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, want) <= (0.0 if dyadic else 1.0)
    assert within_bound(got, pallas) <= 0.0


# ------------------------------------------------------- bf16 forwards --

@pytest.fixture(scope="module")
def lattice_pna():
    """The JAX tests/test_precision.py PNA case: deterministic BCC
    lattices, the tests' PNA config, Flax weights from a seed."""
    jsamples = deterministic_graph_dataset(num_configs=12)
    samples = [tbatch.GraphSample(x=s.x, pos=s.pos, senders=s.senders,
                                  receivers=s.receivers, y_graph=s.y_graph)
               for s in jsamples]
    cfg = make_config("PNA")
    jc = jcfg.update_config(copy.deepcopy(cfg), jsamples)
    tc = tcfg.update_config(copy.deepcopy(cfg), samples)
    jm = jcfg.build_model_config(jc)
    jmodel = j_create_model(jm)
    jb = jbatch.collate(jsamples[:8], bucket=jbatch.BucketSpec(multiple=64))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.device_get(dict(j_init_params(jmodel, jb))))
    return jsamples, samples, jmodel, jm, tcfg.build_model_config(tc), \
        variables


def _port_model(mcfg, variables):
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return model


@pytest.mark.parametrize("dense", [False, True])
def test_bf16_pna_forward_matches_jax(lattice_pna, dense):
    """The bf16 forward (make_forward_fn) of the lattice PNA, port vs JAX
    on both layouts, within 2^-5 on the real graphs; and within 2^-5 of
    the float32 forward (the serving bound)."""
    jsamples, samples, jmodel, jm, tm, variables = lattice_pna
    jb = jbatch.collate(jsamples[:8], bucket=jbatch.BucketSpec(multiple=64))
    tb = tbatch.collate(samples[:8], bucket=tbatch.BucketSpec(multiple=64))
    if dense:
        jb, tb = jbatch.with_neighbor_format(jb), tbatch.with_neighbor_format(
            tb)
    want, _ = jstep.make_forward_fn(jmodel, jm, "bfloat16")(variables, jb)
    model = _port_model(tm, variables)
    with torch.no_grad():
        got, _ = tstep.make_forward_fn(model, tm, "bfloat16")(tb)
        f32, _ = tstep.make_forward_fn(model, tm, "float32")(tb)
    real = tb.graph_mask.numpy()
    assert got[0].dtype == torch.float32
    assert within_bound(got[0][real], np.asarray(want[0])[real]) <= 0.0
    assert within_bound(got[0][real], f32[0][real].numpy()) <= 0.0
    assert not torch.equal(got[0], f32[0])


def test_bf16_gaussian_basis_matches_jax():
    """SchNet's Gaussian smearing of bf16 distances equals the JAX
    package's bitwise, but where XLA flushes a subnormal result (below
    2^-126) to zero: its centres are the float32 linspace rounded once
    (torch.linspace in bf16 steps in bf16, and differently on the card)."""
    from hydragnn_tpu.ops.basis import gaussian_basis as j_basis
    from hydragnn_tpu_torch.ops.basis import gaussian_basis
    d = np.random.RandomState(5).rand(300).astype(np.float32) * 2.5
    for n in (32, 50):
        got = gaussian_basis(_tb(d), 0.0, 2.0, n)
        want = j_basis(_jb(d), 0.0, 2.0, n)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        normal = np.abs(want) >= 2.0 ** -126
        assert np.array_equal(got[normal], want[normal]), n
        assert np.abs(got[~normal]).max() < 2.0 ** -126, n


def test_bf16_schnet_forward_matches_jax():
    """LJ SchNet (LJ.json at 8 wide) in bf16, port vs JAX, node energies
    on real atoms within 2^-5. The port computes every layer in bf16,
    kernel 4 included; the JAX stack widens to float32 after its first
    shifted softplus (ROADMAP C)."""
    from examples.LennardJones.lj_data import generate_lj_dataset
    with open(LJ) as fh:
        base = json.load(fh)
    base["NeuralNetwork"]["Architecture"].update(
        hidden_dim=8, num_filters=8, num_gaussians=8,
        neighbor_format=False)
    base["NeuralNetwork"]["Architecture"]["output_heads"]["node"][
        "dim_headlayers"] = [8, 8]
    samples = lj_configurations(3, seed=9)
    jsamples = generate_lj_dataset(3, seed=9)
    tc = tcfg.update_config(copy.deepcopy(base), samples)
    jc = jcfg.update_config(copy.deepcopy(base), jsamples)
    jm = jcfg.build_model_config(jc)
    jmodel = j_create_model(jm)
    tb = tbatch.collate(samples)
    jb = jbatch.collate(jsamples)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.device_get(dict(j_init_params(jmodel, jb, seed=4))))
    want, _ = jstep.make_forward_fn(jmodel, jm, "bfloat16")(variables, jb)
    model = _port_model(tcfg.build_model_config(tc), variables)
    with torch.no_grad():
        got, _ = tstep.make_forward_fn(model, model.cfg, "bfloat16")(tb)
    real = tb.node_mask.numpy()
    assert within_bound(got[0][real], np.asarray(want[0])[real]) <= 0.0


# ---------------------------------------------------- bf16 serving ------

def test_bf16_engine_breadcrumbs_and_batched_equals_single(lattice_pna):
    """A bf16 engine: futures carry parity "tolerance" with rtol = atol =
    2^-5 and stats() names it; each request's outputs equal the same
    sample's single forward on its bucket bitwise; within the bound of
    a float32 engine, whose futures advertise "bitwise"."""
    _, samples, _, _, tm, variables = lattice_pna
    engines = {}
    try:
        for dt in ("float32", "bf16"):
            engines[dt] = InferenceEngine(
                _port_model(tm, variables), tm, reference_samples=samples,
                max_batch_size=4, max_wait_ms=50.0, num_buckets=1,
                compute_dtype=dt, device="cpu")
        futs = {dt: [e.submit(s) for s in samples[:8]]
                for dt, e in engines.items()}
        res = {dt: [f.result(timeout=300) for f in fs]
               for dt, fs in futs.items()}
        assert all(f.parity == "bitwise" and f.parity_rtol == 0.0
                   for f in futs["float32"])
        assert all(f.parity == "tolerance"
                   and f.parity_rtol == SERVE_REDUCED_RTOL == BOUND
                   and f.parity_atol == SERVE_REDUCED_ATOL == BOUND
                   for f in futs["bf16"])
        stats = engines["bf16"].stats()
        assert (stats["compute_dtype"], stats["parity"]) == ("bfloat16",
                                                              "tolerance")
        for i, fut in enumerate(futs["bf16"]):
            single = engines["bf16"].forward_single(samples[i],
                                                    bucket=fut.bucket)
            for a, b in zip(res["bf16"][i], single):
                assert np.array_equal(a, b)
            for a, b in zip(res["bf16"][i], res["float32"][i]):
                assert within_bound(torch.from_numpy(a), b) <= 0.0
    finally:
        for e in engines.values():
            e.shutdown()


# ---------------------------------------------------- bf16 training -----

STEP_BOUND = 2.0 ** -6    # first bf16 SGD step's change, worst tensor


def _after_aggregations(path, num_conv):
    """A parameter whose gradient passes no neighbour aggregation's
    backward: the heads, the last feature norm, and the kernels after the
    last convolution's aggregation (its biases feed a batch norm, so
    their gradients are 0 but for rounding)."""
    top, *rest = path
    if top == "graph_shared" or top.startswith("head_") \
            or top == f"feature_norm_{num_conv - 1}":
        return True
    return (top == f"conv_{num_conv - 1}" and rest[0] in ("lin", "post_nn")
            and rest[-1] == "kernel")


def test_bf16_sgd_steps_match_jax_and_keep_float32_masters(lattice_pna):
    """3 bf16 SGD steps from the same Flax variables: each step's loss
    within 2^-5 relative of the JAX package's bf16 step, nonfinite_steps
    0, the parameters and running statistics float32 afterwards and
    within the bound of JAX's.

    The first step's parameter change (w_after - w_before), port vs JAX
    at bf16, relative L2 per tensor: at most STEP_BOUND on the worst of
    the tensors whose gradient passes no neighbour aggregation's
    backward (measured 4.3e-3; bitwise on the heads). A zero change
    (1.0) and the port's float32 step (0.39 on conv_1.post_nn) fail that
    bound. The tensors before an aggregation are held by the losses only:
    the port's VJPs sum in float32 and JAX's autodiff in bf16, and on the
    lattice, where neighbourhoods repeat and the std aggregator's var is
    0 but for rounding, both packages' bf16 changes there miss float32's
    by 0.3 to 10 times its size (PERF.md)."""
    from hydragnn_tpu_torch.utils.weights import export_jax_variables
    jsamples, samples, jmodel, jm, tm, variables = lattice_pna
    train_cfg = {"Optimizer": {"type": "SGD", "learning_rate": 0.02}}
    tx = jopt.select_optimizer(train_cfg)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jtrain = jstep.make_train_step(jmodel, jm, tx, "mse", donate=False,
                                   compute_dtype="bfloat16")
    model = _port_model(tm, variables)
    ptx = topt.select_optimizer(train_cfg)
    state = tstep.TrainState.create(model, ptx)
    train = tstep.make_train_step(model, tm, ptx, "mse",
                                  compute_dtype="bf16")

    def leaves(tree):
        return [np.asarray(x, np.float64)
                for x in jax.tree_util.tree_leaves(tree)]
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(variables["params"])[0]]
    held = [i for i, p in enumerate(paths)
            if _after_aggregations(p, tm.num_conv_layers)]
    before = leaves(variables["params"])
    for i in range(3):
        chunk = slice(4 * i, 4 * i + 4)
        jb = jbatch.collate(jsamples[chunk], n_node=128, n_edge=2048,
                            n_graph=5)
        tb = tbatch.collate(samples[chunk], n_node=128, n_edge=2048,
                            n_graph=5)
        jstate, jmet = jtrain(jstate, jb)
        state, met = train(state, tb)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=BOUND)
        assert float(met["nonfinite_steps"]) == 0.0
        if i == 0:
            want = leaves(jstate.params)
            first = leaves(export_jax_variables(model)["params"])
            f32_model = _port_model(tm, variables)
            f32_tx = topt.select_optimizer(train_cfg)
            tstep.make_train_step(f32_model, tm, f32_tx, "mse",
                                  compute_dtype="float32")(
                tstep.TrainState.create(f32_model, f32_tx), tb)
            f32 = leaves(export_jax_variables(f32_model)["params"])

    def worst_change_gap(got):
        return max(np.linalg.norm((got[k] - before[k]) - (want[k] - before[k]))
                   / np.linalg.norm(want[k] - before[k]) for k in held)
    assert len(held) >= 10
    assert worst_change_gap(first) <= STEP_BOUND
    assert worst_change_gap(before) > STEP_BOUND      # no update at all
    assert worst_change_gap(f32) > STEP_BOUND         # a float32 step
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32, k
    got = export_jax_variables(model)
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves(jstate.params if coll == "params"
                                         else jstate.batch_stats)
        assert all(np.asarray(w).dtype == np.float32 for w in want)
        flat = jax.tree_util.tree_leaves(got[coll])
        assert len(flat) == len(want)
        for g, w in zip(flat, want):
            assert within_bound(torch.from_numpy(g), w) <= 0.0


def test_nonfinite_watchdog_counts_a_nan_batch_at_bf16(lattice_pna):
    """The watchdog at bf16: 0 on a healthy batch, 1 when a NaN input
    feature makes the loss and gradients non-finite."""
    _, samples, _, _, tm, variables = lattice_pna
    model = _port_model(tm, variables)
    tx = topt.select_optimizer({"Optimizer": {"type": "AdamW",
                                              "learning_rate": 1e-3}})
    state = tstep.TrainState.create(model, tx)
    step = tstep.make_train_step(model, tm, tx, compute_dtype="bfloat16")
    batch = tbatch.collate(samples[:4])
    state, met = step(state, batch)
    assert float(met["nonfinite_steps"]) == 0.0
    x = batch.x.clone()
    x[0, 0] = float("nan")
    _, met = step(state, batch.replace(x=x))
    assert float(met["nonfinite_steps"]) == 1.0


# ---------------------------------- run_prediction's loop precision (C6) --

@pytest.fixture(scope="module", params=["PNA", "DimeNet"])
def loop_case(request):
    """Lattice data, a tests/utils.make_config model and seeded Flax
    variables, with JAX's model and TrainState on the same weights."""
    from hydragnn_tpu.train.optimizer import select_optimizer as j_select
    from hydragnn_tpu.train.train_step import TrainState as JState
    from hydragnn_tpu_torch.utils.weights import random_flax_variables
    model_type = request.param
    jsamples = deterministic_graph_dataset(num_configs=16)
    samples = [tbatch.GraphSample(x=s.x, pos=s.pos, senders=s.senders,
                                  receivers=s.receivers, y_graph=s.y_graph)
               for s in jsamples]
    cfg = make_config(model_type, hidden_dim=8, num_conv_layers=2)
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 4

    def split(s):
        return s[:10], s[10:13], s[13:]
    tc = tcfg.update_config(copy.deepcopy(cfg), *split(samples))
    variables = random_flax_variables(
        create_model(tcfg.build_model_config(tc), device="cpu"), 3)
    jc = jcfg.update_config(copy.deepcopy(cfg), *split(jsamples))
    jmodel = j_create_model(jcfg.build_model_config(jc))
    jstate = JState.create(
        jax.tree_util.tree_map(jnp.asarray, {
            "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {})}),
        j_select(cfg["NeuralNetwork"]["Training"]))
    return (cfg, split(samples), split(jsamples), variables, jmodel,
            jstate)


def _loop_predictions(case, serving, env, monkeypatch):
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu_torch import run_prediction
    cfg, splits, jsplits, variables, jmodel, jstate = case
    for name in ("HYDRAGNN_PRECISION", "HYDRAGNN_SERVE_PRECISION",
                 "HYDRAGNN_SERVE"):
        monkeypatch.delenv(name, raising=False)
    if env is not None:
        monkeypatch.setenv("HYDRAGNN_PRECISION", env)
    cfg = copy.deepcopy(cfg)
    if serving is not None:
        cfg["Serving"] = {"precision": serving}
    port = run_prediction(copy.deepcopy(cfg), datasets=splits,
                          variables=variables, serve=False, device="cpu")
    want = j_run_prediction(copy.deepcopy(cfg), datasets=jsplits,
                            state=jstate, model=jmodel, serve=False)
    return port, want


@pytest.mark.parametrize("env", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("serving", [None, "float32", "bfloat16"])
def test_run_prediction_loop_computes_at_the_train_side_precision(
        loop_case, monkeypatch, serving, env):
    """C6: run_prediction's loop (serve=False; DimeNet's only route)
    ignores Serving.precision and computes at HYDRAGNN_PRECISION, else
    Architecture.dtype, else float32, as the JAX package's eval-step loop
    does: bitwise the port's own loop with no Serving block, and within
    rtol 1e-4 / atol 1e-5 of JAX's at float32, within 2^-5 at bf16."""
    (trues, preds), (jtrues, jpreds) = _loop_predictions(
        loop_case, serving, env, monkeypatch)
    _, base = _loop_predictions(loop_case, None, env, monkeypatch)[0]
    for p, b in zip(preds, base):
        np.testing.assert_array_equal(p, b)
    for t, jt in zip(trues, jtrues):
        np.testing.assert_array_equal(t, np.asarray(jt))
    for p, jp in zip(preds, jpreds):
        if env == "bfloat16":
            assert within_bound(p, jp) <= 0.0
        else:
            np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-4,
                                       atol=1e-5)


def test_int8_without_the_engine_completes_at_the_train_side_precision(
        loop_case, monkeypatch):
    """Serving.precision "int8" with the engine off completes at the
    train-side precision, as in the JAX package (which acts on int8 only
    in its engine path); with the engine on, the engine is the int8 tier
    (tests/test_torch_quant.py holds its outputs), whose results are
    finite and not the loop's float32 ones."""
    from hydragnn_tpu_torch import run_prediction
    (trues, preds), (_, jpreds) = _loop_predictions(loop_case, "int8", None,
                                                    monkeypatch)
    _, base = _loop_predictions(loop_case, None, None, monkeypatch)[0]
    for p, b, jp in zip(preds, base, jpreds):
        np.testing.assert_array_equal(p, b)
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-4, atol=1e-5)
    cfg, splits, _, variables, _, _ = loop_case
    if cfg["NeuralNetwork"]["Architecture"]["model_type"] == "DimeNet":
        return      # DimeNet always takes the loop
    cfg = copy.deepcopy(cfg)
    cfg["Serving"] = {"precision": "int8"}
    _, served = run_prediction(cfg, datasets=splits, variables=variables,
                               serve=True, device="cpu")
    for p, b in zip(served, base):
        assert p.shape == b.shape and np.isfinite(p).all()
        assert not np.array_equal(p, b)
