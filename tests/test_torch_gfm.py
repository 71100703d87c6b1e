"""Multi-dataset GFM mixture training in the port (hydragnn_tpu_torch:
parallel/multidataset.GfmMixtureLoader, train/gfm.py, telemetry/gfm.py,
utils/envflags.resolve_gfm, train/loss.head_loss_mask, the GFM members of
graphs/synthetic.py and the driver examples/gfm.py) against the JAX
package's on the CPU, on the same numpy-seeded members:

* the knobs, the mixture plan (quotas, order, fingerprint strings), the
  validation messages, every field of every batch (world 1; rank r of W
  against row r of JAX's W-shard plan; weight schedules) and the member
  generator: bitwise;
* one SGD step of the head-masked step: within rtol 1e-5 / atol 1e-6;
  the head-masked step on one dyadic member with one-hot head weights:
  bitwise the plain step;
* the epoch accumulator and the registry's gauges: exact;
* the compositions: SPMD with ZeRO over two gloo ranks and the 1F1B
  pipeline: heads whose member is absent read exactly 0.0;
* the driver's 2-epoch run against examples/gfm/train_gfm.py's
  result.json (the same initial weights): plan_fp equal, epoch 0's train
  loss within rtol 1e-4, epoch 1's within DRIVER_LATER_RTOL.
"""
import copy
import dataclasses
import json
import logging
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples.gfm import gfm_data as jdata
from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.parallel import multidataset as jmd
from hydragnn_tpu.train import gfm as jgfm
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import stack_batches, unstack_batch
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs import synthetic as tsyn
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.parallel import multidataset as tmd
from hydragnn_tpu_torch.train import gfm as tgfm
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import step_graphs
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.test_torch_train import assert_tree_close, numpy_tree
from tests.torch_parallel_worker import spawn_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GFM_CONFIG = ROOT / "examples" / "gfm" / "gfm_mixture.json"
SIZES = (12, 8, 10)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# the driver's epoch-1 train loss against JAX's (two CPU float32 runs
# from the same weights, which add in other orders): 3.6e-7 apart, held
# at 1e-4. Its validation losses are not held against JAX: eval-mode
# BatchNorm after a dozen steps makes them hundreds of times the train
# loss, and the two float32 runs part there by 2-13 % at epoch 0 (Adam;
# 6e-6-3e-4 under SGD), as they do by 2e-2 in the train loss by epoch 2
DRIVER_LATER_RTOL = 1e-4
GFM_ENVS = ("HYDRAGNN_GFM_MIXTURE", "HYDRAGNN_GFM_HEAD_WEIGHTS")
FIELDS = [f.name for f in dataclasses.fields(tbatch.GraphBatch)]


@pytest.fixture
def clean_env(monkeypatch):
    for name in GFM_ENVS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _members(sizes=SIZES, seed=0, dyadic=False):
    """(JAX members, port members): the example's generator in each
    package."""
    return (jdata.build_members(sizes=sizes, seed=seed, dyadic=dyadic),
            tsyn.build_members(sizes=sizes, seed=seed, dyadic=dyadic))


def _config(hidden=8, layers=2):
    with open(GFM_CONFIG) as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=hidden, num_conv_layers=layers)
    arch["output_heads"]["graph"].update(dim_sharedlayers=hidden,
                                         dim_headlayers=[hidden, hidden])
    return cfg


def _model_configs(jm, tm, cfg=None):
    cfg = cfg or _config()
    jall = [s for v in jm.values() for s in v]
    tall = [s for v in tm.values() for s in v]
    jc = jcfg.update_config(copy.deepcopy(cfg), jall)
    tc = tcfg.update_config(copy.deepcopy(cfg), tall)
    return jcfg.build_model_config(jc), tcfg.build_model_config(tc), tc


def assert_batch_equal(tb, jb):
    """Every field of a port batch bitwise the JAX batch's."""
    for f in FIELDS:
        a, w = getattr(tb, f), getattr(jb, f, None)
        if w is None:
            assert a is None, f
            continue
        w = np.asarray(w)
        assert a.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(a.numpy(), w, err_msg=f)


def _jax_view(tb):
    """The JAX GraphBatch of a port batch (the same values)."""
    return jbatch.GraphBatch(**{
        f: None if getattr(tb, f) is None else jnp.asarray(
            getattr(tb, f).numpy())
        for f in FIELDS if f in jbatch.GraphBatch.__dataclass_fields__})


# ------------------------------------------------------------- knobs --
@pytest.mark.parametrize("how", ["default", "config", "env_over_config",
                                 "typo", "non_positive"])
def test_resolve_gfm_matches_jax(clean_env, caplog, how):
    """resolve_gfm: defaults (None, None), the Training.Gfm block, the env
    over the block, and a malformed or non-positive env value, which
    warns with JAX's words naming the variable and keeps the block's."""
    from hydragnn_tpu.utils.envflags import resolve_gfm as j_resolve
    from hydragnn_tpu_torch.utils.envflags import resolve_gfm
    block = None if how == "default" else {
        "Gfm": {"mixture": {"a": 2.0, "b": 1.0}, "head_weights": [1.0, 0.5]}}
    env = {"env_over_config": ("a:3,b", "0.25,0.75"),
           "typo": ("a:zero", "1.0,nope"),
           "non_positive": ("a:-1", "inf")}.get(how)
    if env is not None:
        clean_env.setenv("HYDRAGNN_GFM_MIXTURE", env[0])
        clean_env.setenv("HYDRAGNN_GFM_HEAD_WEIGHTS", env[1])
    with caplog.at_level(logging.WARNING):
        want = j_resolve(block)
        got = resolve_gfm(block)
    assert got == want
    if how == "env_over_config":
        assert got == ({"a": 3.0, "b": 1.0}, (0.25, 0.75))
    port = [r.getMessage() for r in caplog.records
            if r.name == "hydragnn_tpu_torch"]
    ref = [r.getMessage() for r in caplog.records
           if r.name == "hydragnn_tpu"]
    assert port == ref
    assert bool(port) == (how in ("typo", "non_positive"))
    if port:
        assert "HYDRAGNN_GFM_MIXTURE" in port[0]
        assert "HYDRAGNN_GFM_HEAD_WEIGHTS" in port[1]


# --------------------------------------------------- the mixture plan --
@pytest.mark.parametrize("sizes,weights,total", [
    ([12, 8, 10], [12, 8, 10], None),
    ([12, 8, 10], [1.0, 1.0, 2.0], 20),
    ([100, 1, 1], [100.0, 0.001, 0.001], 10),
    ([5, 7], [3.0, 1.0], 1),
    ([4, 4], [1.0, 2.5], 30),
])
def test_mixture_quotas_and_order_match_jax(sizes, weights, total):
    q = tmd.mixture_quotas(sizes, weights, total)
    assert q == jmd.mixture_quotas(sizes, weights, total)
    for seed, epoch in ((0, 0), (7, 3), (2 ** 31 + 5, 1)):
        got = tmd.mixture_order(sizes, q, seed, epoch)
        want = jmd.mixture_order(sizes, q, seed, epoch)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _loaders(jm, tm, batch, **kw):
    jl = jmd.GfmMixtureLoader(jm, batch, async_workers=0, **kw)
    tl = tmd.GfmMixtureLoader(tm, batch, **kw)
    return jl, tl


W = {"alpha": 1.0, "beta": 1.0, "gamma": 2.0}


@pytest.mark.parametrize("case", ["sizes", "weights", "schedule",
                                  "epoch_quota", "lookahead"])
def test_mixture_loader_batches_match_jax(case):
    """World 1: every field of every batch (dataset_id included), the
    selections, the step counts, the padding statistics, the mixture
    fractions and the plan fingerprint, bitwise over two epochs."""
    jm, tm = _members()
    kw = {"sizes": {}, "weights": dict(weights=W),
          "schedule": dict(weight_schedule=[W, {"gamma": 8.0}]),
          "epoch_quota": dict(weights=W, epoch_quota=40),
          "lookahead": dict(pack_lookahead=4)}[case]
    jl, tl = _loaders(jm, tm, 6, seed=7, **kw)
    assert tl.member_names == jl.member_names
    assert (tl.n_node, tl.n_edge, tl.n_graph) == (jl.n_node, jl.n_edge,
                                                  jl.n_graph)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        assert tl._selections() == jl._selections()
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for b, jb in zip(got, want):
            assert_batch_equal(b, jb)
        assert tl.padding_stats() == jl.padding_stats()
        assert tl.mixture_fractions() == jl.mixture_fractions()
        assert tl.global_plan_fingerprint() == jl.global_plan_fingerprint()


@pytest.mark.parametrize("world", [2, 3])
def test_rank_slice_is_the_row_of_jax_stacked_plan(world):
    """Rank r of W (pack_rank r, pack_nproc W, the per-rank batch) takes
    row r of JAX's W-shard plan: every field bitwise, the same step count
    and the same fingerprint string on every rank."""
    jm, tm = _members()
    jl = jmd.GfmMixtureLoader(jm, 3 * world, seed=5, num_shards=world,
                              weights=W, async_workers=0)
    ranks = [tmd.GfmMixtureLoader(tm, 3, seed=5, pack_rank=r,
                                  pack_nproc=world, weights=W)
             for r in range(world)]
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        for r in ranks:
            r.set_epoch(epoch)
        want = list(jl)
        got = [list(r) for r in ranks]
        for r, batches in enumerate(got):
            assert len(batches) == len(want)
            for b, jb in zip(batches, want):
                assert_batch_equal(b, jax.tree_util.tree_map(
                    lambda a, r=r: np.asarray(a)[r], jb))
            assert ranks[r].global_plan_fingerprint() == \
                jl.global_plan_fingerprint()


def test_constant_schedule_is_the_unscheduled_plan():
    """A one-entry schedule draws the unscheduled plan at every epoch
    (bitwise), and its fingerprint differs from it, as in JAX."""
    _, tm = _members()
    plain = tmd.GfmMixtureLoader(tm, 6, seed=7, weights=W)
    const = tmd.GfmMixtureLoader(tm, 6, seed=7, weight_schedule=[W])
    for epoch in (0, 1, 3):
        plain.set_epoch(epoch)
        const.set_epoch(epoch)
        assert plain._selections() == const._selections()
        for a, b in zip(plain, const):
            for f in FIELDS:
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                assert x is None or torch.equal(x, y), f
    assert const.global_plan_fingerprint() != \
        plain.global_plan_fingerprint()


def _raises(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value), str(ei.value)


@pytest.mark.parametrize("case", [
    "unknown_weight", "head_count", "label_width", "task_weights",
    "weights_and_schedule", "empty_schedule", "empty_member",
    "unknown_in_schedule", "multidataset_width"])
def test_validation_messages_match_jax(case):
    """Each mixture / head mismatch raises JAX's error with JAX's
    message, naming the dataset and the head."""
    jm, tm = _members()
    jmc, tmc, _ = _model_configs(jm, tm)

    def make(pkg, members, mcfg):
        two = {n: members[n] for n in ("alpha", "beta")}
        if case == "unknown_weight":
            return lambda: pkg.GfmMixtureLoader(members, 6,
                                                weights={"delta": 2.0})
        if case == "head_count":
            return lambda: pkg.GfmMixtureLoader(two, 6, cfg=mcfg)
        if case == "label_width":
            narrow = dict(members, gamma=[
                s for s in members["gamma"][:4]])
            for s in narrow["gamma"]:
                s.y_graph = s.y_graph[:1]
            return lambda: pkg.GfmMixtureLoader(narrow, 6, cfg=mcfg)
        if case == "task_weights":
            bad = dataclasses.replace(mcfg, task_weights=(1.0,))
            return lambda: pkg.validate_member_heads(
                bad, ("alpha", "beta", "gamma"), list(members.values()),
                per_dataset_heads=True)
        if case == "weights_and_schedule":
            return lambda: pkg.GfmMixtureLoader(members, 6, weights=W,
                                                weight_schedule=[W])
        if case == "empty_schedule":
            return lambda: pkg.GfmMixtureLoader(members, 6,
                                                weight_schedule=[])
        if case == "empty_member":
            return lambda: pkg.GfmMixtureLoader(dict(members, beta=[]), 6)
        if case == "unknown_in_schedule":
            return lambda: pkg.GfmMixtureLoader(
                members, 6, weight_schedule=[W, {"delta": 2.0}])
        narrow = dict(members, beta=[s for s in members["beta"][:4]])
        for s in narrow["beta"]:
            s.y_graph = s.y_graph[:2]
        return lambda: pkg.MultiDatasetLoader(narrow, batch_size=8,
                                              num_shards=4, cfg=mcfg)
    jm2, tm2 = _members()
    want = _raises(make(jmd, jm2, jmc))
    got = _raises(make(tmd, tm2, tmc))
    assert got == want
    assert got[0] is ValueError


def test_gfm_members_match_jax_bitwise():
    for dyadic in (False, True):
        jm, tm = _members(sizes=(5, 4, 6), seed=3, dyadic=dyadic)
        assert list(tm) == list(jm) == [n for n, _ in tsyn.MEMBER_SPECS]
        for name in jm:
            for js, ts in zip(jm[name], tm[name]):
                for f in ("x", "pos", "senders", "receivers", "y_graph"):
                    a, w = getattr(ts, f), getattr(js, f)
                    assert a.dtype == w.dtype, f
                    np.testing.assert_array_equal(a, w, err_msg=f)
        jtr, jva = jdata.split_members(jm)
        ttr, tva = tsyn.split_members(tm)
        assert {n: len(v) for n, v in ttr.items()} == \
            {n: len(v) for n, v in jtr.items()}
        assert {n: len(v) for n, v in tva.items()} == \
            {n: len(v) for n, v in jva.items()}


def test_unported_loader_knobs_raise_naming_a10():
    _, tm = _members()
    tmd.GfmMixtureLoader(tm, 6, async_workers=None, cache_mb=0)
    for kw in (dict(async_workers=2), dict(cache_mb=64)):
        with pytest.raises(NotImplementedError, match="A10"):
            tmd.GfmMixtureLoader(tm, 6, **kw)


# ---------------------------------------------------- the batch field --
def test_dataset_id_rides_every_batch_route_and_keys_its_own_capture():
    """collate leaves dataset_id None; replace, .to, stack_batches and
    unstack_batch carry it; a batch with it has its own capture key and
    static slot, which the slot fill copies it into; two plain batches of
    one shape share one key."""
    _, tm = _members()
    loader = tmd.GfmMixtureLoader(tm, 6, seed=1)
    loader.set_epoch(0)
    b = next(iter(loader))
    plain = tbatch.collate(tm["alpha"][:2], n_node=loader.n_node,
                           n_edge=loader.n_edge, n_graph=loader.n_graph)
    assert plain.dataset_id is None
    assert b.dataset_id.dtype == torch.int32
    assert b.dataset_id.shape == (loader.n_graph,)
    assert torch.equal(b.to("cpu").dataset_id, b.dataset_id)
    stacked = stack_batches([b, b])
    assert stacked.dataset_id.shape == (2, loader.n_graph)
    for part in unstack_batch(stacked):
        assert torch.equal(part.dataset_id, b.dataset_id)
    sig_plain = step_graphs.batch_signature(plain)
    sig_mix = step_graphs.batch_signature(b)
    other = tbatch.collate(tm["beta"][:2], n_node=loader.n_node,
                           n_edge=loader.n_edge, n_graph=loader.n_graph)
    assert step_graphs.batch_signature(other) == sig_plain
    assert ("dataset_id", None) in sig_plain
    assert ("dataset_id", (loader.n_graph,), torch.int32) in sig_mix
    assert sig_plain != sig_mix
    slot = tbatch.GraphBatch(**{
        f: None if getattr(b, f) is None else torch.zeros_like(
            getattr(b, f)) for f in FIELDS})
    step_graphs.fill(slot, b)
    assert torch.equal(slot.dataset_id, b.dataset_id)


def test_head_loss_mask_matches_jax():
    """Graph heads narrow by dataset_id == ih, node heads by the node's
    graph's id; padding's -1 matches no head; no dataset_id leaves the
    plain masks."""
    from hydragnn_tpu.config.config import HeadConfig as JHead
    from hydragnn_tpu.train.loss import head_loss_mask as j_mask
    from hydragnn_tpu_torch.config.config import HeadConfig
    from hydragnn_tpu_torch.train.loss import head_loss_mask
    arrays = dict(graph_mask=np.array([True, True, True, False]),
                  node_mask=np.array([True, True, True, True, False]),
                  node_graph=np.array([0, 0, 1, 2, 3], np.int32),
                  dataset_id=np.array([0, 1, 0, -1], np.int32))
    for ids in (arrays["dataset_id"], None):
        jb = type("B", (), {k: (None if v is None else jnp.asarray(v))
                            for k, v in dict(arrays,
                                             dataset_id=ids).items()})
        tb = type("B", (), {k: (None if v is None else torch.from_numpy(v))
                            for k, v in dict(arrays,
                                             dataset_id=ids).items()})
        for kind in ("graph", "node"):
            for ih in range(3):
                got = head_loss_mask(tb, ih, HeadConfig(
                    head_type=kind, output_dim=1, offset=0))
                want = j_mask(jb, ih, JHead(head_type=kind, output_dim=1,
                                            offset=0))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- steps --
def _jax_and_port_models(jmc, tmc, batch, seed=2):
    jmodel = j_create_model(jmc)
    variables = numpy_tree(j_init_params(jmodel, _jax_view(batch),
                                         seed=seed))
    model = create_model(tmc, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return jmodel, variables, model


def test_gfm_sgd_step_matches_jax():
    """make_gfm_eval_step, then one SGD step of make_gfm_train_step, on a
    three-member mixture batch (GIN, per-head weights) against JAX's from
    the same weights: the eval metrics, the step's loss and each
    task_<i>, and every updated parameter and running statistic within
    rtol 1e-5 / atol 1e-6."""
    jm, tm = _members()
    jmc, tmc, _ = _model_configs(jm, tm)
    loader = tmd.GfmMixtureLoader(tm, 8, cfg=tmc, seed=3)
    loader.set_epoch(0)
    batch = next(b for b in loader
                 if len(set(b.dataset_id[b.graph_mask].tolist())) == 3)
    jmodel, variables, model = _jax_and_port_models(jmc, tmc, batch)
    hw = (1.0, 0.5, 2.0)
    tx = optax.sgd(0.05)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    ptx = topt.Optimizer("SGD", learning_rate=0.05, momentum=0.0)
    state = tstep.TrainState.create(model, ptx)
    jev = jgfm.make_gfm_eval_step(jmodel, jmc, head_weights=hw,
                                  num_datasets=3)
    tev = tgfm.make_gfm_eval_step(model, tmc, head_weights=hw,
                                  num_datasets=3)
    jm_, _ = jev(jstate, _jax_view(batch))
    tm_, _ = tev(state, batch)
    assert sorted(tm_) == sorted(jm_)
    for k in jm_:
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                   err_msg=k, **STEP_TOL)
    jtrain = jgfm.make_gfm_train_step(jmodel, jmc, tx, head_weights=hw,
                                      num_datasets=3, donate=False)
    jstate, jmet = jtrain(jstate, _jax_view(batch))
    train = tgfm.make_gfm_train_step(model, tmc, ptx, head_weights=hw,
                                     num_datasets=3)
    state, met = train(state, batch)
    assert sorted(met) == sorted(jmet) == [
        "loss", "nonfinite_steps", "task_0", "task_1", "task_2"]
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   err_msg=k, **STEP_TOL)
    got = export_jax_variables(model)
    assert_tree_close(got["params"], numpy_tree(jstate.params), STEP_TOL)
    assert_tree_close(got["batch_stats"], numpy_tree(jstate.batch_stats),
                      STEP_TOL)


def test_head_masked_step_is_the_plain_step_bitwise():
    """JAX's test_head_masked_step_bitwise_vs_plain contract: on a batch
    of one dyadic member d with one-hot head weights, the head-masked
    step (dataset_id set) and the plain multihead step give bitwise
    equal parameters, running statistics and head-d loss."""
    _, tm = _members(sizes=(6, 6, 6), seed=1, dyadic=True)
    _, tmc, _ = _model_configs(*_members(sizes=(6, 6, 6), seed=1,
                                         dyadic=True))
    for d, name in enumerate(sorted(tm)):
        onehot = tuple(1.0 if i == d else 0.0 for i in range(3))
        b = tbatch.collate(tm[name], bucket=tbatch.BucketSpec(multiple=64))
        ids = torch.where(b.graph_mask, torch.tensor(d, dtype=torch.int32),
                          torch.tensor(-1, dtype=torch.int32))
        out = []
        for batch in (b.replace(dataset_id=ids), b):
            model = create_model(tmc, device="cpu", seed=2)
            tx = topt.Optimizer("SGD", learning_rate=0.5, momentum=0.0)
            state = tstep.TrainState.create(model, tx)
            step = tstep.make_train_step(
                model, tgfm.apply_head_weights(tmc, onehot), tx)
            state, m = step(state, batch)
            out.append((state.state_dict(), m))
        (s_gfm, m_gfm), (s_plain, m_plain) = out
        for k in s_plain:
            assert torch.equal(s_gfm[k], s_plain[k]), (name, k)
        assert torch.equal(m_gfm[f"task_{d}"], m_plain[f"task_{d}"])


def test_apply_head_weights_matches_jax():
    jm, tm = _members()
    jmc, tmc, _ = _model_configs(jm, tm)
    assert tgfm.apply_head_weights(tmc, None) is tmc
    assert tgfm.apply_head_weights(tmc, (1.0, 0.0, 0.0)).task_weights == \
        jgfm.apply_head_weights(jmc, (1.0, 0.0, 0.0)).task_weights
    assert _raises(lambda: tgfm.apply_head_weights(tmc, (1.0, 0.5))) == \
        _raises(lambda: jgfm.apply_head_weights(jmc, (1.0, 0.5)))
    model = create_model(tmc, device="cpu")
    tx = topt.Optimizer("Adam", learning_rate=1e-3)
    assert _raises(lambda: tgfm.make_gfm_train_step(
        model, tmc, tx, num_datasets=2))[1] == _raises(
        lambda: jgfm._check_gfm_heads(jmc, 2))[1]


# ------------------------------------------------------ accumulation --
def test_epoch_accumulator_and_gauges_match_jax():
    """GfmEpochAccumulator's count-weighted means (an empty-member batch
    does not dilute), measured fractions and graph count, on [G] and
    stacked [D, G] batches; record_gfm_epoch's gauges, names, help
    strings, labels and Prometheus text: exact against JAX's."""
    from hydragnn_tpu.telemetry import record_gfm_epoch as j_record
    from hydragnn_tpu.telemetry.registry import MetricsRegistry as JReg
    from hydragnn_tpu.telemetry.registry import set_registry as j_set
    from hydragnn_tpu_torch.telemetry import record_gfm_epoch
    from hydragnn_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                       set_registry)

    class B:
        def __init__(self, ids, mask, lib):
            self.dataset_id = lib(np.asarray(ids, np.int32))
            self.graph_mask = lib(np.asarray(mask))

    steps = [([0, 0, -1], [True, True, False], {"task_0": 2.0,
                                                "task_1": 0.0}),
             ([1, -1, -1], [True, False, False], {"task_0": 0.0,
                                                  "task_1": 5.0}),
             ([[0, 1, -1], [1, 1, -1]], [[True, True, False],
                                         [True, True, False]],
              {"task_0": 0.25, "task_1": 0.75})]
    accs = []
    for acc, lib in ((tgfm.GfmEpochAccumulator(("a", "b")),
                      torch.from_numpy),
                     (jgfm.GfmEpochAccumulator(("a", "b")), jnp.asarray)):
        for ids, mask, metrics in steps:
            acc.update(B(ids, mask, lib), metrics)
        accs.append(acc)
    assert accs[0].summary() == accs[1].summary()
    assert accs[0].total_graphs == accs[1].total_graphs == 7
    summ = accs[0].summary()
    texts, snaps = [], []
    for rec, reg_cls, setter in ((record_gfm_epoch, MetricsRegistry,
                                  set_registry),
                                 (j_record, JReg, j_set)):
        reg = reg_cls()
        prev = setter(reg)
        try:
            rec(summ["head_losses"], val_losses={"a": 0.7, "b": 0.1},
                mixture_frac=summ["mixture_frac"])
            snaps.append(reg.snapshot())
            texts.append(reg.to_prometheus())
        finally:
            setter(prev)
    assert snaps[0] == snaps[1]
    assert texts[0] == texts[1]
    loss = snaps[0]["gfm_head_loss"]["values"]
    assert loss[(("head", "a"), ("split", "val"))] == 0.7


# ------------------------------------------------------- compositions --
def _member0_micro(tm, tmc, n_micro, graphs):
    samples = tm["alpha"]
    micro = []
    for i in range(n_micro):
        b = tbatch.collate(samples[i * graphs:(i + 1) * graphs],
                           n_node=192, n_edge=4096, n_graph=graphs + 1)
        ids = torch.where(b.graph_mask, torch.tensor(0, dtype=torch.int32),
                          torch.tensor(-1, dtype=torch.int32))
        micro.append(b.replace(dataset_id=ids))
    return micro


def test_gfm_spmd_zero_composition(tmp_path):
    """GfmMixtureLoader ranks (pack_rank r of 2) drive the SPMD step with
    ZeRO in two gloo ranks, bitwise the replicated update; on batches
    of member 0 alone on both ranks, heads 1 and 2 read exactly 0.0."""
    _, tm = _members(sizes=(24, 16, 20))
    _, tmc, tc = _model_configs(*_members(sizes=(24, 16, 20)))
    tc["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "AdamW",
                                                    "learning_rate": 1e-3}
    ranks = [tmd.GfmMixtureLoader(tm, 4, cfg=tmc, seed=3, pack_rank=r,
                                  pack_nproc=2) for r in range(2)]
    mixed = []
    for ld in ranks:
        ld.set_epoch(0)
        mixed.append(list(ld)[:2])
    alone = _member0_micro(tm, tmc, 2, 3)
    alone = [[a, a] for a in alone]
    case = dict(name="gfm", config=tc, variables=None,
                samples=[s for v in tm.values() for s in v],
                batches=[[mixed[0][i], mixed[1][i]] for i in range(2)])
    case0 = dict(case, name="member0", batches=alone)
    out = spawn_ranks(tmp_path, "zero_steps", 2, cases=[case, case0],
                      steps=2)
    for r in out:
        for name in ("gfm", "member0"):
            rep, zero = r[name]["replicated"], r[name]["zero"]
            assert rep["metrics"] == zero["metrics"]
            for part in ("params", "batch_stats"):
                for k, v in rep["state"][part].items():
                    np.testing.assert_array_equal(
                        zero["state"][part][k], v, err_msg=k)
        for m in r["gfm"]["replicated"]["metrics"]:
            assert all(np.isfinite(v) for v in m.values())
        for m in r["member0"]["replicated"]["metrics"]:
            assert m["task_0"] > 0.0
            assert m["task_1"] == 0.0 and m["task_2"] == 0.0


def test_gfm_pipeline_composition():
    """Microbatches carrying dataset_id through the 1F1B pipeline step
    (two stages on the CPU): the pipeline's microbatch split keeps the
    field, heads 1 and 2 read exactly 0.0 on member-0 microbatches, head
    0 trains, and the loss equals the sequential step's within the
    pipeline bound."""
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    jm, tm = _members()
    _, tmc, _ = _model_configs(jm, tm, _config(layers=4))
    micro = _member0_micro(tm, tmc, 4, 3)
    stacked = stack_batches(micro)
    assert all(torch.equal(p.dataset_id, m.dataset_id)
               for p, m in zip(unstack_batch(stacked), micro))
    model = tpt.create_pipeline_model(tmc, ["cpu", "cpu"])
    tx = topt.Optimizer("Adam", learning_rate=1e-3)
    state = tstep.TrainState.create(model, tx)
    step = tpt.make_pipeline_train_step(model, tx, schedule="1f1b")
    for _ in range(2):
        state, metrics = step(state, stacked)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["task_0"]) > 0.0
    assert float(metrics["task_1"]) == 0.0
    assert float(metrics["task_2"]) == 0.0


# ------------------------------------------------------------ driver --
def test_gfm_driver_matches_the_jax_driver(tmp_path, monkeypatch,
                                           clean_env):
    """hydragnn_tpu_torch.examples.gfm against examples/gfm/train_gfm.py,
    2 epochs at --sizes 12,8,10 from the same initial weights (JAX's
    init loaded into the port's model): plan_fp equal, the result's
    keys, mixture fractions and steps equal, epoch 0's train loss within
    rtol 1e-4 and epoch 1's within DRIVER_LATER_RTOL; the result.json on
    disk is the returned result; with HYDRAGNN_TELEMETRY the session's
    epoch events carry the gfm_* keys and metrics.prom the gauges; and
    --resume restarts after the last committed epoch with the same
    history and parameters."""
    from examples.gfm import train_gfm as jdriver
    from hydragnn_tpu_torch.examples import gfm as tdriver
    import hydragnn_tpu.models as jmodels
    seen = {}
    init = jmodels.init_params

    def spy(*a, **k):
        seen["vars"] = numpy_tree(init(*a, **k))
        return seen["vars"]
    monkeypatch.setattr(jmodels, "init_params", spy)
    create = tdriver.create_model

    def create_loaded(mcfg, device="cuda", seed=0):
        model = create(mcfg, device=device, seed=seed)
        model.load_state_dict(load_jax_variables(seen["vars"]))
        return model
    monkeypatch.setattr(tdriver, "create_model", create_loaded)
    argv = ["--sizes", "12,8,10", "--num-epochs", "2"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jargs = jdriver.argparse.Namespace(
        inputfile="gfm_mixture.json", num_epochs=2, batch_size=None,
        sizes="12,8,10", data_seed=0, seed=0, rank=0, world=1,
        job_dir=str(jdir), log_name="gfm", resume=False)
    assert jdriver.run(jargs) == 0
    clean_env.setenv("HYDRAGNN_TELEMETRY", "1")
    result, info = tdriver.run(tdriver.parse_args(
        argv + ["--job-dir", str(tdir), "--device", "cpu"]))
    clean_env.delenv("HYDRAGNN_TELEMETRY")
    events = [json.loads(line) for line in
              (tdir / "telemetry" / "telemetry.jsonl").read_text().split(
                  "\n") if line]
    epochs = [e for e in events if e.get("kind") == "epoch"]
    assert len(epochs) == 2
    for n in ("alpha", "beta", "gamma"):
        for key in (f"gfm_head_loss_{n}", f"gfm_val_head_loss_{n}",
                    f"gfm_mixture_frac_{n}"):
            assert np.isfinite(epochs[-1]["data"][key]), key
    prom = (tdir / "telemetry" / "metrics.prom").read_text()
    assert 'gfm_head_loss{head="gamma",split="val"}' in prom
    assert 'gfm_mixture_frac{dataset="alpha"}' in prom
    with open(jdir / "result.json") as fh:
        want = json.load(fh)
    with open(tdir / "result.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(result))
    assert set(result) == set(want)
    assert result["plan_fp"] == want["plan_fp"]
    assert result["mixture_frac"] == want["mixture_frac"]
    assert result["step"] == want["step"] and \
        result["final_step"] == want["final_step"]
    assert set(result["history"]) == set(want["history"])
    assert all(len(v) == 2 for v in result["history"].values())
    got, ref = result["history"]["train_loss"], want["history"]["train_loss"]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=DRIVER_LATER_RTOL)
    assert got[1] < got[0]
    assert info.train_captures == 0            # the CPU captures none
    resumed, _ = tdriver.run(tdriver.parse_args(
        argv + ["--job-dir", str(tdir), "--device", "cpu", "--resume"]))
    assert resumed["history"] == result["history"]
    assert resumed["param_digest"] == result["param_digest"]


def test_gfm_modules_import_no_jax():
    """The GFM and multi-dataset modules and both drivers load neither
    jax nor the JAX package nor the repository's examples."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.'); "
            "import hydragnn_tpu_torch.parallel.multidataset, "
            "hydragnn_tpu_torch.train.gfm, "
            "hydragnn_tpu_torch.telemetry.gfm, "
            "hydragnn_tpu_torch.examples.gfm, "
            "hydragnn_tpu_torch.examples.multidataset; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) "
            "or m == 'hydragnn_tpu' or m.startswith('hydragnn_tpu.') "
            "or m == 'examples' or m.startswith('examples.')]; "
            "print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
