"""Sampled training's model and steps in the port (hydragnn_tpu_torch:
models/base.BaseStack.encode with `hist_states` and its collected
post-layer states, train/train_step.make_sampled_train_step /
make_sampled_eval_step, exact and historical) against the JAX package's
on the CPU, on SAGE at a small size with the same (JAX-initialized)
weights, the same sampled batch and the same historical tables:

* the forward's outputs and each layer's post-layer state (JAX's sown
  `encoder_h{i}`) with and without `hist_states`: rtol 1e-5 / atol 1e-6;
* the first exact and historical SGD step: the loss and every metric
  within rtol 1e-5, the parameters and running statistics within 1e-5
  relative L2; hist_frac and hist_staleness equal;
* the tables after a refresh on the real rows: `layers` within rtol 1e-5
  / atol 1e-6, `versions` bitwise; with the refresh flag off the real
  rows are untouched, bit for bit;
* eval's `correct` / `count` equal, its loss within rtol 1e-5;
* historical mode refused, before any work, for the stacks whose encoder
  cannot apply the cache.
"""
import copy
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples.ogbn import ogbn_data as jdata
from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.preprocess import sampling as jsamp
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu_torch.examples.ogbn import complete_config
from hydragnn_tpu_torch.models.base import BaseStack, check_hist_encode
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.models.mace import MACEStack
from hydragnn_tpu_torch.models.painn import PAINNStack
from hydragnn_tpu_torch.models.pnaeq import PNAEqStack
from hydragnn_tpu_torch.preprocess import sampling as tsamp
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.test_torch_train import numpy_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OGBN_CONFIG = ROOT / "examples" / "ogbn" / "ogbn_arxiv.json"
FWD_TOL = dict(rtol=1e-5, atol=1e-6)     # the pipeline tests' SAGE bound
LOSS_RTOL = 1e-5
PARAM_REL_L2 = 1e-5
HIDDEN = 8
LR = 0.05
K = 2                                    # historical mode's staleness
STEP0 = 5                                # the step count before the step
FIELDS = [f.name for f in dataclasses.fields(jbatch.GraphBatch)]


def _config():
    with open(OGBN_CONFIG) as f:
        config = json.load(f)
    arch = config["NeuralNetwork"]["Architecture"]
    arch["hidden_dim"] = HIDDEN
    arch["output_heads"]["node"]["dim_headlayers"] = [HIDDEN, HIDDEN]
    return config


@functools.lru_cache(maxsize=None)
def _setup(staleness_k):
    """(graph, loader batch as port tensors, JAX model, JAX model config,
    port model config, JAX-initialized variables)."""
    g = jdata.synthetic_arxiv(num_nodes=300, feat_dim=6, num_classes=4,
                              seed=1)
    loader = tsamp.NeighborSamplingLoader(
        x=g.x, y_node=g.y_onehot, senders=g.senders, receivers=g.receivers,
        train_nodes=g.train_idx, batch_size=8, fanouts=(3, 2), seed=3,
        num_partitions=4, staleness_k=staleness_k, num_layers=2,
        async_workers=0)
    batch = next(iter(loader))
    config = _config()
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(input_dim=int(g.x.shape[1]), output_dim=[g.num_classes],
                output_type=["node"], num_nodes=0)
    jmc = jcfg.build_model_config(copy.deepcopy(config))
    tmc = complete_config(copy.deepcopy(config), g)
    jmodel = j_create_model(jmc)
    init_b = _jax_view(batch)
    if staleness_k:
        init_b = init_b.replace(hist_states=jnp.zeros(
            (1, batch.x.shape[0], HIDDEN)))
    variables = numpy_tree(j_init_params(jmodel, init_b, seed=0))
    return g, batch, jmodel, jmc, tmc, variables


def _jax_view(tb):
    return jbatch.GraphBatch(**{
        f: None if getattr(tb, f) is None else jnp.asarray(
            getattr(tb, f).numpy()) for f in FIELDS})


def _port_model(tmc, variables):
    model = create_model(tmc, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return model


def _tables(g, seed=0):
    """Historical tables with random stale states and version stamps, as
    numpy arrays (feat, layers, versions)."""
    rng = np.random.RandomState(seed)
    ng = g.num_nodes
    feat = np.zeros((ng + 1, g.x.shape[1]), np.float32)
    feat[:ng] = g.x
    layers = rng.randn(1, ng + 1, HIDDEN).astype(np.float32)
    versions = rng.randint(0, STEP0 + 1, ng + 1).astype(np.int32)
    return feat, layers, versions


def _port_tables(arrays):
    return tsamp.HistTables(*(torch.from_numpy(a.copy()) for a in arrays))


def _jax_tables(arrays):
    return jsamp.HistTables(*(jnp.asarray(a) for a in arrays))


def _rel_l2(got, want):
    got = np.concatenate([np.asarray(v, np.float64).ravel()
                          for _, v in sorted(_flat(got))])
    want = np.concatenate([np.asarray(v, np.float64).ravel()
                           for _, v in sorted(_flat(want))])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


# ------------------------------------------------------------- forward --
@pytest.mark.parametrize("with_hist", [False, True])
def test_forward_and_encoder_states_match_jax(with_hist):
    """Training-mode forward of SAGE on a sampled batch: the outputs on
    the real slots and each layer's post-layer state (JAX's sown
    encoder_h{i}), with the historical view (stale states on the cache's
    slots, norms over the fresh slots) and without it."""
    g, batch, jmodel, jmc, tmc, variables = _setup(K)
    if with_hist:
        arrays = _tables(g)
        batch = tstep._hist_view(batch, _port_tables(arrays))
        assert batch.hist_mask.any()
    jb = _jax_view(batch)
    (j_out, _), mutated = jmodel.apply(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, jb, train=True,
        mutable=["batch_stats", "intermediates"])
    model = _port_model(tmc, variables)
    model.train()
    states = []
    out, _ = model(batch, states=states)
    real = batch.node_mask.numpy()
    np.testing.assert_allclose(out[0].detach().numpy()[real],
                               np.asarray(j_out[0])[real], **FWD_TOL)
    sown = mutated["intermediates"]
    assert len(states) == len(sown) == jmc.num_conv_layers
    for i, s in enumerate(states):
        np.testing.assert_allclose(s.detach().numpy()[real],
                                   np.asarray(sown[f"encoder_h{i}"][0])[real],
                                   err_msg=f"encoder_h{i}", **FWD_TOL)
    if with_hist:
        # layer 0's stale slots carry the tables' states exactly
        hm = batch.hist_mask.numpy()
        np.testing.assert_array_equal(states[0].detach().numpy()[hm],
                                      batch.hist_states[0].numpy()[hm])


# --------------------------------------------------------------- steps --
def _jax_step(jmodel, jmc, variables, jb, staleness_k, tables=None,
              flag=True):
    tx = optax.sgd(LR)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jstate = jstate.replace(step=jnp.asarray(STEP0, jnp.int32))
    step = jstep.make_sampled_train_step(jmodel, jmc, tx, loss_name="ce",
                                         staleness_k=staleness_k,
                                         donate=False)
    if staleness_k:
        jstate, jtables, m = step(jstate, jb, tables, jnp.asarray(flag))
        return jstate, jtables, m
    jstate, m = step(jstate, jb)
    return jstate, None, m


def _port_step(tmc, variables, batch, staleness_k, tables=None, flag=True):
    model = _port_model(tmc, variables)
    tx = topt.Optimizer("SGD", learning_rate=LR, momentum=0.0)
    state = tstep.TrainState.create(model, tx)
    state.step = STEP0
    step = tstep.make_sampled_train_step(model, tmc, tx, loss_name="ce",
                                         staleness_k=staleness_k)
    if staleness_k:
        state, tables, m = step(state, batch, tables, flag)
    else:
        state, m = step(state, batch)
    return model, state, tables, m


@pytest.mark.parametrize("staleness_k", [0, K])
def test_first_sgd_step_matches_jax(staleness_k):
    """One SGD step, exact and historical (refresh on), from the same
    weights, batch and tables: every metric (hist_frac and hist_staleness
    equal), the parameters and running statistics, and the refreshed
    tables on the real rows."""
    g, batch, jmodel, jmc, tmc, variables = _setup(staleness_k)
    arrays = _tables(g) if staleness_k else None
    jstate, jtables, jm = _jax_step(
        jmodel, jmc, variables, _jax_view(batch), staleness_k,
        _jax_tables(arrays) if arrays else None)
    ptables = _port_tables(arrays) if arrays else None
    model, state, ptables, m = _port_step(tmc, variables, batch,
                                          staleness_k, ptables)
    assert sorted(m) == sorted(jm)
    for k in m:
        if k in ("hist_frac", "hist_staleness", "nonfinite_steps"):
            assert float(m[k]) == float(jm[k]), k
        else:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    assert state.step == int(jstate.step) == STEP0 + 1
    got = export_jax_variables(model)
    assert _rel_l2(got["params"], numpy_tree(jstate.params)) <= PARAM_REL_L2
    assert _rel_l2(got["batch_stats"],
                   numpy_tree(jstate.batch_stats)) <= PARAM_REL_L2
    if staleness_k:
        ng = g.num_nodes
        np.testing.assert_allclose(ptables.layers.numpy()[:, :ng],
                                   np.asarray(jtables.layers)[:, :ng],
                                   **FWD_TOL)
        np.testing.assert_array_equal(ptables.versions.numpy()[:ng],
                                      np.asarray(jtables.versions)[:ng])
        refreshed = ptables.versions.numpy()[:ng] != arrays[2][:ng]
        assert refreshed.any()
        assert (ptables.versions.numpy()[:ng][refreshed] == STEP0 + 1).all()
        assert float(m["hist_frac"]) > 0.0


def test_refresh_flag_off_leaves_real_rows_untouched():
    """With the flag off the step still trains (as JAX's, whose tables
    stay as they were) and writes only the dump row: rows 0..Ng-1 of
    `layers` and `versions` are bitwise what they were."""
    g, batch, jmodel, jmc, tmc, variables = _setup(K)
    arrays = _tables(g, seed=4)
    jstate, jtables, jm = _jax_step(jmodel, jmc, variables,
                                    _jax_view(batch), K,
                                    _jax_tables(arrays), flag=False)
    _, _, ptables, m = _port_step(tmc, variables, batch, K,
                                  _port_tables(arrays), flag=False)
    ng = g.num_nodes
    np.testing.assert_array_equal(ptables.layers.numpy()[:, :ng],
                                  arrays[1][:, :ng])
    np.testing.assert_array_equal(ptables.versions.numpy()[:ng],
                                  arrays[2][:ng])
    np.testing.assert_array_equal(np.asarray(jtables.layers)[:, :ng],
                                  arrays[1][:, :ng])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)


def test_alternating_refresh_over_steps_matches_jax():
    """Four historical SGD steps over the loader's batches with the flag
    alternating (on at even steps): each step's metrics and the final
    tables' real rows against JAX's."""
    g, _, jmodel, jmc, tmc, variables = _setup(K)
    loader = tsamp.NeighborSamplingLoader(
        x=g.x, y_node=g.y_onehot, senders=g.senders, receivers=g.receivers,
        train_nodes=g.train_idx, batch_size=8, fanouts=(3, 2), seed=3,
        num_partitions=4, staleness_k=K, num_layers=2, async_workers=0)
    batches = [b for _, b in zip(range(4), loader)]
    arrays = _tables(g, seed=5)
    tx = optax.sgd(LR)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jtrain = jstep.make_sampled_train_step(jmodel, jmc, tx, loss_name="ce",
                                           staleness_k=K, donate=False)
    jtables = _jax_tables(arrays)
    model = _port_model(tmc, variables)
    ptx = topt.Optimizer("SGD", learning_rate=LR, momentum=0.0)
    state = tstep.TrainState.create(model, ptx)
    step = tstep.make_sampled_train_step(model, tmc, ptx, loss_name="ce",
                                         staleness_k=K)
    ptables = _port_tables(arrays)
    for i, b in enumerate(batches):
        jstate, jtables, jm = jtrain(jstate, _jax_view(b), jtables,
                                     jnp.asarray(i % 2 == 0))
        state, ptables, m = step(state, b, ptables, i % 2 == 0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        assert float(m["hist_staleness"]) == float(jm["hist_staleness"])
        assert float(m["hist_frac"]) == float(jm["hist_frac"])
    ng = g.num_nodes
    np.testing.assert_array_equal(ptables.versions.numpy()[:ng],
                                  np.asarray(jtables.versions)[:ng])
    np.testing.assert_allclose(ptables.layers.numpy()[:, :ng],
                               np.asarray(jtables.layers)[:, :ng],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("staleness_k", [0, K])
def test_eval_step_matches_jax(staleness_k):
    """The sampled eval step, exact and historical: the loss, and the
    classification head's correct / count equal."""
    g, batch, jmodel, jmc, tmc, variables = _setup(staleness_k)
    tx = optax.sgd(LR)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jev = jstep.make_sampled_eval_step(jmodel, jmc, loss_name="ce",
                                       staleness_k=staleness_k)
    model = _port_model(tmc, variables)
    state = tstep.TrainState.create(model, topt.Optimizer(
        "SGD", learning_rate=LR, momentum=0.0))
    tev = tstep.make_sampled_eval_step(model, tmc, loss_name="ce",
                                       staleness_k=staleness_k)
    if staleness_k:
        arrays = _tables(g)
        jm, jout = jev(jstate, _jax_view(batch), _jax_tables(arrays))
        m, out = tev(state, batch, _port_tables(arrays))
    else:
        jm, jout = jev(jstate, _jax_view(batch))
        m, out = tev(state, batch)
    assert sorted(m) == sorted(jm) == ["correct", "count", "loss", "task_0"]
    assert float(m["count"]) == float(jm["count"]) == 8.0
    assert float(m["correct"]) == float(jm["correct"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    real = batch.node_mask.numpy()
    np.testing.assert_allclose(out[0].numpy()[real],
                               np.asarray(jout[0])[real], **FWD_TOL)


def test_exact_step_runs_the_loaders_batches_and_refuses_tables():
    """Exact mode (K = 0): one step a batch over an epoch, the step
    counted; a table handed to it is refused."""
    g, batch, jmodel, jmc, tmc, variables = _setup(0)
    model = _port_model(tmc, variables)
    tx = topt.Optimizer("Adam", learning_rate=3e-3)
    state = tstep.TrainState.create(model, tx)
    step = tstep.make_sampled_train_step(model, tmc, tx)
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and state.step == 1
    with pytest.raises(ValueError, match="no historical tables"):
        step(state, batch, _port_tables(_tables(g)), True)


@pytest.mark.parametrize("cls", [PAINNStack, PNAEqStack, MACEStack])
def test_hist_mode_refused_for_stacks_that_override_the_encoder(cls):
    """PAINN and PNAEq override `encode`, MACE `forward`: neither applies
    the stale states nor hands back the fresh ones (JAX's historical loss
    fails at its missing encoder_h0), so both step factories refuse them
    in historical mode, naming the stack, before any work; exact mode is
    accepted."""
    model = object.__new__(cls)
    with pytest.raises(ValueError, match=cls.__name__):
        check_hist_encode(model)
    for make in (tstep.make_sampled_train_step,):
        with pytest.raises(ValueError, match="staleness_k"):
            make(model, None, None, staleness_k=2)
    with pytest.raises(ValueError, match="overrides"):
        tstep.make_sampled_eval_step(model, None, staleness_k=2)
    check_hist_encode(object.__new__(BaseStack))
