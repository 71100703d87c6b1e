"""Composed (data x graph) training in the port (`hydragnn_tpu_torch.
parallel.composite`, `Architecture.graph_shards`), the graph slots all on
the CPU, against the JAX package's composite path on the 8-device CPU
mesh:

* GIN and PNA with graph_shards 4 and num_shards 1 and 2: the first
  composed step's loss and parameters against JAX's
  `make_composed_train_step` (rtol 1e-4 / atol 1e-5), SGD from the same
  Flax variables;
* a three-epoch `run_training` history against JAX's composed run and
  against the port's own single-device run (rtol 2e-3 / atol 1e-5, JAX's
  own bound, tests/test_composite.py:56-58);
* LJ SchNet energy-force (equivariant) composed against JAX;
* on a tie-heavy dyadic fixture the cross-slot extreme's gradient bitwise
  the single-device extreme's (`_SegmentExtreme` over one slot) and
  torch's scatter_reduce's; ZeRO on over the data axis bitwise
  ZeRO off; the eval step's weighting against JAX's
  `make_composed_eval_step`;
* the refusals: the divisor (JAX's message), the other model types
  naming A9, the dense layout.
"""
import copy
import importlib
import sys

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.parallel import composite as jcomp
from hydragnn_tpu.parallel.mesh import make_mesh
from hydragnn_tpu.run_training import run_training as j_run_training
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train.train_step import TrainState as JState
from hydragnn_tpu_torch import run_training
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader, unstack_batch
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.ops import segment as tseg
from hydragnn_tpu_torch.parallel import composite as tcomp
from hydragnn_tpu_torch.parallel import graph_parallel as tgp
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.train_step import TrainState, make_train_step
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import (TRAIN_TOL, _jax_view, assert_tree_close,
                                    jax_batch, numpy_tree, to_jax_samples,
                                    to_port_samples)
from tests.torch_pipeline_fixtures import ef_config, lj_samples, molecules
from tests.utils import make_config

torch.set_num_threads(1)
rt = importlib.import_module("hydragnn_tpu_torch.run_training")
CPU8 = ["cpu"] * 8
HISTORY_TOL = dict(rtol=2e-3, atol=1e-5)
SGD = {"type": "SGD", "learning_rate": 0.01}


def _samples(model_type, n=32):
    if model_type == "PNA":
        # five-feature molecules: no zero-variance neighbourhoods, where
        # PNA's std amplifies float32 rounding (torch_pipeline_fixtures)
        return molecules(n, seed=6)
    return to_port_samples(deterministic_graph_dataset(num_configs=n))


def _cfg(model_type, samples, cfg=None):
    cfg = copy.deepcopy(cfg) if cfg else make_config(model_type)
    cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    cfg["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = \
        list(range(samples[0].x.shape[1]))
    return cfg


class Composed:
    """One model in both packages from the same Flax variables, and a
    loader batch of `data` shards (edge list)."""

    def __init__(self, model_type, samples, data, graph, cfg=None,
                 batch_size=8, optimizer=SGD, seed=2):
        cfg = _cfg(model_type, samples, cfg)
        jc = jcfg.update_config(copy.deepcopy(cfg), to_jax_samples(samples))
        tc = tcfg.update_config(copy.deepcopy(cfg), samples)
        self.jm, self.tm = jcfg.build_model_config(jc), \
            tcfg.build_model_config(tc)
        loader = GraphDataLoader(samples, batch_size, num_shards=data)
        self.batches = list(loader)
        self.batch = self.batches[0]
        first = unstack_batch(self.batch)[0]
        self.jmodel = j_create_model(self.jm)
        self.variables = numpy_tree(j_init_params(
            self.jmodel, jax_batch(_jax_view(first)), seed=seed))
        self.data, self.graph = data, graph
        self.mesh = make_mesh((("data", data), ("graph", graph)),
                              devices=jax.devices()[:data * graph])
        self.train = {"Optimizer": copy.deepcopy(optimizer)}

    def jax_state(self):
        tx = jopt.select_optimizer(copy.deepcopy(self.train))
        return JState.create(jax.tree_util.tree_map(np.array,
                                                    self.variables), tx), tx

    def port(self, data=None, graph=None):
        model = create_model(self.tm, device="cpu")
        model.load_state_dict(load_jax_variables(self.variables))
        tx = select_optimizer(copy.deepcopy(self.train))
        grid = tcomp.ComposedGrid(CPU8, data or self.data,
                                  graph or self.graph)
        return model, TrainState.create(model, tx), tx, grid

    def jax_placed(self, batch):
        jb = jax_batch(_jax_view(batch))
        if self.data == 1:
            jb = jax.tree_util.tree_map(
                lambda a: None if a is None else a[None], jb)
        return jcomp.place_composed_batch(jb, self.mesh)


@pytest.mark.parametrize("model_type,data", [("GIN", 1), ("GIN", 2),
                                             ("PNA", 1), ("PNA", 2)])
def test_first_composed_step_matches_jax(model_type, data):
    fx = Composed(model_type, _samples(model_type), data, 4)
    jstate, jtx = fx.jax_state()
    jstep = jcomp.make_composed_train_step(fx.jmodel, fx.jm, jtx, fx.mesh,
                                           "mse")
    jstate, jmet = jstep(jstate, fx.jax_placed(fx.batch))
    model, state, tx, grid = fx.port()
    step = tcomp.make_composed_train_step(model, fx.tm, tx, grid, "mse")
    state, met = step(state, tcomp.place_composed_batch(fx.batch, grid))
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   err_msg=k, **TRAIN_TOL)
    assert float(met["nonfinite_steps"]) == 0.0
    got = export_jax_variables(model)
    assert_tree_close(got["params"], numpy_tree(jstate.params), TRAIN_TOL)
    assert_tree_close(got["batch_stats"], numpy_tree(jstate.batch_stats),
                      TRAIN_TOL)


def test_composed_energy_force_step_matches_jax():
    """Equivariant LJ SchNet, compute_grad_energy, graph_shards 2: the
    shards compute their own distances from the replicated positions; the
    first step's losses and parameters against JAX's."""
    samples = lj_samples(8)
    cfg = ef_config(layers=2)
    fx = Composed("SchNet", samples, 1, 2, cfg=cfg, batch_size=4)
    kw = dict(compute_grad_energy=True)
    jstate, jtx = fx.jax_state()
    jstep = jcomp.make_composed_train_step(fx.jmodel, fx.jm, jtx, fx.mesh,
                                           "mse", **kw)
    jstate, jmet = jstep(jstate, fx.jax_placed(fx.batch))
    model, state, tx, grid = fx.port()
    step = tcomp.make_composed_train_step(model, fx.tm, tx, grid, "mse",
                                          **kw)
    state, met = step(state, tcomp.place_composed_batch(fx.batch, grid))
    for k in ("loss", "energy_loss", "force_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   err_msg=k, **TRAIN_TOL)
    got = export_jax_variables(model)
    assert_tree_close(got["params"], numpy_tree(jstate.params), TRAIN_TOL)


def test_eval_step_weighting_matches_jax():
    """Two data shards with unequal real graphs (the last batch of an
    uneven split): the port's weighted metrics against JAX's."""
    samples = _samples("GIN", 14)
    fx = Composed("GIN", samples, 2, 4)
    batch = fx.batches[-1]
    assert int(batch.graph_mask[0].sum()) != int(batch.graph_mask[1].sum())
    jeval = jcomp.make_composed_eval_step(fx.jmodel, fx.jm, "mse")
    jstate, _ = fx.jax_state()
    want = jeval(jstate, fx.jax_placed(batch))
    model, state, _, grid = fx.port()
    ev = tcomp.make_composed_eval_step(model, fx.tm, grid, "mse")
    got, outputs = ev(state, batch)
    assert outputs is None
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **TRAIN_TOL)


def test_zero_over_the_data_axis_is_bitwise_the_replicated_update():
    """AdamW, two data shards, ZeRO's min size 16 (JAX would split every
    leaf of 16 elements or more over them): two steps with ZeRO equal two
    without, bit for bit (the port's slots share one device, so the
    update stays replicated)."""
    samples = _samples("GIN", 32)
    fx = Composed("GIN", samples, 2, 2,
                  optimizer={"type": "AdamW", "learning_rate": 1e-2})
    states = []
    for zero in (False, True):
        model, state, tx, grid = fx.port()
        step = tcomp.make_composed_train_step(
            model, fx.tm, tx, grid, "mse", zero_opt=zero, zero_min_size=16)
        for b in fx.batches[:2]:
            state, _ = step(state, b)
        states.append(state)
    split = [k for k, v in states[0].params.items()
             if v.numel() >= 16 and v.shape[0] % 2 == 0]
    assert split, "no leaf JAX would split over the data axis"
    for k, v in states[0].params.items():
        assert torch.equal(v, states[1].params[k]), k
    for name, ts in states[0].opt_state.slots.items():
        for a, b in zip(ts, states[1].opt_state.slots[name]):
            assert torch.equal(a, b), name


def _tie_fixture(n=24, e=400, f=5, seed=0):
    """Dyadic rows on few values: many receivers reach their extreme on
    several edges, across every chunk."""
    rng = np.random.RandomState(seed)
    data = (rng.randint(-3, 4, (e, f)) / 4.0).astype(np.float32)
    recv = rng.randint(0, n, e).astype(np.int32)
    mask = rng.rand(e) > 0.1
    return torch.from_numpy(data), torch.from_numpy(recv), \
        torch.from_numpy(mask)


@pytest.mark.parametrize("slots", [2, 3, 8])
def test_cross_slot_extreme_gradient_bitwise_single_device(slots):
    n = 24
    data, recv, mask = _tie_fixture(n)
    g = torch.from_numpy(np.random.RandomState(1).randint(
        -8, 9, (n, data.shape[1])).astype(np.float32) / 8.0)
    for red, single in (("amax", tseg.segment_max),
                        ("amin", tseg.segment_min)):
        x1 = data.clone().requires_grad_(True)
        want = single(x1, recv, n, mask)
        (want_g,) = torch.autograd.grad(want, x1, g)
        x2 = data.clone().requires_grad_(True)
        chunks = tgp.edge_chunks(data.shape[0], slots)
        neutral = 1e30 if red == "amin" else -1e30
        parts = [tseg.extreme_rows(x2[c], recv[c], n, mask[c], neutral, red)
                 for c in chunks]
        out = tseg.cross_slot_extreme(parts, neutral, red)
        clamp = out >= neutral if red == "amin" else out <= neutral
        got = torch.where(clamp, torch.zeros_like(out), out)
        assert torch.equal(got, want), red
        (got_g,) = torch.autograd.grad(got, x2, g)
        assert torch.equal(got_g, want_g), red
        # the rule is torch's own scatter_reduce gradient over all the rows
        x3 = data.clone().requires_grad_(True)
        idl = recv.long()
        masked = torch.where(mask[:, None], x3, torch.full_like(x3, neutral))
        index = torch.where(mask, idl, torch.zeros_like(idl))[:, None]
        ref = torch.full((n, data.shape[1]), neutral).scatter_reduce(
            0, index.expand_as(masked), masked, reduce=red, include_self=True)
        ref = torch.where(clamp, torch.zeros_like(ref), ref)
        (ref_g,) = torch.autograd.grad(ref, x3, g)
        assert torch.equal(got_g, ref_g), red
        # ties really are split across chunks
        hit = (data == want[recv.long()]) & mask[:, None]
        assert int(hit.sum()) > n


def _splits(model_type, n=48):
    samples = _samples(model_type, n)
    k = int(n * 2 / 3)
    return samples[:k], samples[k:k + n // 6], samples[k + n // 6:]


def _with_jax_init(monkeypatch):
    """Record the JAX run's initial variables and load them into the
    port's model."""
    seen = {}
    jrt = sys.modules["hydragnn_tpu.run_training"]
    init = jrt.init_params

    def spy(*a, **k):
        seen["variables"] = numpy_tree(init(*a, **k))
        return seen["variables"]
    monkeypatch.setattr(jrt, "init_params", spy)
    create = rt.create_model

    def create_loaded(mcfg, device="cpu", **kw):
        model = create(mcfg, device=device, **kw)
        model.load_state_dict(load_jax_variables(seen["variables"]))
        return model
    monkeypatch.setattr(rt, "create_model", create_loaded)
    return seen


@pytest.mark.parametrize("model_type,data", [("GIN", 1), ("PNA", 2)])
def test_run_training_history_matches_jax_and_single_device(
        tmp_path, monkeypatch, model_type, data):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    splits = _splits(model_type)
    cfg = _cfg(model_type, splits[0])
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(num_epoch=3, EarlyStopping=False, Optimizer=dict(SGD))
    composed_cfg = copy.deepcopy(cfg)
    composed_cfg["NeuralNetwork"]["Architecture"]["graph_shards"] = 4
    _with_jax_init(monkeypatch)
    _, want, _, _ = j_run_training(
        copy.deepcopy(composed_cfg),
        datasets=tuple(to_jax_samples(s) for s in splits), num_shards=data)
    _, got, model, done = run_training(
        copy.deepcopy(composed_cfg), datasets=splits, device="cpu",
        num_shards=data, graph_devices=CPU8)
    assert done["NeuralNetwork"]["Architecture"]["graph_shards"] == 4
    assert model is not None
    _, single, _, _ = run_training(copy.deepcopy(cfg), datasets=splits,
                                   device="cpu")
    for k in ("train_loss", "val_loss", "test_loss"):
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **HISTORY_TOL)
        if data == 1:
            # the same data through one device: only the slot order of
            # the sums differs
            np.testing.assert_allclose(got[k], single[k], err_msg=k,
                                       **HISTORY_TOL)
    assert got["graph_captures"] == [0, 0, 0]


def test_graph_shards_divisor_raises_jax_message(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    splits = _splits("GIN", 24)
    cfg = _cfg("GIN", splits[0])
    cfg["NeuralNetwork"]["Architecture"]["graph_shards"] = 3
    with pytest.raises(ValueError) as want:
        j_run_training(copy.deepcopy(cfg),
                       datasets=tuple(to_jax_samples(s) for s in splits))
    with pytest.raises(ValueError) as got:
        run_training(copy.deepcopy(cfg), datasets=splits, device="cpu",
                     graph_devices=CPU8)
    assert str(got.value) == str(want.value)
    assert "graph_shards=3 does not divide the device count 8" in \
        str(got.value)


@pytest.mark.parametrize("model_type", ["SAGE", "GAT", "MFC", "CGCNN",
                                        "PNAPlus", "EGNN", "DimeNet",
                                        "PAINN", "MACE"])
def test_other_model_types_refused_naming_a9(tmp_path, monkeypatch,
                                             model_type):
    """Before any work: no splits are read (datasets=None would load the
    config's files)."""
    monkeypatch.chdir(tmp_path)
    cfg = make_config(model_type)
    cfg["NeuralNetwork"]["Architecture"]["graph_shards"] = 2
    with pytest.raises(NotImplementedError, match="A9"):
        run_training(cfg, datasets=None, device="cpu", graph_devices=CPU8)


def test_composed_step_refuses_the_dense_layout():
    samples = _samples("GIN", 16)
    fx = Composed("GIN", samples, 1, 2)
    from hydragnn_tpu_torch.graphs.batch import (neighbor_budget_for_dataset,
                                                 with_neighbor_format)
    dense = with_neighbor_format(fx.batch,
                                 k=neighbor_budget_for_dataset(samples))
    model, state, tx, grid = fx.port()
    step = tcomp.make_composed_train_step(model, fx.tm, tx, grid, "mse")
    with pytest.raises(ValueError, match="dense neighbor layout"):
        step(state, dense)


def test_single_device_step_unchanged_outside_a_composed_forward():
    """The graph axis is only active inside a composed step: the same
    model's plain step afterwards runs the single-device route (PNA's
    fused edge kernel's plain version here), as before."""
    samples = _samples("PNA", 16)
    fx = Composed("PNA", samples, 1, 2)
    model, state, tx, grid = fx.port()
    tcomp.make_composed_train_step(model, fx.tm, tx, grid, "mse")(
        state, fx.batch)
    assert tgp.active_slots() is None
    cargs = type(model).conv_args(model, fx.batch)
    assert "graph_slots" not in cargs
    make_train_step(model, fx.tm, tx, "mse")(state, fx.batch)
