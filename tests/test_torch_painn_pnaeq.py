"""The port's PAINN and PNAEq (models/painn.py, models/pnaeq.py) against
the JAX package's on the CPU, with the Flax weights carried across, on
the dense neighbor layout and the edge list, at LJ.json's layout (radius
2.0, periodic cells, a node energy head) cut to hidden 8: the forward
and its VJP with respect to the positions and every parameter, the
energy-force loss and its parameter gradient (forces taken with
create_graph), 3 energy-force SGD steps, the weight round trip, the two
rotation properties of tests/test_equivariance.py, and LJ energy-force
training through both packages' run_training and run_prediction. Also
the segment sum of [E, 3, F] rows through the segment-sum kernel's
route. The lattice thresholds (tests/test_graphs_full.py) are slow here,
as they are for the JAX package.

Bound: rtol 1e-4 / atol 1e-5 (TRAIN_TOL) on real rows; gradients with
atol grown by rtol times each tensor's largest entry.

The helpers (`lj_config`, `model_pair`, `hold_forward_and_vjp`,
`hold_ef_loss`, `hold_ef_sgd_steps`, `hold_rotation`,
`hold_lj_run_training`) serve test_torch_mace.py and
test_torch_dimenet.py too.
"""
import copy
import dataclasses
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
from hydragnn_tpu_torch.graphs.triplets import make_triplet_transform
from hydragnn_tpu_torch.models.create import create_model, data_input_dim
from hydragnn_tpu_torch.ops import segment as tseg
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables,
                                              random_flax_variables)
from tests.test_torch_invariant_convs import jax_samples
from tests.test_torch_train import (_grads_as_flax, _jax_view,
                                    assert_tree_close, jax_batch, numpy_tree)

torch.set_num_threads(1)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
LJ = ROOT / "examples" / "LennardJones" / "LJ.json"
LAYOUTS = pytest.mark.parametrize("dense", [True, False],
                                  ids=["dense", "edge"])
MODELS = pytest.mark.parametrize("model_type", ["PAINN", "PNAEq"])
EXTRA_ARCH = {"MACE": dict(max_ell=2, node_max_ell=1, correlation=[2])}


def lj_config(model_type, hidden=8):
    """LJ.json with `model_type` and the widths set as
    examples/LennardJones/LennardJones.py sets them (equivariance on but
    for DimeNet), cut to `hidden`."""
    with open(LJ) as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(model_type=model_type, hidden_dim=hidden, num_filters=hidden,
                equivariance=model_type in ("SchNet", "EGNN", "PAINN",
                                            "PNAEq", "MACE"))
    for head in arch["output_heads"].values():
        head["dim_headlayers"] = [hidden] * len(head["dim_headlayers"])
    return cfg


def with_triplets(model_type, tb, samples):
    if model_type != "DimeNet":
        return tb
    return make_triplet_transform(samples, len(samples))(tb, samples)


def model_pair(cfg, samples, dense, seed=3):
    """(JAX model, JAX ModelConfig, port ModelConfig, port batch of all
    `samples`, its JAX view, Flax variables from the JAX init)."""
    tc = tcfg.update_config(copy.deepcopy(cfg), samples)
    jc = jcfg.update_config(copy.deepcopy(cfg), jax_samples(samples))
    jm = jcfg.build_model_config(jc)
    jmodel = j_create_model(jm)
    tm = data_input_dim(tcfg.build_model_config(tc), samples)
    tb = with_triplets(tm.model_type, tbatch.collate(samples), samples)
    if dense:
        tb = tbatch.with_neighbor_format(tb)
    jb = jax_batch(_jax_view(tb))
    variables = numpy_tree(j_init_params(jmodel, jb, seed=seed))
    return jmodel, jm, tm, tb, jb, variables


def port_model(tm, variables):
    model = create_model(tm, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return model


def hold_forward_and_vjp(model_type, dense, samples=None, finite=True,
                         arch=None):
    """The eval forward of the node head on real nodes, and the
    gradients of a random projection of it with respect to the positions
    (real nodes) and every parameter; `arch` overrides architecture
    keys. `finite=False`: the padding node's position gradient is not
    finite in either package (DimeNet)."""
    samples = samples or lj_configurations(3, seed=7)
    cfg = lj_config(model_type)
    cfg["NeuralNetwork"]["Architecture"].update(
        EXTRA_ARCH.get(model_type, {}), **(arch or {}))
    jmodel, _, tm, tb, jb, variables = model_pair(cfg, samples, dense)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want, _ = jmodel.apply(jvars, jb, train=False)
    real = tb.node_mask.numpy()
    c = np.random.RandomState(0).randn(*want[0].shape).astype(np.float32)
    c[~real] = 0.0

    def jloss(p, pos):
        (out,), _ = jmodel.apply({"params": p},
                                 dataclasses.replace(jb, pos=pos),
                                 train=False)
        return jnp.sum(out * c)
    jg_p, jg_pos = jax.grad(jloss, argnums=(0, 1))(jvars["params"], jb.pos)
    model = port_model(tm, variables)
    pos = tb.pos.clone().requires_grad_(True)
    (got,), _ = model(tb.replace(pos=pos))
    np.testing.assert_allclose(got.detach().numpy()[real],
                               np.asarray(want[0])[real], **TRAIN_TOL)
    params = list(model.parameters())
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(c)),
                                [pos] + params, allow_unused=True,
                                materialize_grads=True)
    w = np.asarray(jg_pos)
    np.testing.assert_allclose(
        grads[0].numpy()[real], w[real], rtol=TRAIN_TOL["rtol"],
        atol=TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * np.abs(w[real]).max())
    assert np.abs(w[real]).max() > 1e-4
    if not finite:
        assert not np.isfinite(w[~real]).all()
        assert not np.isfinite(grads[0].numpy()[~real]).all()
    assert_tree_close(_grads_as_flax(model, grads[1:]), numpy_tree(jg_p),
                      TRAIN_TOL, scaled=True)
    return model, tb


def hold_ef_loss(model_type, dense, force_weight=1.0):
    """The energy-force loss (mae) in training mode and its gradient with
    respect to every parameter, through the forces' create_graph."""
    cfg = lj_config(model_type)
    cfg["NeuralNetwork"]["Architecture"].update(
        EXTRA_ARCH.get(model_type, {}))
    jmodel, jm, tm, tb, jb, variables = model_pair(
        cfg, lj_configurations(3, seed=9), dense)
    jloss_fn = jstep.make_loss_fn(jmodel, jm, "mae", compute_grad_energy=True,
                                  force_weight=force_weight)
    (want, (_, metrics)), want_g = jax.value_and_grad(
        jloss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), {}, jb)
    model = port_model(tm, variables)
    model.train()
    total, m = tstep.make_loss_fn(model, tm, "mae", compute_grad_energy=True,
                                  force_weight=force_weight)(tb)
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(total.detach()), float(want),
                               **TRAIN_TOL)
    for k in ("energy_loss", "force_loss"):
        np.testing.assert_allclose(float(m[k].detach()), float(metrics[k]),
                                   err_msg=k, **TRAIN_TOL)
    assert_tree_close(_grads_as_flax(model, grads), numpy_tree(want_g),
                      TRAIN_TOL, scaled=True)
    assert float(torch.stack([g.abs().max() for g in grads]).max()) > 0


def hold_ef_sgd_steps(model_type, dense, steps=3):
    """`steps` energy-force SGD steps (momentum, lr 0.01) on LJ loader
    batches of 4 cells from the same Flax variables: every step's loss
    and the final parameters."""
    cfg = lj_config(model_type)
    cfg["NeuralNetwork"]["Architecture"].update(
        EXTRA_ARCH.get(model_type, {}))
    samples = lj_configurations(12, seed=11)
    jmodel, jm, tm, _, _, variables = model_pair(cfg, samples[:4], dense)
    batches = list(GraphDataLoader(samples, 4, shuffle=True, seed=1,
                                   neighbor_format=dense))
    train_cfg = {"Optimizer": {"type": "SGD", "learning_rate": 0.01}}
    tx = jopt.select_optimizer(train_cfg)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jtrain = jstep.make_train_step(jmodel, jm, tx, "mae",
                                   compute_grad_energy=True, donate=False)
    model = port_model(tm, variables)
    port_tx = topt.select_optimizer(train_cfg)
    state = tstep.TrainState.create(model, port_tx)
    train = tstep.make_train_step(model, tm, port_tx, "mae",
                                  compute_grad_energy=True)
    for b in batches[:steps]:
        jstate, jmet = jtrain(jstate, jax_batch(_jax_view(b)))
        state, met = train(state, b)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   **TRAIN_TOL)
        assert float(met["nonfinite_steps"]) == 0.0
    assert_tree_close(export_jax_variables(model)["params"],
                      numpy_tree(jstate.params), TRAIN_TOL, scaled=True)


def _rotation(seed):
    from scipy.spatial.transform import Rotation
    return Rotation.random(random_state=seed).as_matrix().astype(np.float32)


def hold_rotation(model_type):
    """tests/test_equivariance.py's two properties on the port, on
    LJ.json's node energy head over periodic cells (the positions and the
    edge shifts rotated together), with random weights and biases
    (`random_flax_variables`): the node energies are invariant under the
    rotation (to 1 % of their spread over the nodes: the JAX test's
    rtol 5e-3 would not resolve that spread at init), and the forces
    rotate with it (the JAX test's bound)."""
    samples = lj_configurations(4, seed=3)
    cfg = lj_config(model_type)
    cfg["NeuralNetwork"]["Architecture"].update(
        EXTRA_ARCH.get(model_type, {}))
    mcfg = data_input_dim(tcfg.build_model_config(
        tcfg.update_config(cfg, samples)), samples)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(random_flax_variables(model,
                                                                   2)))
    tb = with_triplets(model_type, tbatch.collate(samples), samples)
    r = torch.from_numpy(_rotation(5))
    rb = tb.replace(pos=tb.pos @ r.T, edge_shifts=tb.edge_shifts @ r.T)
    real = tb.node_mask
    with torch.no_grad():
        (e1,), _ = model(tb)
        (e2,), _ = model(rb)
    # the node energies at init vary little (MACE's by ~1e-4): the
    # rotation may move them by 1 % of their spread
    e1, e2 = e1[real].numpy(), e2[real].numpy()
    spread = float(np.ptp(e1))
    assert spread > 1e-5
    assert float(np.abs(e2 - e1).max()) <= 1e-2 * spread
    _, f1 = energy_forces_from_node_head(model, tb)
    _, f2 = energy_forces_from_node_head(model, rb)
    assert float(f1[real].abs().max()) > 1e-3
    np.testing.assert_allclose(f2[real].numpy(), (f1 @ r.T)[real].numpy(),
                               rtol=5e-3, atol=1e-4)


def hold_weights_round_trip(model_type):
    cfg = lj_config(model_type)
    cfg["NeuralNetwork"]["Architecture"].update(
        EXTRA_ARCH.get(model_type, {}))
    _, _, tm, _, _, variables = model_pair(cfg, lj_configurations(2),
                                           False, seed=4)
    got = export_jax_variables(port_model(tm, variables))
    assert got["batch_stats"] == {}
    assert_tree_close(got["params"], variables["params"],
                      dict(rtol=0, atol=0))
    fresh = create_model(tm, device="cpu", seed=1)
    assert set(fresh.state_dict()) == set(port_model(tm, variables)
                                          .state_dict())
    return got


def hold_lj_run_training(model_type, tmp_path, monkeypatch, cfg=None,
                         samples=None, serve=(False, True)):
    """LJ.json (hidden 8, its 2 layers, batch 8, SGD) on 40 cells, 2
    epochs through both packages' run_training from the same Flax
    variables (the dense layout, the run_training default): completed
    configs bitwise, histories within TRAIN_TOL; then run_prediction from
    the trained states through the port's loop (and its InferenceEngine
    on the edge list, `serve`) against JAX's loop."""
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu.preprocess.load_data import split_dataset
    from hydragnn_tpu_torch import run_prediction
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    samples = samples or lj_configurations(40, seed=13)
    splits = split_dataset(samples, 0.8)
    if cfg is None:
        cfg = lj_config(model_type)
        cfg["NeuralNetwork"]["Architecture"].update(
            EXTRA_ARCH.get(model_type, {}))
        cfg["NeuralNetwork"]["Training"].update(
            num_epoch=2, batch_size=8, keep_best=False,
            Optimizer={"type": "SGD", "learning_rate": 1e-3})
    jrun = importlib.import_module("hydragnn_tpu.run_training")
    prun = importlib.import_module("hydragnn_tpu_torch.run_training")
    inits = []

    def spy_init(*args, **kwargs):
        inits.append(numpy_tree(j_init_params(*args, **kwargs)))
        return jax.tree_util.tree_map(jnp.asarray, inits[-1])
    monkeypatch.setattr(jrun, "init_params", spy_init)
    jsplits = tuple(jax_samples(s) for s in splits)
    jstate, jhist, jmodel, jdone = jrun.run_training(
        copy.deepcopy(cfg), datasets=jsplits, num_shards=1)

    def load_init(mcfg, device="cuda", seed=0):
        model = create_model(mcfg, device=device, seed=seed)
        model.load_state_dict(load_jax_variables(inits[0]))
        return model
    monkeypatch.setattr(prun, "create_model", load_init)
    state, hist, model, done = prun.run_training(
        copy.deepcopy(cfg), datasets=splits, device="cpu")
    assert done == jdone
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], err_msg=key,
                                   **TRAIN_TOL)
    jtrues, jpreds = j_run_prediction(jdone, datasets=jsplits, state=jstate,
                                      model=jmodel, serve=False)
    for s in serve:
        trues, preds = run_prediction(done, datasets=splits, state=state,
                                      model=model, device="cpu", serve=s)
        np.testing.assert_array_equal(trues[0], np.asarray(jtrues[0]))
        assert preds[0].shape == np.asarray(jpreds[0]).shape
        assert np.isfinite(preds[0]).all()
        np.testing.assert_allclose(preds[0], np.asarray(jpreds[0]),
                                   **TRAIN_TOL)
    return hist, jhist


# ------------------------------------------------------------ the tests --
@MODELS
@LAYOUTS
def test_forward_and_vjp_match_jax(model_type, dense):
    hold_forward_and_vjp(model_type, dense)


@MODELS
@LAYOUTS
def test_energy_force_loss_and_gradient_match_jax(model_type, dense):
    hold_ef_loss(model_type, dense)


@MODELS
@LAYOUTS
def test_energy_force_sgd_steps_match_jax(model_type, dense):
    hold_ef_sgd_steps(model_type, dense)


@MODELS
def test_weights_round_trip(model_type):
    got = hold_weights_round_trip(model_type)
    # the last conv has no vector re-embedding, as in Flax
    assert "vec_embed" in got["params"]["conv_0"]
    assert "vec_embed" not in got["params"]["conv_1"]


@MODELS
def test_rotation_invariant_outputs_and_covariant_forces(model_type):
    hold_rotation(model_type)


@MODELS
def test_lj_run_training_and_prediction_match_jax(model_type, tmp_path,
                                                   monkeypatch):
    hold_lj_run_training(model_type, tmp_path, monkeypatch)


def test_vector_segment_sum_runs_the_kernel_route(monkeypatch):
    """[E, 3, F] and [E, mul, 2l+1] segment sums go to
    kernels.segment.segment_sum as [E, prod] rows (on the CPU its plain
    version) and equal the plain version of the 3-D data bitwise, in
    value and gradient; segment_count is untouched."""
    from hydragnn_tpu_torch.kernels import segment as kseg
    calls = []
    real = kseg.segment_sum

    def spy(data, *args, **kwargs):
        calls.append(tuple(data.shape))
        return real(data, *args, **kwargs)
    monkeypatch.setattr(tseg._seg_kernel, "segment_sum", spy)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(-1, 9, 60).astype(np.int32))
    mask = torch.from_numpy(rng.rand(60) > 0.2)
    for shape in ((60, 3, 5), (60, 4, 5), (60, 2, 3, 2)):
        data = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        data.requires_grad_(True)
        got = tseg.segment_sum(data, ids, 8, mask)
        want = kseg.segment_sum_plain(
            torch.where(mask.view(-1, *[1] * (len(shape) - 1)), data,
                        torch.zeros_like(data)), ids, 8)
        assert got.shape == (8,) + shape[1:]
        assert torch.equal(got, want)
        cot = torch.from_numpy(rng.randn(*got.shape).astype(np.float32))
        (g1,) = torch.autograd.grad(torch.sum(got * cot), data)
        (g2,) = torch.autograd.grad(torch.sum(want * cot), data)
        assert torch.equal(g1, g2)
        assert calls[-1] == (60, int(np.prod(shape[1:])))
    n = len(calls)
    tseg.segment_count(ids, 8, mask)
    assert len(calls) == n


@pytest.mark.parametrize("reduce", ["amax", "amin"])
def test_segment_extremes_differentiate_as_scatter_reduce(reduce):
    """ops.segment's segment max / min (PNAEq's edge-list statistics):
    values and gradients bitwise scatter_reduce's under autograd (ties
    split evenly, empty segments 0), and the gradient's own gradient
    (the second derivative a force loss takes) within float32 rounding:
    it is now a segment sum in a fixed order."""
    rng = np.random.RandomState(4)
    data = torch.from_numpy(rng.randint(-3, 4, (50, 3)).astype(np.float32))
    data.requires_grad_(True)
    ids = torch.from_numpy(rng.randint(-1, 13, 50).astype(np.int32))
    mask = torch.from_numpy(rng.rand(50) > 0.2)
    neutral = -1e30 if reduce == "amax" else 1e30
    got = tseg._segment_extreme(data, ids, 12, mask, neutral, reduce)
    idl = ids.long()
    valid = (idl >= 0) & (idl < 12) & mask
    masked = torch.where(valid[:, None], data, torch.full_like(data, neutral))
    index = torch.where(valid, idl, torch.zeros_like(idl))[:, None]
    want = torch.full((12, 3), neutral).scatter_reduce(
        0, index.expand_as(masked), masked, reduce=reduce, include_self=True)
    assert torch.equal(got, want)
    cot = torch.from_numpy(rng.randn(12, 3).astype(np.float32))
    cot.requires_grad_(True)
    (g1,) = torch.autograd.grad(torch.sum(got * cot), data, create_graph=True)
    (g2,) = torch.autograd.grad(torch.sum(want * cot), data,
                                create_graph=True)
    assert torch.equal(g1, g2)
    w = torch.from_numpy(rng.randn(50, 3).astype(np.float32))
    (h1,) = torch.autograd.grad(torch.sum(g1 * w), cot)
    (h2,) = torch.autograd.grad(torch.sum(g2 * w), cot)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("model_type", ["PAINN", "PNAEq"])
def test_lattice_threshold(model_type, monkeypatch):
    """tests/test_graphs_full.py's rows (PAINN and PNAEq RMSE < 0.60)
    through the port's run_training; slow, as the JAX rows are (they run
    on the card in chip_smoke.py phase 15)."""
    from tests.test_torch_invariant_convs import lattice_threshold_rmse
    rmse = lattice_threshold_rmse(model_type, monkeypatch)
    assert rmse < 0.60, f"{model_type} RMSE {rmse:.4f} above 0.60"
