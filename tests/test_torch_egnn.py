"""The port's EGNN (models/egnn.py: `EGCL`, `EGCLStack`) against the JAX
package's on the CPU, on the dense neighbor layout and the edge list,
with the Flax weights carried across; the synthetic OC20 slabs
(graphs/synthetic.py `oc20_slabs`) against the example's generator; the
OC20 energy and forces configs through both packages' run_training and
run_prediction; the rotation test; and the lattice threshold.

Bound: rtol 1e-4 / atol 1e-5 (TRAIN_TOL) unless stated; gradients with
atol grown by rtol times each tensor's largest entry. The slabs are
periodic (10.8 x 10.8 x 25 A cells, radius 5): every conv sees PBC edge
shifts, and the edge length as the edge feature, as in the OC20 configs.
"""
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.models import egnn as jegnn
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import oc20_slabs
from hydragnn_tpu_torch.models import egnn as tegnn
from hydragnn_tpu_torch.models.create import create_model, data_input_dim
from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.test_torch_invariant_convs import (FIELDS, hold_sgd_steps,
                                              jax_samples,
                                              lattice_threshold_rmse)
from tests.test_torch_train import (_grads_as_flax, _jax_view,
                                    assert_tree_close, jax_batch, numpy_tree)

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
OC20 = ROOT / "examples" / "open_catalyst_2020"
LAYOUTS = pytest.mark.parametrize("dense", [True, False],
                                  ids=["dense", "edge"])


def oc20_config(which="energy", **arch):
    with open(OC20 / f"open_catalyst_{which}.json") as fh:
        cfg = json.load(fh)
    cfg["NeuralNetwork"]["Architecture"].update(arch)
    return cfg


def collated(samples, dense):
    tb = tbatch.collate(samples)
    if dense:
        tb = tbatch.with_neighbor_format(tb)
    return tb, jax_batch(_jax_view(tb))


def test_oc20_slabs_match_the_example_bitwise(monkeypatch, tmp_path):
    """oc20_slabs: the frames examples/open_catalyst_2020/oc20_data.py
    generates (seed for seed, chunk after chunk) through
    examples/common_atomistic.py's frame_to_sample, every field bitwise."""
    from examples.common_atomistic import frame_to_sample
    from examples.open_catalyst_2020 import oc20_data
    frames = []
    monkeypatch.setattr(oc20_data, "write_extxyz",
                        lambda path, fr, mode="w": frames.extend(fr))
    oc20_data.generate_oc20_dataset(str(tmp_path), num_chunks=2,
                                    frames_per_chunk=6, seed=3)
    want = [frame_to_sample(f.z, f.pos, f.info["free_energy"],
                            f.arrays["forces"], 5.0, 512, cell=f.cell)
            for f in frames]
    got = oc20_slabs(12, seed=3)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.num_nodes == 29 and g.edge_shifts is not None
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, f)


@pytest.mark.parametrize("cutoff", [0.0, 5.0], ids=["r2-relu", "sinc-silu"])
@pytest.mark.parametrize("equivariant", [False, True],
                         ids=["invariant", "equivariant"])
@LAYOUTS
def test_egcl_matches_jax(cutoff, equivariant, dense):
    """One EGCL on random features over 3 periodic slabs (edge lengths as
    the edge feature): the features and positions it gives, and the
    gradients of a random projection of both with respect to the
    features, the positions and every parameter."""
    samples = oc20_slabs(3, seed=5)
    tb, jb = collated(samples, dense)
    rng = np.random.RandomState(0)
    x = rng.randn(tb.num_nodes, 7).astype(np.float32)
    jconv = jegnn.EGCL(out_dim=8, hidden_dim=8, edge_dim=1,
                       equivariant=equivariant, cutoff=cutoff, num_rbf=16)
    tconv = tegnn.EGCL(7, 8, hidden_dim=8, edge_dim=1,
                       equivariant=equivariant, cutoff=cutoff, num_rbf=16)
    variables = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x), jb.pos,
                           jb, {})
    tconv.load_state_dict(load_jax_variables(numpy_tree(variables)))
    pos = np.asarray(jb.pos)
    wh, wp = jconv.apply(variables, jnp.asarray(x), jb.pos, jb, {})
    ch = rng.randn(*wh.shape).astype(np.float32)
    cp = rng.randn(*wp.shape).astype(np.float32)
    real = tb.node_mask.numpy()
    ch[~real] = 0.0
    cp[~real] = 0.0

    def jloss(p, xx, pp):
        h, q = jconv.apply({"params": p}, xx, pp, jb, {})
        return jnp.sum(h * ch) + jnp.sum(q * cp)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(variables["params"],
                                            jnp.asarray(x), jnp.asarray(pos))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(pos.copy()).requires_grad_(True)
    gh, gp = tconv(xt, pt, tb, {})
    np.testing.assert_allclose(gh.detach().numpy()[real],
                               np.asarray(wh)[real], **TRAIN_TOL)
    np.testing.assert_allclose(gp.detach().numpy()[real],
                               np.asarray(wp)[real], **TRAIN_TOL)
    if not equivariant:
        assert torch.equal(gp, pt)
    params = list(tconv.parameters())
    grads = torch.autograd.grad(
        torch.sum(gh * torch.from_numpy(ch))
        + torch.sum(gp * torch.from_numpy(cp)), [xt, pt] + params)
    for g, w in zip(grads[:2], jg[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy()[real], w[real], rtol=TRAIN_TOL["rtol"],
            atol=TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * np.abs(w).max())
    assert_tree_close(_grads_as_flax(tconv, grads[2:]), numpy_tree(jg[0]),
                      TRAIN_TOL, scaled=True)


@pytest.fixture(scope="module")
def oc20_models():
    """The OC20 energy and forces configs at their published widths
    (EGNN hidden 50, 3 layers, equivariant, radius 5, edge lengths) over
    6 slabs: {which: (samples, JAX model, port ModelConfig)}."""
    samples = oc20_slabs(6, seed=7)
    out = {}
    for which in ("energy", "forces"):
        cfg = oc20_config(which)
        tc = tcfg.update_config(copy.deepcopy(cfg), samples)
        jc = jcfg.update_config(copy.deepcopy(cfg), jax_samples(samples))
        jmodel = j_create_model(jcfg.build_model_config(jc))
        out[which] = (samples, jmodel, data_input_dim(
            tcfg.build_model_config(tc), samples))
    return out


@pytest.mark.parametrize("which", ["energy", "forces"])
@LAYOUTS
def test_egnn_stack_at_oc20_width_matches_jax(oc20_models, which, dense):
    samples, jmodel, mcfg = oc20_models[which]
    assert (mcfg.model_type, mcfg.hidden_dim, mcfg.num_conv_layers,
            mcfg.equivariance, mcfg.radius, mcfg.edge_dim,
            mcfg.input_dim) == ("EGNN", 50, 3, True, 5.0, 1, 7)
    tb, jb = collated(samples, dense)
    variables = numpy_tree(j_init_params(jmodel, jb, seed=3))
    assert not variables.get("batch_stats")       # no feature norms
    want, _ = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                           jb, train=False)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    with torch.no_grad():
        got, _ = model(tb)
    mask = (tb.graph_mask if which == "energy" else tb.node_mask).numpy()
    g, w = got[0].numpy()[mask], np.asarray(want[0])[mask]
    assert g.shape == ((6, 1) if which == "energy" else (6 * 29, 3))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, **TRAIN_TOL)


def _rotation(seed):
    from scipy.spatial.transform import Rotation
    return Rotation.random(random_state=seed).as_matrix().astype(np.float32)


def test_egnn_rotation_invariant_energy_covariant_positions_and_forces():
    """EGNN at the OC20 energy config's layout (equivariant, sinc radial,
    edge lengths) on periodic slabs, positions and PBC shifts rotated
    together: the graph energies are invariant and every layer's
    updated positions rotate with the frame (rtol 5e-3 / atol 5e-4, the
    JAX package's test_equivariance.py bound); so do the forces of a
    node-energy head."""
    samples = oc20_slabs(4, seed=9)
    cfg = oc20_config("energy", hidden_dim=16)
    tc = tcfg.update_config(copy.deepcopy(cfg), samples)
    mcfg = data_input_dim(tcfg.build_model_config(tc), samples)
    model = create_model(mcfg, device="cpu", seed=2)
    tb = tbatch.collate(samples)
    r = torch.from_numpy(_rotation(5))
    rb = tb.replace(pos=tb.pos @ r.T, edge_shifts=tb.edge_shifts @ r.T)
    real = tb.node_mask
    with torch.no_grad():
        (e1,), _ = model(tb)
        (e2,), _ = model(rb)
        _, p1 = model.encode(tb, model.conv_args(tb))
        _, p2 = model.encode(rb, model.conv_args(rb))
    gm = tb.graph_mask
    np.testing.assert_allclose(e2[gm].numpy(), e1[gm].numpy(), rtol=5e-3,
                               atol=5e-4)
    assert float((p1 - tb.pos)[real].abs().max()) > 1e-4    # they moved
    np.testing.assert_allclose(p2[real].numpy(), (p1 @ r.T)[real].numpy(),
                               rtol=5e-3, atol=5e-4)
    node = copy.deepcopy(cfg)
    node["NeuralNetwork"]["Architecture"]["output_heads"] = {
        "node": {"num_headlayers": 2, "dim_headlayers": [16, 16],
                 "type": "mlp"}}
    node["NeuralNetwork"]["Variables_of_interest"].update(
        type=["node"], output_names=["energy"], output_dim=[1])
    mcfg = data_input_dim(tcfg.build_model_config(tcfg.update_config(
        node, samples)), samples)
    model = create_model(mcfg, device="cpu", seed=2)
    _, f1 = energy_forces_from_node_head(model, tb)
    _, f2 = energy_forces_from_node_head(model, rb)
    assert float(f1[real].abs().max()) > 1e-4
    np.testing.assert_allclose(f2[real].numpy(), (f1 @ r.T)[real].numpy(),
                               rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("which", ["energy", "forces"])
@LAYOUTS
def test_egnn_sgd_steps_match_jax(which, dense):
    """3 SGD steps of the OC20 configs cut to hidden 8 (their layouts
    and losses: mae on the graph energy or on the node forces) from the
    same Flax variables."""
    from tests.test_torch_invariant_convs import setup_models
    samples = oc20_slabs(12, seed=11)
    cfg = oc20_config(which, hidden_dim=8)
    head = cfg["NeuralNetwork"]["Architecture"]["output_heads"]
    for h in head.values():
        h["dim_headlayers"] = [8, 8]
        if "dim_sharedlayers" in h:
            h["dim_sharedlayers"] = 8
    jmodel, jm, tm, batches, variables = setup_models(cfg, samples, dense,
                                                      batch_size=4)
    hold_sgd_steps(jmodel, jm, data_input_dim(tm, samples), batches,
                   variables, loss="mae")


def test_egnn_weights_round_trip(oc20_models):
    samples, jmodel, mcfg = oc20_models["energy"]
    _, jb = collated(samples, False)
    variables = numpy_tree(j_init_params(jmodel, jb, seed=4))
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    got = export_jax_variables(model)
    assert got["batch_stats"] == {}         # Flax makes no empty collection
    assert_tree_close(got["params"], variables["params"],
                      dict(rtol=0, atol=0))
    assert model.conv_2.coords_range.shape == (1,)
    fresh = create_model(mcfg, device="cpu")
    assert float(fresh.conv_0.coords_range.detach()) == 3.0


@pytest.mark.parametrize("which", ["energy", "forces"])
def test_oc20_run_training_and_prediction_match_jax(tmp_path, monkeypatch,
                                                    which):
    """The slice's path at a cut width: the OC20 config (hidden 8, its 3
    layers, batch 8) on 40 slabs, 2 epochs of SGD through both packages'
    run_training from the same Flax variables (the dense layout, the
    run_training default): completed configs bitwise, histories within
    TRAIN_TOL; then run_prediction from the trained states through the
    port's loop and its InferenceEngine (edge list) against JAX's."""
    import importlib
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu.preprocess.load_data import split_dataset
    from hydragnn_tpu_torch import run_prediction
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    samples = oc20_slabs(40, seed=13)
    splits = split_dataset(samples, 0.8)
    cfg = oc20_config(which, hidden_dim=8)
    for h in cfg["NeuralNetwork"]["Architecture"]["output_heads"].values():
        h["dim_headlayers"] = [8, 8]
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
    for serve in (False, True):
        trues, preds = run_prediction(done, datasets=splits, state=state,
                                      model=model, device="cpu", serve=serve)
        np.testing.assert_array_equal(trues[0], np.asarray(jtrues[0]))
        assert preds[0].shape == np.asarray(jpreds[0]).shape
        np.testing.assert_allclose(preds[0], np.asarray(jpreds[0]),
                                   **TRAIN_TOL)


def test_egnn_meets_the_lattice_threshold(monkeypatch):
    """tests/test_graphs_full.py's EGNN row (RMSE < 0.20) through the
    port's run_training (`lattice_threshold_rmse`)."""
    rmse = lattice_threshold_rmse("EGNN", monkeypatch)
    assert rmse < 0.20, f"EGNN RMSE {rmse:.4f} above threshold 0.20"
