"""The port's DimeNet (models/dimenet.py) against the JAX package's on the
CPU, with the Flax weights carried across, on the dense neighbor layout
and the edge list: at LJ.json's DimeNet keys (num_radial 8,
num_spherical 4, int_emb 16, basis_emb 8, out_emb 32) cut to hidden 8,
the forward and its VJP with respect to the positions and every
parameter, and the energy-force pin below; on the BCC lattice (a graph
head), 3 SGD steps and both packages' run_training and run_prediction
(the triplet transform wired into both entry points, run_prediction's
engine fallback and run_training's packing fallback); the weight round
trip. The lattice row of tests/test_graphs_full.py is slow here, as it
is for the JAX package.

The pin: DimeNet's energy-force gradient is not finite in the JAX
package (its padding triplets point at the zero-length padding edge,
where the angle's |a x b| and atan2 take their gradient at the origin),
and the port computes the angle as JAX does, so it is not finite in the
port either, in the same places: the padding node's forces and the
energy-force loss's parameter gradients. The real nodes' forces agree.

Bound: rtol 1e-4 / atol 1e-5 (TRAIN_TOL).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu.train.loss import energy_forces_from_node_head as j_ef
from hydragnn_tpu_torch.graphs.synthetic import (bcc_lattices,
                                                 lj_configurations)
from hydragnn_tpu_torch.graphs.triplets import make_triplet_transform
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
from tests.test_torch_invariant_convs import hold_sgd_steps, setup_models
from tests.test_torch_painn_pnaeq import (LAYOUTS, TRAIN_TOL,
                                          hold_forward_and_vjp,
                                          hold_lj_run_training,
                                          hold_weights_round_trip, lj_config,
                                          model_pair, port_model)
from tests.utils import make_config

torch.set_num_threads(1)


def lattice_config(**training):
    cfg = make_config("DimeNet", hidden_dim=8, num_conv_layers=2,
                      num_spherical=4)
    cfg["NeuralNetwork"]["Training"].update(training)
    return cfg


@LAYOUTS
def test_forward_and_vjp_match_jax(dense):
    """The real nodes' outputs and gradients; the padding node's position
    gradient is not finite in either package."""
    model, _ = hold_forward_and_vjp("DimeNet", dense, finite=False)
    assert model.conv_0.interaction.lin_down.out_features == 16
    assert model.conv_0.output.lin_up.out_features == 32


@LAYOUTS
def test_energy_force_gradient_is_nonfinite_where_jax_is(dense):
    """On 4 LJ cells: energies and the real nodes' forces within
    TRAIN_TOL of JAX's; the padding node's forces non-finite in both; the
    energy-force loss and its parameter gradients non-finite in both, the
    same entries; and without the padding triplets (the tables cut to the
    real ones) every force and gradient finite: the padding triplets, not
    a collinear real one, are the source."""
    samples = lj_configurations(4, seed=1)
    jmodel, jm, tm, tb, jb, variables = model_pair(lj_config("DimeNet"),
                                                   samples, dense)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    je, jf, _ = j_ef(lambda v, b, train: (jmodel.apply(v, b, train=train),
                                          None), jvars, jb, train=False)
    model = port_model(tm, variables)
    e, f = energy_forces_from_node_head(model, tb)
    real, gm = tb.node_mask.numpy(), tb.graph_mask.numpy()
    jf, f = np.asarray(jf), f.numpy()
    np.testing.assert_allclose(e.numpy()[gm], np.asarray(je)[gm], **TRAIN_TOL)
    np.testing.assert_allclose(f[real], jf[real], rtol=TRAIN_TOL["rtol"],
                               atol=TRAIN_TOL["atol"]
                               + TRAIN_TOL["rtol"] * np.abs(jf[real]).max())
    assert np.isfinite(f[real]).all() and np.isfinite(jf[real]).all()
    assert not np.isfinite(jf[~real]).all()
    assert not np.isfinite(f[~real]).all()

    jloss = jstep.make_loss_fn(jmodel, jm, "mae", compute_grad_energy=True)
    (want, _), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jvars["params"], {}, jb)
    model.train()
    loss_fn = tstep.make_loss_fn(model, tm, "mae", compute_grad_energy=True)
    total, _ = loss_fn(tb)
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    assert not np.isfinite(float(want)) and not torch.isfinite(total)
    jbad = sum(int((~np.isfinite(np.asarray(g))).sum())
               for g in jax.tree_util.tree_leaves(want_g))
    bad = sum(int((~torch.isfinite(g)).sum()) for g in grads)
    assert bad == jbad > 0

    t = int(tb.triplet_mask.sum())
    cut = tb.replace(idx_kj=tb.idx_kj[:t], idx_ji=tb.idx_ji[:t],
                     triplet_mask=tb.triplet_mask[:t])
    model.eval()
    _, f_cut = energy_forces_from_node_head(model, cut)
    assert torch.isfinite(f_cut).all()
    np.testing.assert_array_equal(f_cut.numpy()[real], f[real])
    model.train()
    total, _ = loss_fn(cut)
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    assert torch.isfinite(total) and all(torch.isfinite(g).all()
                                         for g in grads)


@LAYOUTS
def test_sgd_steps_match_jax(dense):
    """3 SGD steps on the BCC lattice's graph head (batches of 8 with
    their triplet tables; the lattice holds collinear triplets, whose
    angle gradient no parameter gradient reads)."""
    samples = bcc_lattices(24, seed=3)
    hold_sgd_steps(*setup_models(
        lattice_config(), samples, dense,
        batch_transform=make_triplet_transform(samples, 8)))


def test_weights_round_trip():
    got = hold_weights_round_trip("DimeNet")
    conv = got["params"]["conv_0"]
    assert sorted(conv) == ["emb", "interaction", "lin", "output"]
    assert "bias" not in conv["interaction"]["lin_sbf1"]
    assert conv["interaction"]["lin_sbf1"]["kernel"].shape == (4 * 8, 8)


def test_lattice_run_training_and_prediction_match_jax(tmp_path,
                                                       monkeypatch, caplog):
    """The lattice (hidden 8, batch 8, SGD) on 40 graphs, 2 epochs through
    both packages' run_training from the same Flax variables, then
    run_prediction through the loop, and with serve=True, which falls
    back to the loop with the JAX package's warning."""
    cfg = lattice_config(num_epoch=2, batch_size=8, keep_best=False,
                         Optimizer={"type": "SGD", "learning_rate": 1e-3})
    with caplog.at_level(logging.WARNING, logger="hydragnn_tpu_torch"):
        hold_lj_run_training("DimeNet", tmp_path, monkeypatch, cfg=cfg,
                             samples=bcc_lattices(40, seed=5))
    assert "does not support triplet batch transforms" in caplog.text


def test_packing_falls_back_to_fixed_batches(tmp_path, monkeypatch, capsys):
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    monkeypatch.chdir(tmp_path)
    cfg = lattice_config(num_epoch=1, batch_size=8, batch_packing=True)
    _, hist, _, _ = run_training(cfg, datasets=split_dataset(
        bcc_lattices(24, seed=6), 0.7), device="cpu")
    assert "falling back to fixed-shape batching" in capsys.readouterr().out
    assert np.isfinite(hist["train_loss"]).all()


@pytest.mark.slow
def test_lattice_threshold(monkeypatch):
    """tests/test_graphs_full.py's DimeNet row (RMSE < 0.50) through the
    port's run_training; slow, as the JAX row is (it runs on the card in
    chip_smoke.py phase 15)."""
    from tests.test_torch_invariant_convs import lattice_threshold_rmse
    rmse = lattice_threshold_rmse("DimeNet", monkeypatch)
    assert rmse < 0.50, f"DimeNet RMSE {rmse:.4f} above 0.50"
