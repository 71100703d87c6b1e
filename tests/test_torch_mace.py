"""The port's MACE (models/mace.py) against the JAX package's on the CPU,
with the Flax weights carried across (MACE's `LinearIrreps` leaves
untransposed), on the dense neighbor layout and the edge list, at
LJ.json's MACE keys (max_ell 2, node_max_ell 1, correlation [2]) cut to
hidden 8: the forward and its VJP with respect to the positions and
every parameter (also with the other radial bases, distance transforms
and a deeper correlation), the energy-force loss and its parameter
gradient (forces through the per-graph position centring), 3
energy-force SGD steps, the weight round trip, the two rotation
properties of tests/test_equivariance.py, and LJ energy-force training
through both packages' run_training and run_prediction. The lattice row
of tests/test_graphs_full.py is slow here, as it is for the JAX package.

Bound: rtol 1e-4 / atol 1e-5 (TRAIN_TOL); the helpers are
tests/test_torch_painn_pnaeq.py's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.models import mace as jmace
from hydragnn_tpu_torch.models import mace as tmace
from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
from tests.test_torch_painn_pnaeq import (LAYOUTS, hold_ef_loss,
                                          hold_ef_sgd_steps,
                                          hold_forward_and_vjp,
                                          hold_lj_run_training,
                                          hold_rotation,
                                          hold_weights_round_trip)

torch.set_num_threads(1)


@LAYOUTS
def test_forward_and_vjp_match_jax(dense):
    model, _ = hold_forward_and_vjp("MACE", dense)
    # LJ.json's keys: l <= 1 between the layers, l = 0 after the last
    assert model.product_0.out_ls == [0, 1]
    assert model.product_1.out_ls == [0]
    assert model.interaction_0.lin_up.lin_l0.shape == (8, 8)


@pytest.mark.parametrize("arch", [
    dict(radial_type="gaussian", distance_transform="Agnesi"),
    dict(radial_type="chebyshev", distance_transform="Soft"),
    dict(max_ell=3, node_max_ell=2, correlation=[3, 2]),
], ids=["gaussian-agnesi", "chebyshev-soft", "lmax3-corr3"])
def test_other_options_match_jax(arch):
    hold_forward_and_vjp("MACE", False, arch=arch)


@LAYOUTS
def test_energy_force_loss_and_gradient_match_jax(dense):
    hold_ef_loss("MACE", dense)


@LAYOUTS
def test_energy_force_sgd_steps_match_jax(dense):
    hold_ef_sgd_steps("MACE", dense)


def test_weights_round_trip():
    """Every LinearIrreps leaf crosses as it is, [mul_in, mul_out], with
    the keys the configuration gives (the residual's `sc` keeps l = 1 on
    the last layer, whose output holds l = 0 only)."""
    got = hold_weights_round_trip("MACE")
    params = got["params"]
    assert sorted(params["product_1"]["sc"]) == ["lin_l0", "lin_l1"]
    assert sorted(params["product_1"]["mix_2"]) == ["lin_l0"]
    assert sorted(params["interaction_0"]["lin_out"]) == ["lin_l0", "lin_l1"]
    assert params["node_embedding"]["kernel"].shape == (118, 8)


def test_process_node_attributes_matches_jax():
    x = np.asarray([[0.2], [1.0], [1.6], [26.5], [117.5], [300.0]],
                   np.float32)
    got = tmace.process_node_attributes(torch.from_numpy(x))
    want = jmace.process_node_attributes(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rotation_invariant_outputs_and_covariant_forces():
    hold_rotation("MACE")


def test_lj_run_training_and_prediction_match_jax(tmp_path, monkeypatch):
    hold_lj_run_training("MACE", tmp_path, monkeypatch,
                         samples=lj_configurations(32, seed=13))


@pytest.mark.slow
def test_lattice_threshold(monkeypatch):
    """tests/test_graphs_full.py's MACE row (RMSE < 0.70 with its
    EXTRA_ARCH keys) through the port's run_training; slow, as the JAX
    row is (it runs on the card in chip_smoke.py phase 15)."""
    from tests.test_torch_invariant_convs import lattice_threshold_rmse
    rmse = lattice_threshold_rmse("MACE", monkeypatch, max_ell=2,
                                  node_max_ell=1, correlation=[2])
    assert rmse < 0.70, f"MACE RMSE {rmse:.4f} above 0.70"


def test_new_modules_import_no_jax():
    """The slice's modules, and the host tables they build (sympy's CG
    coefficients, scipy's Bessel zeros), load neither jax nor the JAX
    package."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys; sys.path.insert(0, '.'); "
            "import hydragnn_tpu_torch.models.dimenet, "
            "hydragnn_tpu_torch.models.painn, "
            "hydragnn_tpu_torch.models.pnaeq, "
            "hydragnn_tpu_torch.models.mace, "
            "hydragnn_tpu_torch.graphs.triplets; "
            "from hydragnn_tpu_torch.ops import irreps, spherical; "
            "irreps.clebsch_gordan(1, 1, 2); "
            "spherical.spherical_norms(4, 8); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) "
            "or m == 'hydragnn_tpu' or m.startswith('hydragnn_tpu.')]; "
            "print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
