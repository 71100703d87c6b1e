"""The port's invariant convs and stacks (models/convs.py, stacks.py:
GIN, SAGE, GATv2, MFC, CGCNN, PNAPlus) against the JAX package's on the
CPU, on the dense neighbor layout and the edge list, with the Flax
weights carried across (utils/weights.py); the synthetic QM9 molecules;
qm9.json's GIN through run_training and run_prediction; and the models'
lattice thresholds (tests/test_graphs_full.py's THRESHOLDS) through the
port's run_training.

Bound: rtol 1e-4 / atol 1e-5 (TRAIN_TOL) on real rows and graphs; the
two packages differ in the order of the float32 sums inside GEMMs and
reductions. Gradients of a conv and of the first SGD step are held with
atol grown by rtol times each tensor's largest entry (a gradient's error
scales with its tensor). Training is held with SGD: Adam turns rounding
noise below its eps into lr-sized steps (tests/test_torch_train.py).
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
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.models import convs as jconvs
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.ops.basis import bessel_basis as j_bessel
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import (qm9_molecules,
                                                 synthetic_molecules)
from hydragnn_tpu_torch.models import convs as tconvs
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.ops.basis import bessel_basis
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.test_torch_pna import randomize_batch_stats
from tests.test_torch_train import (_grads_as_flax, _jax_view,
                                    assert_tree_close, jax_batch, numpy_tree)
from tests.utils import make_config

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
QM9 = ROOT / "examples" / "qm9" / "qm9.json"
FEATURES = 5
HIDDEN = 8

# (model_type, extra architecture keys); CGCNN also with edge lengths
MODELS = [("GIN", {}), ("SAGE", {}), ("GAT", {}), ("MFC", {}),
          ("CGCNN", {}), ("CGCNN", {"edge_features": ["length"]}),
          ("PNAPlus", {})]
MODEL_IDS = ["GIN", "SAGE", "GAT", "MFC", "CGCNN", "CGCNN-lengths",
             "PNAPlus"]
LAYOUTS = pytest.mark.parametrize("dense", [True, False],
                                  ids=["dense", "edge"])
# the lattice thresholds; GAT and PNAPlus are slow, as in the JAX suite
THRESHOLDS = {"GIN": 0.25, "SAGE": 0.20, "MFC": 0.30, "CGCNN": 0.50,
              "GAT": 0.60, "PNAPlus": 0.20}
_SLOW = {"GAT", "PNAPlus"}

FIELDS = ("x", "pos", "senders", "receivers", "edge_attr", "edge_shifts",
          "y_graph", "y_node", "cell", "energy", "forces")


def jax_samples(samples):
    """The JAX GraphSamples of port samples, every field carried."""
    return [jbatch.GraphSample(**{f: getattr(s, f) for f in FIELDS})
            for s in samples]


def with_edge_lengths(samples):
    for s in samples:
        vec = s.pos[s.senders] - s.pos[s.receivers]
        if s.edge_shifts is not None:
            vec = vec + s.edge_shifts
        s.edge_attr = np.linalg.norm(vec, axis=1,
                                     keepdims=True).astype(np.float32)
    return samples


def molecules(n=16, seed=3, lengths=False):
    samples = synthetic_molecules(n, seed=seed, min_atoms=4, max_atoms=14,
                                  num_features=FEATURES, max_in_degree=6)
    return with_edge_lengths(samples) if lengths else samples


def small_config(model_type, arch):
    cfg = make_config(model_type, hidden_dim=HIDDEN, num_conv_layers=2,
                      radius=1.8, max_neighbours=6, **arch)
    cfg["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = \
        list(range(FEATURES))
    return cfg


def setup_models(cfg, samples, dense, seed=2, batch_size=8,
                 batch_transform=None):
    """(JAX model, JAX ModelConfig, port ModelConfig, port loader batches,
    Flax variables with random running statistics); `batch_transform`
    is the loader's (DimeNet's triplets)."""
    tc = tcfg.update_config(copy.deepcopy(cfg), samples)
    jc = jcfg.update_config(copy.deepcopy(cfg), jax_samples(samples))
    jm = jcfg.build_model_config(jc)
    jmodel = j_create_model(jm)
    batches = list(GraphDataLoader(samples, batch_size, shuffle=True, seed=1,
                                   neighbor_format=dense,
                                   batch_transform=batch_transform))
    variables = randomize_batch_stats(j_init_params(
        jmodel, jax_batch(_jax_view(batches[0])), seed=seed), seed + 3)
    return jmodel, jm, tcfg.build_model_config(tc), batches, variables


def port_model(tm, variables):
    model = create_model(tm, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return model


def hold_stack(jmodel, model, batch, variables):
    """Eval-mode outputs, and train-mode outputs with the updated running
    statistics, of the port's stack against the JAX package's."""
    jb = jax_batch(_jax_view(batch))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    gm = batch.graph_mask.numpy()
    want, _ = jmodel.apply(jvars, jb, train=False)
    model.eval()
    with torch.no_grad():
        got, var = model(batch)
    assert var is None
    assert np.isfinite(got[0].numpy()[gm]).all()
    np.testing.assert_allclose(got[0].numpy()[gm], np.asarray(want[0])[gm],
                               **TRAIN_TOL)
    if not variables["batch_stats"]:
        return
    (want, _), new = jmodel.apply(jvars, jb, train=True,
                                  mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        got, _ = model(batch)
    np.testing.assert_allclose(got[0].numpy()[gm], np.asarray(want[0])[gm],
                               **TRAIN_TOL)
    assert_tree_close(export_jax_variables(model)["batch_stats"],
                      numpy_tree(new["batch_stats"]), TRAIN_TOL)


def hold_sgd_steps(jmodel, jm, tm, batches, variables, loss="mse",
                   steps=3):
    """`steps` SGD steps with momentum from the same Flax variables: the
    first step's gradients, each step's loss, and the final parameters
    and running statistics."""
    train_cfg = {"Optimizer": {"type": "SGD", "learning_rate": 0.02}}
    tx = jopt.select_optimizer(train_cfg)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jtrain = jstep.make_train_step(jmodel, jm, tx, loss, donate=False)
    model = port_model(tm, variables)
    port_tx = topt.select_optimizer(train_cfg)
    state = tstep.TrainState.create(model, port_tx)
    train = tstep.make_train_step(model, tm, port_tx, loss)

    jb0 = jax_batch(_jax_view(batches[0]))
    (_, _), want_g = jax.value_and_grad(
        jstep.make_loss_fn(jmodel, jm, loss), has_aux=True)(
        jstate.params, jstate.batch_stats, jb0)
    model.train()
    total, _ = tstep.make_loss_fn(model, tm, loss)(batches[0])
    got_g = torch.autograd.grad(total, list(state.params.values()),
                                allow_unused=True, materialize_grads=True)
    with torch.no_grad():   # the probe forward updated the running stats
        for k, v in load_jax_variables(variables).items():
            if k.endswith((".mean", ".var")):
                state.batch_stats[k].copy_(v)
    assert_tree_close(_grads_as_flax(model, got_g), numpy_tree(want_g),
                      TRAIN_TOL, scaled=True)
    for b in (batches * steps)[:steps]:
        jstate, jm_ = jtrain(jstate, jax_batch(_jax_view(b)))
        state, m = train(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   **TRAIN_TOL)
        assert float(m["nonfinite_steps"]) == 0.0
    got = export_jax_variables(model)
    assert_tree_close(got["params"], numpy_tree(jstate.params), TRAIN_TOL,
                      scaled=True)
    assert_tree_close(got["batch_stats"], numpy_tree(jstate.batch_stats),
                      TRAIN_TOL)


# ------------------------------------------------------------- the convs --
def _conv_pair(model_type, deg, edge_dim, final=False):
    """(JAX conv, port conv) of one layer: FEATURES in, HIDDEN out."""
    if model_type == "GIN":
        return jconvs.GINConv(out_dim=HIDDEN), tconvs.GINConv(FEATURES,
                                                              HIDDEN)
    if model_type == "SAGE":
        return jconvs.SAGEConv(out_dim=HIDDEN), tconvs.SAGEConv(FEATURES,
                                                                HIDDEN)
    if model_type == "GAT":
        return (jconvs.GATv2Conv(out_dim=HIDDEN, heads=6,
                                 negative_slope=0.05, concat=not final),
                tconvs.GATv2Conv(FEATURES, HIDDEN, heads=6,
                                 negative_slope=0.05, concat=not final))
    if model_type == "MFC":
        return (jconvs.MFConv(out_dim=HIDDEN, max_degree=6),
                tconvs.MFConv(FEATURES, HIDDEN, max_degree=6))
    if model_type == "CGCNN":
        return (jconvs.CGConv(out_dim=FEATURES),
                tconvs.CGConv(FEATURES, edge_dim=edge_dim))
    return (jconvs.PNAConv(out_dim=HIDDEN, deg_hist=tuple(deg), rbf=True),
            tconvs.PNAConv(FEATURES, HIDDEN, deg_hist=tuple(deg), rbf_dim=6))


@pytest.mark.parametrize("model_type,arch", MODELS +
                         [("GAT", {"final": True})],
                         ids=MODEL_IDS + ["GAT-final"])
@LAYOUTS
def test_conv_matches_jax(model_type, arch, dense):
    """One conv layer on random features: its output and the gradients of
    a random projection of it with respect to the features and every
    parameter."""
    lengths = "edge_features" in arch
    samples = molecules(6, seed=11, lengths=lengths)
    tb = tbatch.collate(samples)
    if dense:
        tb = tbatch.with_neighbor_format(tb)
    jb = jax_batch(_jax_view(tb))
    rng = np.random.RandomState(0)
    x = rng.randn(tb.num_nodes, FEATURES).astype(np.float32)
    deg = tcfg.gather_deg(samples)
    jconv, tconv = _conv_pair(model_type, deg, int(lengths),
                              final=arch.get("final", False))
    jcargs, tcargs = {}, {}
    if model_type == "PNAPlus":
        vec = tb.pos[tb.senders] - tb.pos[tb.receivers]
        length = torch.sqrt(torch.sum(vec * vec, -1) + 1e-9)
        tcargs["rbf"] = bessel_basis(length, 1.8, 6, 5)
        jcargs["rbf"] = j_bessel(jnp.asarray(length.numpy()), 1.8, 6, 5)
    if model_type == "CGCNN" and not lengths:
        tb = tb.replace(edge_attr=None)
        jb = jb.replace(edge_attr=None)
    variables = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x), jb.pos,
                           jb, jcargs)
    params = numpy_tree(variables)["params"]
    tconv.load_state_dict(load_jax_variables({"params": params}))
    want = np.asarray(jconv.apply(variables, jnp.asarray(x), jb.pos, jb,
                                  jcargs)[0])
    c = rng.randn(*want.shape).astype(np.float32)
    real = tb.node_mask.numpy()
    c[~real] = 0.0

    def jloss(p, xx):
        out, _ = jconv.apply({"params": p}, xx, jb.pos, jb, jcargs)
        return jnp.sum(out * c)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(variables["params"],
                                                 jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, _ = tconv(xt, tb.pos, tb, tcargs)
    np.testing.assert_allclose(got.detach().numpy()[real], want[real],
                               **TRAIN_TOL)
    params_t = list(tconv.parameters())
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(c)),
                                [xt] + params_t)
    np.testing.assert_allclose(grads[0].numpy()[real],
                               np.asarray(jg_x)[real], **TRAIN_TOL)
    assert_tree_close(_grads_as_flax(tconv, grads[1:]), numpy_tree(jg_p),
                      TRAIN_TOL, scaled=True)


# ------------------------------------------------------------ the stacks --
@pytest.mark.parametrize("model_type,arch", MODELS, ids=MODEL_IDS)
@LAYOUTS
def test_stack_matches_jax(model_type, arch, dense):
    samples = molecules(lengths="edge_features" in arch)
    jmodel, _, tm, batches, variables = setup_models(
        small_config(model_type, arch), samples, dense)
    model = port_model(tm, variables)
    if model_type == "GAT":
        # concatenated heads: conv_0 gives 6 x 8 features, its norm and
        # conv_1 take them, conv_1 averages its heads
        assert model.feature_norm_0.scale.shape == (6 * HIDDEN,)
        assert model.conv_1.lin_l.in_features == 6 * HIDDEN
        assert model.feature_norm_1.scale.shape == (HIDDEN,)
    if model_type == "CGCNN":
        assert model.cfg.hidden_dim == FEATURES
    hold_stack(jmodel, model, batches[0], variables)


@pytest.mark.parametrize("model_type,arch", MODELS, ids=MODEL_IDS)
def test_weights_round_trip(model_type, arch):
    """export_jax_variables ∘ load_jax_variables is the identity on the
    Flax tree, bitwise, with every leaf of the JAX model's tree (eps,
    att, the MFC banks kept as they are)."""
    samples = molecules(lengths="edge_features" in arch)
    _, _, tm, _, variables = setup_models(small_config(model_type, arch),
                                          samples, False)
    got = export_jax_variables(port_model(tm, variables))
    assert_tree_close(got, variables, dict(rtol=0, atol=0))
    with pytest.raises(KeyError):
        load_jax_variables({"params": {"conv_0": {"gamma": np.zeros(2)}}})


@pytest.mark.parametrize("model_type,arch", MODELS, ids=MODEL_IDS)
@LAYOUTS
def test_sgd_steps_match_jax(model_type, arch, dense):
    samples = molecules(24, seed=6, lengths="edge_features" in arch)
    hold_sgd_steps(*setup_models(small_config(model_type, arch), samples,
                                 dense))


def test_create_model_initializes_as_flax_by_shape():
    """init_params: GIN's eps 100, MFC's banks lecun_normal with fan_in
    d * in and zero bank biases, GAT's att with fan_in H; seeded."""
    samples = molecules()
    for model_type in ("GIN", "MFC", "GAT"):
        _, _, tm, _, _ = setup_models(small_config(model_type, {}), samples,
                                      False)
        model = create_model(tm, device="cpu", seed=4)
        again = create_model(tm, device="cpu", seed=4)
        for k, v in again.state_dict().items():
            assert torch.equal(v, model.state_dict()[k]), k
        if model_type == "GIN":
            assert float(model.conv_0.eps.detach()) == 100.0
        elif model_type == "MFC":
            w = model.conv_1.w_l.detach()
            assert w.shape == (7, HIDDEN, HIDDEN)
            assert abs(float(w.std()) - (7 * HIDDEN) ** -0.5) < 0.02
            assert float(model.conv_1.b_l.detach().abs().max()) == 0.0
        else:
            att = model.conv_0.att.detach()
            assert att.shape == (1, 6, HIDDEN)
            assert abs(float(att.std()) - 6 ** -0.5) < 0.15


@pytest.mark.parametrize("model_type", ["DimeNet", "PAINN", "PNAEq",
                                        "MACE"])
def test_unported_models_raise_naming_a7(model_type):
    """ROADMAP A7 is ported: each of the four models it named builds
    through create_model from the small config and runs a finite forward
    of the right shape (DimeNet on a batch with its triplet tables); the
    parity with the JAX package is held in test_torch_dimenet.py,
    test_torch_painn_pnaeq.py and test_torch_mace.py."""
    from hydragnn_tpu_torch.graphs.triplets import make_triplet_transform
    from hydragnn_tpu_torch.models.create import _NOT_PORTED
    samples = molecules()
    cfg = small_config(model_type, {"max_ell": 2, "num_spherical": 4})
    tm = tcfg.build_model_config(tcfg.update_config(cfg, samples))
    assert not _NOT_PORTED
    model = create_model(tm, device="cpu")
    batch = tbatch.collate(samples[:6])
    if model_type == "DimeNet":
        batch = make_triplet_transform(samples, 6)(batch, samples[:6])
    with torch.no_grad():
        out, _ = model(batch)
    gm = batch.graph_mask.numpy()
    assert out[0].shape == (batch.num_graphs, 1)
    assert np.isfinite(out[0].numpy()[gm]).all()


# -------------------------------------------------------------- QM9 GIN --
def test_qm9_molecules_match_the_example_bitwise():
    from examples.qm9.qm9_data import load_qm9
    want = load_qm9(str(ROOT / "no-such-dir"), 30, seed=4)
    got = qm9_molecules(30, seed=4)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, f)


def qm9_config():
    """examples/qm9/qm9.json without the two keys the port refuses or
    neither package reads: Visualization.create_plots (ROADMAP A10) and
    NeuralNetwork.Profile (the JAX package reads a top-level Profile
    only)."""
    with open(QM9) as fh:
        cfg = json.load(fh)
    cfg["Visualization"]["create_plots"] = False
    cfg["NeuralNetwork"].pop("Profile")
    return cfg


@LAYOUTS
def test_qm9_gin_run_training_matches_jax(tmp_path, monkeypatch, dense):
    """qm9.json's GIN at its published widths (hidden 5, 6 layers, heads
    [50, 25], batch 64) on 160 synthetic molecules, 2 epochs of SGD
    through both packages' run_training from the same Flax variables:
    the completed configs bitwise, the histories within TRAIN_TOL; then
    run_prediction from the trained states."""
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu.preprocess.load_data import split_dataset
    from hydragnn_tpu_torch import run_prediction
    import importlib
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    samples = qm9_molecules(160, seed=1)
    splits = split_dataset(samples, 0.7)
    cfg = qm9_config()
    cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
    cfg["NeuralNetwork"]["Training"].update(
        Optimizer={"type": "SGD", "learning_rate": 1e-3}, keep_best=False)
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
    assert model.cfg.model_type == "GIN" and model.cfg.hidden_dim == 5
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], err_msg=key,
                                   **TRAIN_TOL)
    trues, preds = run_prediction(done, datasets=splits, state=state,
                                  model=model, device="cpu")
    jtrues, jpreds = j_run_prediction(jdone, datasets=jsplits, state=jstate,
                                      model=jmodel)
    np.testing.assert_array_equal(trues[0], np.asarray(jtrues[0]))
    np.testing.assert_allclose(preds[0], np.asarray(jpreds[0]), **TRAIN_TOL)


# --------------------------------------------------------- the lattice --
def lattice_threshold_rmse(model_type, monkeypatch, **arch):
    """tests/test_graphs_full.py's run of a model through the port's
    run_training and run_prediction on the CPU: 60 epochs on the
    deterministic BCC lattice from the initial Flax variables the JAX
    package's run_training draws (its init_params at seed 0, carried
    across), so the row holds the port's training path from the JAX
    row's start. `arch` are the row's extra architecture keys
    (test_graphs_full.py's EXTRA_ARCH). Returns the test RMSE."""
    import importlib
    from hydragnn_tpu.graphs.batch import collate as j_collate
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    from tests.deterministic_data import deterministic_graph_dataset
    from tests.test_torch_train import to_port_samples
    jsamples = deterministic_graph_dataset(num_configs=160,
                                           heads=("graph",))
    splits = split_dataset(to_port_samples(jsamples), 0.7)
    cfg = make_config(model_type, **arch)
    train_cfg = cfg["NeuralNetwork"]["Training"]
    train_cfg["num_epoch"] = 60
    train_cfg["EarlyStopping"] = False
    jc = jcfg.update_config(copy.deepcopy(cfg), jsamples)
    jmodel = j_create_model(jcfg.build_model_config(jc))
    # Flax's initial values depend on the input shapes only
    init_batch = j_collate(jsamples[:4])
    if model_type == "DimeNet":
        from hydragnn_tpu.graphs.triplets import add_triplets, triplet_budget
        init_batch = add_triplets(j_collate(jsamples[:4], np_out=True),
                                  triplet_budget(jsamples[:4], 4))
    init = numpy_tree(j_init_params(jmodel, init_batch))
    prun = importlib.import_module("hydragnn_tpu_torch.run_training")

    def jax_init(mcfg, device="cuda", seed=0):
        model = create_model(mcfg, device=device, seed=seed)
        model.load_state_dict(load_jax_variables(init))
        return model
    monkeypatch.setattr(prun, "create_model", jax_init)
    state, history, model, completed = run_training(cfg, datasets=splits,
                                                    device="cpu")
    assert len(history["train_loss"]) == 60
    trues, preds = run_prediction(completed, datasets=splits, state=state,
                                  model=model, device="cpu")
    return float(np.sqrt(np.mean((trues[0] - preds[0]) ** 2)))


@pytest.mark.parametrize(
    "model_type",
    [pytest.param(m, marks=pytest.mark.slow) if m in _SLOW else m
     for m in sorted(THRESHOLDS)])
def test_run_training_meets_the_lattice_threshold(model_type, monkeypatch):
    """Each model's THRESHOLDS row: RMSE below the JAX package's
    threshold (`lattice_threshold_rmse`)."""
    rmse = lattice_threshold_rmse(model_type, monkeypatch)
    assert rmse < THRESHOLDS[model_type], (
        f"{model_type} RMSE {rmse:.4f} above threshold "
        f"{THRESHOLDS[model_type]}")
