"""The port's training path (hydragnn_tpu_torch: MaskedBatchNorm in
training mode, the two PNA kernels' autograd Functions, the losses, the
loader, the train/eval steps, the trainer and run_training) against the
JAX package's on the CPU, where the port's kernels take their plain
versions and the JAX package's Pallas kernels run in interpret mode.

Bounds (measured values in the test docstrings):
* BatchNorm, losses: rtol 1e-6 / atol 1e-7 (the same float32 sums in
  another order).
* The kernels' VJPs: the tie-rich dyadic case is exact (every product,
  quotient and sum representable); random data within rtol/atol 2e-5,
  the kernels' sum bound.
* Loader batches: bitwise.
* Train steps and histories: rtol 1e-4 / atol 1e-5 on losses, gradients
  and parameters, the forward's bound (tests/test_torch_pna.py): the two
  packages add in other orders inside GEMMs and reductions, and the
  optimizer carries the differences from step to step.
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
from hydragnn_tpu.datasets.loader import GraphDataLoader as JLoader
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.kernels.fused_mp_pallas import _fused_pna_accums
from hydragnn_tpu.kernels.nbr_pallas import fused_neighbor_aggregate
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.models.layers import MaskedBatchNorm as JBatchNorm
from hydragnn_tpu.ops.activations import masked_loss as j_masked_loss
from hydragnn_tpu.train import loss as jloss
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu.train import trainer as jtrainer
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                 synthetic_molecules,
                                                 tie_rich_edge_case,
                                                 tie_rich_neighbor_case)
from hydragnn_tpu_torch.kernels import fused_mp, nbr
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
from hydragnn_tpu_torch.ops.activations import masked_loss
from hydragnn_tpu_torch.train import loss as tloss
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.train import trainer as ttrainer
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them (8
# threads per worker made these tests 30x slower under pytest-xdist).
torch.set_num_threads(1)

SUM_TOL = dict(rtol=2e-5, atol=2e-5)
FINE = dict(rtol=1e-6, atol=1e-7)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
CSCE = ROOT / "examples" / "csce" / "csce_gap.json"
LJ = ROOT / "examples" / "LennardJones" / "LJ.json"


def _t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def to_jax_samples(samples):
    return [jbatch.GraphSample(
        x=s.x, pos=s.pos, senders=s.senders, receivers=s.receivers,
        edge_shifts=s.edge_shifts, y_graph=s.y_graph, y_node=s.y_node,
        cell=s.cell, energy=s.energy, forces=s.forces) for s in samples]


def to_port_samples(samples):
    return [tbatch.GraphSample(
        x=s.x, pos=s.pos, senders=s.senders, receivers=s.receivers,
        edge_shifts=s.edge_shifts, y_graph=s.y_graph, y_node=s.y_node,
        cell=s.cell, energy=s.energy, forces=s.forces) for s in samples]


def jax_batch(b):
    return jax.tree_util.tree_map(
        lambda a: None if a is None else jnp.asarray(np.asarray(a)), b)


def assert_tree_close(got, want, tol, path="", scaled=False):
    """Leaf by leaf; with `scaled`, atol grows by rtol times the leaf's
    largest |entry| (a gradient's error scales with its tensor, not with
    each of its entries)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}/{k}", scaled)
    else:
        w = np.asarray(want)
        t = dict(tol)
        if scaled and w.size:
            t["atol"] = t["atol"] + t["rtol"] * float(np.abs(w).max())
        np.testing.assert_allclose(np.asarray(got), w, err_msg=path, **t)


# ------------------------------------------------------- (b) BatchNorm --
def test_masked_batch_norm_training_mode_matches_flax():
    """Batch statistics over the masked rows, the Flax running update
    (0.9 old + 0.1 batch), and the input gradient through the batch
    statistics (measured 6e-8 abs)."""
    rng = np.random.RandomState(0)
    x = rng.randn(50, 7).astype(np.float32) * 3 + 1
    mask = rng.rand(50) > 0.3
    g = rng.randn(50, 7).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.randn(7)).astype(np.float32),
              "bias": (0.1 * rng.randn(7)).astype(np.float32)}
    stats = {"mean": rng.randn(7).astype(np.float32),
             "var": (0.5 + rng.rand(7)).astype(np.float32)}
    bn = JBatchNorm()

    def fwd(xx):
        y, mut = bn.apply({"params": params, "batch_stats": stats}, xx,
                          jnp.asarray(mask), use_running_average=False,
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])
    (_, (want, new_stats)), want_dx = jax.value_and_grad(
        fwd, has_aux=True)(jnp.asarray(x))

    port = MaskedBatchNorm(7)
    port.load_state_dict({k: _t(v) for k, v in {**params, **stats}.items()})
    port.train()
    tx = _t(x).requires_grad_(True)
    got = port(tx, _t(mask))
    (dx,) = torch.autograd.grad((got * _t(g)).sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FINE)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **FINE)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(new_stats[k]), **FINE)
    port.eval()   # eval mode reads the running statistics, updates none
    before = port.mean.clone()
    y_eval = port(_t(x), _t(mask))
    assert torch.equal(port.mean, before)
    want_eval = bn.apply({"params": params, "batch_stats": {
        k: np.asarray(v) for k, v in new_stats.items()}}, jnp.asarray(x),
        jnp.asarray(mask), use_running_average=True)
    np.testing.assert_allclose(y_eval.detach().numpy(), np.asarray(want_eval),
                               **FINE)


# ---------------------------------------------------- (c) kernel VJPs --
def _random_nbr_case(seed, n=40, k=9, f=12):
    rng = np.random.RandomState(seed)
    pi = rng.randn(n, f).astype(np.float32)
    pj = rng.randn(n, f).astype(np.float32)
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    mask[5] = False                       # isolated
    # one real slot leaves sq/c - mean^2 at its rounding noise, where the
    # reference's fused arithmetic takes another side of max(var, 0) than
    # any other order: random rows keep 0 or at least 2 slots
    single = mask.sum(1) == 1
    mask[single, :2] = True
    return pi, pj, idx, mask


def _cotangents(seed, n, f, dyadic):
    rng = np.random.RandomState(seed)
    if dyadic:
        gs = [rng.randint(-4, 5, (n, f)).astype(np.float32) / 8
              for _ in range(3)]
        return gs[0], gs[1], gs[2], np.zeros((n, f), np.float32)
    return tuple(rng.randn(n, f).astype(np.float32) for _ in range(4))


@pytest.mark.parametrize("dyadic", [False, True])
def test_nbr_aggregate_vjp_matches_jax(dyadic):
    """nbr_aggregate_vjp (the Function's backward) against jax.vjp of the
    Pallas kernel's custom VJP; the dyadic case (tie counts 1, 2, 8; a
    zero variance; isolated and masked slots; no std cotangent, whose
    1 / (2 std) is not representable) is bitwise."""
    if dyadic:
        pi, pj, idx, mask = tie_rich_neighbor_case(3)
    else:
        pi, pj, idx, mask = _random_nbr_case(3)
    n, f = pi.shape
    g_mean, g_min, g_max, g_std = _cotangents(4, n, f, dyadic)
    _, vjp = jax.vjp(lambda a, b: fused_neighbor_aggregate(
        a, b, jnp.asarray(idx), jnp.asarray(mask), 64, True),
        jnp.asarray(pi), jnp.asarray(pj))
    want = vjp(tuple(jnp.asarray(g) for g in
                     (g_mean, g_min, g_max, g_std, np.zeros(n, np.float32))))
    _, mn, mx, _, _ = nbr.nbr_aggregate(_t(pi), _t(pj), _t(idx), _t(mask))
    got = nbr.nbr_aggregate_vjp(_t(pi), _t(pj), _t(idx), _t(mask), mn, mx,
                                _t(g_mean), _t(g_min), _t(g_max), _t(g_std))
    # the Function's backward (nbr_aggregate under autograd) is the same
    tpi, tpj = _t(pi).requires_grad_(True), _t(pj).requires_grad_(True)
    out = nbr.nbr_aggregate(tpi, tpj, _t(idx), _t(mask))
    via_fn = torch.autograd.grad(
        sum((o * _t(g)).sum() for o, g in zip(out[:4], (g_mean, g_min, g_max,
                                                        g_std))), (tpi, tpj))
    for a, b, w in zip(got, via_fn, want):
        assert torch.equal(a, b)
        if dyadic:
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **SUM_TOL)
    assert float(got[0][5].abs().max()) == 0.0 or dyadic


@pytest.mark.parametrize("dyadic", [False, True])
def test_pna_edge_vjp_matches_jax(dyadic):
    """pna_edge_vjp (the accumulators' Function's backward) against
    jax.vjp of the Pallas kernel's accumulators, masked edges, an
    isolated node and receivers out of range included; bitwise on the
    dyadic case."""
    if dyadic:
        pi, pj, send, recv, em = tie_rich_edge_case(5)
    else:
        rng = np.random.RandomState(5)
        n, e, f = 40, 300, 12
        pi = rng.randn(n, f).astype(np.float32)
        pj = rng.randn(n, f).astype(np.float32)
        send = rng.randint(0, n, e).astype(np.int32)
        recv = rng.randint(0, n, e).astype(np.int32)
        recv[recv == 7] = 8
        em = rng.rand(e) > 0.2
        em[-20:] = False
    n, f = pi.shape
    rng = np.random.RandomState(6)
    if dyadic:
        gs = [rng.randint(-4, 5, (n, f)).astype(np.float32) / 8
              for _ in range(4)]
    else:
        gs = [rng.randn(n, f).astype(np.float32) for _ in range(4)]
    g_s, g_sq, g_min, g_max = gs
    _, vjp = jax.vjp(lambda a, b: _fused_pna_accums(
        a, b, jnp.asarray(send), jnp.asarray(recv), jnp.asarray(em), n, True),
        jnp.asarray(pi), jnp.asarray(pj))
    want = vjp(tuple(jnp.asarray(g) for g in
                     (g_s, g_sq, np.zeros((n, 1), np.float32), g_min, g_max)))
    tpi, tpj = _t(pi).requires_grad_(True), _t(pj).requires_grad_(True)
    out = fused_mp.pna_edge_accumulators(tpi, tpj, _t(send), _t(recv),
                                         _t(em), n)
    got = torch.autograd.grad(
        sum((o * _t(g)).sum() for o, g in zip(
            (out[0], out[1], out[3], out[4]), gs)), (tpi, tpj))
    direct = fused_mp.pna_edge_vjp(_t(pi), _t(pj), _t(send), _t(recv),
                                   _t(em), n, out[3].detach(),
                                   out[4].detach(), *map(_t, gs))
    for a, b, w in zip(got, direct, want):
        assert torch.equal(a, b)
        if dyadic:
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **SUM_TOL)


def test_std_tie_passes_half_the_gradient():
    """At var = 0 (identical messages) the std's gradient passes through
    max(var, 0) halved, JAX's maximum tie; the plain versions' autograd
    agrees with the Functions on both layouts."""
    pi = np.zeros((3, 2), np.float32)
    pj = np.ones((3, 2), np.float32)
    idx = np.array([[1, 2], [0, 2], [0, 1]], np.int32)
    mask = np.ones((3, 2), bool)
    g = np.ones((3, 2), np.float32)
    z = np.zeros_like(g)
    mn = mx = _t(pj[:, :])      # every message is 1: min = max = 1
    got = nbr.nbr_aggregate_vjp(*map(_t, (pi, pj, idx, mask)), mn, mx,
                                *map(_t, (z, z, z, g)))
    tpj = _t(pj).requires_grad_(True)
    sd = nbr.nbr_aggregate_plain(_t(pi), tpj, _t(idx), _t(mask))[3]
    (want,) = torch.autograd.grad(sd.sum(), tpj)
    assert torch.equal(got[1], want)
    _, vjp = jax.vjp(lambda b: fused_neighbor_aggregate(
        jnp.asarray(pi), b, jnp.asarray(idx), jnp.asarray(mask), 64,
        True)[3], jnp.asarray(pj))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]))


# ---------------------------------------------------------- (d) losses --
@pytest.mark.parametrize("name", ["mse", "mae", "rmse", "smooth_l1",
                                  "GaussianNLLLoss", "ce"])
def test_masked_loss_matches_jax(name):
    rng = np.random.RandomState(7)
    pred = rng.randn(30, 4).astype(np.float32) * 2
    target = rng.randn(30, 4).astype(np.float32)
    if name == "ce":
        target = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 30)]
    var = rng.rand(30, 4).astype(np.float32)
    mask = rng.rand(30) > 0.4
    want = j_masked_loss(name, jnp.asarray(pred), jnp.asarray(target),
                         jnp.asarray(mask), jnp.asarray(var))
    tp = _t(pred).requires_grad_(True)
    got = masked_loss(name, tp, _t(target), _t(mask), _t(var))
    np.testing.assert_allclose(float(got.detach()), float(want), **FINE)
    want_g = jax.grad(lambda p: j_masked_loss(
        name, p, jnp.asarray(target), jnp.asarray(mask), jnp.asarray(var)))(
        jnp.asarray(pred))
    (got_g,) = torch.autograd.grad(got, tp)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **FINE)


def test_multihead_loss_matches_jax():
    """A graph head and a node head with task weights 1 and 0.5, on a
    collated batch: totals and per-task losses."""
    samples = synthetic_molecules(6, seed=2, min_atoms=4, max_atoms=9,
                                  num_features=3)
    rng = np.random.RandomState(3)
    for s in samples:
        s.y_graph = rng.randn(2).astype(np.float32)
        s.y_node = rng.randn(s.num_nodes, 1).astype(np.float32)
    cfgs = []
    for mod in (jcfg, tcfg):
        heads = (mod.HeadConfig("graph", 2, 0), mod.HeadConfig("node", 1, 0))
        cfgs.append(mod.ModelConfig("PNA", 3, 8, 1, heads,
                                    task_weights=(1.0, 0.5)))
    tb = tbatch.collate(samples)
    jb = jax_batch(jbatch.collate(to_jax_samples(samples), np_out=True))
    outs = [rng.randn(tb.num_graphs, 2).astype(np.float32),
            rng.randn(tb.num_nodes, 1).astype(np.float32)]
    for name in ("mse", "mae"):
        want, wtasks = jloss.multihead_loss(cfgs[0], name,
                                            [jnp.asarray(o) for o in outs],
                                            None, jb)
        got, tasks = tloss.multihead_loss(cfgs[1], name,
                                          [_t(o) for o in outs], None, tb)
        np.testing.assert_allclose(float(got.detach()), float(want), **FINE)
        for a, b in zip(tasks, wtasks):
            np.testing.assert_allclose(float(a), float(b), **FINE)


# ---------------------------------------------------------- (e) loader --
@pytest.mark.parametrize("neighbor_format", [True, False])
def test_loader_batches_match_jax_bitwise(neighbor_format):
    """Shuffled train batches over 2 epochs and the unshuffled ones, every
    field bitwise; drop_last drops the partial batch of the shuffled
    loader only."""
    samples = synthetic_molecules(45, seed=4, min_atoms=3, max_atoms=12,
                                  num_features=4)
    jsamples = to_jax_samples(samples)
    for shuffle in (True, False):
        port = GraphDataLoader(samples, 8, shuffle=shuffle, seed=3,
                               neighbor_format=neighbor_format)
        ref = JLoader(jsamples, 8, shuffle=shuffle, seed=3,
                      neighbor_format=neighbor_format, async_workers=0)
        assert len(port) == len(ref) == (5 if shuffle else 6)
        assert (port.n_node, port.n_edge, port.n_graph, port.neighbor_k) \
            == (ref.n_node, ref.n_edge, ref.n_graph, ref.neighbor_k)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            pairs = list(zip(port, ref))
            assert len(pairs) == len(port)
            for tb, jb in pairs:
                for field in ("x", "pos", "senders", "receivers",
                              "node_graph", "node_mask", "edge_mask",
                              "graph_mask", "y_graph", "nbr", "nbr_edge",
                              "nbr_mask"):
                    a, b = getattr(tb, field), getattr(jb, field)
                    assert (a is None) == (b is None), field
                    if a is not None:
                        assert a.numpy().dtype == np.asarray(b).dtype, field
                        np.testing.assert_array_equal(a.numpy(),
                                                      np.asarray(b), field)


# ------------------------------------------------ (f) the train steps --
def _small_pna(samples, dense):
    with open(CSCE) as fh:
        base = json.load(fh)
    arch = base["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=16, num_conv_layers=2)
    arch["output_heads"]["graph"].update(dim_sharedlayers=16,
                                         dim_headlayers=[16, 16])
    base["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = \
        list(range(samples[0].x.shape[1]))
    tc = tcfg.update_config(copy.deepcopy(base), samples)
    jc = jcfg.update_config(copy.deepcopy(base), to_jax_samples(samples))
    jmodel = j_create_model(jcfg.build_model_config(jc))
    loader = GraphDataLoader(samples, 8, shuffle=True, seed=1,
                             neighbor_format=dense)
    batches = list(loader)
    variables = numpy_tree(j_init_params(jmodel, jax_batch(
        _jax_view(batches[0])), seed=2))
    return jmodel, jcfg.build_model_config(jc), tcfg.build_model_config(tc), \
        batches, variables


def _jax_view(tb):
    """The JAX GraphBatch of a port batch (the same numpy buffers)."""
    fields = {f: (None if getattr(tb, f) is None
                  else getattr(tb, f).numpy())
              for f in ("x", "pos", "senders", "receivers", "node_graph",
                        "node_mask", "edge_mask", "graph_mask", "y_graph",
                        "y_node", "edge_attr", "edge_shifts", "cell",
                        "energy", "forces", "idx_kj", "idx_ji",
                        "triplet_mask", "nbr", "nbr_edge", "nbr_mask")}
    return jbatch.GraphBatch(**fields)


def _grads_as_flax(model, grads):
    names = [k for k, _ in model.named_parameters()]
    tree = {}
    for key, g in zip(names, grads):
        *path, leaf = key.split(".")
        arr = g.detach().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", arr.T
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


@pytest.mark.parametrize("dense", [True, False])
def test_pna_train_steps_match_jax(dense):
    """3 steps of a small PNA (hidden 16, 2 layers) from the same Flax
    variables: each step's loss, the first step's gradients, and the
    final params and batch_stats (via export_jax_variables) within
    TRAIN_TOL.

    The optimizer is SGD with momentum, whose update is linear in the
    gradient. Adam's first updates are close to lr * sign(g): on a
    gradient at the level of float noise (the biases in front of a
    BatchNorm get 1e-11, exactly 0 without rounding) the two packages'
    noise picks different signs, and after two steps the parameters
    differ by a few lr (test_torch_optimizer.py holds Adam/AdamW to optax
    on the same gradients instead)."""
    samples = synthetic_molecules(40, seed=6, min_atoms=4, max_atoms=14,
                                  num_features=5, max_in_degree=6)
    jmodel, jm, tm, batches, variables = _small_pna(samples, dense)
    train_cfg = {"Optimizer": {"type": "SGD", "learning_rate": 0.05}}
    tx = jopt.select_optimizer(train_cfg)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jtrain = jstep.make_train_step(jmodel, jm, tx, "mse", donate=False)
    jloss_fn = jstep.make_loss_fn(jmodel, jm, "mse")

    model = create_model(tm, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    port_tx = topt.select_optimizer(train_cfg)
    state = tstep.TrainState.create(model, port_tx)
    train = tstep.make_train_step(model, tm, port_tx, "mse")

    jb0 = jax_batch(_jax_view(batches[0]))
    (_, _), want_g = jax.value_and_grad(jloss_fn, has_aux=True)(
        jstate.params, jstate.batch_stats, jb0)
    model.train()
    total, _ = tstep.make_loss_fn(model, tm, "mse")(batches[0])
    got_g = torch.autograd.grad(total, list(state.params.values()))
    with torch.no_grad():   # the probe forward updated the running stats
        for k, v in load_jax_variables(variables).items():
            if k.endswith((".mean", ".var")):
                state.batch_stats[k].copy_(v)
    assert_tree_close(_grads_as_flax(model, got_g), numpy_tree(want_g),
                      TRAIN_TOL)
    for b in batches[:3]:
        jstate, jm_ = jtrain(jstate, jax_batch(_jax_view(b)))
        state, m = train(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   **TRAIN_TOL)
        assert float(m["nonfinite_steps"]) == 0.0
    assert state.step == 3
    got = export_jax_variables(model)
    assert_tree_close(got["params"], numpy_tree(jstate.params), TRAIN_TOL)
    assert_tree_close(got["batch_stats"], numpy_tree(jstate.batch_stats),
                      TRAIN_TOL)


# ----------------------------------------------------- (g) the trainer --
def test_train_validate_test_history_matches_jax(tmp_path, monkeypatch):
    """3 epochs through both trainers with a plateau whose best is pinned
    below any loss, so it fires every epoch (lr 1e-2 -> 5e-3 -> 2.5e-3 ->
    1.25e-3): train/val/test losses within TRAIN_TOL, lr exact, and
    keep_best hands back a copy of the best epoch's state. SGD with
    momentum, as in test_pna_train_steps_match_jax."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    samples = synthetic_molecules(36, seed=8, min_atoms=4, max_atoms=12,
                                  num_features=5, max_in_degree=6)
    jmodel, jm, tm, _, variables = _small_pna(samples, True)
    tr, va, te = samples[:24], samples[24:30], samples[30:]
    train_cfg = {"Optimizer": {"type": "SGD", "learning_rate": 0.01}}

    def loaders(cls, data, **kw):
        return (cls(data[0], 8, shuffle=True, neighbor_format=True, **kw),
                cls(data[1], 8, neighbor_format=True, **kw),
                cls(data[2], 8, neighbor_format=True, **kw))

    tx = jopt.select_optimizer(train_cfg)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jplateau = jtrainer.ReduceLROnPlateau(factor=0.5, patience=0)
    jplateau.best = -1.0
    jl = loaders(JLoader, (to_jax_samples(tr), to_jax_samples(va),
                           to_jax_samples(te)), async_workers=0)
    _, jhist = jtrainer.train_validate_test(
        jstep.make_train_step(jmodel, jm, tx, "mse", donate=False),
        jstep.make_eval_step(jmodel, jm, "mse"), jstate, *jl, num_epochs=3,
        log_dir=str(tmp_path), plateau=jplateau, use_early_stopping=False)

    model = create_model(tm, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    port_tx = topt.select_optimizer(train_cfg)
    plateau = ttrainer.ReduceLROnPlateau(factor=0.5, patience=0)
    plateau.best = -1.0
    state = tstep.TrainState.create(model, port_tx)
    snapshots = []
    eval_step = tstep.make_eval_step(model, tm, "mse")

    def spy_eval(st, b):
        if not snapshots or snapshots[-1][0] != st.step:
            snapshots.append((st.step, export_jax_variables(st)))
        return eval_step(st, b)
    state, hist = ttrainer.train_validate_test(
        tstep.make_train_step(model, tm, port_tx, "mse"), spy_eval, state,
        *loaders(GraphDataLoader, (tr, va, te)), num_epochs=3,
        plateau=plateau, use_early_stopping=False)
    assert hist["lr"] == jhist["lr"]
    assert hist["lr"] == [float(np.float32(0.01)) * f
                          for f in (0.5, 0.25, 0.125)]
    for key in ("train_loss", "val_loss", "test_loss", "task_0",
                "val_task_0", "test_task_0"):
        np.testing.assert_allclose(hist[key], jhist[key], err_msg=key,
                                   **TRAIN_TOL)
    assert hist["nonfinite_steps"] == [0.0, 0.0, 0.0]
    best = int(np.argmin(hist["val_loss"]))
    assert state.step == snapshots[best][0]
    assert_tree_close(export_jax_variables(state), snapshots[best][1],
                      dict(rtol=0, atol=0))
    assert state.params["conv_0.pre_i.weight"] is \
        model.conv_0.pre_i.weight      # the live tensors, restored


# ----------------------------------------- (h) energy-force training --
def test_lj_energy_force_loss_and_gradient_match_jax():
    """A small SchNet (LJ.json at 8 wide, 2 equivariant layers) in
    training mode: the energy + force loss (TRAIN_TOL), its gradient with
    respect to every parameter (through the forces' create_graph and the
    batch statistics' dependence on the positions) and the updated
    running statistics, against the JAX package's loss_fn, with force
    weight 1 and "auto". Gradients: within 1e-4 of each tensor's largest
    entry plus 5e-5 (measured: 5e-5 of the largest entry; the last
    linear layer's bias in front of a BatchNorm, whose gradient is 0
    without rounding, differs by its noise, 2e-5)."""
    from examples.LennardJones.lj_data import generate_lj_dataset
    with open(LJ) as fh:
        base = json.load(fh)
    base["NeuralNetwork"]["Architecture"].update(
        hidden_dim=8, num_filters=8, num_gaussians=8)
    base["NeuralNetwork"]["Architecture"]["output_heads"]["node"][
        "dim_headlayers"] = [8, 8]
    samples = lj_configurations(3, seed=9)
    tc = tcfg.update_config(copy.deepcopy(base), samples)
    jc = jcfg.update_config(copy.deepcopy(base),
                            generate_lj_dataset(3, seed=9))
    jmodel = j_create_model(jcfg.build_model_config(jc))
    tm = tcfg.build_model_config(tc)
    tb = tbatch.collate(samples)
    jb = jax_batch(_jax_view(tb))
    rng = np.random.RandomState(1)
    variables = numpy_tree(j_init_params(jmodel, jb, seed=4))
    stats = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    for fw in (1.0, "auto"):
        jloss_fn = jstep.make_loss_fn(jmodel, jcfg.build_model_config(jc),
                                      "mae", compute_grad_energy=True,
                                      force_weight=fw)
        (want, (new_bs, metrics)), want_g = jax.value_and_grad(
            jloss_fn, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]),
            jax.tree_util.tree_map(jnp.asarray, stats), jb)
        model = create_model(tm, device="cpu")
        model.load_state_dict(load_jax_variables(variables))
        model.train()
        total, m = tstep.make_loss_fn(model, tm, "mae",
                                      compute_grad_energy=True,
                                      force_weight=fw)(tb)
        grads = torch.autograd.grad(total, list(model.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
        np.testing.assert_allclose(float(total.detach()), float(want),
                                   **TRAIN_TOL)
        for k in ("energy_loss", "force_loss"):
            np.testing.assert_allclose(float(m[k].detach()), float(metrics[k]),
                                       **TRAIN_TOL)
        assert_tree_close(_grads_as_flax(model, grads), numpy_tree(want_g),
                          dict(rtol=1e-4, atol=5e-5), scaled=True)
        assert_tree_close(export_jax_variables(model)["batch_stats"],
                          numpy_tree(new_bs), TRAIN_TOL)
        assert float(torch.stack([g.abs().max() for g in grads]).max()) > 0


def test_energy_force_loss_without_geometry_gives_zero_forces():
    """LJ.json switched to PNA (equivariance off, hidden 8, 3 LJ cells,
    compute_grad_energy): the energy never reads the positions, so the
    forces are 0, as jax.grad gives them, where torch.autograd.grad would
    raise. The loss (JAX: 7.4355 = energy 4.9031 + force 2.5324), its
    metrics and the updated running statistics against the JAX package's
    loss_fn within TRAIN_TOL, the parameter gradients within the LJ
    SchNet test's bound (the biases in front of a BatchNorm get a gradient
    that is 0 but for rounding, here up to 4e-5) but for conv_0's
    pre-layers, on constant rows, within 1e-2 relative L2 (measured
    6.9e-3); and the forces
    the EF engine's function serves are exactly 0."""
    from examples.LennardJones.lj_data import generate_lj_dataset
    with open(LJ) as fh:
        base = json.load(fh)
    base["NeuralNetwork"]["Architecture"].update(
        model_type="PNA", equivariance=False, hidden_dim=8)
    base["NeuralNetwork"]["Architecture"]["output_heads"]["node"][
        "dim_headlayers"] = [8, 8]
    samples = lj_configurations(3, seed=9)
    tc = tcfg.update_config(copy.deepcopy(base), samples)
    jc = jcfg.update_config(copy.deepcopy(base),
                            generate_lj_dataset(3, seed=9))
    jm = jcfg.build_model_config(jc)
    jmodel = j_create_model(jm)
    tm = tcfg.build_model_config(tc)
    tb = tbatch.collate(samples)
    jb = jax_batch(_jax_view(tb))
    variables = numpy_tree(j_init_params(jmodel, jb, seed=4))
    jloss_fn = jstep.make_loss_fn(jmodel, jm, "mae",
                                  compute_grad_energy=True)
    (want, (new_bs, metrics)), want_g = jax.value_and_grad(
        jloss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), jb)
    np.testing.assert_allclose(float(want), 7.4355, atol=1e-4)
    model = create_model(tm, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    model.train()
    total, m = tstep.make_loss_fn(model, tm, "mae",
                                  compute_grad_energy=True)(tb)
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(total.detach()), float(want),
                               **TRAIN_TOL)
    for k in ("energy_loss", "force_loss"):
        np.testing.assert_allclose(float(m[k].detach()), float(metrics[k]),
                                   **TRAIN_TOL)
    got_g, want_g = _grads_as_flax(model, grads), numpy_tree(want_g)
    # conv_0 reads x = 1 on every atom: each receiver's messages are
    # equal, its variance 0 but for rounding, and the std's gradient
    # (1 / (2 sqrt(1e-5)) = 158 times the variance's) carries the two
    # packages' rounding of sq / c - mean² into the pre-layers
    for name in ("pre_i", "pre_j"):
        want_leaves = want_g["conv_0"].pop(name)
        for leaf, g in got_g["conv_0"].pop(name).items():
            w = want_leaves[leaf]
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), name
    assert_tree_close(got_g, want_g, dict(rtol=1e-4, atol=5e-5),
                      scaled=True)
    assert_tree_close(export_jax_variables(model)["batch_stats"],
                      numpy_tree(new_bs), TRAIN_TOL)
    model.eval()
    energy, forces = tloss.energy_forces_from_node_head(model, tb)
    assert energy.shape == (tb.num_graphs, 1)
    assert torch.equal(forces, torch.zeros_like(tb.pos))


# ------------------------------------------------ (i) run_training, PNA --
def test_run_training_pna_meets_the_lattice_threshold():
    """The PNA row of tests/test_graphs_full.py through the port's
    run_training and run_prediction on the CPU: RMSE below 0.20 on the
    deterministic BCC lattice after 60 epochs."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    from tests.deterministic_data import deterministic_graph_dataset
    from tests.utils import make_config
    samples = to_port_samples(deterministic_graph_dataset(
        num_configs=160, heads=("graph",)))
    splits = split_dataset(samples, 0.7)
    cfg = make_config("PNA")
    train_cfg = cfg["NeuralNetwork"]["Training"]
    train_cfg["num_epoch"] = 60
    train_cfg["EarlyStopping"] = False
    state, history, model, completed = run_training(cfg, datasets=splits,
                                                    device="cpu")
    assert len(history["train_loss"]) == 60
    assert history["train_loss"][-1] < history["train_loss"][0]
    trues, preds = run_prediction(completed, datasets=splits, state=state,
                                  model=model, device="cpu")
    rmse = float(np.sqrt(np.mean((trues[0] - preds[0]) ** 2)))
    assert rmse < 0.20, f"PNA RMSE {rmse:.4f} above threshold 0.20"


def test_run_training_refuses_knobs_off_its_path():
    """Every knob the port does not train with raises NotImplementedError
    naming its ROADMAP item, before any training."""
    from hydragnn_tpu_torch import run_training
    samples = synthetic_molecules(12, seed=1, min_atoms=4, max_atoms=8)
    with open(CSCE) as fh:
        base = json.load(fh)
    # Checkpoint, continue, checkpoint_every_n_epochs, the bf16 dtype,
    # steps_per_call and batch_packing train now
    # (tests/test_torch_checkpoint.py, test_torch_precision.py,
    # test_torch_steps_per_call.py, test_torch_packing.py); a dtype the
    # port does not compute in still raises
    cases = [("Training", "pipeline_stages", 2, "A9"),
             ("Architecture", "graph_shards", 2, "A9"),
             ("Training", "async_loader_workers", 2, "A10"),
             ("Training", "conv_checkpointing", True, "A4"),
             ("Architecture", "dtype", "float16", "A5")]
    for section, key, value, item in cases:
        cfg = copy.deepcopy(base)
        cfg["NeuralNetwork"][section][key] = value
        with pytest.raises(NotImplementedError, match=item):
            run_training(cfg, datasets=(samples[:8], samples[8:10],
                                        samples[10:]), device="cpu")
    for extra in ({"Profile": {"enable": 1}},
                  {"Visualization": {"create_plots": True}}):
        with pytest.raises(NotImplementedError):
            run_training({**copy.deepcopy(base), **extra},
                         datasets=(samples[:8], samples[8:10], samples[10:]),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        run_training(copy.deepcopy(base), datasets=(samples[:8], samples[8:10],
                                                    samples[10:]),
                     device="cpu", num_shards=2)
    # datasets=None reads the config's files: csce_gap.json names no
    # Dataset.format, so the JAX package's default, pickle, is asked for
    # (tests/test_torch_rawdata.py holds the formats the port reads)
    with pytest.raises(NotImplementedError, match="A10"):
        run_training(copy.deepcopy(base), device="cpu")
