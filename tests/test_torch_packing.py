"""Budget-packed batching of the port (graphs/packing.py's planner, the
loader's packing mode, `resolve_pack_lookahead`, run_training with
`batch_packing`) against the JAX package's live plans, batches and
losses on the CPU.

Bounds: the planner, the packed batches, the padding statistics and the
plan fingerprint are host numpy and held bitwise; losses within
rtol 1e-4 / atol 1e-5 (tests/test_torch_train.py's TRAIN_TOL: the two
packages add in other orders inside GEMMs and reductions). The JAX
package's own packed-vs-fixed loss claim
(test_packing::test_loss_trajectory_equivalence_packed_vs_fixed) is red
on this tree, so the port is held against JAX's packed run itself.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.datasets.async_loader import neighbor_budget as j_k
from hydragnn_tpu.datasets.loader import GraphDataLoader as JLoader
from hydragnn_tpu.graphs import packing as jpack
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.utils.envflags import \
    resolve_pack_lookahead as j_resolve_lookahead
from hydragnn_tpu_torch.graphs import packing as tpack
from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
from hydragnn_tpu_torch.utils.envflags import resolve_pack_lookahead
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import (TRAIN_TOL, jax_batch, numpy_tree,
                                    to_jax_samples, to_port_samples)
from tests.utils import make_config

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

BATCH_FIELDS = ("x", "pos", "senders", "receivers", "node_graph",
                "node_mask", "edge_mask", "graph_mask", "y_graph", "y_node",
                "edge_attr", "edge_shifts", "cell", "energy", "forces", "nbr",
                "nbr_edge", "nbr_mask")
SGD = {"type": "SGD", "learning_rate": 0.01}


def _sizes(seed, n=300):
    """Size-skewed node and edge counts, as atomistic datasets have."""
    rng = np.random.RandomState(seed)
    nodes = rng.randint(1, 60, n).astype(np.int64)
    nodes[rng.rand(n) < 0.05] = 120
    edges = (nodes * rng.randint(0, 12, n)).astype(np.int64)
    return nodes, edges


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("lookahead", [1, 8, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_plan_matches_jax_bitwise(seed, lookahead, drop_last):
    """choose_budget, pack_order over a shuffled order, plan_steps and
    plan_padding_stats: the same budget, bins, selections and stats as
    the JAX package's, and every sample in exactly one bin."""
    nodes, edges = _sizes(seed)
    budget = tpack.choose_budget(nodes, edges, 16, lookahead=lookahead)
    jbudget = jpack.choose_budget(nodes, edges, 16, lookahead=lookahead)
    assert dataclasses.astuple(budget) == dataclasses.astuple(jbudget)
    order = np.random.RandomState(seed + 7).permutation(len(nodes))
    bins = tpack.pack_order(order, nodes, edges, budget)
    assert bins == jpack.pack_order(order, nodes, edges, jbudget)
    assert sorted(i for b in bins for i in b) == list(range(len(nodes)))
    for b in bins:
        assert nodes[list(b)].sum() <= budget.cap_nodes
        assert edges[list(b)].sum() <= budget.cap_edges
        assert len(b) <= budget.cap_graphs
    for shards in (1, 3):
        sels = tpack.plan_steps(bins, shards, drop_last=drop_last)
        assert sels == jpack.plan_steps(bins, shards, drop_last=drop_last)
        assert tpack.plan_padding_stats(
            sels, nodes, edges, budget.n_node, budget.n_edge) == \
            jpack.plan_padding_stats(sels, nodes, edges, budget.n_node,
                                     budget.n_edge)
    # fixed (flat) selections as well
    flat = [tuple(order[i:i + 16]) for i in range(0, len(order), 16)]
    assert tpack.plan_padding_stats(flat, nodes, edges, 4096, 8192) == \
        jpack.plan_padding_stats(flat, nodes, edges, 4096, 8192)


def test_check_fits_names_the_dataset_index():
    """A graph larger than a bin raises before any packing, naming its
    dataset index (not its place in the shuffled order), as JAX's."""
    nodes = np.array([5, 6, 400, 7])
    edges = np.array([10, 12, 30, 14])
    budget = tpack.PackBudget(n_node=128, n_edge=256, n_graph=9)
    order = [3, 2, 0, 1]
    with pytest.raises(ValueError, match="sample 2 ") as got:
        tpack.pack_order(order, nodes, edges, budget)
    with pytest.raises(ValueError) as want:
        jpack.pack_order(order, nodes, edges,
                         jpack.PackBudget(n_node=128, n_edge=256, n_graph=9))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="sample 1 "):
        tpack.check_fits(np.array([1, 2]), np.array([3, 300]), budget)


@pytest.mark.parametrize("neighbor_format", [True, False])
def test_packed_loader_batches_match_jax_bitwise(neighbor_format):
    """The packed train, val and test loaders of `create_dataloaders`
    (one budget over all three splits, one K) against JAX's
    GraphDataLoader(packing=True, async_workers=0) on the same budget:
    every batch bitwise over two epochs, the step counts, the padding
    statistics and the plan fingerprint."""
    samples = synthetic_molecules(90, seed=4, min_atoms=3, max_atoms=30,
                                  num_features=4, max_in_degree=8)
    tr, va, te = samples[:60], samples[60:75], samples[75:]
    loaders = create_dataloaders(tr, va, te, 8,
                                 neighbor_format=neighbor_format,
                                 packing=True, pack_lookahead=16)
    jall = to_jax_samples(samples)
    nodes, edges = jpack.sample_sizes(jall)
    jbudget = jpack.choose_budget(nodes, edges, 8, lookahead=16)
    assert dataclasses.astuple(loaders[0].pack_budget) == \
        dataclasses.astuple(jbudget)
    k = j_k(jall) if neighbor_format else None
    for loader, split, shuffle in zip(loaders, (tr, va, te),
                                      (True, False, False)):
        jl = JLoader(to_jax_samples(split), 8, shuffle=shuffle,
                     drop_last=shuffle, packing=True, pack_budget=jbudget,
                     neighbor_format=neighbor_format, neighbor_k=k,
                     async_workers=0)
        assert (loader.n_node, loader.n_edge, loader.n_graph) == \
            (jl.n_node, jl.n_edge, jl.n_graph)
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            jl.set_epoch(epoch)
            assert len(loader) == len(jl)
            got, want = list(loader), list(jl)
            assert len(got) == len(want) == len(loader)
            for b, jb in zip(got, want):
                for f in BATCH_FIELDS:
                    a, w = getattr(b, f), getattr(jb, f)
                    if w is None:
                        assert a is None, f
                        continue
                    w = np.asarray(w)
                    assert a.numpy().dtype == w.dtype, f
                    np.testing.assert_array_equal(a.numpy(), w, err_msg=f)
            assert loader.padding_stats() == jl.padding_stats()
            assert loader.global_plan_fingerprint() == \
                jl.global_plan_fingerprint()


def test_fixed_loader_padding_stats_match_jax():
    """The fixed-shape loader reports its padding too (the trainer's
    history entries), as JAX's does for in-memory datasets."""
    from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
    samples = synthetic_molecules(40, seed=6, min_atoms=3, max_atoms=20,
                                  num_features=4, max_in_degree=6)
    loader = GraphDataLoader(samples, 8, shuffle=True)
    jl = JLoader(to_jax_samples(samples), 8, shuffle=True, async_workers=0)
    for epoch in (0, 3):
        loader.set_epoch(epoch)
        jl.set_epoch(epoch)
        assert loader.padding_stats() == jl.padding_stats()
    with pytest.raises(ValueError, match="packing-mode"):
        loader.global_plan_fingerprint()


@pytest.mark.parametrize("kw", [dict(pack_rank=1, pack_nproc=2),
                                dict(pack_nproc=2)])
def test_packing_across_processes_raises_naming_a9(kw):
    """Packing across processes is ported (it raised naming A9 before):
    a rank's loader takes JAX's bins of the global plan, bitwise, with
    JAX's fingerprint, an all-padding batch for a tail's padding bin
    included (the unshuffled loader keeps its tail)."""
    from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
    samples = synthetic_molecules(9, seed=1, min_atoms=3, max_atoms=6)
    for shuffle in (True, False):
        loader = GraphDataLoader(samples, 4, shuffle=shuffle, packing=True,
                                 **kw)
        jl = JLoader(to_jax_samples(samples), 4, shuffle=shuffle,
                     packing=True, async_workers=0, **kw)
        assert loader._selections() == jl._selections()
        assert loader.global_plan_fingerprint() == \
            jl.global_plan_fingerprint()
        for b, jb in zip(list(loader), list(jl)):
            for f in BATCH_FIELDS:
                w = getattr(jb, f)
                if w is None:
                    assert getattr(b, f) is None, f
                    continue
                np.testing.assert_array_equal(getattr(b, f).numpy(),
                                              np.asarray(w), err_msg=f)


@pytest.mark.parametrize("env", [None, "4", "32"])
@pytest.mark.parametrize("config", ["absent", 16])
def test_resolve_pack_lookahead_matches_jax(monkeypatch, config, env):
    """HYDRAGNN_PACK_LOOKAHEAD, when set, wins over
    Training.pack_lookahead; neither leaves the planner's default
    (None)."""
    monkeypatch.delenv("HYDRAGNN_PACK_LOOKAHEAD", raising=False)
    tr = {} if config == "absent" else {"pack_lookahead": config}
    if env is not None:
        monkeypatch.setenv("HYDRAGNN_PACK_LOOKAHEAD", env)
    got = resolve_pack_lookahead(tr)
    assert got == j_resolve_lookahead(tr)
    want = int(env) if env is not None else (
        None if config == "absent" else config)
    assert got == want


def test_pack_lookahead_reaches_the_budget(monkeypatch):
    """run_training's loaders take the resolved lookahead: the env's
    value lands in the packed loader's budget (the planner's window)."""
    import importlib
    prun = importlib.import_module("hydragnn_tpu_torch.run_training")
    seen = []
    real = prun.create_dataloaders

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[0].pack_budget)
        return out
    monkeypatch.setattr(prun, "create_dataloaders", spy)
    monkeypatch.setenv("HYDRAGNN_PACK_LOOKAHEAD", "5")
    samples = to_port_samples(deterministic_graph_dataset(num_configs=20))
    cfg = make_config("PNA")
    cfg["NeuralNetwork"]["Training"].update(
        num_epoch=1, batch_packing=True, EarlyStopping=False,
        Optimizer=dict(SGD))
    prun.run_training(cfg, datasets=(samples[:14], samples[14:17],
                                     samples[17:]), device="cpu")
    assert seen[0].lookahead == 5


@pytest.mark.parametrize("neighbor_format", [True, False])
def test_packed_run_training_matches_jax(tmp_path, monkeypatch,
                                         neighbor_format):
    """run_training with Training.batch_packing on the lattice (PNA,
    batch 8, 2 epochs of SGD) against the JAX package's live packed
    run_training from the same Flax variables: the first packed batch's
    loss, then every epoch's train/val/test loss within TRAIN_TOL, the
    lr exactly, and the padding fractions bitwise. No CUDA graph is
    captured on the CPU (graph_captures 0 each epoch)."""
    import importlib
    jrun = importlib.import_module("hydragnn_tpu.run_training")
    prun = importlib.import_module("hydragnn_tpu_torch.run_training")
    from hydragnn_tpu.train import train_step as jstep
    from hydragnn_tpu_torch.train import train_step as tstep
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    samples = deterministic_graph_dataset(num_configs=48)
    cfg = make_config("PNA", neighbor_format=neighbor_format)
    cfg["NeuralNetwork"]["Training"].update(
        num_epoch=2, batch_size=8, batch_packing=True, keep_best=False,
        EarlyStopping=False, Optimizer=dict(SGD))
    datasets = (samples[:34], samples[34:41], samples[41:])
    port_sets = tuple(to_port_samples(d) for d in datasets)

    inits, jmodels = [], []

    def spy_init(model, *args, **kwargs):
        jmodels.append(model)
        inits.append(numpy_tree(j_init_params(model, *args, **kwargs)))
        return jax.tree_util.tree_map(jnp.asarray, inits[-1])
    monkeypatch.setattr(jrun, "init_params", spy_init)
    jloaders = []
    real_jdl = jrun.create_dataloaders

    def jspy(*args, **kwargs):
        out = real_jdl(*args, **kwargs)
        jloaders.append(out)
        return out
    monkeypatch.setattr(jrun, "create_dataloaders", jspy)
    _, jhist, _, jcompleted = jrun.run_training(
        copy.deepcopy(cfg), datasets=datasets, num_shards=1)

    def port_model(mcfg, device="cuda", seed=0):
        model = create_model(mcfg, device=device, seed=seed)
        model.load_state_dict(load_jax_variables(inits[0]))
        return model
    monkeypatch.setattr(prun, "create_model", port_model)
    ploaders = []
    real_pdl = prun.create_dataloaders

    def pspy(*args, **kwargs):
        out = real_pdl(*args, **kwargs)
        ploaders.append(out)
        return out
    monkeypatch.setattr(prun, "create_dataloaders", pspy)
    _, hist, model, completed = prun.run_training(
        copy.deepcopy(cfg), datasets=port_sets, device="cpu")

    # the first packed batch's loss from the shared initial variables
    train_loader, jtrain_loader = ploaders[0][0], jloaders[0][0]
    assert train_loader.packing and jtrain_loader.packing
    assert train_loader.n_graph == jtrain_loader.n_graph
    train_loader.set_epoch(0)
    jtrain_loader.set_epoch(0)
    batch, jb = next(iter(train_loader)), next(iter(jtrain_loader))
    assert int(batch.graph_mask.sum()) < train_loader.n_graph - 1
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu_torch.config import config as tcfg
    jm = jcfg.build_model_config(jcompleted)
    tm = tcfg.build_model_config(completed)
    jvars = jax.tree_util.tree_map(jnp.asarray, inits[0])
    jloss, _ = jstep.make_loss_fn(jmodels[0], jm, "mse")(
        jvars["params"], jvars["batch_stats"], jax_batch(jb))
    first = create_model(tm, device="cpu")
    first.load_state_dict(load_jax_variables(inits[0]))
    first.train()
    tloss, _ = tstep.make_loss_fn(first, tm, "mse")(batch)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **TRAIN_TOL)

    assert len(hist["train_loss"]) == 2
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], err_msg=key,
                                   **TRAIN_TOL)
    assert hist["lr"] == jhist["lr"]
    for key in ("padding_frac_nodes", "padding_frac_edges"):
        assert hist[key] == jhist[key], key
    assert hist["graph_captures"] == [0, 0]
