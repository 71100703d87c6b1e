"""Multi-dataset training in the port (hydragnn_tpu_torch:
parallel/multidataset.MultiDatasetLoader, `assign_shards_to_datasets`,
`merge_pna_deg`, and the driver examples/multidataset.py) against the
JAX package's on the CPU: the host pieces bitwise (the assignment, the
merged histogram, every field of the stacked [D, ...] batches on the
fixed and packed routes, their padding statistics), rank r's stream
(`shard=r`) bitwise the stacked batch's row r, the JAX package's
refusals and the port's A2 / A10 refusals, and the driver's two-rank run
over OC2020 + OC2022 on gloo against the JAX example's SPMD run on the
same files and weights."""
import dataclasses

import numpy as np
import pytest
import torch

from hydragnn_tpu.parallel import multidataset as jmd
from hydragnn_tpu_torch.datasets.loader import unstack_batch
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.parallel import multidataset as tmd
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import to_port_samples
from tests.torch_parallel_worker import spawn_ranks

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(tbatch.GraphBatch)]


@pytest.mark.parametrize("sizes,shards", [
    ([100, 300, 600], 8), ([24, 48], 8), ([5, 5, 5], 3), ([1, 1000], 4),
    ([7, 3, 9, 2], 6)])
def test_shard_assignment_matches_jax(sizes, shards):
    got = tmd.assign_shards_to_datasets(sizes, shards)
    assert got == jmd.assign_shards_to_datasets(sizes, shards)
    assert len(got) == shards and set(got) == set(range(len(sizes)))


def test_shard_assignment_refusal_matches_jax():
    with pytest.raises(ValueError) as want:
        jmd.assign_shards_to_datasets([1, 2, 3], 2)
    with pytest.raises(ValueError) as got:
        tmd.assign_shards_to_datasets([1, 2, 3], 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("hists", [
    [[1, 2, 3], [0, 5]], [[4], [0, 0, 0, 9], [1, 1]], [[0, 3, 2, 1]]])
def test_merge_pna_deg_matches_jax(hists):
    assert tmd.merge_pna_deg(hists) == jmd.merge_pna_deg(hists)


def _members():
    """Two lattice members (JAX samples, port samples)."""
    ja = deterministic_graph_dataset(num_configs=24, seed=0)
    jb = deterministic_graph_dataset(num_configs=48, seed=1)
    return [ja, jb], [to_port_samples(ja), to_port_samples(jb)]


def _assert_equal(tb, jb):
    for f in FIELDS:
        a, w = getattr(tb, f), getattr(jb, f, None)
        if w is None:
            assert a is None, f
            continue
        w = np.asarray(w)
        assert a.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(a.numpy(), w, err_msg=f)


@pytest.mark.parametrize("packing", [False, True])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_stacked_batches_and_rank_streams_match_jax(packing, shards):
    """The stacked batches, bitwise JAX's over two epochs (the shorter
    streams cycling into their next pass), the budgets and padding
    statistics; each `shard=r` loader's stream bitwise row r."""
    jm, tm = _members()
    jl = jmd.MultiDatasetLoader(jm, batch_size=16, num_shards=shards,
                                seed=2, packing=packing)
    tl = tmd.MultiDatasetLoader(tm, batch_size=16, num_shards=shards,
                                seed=2, packing=packing)
    ranks = [tmd.MultiDatasetLoader(tm, batch_size=16, num_shards=shards,
                                    seed=2, packing=packing, shard=r)
             for r in range(shards)]
    assert tl.assignment == jl.assignment
    assert (tl.n_node, tl.n_edge, tl.n_graph, tl.graphs_per_shard) == (
        jl.n_node, jl.n_edge, jl.n_graph, jl.graphs_per_shard)
    for epoch in (0, 1):
        for ld in [jl, tl] + ranks:
            ld.set_epoch(epoch)
        want = list(jl)
        got = list(tl)
        assert len(got) == len(want) == len(tl) == len(jl)
        for b, jb in zip(got, want):
            _assert_equal(b, jb)
        for r, ld in enumerate(ranks):
            stream = list(ld)
            assert len(stream) == len(got)
            for b, full in zip(stream, got):
                row = unstack_batch(full)[r]
                for f in FIELDS:
                    x, y = getattr(b, f), getattr(row, f)
                    assert (x is None) == (y is None), f
                    assert x is None or torch.equal(x, y), f
        assert tl.padding_stats() == jl.padding_stats()


def test_multidataset_refusals():
    """batch_size not divisible by the shards (JAX's message), a shard out
    of range, and mapping members sorted by name."""
    jm, tm = _members()
    with pytest.raises(ValueError) as want:
        jmd.MultiDatasetLoader(jm, batch_size=10, num_shards=4)
    with pytest.raises(ValueError) as got:
        tmd.MultiDatasetLoader(tm, batch_size=10, num_shards=4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="shard 4"):
        tmd.MultiDatasetLoader(tm, batch_size=8, num_shards=4, shard=4)
    ld = tmd.MultiDatasetLoader({"zeta": tm[0], "eta": tm[1]}, batch_size=8,
                                num_shards=4)
    assert ld.member_names == ("eta", "zeta")


# ---------------------------------------------------------- the driver --
def _args(tmp_path, *extra):
    from hydragnn_tpu_torch.examples import multidataset as md
    return md.parse_args(["--job-dir", str(tmp_path), "--device", "cpu",
                          *extra])


@pytest.mark.parametrize("argv,error,match", [
    (["--multi_model_list", "ANI1x,OC2020"], NotImplementedError, "A2"),
    (["--multi_model_list", "OC2020,MPTrj"], NotImplementedError, "A2"),
    (["--multi_model_list", "qm7x"], NotImplementedError, "A2"),
    (["--multi_model_list", "OC2021"], ValueError, "unknown member"),
    (["--preonly"], NotImplementedError, "A10"),
    (["--ddstore"], NotImplementedError, "A10")])
def test_driver_refuses_before_any_work(tmp_path, argv, error, match):
    """The members whose readers are not ported raise naming A2, the
    GraphStore and DDStore stages naming A10, an unknown member with the
    JAX example's message; nothing is written."""
    from hydragnn_tpu_torch.examples import multidataset as md
    with pytest.raises(error, match=match):
        md.run(_args(tmp_path, *argv))
    assert not (tmp_path / "dataset").exists()


def _jax_driver_run(job_dir, limit, config):
    """examples/multidataset/train.py's arithmetic in the JAX package on
    the members the port's driver reads (the same files, read with the
    JAX examples' readers): the members split and their histograms
    merged, its MultiDatasetLoader and fixed loaders over a 2-device
    mesh, its SPMD step for one epoch. The learning rate is halved: its
    step sums the shards' gradients, the port's averages them (ROADMAP
    C9). Returns (the first step's metrics, the history, the initial
    variables)."""
    import copy
    import os

    import jax
    from examples.open_catalyst_2020.oc20_data import load_oc20
    from examples.open_catalyst_2022.oc22_data import load_oc22
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu.datasets.loader import GraphDataLoader
    from hydragnn_tpu.graphs.batch import collate
    from hydragnn_tpu.models.create import create_model, init_params
    from hydragnn_tpu.parallel import mesh as jmesh
    from hydragnn_tpu.parallel.spmd import (make_spmd_eval_step,
                                            make_spmd_train_step)
    from hydragnn_tpu.preprocess.load_data import split_dataset
    from hydragnn_tpu.train import optimizer as jopt
    from hydragnn_tpu.train import trainer as jtrainer
    from hydragnn_tpu.train.train_step import TrainState
    from tests.test_torch_train import numpy_tree
    config = copy.deepcopy(config)
    tr = config["NeuralNetwork"]["Training"]
    tr["Optimizer"]["learning_rate"] /= 2
    members = [load_oc20(os.path.join(job_dir, "dataset", "oc2020"),
                         limit=limit, max_neighbours=64),
               load_oc22(os.path.join(job_dir, "dataset", "oc2022"),
                         limit=limit, max_neighbours=64)]
    splits = [split_dataset(m, tr["perc_train"], False) for m in members]
    trainsets = [s[0] for s in splits]
    valset = sum((list(s[1]) for s in splits), [])
    testset = sum((list(s[2]) for s in splits), [])
    all_train = sum((list(t) for t in trainsets), [])

    class _WithDeg(list):
        pass
    proxy = _WithDeg(all_train)
    proxy.pna_deg = jmd.merge_pna_deg(
        [jcfg.gather_deg(m).tolist() for m in members])
    config = jcfg.update_config(config, proxy, valset, testset)
    mcfg = jcfg.build_model_config(config)
    model = create_model(mcfg)
    batch = tr["batch_size"]
    loader = jmd.MultiDatasetLoader(trainsets, batch_size=batch,
                                    num_shards=2)
    val = GraphDataLoader(valset, batch_size=batch, num_shards=2,
                          async_workers=0)
    test = GraphDataLoader(testset, batch_size=batch, num_shards=2,
                           async_workers=0)
    variables = numpy_tree(init_params(model, collate(
        all_train[:loader.graphs_per_shard], n_node=loader.n_node,
        n_edge=loader.n_edge, n_graph=loader.n_graph)))
    tx = jopt.select_optimizer(tr)
    mesh = jmesh.make_mesh((("data", 2),), devices=jax.devices()[:2])
    loss = tr["loss_function_type"]
    step = make_spmd_train_step(model, mcfg, tx, mesh, loss)
    _, first = step(TrainState.create(variables, tx),
                    jmesh.shard_batch(next(iter(loader)), mesh))
    _, hist = jtrainer.train_validate_test(
        step, make_spmd_eval_step(model, mcfg, mesh, loss),
        TrainState.create(variables, tx), loader, val, test, num_epochs=1,
        use_early_stopping=False, log_name="multidataset_ref",
        log_dir=str(job_dir), place_fn=lambda b: jmesh.shard_batch(b, mesh))
    return {k: float(v) for k, v in first.items()}, hist, variables


def test_driver_trains_oc20_and_oc22_over_two_gloo_ranks(tmp_path):
    """The driver at gfm_energy.json's width (EGNN hidden 50, 3 layers,
    batch 32) on OC2020 + OC2022 (limit 40 each: two steps an epoch), two
    gloo ranks, rank r on shard r (one member each), under SGD: the same
    history on both
    ranks, each rank's batches from its own member, and the first step's
    metrics and one epoch's train, val and test history (loss and task)
    within TRAIN_TOL of the JAX example's arithmetic on the same files
    and initial weights (`_jax_driver_run`), the bound of the SPMD runs'
    tests (tests/test_torch_parallel_run.py)."""
    import json

    from hydragnn_tpu_torch.examples import multidataset as md
    from tests.test_torch_train import TRAIN_TOL
    job = tmp_path / "job"
    for name in ("OC2020", "OC2022"):
        md.ensure_member(name, str(job / "dataset"))
    with open(md.DEFAULT_CONFIG) as f:
        config = json.load(f)
    config["NeuralNetwork"]["Training"]["Optimizer"] = {
        "type": "SGD", "learning_rate": 0.01}
    inputfile = tmp_path / "gfm_energy_sgd.json"
    inputfile.write_text(json.dumps(config))
    first, want, variables = _jax_driver_run(job, 40, config)
    r0, r1 = spawn_ranks(tmp_path, "multidataset_driver", 2, timeout=240,
                         limit=40, job_dir=str(job),
                         inputfile=str(inputfile), variables=variables)
    assert r0["history"] == r1["history"]
    assert r0["member"] != r1["member"]
    assert r0["first"] == r1["first"]
    for k in ("loss", "task_0"):
        np.testing.assert_allclose(r0["first"][k], first[k], err_msg=k,
                                   **TRAIN_TOL)
    for k in ("train_loss", "val_loss", "test_loss", "task_0",
              "val_task_0", "test_task_0"):
        assert len(r0["history"][k]) == 1, k
        np.testing.assert_allclose(r0["history"][k], want[k], err_msg=k,
                                   **TRAIN_TOL)
