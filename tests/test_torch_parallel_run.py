"""run_training and run_prediction over gloo ranks of the port (tests/
torch_parallel_worker.py) against the JAX package on the CPU.

* run_training, W = 2, 3 epochs, GIN and a small PNA, fixed-shape and
  packed: every rank's model is bitwise the other's after each epoch,
  and the history matches the JAX reference within rtol 1e-4 / atol
  1e-5 (tests/test_torch_train.py's TRAIN_TOL). The reference is the JAX
  package's SPMD step on a 2-device mesh driven by its trainer over the
  per-process loaders that `slice_by_process` (or the packed loader's
  pack_rank / pack_nproc) gives, with the globally reduced budgets: the
  arithmetic of JAX's multi-process run, in one process. It runs SGD at
  the learning rate over W (ROADMAP C9: JAX's step sums the shards'
  gradients; for SGD's linear update and W = 2 that is the mean's).
* a world-1 gloo group (the SPMD step at W = 1) is bitwise no group;
* a checkpoint is written once (rank 0), carries `world_size` 2, and a
  `continue` at W = 2 (ZeRO on, so its slots are gathered to save and
  sliced to restore) resumes bitwise the uninterrupted run;
* run_prediction(num_shards=2) returns JAX's order, bitwise the
  single-process outputs on the shards' shape, and within rtol 1e-4 /
  atol 1e-5 of JAX's num_shards=2 run;
* DimeNet under multi-process SPMD raises as in JAX.
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.datasets.loader import _stack_batches
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.parallel import mesh as jmesh
from hydragnn_tpu.parallel import multiprocess as jmp
from hydragnn_tpu.parallel.spmd import (make_spmd_eval_step,
                                        make_spmd_train_step)
from hydragnn_tpu.preprocess import load_data as jload
from hydragnn_tpu.run_prediction import run_prediction as j_run_prediction
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train import trainer as jtrainer
from hydragnn_tpu.train.train_step import TrainState as JState
from hydragnn_tpu_torch import run_prediction, run_training
from hydragnn_tpu_torch.preprocess.load_data import split_dataset
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import (TRAIN_TOL, jax_batch, numpy_tree,
                                    to_jax_samples, to_port_samples)
from tests.torch_parallel_worker import spawn_ranks
from tests.utils import make_config

torch.set_num_threads(1)

WORLD = 2
SGD = {"type": "SGD", "learning_rate": 0.01}


def _data(n=64, seed=0):
    jsamples = deterministic_graph_dataset(num_configs=n, seed=seed)
    samples = to_port_samples(jsamples)
    tr, va, te = split_dataset(samples, 0.7)
    return (tr, va, te), tuple(to_jax_samples(s) for s in (tr, va, te))


def _config(model_type, packing, epochs=3, **train):
    cfg = make_config(model_type)
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(num_epoch=epochs, EarlyStopping=False, batch_size=8,
              batch_packing=packing, Optimizer=dict(SGD), **train)
    return cfg


def _flat(tree):
    """Every leaf of a variable tree, raveled and joined in tree order."""
    return np.concatenate([np.ravel(x)
                           for x in jax.tree_util.tree_leaves(tree)])


class _Zip:
    """The per-process loaders of one split as one loader of [W, ...]
    stacked batches: global step i is every rank's batch i."""

    def __init__(self, loaders):
        self.loaders = loaders

    def set_epoch(self, epoch):
        for ld in self.loaders:
            ld.set_epoch(epoch)

    def __len__(self):
        assert len({len(ld) for ld in self.loaders}) == 1
        return len(self.loaders[0])

    def __iter__(self):
        for rows in zip(*self.loaders):
            yield jax_batch(_stack_batches(list(rows)))


def _jax_run(cfg, jsplits, packing):
    """The JAX history of its multi-process run's arithmetic, and the
    initial variables the port loads."""
    jtr, jva, jte = jsplits
    jc = jcfg.update_config(copy.deepcopy(cfg), jtr, jva, jte)
    tr = jc["NeuralNetwork"]["Training"]
    tr["Optimizer"]["learning_rate"] /= WORLD
    local_batch = tr["batch_size"] // WORLD
    nbr = True
    per_rank = []
    if packing:
        for r in range(WORLD):
            per_rank.append(jload.create_dataloaders(
                jtr, jva, jte, local_batch, neighbor_format=nbr,
                async_workers=0, packing=True, pack_rank=r,
                pack_nproc=WORLD))
    else:
        slices = [(jmp.slice_by_process(jtr, WORLD, r),
                   jmp.slice_by_process(jva, WORLD, r,
                                        underflow="replicate"),
                   jmp.slice_by_process(jte, WORLD, r,
                                        underflow="replicate"))
                  for r in range(WORLD)]
        raw = []
        for t, v, e in slices:
            jload.loader_budgets(t + v + e, local_batch, nbr,
                                 reduce_fn=lambda *x: raw.append(x) or x)
        mx = tuple(max(c) for c in zip(*raw))
        n_node, n_edge, k = jload.loader_budgets(
            slices[0][0], local_batch, nbr, reduce_fn=lambda *x: mx)
        for t, v, e in slices:
            per_rank.append(jload.create_dataloaders(
                t, v, e, local_batch, neighbor_format=nbr, async_workers=0,
                n_node_per_shard=n_node, n_edge_per_shard=n_edge,
                neighbor_k=k))
    loaders = [_Zip([pr[i] for pr in per_rank]) for i in range(3)]
    mesh = jmesh.make_mesh((("data", WORLD),), devices=jax.devices()[:WORLD])
    jmcfg = jcfg.build_model_config(jc)
    jmodel = j_create_model(jmcfg)
    first = next(iter(per_rank[0][0]))
    variables = numpy_tree(j_init_params(jmodel, jax_batch(first), seed=4))
    tx = jopt.select_optimizer(tr)
    state = JState.create(variables, tx)
    _, hist = jtrainer.train_validate_test(
        make_spmd_train_step(jmodel, jmcfg, tx, mesh, "mse"),
        make_spmd_eval_step(jmodel, jmcfg, mesh, "mse"), state, *loaders,
        num_epochs=tr["num_epoch"], use_early_stopping=False,
        log_name="parallel_ref", log_dir=os.getcwd(),
        place_fn=lambda b: jmesh.shard_batch(b, mesh))
    return hist, variables


@pytest.mark.parametrize("model_type,packing", [
    ("GIN", False), ("GIN", True), ("PNA", False), ("PNA", True)])
def test_run_training_two_ranks_matches_jax(tmp_path, monkeypatch,
                                            model_type, packing):
    monkeypatch.chdir(tmp_path)
    splits, jsplits = _data()
    cfg = _config(model_type, packing)
    want, variables = _jax_run(cfg, jsplits, packing)
    out = spawn_ranks(tmp_path / "ranks", "train_run", WORLD, config=cfg,
                      splits=splits, variables=variables, num_shards=WORLD)
    r0, r1 = out[0]["first"], out[1]["first"]
    assert len(r0["digests"]) == 3
    assert r0["digests"] == r1["digests"]
    # the padding fractions are each rank's own loader's, as in JAX
    local = ("padding_frac_nodes", "padding_frac_edges")
    assert {k: v for k, v in r0["history"].items() if k not in local} == \
        {k: v for k, v in r1["history"].items() if k not in local}
    for k in ("train_loss", "val_loss", "test_loss", "task_0",
              "val_task_0", "test_task_0"):
        np.testing.assert_allclose(r0["history"][k], want[k], err_msg=k,
                                   **TRAIN_TOL)
    # rank 0 alone writes the history
    log_dir = tmp_path / "ranks" / "logs" / r0["log_name"]
    with open(log_dir / "history.json") as f:
        assert json.load(f)["train_loss"] == r0["history"]["train_loss"]


def test_world_one_group_is_bitwise_no_group(tmp_path, monkeypatch):
    """The SPMD step in a world-1 gloo group (its all-reduces of one
    rank) trains bitwise what the single-device step trains."""
    monkeypatch.chdir(tmp_path)
    splits, jsplits = _data()
    cfg = _config("PNA", False)
    _, variables = _jax_run(cfg, jsplits, False)
    (grouped,) = spawn_ranks(tmp_path / "ranks", "train_run", 1,
                             config=cfg, splits=splits, variables=variables,
                             num_shards=None)
    import importlib
    rt = importlib.import_module("hydragnn_tpu_torch.run_training")
    from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                                  load_jax_variables)
    create = rt.create_model

    def create_model(mcfg, device="cpu"):
        model = create(mcfg, device=device)
        model.load_state_dict(load_jax_variables(variables))
        return model
    monkeypatch.setattr(rt, "create_model", create_model)
    _, hist, model, _ = run_training(copy.deepcopy(cfg), datasets=splits,
                                     device="cpu")
    assert grouped["first"]["history"]["train_loss"] == hist["train_loss"]
    assert grouped["first"]["history"]["val_loss"] == hist["val_loss"]
    np.testing.assert_array_equal(_flat(export_jax_variables(model)),
                                  _flat(grouped["first"]["variables"]))


def test_checkpoint_written_once_and_resumed_bitwise(tmp_path):
    """Two ranks with ZeRO (Adam, threshold 0) and a save every epoch,
    killed in epoch 2 on both ranks (the `forward-step` fault site), then
    `continue`d: bitwise the uninterrupted run; the saves are committed
    step dirs whose resume.json says world 2."""
    splits, _ = _data()

    def cfg(**train):
        c = _config("PNA", False, Checkpoint=True,
                    checkpoint_every_n_epochs=1, **train)
        c["NeuralNetwork"]["Training"]["Optimizer"] = {
            "type": "Adam", "learning_rate": 0.005,
            "use_zero_redundancy": True, "zero_min_shard_size": 0}
        return c
    whole = spawn_ranks(tmp_path / "whole", "train_run", WORLD,
                        config=cfg(), splits=splits, variables=None,
                        num_shards=WORLD)
    parts = spawn_ranks(tmp_path / "parts", "train_run", WORLD,
                        config=cfg(fault_plan="forward-step@12"),
                        splits=splits, variables=None, num_shards=WORLD,
                        resume_config=cfg(**{"continue": 1}))
    for rank in range(WORLD):
        assert parts[rank]["first"]["fault"].startswith("InjectedFault")
        w, p = whole[rank]["first"], parts[rank]["resumed"]
        assert p["history"]["train_loss"] == w["history"]["train_loss"]
        assert p["history"]["val_loss"] == w["history"]["val_loss"]
        np.testing.assert_array_equal(_flat(p["variables"]),
                                      _flat(w["variables"]))
    ckpt = tmp_path / "parts" / "logs" / parts[0]["resumed"]["log_name"] \
        / "checkpoint"
    steps = sorted(d.name for d in ckpt.iterdir() if d.is_dir())
    assert steps and all(s.startswith("step_") for s in steps), steps
    for step in steps:
        assert (ckpt / step / "COMMITTED").exists()
        with open(ckpt / step / "resume.json") as f:
            assert json.load(f)["world_size"] == WORLD


def test_run_prediction_two_ranks_in_jax_order(tmp_path):
    """Each rank forwards its shard of every batch; every rank returns
    the whole lists, in JAX's device-major order: bitwise the
    single-process loop on the shards' batch shape, and JAX's
    num_shards=2 run within TRAIN_TOL."""
    splits, jsplits = _data(n=61, seed=3)
    cfg = make_config("PNA")
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 6
    jc = jcfg.update_config(copy.deepcopy(cfg), *jsplits)
    jmcfg = jcfg.build_model_config(jc)
    jmodel = j_create_model(jmcfg)
    jload_b = jload.create_dataloaders(*jsplits, 3, async_workers=0)[2]
    variables = numpy_tree(j_init_params(
        jmodel, jax_batch(next(iter(jload_b))), seed=4))
    out = spawn_ranks(tmp_path, "predict_run", WORLD, config=cfg,
                      splits=splits, variables=variables, num_shards=WORLD)
    single_cfg = copy.deepcopy(cfg)
    single_cfg["NeuralNetwork"]["Training"]["batch_size"] = 3
    trues1, preds1 = run_prediction(single_cfg, datasets=splits,
                                    variables=variables, serve=False,
                                    device="cpu")
    state = JState.create(variables, jopt.select_optimizer(
        jc["NeuralNetwork"]["Training"]))
    jt, jp = j_run_prediction(copy.deepcopy(cfg), datasets=jsplits,
                              state=state, model=jmodel, num_shards=WORLD,
                              serve=False)
    for trues, preds in out:
        for a, b, c, d, e in zip(trues, preds, trues1, preds1, jp):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
            np.testing.assert_allclose(b, np.asarray(e), **TRAIN_TOL)
        for a, b in zip(trues, jt):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_dimenet_under_multiprocess_spmd_raises_as_jax(tmp_path):
    splits, _ = _data(n=24)
    cfg = _config("DimeNet", False, epochs=1)
    out = spawn_ranks(tmp_path, "train_error", WORLD, config=cfg,
                      splits=splits)
    for msg in out:
        assert msg.startswith("multi-process SPMD does not support "
                              "triplet-transform models yet"), msg
