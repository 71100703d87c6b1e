"""ZeRO (`Optimizer.use_zero_redundancy`, parallel/spmd.ZeroPartition) on
the CPU, in gloo ranks (tests/torch_parallel_worker.py).

At `zero_min_shard_size` 0, W = 2 and W = 3 (an uneven partition: the
leaves whose leading dim does not divide by 3 stay whole), three steps
of the SPMD step with ZeRO are bitwise the replicated SPMD step's, for
every update rule `select_optimizer` builds, global-norm clipping and
gradient accumulation included: parameters, BatchNorm statistics,
metrics and the optimizer slots gathered whole. Each rank holds at most
its share of the split slots (its bytes printed). And the contract of
the JAX package's test_training.py::test_zero_opt_matches_replicated,
held bitwise here: run_training over 2 ranks with ZeRO on trains the
replicated run's trajectory (GIN, 3 epochs, threshold 0).
"""
import copy

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.parallel.mesh import zero_sharded
from hydragnn_tpu_torch.preprocess.load_data import (loader_budgets,
                                                     split_dataset)
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import to_port_samples
from tests.torch_parallel_worker import spawn_ranks
from tests.utils import make_config

torch.set_num_threads(1)

STEPS = 3
OPTIMIZERS = {
    "SGD": ({"type": "SGD", "learning_rate": 0.01}, {}),
    "Adam": ({"type": "Adam", "learning_rate": 0.005}, {}),
    "AdamW": ({"type": "AdamW", "learning_rate": 0.005}, {}),
    "Adadelta": ({"type": "Adadelta", "learning_rate": 0.5}, {}),
    "Adagrad": ({"type": "Adagrad", "learning_rate": 0.05}, {}),
    "Adamax": ({"type": "Adamax", "learning_rate": 0.005}, {}),
    "RMSprop": ({"type": "RMSprop", "learning_rate": 0.001}, {}),
    "FusedLAMB": ({"type": "FusedLAMB", "learning_rate": 0.005}, {}),
    "AdamW_clip": ({"type": "AdamW", "learning_rate": 0.005},
                   {"grad_clip": 0.01}),
    "Adam_accumulate": ({"type": "Adam", "learning_rate": 0.005},
                        {"gradient_accumulation_steps": 2}),
}


def _cases(world):
    samples = to_port_samples(deterministic_graph_dataset(num_configs=48,
                                                          seed=7))
    n_node, n_edge, k = loader_budgets(samples, 3, True)
    batches = [[tbatch.with_neighbor_format(tbatch.collate(
        samples[(s * world + r) * 3:(s * world + r + 1) * 3],
        n_node=n_node, n_edge=n_edge, n_graph=4), k=k)
        for r in range(world)] for s in range(STEPS)]
    cases = []
    for name, (opt, extra) in OPTIMIZERS.items():
        cfg = make_config("PNA", hidden_dim=6)
        cfg["NeuralNetwork"]["Training"]["Optimizer"] = dict(opt)
        cfg["NeuralNetwork"]["Training"].update(extra)
        cases.append(dict(name=name, samples=samples, variables=None,
                          config=tcfg.update_config(copy.deepcopy(cfg),
                                                    samples),
                          batches=batches))
    return cases


@pytest.fixture(scope="module", params=[2, 3])
def zero_runs(request, tmp_path_factory):
    world = request.param
    out = spawn_ranks(tmp_path_factory.mktemp(f"zero{world}"), "zero_steps",
                      world, timeout=150, cases=_cases(world), steps=STEPS)
    return world, out


def _equal_trees(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_zero_steps_are_bitwise_the_replicated_steps(zero_runs, name):
    world, out = zero_runs
    for rank, res in enumerate(out):
        rep, zero = res[name]["replicated"], res[name]["zero"]
        np.testing.assert_equal(zero["metrics"], rep["metrics"])
        _equal_trees(zero["state"], rep["state"])
        _equal_trees(zero["slots"], rep["slots"])
        # every rank trains the same state
        _equal_trees(zero["state"], out[0][name]["zero"]["state"])
        # at most its share: the whole leaves plus 1/W of the split ones
        sharded = zero["sharded"]
        per_leaf = [sum(v[i].nbytes for v in rep["slots"].values())
                    for i in range(len(sharded))]
        share = sum(b // world if s else b
                    for b, s in zip(per_leaf, sharded))
        print(f"{name} W={world} rank {rank}: optimizer slots "
              f"{zero['slot_bytes']} bytes (replicated "
              f"{rep['slot_bytes']}, share {share})")
        assert zero["slot_bytes"] == share
        if world == 3 and name != "SGD":
            # an uneven partition: some leaves split, some whole
            assert any(sharded) and not all(sharded)
        if name == "SGD":
            assert zero["slot_bytes"] < rep["slot_bytes"]


def test_zero_rule_leaves_small_and_indivisible_leaves_whole():
    assert zero_sharded((6, 4), 2, 0)
    assert not zero_sharded((6, 4), 4, 0)
    assert not zero_sharded((6, 4), 2, 25)
    assert zero_sharded((6, 4), 3, 24)
    assert not zero_sharded((), 2, 0)


def test_zero_run_training_matches_replicated(tmp_path):
    """The JAX package's ZeRO contract (test_zero_opt_matches_replicated:
    GIN, 3 epochs, threshold 0), over 2 ranks and bitwise: the history,
    the per-epoch states and the final variables."""
    samples = to_port_samples(deterministic_graph_dataset(num_configs=64))
    splits = split_dataset(samples, 0.7)
    runs = {}
    for zero in (False, True):
        cfg = make_config("GIN")
        tr = cfg["NeuralNetwork"]["Training"]
        tr.update(num_epoch=3, EarlyStopping=False, batch_size=8)
        tr["Optimizer"]["use_zero_redundancy"] = zero
        tr["Optimizer"]["zero_min_shard_size"] = 0
        runs[zero] = spawn_ranks(tmp_path / str(zero), "train_run", 2,
                                 config=cfg, splits=splits, variables=None,
                                 num_shards=2)
    for rank in range(2):
        rep, zero = runs[False][rank]["first"], runs[True][rank]["first"]
        assert zero["history"]["train_loss"] == rep["history"]["train_loss"]
        assert zero["history"]["val_loss"] == rep["history"]["val_loss"]
        assert zero["digests"] == rep["digests"]
        _equal_trees(zero["variables"], rep["variables"])
    assert runs[True][0]["first"]["digests"] == \
        runs[True][1]["first"]["digests"]
