"""Knob resolution of the port against the JAX package's on the CPU:
batch packing's precedence (`utils/envflags.resolve_packing`, which
`run_training` consults) and the three serving knobs the port refuses
(`serving/config.check_unported_serving_knobs`: the metrics server,
raw-structure serving and a replica fleet, ROADMAP A8), while the
failure-semantics knobs that JAX's offline run_prediction ignores too
pass."""
import logging

import numpy as np
import pytest
import torch

from hydragnn_tpu.serving.config import resolve_fleet as j_resolve_fleet
from hydragnn_tpu.serving.config import resolve_serving as j_resolve_serving
from hydragnn_tpu.utils.envflags import resolve_packing as j_resolve_packing
from hydragnn_tpu_torch.serving.config import resolve_serving
from hydragnn_tpu_torch.utils.envflags import resolve_packing

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

PACKING_ENVS = ("HYDRAGNN_PACKING",)
SERVING_ENVS = ("HYDRAGNN_SERVE_METRICS_PORT", "HYDRAGNN_SERVE_STRUCTURE",
                "HYDRAGNN_FLEET_REPLICAS", "HYDRAGNN_SERVE_MAX_QUEUE",
                "HYDRAGNN_SERVE_DEADLINE_MS",
                "HYDRAGNN_SERVE_BREAKER_THRESHOLD",
                "HYDRAGNN_SERVE_BREAKER_RESET_S")


@pytest.fixture
def clean_env(monkeypatch):
    for name in PACKING_ENVS + SERVING_ENVS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [None, "0", "1", "typo"])
@pytest.mark.parametrize("config", ["absent", False, True])
def test_resolve_packing_matches_jax(clean_env, caplog, config, env):
    """HYDRAGNN_PACKING, when set, wins over Training.batch_packing; a
    typo warns and keeps the config's value; the port resolves every case
    as the JAX package does."""
    tr = {} if config == "absent" else {"batch_packing": config}
    if env is not None:
        clean_env.setenv("HYDRAGNN_PACKING", env)
    with caplog.at_level(logging.WARNING):
        got = resolve_packing(tr)
    assert got == j_resolve_packing(tr)
    want = {None: config is True, "0": False, "1": True,
            "typo": config is True}[env]
    assert got is want
    warned = any("HYDRAGNN_PACKING" in r.getMessage()
                 and r.name == "hydragnn_tpu_torch" for r in caplog.records)
    assert warned == (env == "typo")


def _lattice_splits(num_configs):
    from hydragnn_tpu_torch.graphs.batch import GraphSample
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    from tests.deterministic_data import deterministic_graph_dataset
    samples = [GraphSample(
        x=s.x, pos=s.pos, senders=s.senders, receivers=s.receivers,
        edge_shifts=s.edge_shifts, y_graph=s.y_graph, y_node=s.y_node,
        cell=s.cell, energy=s.energy, forces=s.forces)
        for s in deterministic_graph_dataset(num_configs=num_configs,
                                             heads=("graph",))]
    return split_dataset(samples, 0.7)


@pytest.mark.parametrize("config,env,packs", [
    (True, "0", False),      # the env turns the config's packing off
    (True, None, True),
    (False, "1", True),
    (True, "typo", True),    # a typo keeps the config's value
])
def test_run_training_packing_follows_the_env(clean_env, config, env, packs):
    """`run_training` with `batch_packing: true` and HYDRAGNN_PACKING=0
    trains one unpacked epoch on the CPU lattice, as the JAX package
    does; where packing resolves on, the epoch trains packed: its padding
    fractions are those of the packed loader's plan, else the fixed
    loader's."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from tests.utils import make_config
    splits = _lattice_splits(40)
    cfg = make_config("PNA")
    tr = cfg["NeuralNetwork"]["Training"]
    tr["num_epoch"] = 1
    tr["EarlyStopping"] = False
    tr["batch_packing"] = config
    if env is not None:
        clean_env.setenv("HYDRAGNN_PACKING", env)
    _, history, _, _ = run_training(cfg, datasets=splits, device="cpu")
    assert len(history["train_loss"]) == 1
    assert np.isfinite(history["train_loss"]).all()
    assert np.isfinite(history["val_loss"]).all()
    loader = create_dataloaders(*splits, int(tr["batch_size"]),
                                neighbor_format=True, packing=packs)[0]
    loader.set_epoch(0)
    stats = loader.padding_stats()
    assert stats["packing"] == ("packed" if packs else "fixed")
    for k in ("padding_frac_nodes", "padding_frac_edges"):
        assert history[k] == [stats[k]], k


# (Serving block, env) -> refused; each refused case is one the JAX
# package acts on (its run_prediction starts the server, the structure
# engine or the router)
SERVING_CASES = [
    ({"metrics_port": 9100}, {}, True),
    ({}, {"HYDRAGNN_SERVE_METRICS_PORT": "9100"}, True),
    ({"structure": True}, {}, True),
    ({}, {"HYDRAGNN_SERVE_STRUCTURE": "1"}, True),
    ({"fleet": {"replicas": 2}}, {}, True),
    ({}, {"HYDRAGNN_FLEET_REPLICAS": "3"}, True),
    # the env wins over the block, both ways
    ({"metrics_port": 9100}, {"HYDRAGNN_SERVE_METRICS_PORT": "0"}, False),
    ({"structure": True}, {"HYDRAGNN_SERVE_STRUCTURE": "off"}, False),
    ({"fleet": {"replicas": 4}}, {"HYDRAGNN_FLEET_REPLICAS": "1"}, False),
    # off as written, or a typo that warns and keeps the default
    ({"metrics_port": 0, "structure": False, "fleet": {"replicas": 1}}, {},
     False),
    ({}, {"HYDRAGNN_SERVE_STRUCTURE": "ture",
          "HYDRAGNN_FLEET_REPLICAS": "two"}, False),
    # exempt: JAX's offline run_prediction holds them at their defaults
    ({"max_queue": 8, "deadline_ms": 50.0, "breaker_threshold": 2,
      "breaker_reset_s": 1.0}, {}, False),
    ({}, {"HYDRAGNN_SERVE_MAX_QUEUE": "4",
          "HYDRAGNN_SERVE_DEADLINE_MS": "10",
          "HYDRAGNN_SERVE_BREAKER_THRESHOLD": "1",
          "HYDRAGNN_SERVE_BREAKER_RESET_S": "2"}, False),
]


@pytest.mark.parametrize("block,env,refused", SERVING_CASES)
def test_unported_serving_knobs_raise_naming_a8(clean_env, block, env,
                                                refused):
    """metrics_port > 0, structure and fleet.replicas > 1, by the config
    block or the env, raise NotImplementedError naming A8 exactly where
    the JAX package's resolution turns them on; max_queue, deadline_ms
    and breaker_* do not raise."""
    for name, value in env.items():
        clean_env.setenv(name, value)
    cfg = {"Serving": block}
    j = j_resolve_serving(cfg)
    acts = (j.metrics_port > 0 or j.structure
            or j_resolve_fleet(cfg).replicas > 1)
    assert acts == refused
    if refused:
        with pytest.raises(NotImplementedError, match="A8"):
            resolve_serving(cfg)
    else:
        resolve_serving(cfg)


def test_run_prediction_refuses_the_metrics_server_before_any_work(
        clean_env):
    """run_prediction resolves the serving knobs first: a metrics port
    raises before the model, the weights or the data are touched."""
    from hydragnn_tpu_torch import run_prediction
    from tests.utils import make_config
    cfg = make_config("PNA")
    cfg["Serving"] = {"metrics_port": 9100}
    with pytest.raises(NotImplementedError, match="A8"):
        run_prediction(cfg, datasets=([], [], []), device="cpu")
