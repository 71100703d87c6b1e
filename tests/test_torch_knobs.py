"""Knob resolution of the port against the JAX package's on the CPU:
batch packing's precedence (`utils/envflags.resolve_packing`, which
`run_training` consults) and the three serving knobs the port refuses
(`serving/config.check_unported_serving_knobs`: the metrics server,
raw-structure serving and a replica fleet, ROADMAP A8), while the
failure-semantics knobs that JAX's offline run_prediction ignores too
pass; the fault plan's resolution (`utils/faults.resolve_fault_plan`:
run_training refuses a plan, naming A8, exactly where JAX's resolution
yields one) and run_prediction's HYDRAGNN_DUMP_TESTDATA dump."""
import copy
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


# (Training.fault_plan, HYDRAGNN_FAULT_PLAN) -> whether a plan resolves
FAULT_PLAN_CASES = [
    (None, None, False),
    ("forward-step@3", None, True),
    (None, "forward-step@7;serving-dispatch@2,5", True),
    # the env wins over the config, both ways
    ("forward-step@3", "checkpoint-write@0", True),
    ("forward-step@3", "", False),         # set but empty masks the plan
    ("forward-step@3", "   ", False),
    # a malformed spec warns and injects nothing
    ("forward-step@x", None, False),
    (None, "no-such-site@1", False),
    ("forward-step@3", "forward-step", False),
    ("", None, False),
]


@pytest.mark.parametrize("config,env,resolves", FAULT_PLAN_CASES)
def test_fault_plan_resolution_matches_jax(clean_env, caplog, config, env,
                                           resolves):
    """HYDRAGNN_FAULT_PLAN over Training.fault_plan, a set-but-empty env
    masking the config's plan and a malformed spec warning and giving
    none: the port's resolution gives JAX's plan, site by site, in every
    case, and warns where JAX warns."""
    from hydragnn_tpu.utils.faults import resolve_fault_plan as j_resolve
    from hydragnn_tpu_torch.utils.faults import resolve_fault_plan
    clean_env.delenv("HYDRAGNN_FAULT_PLAN", raising=False)
    tr = {} if config is None else {"fault_plan": config}
    if env is not None:
        clean_env.setenv("HYDRAGNN_FAULT_PLAN", env)
    with caplog.at_level(logging.WARNING):
        want = j_resolve(tr)
        got = resolve_fault_plan(tr)
    assert (got is not None) == (want is not None) == resolves
    if resolves:
        assert got == want.injections
    warned = {r.name for r in caplog.records
              if "not a valid fault plan" in r.getMessage()}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)


@pytest.mark.parametrize("config,env,resolves", [
    c for c in FAULT_PLAN_CASES if c[:2] in (
        ("forward-step@3", None), (None, "forward-step@7;serving-dispatch@2,5"),
        ("forward-step@3", ""), ("forward-step@x", None))])
def test_run_training_refuses_a_fault_plan_where_jax_resolves_one(
        clean_env, config, env, resolves):
    """run_training raises NotImplementedError naming A8 before any work
    exactly where the JAX package would install a plan, and otherwise
    trains: a masked or malformed plan injects nothing there either."""
    from hydragnn_tpu_torch import run_training
    from tests.utils import make_config
    clean_env.delenv("HYDRAGNN_FAULT_PLAN", raising=False)
    splits = _lattice_splits(20)
    cfg = make_config("PNA")
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(num_epoch=1, EarlyStopping=False)
    if config is not None:
        tr["fault_plan"] = config
    if env is not None:
        clean_env.setenv("HYDRAGNN_FAULT_PLAN", env)
    if resolves:
        with pytest.raises(NotImplementedError, match="A8"):
            run_training(cfg, datasets=splits, device="cpu")
    else:
        _, history, _, _ = run_training(cfg, datasets=splits, device="cpu")
        assert np.isfinite(history["train_loss"]).all()


@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
def test_run_prediction_dumps_test_data_as_jax_does(clean_env, tmp_path,
                                                    env):
    """HYDRAGNN_DUMP_TESTDATA: where the JAX package's run_prediction
    writes ./logs/<log name>/test_data.pk, the port's writes it too, with
    the same names and targets, and predictions within rtol 1e-4 /
    atol 1e-5 of JAX's from the same weights; where JAX writes none, the
    port writes none."""
    import pickle
    import jax
    import jax.numpy as jnp
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu.graphs.batch import collate as j_collate
    from hydragnn_tpu.models.create import create_model as j_create_model
    from hydragnn_tpu.models.create import init_params as j_init_params
    from hydragnn_tpu.train.optimizer import select_optimizer as j_opt
    from hydragnn_tpu.train.train_step import TrainState as JState
    from hydragnn_tpu_torch import run_prediction
    from tests.test_torch_train import numpy_tree, to_jax_samples
    from tests.utils import make_config
    clean_env.chdir(tmp_path)
    clean_env.delenv("HYDRAGNN_DUMP_TESTDATA", raising=False)
    splits = _lattice_splits(20)
    jsplits = tuple(to_jax_samples(s) for s in splits)
    cfg = make_config("PNA")
    done = jcfg.update_config(copy.deepcopy(cfg), *jsplits)
    jmodel = j_create_model(jcfg.build_model_config(done))
    variables = numpy_tree(j_init_params(
        jmodel, j_collate(jsplits[0][:4], np_out=True), seed=3))
    jstate = JState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                           j_opt(done["NeuralNetwork"]["Training"]))
    if env is not None:
        clean_env.setenv("HYDRAGNN_DUMP_TESTDATA", env)
    dump = tmp_path / "logs" / jcfg.get_log_name_config(done) / "test_data.pk"
    j_trues, j_preds = j_run_prediction(copy.deepcopy(cfg), datasets=jsplits,
                                        state=jstate, model=jmodel)
    jax_wrote = dump.exists()
    want = pickle.loads(dump.read_bytes()) if jax_wrote else None
    if jax_wrote:
        dump.unlink()
    trues, preds = run_prediction(copy.deepcopy(cfg), datasets=splits,
                                  variables=variables, device="cpu")
    assert dump.exists() == jax_wrote == (env in ("1", "yes"))
    np.testing.assert_allclose(preds[0], j_preds[0], rtol=1e-4, atol=1e-5)
    if jax_wrote:
        got = pickle.loads(dump.read_bytes())
        assert list(got) == list(want) == ["sum_x_x2_x3"]
        for name in want:
            assert set(got[name]) == {"true", "pred"}
            np.testing.assert_array_equal(got[name]["true"],
                                          want[name]["true"])
            np.testing.assert_array_equal(got[name]["true"], trues[0])
            np.testing.assert_array_equal(got[name]["pred"], preds[0])
            np.testing.assert_allclose(got[name]["pred"], want[name]["pred"],
                                       rtol=1e-4, atol=1e-5)
