"""Knob resolution of the port against the JAX package's on the CPU:
batch packing's precedence (`utils/envflags.resolve_packing`, which
`run_training` consults); every `Serving` knob (`serving/config.
resolve_serving`: env over config over default, set-but-empty and
malformed values as JAX resolves them), of which sharded serving is
still refused (ROADMAP A8) while the int8 tier and its
`quant_calib_samples` resolve as JAX's, a replica fleet resolves as
JAX's (`resolve_fleet`), raw-structure serving builds a structure engine
and the metrics port starts the /metrics server through
`run_prediction`; the fault plan's resolution
(`utils/faults.resolve_fault_plan`: run_training installs exactly the
plan JAX's resolution yields) and run_prediction's
HYDRAGNN_DUMP_TESTDATA dump; the training
telemetry knobs (`utils/envflags.resolve_telemetry`: env over the
Training.Telemetry block, strict) and what run_training does with them:
`device_trace` alone traces its epoch, HYDRAGNN_TELEMETRY=0 turns a
block's session off; and the repairs C10-C12, each held against the JAX
package's live behaviour on the same config, splits and weights: a
pipelined run with `create_plots` trains (JAX skips the plots there),
run_prediction's engine route resolves `num_shards` before refusing it,
and a numpy dtype name the port lacks (float16, ...) is refused only
where the resolved compute dtype is used."""
import copy
import logging

import numpy as np
import pytest
import torch

from hydragnn_tpu.serving.config import resolve_fleet as j_resolve_fleet
from hydragnn_tpu.serving.config import resolve_serving as j_resolve_serving
from hydragnn_tpu.utils.envflags import resolve_packing as j_resolve_packing
from hydragnn_tpu.utils.envflags import \
    resolve_telemetry as j_resolve_telemetry
from hydragnn_tpu_torch.serving.config import (resolve_fleet,
                                               resolve_serving)
from hydragnn_tpu_torch.utils.envflags import (resolve_packing,
                                               resolve_telemetry)

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

PACKING_ENVS = ("HYDRAGNN_PACKING",)
# every Serving knob: (ServingConfig field, block key, env var, a block
# value, a well-formed env value, a malformed one); the JAX package's
# names and defaults
SERVING_KNOBS = [
    ("enabled", "enabled", "HYDRAGNN_SERVE", True, "0", "ture"),
    ("max_batch_size", "max_batch_size", "HYDRAGNN_SERVE_MAX_BATCH", 64,
     "12", "twelve"),
    ("max_wait_ms", "max_wait_ms", "HYDRAGNN_SERVE_MAX_WAIT_MS", 2.0, "0.5",
     "soon"),
    ("num_buckets", "num_buckets", "HYDRAGNN_SERVE_BUCKETS", 3, "2", "2.5"),
    ("bucket_multiple", "bucket_multiple", "HYDRAGNN_SERVE_BUCKET_MULTIPLE",
     32, "128", "x"),
    ("max_queue", "max_queue", "HYDRAGNN_SERVE_MAX_QUEUE", 8, "4", "many"),
    ("deadline_ms", "deadline_ms", "HYDRAGNN_SERVE_DEADLINE_MS", 50.0, "10",
     "10ms"),
    ("breaker_threshold", "breaker_threshold",
     "HYDRAGNN_SERVE_BREAKER_THRESHOLD", 2, "1", "one"),
    ("breaker_reset_s", "breaker_reset_s", "HYDRAGNN_SERVE_BREAKER_RESET_S",
     1.0, "2", "2s"),
    ("precision", "precision", "HYDRAGNN_SERVE_PRECISION", "bf16", "fp32",
     "half-ish"),
    ("quant_calib_samples", "quant_calib_samples",
     "HYDRAGNN_QUANT_CALIB_SAMPLES", 16, "8", "eight"),
    ("metrics_port", "metrics_port", "HYDRAGNN_SERVE_METRICS_PORT", 0, "0",
     "http"),
    ("structure", "structure", "HYDRAGNN_SERVE_STRUCTURE", True, "off",
     "yes please"),
    ("md_skin", "md_skin", "HYDRAGNN_MD_SKIN", 0.5, "0.2", "thin"),
]
SERVING_ENVS = tuple(k[2] for k in SERVING_KNOBS) + (
    "HYDRAGNN_FLEET_REPLICAS", "HYDRAGNN_FLEET_COMPILE_STORE")


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


# (Serving block, env) -> whether the JAX package's run_prediction acts
# on it (starts the metrics server or the router); the port resolves
# every one (the int8 tier included) as JAX does
SERVING_CASES = [
    ({"metrics_port": 9100}, {}, True),
    ({}, {"HYDRAGNN_SERVE_METRICS_PORT": "9100"}, True),
    ({"fleet": {"replicas": 2}}, {}, True),
    ({}, {"HYDRAGNN_FLEET_REPLICAS": "3"}, True),
    # the env wins over the block, both ways
    ({"metrics_port": 9100}, {"HYDRAGNN_SERVE_METRICS_PORT": "0"}, False),
    ({"fleet": {"replicas": 4}}, {"HYDRAGNN_FLEET_REPLICAS": "1"}, False),
    # off as written, or a typo that warns and keeps the default
    ({"metrics_port": 0, "structure": False, "fleet": {"replicas": 1}}, {},
     False),
    ({}, {"HYDRAGNN_SERVE_STRUCTURE": "ture",
          "HYDRAGNN_FLEET_REPLICAS": "two"}, False),
    # ported: raw-structure serving and the failure semantics
    ({"structure": True}, {}, False),
    ({}, {"HYDRAGNN_SERVE_STRUCTURE": "1"}, False),
    ({"max_queue": 8, "deadline_ms": 50.0, "breaker_threshold": 2,
      "breaker_reset_s": 1.0}, {}, False),
    ({}, {"HYDRAGNN_SERVE_MAX_QUEUE": "4",
          "HYDRAGNN_SERVE_DEADLINE_MS": "10",
          "HYDRAGNN_SERVE_BREAKER_THRESHOLD": "1",
          "HYDRAGNN_SERVE_BREAKER_RESET_S": "2"}, False),
    # ported: the fleet and its compile store
    ({"fleet": {"replicas": 2, "compile_store": "/tmp/store"}},
     {"HYDRAGNN_FLEET_COMPILE_STORE": "/env/store"}, True),
    # the int8 tier, by the block or the env, with its calibration-set
    # size (strict: a typo warns and keeps the block's)
    ({"precision": "int8"}, {}, False),
    ({}, {"HYDRAGNN_SERVE_PRECISION": "int8"}, False),
    ({"precision": "i8", "quant_calib_samples": 8},
     {"HYDRAGNN_QUANT_CALIB_SAMPLES": "4"}, False),
    ({"quant_calib_samples": 8}, {"HYDRAGNN_QUANT_CALIB_SAMPLES": "four"},
     False),
]


@pytest.mark.parametrize("block,env,acts", SERVING_CASES)
def test_unported_serving_knobs_raise_naming_a8(clean_env, block, env,
                                                acts):
    """Every knob resolves to the JAX package's values: the fleet
    (ported: the router and its store), metrics_port (the /metrics
    server), structure, max_queue, deadline_ms, breaker_* and the
    precision, int8 and its quant_calib_samples included: none of them
    raises any longer (the int8 tier is ported; the name is kept from
    when it was refused), and only num_shards > 1 still names A8
    (test_run_prediction_refuses_the_metrics_server_before_any_work)."""
    import dataclasses
    for name, value in env.items():
        clean_env.setenv(name, value)
    cfg = {"Serving": block}
    j = j_resolve_serving(cfg)
    assert acts == (j.metrics_port > 0 or j_resolve_fleet(cfg).replicas > 1)
    assert dataclasses.asdict(resolve_fleet(cfg)) == \
        dataclasses.asdict(j_resolve_fleet(cfg))
    assert resolve_serving(cfg) == _as_port(j)


def _as_port(j):
    from hydragnn_tpu_torch.serving.config import ServingConfig
    return ServingConfig(**{f: getattr(j, f)
                            for f in ServingConfig.__dataclass_fields__})


@pytest.mark.parametrize("how", ["default", "config", "env_over_config",
                                 "set_but_empty", "malformed"])
@pytest.mark.parametrize("knob", SERVING_KNOBS, ids=[k[0] for k in
                                                     SERVING_KNOBS])
def test_resolve_serving_matches_jax(clean_env, caplog, knob, how):
    """Each Serving knob resolves to the JAX package's value: its default,
    the block's value, the env's over the block's, a set-but-empty env
    (keeps the block's) and a malformed env (warns, keeps the block's)."""
    from hydragnn_tpu_torch.serving.config import ServingConfig
    field, key, env, value, good, bad = knob
    block = {} if how == "default" else {key: value}
    if how in ("env_over_config", "set_but_empty", "malformed"):
        clean_env.setenv(env, {"env_over_config": good,
                               "set_but_empty": "", "malformed": bad}[how])
    cfg = {"Serving": block}
    with caplog.at_level(logging.WARNING):
        want = j_resolve_serving(cfg)
        got = resolve_serving(cfg)
    assert set(ServingConfig.__dataclass_fields__) == \
        set(type(want).__dataclass_fields__)
    assert got == _as_port(want)
    assert getattr(got, field) == getattr(want, field)
    if how == "env_over_config" and field != "metrics_port":
        # the env's value, not the block's
        assert getattr(got, field) != (
            "bfloat16" if field == "precision" else value)
    warned = {r.name for r in caplog.records if env in r.getMessage()}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)
    assert ("hydragnn_tpu_torch" in warned) == (how == "malformed")


def test_serving_structure_builds_a_structure_engine(clean_env,
                                                     monkeypatch):
    """Serving.structure (or HYDRAGNN_SERVE_STRUCTURE) makes
    run_prediction hand its engine the full config and the skin, as the
    JAX package's does, with the failure knobs at their permissive
    defaults; the predictions are the structure-less engine's."""
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.serving import engine as tengine
    from tests.utils import make_config
    import importlib
    rp = importlib.import_module("hydragnn_tpu_torch.run_prediction")
    built = []

    class Spy(tengine.InferenceEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append((self, kw))

    monkeypatch.setattr(rp, "InferenceEngine", Spy)
    splits = _lattice_splits(20)
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import (create_model,
                                                  data_input_dim)
    from hydragnn_tpu_torch.utils.weights import random_flax_variables
    done = tcfg.update_config(make_config("PNA"), *splits)
    mcfg = data_input_dim(tcfg.build_model_config(done),
                          [s for split in splits for s in split])
    variables = random_flax_variables(create_model(mcfg, device="cpu"), 0)
    out = []
    for block, env in (({"structure": True, "md_skin": 0.4,
                         "max_queue": 2, "deadline_ms": 0.001}, None),
                       ({}, "1"), ({}, None)):
        if env is not None:
            clean_env.setenv("HYDRAGNN_SERVE_STRUCTURE", env)
        cfg = make_config("PNA")
        cfg["Serving"] = block
        out.append(run_prediction(cfg, datasets=splits, variables=variables,
                                  serve=True, device="cpu")[1][0])
        clean_env.delenv("HYDRAGNN_SERVE_STRUCTURE", raising=False)
    (eng_a, kw_a), (eng_b, kw_b), (eng_c, kw_c) = built
    assert kw_a["structure_config"]["Serving"]["structure"] is True
    assert kw_b["structure_config"] is not None
    assert kw_c["structure_config"] is None
    assert eng_a.md_skin == 0.4 and eng_b.md_skin == 0.3
    for eng, kw in built:
        assert kw["breaker_threshold"] == 0
        assert eng.max_queue == 0 and eng.default_deadline_ms is None
    sess = eng_a.structure_session()
    assert sess.nlist.skin == 0.4 and sess.nlist.pbc is None
    with pytest.raises(RuntimeError, match="structure_config"):
        eng_c.structure_session()
    np.testing.assert_array_equal(out[0], out[2])
    np.testing.assert_array_equal(out[1], out[2])


def test_run_prediction_refuses_the_metrics_server_before_any_work(
        clean_env):
    """run_prediction resolves the serving knobs first: a num_shards that
    resolves above 1 (over the world, as JAX resolves it: C11) on the
    engine route (`Serving.enabled`) raises before the model, the
    weights or the data are touched (the loop shards over a process
    group's ranks, tests/test_torch_parallel_run.py); the
    int8 tier resolves (an engine serves it, the loop computes at the
    train-side precision, as in the JAX package:
    tests/test_torch_precision.py, test_torch_quant.py); the metrics
    server and the fleet are
    ported, so a metrics port and a replica count resolve (and serve,
    tests/test_torch_telemetry.py and tests/test_torch_fleet.py)."""
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.parallel import mesh
    from tests.utils import make_config
    # a count that resolves above 1 (C11): a world of two, and the
    # config's batch_size divides by 2
    clean_env.setattr(mesh, "get_comm_size_and_rank", lambda: (2, 0))
    cfg = make_config("PNA")
    cfg["Serving"] = {"enabled": True, "metrics_port": 9100,
                      "fleet": {"replicas": 2}, "precision": "int8"}
    with pytest.raises(NotImplementedError, match="A8"):
        run_prediction(cfg, datasets=([], [], []), device="cpu",
                       num_shards=2)
    assert resolve_serving(cfg).precision == "int8"
    cfg["Serving"].pop("precision")
    with pytest.raises(NotImplementedError, match="A8"):
        run_prediction(cfg, datasets=([], [], []), device="cpu",
                       num_shards=2)
    assert resolve_serving({"Serving": {"metrics_port": 9100}}
                           ).metrics_port == 9100
    assert resolve_fleet(cfg).replicas == 2


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
        assert got.injections == want.injections
    warned = {r.name for r in caplog.records
              if "not a valid fault plan" in r.getMessage()}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)


@pytest.mark.parametrize("config,env,resolves", [
    c for c in FAULT_PLAN_CASES if c[:2] in (
        ("forward-step@3", None), (None, "forward-step@7;serving-dispatch@2,5"),
        ("forward-step@3", ""), ("forward-step@x", None))])
def test_run_training_refuses_a_fault_plan_where_jax_resolves_one(
        clean_env, config, env, resolves):
    """run_training installs, for the run, exactly the plan the JAX
    package's resolution yields (the training sites are wired; the name
    is kept from when the port refused a plan), and trains: a masked or
    malformed plan injects nothing. The run's one dispatch an epoch
    leaves the listed forward-step indices unreached."""
    from hydragnn_tpu.utils.faults import resolve_fault_plan as j_resolve
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.utils import faults as tfaults
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
    want = j_resolve(tr)
    try:
        _, history, _, _ = run_training(cfg, datasets=splits, device="cpu")
        plan = tfaults.active_fault_plan()
        assert (plan is not None) == (want is not None) == resolves
        if resolves:
            assert plan.injections == want.injections
            assert plan.fired() == []
            assert plan.counts().get("forward-step", 0) == \
                ("forward-step" in plan.injections)
    finally:
        tfaults.install_fault_plan(None)
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


# ------------------------------------------------- training telemetry --

TELEMETRY_ENVS = ("HYDRAGNN_TELEMETRY", "HYDRAGNN_TELEMETRY_DIR",
                  "HYDRAGNN_DEVICE_TRACE", "HYDRAGNN_DEVICE_TRACE_EPOCH")
# (Training.Telemetry block, env)
TELEMETRY_CASES = [
    (None, {}),
    ({"enabled": True}, {}),
    ({"enabled": True, "dir": "tel", "device_trace": True,
      "device_trace_epoch": 2}, {}),
    ({"device_trace": True}, {}),
    # the env wins over the block, both ways
    ({"enabled": True}, {"HYDRAGNN_TELEMETRY": "0"}),
    ({"enabled": True}, {"HYDRAGNN_TELEMETRY": "false"}),
    ({}, {"HYDRAGNN_TELEMETRY": "1", "HYDRAGNN_DEVICE_TRACE": "on"}),
    ({"device_trace": True}, {"HYDRAGNN_DEVICE_TRACE": "off"}),
    # set but empty: off, and an empty dir falls back to the block's
    ({"enabled": True, "dir": "tel"}, {"HYDRAGNN_TELEMETRY": "",
                                       "HYDRAGNN_TELEMETRY_DIR": ""}),
    ({"enabled": True, "dir": "tel"}, {"HYDRAGNN_TELEMETRY_DIR": " env "}),
    ({"device_trace_epoch": 3}, {"HYDRAGNN_DEVICE_TRACE_EPOCH": "1"}),
    ({"device_trace_epoch": 3}, {"HYDRAGNN_DEVICE_TRACE_EPOCH": ""}),
    # typos warn and keep the block's value
    ({"enabled": True}, {"HYDRAGNN_TELEMETRY": "ture"}),
    ({}, {"HYDRAGNN_TELEMETRY": "yes please",
          "HYDRAGNN_DEVICE_TRACE": "2"}),
    ({"device_trace_epoch": 3}, {"HYDRAGNN_DEVICE_TRACE_EPOCH": "one"}),
]


@pytest.mark.parametrize("block,env", TELEMETRY_CASES)
def test_resolve_telemetry_matches_jax(clean_env, caplog, block, env):
    """C7: each telemetry knob resolves env over block over off, with
    JAX's strict parsing (set-but-empty, "0"/"false", typos, the
    artifact directory and the traced epoch) and the same warnings."""
    import dataclasses
    for name in TELEMETRY_ENVS:
        clean_env.delenv(name, raising=False)
    for name, value in env.items():
        clean_env.setenv(name, value)
    train_cfg = {} if block is None else {"Telemetry": block}
    with caplog.at_level(logging.WARNING):
        want = j_resolve_telemetry(train_cfg)
        got = resolve_telemetry(train_cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for run_dir in ("logs/a", "x"):
        assert got.resolve_out_dir(run_dir) == want.resolve_out_dir(run_dir)
    warned = {r.name for r in caplog.records}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)


def _tiny_run(tmp_path, telemetry, profile=None, num_epoch=2):
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from tests.utils import make_config
    cfg = make_config("PNA")
    cfg["NeuralNetwork"]["Training"].update(num_epoch=num_epoch,
                                            batch_size=4)
    cfg["NeuralNetwork"]["Training"]["Telemetry"] = telemetry
    if profile is not None:
        cfg["Profile"] = profile
    s = synthetic_molecules(12, seed=3, min_atoms=3, max_atoms=6,
                            num_features=1)
    return run_training(cfg, datasets=(s[:8], s[8:10], s[10:]),
                        device="cpu")


def test_device_trace_alone_traces_the_target_epoch(clean_env, tmp_path):
    """C7, reproduced at the re-anchor: `device_trace: true` with the
    session off traces the target epoch (one torch.profiler trace under
    <telemetry dir>/profile), as JAX's run_training brackets it without
    a session; no session artifacts are written."""
    import glob
    import os
    for name in TELEMETRY_ENVS:
        clean_env.delenv(name, raising=False)
    clean_env.chdir(tmp_path)
    _tiny_run(tmp_path, {"device_trace": True, "device_trace_epoch": 1,
                         "dir": "tel"})
    assert len(glob.glob(os.path.join("tel", "profile", "*.json"))) == 1
    assert not os.path.exists(os.path.join("tel", "telemetry.jsonl"))


def test_telemetry_env_zero_runs_without_a_session(clean_env, tmp_path):
    """C7, reproduced at the re-anchor: `enabled: true` under
    HYDRAGNN_TELEMETRY=0 trains with no session (no artifacts, the
    process registry untouched), as in JAX."""
    import os
    from hydragnn_tpu_torch.telemetry import get_registry
    for name in TELEMETRY_ENVS:
        clean_env.delenv(name, raising=False)
    clean_env.setenv("HYDRAGNN_TELEMETRY", "0")
    clean_env.chdir(tmp_path)
    reg = get_registry()
    _, history, _, _ = _tiny_run(tmp_path, {"enabled": True, "dir": "tel"})
    assert len(history["train_loss"]) == 2
    assert get_registry() is reg
    assert not os.path.exists("tel")
    assert "achieved_flops_per_s" not in history


@pytest.mark.parametrize("value", [None, True, False, 1, 0])
def test_conv_checkpointing_resolves_as_jax_and_is_not_refused(value):
    """Training.conv_checkpointing (a config key only, as in the JAX
    package) completes to JAX's ModelConfig value and passes
    check_training_knobs: remat is ported (tests/test_torch_node_heads.py
    holds it bitwise)."""
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.run_training import check_training_knobs
    from tests.deterministic_data import deterministic_graph_dataset
    from tests.test_torch_train import to_port_samples
    from tests.utils import make_config
    jsamples = deterministic_graph_dataset(num_configs=6)
    cfg = make_config("GIN")
    if value is not None:
        cfg["NeuralNetwork"]["Training"]["conv_checkpointing"] = value
    check_training_knobs(copy.deepcopy(cfg))
    want = jcfg.build_model_config(jcfg.update_config(copy.deepcopy(cfg),
                                                      jsamples))
    got = tcfg.build_model_config(tcfg.update_config(
        copy.deepcopy(cfg), to_port_samples(jsamples)))
    assert got.conv_checkpointing == want.conv_checkpointing == bool(value)


@pytest.mark.parametrize("knob,value,model,raises", [
    (("Training", "Optimizer", "use_zero_redundancy"), True, "GIN", False),
    (("Training", "Optimizer", "zero_min_shard_size"), 0, "GIN", False),
    (("Training", "pipeline_data_shards"), 2, "GIN", False),
    (("Architecture", "graph_shards"), 2, "GIN", False),
    (("Training", "pipeline_stages"), 2, "GIN", False),
    (("Architecture", "graph_shards"), 2, "PNA", False),
    (("Architecture", "graph_shards"), 2, "SchNet", False),
    (("Architecture", "graph_shards"), 2, "SAGE", True),
    (("Architecture", "graph_shards"), 2, "DimeNet", True)])
def test_multi_gpu_knobs_resolve_or_raise_naming_a9(clean_env, knob, value,
                                                    model, raises):
    """The data-parallel knobs are ported (ZeRO: a no-op in one process,
    as in the JAX package; tests/test_torch_parallel_zero.py holds it over
    ranks), and so are the pipeline (tests/test_torch_pipeline_run.py),
    its data axis (`pipeline_data_shards > 1` on a pipelined config,
    tests/test_torch_pipeline_data.py) and graph parallelism for GIN, PNA
    and SchNet (tests/test_torch_composite.py); graph_shards on the other
    model types still raises naming A9, before any work."""
    from hydragnn_tpu_torch.run_training import check_training_knobs
    from tests.utils import make_config
    cfg = make_config(model)
    node = cfg["NeuralNetwork"]
    for k in knob[:-1]:
        node = node.setdefault(k, {})
    node[knob[-1]] = value
    if knob[-1] == "pipeline_data_shards":
        # the data axis is read on a pipelined config only, as in JAX
        node["pipeline_stages"] = 2
    if raises:
        with pytest.raises(NotImplementedError, match="A9"):
            check_training_knobs(cfg)
    else:
        check_training_knobs(cfg)


@pytest.mark.parametrize("stages,graph_shards,num_shards", [
    (1, 2, 1), (1, 4, 2), (2, 1, 2), (1, 1, 1)])
def test_multiprocess_refusal_names_the_real_graph_shards(
        clean_env, monkeypatch, tmp_path, stages, graph_shards, num_shards):
    """A multi-process run takes the plain data-parallel path only: the
    port's refusal (`run_training.multiprocess_path_check`) carries the
    JAX package's message with the real graph_shards, held against JAX's
    run_training made to see two processes (its check,
    run_training.py:278-287, runs before any process talks to another)."""
    import importlib
    from hydragnn_tpu.parallel import multiprocess as jmp
    from hydragnn_tpu.run_training import run_training as j_run_training
    from tests.deterministic_data import deterministic_graph_dataset
    from tests.utils import make_config
    rt = importlib.import_module("hydragnn_tpu_torch.run_training")
    monkeypatch.chdir(tmp_path)
    cfg = make_config("GIN")
    cfg["NeuralNetwork"]["Architecture"]["graph_shards"] = graph_shards
    if stages > 1:
        cfg["NeuralNetwork"]["Training"].update(
            pipeline_stages=stages, pipeline_norm="layernorm")
    samples = deterministic_graph_dataset(num_configs=24)
    monkeypatch.setattr(jmp, "is_multiprocess", lambda: True)
    monkeypatch.setattr(jmp, "slice_by_process",
                        lambda data, **kw: data)
    with pytest.raises(ValueError) as want:
        j_run_training(cfg, datasets=(samples[:16], samples[16:20],
                                      samples[20:]), num_shards=num_shards)
    with pytest.raises(ValueError) as got:
        rt.multiprocess_path_check(2, stages, graph_shards, num_shards)
    assert str(got.value) == str(want.value)
    assert f"graph_shards={graph_shards}," in str(got.value)


# ---------------------------------------------------- C10, C11, C12 --

def test_pipelined_run_with_create_plots_trains_as_jax(tmp_path,
                                                       monkeypatch, capsys):
    """C10: GIN over 2 stages x 4 microbatches with
    Visualization.create_plots trains one epoch in both packages (JAX
    builds no Visualizer on the pipelined path), the port printing JAX's
    line; the histories within the pipeline bound for GIN (rtol 1e-5 /
    atol 1e-6)."""
    from hydragnn_tpu.run_training import run_training as j_run_training
    from hydragnn_tpu_torch import run_training
    from tests.test_torch_pipeline_run import (CPU2, HISTORY_KEYS, _cfg,
                                               _splits, _with_jax_init)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    splits, jsplits = _splits()
    _with_jax_init(monkeypatch)

    def cfg():
        c = _cfg("GIN", epochs=1)
        c["Visualization"] = {"create_plots": True}
        return c
    _, want, _, _ = j_run_training(cfg(), datasets=jsplits)
    capsys.readouterr()
    _, got, _, _ = run_training(cfg(), datasets=splits, device="cpu",
                                pipeline_devices=CPU2)
    assert ("pipeline_stages > 1: prediction-based plots are not wired for "
            "the pipelined parameter layout; skipping"
            in capsys.readouterr().out)
    for k in HISTORY_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_create_plots_off_the_pipeline_still_raises_naming_a10():
    """C10: where JAX builds the Visualizer (no pipeline), create_plots
    is still refused, naming A10, before any work."""
    from hydragnn_tpu_torch.run_training import check_training_knobs
    from tests.utils import make_config
    cfg = make_config("GIN")
    cfg["Visualization"] = {"create_plots": True}
    with pytest.raises(NotImplementedError, match="A10"):
        check_training_knobs(cfg)
    cfg["NeuralNetwork"]["Training"]["pipeline_stages"] = 1
    with pytest.raises(NotImplementedError, match="A10"):
        check_training_knobs(cfg)


def _jax_state_and_variables(cfg, jsplits, seed=3):
    import jax
    import jax.numpy as jnp
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu.graphs.batch import collate as j_collate
    from hydragnn_tpu.models.create import create_model as j_create_model
    from hydragnn_tpu.models.create import init_params as j_init_params
    from hydragnn_tpu.train.optimizer import select_optimizer as j_opt
    from hydragnn_tpu.train.train_step import TrainState as JState
    from tests.test_torch_train import numpy_tree
    done = jcfg.update_config(copy.deepcopy(cfg), *jsplits)
    jmodel = j_create_model(jcfg.build_model_config(done))
    variables = numpy_tree(j_init_params(
        jmodel, j_collate(jsplits[0][:4], np_out=True), seed=seed))
    jstate = JState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                           j_opt(done["NeuralNetwork"]["Training"]))
    return jmodel, jstate, variables


def test_engine_route_resolves_num_shards_before_refusing(clean_env,
                                                          monkeypatch):
    """C11: GIN, batch_size 5, num_shards=2, serve=True. JAX resolves the
    count over its devices (8 on this CPU) with the warning "requested
    num_shards=2 does not divide batch_size 5; falling back to a
    single-device run" and serves; the port, whose world is made the
    same size, warns the same words and serves, its predictions within
    1e-6 of JAX's."""
    import warnings
    import jax
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.parallel import mesh
    from tests.test_torch_train import to_jax_samples
    from tests.utils import make_config
    world = jax.device_count()
    assert world >= 2
    monkeypatch.setattr(mesh, "get_comm_size_and_rank",
                        lambda: (world, 0))
    splits = _lattice_splits(20)
    jsplits = tuple(to_jax_samples(s) for s in splits)
    cfg = make_config("GIN")
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 5
    jmodel, jstate, variables = _jax_state_and_variables(cfg, jsplits)
    words = ("requested num_shards=2 does not divide batch_size 5; "
             "falling back to a single-device run")
    out = []
    for call in (lambda: j_run_prediction(
                     copy.deepcopy(cfg), datasets=jsplits, state=jstate,
                     model=jmodel, serve=True, num_shards=2),
                 lambda: run_prediction(
                     copy.deepcopy(cfg), datasets=splits,
                     variables=variables, serve=True, device="cpu",
                     num_shards=2)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append(call())
        assert [str(w.message) for w in caught
                if "num_shards" in str(w.message)] == [words]
    (_, j_preds), (_, preds) = out
    np.testing.assert_allclose(preds[0], j_preds[0], rtol=0, atol=1e-6)


# (Serving block, Architecture.dtype, env, what runs)
PRECISION_CASES = {
    # (a) the engine off: the loop computes at the train-side policy
    "a": ({"precision": "float16"}, None, {}, "predict_loop"),
    # (b) the engine on, the env's bf16 over the block's float16
    "b": ({"precision": "float16"}, None,
          {"HYDRAGNN_SERVE_PRECISION": "bf16"}, "predict_engine"),
    # (c) run_training, HYDRAGNN_PRECISION's bf16 over Architecture.dtype
    "c": ({}, "float16", {"HYDRAGNN_PRECISION": "bf16"}, "train"),
}


@pytest.mark.parametrize("case", sorted(PRECISION_CASES))
def test_unported_dtype_name_runs_where_jax_does_not_act_on_it(
        clean_env, tmp_path, case):
    """C12: a numpy dtype name the port lacks (float16) passes through
    canonicalization as in JAX; where JAX's resolution never computes in
    it, both packages run: (a) Serving.precision float16 with the engine
    off (the loop at float32: predictions within 1e-6 of JAX's); (b) the
    same with the engine on under HYDRAGNN_SERVE_PRECISION=bf16 (both
    engines at bf16: within 2^-5 of JAX's); (c) Architecture.dtype
    float16 under HYDRAGNN_PRECISION=bf16 in run_training (both train at
    bf16: the epoch's losses within 2^-5 relative)."""
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu.run_training import run_training as j_run_training
    from hydragnn_tpu.serving.config import resolve_serving as j_serving
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.config import config as tcfg
    from tests.test_torch_train import to_jax_samples
    from tests.utils import make_config
    clean_env.chdir(tmp_path)
    clean_env.setenv("HYDRAGNN_DISABLE_TB", "1")
    for name in ("HYDRAGNN_PRECISION", "HYDRAGNN_SERVE_PRECISION"):
        clean_env.delenv(name, raising=False)
    serving, dtype, env, what = PRECISION_CASES[case]
    for name, value in env.items():
        clean_env.setenv(name, value)
    splits = _lattice_splits(20)
    jsplits = tuple(to_jax_samples(s) for s in splits)
    cfg = make_config("GIN")
    cfg["Serving"] = dict(serving)
    if dtype is not None:
        cfg["NeuralNetwork"]["Architecture"]["dtype"] = dtype
    assert resolve_serving(cfg).precision == j_serving(cfg).precision
    done_j = jcfg.update_config(copy.deepcopy(cfg), *jsplits)
    done_t = tcfg.update_config(copy.deepcopy(cfg), *splits)
    assert tcfg.build_model_config(done_t).dtype == \
        jcfg.build_model_config(done_j).dtype
    if what == "train":
        import importlib
        import jax
        from hydragnn_tpu_torch.models.create import create_model
        from hydragnn_tpu_torch.utils.weights import load_jax_variables
        from tests.test_torch_train import numpy_tree
        jrun = importlib.import_module("hydragnn_tpu.run_training")
        prun = importlib.import_module("hydragnn_tpu_torch.run_training")
        cfg["NeuralNetwork"]["Training"].update(
            num_epoch=1, EarlyStopping=False,
            Optimizer={"type": "SGD", "learning_rate": 0.01})
        inits, j_init = [], jrun.init_params

        def spy(*a, **k):       # one initial weights for both packages
            inits.append(numpy_tree(j_init(*a, **k)))
            return jax.tree_util.tree_map(jax.numpy.asarray, inits[-1])

        def port_model(mcfg, device="cuda", seed=0):
            model = create_model(mcfg, device=device, seed=seed)
            model.load_state_dict(load_jax_variables(inits[0]))
            return model
        clean_env.setattr(jrun, "init_params", spy)
        clean_env.setattr(prun, "create_model", port_model)
        _, want, _, _ = j_run_training(copy.deepcopy(cfg), datasets=jsplits,
                                       num_shards=1)
        _, got, _, _ = run_training(copy.deepcopy(cfg), datasets=splits,
                                    device="cpu")
        for k in ("train_loss", "val_loss", "test_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=2 ** -5,
                                       err_msg=k)
        return
    jmodel, jstate, variables = _jax_state_and_variables(cfg, jsplits)
    serve = what == "predict_engine"
    _, j_preds = j_run_prediction(copy.deepcopy(cfg), datasets=jsplits,
                                  state=jstate, model=jmodel, serve=serve)
    _, preds = run_prediction(copy.deepcopy(cfg), datasets=splits,
                              variables=variables, serve=serve,
                              device="cpu")
    tol = (dict(rtol=2 ** -5, atol=2 ** -5) if serve
           else dict(rtol=0, atol=1e-6))
    np.testing.assert_allclose(preds[0], j_preds[0], **tol)


def test_resolved_float16_is_refused_naming_a5(clean_env):
    """C12: where the resolved compute dtype is float16 (Architecture.dtype
    float16 and no env, or an engine asked for float16), JAX computes in
    it and the port raises naming A5: the train and eval step factories,
    run_training and the engine."""
    from hydragnn_tpu.train import precision as jprec
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    from tests.utils import make_config
    for name in ("HYDRAGNN_PRECISION", "HYDRAGNN_SERVE_PRECISION"):
        clean_env.delenv(name, raising=False)
    splits = _lattice_splits(20)
    cfg = make_config("GIN")
    cfg["NeuralNetwork"]["Architecture"]["dtype"] = "float16"
    done = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = tcfg.build_model_config(done)
    assert mcfg.dtype == "float16" == jprec.resolve_precision(mcfg.dtype)
    model = create_model(mcfg, device="cpu")
    tx = topt.Optimizer("SGD", learning_rate=0.01)
    f32 = tcfg.build_model_config(tcfg.update_config(make_config("GIN"),
                                                     *splits))
    for make in (lambda: tstep.make_train_step(model, mcfg, tx),
                 lambda: tstep.make_eval_step(model, mcfg),
                 lambda: run_training(copy.deepcopy(cfg), datasets=splits,
                                      device="cpu"),
                 lambda: InferenceEngine(model, f32,
                                         reference_samples=splits[2],
                                         compute_dtype="float16",
                                         device="cpu")):
        with pytest.raises(NotImplementedError, match="A5"):
            make()
