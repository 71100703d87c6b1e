"""The port's HPO search pieces against the JAX package's on the CPU:

* utils/bayes_opt.py: the encoder, the GP and the CBO bitwise JAX's: the
  same seed and the same tells give the same asks, past the warm-up, with
  the constant liar and an inf tell's worst-finite stand-in;
* utils/hpo.py: the nodelist parser, the launch command (the card pin
  CUDA_VISIBLE_DEVICES where JAX pins TPU_VISIBLE_CHIPS, the rest
  equal), `search`'s history on a seeded quadratic (CBO and the
  HYDRAGNN_HPO_RANDOM branch), and `orchestrate` on tests/test_hpo.py's
  toy trial script with concurrent=1 (trials.jsonl's params and values,
  failed trials null with their rc, resume skipping logged trials);
* utils/envflags.py's `resolve_hpo_supervisor` and `resolve_elastic`: a
  table of env and config cases, set-but-empty and malformed values and
  the warning each logs, against JAX's resolvers;
* hpo/pbt.py: `perturb_params` bitwise; the fork of a trial's BEST
  checkpoint and its fallbacks (BEST malformed or uncommitted: a warning
  and the newest verified step; nothing to fork: FileNotFoundError); a
  forked trial starts at epoch 0 from the donor's weights;
* examples/qm9_hpo.py: the first three asks over its SPACE bitwise JAX's
  CBO, hpo_results.json in JAX's layout, a trial through
  `make_objective` and a failing one scored inf with its reason.
"""
import json
import logging
import os
import textwrap

import numpy as np
import pytest
import torch

import hydragnn_tpu.hpo.pbt as jpbt
import hydragnn_tpu.utils.bayes_opt as jbo
import hydragnn_tpu.utils.envflags as jenv
import hydragnn_tpu.utils.hpo as jhpo
import hydragnn_tpu_torch.hpo.pbt as tpbt
import hydragnn_tpu_torch.utils.bayes_opt as tbo
import hydragnn_tpu_torch.utils.envflags as tenv
import hydragnn_tpu_torch.utils.hpo as thpo

torch.set_num_threads(1)

SPACE = {"lr": (1e-5, 1e-1), "width": (4, 64),
         "model": ["GIN", "PNA", "SAGE"], "shift": (-0.5, 0.5), "fixed": 7}


def _objective(p):
    return ((np.log10(p["lr"]) + 3.0) ** 2 + (p["width"] - 20) ** 2 / 400.0
            + p["shift"] ** 2 + (0.0 if p["model"] == "PNA" else 0.3))


# --------------------------------------------------------- bayes_opt.py

def test_encoder_and_gp_bitwise_jax():
    je, te = jbo._Encoder(SPACE), tbo._Encoder(SPACE)
    assert te.dims == je.dims and te.d == je.d
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(20):
        p, q = je.sample(r1), te.sample(r2)
        assert p == q
        np.testing.assert_array_equal(te.encode(q), je.encode(p))
    rng = np.random.RandomState(0)
    X, Xs = rng.rand(20, 3), rng.rand(7, 3)
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    for a, b in zip(tbo._GP().fit(X, y).predict(Xs),
                    jbo._GP().fit(X, y).predict(Xs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tbo._matern52(X, Xs, 0.3),
                                  jbo._matern52(X, Xs, 0.3))


@pytest.mark.parametrize("maximize", [False, True])
def test_cbo_asks_bitwise_jax_past_warmup(maximize):
    """Asks and tells interleaved, a batch of asks before their tells
    (the constant liar), an inf tell, past the warm-up of 4."""
    opts = [m.CBO(SPACE, seed=5, n_warmup=4, n_candidates=64,
                  maximize=maximize) for m in (jbo, tbo)]
    for rnd in range(5):
        batches = [[o.ask() for _ in range(3)] for o in opts]
        assert batches[0] == batches[1], rnd
        for i, p in enumerate(batches[0]):
            val = float("inf") if (rnd, i) == (2, 1) else _objective(p)
            for o in opts:
                o.tell(p, val)
    assert opts[0].y == opts[1].y and opts[0].best == opts[1].best
    assert all(np.isfinite(v) for v in opts[1].y)
    assert opts[0].pending == [] and opts[1].pending == []


# ------------------------------------------------------------ utils/hpo

@pytest.mark.parametrize("nodelist", [
    "frontier[00001-00003,00007]", "node12", "node1,node2", "",
    "frontier[001-002],borg[005]", "a[1-2],b,c[04,06-07]",
    "x[08-10],y[1-2]"])
def test_parse_slurm_nodelist_matches_jax(nodelist):
    assert thpo.parse_slurm_nodelist(nodelist) == \
        jhpo.parse_slurm_nodelist(nodelist)


def test_read_node_list_matches_jax(monkeypatch):
    for env in ({"SLURM_NODELIST": "n[1-2],m[7]"},
                {"SLURM_JOB_NODELIST": "solo"}, {"SLURM_NODELIST": " "}, {}):
        for k in ("SLURM_NODELIST", "SLURM_JOB_NODELIST"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert thpo.read_node_list() == jhpo.read_node_list()


@pytest.mark.parametrize("chips,coord", [
    (None, None), ([2, 3], None), ([0], "10.0.0.1:1234"),
    (None, "host:9")])
def test_launch_command_is_jax_with_the_card_pin(chips, coord):
    args = {"lr": 0.01, "flag": "", "model": "PNA"}
    want = jhpo.create_launch_command("t.py", args, chips=chips,
                                      coordinator=coord, python="py")
    got = thpo.create_launch_command("t.py", args, chips=chips,
                                     coordinator=coord, python="py")
    assert got == [w.replace("TPU_VISIBLE_CHIPS=", "CUDA_VISIBLE_DEVICES=")
                   for w in want]
    assert thpo.split_env_prefix(got)[1] == jhpo.split_env_prefix(want)[1]
    env, _ = thpo.split_env_prefix(got)
    if chips:
        assert env["CUDA_VISIBLE_DEVICES"] == ",".join(map(str, chips))


def test_search_space_sample_bitwise_jax():
    # SearchSpace samples float ranges log-uniformly (positive ranges only)
    space = {k: v for k, v in SPACE.items() if k != "shift"}
    r1, r2 = np.random.RandomState(1), np.random.RandomState(1)
    for _ in range(10):
        assert thpo.SearchSpace(space).sample(r2) == \
            jhpo.SearchSpace(space).sample(r1)


@pytest.mark.parametrize("random", [False, True])
def test_search_history_matches_jax(monkeypatch, tmp_path, random):
    if random:
        monkeypatch.setenv("HYDRAGNN_HPO_RANDOM", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_HPO_RANDOM", raising=False)
    space = {"x": (0.01, 1.0), "y": (0.01, 1.0)}

    def f(p):
        return (p["x"] - 0.3) ** 2 + (p["y"] - 0.7) ** 2
    out = {}
    for key, mod in (("jax", jhpo), ("torch", thpo)):
        path = str(tmp_path / f"{key}.json")
        out[key] = (mod.search(f, space, num_trials=12, seed=3,
                               log_path=path), open(path).read())
    assert out["torch"] == out["jax"]


TRIAL = textwrap.dedent("""
    import argparse, json
    p = argparse.ArgumentParser()
    p.add_argument("--x", type=float)
    p.add_argument("--tag", default="")
    a = p.parse_args()
    print(json.dumps({"final_val_loss": (a.x - 0.4) ** 2}))
""")


def _trials(log_dir):
    with open(os.path.join(log_dir, "trials.jsonl")) as f:
        return [{k: r[k] for k in ("params", "value", "failed", "timed_out",
                                   "rc")} for r in map(json.loads, f)]


def test_orchestrate_matches_jax(tmp_path):
    (tmp_path / "trial.py").write_text(TRIAL)
    (tmp_path / "bad.py").write_text("import sys; sys.exit(3)\n")
    out = {}
    for key, mod in (("jax", jhpo), ("torch", thpo)):
        log_dir = str(tmp_path / key)
        res = mod.orchestrate(str(tmp_path / "trial.py"), {"x": (0.01, 1.0)},
                              num_trials=3, concurrent=1, seed=0,
                              log_dir=log_dir, extra_args={"tag": "t"},
                              timeout_s=120)
        # resume: one more trial on top of the three logged
        res2 = mod.orchestrate(str(tmp_path / "trial.py"),
                               {"x": (0.01, 1.0)}, num_trials=4,
                               concurrent=1, seed=0, log_dir=log_dir,
                               extra_args={"tag": "t"}, timeout_s=120)
        bad_dir = str(tmp_path / f"{key}_bad")
        bad = mod.orchestrate(str(tmp_path / "bad.py"), {"x": (0.01, 1.0)},
                              num_trials=2, concurrent=1, seed=0,
                              log_dir=bad_dir, timeout_s=60)
        bad2 = mod.orchestrate(str(tmp_path / "bad.py"), {"x": (0.01, 1.0)},
                               num_trials=2, concurrent=1, seed=0,
                               log_dir=bad_dir, timeout_s=60)
        with open(os.path.join(log_dir, "result.json")) as f:
            best = json.load(f)["best"]
        out[key] = (_trials(log_dir), res["best"], len(res2["history"]),
                    best, _trials(bad_dir), len(bad2["history"]))
    assert out["torch"] == out["jax"]
    assert all(r["value"] is None and r["failed"] and r["rc"] == 3
               for r in out["torch"][4])
    assert out["torch"][2] == 4 and out["torch"][5] == 2


# ------------------------------------------------------------- envflags

HPO_ENV = ("HYDRAGNN_HPO_MAX_RETRIES", "HYDRAGNN_HPO_HEARTBEAT_S",
           "HYDRAGNN_HPO_BACKOFF_S", "HYDRAGNN_HPO_CONCURRENCY")
EL_ENV = ("HYDRAGNN_ELASTIC_MAX_RESTARTS", "HYDRAGNN_ELASTIC_HEARTBEAT_S",
          "HYDRAGNN_ELASTIC_BACKOFF_S")


@pytest.mark.parametrize("env,cfg", [
    ({}, None),
    ({}, {"max_retries": 5, "heartbeat_s": 9.0, "backoff_s": 0.2,
          "concurrency": 4, "max_restarts": 5}),
    ({"HYDRAGNN_HPO_MAX_RETRIES": "1", "HYDRAGNN_HPO_HEARTBEAT_S": "3.5",
      "HYDRAGNN_HPO_BACKOFF_S": "0", "HYDRAGNN_HPO_CONCURRENCY": "8",
      "HYDRAGNN_ELASTIC_MAX_RESTARTS": "7",
      "HYDRAGNN_ELASTIC_HEARTBEAT_S": "30",
      "HYDRAGNN_ELASTIC_BACKOFF_S": "0.5"}, {"max_retries": 5}),
    ({"HYDRAGNN_HPO_MAX_RETRIES": "threeish",
      "HYDRAGNN_ELASTIC_MAX_RESTARTS": "seven",
      "HYDRAGNN_HPO_HEARTBEAT_S": "soon"}, {"max_retries": 5,
                                           "max_restarts": 4}),
    ({"HYDRAGNN_HPO_MAX_RETRIES": "", "HYDRAGNN_HPO_CONCURRENCY": "  ",
      "HYDRAGNN_ELASTIC_BACKOFF_S": ""}, {"concurrency": 3,
                                          "backoff_s": 2.0}),
    ({"HYDRAGNN_HPO_MAX_RETRIES": "-3", "HYDRAGNN_HPO_HEARTBEAT_S": "0",
      "HYDRAGNN_HPO_CONCURRENCY": "0", "HYDRAGNN_ELASTIC_HEARTBEAT_S": "0",
      "HYDRAGNN_ELASTIC_BACKOFF_S": "-1"}, None),
    ({"HYDRAGNN_ELASTIC_MAX_RESTARTS": "2.5",
      "HYDRAGNN_HPO_BACKOFF_S": "1e-1"}, {"max_restarts": -3,
                                          "heartbeat_s": 0.0}),
])
def test_supervisor_knobs_resolve_as_jax(monkeypatch, caplog, env, cfg):
    for name in HPO_ENV + EL_ENV:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    for key, mod, logger in (("jax", jenv, "hydragnn_tpu"),
                             ("torch", tenv, "hydragnn_tpu_torch")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            vals = (mod.resolve_hpo_supervisor(cfg), mod.resolve_elastic(cfg))
        got[key] = (vals, [r.getMessage() for r in caplog.records
                           if r.name == logger])
    assert got["torch"] == got["jax"]
    warned = " ".join(got["torch"][1])
    for name, val in env.items():
        if val in ("threeish", "seven", "soon", "2.5"):
            assert name in warned, name
        elif not val.strip():
            assert name not in warned, name


# -------------------------------------------------------------------- pbt

def test_perturb_params_bitwise_jax():
    params = {"lr": 0.01, "width": 16, "model": "GIN", "fixed": 7,
              "shift": 0.1}
    for seed in range(40):
        got = tpbt.perturb_params(params, SPACE, seed=seed)
        assert got == jpbt.perturb_params(params, SPACE, seed=seed)
        assert 1e-5 <= got["lr"] <= 1e-1 and isinstance(got["width"], int)
    assert tpbt.perturb_params(params, SPACE, 3, factors=(0.5, 2.0),
                               resample_prob=1.0) == \
        jpbt.perturb_params(params, SPACE, 3, factors=(0.5, 2.0),
                            resample_prob=1.0)


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """A trial trained 3 epochs on the CPU: its run's checkpoint dir."""
    from hydragnn_tpu_torch.hpo.runner import run_trial
    d = tmp_path_factory.mktemp("donor") / "trial_0000"
    d.mkdir()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        result = run_trial({"learning_rate": 0.01}, num_epochs=3,
                           num_configs=16, data_seed=0, resume=False,
                           device="cpu")
    finally:
        os.chdir(cwd)
    (ckpt,) = (d / "logs").glob("*/checkpoint")
    return d, str(ckpt), result


def _copy_ckpt(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return str(dst)


def test_fork_checkpoint_and_fallbacks(donor, tmp_path, caplog):
    from hydragnn_tpu_torch.utils import checkpoint as ck
    _, src, _ = donor
    with open(os.path.join(src, "BEST")) as f:
        best_name, best_val = f.read().split()
    step, val = tpbt.fork_checkpoint(src, str(tmp_path / "f0"))
    assert (f"step_{step}", val) == (best_name, float(best_val))
    dst = os.path.join(str(tmp_path / "f0"), best_name)
    assert ck.verify_checkpoint(dst, deep=True)
    assert not os.path.exists(os.path.join(dst, ck.RESUME_META))
    with open(os.path.join(str(tmp_path / "f0"), "LATEST")) as f:
        assert f.read().strip() == best_name
    assert tpbt.fork_checkpoint(src, str(tmp_path / "f0b")) == (step, val)
    newest = max(int(p[5:]) for p in os.listdir(src) if p.startswith("step_"))
    # an empty BEST: a warning and the newest verified step, val unknown
    bad = _copy_ckpt(src, tmp_path / "bad")
    with open(os.path.join(bad, "BEST"), "w") as f:
        f.write("")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="hydragnn_tpu_torch"):
        assert tpbt.select_fork_source(bad) == (
            os.path.join(bad, f"step_{newest}"), None)
    assert any("falling back" in r.getMessage() for r in caplog.records)
    # a garbled val line keeps the target, val unknown (as JAX parses it:
    # the target is read before the val raises)
    with open(os.path.join(bad, "BEST"), "w") as f:
        f.write(f"{best_name}\nnot-a-number")
    assert tpbt.select_fork_source(bad) == (os.path.join(bad, best_name),
                                            None)
    unc = _copy_ckpt(src, tmp_path / "unc")
    os.remove(os.path.join(unc, best_name, ck.COMMIT_MARKER))
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="hydragnn_tpu_torch"):
        target, v = tpbt.select_fork_source(unc)
    assert v is None and caplog.records
    assert target == os.path.join(unc, f"step_{newest}") or \
        best_name == f"step_{newest}"
    empty = tmp_path / "empty"
    empty.mkdir()
    for src_dir in (str(empty), str(tmp_path / "missing")):
        with pytest.raises(FileNotFoundError):
            tpbt.fork_checkpoint(src_dir, str(tmp_path / "nowhere"))


def test_forked_trial_starts_at_epoch_zero_from_donor_weights(
        donor, tmp_path, monkeypatch):
    """ProcessLauncher's fork preparation, then the runner in-process: the
    fork's run restores the donor's BEST state and trains from epoch 0."""
    import importlib
    from hydragnn_tpu_torch.hpo import ProcessLauncher, TrialSpec
    from hydragnn_tpu_torch.hpo.runner import run_trial
    trt = importlib.import_module("hydragnn_tpu_torch.run_training")
    trial_dir, src, _ = donor
    la = ProcessLauncher(os.path.dirname(str(trial_dir)), device="cpu")
    spec = TrialSpec(5, {"learning_rate": 0.02}, seed=5, forked_from=0)
    fork_dir = la.trial_dir(5)
    os.makedirs(fork_dir)
    la._prepare_fork(spec, fork_dir)
    with open(os.path.join(fork_dir, "FORK.json")) as f:
        meta = json.load(f)
    with open(os.path.join(src, "BEST")) as f:
        best_name = f.readline().strip()
    assert meta["donor_step"] == int(best_name[5:])
    assert meta["donor_trial"] == 0 and meta["startfrom"] == "_fork_donor"
    seen = {}
    resume = trt._resume

    def spy(train_cfg, state, log_name, verbosity):
        out = resume(train_cfg, state, log_name, verbosity)
        seen["start"] = out[0]
        seen["params"] = {k: v.clone() for k, v in state.params.items()}
        seen["step"] = int(state.step)
        return out
    monkeypatch.setattr(trt, "_resume", spy)
    monkeypatch.chdir(fork_dir)
    result = run_trial(spec.params, num_epochs=2, num_configs=16,
                       data_seed=0, resume=False, device="cpu")
    assert seen["start"] == 0
    assert len(result["history"]["train_loss"]) == 2
    donor_state = torch.load(os.path.join(src, best_name, "state.pt"),
                             weights_only=True)
    assert seen["step"] == donor_state["step"]
    for k, v in donor_state["params"].items():
        assert torch.equal(seen["params"][k], v), k


# ---------------------------------------------------------------- qm9 hpo

def test_qm9_search_asks_and_results_layout_match_jax(tmp_path):
    from examples.qm9_hpo import common as jqm9
    from hydragnn_tpu_torch.examples import qm9_hpo
    assert qm9_hpo.SPACE == jqm9.SPACE
    assert qm9_hpo.load_base_config() == jqm9.load_base_config()
    asks = []
    for mod in (jbo, tbo):
        opt = mod.CBO(qm9_hpo.SPACE, seed=0)
        asks.append([opt.ask() for _ in range(3)])
    assert asks[0] == asks[1]

    def f(p):
        return p["hidden_dim"] / 64.0 + p["num_conv_layers"] \
            + (0.0 if p["model_type"] == "PNA" else 1.0)
    logs = []
    for key, mod in (("jax", jhpo), ("torch", thpo)):
        path = str(tmp_path / f"{key}.json")
        mod.search(f, qm9_hpo.SPACE, num_trials=4, log_path=path)
        with open(path) as fh:
            logs.append(json.load(fh))
    assert logs[0] == logs[1]
    assert list(logs[1]) == ["best", "history"]
    assert list(logs[1]["history"][0]) == ["params", "value"]


def test_qm9_objective_trains_and_scores_failures_inf(capsys):
    from hydragnn_tpu_torch.examples import qm9_hpo
    base = qm9_hpo.load_base_config()
    splits = qm9_hpo.load_splits(24, base)
    objective = qm9_hpo.make_objective(base, splits, 1, device="cpu")
    val = objective({"model_type": "PNA", "hidden_dim": 16,
                     "num_conv_layers": 1, "num_headlayers": 1,
                     "dim_headlayer": 16})
    assert np.isfinite(val)
    assert "trial failed" not in capsys.readouterr().out
    bad = {"model_type": "NoSuchModel", "hidden_dim": 16,
           "num_conv_layers": 1, "num_headlayers": 1, "dim_headlayer": 16}
    assert objective(bad) == float("inf")
    out = capsys.readouterr().out
    assert "trial failed: " in out and "NoSuchModel" in out


def test_supervision_modules_import_no_jax():
    """The slice's modules (and the runners its children run) import
    nothing of JAX or the JAX package."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, '.'); "
            "import hydragnn_tpu_torch.hpo, hydragnn_tpu_torch.hpo.runner, "
            "hydragnn_tpu_torch.elastic, "
            "hydragnn_tpu_torch.elastic.runner, "
            "hydragnn_tpu_torch.utils.hpo, "
            "hydragnn_tpu_torch.utils.bayes_opt, "
            "hydragnn_tpu_torch.examples.qm9_hpo, "
            "hydragnn_tpu_torch.examples.gfm; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) "
            "or m == 'hydragnn_tpu' or m.startswith('hydragnn_tpu.') "
            "or m == 'examples' or m.startswith('examples.')]; "
            "print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
