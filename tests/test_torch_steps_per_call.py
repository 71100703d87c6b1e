"""Steps per call in the port (hydragnn_tpu_torch): the multi steps
(`make_multi_train_step` / `make_multi_eval_step`), the trainer's groups
and `run_training` with `Training.steps_per_call`, against the JAX
package's on the CPU, where the port runs the eager steps (on the card a
group is one CUDA graph replay: tests/test_torch_cuda.py). Also the
capture-safety the graphs rest on, pinned on the CPU: the optimizer
updates its slots in place and reads its per-step scalars from a tensor,
and a restore or a resume copies into the live tensors.

Bounds:
* port vs JAX: rtol 1e-4 / atol 1e-5 on losses (TRAIN_TOL of
  tests/test_torch_train.py: the two packages add in other orders inside
  GEMMs and reductions, and the optimizer carries the differences). The
  optimizer is SGD with momentum there, as in that file: Adam turns
  gradient noise below its eps into lr-sized updates whose sign follows
  the summation order.
* port vs port (a group against its single steps, S = 2 against S = 1):
  bitwise.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import build_model_config as j_build_model_config
from hydragnn_tpu.config import update_config as j_update_config
from hydragnn_tpu.graphs.batch import collate as j_collate
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu.utils.envflags import \
    resolve_steps_per_call as j_resolve_steps_per_call
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.utils import checkpoint as ckpt
from hydragnn_tpu_torch.utils.envflags import resolve_steps_per_call
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.deterministic_data import deterministic_graph_dataset
from tests.utils import make_config

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them.
torch.set_num_threads(1)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
SGD = {"type": "SGD", "learning_rate": 0.01}
RULES = ["SGD", "Adam", "Adadelta", "Adagrad", "Adamax", "AdamW", "RMSprop",
         "FusedLAMB"]


def to_port_samples(samples):
    return [tbatch.GraphSample(
        x=s.x, pos=s.pos, senders=s.senders, receivers=s.receivers,
        edge_shifts=s.edge_shifts, y_graph=s.y_graph, y_node=s.y_node,
        cell=s.cell, energy=s.energy, forces=s.forces) for s in samples]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def assert_tree_close(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **tol)


def _lattice(num_configs, optimizer=None):
    """The deterministic lattice PNA of tests/test_training.py, as the
    JAX package and the port complete its config."""
    samples = deterministic_graph_dataset(num_configs=num_configs)
    cfg = make_config("PNA", heads=("graph",))
    if optimizer is not None:
        cfg["NeuralNetwork"]["Training"]["Optimizer"] = dict(optimizer)
    jc = j_update_config(copy.deepcopy(cfg), samples)
    tc = tcfg.update_config(copy.deepcopy(cfg), to_port_samples(samples))
    return samples, cfg, jc, tc


def _state_arrays(state):
    """Every tensor of a port state, by name, as numpy."""
    out = {f"p/{k}": v.detach().numpy().copy()
           for k, v in state.params.items()}
    out.update({f"b/{k}": v.detach().numpy().copy()
                for k, v in state.batch_stats.items()})
    opt = state.opt_state
    for k, ts in opt.slots.items():
        out.update({f"s/{k}/{i}": t.numpy().copy() for i, t in enumerate(ts)})
    for i, t in enumerate(opt.acc_grads or ()):
        out[f"a/{i}"] = t.numpy().copy()
    return out


def _slot_ptrs(state):
    opt = state.opt_state
    return [t.data_ptr() for ts in opt.slots.values() for t in ts] + [
        t.data_ptr() for t in (opt.acc_grads or ())]


# ------------------------------------------ the multi steps vs JAX's --
def test_multi_steps_match_jax():
    """S = 3 steps in one call from the same Flax variables: each step's
    loss against JAX's scanned multi step within TRAIN_TOL, the final
    parameters and batch statistics likewise, then the metrics-only multi
    eval step against JAX's."""
    samples, _, jc, tc = _lattice(12, SGD)
    jm, tm = j_build_model_config(jc), tcfg.build_model_config(tc)
    jmodel = j_create_model(jm)
    kw = dict(n_node=96, n_edge=640, n_graph=5)
    jbatches = [j_collate(samples[i:i + 4], **kw) for i in (0, 4, 8)]
    port_samples = to_port_samples(samples)
    batches = [tbatch.collate(port_samples[i:i + 4], **kw)
               for i in (0, 4, 8)]
    variables = numpy_tree(j_init_params(jmodel, jbatches[0]))
    train_cfg = {"Optimizer": SGD}
    tx = jopt.select_optimizer(train_cfg)
    jstate = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jbatches)
    jstate, jmetrics = jstep.make_multi_train_step(
        jmodel, jm, tx, donate=False)(jstate, stacked)

    model = create_model(tm, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    ptx = topt.select_optimizer(train_cfg)
    state = tstep.TrainState.create(model, ptx)
    state, metrics = tstep.make_multi_train_step(model, tm, ptx)(state,
                                                                 batches)
    assert metrics["loss"].shape == (3,) and state.step == 3
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), **TRAIN_TOL)
    np.testing.assert_array_equal(metrics["nonfinite_steps"].numpy(),
                                  np.zeros(3, np.float32))
    got = export_jax_variables(model)
    assert_tree_close(got["params"], numpy_tree(jstate.params), TRAIN_TOL)
    assert_tree_close(got["batch_stats"], numpy_tree(jstate.batch_stats),
                      TRAIN_TOL)

    jeval = jstep.make_multi_eval_step(jmodel, jm)(jstate, stacked)
    peval = tstep.make_multi_eval_step(model, tm)(state, batches)
    assert set(peval) == {"loss", "task_0"}
    np.testing.assert_allclose(peval["loss"].numpy(),
                               np.asarray(jeval["loss"]), **TRAIN_TOL)
    single = tstep.make_eval_step(model, tm)
    for i, b in enumerate(batches):
        assert float(single(state, b)[0]["loss"]) == float(peval["loss"][i])


@pytest.mark.parametrize("name,accumulate", [("AdamW", 1), ("AdamW", 2),
                                             ("SGD", 3)])
def test_group_equals_its_single_steps_bitwise(name, accumulate):
    """A group of S = 3 steps against 3 single steps from the same state:
    parameters, BatchNorm statistics, optimizer slots, the accumulator,
    the counters and the metrics bitwise, over two groups with a
    learning-rate change between them; with accumulation over 2 steps
    the second group starts mid-accumulation (phase 1), over 3 at a
    boundary."""
    samples, _, _, tc = _lattice(24)
    tm = tcfg.build_model_config(tc)
    port_samples = to_port_samples(samples)
    kw = dict(n_node=96, n_edge=640, n_graph=5)
    batches = [tbatch.collate(port_samples[i:i + 4], **kw)
               for i in range(0, 24, 4)]
    train_cfg = {"Optimizer": {"type": name, "learning_rate": 0.01},
                 "gradient_accumulation_steps": accumulate}
    runs = []
    for grouped in (False, True):
        model = create_model(tm, device="cpu", seed=5)
        tx = topt.select_optimizer(train_cfg)
        state = tstep.TrainState.create(model, tx)
        single = tstep.make_train_step(model, tm, tx)
        multi = tstep.make_multi_train_step(model, tm, tx)
        losses = []
        for g in range(2):
            if g == 1:
                topt.set_learning_rate(state.opt_state, 0.004)
            group = batches[3 * g:3 * g + 3]
            if grouped:
                state, m = multi(state, group)
                losses += list(m["loss"].numpy())
            else:
                for b in group:
                    state, m = single(state, b)
                    losses.append(float(m["loss"]))
        opt = state.opt_state
        runs.append((_state_arrays(state), losses, state.step,
                     (opt.count, opt.mini_step, opt.gradient_step)))
    (a, la, sa, ca), (b, lb, sb, cb) = runs
    assert sa == sb == 6 and ca == cb
    assert np.array_equal(np.float32(la), np.float32(lb))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------- run_training --
def test_run_training_steps_per_call_matches_jax(tmp_path, monkeypatch):
    """Training.steps_per_call 2 over 5 train batches (two groups and a
    remainder), 2 epochs: state.step 10, and 3 under
    HYDRAGNN_MAX_NUM_BATCH=3 (the cap lands inside the second group). The
    history against JAX's run_training with the same knob, from the same
    Flax variables (JAX's init, carried across), within TRAIN_TOL; the
    parameters bitwise against the port's own steps_per_call 1 run."""
    import importlib
    # the packages' `run_training` attributes are the functions
    jrun_mod = importlib.import_module("hydragnn_tpu.run_training")
    prun_mod = importlib.import_module("hydragnn_tpu_torch.run_training")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    samples = deterministic_graph_dataset(num_configs=28)
    cfg = make_config("PNA", heads=("graph",))
    tr_cfg = cfg["NeuralNetwork"]["Training"]
    tr_cfg.update(num_epoch=2, batch_size=4, steps_per_call=2,
                  keep_best=False, EarlyStopping=False,
                  Optimizer=dict(SGD))
    datasets = (samples[:20], samples[20:24], samples[24:])
    port_sets = tuple(to_port_samples(d) for d in datasets)

    inits = []

    def spy_init(*args, **kwargs):
        inits.append(numpy_tree(j_init_params(*args, **kwargs)))
        return jax.tree_util.tree_map(jnp.asarray, inits[-1])
    monkeypatch.setattr(jrun_mod, "init_params", spy_init)
    _, jhist, _, _ = jrun_mod.run_training(copy.deepcopy(cfg),
                                           datasets=datasets, num_shards=1)

    def port_model(mcfg, device="cuda", seed=0):
        model = create_model(mcfg, device=device, seed=seed)
        model.load_state_dict(load_jax_variables(inits[0]))
        return model
    monkeypatch.setattr(prun_mod, "create_model", port_model)
    state, hist, _, _ = prun_mod.run_training(
        copy.deepcopy(cfg), datasets=port_sets, device="cpu")
    assert state.step == 10
    assert len(hist["train_loss"]) == 2
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], err_msg=key,
                                   **TRAIN_TOL)
    assert hist["lr"] == jhist["lr"]

    one = copy.deepcopy(cfg)
    one["NeuralNetwork"]["Training"]["steps_per_call"] = 1
    state1, _, _, _ = prun_mod.run_training(one, datasets=port_sets,
                                            device="cpu")
    assert state1.step == 10
    for k, v in state.state_dict().items():
        assert torch.equal(v, state1.state_dict()[k]), k

    monkeypatch.setenv("HYDRAGNN_MAX_NUM_BATCH", "3")
    capped = copy.deepcopy(cfg)
    capped["NeuralNetwork"]["Training"]["num_epoch"] = 1
    state, _, _, _ = prun_mod.run_training(capped, datasets=port_sets,
                                           device="cpu")
    assert state.step == 3


@pytest.mark.parametrize("env,config,want", [
    (None, None, 1), (None, 4, 4), ("3", 4, 3), ("  ", 4, 4), ("1", 8, 1),
    ("", None, 1)])
def test_resolve_steps_per_call_env_over_config(monkeypatch, env, config,
                                                want):
    """HYDRAGNN_STEPS_PER_CALL, when set and not blank, wins over
    Training.steps_per_call (default 1), as in the JAX package; a value
    that is not an integer raises in both."""
    if env is None:
        monkeypatch.delenv("HYDRAGNN_STEPS_PER_CALL", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_STEPS_PER_CALL", env)
    train_cfg = {} if config is None else {"steps_per_call": config}
    assert resolve_steps_per_call(train_cfg) == want
    assert j_resolve_steps_per_call(train_cfg) == want
    monkeypatch.setenv("HYDRAGNN_STEPS_PER_CALL", "two")
    with pytest.raises(ValueError):
        resolve_steps_per_call(train_cfg)
    with pytest.raises(ValueError):
        j_resolve_steps_per_call(train_cfg)


# ------------------------------------------------ capture-safety --
@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("name", RULES)
def test_optimizer_updates_slots_in_place(name, accumulate):
    """After each of 5 updates every slot (and the accumulator) is the
    tensor `init` made; the step's scalar row holds -lr, the bias
    corrections the update's count takes and the micro-step divisor; a
    learning-rate change reaches the next update's row and its bits."""
    rng = np.random.RandomState(3)
    shapes = [(3, 4), (5,)]
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in shapes]
    tx = topt.Optimizer(name, learning_rate=0.01, accumulate=accumulate)
    st = tx.init(params)
    ptrs = [t.data_ptr() for ts in st.slots.values() for t in ts] + [
        t.data_ptr() for t in (st.acc_grads or ())]
    for i in range(5):
        row = tx.step_scalars(st)
        assert row[0] == -st.learning_rate
        assert row[1] == float(1 - torch.tensor(0.9) ** float(st.count + 1))
        assert row[3] == st.mini_step + 1
        grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in shapes]
        updates, st = tx.update(grads, st, params)
        assert [t.data_ptr() for ts in st.slots.values() for t in ts] + [
            t.data_ptr() for t in (st.acc_grads or ())] == ptrs
        if updates is not None:
            for p, u in zip(params, updates):
                p.add_(u)
    # the same state and gradients at two learning rates: the update
    # follows the new rate
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in shapes]
    outs = []
    for lr in (0.01, 0.002):
        probe = tx.init(params)
        for k, ts in st.slots.items():
            for v, w in zip(probe.slots[k], ts):
                v.copy_(w)
        probe.count, probe.mini_step = st.count, accumulate - 1
        topt.set_learning_rate(probe, lr)
        assert tx.step_scalars(probe)[0] == -float(np.float32(lr))
        updates, _ = tx.update(grads, probe, params)
        outs.append(updates)
    assert not all(torch.equal(a, b) for a, b in zip(*outs))


def test_restore_and_resume_copy_into_the_live_tensors(tmp_path,
                                                       monkeypatch):
    """TrainState.restore and a checkpoint resume (load_existing_model,
    then restore, as run_training's `continue` does) copy into the
    parameters, buffers, slots and accumulator the state already holds
    (a captured step keeps reading those), with the snapshot's values and
    counters."""
    monkeypatch.chdir(tmp_path)
    samples, _, _, tc = _lattice(8)
    tm = tcfg.build_model_config(tc)
    batch = tbatch.collate(to_port_samples(samples[:4]), n_node=96,
                           n_edge=640, n_graph=5)
    model = create_model(tm, device="cpu")
    tx = topt.select_optimizer({"Optimizer": {"type": "AdamW"},
                                "gradient_accumulation_steps": 2})
    state = tstep.TrainState.create(model, tx)
    step = tstep.make_train_step(model, tm, tx)
    state, _ = step(state, batch)
    snap = state.copy()
    ckpt.save_model(state, "run")
    live = [t.data_ptr() for t in state.state_dict().values()]
    slots = _slot_ptrs(state)
    for _ in range(3):
        state, _ = step(state, batch)
    assert state.step == 4
    state.restore(snap)
    assert [t.data_ptr() for t in state.state_dict().values()] == live
    assert _slot_ptrs(state) == slots
    want = _state_arrays(snap)
    got = _state_arrays(state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (state.step, state.opt_state.mini_step, state.opt_state.count) \
        == (1, 1, 0)

    for _ in range(2):
        state, _ = step(state, batch)
    restored = ckpt.load_existing_model(state, "run")
    assert restored is not None
    state.restore(restored)
    assert _slot_ptrs(state) == slots
    assert [t.data_ptr() for t in state.state_dict().values()] == live
    got = _state_arrays(state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert state.step == 1


@pytest.mark.parametrize("accumulate", [1, 3])
def test_replay_rows_follow_the_eager_updates(accumulate):
    """The scalar rows a group's replay loads (`step_graphs._advance_rows`,
    computed on the host before the replay) are the rows the eager
    updates read, step for step, and leave the host's counters where the
    eager updates leave them: over 7 steps (a phase that does not divide
    the group) with a learning-rate change after step 3."""
    import dataclasses
    from hydragnn_tpu_torch.train.step_graphs import _advance_rows
    rng = np.random.RandomState(4)
    params = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))]
    tx = topt.Optimizer("AdamW", learning_rate=0.01, accumulate=accumulate)
    eager = tx.init(params)
    replayed = dataclasses.replace(eager)
    want = []
    for i in range(7):
        if i == 3:
            topt.set_learning_rate(eager, 0.003)
        want.append(tx.step_scalars(eager))
        tx.update([torch.from_numpy(rng.randn(4, 3).astype(np.float32))],
                  eager, params)
    got = _advance_rows(tx, replayed, 3)
    topt.set_learning_rate(replayed, 0.003)
    got = torch.cat([got, _advance_rows(tx, replayed, 4)])
    np.testing.assert_array_equal(got.numpy(), np.float32(want))
    assert (replayed.count, replayed.mini_step, replayed.gradient_step) == \
        (eager.count, eager.mini_step, eager.gradient_step)
