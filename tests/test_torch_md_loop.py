"""MD in the loop on the port (hydragnn_tpu_torch/md) against the JAX
package, on the CPU:

* `md/integrator` against hydragnn_tpu/md/integrator.py on seeded
  arrays, bitwise;
* `run_md` on the port's CPU engine: the incremental, rebuild and offline
  modes give the same trajectory bit for bit;
* the port's `run_md` against the JAX package's (examples/md_loop) with
  the same weights (`load_jax_variables`), 64 atoms for 10 steps:
  energies within rtol 1e-5, positions within 1e-6 absolute (the
  position grid's step is 2^-21 = 4.8e-7, so one flipped grid point
  still holds);
* `submit_structure` against the JAX engine's: energies and forces
  within rtol 1e-5 / atol 1e-6, the served edges bitwise.
"""
import copy
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.md import integrator as jmdi
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.preprocess.transforms import \
    build_graph_sample as j_build_graph_sample
from hydragnn_tpu.serving.engine import InferenceEngine as JEngine
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.md import integrator as mdi
from hydragnn_tpu_torch.md.loop import (init_lattice, lj_md_config,
                                        maxwell_velocities, md_buckets,
                                        run_md)
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
from hydragnn_tpu_torch.serving.config import Structure
from hydragnn_tpu_torch.serving.engine import InferenceEngine
from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                              random_flax_variables)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from examples.md_loop import md_loop as jmd  # noqa: E402

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

MD_TOL = dict(rtol=1e-5)
POS_ATOL = 1e-6
EF_TOL = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ integrator --

def test_integrator_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    pos0 = rng.normal(0.0, 3.0, (200, 3))
    vel0 = rng.normal(0.0, 0.6, (200, 3))
    for dt in (0.005, 0.001, 0.0173):
        got, want = mdi.init_state(pos0, vel0, dt), \
            jmdi.init_state(pos0, vel0, dt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for fs, mass in ((1.0, 1.0), (0.37, 2.5), (123.4, 0.7)):
            assert mdi.force_scale_split(dt, fs, mass) == \
                jmdi.force_scale_split(dt, fs, mass)
    cell = rng.normal(0.0, 4.0, (3, 3))
    np.testing.assert_array_equal(mdi.quantize_cell(cell),
                                  jmdi.quantize_cell(cell))
    pos, vd = mdi.init_state(pos0, vel0, 0.005)
    s_hi, s_lo = mdi.force_scale_split(0.005, 0.8)
    ad2 = mdi.accel_term(rng.normal(0.0, 5.0, (200, 3)).astype(np.float32),
                         s_hi, s_lo)
    for _ in range(5):
        forces = rng.normal(0.0, 5.0, (200, 3))
        ad2_new = mdi.accel_term(forces, s_hi, s_lo)
        np.testing.assert_array_equal(
            ad2_new, jmdi.accel_term(forces, s_hi, s_lo))
        pos_new = mdi.drift(pos, vd, ad2)
        np.testing.assert_array_equal(pos_new, jmdi.drift(pos, vd, ad2))
        vd_new = mdi.kick(vd, ad2, ad2_new)
        np.testing.assert_array_equal(vd_new, jmdi.kick(vd, ad2, ad2_new))
        pos, vd, ad2 = pos_new, vd_new, ad2_new
    assert (mdi.POS_BITS, mdi.VEL_BITS, mdi.COORD_LIMIT,
            mdi.CUTOFF_LIMIT) == (jmdi.POS_BITS, jmdi.VEL_BITS,
                                  jmdi.COORD_LIMIT, jmdi.CUTOFF_LIMIT)
    for args in ((3000.0, 2.3), (10.0, 9.0), (float("nan"), 2.3)):
        with pytest.raises(ValueError, match="MD grid integrator"):
            mdi.validate_ranges(*args)
        with pytest.raises(ValueError, match="MD grid integrator"):
            jmdi.validate_ranges(*args)
    mdi.validate_ranges(100.0, 2.3)
    with pytest.raises(ValueError, match="non-finite"):
        mdi.force_scale_split(0.005, float("inf"))


# ------------------------------------------------------- the LJ system --

@pytest.fixture(scope="module")
def lj_md():
    """The LJ SchNet MD system of 4³ atoms under both packages, with the
    same Flax-shaped random weights."""
    pos0, cell = init_lattice(4, 1.2, 0.05, seed=1)
    n = len(pos0)
    vel0 = maxwell_velocities(n, 0.3, seed=2)
    nf = np.ones((n, 1), np.float32)
    cfg = lj_md_config()
    frame0 = build_graph_sample(nf, pos0, cfg, cell=cell, with_targets=False)
    completed = tcfg.update_config(copy.deepcopy(cfg), [frame0])
    mcfg = tcfg.build_model_config(completed)
    model = create_model(mcfg, device="cpu")
    variables = random_flax_variables(model, 3)
    model.load_state_dict(load_jax_variables(variables))

    jframe0 = j_build_graph_sample(nf, pos0, cfg, cell=cell,
                                   with_targets=False)
    jcompleted = jcfg.update_config(copy.deepcopy(cfg), [jframe0])
    jmcfg = jcfg.build_model_config(jcompleted)
    jmodel = j_create_model(jmcfg)
    jvars = jax.tree_util.tree_map(jax.numpy.asarray, variables)
    return dict(pos0=pos0, cell=cell, vel0=vel0, nf=nf, frame0=frame0,
                completed=completed, mcfg=mcfg, model=model,
                jframe0=jframe0, jcompleted=jcompleted, jmcfg=jmcfg,
                jmodel=jmodel, jvars=jvars, variables=variables)


def _engine(lj, **kw):
    n = len(lj["pos0"])
    return InferenceEngine(
        lj["model"], lj["mcfg"],
        buckets=md_buckets(n, lj["frame0"].num_edges),
        proto_sample=lj["frame0"], max_batch_size=1, max_wait_ms=0.0,
        structure_config=lj["completed"], md_skin=0.3, ef_forward=True,
        device="cpu", **kw)


def _jengine(lj):
    n = len(lj["pos0"])
    return JEngine(
        lj["jmodel"], lj["jvars"], lj["jmcfg"],
        buckets=jmd.md_buckets(n, lj["jframe0"].num_edges),
        proto_sample=lj["jframe0"], max_batch_size=1, max_wait_ms=0.0,
        structure_config=lj["jcompleted"], md_skin=0.3, ef_forward=True)


def test_run_md_modes_are_bitwise_equal(lj_md):
    """incremental (skin 0.05: rebuilds within the run), rebuild and
    offline: the same energies, positions and velocities, bit for bit;
    the bucket set stays frozen."""
    lj = lj_md
    with _engine(lj) as eng:
        assert eng.warmup() == 1
        runs = {mode: run_md(eng, lj["completed"], lj["pos0"], lj["vel0"],
                             lj["cell"], lj["nf"], steps=20, dt=0.005,
                             mode=mode, skin=0.05 if mode == "incremental"
                             else None, record_positions=True)
                for mode in ("incremental", "rebuild", "offline")}
        health = eng.health()
    inc = runs["incremental"]
    assert 0.0 < inc["rebuild_fraction"] < 1.0
    assert runs["rebuild"]["rebuild_fraction"] == 1.0
    for mode in ("rebuild", "offline"):
        r = runs[mode]
        assert r["energies"] == inc["energies"], mode
        np.testing.assert_array_equal(r["final_pos"], inc["final_pos"])
        np.testing.assert_array_equal(r["final_vel"], inc["final_vel"])
        for a, b in zip(r["positions"], inc["positions"]):
            np.testing.assert_array_equal(a, b)
    assert np.isfinite(inc["energies"]).all()
    assert not np.array_equal(inc["final_pos"], mdi.init_state(
        lj["pos0"], lj["vel0"], 0.005)[0])
    # two sessions of 21 submits each went through submit_structure
    assert health["structure_requests"] == health["nbr_updates"] == 42
    # the rebuild session rebuilt at all 21, the incremental one at its
    # first submit and at the steps run_md counted
    assert health["nbr_rebuilds"] == \
        21 + 1 + round(inc["rebuild_fraction"] * 20)
    with pytest.raises(ValueError, match="mode"):
        run_md(None, lj["completed"], lj["pos0"], lj["vel0"], lj["cell"],
               lj["nf"], steps=1, dt=0.005, mode="sideways")


def test_run_md_matches_jax(lj_md):
    lj = lj_md
    jeng = _jengine(lj)
    try:
        jeng.warmup()
        want = jmd.run_md(jeng, lj["jcompleted"], lj["pos0"], lj["vel0"],
                          lj["cell"], lj["nf"], steps=10, dt=0.005)
    finally:
        jeng.shutdown()
    with _engine(lj) as eng:
        eng.warmup()
        got = run_md(eng, lj["completed"], lj["pos0"], lj["vel0"],
                     lj["cell"], lj["nf"], steps=10, dt=0.005)
    np.testing.assert_allclose(got["energy_first"], want["energy_first"],
                               **MD_TOL)
    np.testing.assert_allclose(got["energy_last"], want["energy_last"],
                               **MD_TOL)
    np.testing.assert_allclose(got["final_pos"], want["final_pos"],
                               rtol=0, atol=POS_ATOL)
    assert got["rebuild_fraction"] == want["rebuild_fraction"]


def test_submit_structure_matches_jax_engine(lj_md):
    """A session's steps, a session-less submit and a `Structure`
    request: results within EF_TOL of the JAX engine's, `rebuilt` equal,
    the served samples' edges bitwise."""
    lj = lj_md
    rng = np.random.RandomState(8)
    frames = [lj["pos0"]]
    for _ in range(5):
        frames.append(frames[-1] + rng.randn(*lj["pos0"].shape) * 0.005)
    cell = mdi.quantize_cell(lj["cell"])

    def drive(eng):
        served = []
        real_submit = eng.submit

        def spy(sample, deadline_ms=None):
            served.append(sample)
            return real_submit(sample, deadline_ms=deadline_ms)

        eng.submit = spy
        sess = eng.structure_session()
        futs = [eng.submit_structure(p, lj["nf"], cell=cell, session=sess)
                for p in frames]
        futs.append(eng.submit_structure(frames[-1], lj["nf"], cell=cell))
        results = [f.result(timeout=300) for f in futs]
        return results, [f.rebuilt for f in futs], served, eng.health()

    jeng = _jengine(lj)
    try:
        want, want_rebuilt, want_served, want_health = drive(jeng)
    finally:
        jeng.shutdown()
    with _engine(lj) as eng:
        got, got_rebuilt, got_served, got_health = drive(eng)
        struct = Structure(positions=frames[2], node_features=lj["nf"],
                           cell=cell)
        again = eng.submit_structure(struct).result(timeout=300)
    assert got_rebuilt == want_rebuilt == [True] + [False] * 5 + [True]
    for g, w in zip(got_served, want_served):
        for name in ("senders", "receivers", "edge_shifts", "pos", "x"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name), err_msg=name)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), **EF_TOL)
        np.testing.assert_allclose(g[1], np.asarray(w[1]), **EF_TOL)
    np.testing.assert_array_equal(again[1], got[2][1])
    for key in ("structure_requests", "nbr_updates", "nbr_rebuilds",
                "nbr_rebuild_fraction", "requests_done"):
        assert got_health[key] == want_health[key], key


def test_structure_serving_requires_its_config(lj_md):
    lj = lj_md
    eng = InferenceEngine(
        lj["model"], lj["mcfg"], buckets=md_buckets(64, 4000),
        proto_sample=lj["frame0"], ef_forward=True, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="structure_config"):
            eng.structure_session()
        with pytest.raises(RuntimeError, match="structure_config"):
            eng.submit_structure(lj["pos0"], lj["nf"])
    finally:
        eng.shutdown()
    with _engine(lj) as eng:
        with pytest.raises(ValueError, match="node_features"):
            eng.submit_structure(lj["pos0"])
        # the farm is ported (tests/test_torch_md_farm.py); its scorer
        # (md/active.py) is not
        with pytest.raises(NotImplementedError, match="A10"):
            eng.trajectory_farm(dt=0.005, scorer=object())
    eng = InferenceEngine(
        lj["model"], lj["mcfg"], buckets=md_buckets(64, 4000),
        proto_sample=lj["frame0"], ef_forward=True, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="structure_config"):
            eng.trajectory_farm(dt=0.005)
    finally:
        eng.shutdown()
