"""The port's trajectory farm (hydragnn_tpu_torch/md/farm.py) on the CPU,
against the JAX package and against the port's own single-session loop:

* the torch forms of the grid integrator (`drift_torch`, `kick_torch`,
  `accel_term_torch`, `displacement2_torch`) against the numpy forms,
  bitwise, float64;
* `pack_candidates` against the JAX package's, bitwise, and both
  capacity errors;
* `make_batched_refilter` against the JAX package's (run under
  `jax.enable_x64(True)`) and against per-trajectory `NeighborList`
  emissions, bitwise: open and PBC, capped and uncapped, heterogeneous
  rebuild cadences, the cap-tie lattice;
* the farm end to end at the JAX package's fixture sizes (27 atoms,
  hidden 4, radius 1.2), T = 3, 24 steps, K = 5, PBC with cap 6 and open
  uncapped: each trajectory equals the port's `run_md` incremental
  bitwise in positions and velocities, energies within rtol 1e-9, with
  rebuild swaps; T = 1 equals T = 3's trajectory 0 and K = 1 equals
  K = 5, bitwise;
* one trajectory against the JAX package's `examples/md_loop.run_md`
  with the same weights: positions within 1e-6 absolute, energies within
  rtol 1e-5 (the bounds of tests/test_torch_md_loop.py);
* `swap_variables`, the farm's isolation from an engine swap, the
  registry's farm counters and event, and the validation errors.

The JAX package's own farm runs under `jax.experimental.enable_x64`,
which the installed jax no longer has; its pure pieces are called here
under `jax.enable_x64(True)` instead, and nothing in the JAX package
changes for that.
"""
import copy
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs.neighborlist import NeighborList as JNeighborList
from hydragnn_tpu.md import farm as jfarm
from hydragnn_tpu.md import integrator as jmdi
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.preprocess.transforms import \
    build_graph_sample as j_build_graph_sample
from hydragnn_tpu.serving.engine import InferenceEngine as JEngine
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs.neighborlist import NeighborList
from hydragnn_tpu_torch.md import integrator as mdi
from hydragnn_tpu_torch.md.farm import (TrajectoryFarm,
                                        make_batched_refilter,
                                        pack_candidates)
from hydragnn_tpu_torch.md.loop import (init_lattice, lj_md_config,
                                        maxwell_velocities, md_buckets,
                                        run_md)
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
from hydragnn_tpu_torch.serving.engine import InferenceEngine
from hydragnn_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                   set_registry)
from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                              random_flax_variables)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from examples.md_loop import md_loop as jmd  # noqa: E402

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

E_RTOL = 1e-9       # farm vs session energies (the JAX package's bound)
JAX_E_RTOL = 1e-5   # port vs JAX, tests/test_torch_md_loop.py's bounds
JAX_POS_ATOL = 1e-6


# ------------------------------------------------------------ integrator --

def test_integrator_torch_forms_match_numpy_bitwise():
    """drift / kick / accel_term / the displacement d²: the torch forms
    on float64 CPU tensors equal the numpy forms bit for bit, alone and
    through a 4-step loop."""
    rng = np.random.RandomState(0)
    T, n, dt = 3, 40, 0.004
    pos, vd = mdi.init_state(rng.randn(T, n, 3) * 2.0, rng.randn(T, n, 3),
                             dt)
    s_hi, s_lo = mdi.force_scale_split(dt, force_scale=1.7, mass=0.9)
    forces = rng.randn(T, n, 3).astype(np.float32) * 50.0
    ad2 = mdi.accel_term(forces, s_hi, s_lo)
    ad2_new = mdi.accel_term(-2.5 * forces, s_hi, s_lo)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        mdi.drift_torch(t(pos), t(vd), t(ad2)).numpy(),
        mdi.drift(pos, vd, ad2))
    np.testing.assert_array_equal(
        mdi.kick_torch(t(vd), t(ad2), t(ad2_new)).numpy(),
        mdi.kick(vd, ad2, ad2_new))
    np.testing.assert_array_equal(
        mdi.accel_term_torch(t(forces), s_hi, s_lo).numpy(), ad2)
    # float64 forces round through float32 first, as the numpy form
    f64 = rng.randn(T, n, 3) * 7.0
    np.testing.assert_array_equal(
        mdi.accel_term_torch(t(f64), s_hi, s_lo).numpy(),
        mdi.accel_term(f64, s_hi, s_lo))
    ref = mdi.quantize_pos(pos + rng.randn(T, n, 3) * 0.1)
    np.testing.assert_array_equal(
        mdi.displacement2_torch(t(pos), t(ref)).numpy(),
        np.sum((pos - ref) ** 2, axis=-1))
    fs = (rng.randn(4, T, n, 3) * 30.0).astype(np.float32)
    hp, hv, ha = pos, vd, ad2
    tp, tv, ta = t(pos), t(vd), t(ad2)
    for k in range(4):
        hp = mdi.drift(hp, hv, ha)
        ha2 = mdi.accel_term(fs[k], s_hi, s_lo)
        hv = mdi.kick(hv, ha, ha2)
        ha = ha2
        tp = mdi.drift_torch(tp, tv, ta)
        ta2 = mdi.accel_term_torch(t(fs[k]), s_hi, s_lo)
        tv = mdi.kick_torch(tv, ta, ta2)
        ta = ta2
        for a, b in ((tp, hp), (tv, hv), (ta, ha)):
            np.testing.assert_array_equal(a.numpy(), b)
    # the JAX package's numpy forms give the same values
    np.testing.assert_array_equal(hp, _jax_loop(pos, vd, ad2, fs, s_hi,
                                                s_lo))


def _jax_loop(pos, vd, ad2, fs, s_hi, s_lo):
    for f in fs:
        pos = jmdi.drift(pos, vd, ad2)
        a2 = jmdi.accel_term(f, s_hi, s_lo)
        vd = jmdi.kick(vd, ad2, a2)
        ad2 = a2
    return pos


# ------------------------------------------------------- candidate layout --

def _walk_on_grid(rng, pos, scale):
    return mdi.quantize_pos(pos + rng.randn(*pos.shape) * scale)


def _lists(r, skin, cap, pbc):
    kw = dict(max_neighbours=cap,
              pbc=(True, True, True) if pbc else None)
    return NeighborList(r, skin, **kw), JNeighborList(r, skin, **kw)


@pytest.mark.parametrize("pbc,cap", [(False, None), (False, 5),
                                     (True, None), (True, 6)])
def test_pack_candidates_matches_jax_bitwise(pbc, cap):
    rng = np.random.RandomState(11 if pbc else 12)
    n, r, skin = 40, 1.1, 0.3
    cell = mdi.quantize_cell(np.eye(3) * 3.5) if pbc else None
    pos = mdi.quantize_pos(rng.rand(n, 3) * 3.0)
    nl, jnl = _lists(r, skin, cap, pbc)
    for step in range(4):
        if step:
            pos = _walk_on_grid(rng, pos, 0.08)
        nl.update(pos, cell=cell)
        jnl.update(pos, cell=cell)
        got = pack_candidates(nl, 4096, 64, n, pbc=pbc,
                              capped=cap is not None)
        want = jfarm.pack_candidates(jnl, 4096, 64, n, pbc=pbc,
                                     capped=cap is not None)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"step {step} {key}")


def test_pack_candidates_capacity_errors_match_jax():
    rng = np.random.RandomState(5)
    n = 40
    pos = mdi.quantize_pos(rng.rand(n, 3) * 3.0)
    nl, jnl = _lists(1.1, 0.3, 4, False)
    nl.update(pos)
    jnl.update(pos)
    c = len(nl.export_candidates()[0])
    for fn, lst in ((pack_candidates, nl), (jfarm.pack_candidates, jnl)):
        with pytest.raises(ValueError, match="candidate count") as e1:
            fn(lst, c - 1, 64, n, pbc=False, capped=True)
        assert "HYDRAGNN_MD_FARM_CAND_HEADROOM" in str(e1.value)
        with pytest.raises(ValueError, match="max degree") as e2:
            fn(lst, c, 2, n, pbc=False, capped=True)
        assert "degree capacity 2" in str(e2.value)
        # uncapped: the degree capacity is not checked
        fn(lst, c, 2, n, pbc=False, capped=False)
    msgs = []
    for fn, lst in ((pack_candidates, nl), (jfarm.pack_candidates, jnl)):
        try:
            fn(lst, c - 1, 64, n, pbc=False, capped=True)
        except ValueError as exc:
            msgs.append(str(exc))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------ batched re-filter --

def _jax_keep(n, r, cap, w_cap, pos, caches):
    import jax.numpy as jnp
    with jax.enable_x64(True):
        fn = jax.jit(jfarm.make_batched_refilter(n, r, cap, w_cap))
        return np.asarray(fn(jnp.asarray(pos),
                             *[jnp.asarray(caches[k]) for k in
                               ("send", "recv", "valid", "seg_start",
                                "off")]))


def _port_keep(n, r, cap, w_cap, pos, caches):
    fn = make_batched_refilter(n, r, cap, w_cap)
    args = [torch.from_numpy(caches[k]).to(torch.int64)
            if k in ("send", "recv", "seg_start")
            else torch.from_numpy(caches[k])
            for k in ("send", "recv", "valid", "seg_start", "off")]
    return fn(torch.from_numpy(pos), *args).numpy()


@pytest.mark.parametrize("pbc,cap", [(False, None), (False, 5),
                                     (True, None), (True, 6)])
def test_batched_refilter_matches_jax_and_neighborlist(pbc, cap):
    """At every step the port's keep mask equals the JAX package's and
    the edges it induces equal each trajectory's `NeighborList` update,
    bitwise; trajectories walk at their own temperatures, so rebuilds
    interleave (the case of tests/test_md_farm.py)."""
    rng = np.random.RandomState(3 if pbc else 4)
    T, n, r, skin = 3, 40, 1.1, 0.3
    cell = mdi.quantize_cell(np.eye(3) * 3.5) if pbc else None
    pos = np.stack([mdi.quantize_pos(rng.rand(n, 3) * 3.0)
                    for _ in range(T)])
    nls = [_lists(r, skin, cap, pbc)[0] for _ in range(T)]
    c_cap, w_cap = 4096, 64
    scales = [0.004, 0.012, 0.03]
    packed = [None] * T
    for step in range(12):
        edges_ref = []
        for t in range(T):
            if step:
                pos[t] = _walk_on_grid(rng, pos[t], scales[t])
            send, recv, shifts, rebuilt = nls[t].update(pos[t], cell=cell)
            edges_ref.append((send, recv, shifts))
            if rebuilt or packed[t] is None:
                packed[t] = pack_candidates(nls[t], c_cap, w_cap, n,
                                            pbc=pbc, capped=cap is not None)
        caches = {k: np.stack([p[k] for p in packed]) for k in packed[0]}
        keep = _port_keep(n, r, cap, w_cap, pos, caches)
        np.testing.assert_array_equal(
            keep, _jax_keep(n, r, cap, w_cap, pos, caches),
            err_msg=f"step {step}")
        for t in range(T):
            send, recv, shifts = edges_ref[t]
            np.testing.assert_array_equal(
                packed[t]["send"][keep[t]].astype(np.int32), send,
                err_msg=f"step {step} traj {t}")
            np.testing.assert_array_equal(
                packed[t]["recv"][keep[t]].astype(np.int32), recv)
            if pbc:
                np.testing.assert_array_equal(packed[t]["shift"][keep[t]],
                                              shifts)
    assert any(nl.rebuilds > 1 for nl in nls), "no rebuild exercised"
    assert any(nl.rebuilds < nl.updates for nl in nls), \
        "no candidate reuse exercised"


def test_batched_refilter_cap_tie_lattice():
    """A perfect lattice: every shell ties in d², so the cap's (d², input
    order) tie-break decides; the port keeps the host's and JAX's
    winners."""
    nd, r, cap = 4, 1.05, 3
    grid = np.stack(np.meshgrid(*[np.arange(nd)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    pos = mdi.quantize_pos(grid.astype(np.float64))
    n = pos.shape[0]
    nl = NeighborList(r, 0.25, max_neighbours=cap)
    send, recv, _, _ = nl.update(pos)
    packed = pack_candidates(nl, 1024, 32, n, pbc=False, capped=True)
    caches = {k: v[None] for k, v in packed.items()}
    keep = _port_keep(n, r, cap, 32, pos[None], caches)[0]
    np.testing.assert_array_equal(
        keep, _jax_keep(n, r, cap, 32, pos[None], caches)[0])
    np.testing.assert_array_equal(packed["send"][keep].astype(np.int32),
                                  send)
    np.testing.assert_array_equal(packed["recv"][keep].astype(np.int32),
                                  recv)
    assert len(send) < 6 * n


# ------------------------------------------------------------ end to end --

def _system(pbc, cap, hidden=4, apd=3, radius=1.2, lattice=1.0):
    """The JAX package's farm fixture (tests/test_md_farm.py): the LJ MD
    config at hidden 4, one conv, 8 Gaussians, radius 1.2, 27 atoms."""
    cfg = lj_md_config(radius=radius, max_neighbours=cap,
                       hidden_dim=hidden, num_conv_layers=1,
                       num_gaussians=8)
    cfg["NeuralNetwork"]["Architecture"][
        "periodic_boundary_conditions"] = pbc
    pos0, cell = init_lattice(apd, lattice, 0.05, seed=1)
    if not pbc:
        cell = None
    n = len(pos0)
    nf = np.ones((n, 1), np.float32)
    frame0 = build_graph_sample(nf, pos0, cfg, cell=cell, with_targets=False)
    done = tcfg.update_config(copy.deepcopy(cfg), [frame0])
    mcfg = tcfg.build_model_config(done)
    # seed 8: forces of ~0.1-0.8 at this width (seeds 1 and 3 give a
    # constant energy, zero forces)
    variables = random_flax_variables(create_model(mcfg, device="cpu"), 8)
    return dict(cfg=cfg, done=done, mcfg=mcfg, frame0=frame0, n=n, nf=nf,
                cell=cell, variables=variables, pos0=pos0)


def _engine(sysd, variables=None, **kw):
    model = create_model(sysd["mcfg"], device="cpu")
    model.load_state_dict(load_jax_variables(
        variables if variables is not None else sysd["variables"]))
    return InferenceEngine(
        model, sysd["mcfg"],
        buckets=md_buckets(sysd["n"], max(sysd["frame0"].num_edges, 1)),
        proto_sample=sysd["frame0"], max_batch_size=1, max_wait_ms=0.0,
        structure_config=sysd["done"], md_skin=0.3, ef_forward=True,
        device="cpu", **kw)


def _initial(n, T):
    pos = np.stack([init_lattice(3, 1.0, 0.05, seed=100 + t)[0]
                    for t in range(T)])
    vel = np.stack([maxwell_velocities(n, 0.3 * (t + 1), seed=200 + t)
                    for t in range(T)])
    return pos, vel


@pytest.fixture(scope="module", params=[(True, 6), (False, None)],
                ids=["pbc_cap6", "open_uncapped"])
def farm_case(request):
    """A farm run (T = 3, 24 steps, K = 5) and the session runs of its
    three trajectories, on one CPU engine."""
    pbc, cap = request.param
    sysd = _system(pbc, cap)
    T, S, dt = 3, 24, 0.004
    pos, vel = _initial(sysd["n"], T)
    with _engine(sysd) as eng:
        eng.warmup()
        farm = eng.trajectory_farm(dt=dt, skin=0.3, steps_per_dispatch=5)
        res = farm.run(pos, vel, S, node_features=sysd["nf"],
                       cell=sysd["cell"])
        seqs = [run_md(eng, sysd["done"], pos[t], vel[t], sysd["cell"],
                       sysd["nf"], steps=S, dt=dt, mode="incremental",
                       skin=0.3) for t in range(T)]
        res1 = eng.trajectory_farm(dt=dt, skin=0.3, steps_per_dispatch=5
                                   ).run(pos[:1], vel[:1], S,
                                         node_features=sysd["nf"],
                                         cell=sysd["cell"])
        res_k1 = eng.trajectory_farm(dt=dt, skin=0.3, steps_per_dispatch=1
                                     ).run(pos, vel, S,
                                           node_features=sysd["nf"],
                                           cell=sysd["cell"])
    return dict(sysd=sysd, pos=pos, vel=vel, res=res, seqs=seqs, res1=res1,
                res_k1=res_k1, S=S, dt=dt)


def test_farm_equals_single_session_run_md_bitwise(farm_case):
    res, seqs = farm_case["res"], farm_case["seqs"]
    assert res["rebuild_swaps"] > 0, "no mid-run swap exercised"
    # the forces move the trajectories: the energies change
    assert all(seq["energy_first"] != seq["energy_last"] for seq in seqs)
    assert res["trajectories"] == 3 and res["steps"] == farm_case["S"]
    for t, seq in enumerate(seqs):
        np.testing.assert_array_equal(res["final_pos"][t], seq["final_pos"])
        np.testing.assert_array_equal(res["final_vel"][t], seq["final_vel"])
        for key in ("energy_first", "energy_last"):
            np.testing.assert_allclose(float(res[key][t]), seq[key],
                                       rtol=E_RTOL, atol=0.0)
    # every trajectory moved, and the rebuilds the farm swapped in are
    # the sessions' own
    assert res["per_traj_rebuilds"] == [
        round(seq["rebuild_fraction"] * farm_case["S"]) for seq in seqs]
    assert sum(res["per_traj_rebuilds"]) == res["rebuild_swaps"]


def test_farm_width_and_dispatch_independent(farm_case):
    """T = 1 equals trajectory 0 of T = 3, and K = 1 equals K = 5, bit
    for bit (positions, velocities, energies)."""
    res, res1, res_k1 = (farm_case["res"], farm_case["res1"],
                         farm_case["res_k1"])
    for key in ("final_pos", "final_vel", "energy_first", "energy_last"):
        np.testing.assert_array_equal(res1[key][0], res[key][0])
        np.testing.assert_array_equal(res_k1[key], res[key])
    assert res_k1["dispatches"] > res["dispatches"]
    assert res["steps_per_dispatch"] == 5 and res_k1["steps_per_dispatch"] == 1


def test_farm_trajectory_matches_jax_run_md():
    """A T = 1 farm on the port against the JAX package's run_md (its
    session loop; its farm needs the jax x64 switch it can no longer
    import) with the same Flax weights: positions within 1e-6, energies
    within rtol 1e-5."""
    sysd = _system(True, 6)
    S, dt = 16, 0.004
    pos, vel = _initial(sysd["n"], 1)
    with _engine(sysd) as eng:
        res = eng.trajectory_farm(dt=dt, skin=0.3).run(
            pos, vel, S, node_features=sysd["nf"], cell=sysd["cell"])
    jframe0 = j_build_graph_sample(sysd["nf"], sysd["pos0"], sysd["cfg"],
                                   cell=sysd["cell"], with_targets=False)
    jdone = jcfg.update_config(copy.deepcopy(sysd["cfg"]), [jframe0])
    jmcfg = jcfg.build_model_config(jdone)
    jvars = jax.tree_util.tree_map(jax.numpy.asarray, sysd["variables"])
    jeng = JEngine(j_create_model(jmcfg), jvars, jmcfg,
                   buckets=jmd.md_buckets(sysd["n"], jframe0.num_edges),
                   proto_sample=jframe0, max_batch_size=1, max_wait_ms=0.0,
                   structure_config=jdone, md_skin=0.3, ef_forward=True)
    try:
        jeng.warmup()
        want = jmd.run_md(jeng, jdone, pos[0], vel[0], sysd["cell"],
                          sysd["nf"], steps=S, dt=dt)
    finally:
        jeng.shutdown()
    np.testing.assert_allclose(res["final_pos"][0], want["final_pos"],
                               rtol=0, atol=JAX_POS_ATOL)
    for key in ("energy_first", "energy_last"):
        np.testing.assert_allclose(float(res[key][0]), want[key],
                                   rtol=JAX_E_RTOL)


# ------------------------------------------------------------- hot swap --

def test_farm_swap_variables_and_engine_swap_isolation():
    """The farm serves the weights it was built with after the engine
    swaps; its own `swap_variables` serves the new weights as a fresh
    engine's farm does, bitwise, and refuses a mismatched tree before
    any change."""
    sysd = _system(True, 6)
    other = random_flax_variables(create_model(sysd["mcfg"], device="cpu"),
                                  17)
    pos, vel = _initial(sysd["n"], 2)
    kw = dict(node_features=sysd["nf"], cell=sysd["cell"])
    with _engine(sysd) as eng:
        farm = eng.trajectory_farm(dt=0.004)
        before = farm.run(pos, vel, 8, **kw)
        assert eng.swap_variables(other, "v1") == "v0"
        after_engine_swap = farm.run(pos, vel, 8, **kw)
        swapped_engine_farm = eng.trajectory_farm(dt=0.004).run(pos, vel, 8,
                                                                **kw)
        bad = copy.deepcopy(other)
        leaf = bad["params"]["conv_0"]["lin1"]["kernel"]
        bad["params"]["conv_0"]["lin1"]["kernel"] = np.zeros(
            (leaf.shape[0] + 1, leaf.shape[1]), leaf.dtype)
        with pytest.raises(ValueError, match="swap rejected"):
            farm.swap_variables(bad, "bad")
        assert farm.version == "farm-init"
        assert farm.run(pos, vel, 8, **kw)["final_pos"].tobytes() == \
            before["final_pos"].tobytes()
        assert farm.swap_variables(other, "v1") == "farm-init"
        assert farm.version == "v1"
        after_farm_swap = farm.run(pos, vel, 8, **kw)
    for key in ("final_pos", "final_vel", "energy_last"):
        np.testing.assert_array_equal(after_engine_swap[key], before[key])
        np.testing.assert_array_equal(after_farm_swap[key],
                                      swapped_engine_farm[key])
    assert not np.array_equal(after_farm_swap["energy_last"],
                              before["energy_last"])
    with _engine(sysd, variables=other) as eng:
        fresh = eng.trajectory_farm(dt=0.004).run(pos, vel, 8, **kw)
    np.testing.assert_array_equal(fresh["final_pos"],
                                  after_farm_swap["final_pos"])


# ----------------------------------------------- telemetry and validation --

def test_farm_registry_counters_and_validation():
    """The farm's counters, gauge and `farm_run` event land in the
    registry (tests/test_md_farm.py's telemetry case), and out-of-
    contract inputs raise the JAX package's errors."""
    sysd = _system(True, 6)
    with _engine(sysd) as eng:
        reg = MetricsRegistry()
        prev = set_registry(reg)
        try:
            farm = eng.trajectory_farm(dt=0.004, skin=0.3)
            pos_t = init_lattice(3, 1.0, 0.05, seed=7)[0][None]
            vel_t = maxwell_velocities(sysd["n"], 0.3, seed=8)[None]
            res = farm.run(pos_t, vel_t, 6, node_features=sysd["nf"],
                           cell=sysd["cell"])
        finally:
            set_registry(prev)
        snap = reg.snapshot()
        assert snap["md.farm_steps_total"]["values"][()] == 6.0
        assert snap["md.farm_dispatches_total"]["values"][()] == \
            res["dispatches"]
        assert snap["md.farm_rebuild_swaps_total"]["values"][()] == \
            res["rebuild_swaps"]
        assert "md.farm_steps_per_dispatch" in snap
        evts = [e for e in reg.events if e["name"] == "farm_run"]
        assert len(evts) == 1
        assert evts[0]["data"]["steps"] == 6
        assert evts[0]["data"]["trajectories"] == 1
        assert "wall_s" in evts[0]["timing"]

        with pytest.raises(ValueError, match=r"\[T, n_atoms, 3\]"):
            farm.run(pos_t[0], vel_t[0], 4, node_features=sysd["nf"],
                     cell=sysd["cell"])
        with pytest.raises(ValueError, match="steps must be"):
            farm.run(pos_t, vel_t, 0, node_features=sysd["nf"],
                     cell=sysd["cell"])
        with pytest.raises(ValueError, match="cell"):
            farm.run(pos_t, vel_t, 4, node_features=sysd["nf"])
        with pytest.raises(ValueError, match="node capacity"):
            big = np.zeros((1, eng.buckets[0].n_node, 3))
            farm.run(big, big, 4, node_features=sysd["nf"],
                     cell=sysd["cell"])

        for kw, match in (({"skin": -1.0}, "skin"), ({"dt": 0.0}, "dt"),
                          ({"steps_per_dispatch": 0}, "steps_per_dispatch"),
                          ({"cand_headroom": -0.1}, "cand_headroom")):
            args = dict(dt=0.004)
            args.update(kw)
            with pytest.raises(ValueError, match=match):
                eng.trajectory_farm(**args)
        with pytest.raises(NotImplementedError, match="A10"):
            eng.trajectory_farm(dt=0.004, scorer=object())

        eng.ef_forward = False
        with pytest.raises(ValueError, match="ef_forward"):
            eng.trajectory_farm(dt=0.004)
        eng.ef_forward = True
        buckets = eng.buckets
        eng.buckets = buckets + buckets
        try:
            with pytest.raises(ValueError, match="single-bucket"):
                eng.trajectory_farm(dt=0.004)
        finally:
            eng.buckets = buckets
        # the config block reaches the farm (env unset here)
        eng._structure_cfg.setdefault("Serving", {})["md_farm"] = {
            "steps_per_dispatch": 3, "cand_headroom": 0.25}
        farm3 = eng.trajectory_farm(dt=0.004)
        assert (farm3.steps_per_dispatch, farm3.cand_headroom) == (3, 0.25)
        del eng._structure_cfg["Serving"]["md_farm"]

    cfg = copy.deepcopy(sysd["done"])
    cfg["Dataset"]["rotational_invariance"] = True
    with pytest.raises(ValueError, match="rotational_invariance"):
        TrajectoryFarm(create_model(sysd["mcfg"], device="cpu"),
                       sysd["variables"], sysd["mcfg"], cfg,
                       bucket=md_buckets(27, 400)[0], dt=0.004,
                       device="cpu")
    cfg = copy.deepcopy(sysd["done"])
    cfg["NeuralNetwork"]["Architecture"]["edge_features"] = ["length"]
    with pytest.raises(ValueError, match="edge_features"):
        TrajectoryFarm(create_model(sysd["mcfg"], device="cpu"),
                       sysd["variables"], sysd["mcfg"], cfg,
                       bucket=md_buckets(27, 400)[0], dt=0.004,
                       device="cpu")
    with pytest.raises(RuntimeError, match="structure_config"):
        plain = InferenceEngine(
            create_model(sysd["mcfg"], device="cpu"), sysd["mcfg"],
            buckets=md_buckets(27, 400), proto_sample=sysd["frame0"],
            ef_forward=True, device="cpu")
        try:
            plain.trajectory_farm(dt=0.004)
        finally:
            plain.shutdown()


def test_dense_routes_and_the_per_trajectory_route(monkeypatch):
    """`dense_routes` probes every linear layer of the T-fold forward (on
    the CPU each one's [T r, in] product is bitwise T products of r rows:
    one product); forced to one trajectory a product, the farm still
    equals run_md bitwise (the route the card takes for the layers whose
    bits depend on the row count)."""
    from hydragnn_tpu_torch.md import farm as farm_mod
    sysd = _system(True, 6)
    T, S, dt = 3, 12, 0.004
    pos, vel = _initial(sysd["n"], T)
    kw = dict(node_features=sysd["nf"], cell=sysd["cell"])
    probed = []
    real = farm_mod.dense_routes

    def per_trajectory(*args, **kwargs):
        routes = real(*args, **kwargs)
        probed.append(dict(routes))
        return {name: 1 for name in routes}

    monkeypatch.setattr(farm_mod, "dense_routes", per_trajectory)
    with _engine(sysd) as eng:
        farm = eng.trajectory_farm(dt=dt, skin=0.3, steps_per_dispatch=4)
        res = farm.run(pos, vel, S, **kw)
        seqs = [run_md(eng, sysd["done"], pos[t], vel[t], sysd["cell"],
                       sysd["nf"], steps=S, dt=dt, mode="incremental",
                       skin=0.3) for t in range(T)]
    (routes,) = probed
    names = {n for n, m in farm.model.named_modules()
             if isinstance(m, torch.nn.Linear)}
    assert set(routes) == names and set(routes.values()) == {T}
    assert farm.dense_routes == {name: 1 for name in names}
    for t, seq in enumerate(seqs):
        np.testing.assert_array_equal(res["final_pos"][t], seq["final_pos"])
        np.testing.assert_array_equal(res["final_vel"][t], seq["final_vel"])
    # the instance forwards are taken off after the body
    assert not any("forward" in vars(m) for m in farm.model.modules())
