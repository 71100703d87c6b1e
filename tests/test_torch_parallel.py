"""The port's data-parallel layer (hydragnn_tpu_torch/parallel/) against
the JAX package's (hydragnn_tpu/parallel/) on the CPU.

Pure pieces are held bitwise against JAX's, which take explicit nproc /
rank arguments (or read jax.process_count, patched here): slice_by_process
in both underflow modes, packing_process_coords,
validate_multiprocess_spmd, resolve_num_shards with its warnings, the
packed loader's per-rank bins and plan fingerprint, loader_budgets with a
max-reduce. The collectives run in gloo ranks (tests/
torch_parallel_worker.py: subprocesses, a file rendezvous under tmp_path,
one torch thread, a join bound). The train step of W = 2 port ranks is
held against JAX's make_spmd_train_step on a 2-device CPU mesh fed the
same two shards: parameters, BatchNorm running statistics and metrics
over 3 SGD steps within rtol 1e-5 / atol 1e-6 (SGD: Adam would turn the
packages' float32 rounding noise in a ~0 gradient into a full step),
`nonfinite_steps` exactly, a NaN on one rank only included; the eval
step against make_spmd_eval_step on shards of 3 and 1 real graphs.

JAX's step sums the shards' gradients where its code means their mean
(ROADMAP C9: under jax 0.9's shard_map the gradient of a replicated
parameter arrives psum-ed, and the pmean that follows leaves the sum),
so the JAX reference runs SGD at the learning rate over W: for SGD's
linear update, and W = 2 a power of two, that is the mean's update.

LJ SchNet's energy-force parameters are held within rtol 1e-4 and atol
1e-6 plus 1e-4 of each leaf's largest entry: the single-device EF
gradients of the two packages differ by ~5e-5 of a tensor's largest
entry (tests/test_torch_train.py), and three SGD steps carry that into
the parameters (measured: 1.5e-6 on a bias of 0.055 at rtol 1e-5).
"""
import copy
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.datasets.loader import GraphDataLoader as JLoader
from hydragnn_tpu.datasets.loader import _stack_batches
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.parallel import mesh as jmesh
from hydragnn_tpu.parallel import multiprocess as jmp
from hydragnn_tpu.parallel.spmd import (make_spmd_eval_step,
                                        make_spmd_train_step)
from hydragnn_tpu.preprocess.load_data import \
    loader_budgets as j_loader_budgets
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train.train_step import TrainState as JState
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                 synthetic_molecules)
from hydragnn_tpu_torch.kernels import _build
from hydragnn_tpu_torch.parallel import mesh as tmesh
from hydragnn_tpu_torch.parallel import multiprocess as tmp
from hydragnn_tpu_torch.preprocess.load_data import loader_budgets
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import (_jax_view, jax_batch, numpy_tree,
                                    to_jax_samples, to_port_samples)
from tests.torch_parallel_worker import spawn_ranks
from tests.utils import make_config

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
EF_PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SGD = {"type": "SGD", "learning_rate": 0.01}
LJ = Path(__file__).resolve().parents[1] / "examples" / "LennardJones" \
    / "LJ.json"


# ---------------------------------------------------------- pure pieces

@pytest.mark.parametrize("n,nproc,underflow", [
    (10, 2, "raise"), (11, 3, "raise"), (7, 4, "raise"), (2, 3, "raise"),
    (2, 3, "replicate"), (0, 2, "raise"), (9, 3, "replicate")])
def test_slice_by_process_matches_jax(n, nproc, underflow):
    data = list(range(n))
    for rank in range(nproc):
        try:
            want = jmp.slice_by_process(data, nproc=nproc, rank=rank,
                                        what="split", underflow=underflow)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                tmp.slice_by_process(data, nproc=nproc, rank=rank,
                                     what="split", underflow=underflow)
            assert str(got.value) == str(exc)
            continue
        assert tmp.slice_by_process(data, nproc=nproc, rank=rank,
                                    what="split",
                                    underflow=underflow) == want


def test_packing_process_coords_matches_jax():
    """One process: JAX's (process_index, process_count) = (0, 1); the
    port's explicit coordinates pass through; local data is refused with
    JAX's message."""
    assert tmp.packing_process_coords("replicated") == \
        jmp.packing_process_coords("replicated") == (0, 1)
    assert tmp.packing_process_coords("replicated", nproc=3, rank=2) == \
        (2, 3)
    with pytest.raises(ValueError) as want:
        jmp.packing_process_coords("local")
    with pytest.raises(ValueError) as got:
        tmp.packing_process_coords("local")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("num_shards,batch,nproc", [
    (2, 8, 2), (4, 8, 2), (3, 9, 3), (2, 7, 2), (3, 8, 2), (1, 4, 1)])
def test_validate_multiprocess_spmd_matches_jax(monkeypatch, num_shards,
                                                batch, nproc):
    """JAX reads the process count and local devices; one device a rank
    here, so JAX is patched to nproc processes of one device each."""
    monkeypatch.setattr(jax, "process_count", lambda: nproc)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    try:
        want = jmp.validate_multiprocess_spmd(num_shards, batch)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tmp.validate_multiprocess_spmd(num_shards, batch, nproc=nproc)
        assert str(got.value) == str(exc)
        return
    assert tmp.validate_multiprocess_spmd(num_shards, batch,
                                          nproc=nproc) == want


SHARD_GRID = [(None, 8, None, 1), (None, 8, None, 2), (2, 8, None, 1),
              (2, 8, None, 2), (3, 8, None, 4), (4, 8, True, 4),
              (None, 6, True, 4), (None, 8, False, 4), (8, 8, None, 2),
              (0, 8, None, 2), (1, 8, None, 2)]


@pytest.mark.parametrize("num_shards,batch,use_spmd,budget", SHARD_GRID)
def test_resolve_num_shards_matches_jax(num_shards, batch, use_spmd,
                                        budget):
    """The value and the warning text, over a grid with every fallback;
    the port's default budget is the world (1 without a group)."""
    def run(fn, **kw):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fn(num_shards, batch, use_spmd, **kw)
        return out, [str(w.message) for w in rec]
    assert run(tmesh.resolve_num_shards, device_budget=budget) == \
        run(jmesh.resolve_num_shards, device_budget=budget)
    assert run(tmesh.resolve_num_shards) == \
        run(jmesh.resolve_num_shards, device_budget=1)


@pytest.mark.parametrize("world", [2, 3])
def test_packed_loader_rank_bins_match_jax(world):
    """Each rank's bins of the global plan, its batches and the plan
    fingerprint (equal on every rank) are JAX's, for W = 2 and 3, shuffled
    over two epochs and unshuffled (a padding bin at the tail)."""
    samples = synthetic_molecules(37, seed=4, min_atoms=3, max_atoms=12,
                                  num_features=4, max_in_degree=6)
    jsamples = to_jax_samples(samples)
    for shuffle in (True, False):
        fps = {0: set(), 1: set()}
        for rank in range(world):
            kw = dict(pack_rank=rank, pack_nproc=world)
            loader = GraphDataLoader(samples, 4, shuffle=shuffle,
                                     packing=True, neighbor_format=True,
                                     **kw)
            jl = JLoader(jsamples, 4, shuffle=shuffle, packing=True,
                         neighbor_format=True, async_workers=0, **kw)
            for epoch in (0, 1):
                loader.set_epoch(epoch)
                jl.set_epoch(epoch)
                assert loader._selections() == jl._selections()
                assert len(loader) == len(jl)
                fp = loader.global_plan_fingerprint()
                assert fp == jl.global_plan_fingerprint()
                fps[epoch].add(fp)
                for b, jb in zip(list(loader), list(jl)):
                    for f in ("x", "senders", "receivers", "node_graph",
                              "node_mask", "edge_mask", "graph_mask",
                              "y_graph", "nbr", "nbr_mask"):
                        np.testing.assert_array_equal(
                            getattr(b, f).numpy(),
                            np.asarray(getattr(jb, f)), err_msg=f)
        # one fingerprint an epoch, whatever the rank
        assert [len(v) for v in fps.values()] == [1, 1]


@pytest.mark.parametrize("neighbor_format", [False, True])
def test_loader_budgets_with_a_max_reduce_match_jax(neighbor_format):
    """Three ranks' slices; each rank's raw (max nodes, max edges, K) are
    max-reduced before bucketing, in both packages, bitwise."""
    samples = synthetic_molecules(30, seed=2, min_atoms=3, max_atoms=20,
                                  num_features=4, max_in_degree=9)
    slices = [samples[r * 10:(r + 1) * 10] for r in range(3)]
    raw = []
    for part in slices:
        loader_budgets(part, 4, neighbor_format,
                       reduce_fn=lambda *v: raw.append(v) or v)

    def reduce(*v):
        return tuple(max(col) for col in zip(*raw))
    got = [loader_budgets(part, 4, neighbor_format, reduce_fn=reduce)
           for part in slices]
    want = [j_loader_budgets(to_jax_samples(part), 4, neighbor_format,
                             reduce_fn=reduce) for part in slices]
    assert got == want
    assert len(set(got)) == 1


# ----------------------------------------------------------- collectives

def test_collectives_over_three_gloo_ranks(tmp_path):
    """allreduce_max_int, sync_config_stats (pna_deg histograms add,
    max_neighbours follows, min-max ranges widen) and
    assert_equal_across_processes (JAX's message for unequal values)
    over three gloo ranks, against the JAX package's arithmetic."""
    values = [(3, 10, 0), (7, 2, 5), (1, 1, 9)]
    degs = [[0, 4, 2], [1, 1, 1, 3], [5]]
    mms = [[[0.0, -1.0], [2.0, 1.0]], [[-3.0, 0.5], [1.0, 4.0]],
           [[0.5, -2.0], [0.75, 0.0]]]
    cfgs = [{"NeuralNetwork": {
        "Architecture": {"pna_deg": d, "max_neighbours": len(d) - 1},
        "Variables_of_interest": {"x_minmax": mm, "y_minmax": mm}}}
        for d, mm in zip(degs, mms)]
    res = spawn_ranks(tmp_path, "collectives", 3, stats_configs=cfgs,
                      values=values)
    want_deg = np.zeros(4, np.int64)
    for d in degs:
        want_deg[:len(d)] += d
    arr = np.asarray(mms, np.float64)
    want_mm = np.stack([arr[:, 0].min(axis=0), arr[:, 1].max(axis=0)])
    for rank, r in enumerate(res):
        assert r["max"] == (7, 10, 9)
        arch = r["stats"]["NeuralNetwork"]["Architecture"]
        assert arch["pna_deg"] == want_deg.tolist()
        assert arch["max_neighbours"] == 3
        voi = r["stats"]["NeuralNetwork"]["Variables_of_interest"]
        assert voi["x_minmax"] == voi["y_minmax"] == want_mm.tolist()
        assert r["unequal"] == (
            "rank differs across processes ([0, 1, 2]): every process "
            "must run the same number of steps or the collectives "
            "deadlock — equalize the per-host dataset shards")


def test_init_distributed_missing_peer_raises_within_the_bound(tmp_path):
    """A world of 2 whose other rank never comes: an actionable
    RuntimeError naming this process within the rendezvous bound, and no
    group left behind."""
    import torch.distributed as dist
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rendezvous timed out after "
                       "2s: this is process 0 of 2"):
        tmesh.init_distributed(coordinator=f"file://{tmp_path}/rdzv",
                               num_processes=2, process_id=0, timeout_s=2,
                               device="cpu")
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


def test_init_distributed_without_a_coordinator_is_one_process(
        monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("HYDRAGNN_MASTER_ADDR", raising=False)
    assert tmesh.init_distributed(device="cpu") == (1, 0)
    assert tmesh.get_comm_size_and_rank() == (1, 0)
    assert not dist.is_initialized()


def test_zero_placement_rule_matches_jax():
    """mesh.zero_sharded is JAX's param_sharding_zero leaf rule."""
    devices = jax.devices()[:2]
    mesh = jmesh.make_mesh((("data", 2),), devices=devices)
    leaves = {"a": np.zeros((4, 3)), "b": np.zeros((3, 4)),
              "c": np.zeros(()), "d": np.zeros((6,)),
              "e": np.zeros((2, 2))}
    for min_size in (0, 8, 13):
        spec = jmesh.param_sharding_zero(mesh, leaves, min_size=min_size)
        for k, v in leaves.items():
            want = spec[k].spec == jax.sharding.PartitionSpec("data")
            assert tmesh.zero_sharded(v.shape, 2, min_size) == want, \
                (k, min_size)


# ------------------------------------------------------------ build lock

BUILD_CHILD = """
import os, sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
from hydragnn_tpu_torch.kernels import _build
_build.BUILD_ROOT = Path({build!r})

def fake_compile(sources, out_dir):
    with open({counter!r}, "a") as f:
        f.write(f"{{os.getpid()}} {{len(sources)}}\\n")
    time.sleep(2.0)
    for src in sources:
        (out_dir / f"lib{{src.stem}}.so").write_bytes(b"")

_build._compile = fake_compile
_build.ctypes.CDLL = lambda path: path
_build.build_all()
"""


def test_build_lock_runs_one_compile_for_two_processes(tmp_path):
    """Two processes that build at once (nvcc stubbed: it sleeps and
    writes empty libraries): the lock file in the digest directory lets
    one compile; the other finds the libraries."""
    counter = tmp_path / "compiles.txt"
    code = BUILD_CHILD.format(root=str(Path(__file__).resolve().parents[1]),
                              build=str(tmp_path / "build"),
                              counter=str(counter))
    procs = [subprocess.Popen([sys.executable, "-c", code])
             for _ in range(2)]
    try:
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0, 0]
    lines = counter.read_text().splitlines()
    assert len(lines) == 1, lines
    assert int(lines[0].split()[1]) == len(list(_build.CSRC_DIR.glob("*.cu")))


# ------------------------------------------------- the step against JAX

def _batches(samples, per, n_steps, world, nbr):
    """[step][rank] port batches of `per` graphs on one padded shape."""
    n_node, n_edge, k = loader_budgets(samples, per, nbr)
    out = []
    for s in range(n_steps):
        row = []
        for r in range(world):
            at = (s * world + r) * per
            b = tbatch.collate(samples[at:at + per], n_node=n_node,
                               n_edge=n_edge, n_graph=per + 1)
            if nbr:
                b = tbatch.with_neighbor_format(b, k=k)
            row.append(b)
        out.append(row)
    return out, (n_node, n_edge, k)


def _summing(jc, world=2):
    """The JAX config at SGD's learning rate over the world: JAX's step
    sums the shards' gradients (ROADMAP C9), the port averages them."""
    opt = jc["NeuralNetwork"]["Training"]["Optimizer"]
    assert opt["type"] == "SGD"
    opt["learning_rate"] = opt["learning_rate"] / world
    return jc


def _pna_case(name, nbr, nan=False):
    jsamples = deterministic_graph_dataset(num_configs=40, seed=5)
    samples = to_port_samples(jsamples)
    cfg = make_config("PNA")
    cfg["NeuralNetwork"]["Training"]["Optimizer"] = dict(SGD)
    tc = tcfg.update_config(copy.deepcopy(cfg), samples)
    jc = _summing(jcfg.update_config(copy.deepcopy(cfg), jsamples))
    batches, (n_node, n_edge, k) = _batches(samples, 4, 3, 2, nbr)
    if nan:
        b = batches[1][1]
        batches[1][1] = b.replace(y_graph=torch.full_like(b.y_graph,
                                                          float("nan")))
    # eval shards of 3 and 1 real graphs on the train shape
    ev = [tbatch.collate(samples[24:27], n_node=n_node, n_edge=n_edge,
                         n_graph=5),
          tbatch.collate(samples[27:28], n_node=n_node, n_edge=n_edge,
                         n_graph=5)]
    if nbr:
        ev = [tbatch.with_neighbor_format(b, k=k) for b in ev]
    return dict(name=name, config=tc, jconfig=jc, samples=samples,
                batches=batches, eval_batches=None if nan else ev)


def _ef_case():
    with open(LJ) as fh:
        base = json.load(fh)
    arch = base["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=8, num_filters=8, num_gaussians=8,
                neighbor_format=False)
    arch["output_heads"]["node"]["dim_headlayers"] = [8, 8]
    base["NeuralNetwork"]["Training"]["Optimizer"] = dict(SGD)
    samples = lj_configurations(12, seed=9)
    tc = tcfg.update_config(copy.deepcopy(base), samples)
    jc = _summing(jcfg.update_config(copy.deepcopy(base),
                                     to_jax_samples(samples)))
    batches, _ = _batches(samples, 2, 3, 2, False)
    return dict(name="schnet_ef", config=tc, jconfig=jc, samples=samples,
                batches=batches, eval_batches=None, cge=True)


def _stacked(rows):
    return jax_batch(_stack_batches([_jax_view(b) for b in rows]))


def _jax_reference(case, mesh):
    jc = case["jconfig"]
    jmcfg = jcfg.build_model_config(jc)
    jmodel = j_create_model(jmcfg)
    tr = jc["NeuralNetwork"]["Training"]
    variables = numpy_tree(j_init_params(
        jmodel, jax_batch(_jax_view(case["batches"][0][0])), seed=4))
    state = JState.create(variables, jopt.select_optimizer(tr))
    cge = case.get("cge", False)
    step = make_spmd_train_step(jmodel, jmcfg, jopt.select_optimizer(tr),
                                mesh, tr.get("loss_function_type", "mse"),
                                compute_grad_energy=cge)
    metrics = []
    for rows in case["batches"]:
        state, m = step(state, jmesh.shard_batch(_stacked(rows), mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    ev = None
    if case["eval_batches"] is not None:
        evs = make_spmd_eval_step(jmodel, jmcfg, mesh, "mse")
        ev = {k: float(v) for k, v in evs(
            state, jmesh.shard_batch(_stacked(case["eval_batches"]),
                                     mesh)).items()}
    return variables, metrics, numpy_tree({"params": state.params,
                                           "batch_stats": state.batch_stats}
                                          ), ev


@pytest.fixture(scope="module")
def spmd_runs(tmp_path_factory):
    mesh = jmesh.make_mesh((("data", 2),), devices=jax.devices()[:2])
    cases = [_pna_case("pna_dense", True), _pna_case("pna_edge", False),
             _pna_case("pna_nan", True, nan=True), _ef_case()]
    ref = {}
    for case in cases:
        variables, metrics, final, ev = _jax_reference(case, mesh)
        case["variables"] = variables
        ref[case["name"]] = (metrics, final, ev)
        case.pop("jconfig")
    got = spawn_ranks(tmp_path_factory.mktemp("spmd"), "spmd_steps", 2,
                      timeout=150, cases=cases)
    return got, ref


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _assert_tree(got, want, tol, path="", scaled=False):
    """Leaf by leaf; `scaled` adds rtol times the leaf's largest |entry|
    to atol."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree(got[k], want[k], tol, f"{path}/{k}", scaled)
        return
    want = np.asarray(want)
    tol = dict(tol)
    if scaled and want.size:
        tol["atol"] += tol["rtol"] * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, err_msg=path, **tol)


@pytest.mark.parametrize("name", ["pna_dense", "pna_edge", "schnet_ef",
                                  "pna_nan"])
def test_spmd_step_matches_jax_on_a_two_device_mesh(spmd_runs, name):
    got, ref = spmd_runs
    want_metrics, want_state, _ = ref[name]
    r0, r1 = got[0][name], got[1][name]
    # the ranks are bitwise one another (NaN equal to NaN)
    np.testing.assert_equal(r0["metrics"], r1["metrics"])
    _assert_tree(r0["variables"], r1["variables"], dict(rtol=0, atol=0))
    for g, w in zip(r0["metrics"], want_metrics):
        assert set(g) == set(w)
        assert g["nonfinite_steps"] == w["nonfinite_steps"]
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **STEP_TOL)
    if name == "pna_nan":
        # the NaN on rank 1 at step 1 poisons the mean gradient on every
        # rank in both packages; where the NaNs land in the parameters
        # follows each package's arithmetic (JAX keeps a few selected
        # zeros), so only their presence is held
        assert [m["nonfinite_steps"] for m in r0["metrics"]] == [0, 1, 1]
        for tree in (r0["variables"]["params"], want_state["params"]):
            leaves = [np.asarray(v) for v in _leaves(tree)]
            assert any(np.isnan(v).any() for v in leaves)
    elif name == "schnet_ef":
        _assert_tree(r0["variables"], want_state, EF_PARAM_TOL, scaled=True)
    else:
        _assert_tree(r0["variables"], want_state, STEP_TOL)
    if name != "pna_nan":
        assert all(m["nonfinite_steps"] == 0 for m in r0["metrics"])


def test_spmd_eval_step_weights_unequal_shards_as_jax(spmd_runs):
    got, ref = spmd_runs
    want = ref["pna_dense"][2]
    assert got[0]["pna_dense"]["eval"] == got[1]["pna_dense"]["eval"]
    for k, v in want.items():
        np.testing.assert_allclose(got[0]["pna_dense"]["eval"][k], v,
                                   err_msg=k, **STEP_TOL)
