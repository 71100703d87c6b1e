"""The host side of sampled training in the port (hydragnn_tpu_torch:
parallel/partition.py, preprocess/sampling.py, preprocess/cache.py's
array shards, datasets/async_loader.py's two pieces, telemetry/sampling.py,
utils/envflags.resolve_sampling, the ogbn graph of graphs/synthetic.py and
GraphBatch's sampled fields) against the JAX package's live output on the
same numpy inputs, bit for bit:

* partition maps, fingerprints, cut fractions and their errors;
* resolve_sampling and resolve_async_workers, env cases included;
* seed_plan and the per-batch RNG's draws; CSRGraph with its errors; the
  k-hop sampler and the refresh allowance, exact and historical; every
  field of build_sampled_batch;
* two epochs of NeighborSamplingLoader batches at world 1, 2 and 3 (every
  rank), synchronous and in the background; plan_fingerprint; fetch_stats
  (synchronous: in the background the producer may run ahead);
* the registry's sampling metrics after the same batches;
* the feature-store cache key and array shards written by either package
  and opened by the other; the ogbn graph and its .npz loader;
* the sampled fields through `.to`, `cast_floats`, the capture slots'
  `fill` and `batch_signature`.
"""
import dataclasses
import logging
import threading
import time

import numpy as np
import pytest
import torch

from examples.ogbn import ogbn_data as jdata
from hydragnn_tpu.datasets import async_loader as jasync
from hydragnn_tpu.parallel import partition as jpart
from hydragnn_tpu.preprocess import cache as jcache
from hydragnn_tpu.preprocess import sampling as jsamp
from hydragnn_tpu.utils import envflags as jenv
from hydragnn_tpu_torch.datasets import async_loader as tasync
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs import synthetic as tsyn
from hydragnn_tpu_torch.parallel import partition as tpart
from hydragnn_tpu_torch.preprocess import cache as tcache
from hydragnn_tpu_torch.preprocess import sampling as tsamp
from hydragnn_tpu_torch.train import step_graphs
from hydragnn_tpu_torch.train.train_step import cast_floats
from hydragnn_tpu_torch.utils import envflags as tenv

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(tbatch.GraphBatch)]
SAMPLED = ("seed_mask", "node_global", "hist_mask", "refresh_upto",
           "hist_states")
SAMPLE_ENVS = ("HYDRAGNN_SAMPLE_FANOUTS", "HYDRAGNN_SAMPLE_STALENESS_K",
               "HYDRAGNN_SAMPLE_PARTITIONS")
ASYNC_ENVS = ("HYDRAGNN_ASYNC_LOADER", "HYDRAGNN_LOADER_WORKERS")


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the comparison is the point
        return type(exc).__name__, str(exc)
    return None


def _graph(n=300, seed=1):
    return jdata.synthetic_arxiv(num_nodes=n, feat_dim=5, num_classes=4,
                                 seed=seed)


def assert_batch_equal(tb, jb):
    """Every field of a port batch bitwise the JAX batch's (dtype too)."""
    for f in FIELDS:
        a, w = getattr(tb, f), getattr(jb, f, None)
        if w is None:
            assert a is None, f
            continue
        w = np.asarray(w)
        assert a.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(a.numpy(), w, err_msg=f)


# ----------------------------------------------------------- partition --
@pytest.mark.parametrize("mode", ["range", "hash"])
@pytest.mark.parametrize("n,p,seed", [(0, 3, 0), (1, 1, 0), (97, 4, 0),
                                      (1000, 7, 5), (5000, 16, -3)])
def test_partition_maps_and_fingerprints_match_jax(mode, n, p, seed):
    got = tpart.partition_nodes(n, p, mode, seed=seed)
    want = jpart.partition_nodes(n, p, mode, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tpart.partition_fingerprint(n, p, mode, seed) == \
        jpart.partition_fingerprint(n, p, mode, seed)
    if n:
        rng = np.random.RandomState(n)
        s, r = rng.randint(0, n, 3 * n), rng.randint(0, n, 3 * n)
        assert tpart.cut_fraction(s, r, got) == jpart.cut_fraction(s, r,
                                                                   want)
    assert tpart.cut_fraction([], [], got) == 0.0


def test_partition_errors_match_jax():
    for args in ((-1, 2), (10, 0), (10, 2, "metis")):
        assert _raises(lambda: tpart.partition_nodes(*args)) == \
            _raises(lambda: jpart.partition_nodes(*args))
    assert _raises(lambda: tpart.partition_nodes(10, 2, "metis"))[0] == \
        "ValueError"


# --------------------------------------------------------------- knobs --
@pytest.mark.parametrize("how", ["default", "config", "env_over_config",
                                 "typos", "non_positive", "empty"])
def test_resolve_sampling_matches_jax(monkeypatch, caplog, how):
    """Defaults, the Training.Sampling block, the env over it, and
    malformed values, which warn naming the variable and keep the
    block's."""
    for name in SAMPLE_ENVS:
        monkeypatch.delenv(name, raising=False)
    block = None if how == "default" else {"Sampling": {
        "fanouts": [10, 5], "staleness_k": 3, "partitions": 4,
        "partition_mode": "hash"}}
    env = {"env_over_config": ("6,4,2", "8", "2"),
           "typos": ("10,x", "eight", "2.5"),
           "non_positive": ("5,0", "-4", "-2"),
           "empty": ("  ", "", " ")}.get(how)
    if env is not None:
        for name, v in zip(SAMPLE_ENVS, env):
            monkeypatch.setenv(name, v)
    with caplog.at_level(logging.WARNING):
        got = tenv.resolve_sampling(block)
    port_log = caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = jenv.resolve_sampling(block)
    assert got == want
    if how == "typos":
        for name in SAMPLE_ENVS:
            assert name in port_log and name in caplog.text
    elif how == "non_positive":
        assert "HYDRAGNN_SAMPLE_FANOUTS" in port_log
        assert got[1:3] == (0, 1)


@pytest.mark.parametrize("env", [{}, {"HYDRAGNN_ASYNC_LOADER": "0"},
                                 {"HYDRAGNN_ASYNC_LOADER": "off",
                                  "HYDRAGNN_LOADER_WORKERS": "5"},
                                 {"HYDRAGNN_LOADER_WORKERS": "0"},
                                 {"HYDRAGNN_LOADER_WORKERS": "3"},
                                 {"HYDRAGNN_LOADER_WORKERS": "-2"}])
def test_resolve_async_workers_matches_jax(monkeypatch, env):
    for name in ASYNC_ENVS:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for override in (None, 0, 4, -1):
        assert tasync.resolve_async_workers(override) == \
            jasync.resolve_async_workers(override)
    assert tasync.DEFAULT_WORKERS == jasync.DEFAULT_WORKERS


# ----------------------------------------------------- background stream --
def test_background_iterate_order_stats_error_and_stop():
    """Order kept and every item counted; a producer's exception re-raised
    on the consumer after the items before it; an abandoned stream stops
    its producer (joined before control returns)."""
    stats = {}
    got = list(tasync.background_iterate(iter(range(20)), depth=3,
                                         stats=stats))
    assert got == list(range(20))
    assert stats["items"] == 20 and 0 <= stats["ready_items"] <= 20

    def boom():
        yield 1
        yield 2
        raise RuntimeError("producer failed")
    seen = []
    with pytest.raises(RuntimeError, match="producer failed"):
        for item in tasync.background_iterate(boom(), depth=2):
            seen.append(item)
    assert seen == [1, 2]

    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1
    stream = tasync.background_iterate(endless(), depth=2)
    assert next(stream) == 0
    stream.close()
    n = len(made)
    time.sleep(0.3)
    assert len(made) == n <= 4
    assert not any(t.name == "hydragnn-producer" and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------------- plan and sampler --
def test_seed_plan_and_batch_rng_match_jax():
    for n, epoch, seed in ((1, 0, 0), (50, 0, 0), (1000, 3, 7),
                           (257, 11, 123456)):
        np.testing.assert_array_equal(tsamp.seed_plan(n, epoch, seed),
                                      jsamp.seed_plan(n, epoch, seed))
    for seed, epoch, gb in ((0, 0, 0), (7, 2, 5), (123, 9, 1000)):
        a = tsamp._batch_rng(seed, epoch, gb)
        b = jsamp._batch_rng(seed, epoch, gb)
        np.testing.assert_array_equal(a.randint(0, 1 << 30, 16),
                                      b.randint(0, 1 << 30, 16))
        np.testing.assert_array_equal(a.choice(40, 7, replace=False),
                                      b.choice(40, 7, replace=False))


def test_csr_graph_and_its_errors_match_jax():
    g = _graph()
    tc = tsamp.CSRGraph(g.senders, g.receivers, g.num_nodes)
    jc = jsamp.CSRGraph(g.senders, g.receivers, g.num_nodes)
    np.testing.assert_array_equal(tc.senders, jc.senders)
    np.testing.assert_array_equal(tc.indptr, jc.indptr)
    assert tc.num_edges == jc.num_edges
    nodes = np.arange(0, g.num_nodes, 7)
    skip = nodes % 3 == 0
    for fanout in (1, 3, 12):
        a = tc.sample_in_neighbors(nodes, fanout, np.random.RandomState(4),
                                   skip=skip)
        b = jc.sample_in_neighbors(nodes, fanout, np.random.RandomState(4),
                                   skip=skip)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    empty = tsamp.CSRGraph(np.zeros(0, np.int64), np.zeros(0, np.int64), 5)
    assert empty.num_edges == 0 and not empty.indptr.any()
    good = np.asarray([0, 1], np.int64)
    for s, r, n in ((good, np.asarray([0, 5]), 4),
                    (np.asarray([0, -1]), good, 4),
                    (np.asarray([0]), good, 4), (good, good, -1)):
        assert _raises(lambda: tsamp.CSRGraph(s, r, n)) == \
            _raises(lambda: jsamp.CSRGraph(s, r, n))


@pytest.mark.parametrize("hist", [False, True])
def test_khop_subgraph_allowance_and_batch_match_jax(hist):
    """The k-hop sampler (historical: remote nodes beyond hop 0 halted),
    the refresh allowance and every field of the batch."""
    g = _graph()
    owner = jpart.partition_nodes(g.num_nodes, 3)
    tc = tsamp.CSRGraph(g.senders, g.receivers, g.num_nodes)
    jc = jsamp.CSRGraph(g.senders, g.receivers, g.num_nodes)
    seeds = np.asarray([3, 50, 120, 7, 299, 3])
    for rank in range(3):
        kw = dict(owner=owner, rank=rank, expand_remote=not hist)
        a = tsamp.sample_khop_subgraph(tc, seeds, (4, 3, 2),
                                       np.random.RandomState(9), **kw)
        b = jsamp.sample_khop_subgraph(jc, seeds, (4, 3, 2),
                                       np.random.RandomState(9), **kw)
        for f in ("node_ids", "hop_of", "halted", "offsets"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert a.num_seeds == b.num_seeds == len(seeds)
        for (la, ma), (lb, mb) in zip(a.hop_tables, b.hop_tables):
            np.testing.assert_array_equal(la, lb)
            np.testing.assert_array_equal(ma, mb)
        assert a.halted.any() == hist
        for layers in (1, 2, 3):
            np.testing.assert_array_equal(
                tsamp.refresh_allowance(a, owner, rank, layers),
                jsamp.refresh_allowance(b, owner, rank, layers))
        np.testing.assert_array_equal(
            tsamp.refresh_allowance(a, None, rank, 3),
            jsamp.refresh_allowance(b, None, rank, 3))
        x_rows = g.x[a.node_ids] * (~a.halted)[:, None]
        y = g.y_onehot[seeds]
        kwb = dict(num_nodes_global=g.num_nodes, num_layers=3, hist=hist,
                   owner=owner, rank=rank)
        assert_batch_equal(tsamp.build_sampled_batch(a, x_rows, y, **kwb),
                           jsamp.build_sampled_batch(b, x_rows, y, **kwb))
    # one-column labels and no fanouts: the padding edge alone
    a = tsamp.sample_khop_subgraph(tc, seeds, (), np.random.RandomState(0))
    b = jsamp.sample_khop_subgraph(jc, seeds, (), np.random.RandomState(0))
    assert_batch_equal(
        tsamp.build_sampled_batch(a, g.x[seeds], g.label[seeds],
                                  num_nodes_global=g.num_nodes, hist=True),
        jsamp.build_sampled_batch(b, g.x[seeds], g.label[seeds],
                                  num_nodes_global=g.num_nodes, hist=True))


def _loaders(g, **kw):
    kw = dict(dict(x=g.x, y_node=g.y_onehot, senders=g.senders,
                   receivers=g.receivers, train_nodes=g.train_idx,
                   batch_size=16, fanouts=(4, 3), seed=7, num_partitions=4),
              **kw)
    return tsamp.NeighborSamplingLoader(**kw), jsamp.NeighborSamplingLoader(
        **kw)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("async_workers", [0, 2])
def test_loader_epochs_match_jax_at_every_rank(world, async_workers):
    """Two epochs of every rank's batches, exact and historical (K 3),
    the plan's fingerprint, and (synchronous) the fetch accounting."""
    g = _graph()
    for staleness_k in (0, 3):
        fps = set()
        for rank in range(world):
            tl, jl = _loaders(g, rank=rank, world=world,
                              staleness_k=staleness_k,
                              async_workers=async_workers)
            assert tl.plan_fingerprint() == jl.plan_fingerprint()
            fps.add(tl.plan_fingerprint())
            assert len(tl) == len(jl) and tl.rank_batches() == \
                jl.rank_batches()
            assert tl.async_workers == jl.async_workers == async_workers
            for epoch in range(2):
                tl.set_epoch(epoch)
                jl.set_epoch(epoch)
                n = 0
                for tb, jb in zip(tl, jl):
                    assert_batch_equal(tb, jb)
                    n += 1
                assert n == len(tl)
            if async_workers == 0:
                assert tl.fetch_stats() == jl.fetch_stats()
            else:
                assert tl.fetch_stats()["batches"] == 2 * len(tl)
                assert 0.0 <= tl.sampler_overlap_frac() <= 1.0
        assert len(fps) == 1


def test_loader_without_shuffle_errors_and_store_match_jax():
    g = _graph()
    tl, jl = _loaders(g, shuffle=False, async_workers=0,
                      train_nodes=g.val_idx[:32])
    np.testing.assert_array_equal(tl.epoch_order(3), jl.epoch_order(3))
    assert tl.plan_fingerprint() == jl.plan_fingerprint()
    for kw in (dict(batch_size=400), dict(x=None)):
        args = dict(dict(x=g.x, y_node=g.y_onehot, senders=g.senders,
                         receivers=g.receivers, async_workers=0), **kw)
        assert _raises(lambda: tsamp.NeighborSamplingLoader(**args)) == \
            _raises(lambda: jsamp.NeighborSamplingLoader(**args))
    owner = jpart.partition_nodes(g.num_nodes, 4)
    ts = tsamp.NodeFeatureStore(g.x, g.label, owner, rank=1)
    js = jsamp.NodeFeatureStore(g.x, g.label, owner, rank=1)
    ids = np.arange(0, g.num_nodes, 3)
    np.testing.assert_array_equal(ts.gather_features(ids),
                                  js.gather_features(ids))
    np.testing.assert_array_equal(ts.gather_labels(ids),
                                  js.gather_labels(ids))
    assert ts.fetch_stats() == js.fetch_stats()
    assert (ts.num_nodes, ts.feat_dim, ts.label_dim) == \
        (js.num_nodes, js.feat_dim, js.label_dim)


def test_init_hist_tables_layout_matches_jax():
    g = _graph(60)
    for layers in (1, 2, 3):
        t = tsamp.init_hist_tables(g.x, 8, layers, device="cpu")
        j = jsamp.init_hist_tables(g.x, 8, layers)
        for name in ("feat", "layers", "versions"):
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            assert a.numpy().dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    snap = t.copy()
    t.layers += 1.0
    t.versions += 3
    t.restore(snap)
    assert torch.equal(t.layers, snap.layers)
    assert torch.equal(t.versions, snap.versions)


# ----------------------------------------------------------- telemetry --
def test_sampling_metrics_match_jax_registry():
    """The same batches through each package's loader, then one
    record_hist_refresh each: the registries' Prometheus text equal."""
    from hydragnn_tpu.telemetry import sampling as jtel
    from hydragnn_tpu.telemetry.registry import MetricsRegistry as JReg
    from hydragnn_tpu.telemetry.registry import get_registry as j_get
    from hydragnn_tpu.telemetry.registry import set_registry as j_set
    from hydragnn_tpu_torch.telemetry import record_hist_refresh
    from hydragnn_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                       get_registry,
                                                       set_registry)
    j_prev, t_prev = j_get(), get_registry()
    j_set(JReg())
    set_registry(MetricsRegistry())
    try:
        g = _graph()
        tl, jl = _loaders(g, staleness_k=2, async_workers=0)
        for _ in zip(tl, jl):
            pass
        record_hist_refresh(1.5, 0.25)
        jtel.record_hist_refresh(1.5, 0.25)
        got, want = get_registry().to_prometheus(), j_get().to_prometheus()
        assert "sampler_hist_served_nodes_total" in got
        assert got == want
    finally:
        j_set(j_prev)
        set_registry(t_prev)


# --------------------------------------------------------------- cache --
def test_cache_key_and_shards_cross_both_packages(tmp_path):
    """The key string equals JAX's; a store shard written by JAX opens in
    the port and one the port writes opens in JAX, the same arrays; a
    corrupt or foreign shard is refused alike."""
    g = _graph(80)
    owner = jpart.partition_nodes(g.num_nodes, 4)
    pfp = jpart.partition_fingerprint(g.num_nodes, 4)
    for extra in (None, {"rank": 1}):
        assert tcache.feature_store_key(g.fingerprint(), pfp, extra) == \
            jcache.feature_store_key(g.fingerprint(), pfp, extra)
    assert tsyn.OgbnGraph(**{f.name: getattr(g, f.name) for f in
                             dataclasses.fields(g)}).fingerprint() == \
        g.fingerprint()
    key = tcache.feature_store_key(g.fingerprint(), pfp)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    js = jsamp.NodeFeatureStore.build_cached(str(jdir), key, g.x, g.label,
                                             owner, rank=2)
    ts = tsamp.NodeFeatureStore.open_cached(str(jdir), key, rank=2)
    ts2 = tsamp.NodeFeatureStore.build_cached(str(tdir), key, g.x, g.label,
                                              owner, rank=2)
    js2 = jsamp.NodeFeatureStore.open_cached(str(tdir), key, rank=2)
    for a, b in ((ts, js), (ts2, js2), (ts, ts2)):
        for f in ("x", "y", "owner"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with open(jdir / f"featstore-{key}" / "data.bin", "rb") as f1, \
            open(tdir / f"featstore-{key}" / "data.bin", "rb") as f2:
        assert f1.read() == f2.read()
    meta = {"minmax": np.arange(6, dtype=np.float64).reshape(2, 3),
            "name": "x"}
    tcache.save_array_shard(str(tdir), "m", {"a": np.ones(3)}, meta)
    arrays, got = jcache.load_array_shard(str(tdir), "m")
    np.testing.assert_array_equal(got["minmax"], meta["minmax"])
    arrays, got = tcache.load_array_shard(str(tdir), "m")
    np.testing.assert_array_equal(got["minmax"], meta["minmax"])
    assert got["name"] == "x"
    assert _raises(lambda: tcache.load_array_shard(str(tdir), "none"))[0] \
        == "FileNotFoundError"
    with open(tdir / f"featstore-{key}" / "data.bin", "r+b") as f:
        f.seek(5)
        f.write(b"\xff")
    for mod in (tcache, jcache):
        with pytest.raises(mod.CacheInvalid, match="checksum"):
            mod.load_array_shard(str(tdir), key)
    (tdir / "featstore-other").mkdir()
    for name in ("meta.json", "index.json", "data.bin"):
        (tdir / "featstore-other" / name).write_bytes(
            (tdir / "featstore-m" / name).read_bytes())
    for mod in (tcache, jcache):
        with pytest.raises(mod.CacheInvalid, match="built for key"):
            mod.load_array_shard(str(tdir), "other")
    assert tcache.CACHE_SCHEMA_VERSION == jcache.CACHE_SCHEMA_VERSION


# ----------------------------------------------------------- ogbn graph --
def test_ogbn_graph_and_npz_loader_match_jax(tmp_path):
    for kw in (dict(), dict(num_nodes=500, feat_dim=7, num_classes=3,
                            avg_degree=4, homophily=0.9, seed=4)):
        a, b = tsyn.synthetic_arxiv(**kw), jdata.synthetic_arxiv(**kw)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        np.testing.assert_array_equal(a.y_onehot, b.y_onehot)
        assert a.fingerprint() == b.fingerprint()
    g = jdata.synthetic_arxiv(num_nodes=120, seed=2)
    np.savez(tmp_path / jdata.NPZ_NAME, x=g.x, label=g.label,
             senders=g.senders, receivers=g.receivers,
             train_idx=g.train_idx, val_idx=g.val_idx, test_idx=g.test_idx)
    assert tsyn.OGBN_NPZ_NAME == jdata.NPZ_NAME
    a = tsyn.load_ogbn(str(tmp_path), num_nodes=50)
    b = jdata.load_ogbn(str(tmp_path), num_nodes=50)
    assert a.fingerprint() == b.fingerprint() == g.fingerprint()
    assert a.num_classes == b.num_classes
    assert tsyn.load_ogbn(None, num_nodes=50).fingerprint() == \
        jdata.load_ogbn(None, num_nodes=50).fingerprint()


# ------------------------------------------------------ the batch fields --
def test_sampled_fields_ride_every_batch_route_and_key_their_capture():
    """collate leaves the sampled fields None; `.to`, `cast_floats` (which
    casts hist_states as JAX's `_cast_floats` does) and the slot `fill`
    carry them; a sampled batch keys its own capture, and a plain batch's
    key holds each sampled field as None, as it holds `dataset_id`."""
    g = _graph()
    tl, _ = _loaders(g, staleness_k=3, async_workers=0)
    b = next(iter(tl))
    assert b.node_global.dtype == torch.int32
    assert b.refresh_upto.dtype == torch.int32
    assert b.seed_mask.dtype == b.hist_mask.dtype == torch.bool
    b = b.replace(hist_states=torch.randn(1, b.num_nodes, 4))
    moved = b.to("cpu")
    for f in SAMPLED:
        assert torch.equal(getattr(moved, f), getattr(b, f)), f
    half = cast_floats(b, torch.bfloat16)
    assert half.hist_states.dtype == torch.bfloat16
    assert half.node_global.dtype == torch.int32
    assert torch.equal(half.hist_mask, b.hist_mask)
    slot = tbatch.GraphBatch(**{
        f: None if getattr(b, f) is None else torch.zeros_like(
            getattr(b, f)) for f in FIELDS})
    step_graphs.fill(slot, b)
    for f in SAMPLED:
        assert torch.equal(getattr(slot, f), getattr(b, f)), f
    samples = [tbatch.GraphSample(x=np.ones((3, 2)), pos=np.zeros((3, 3)),
                                  senders=[0, 1], receivers=[1, 2])]
    plain = tbatch.collate(samples, n_node=8, n_edge=8, n_graph=2)
    assert all(getattr(plain, f) is None for f in SAMPLED)
    sig = step_graphs.batch_signature(plain)
    assert [k[0] for k in sig] == list(FIELDS)
    for f in SAMPLED + ("dataset_id",):
        assert (f, None) in sig, f
    sig_b = step_graphs.batch_signature(b)
    assert ("hist_states", (1, b.num_nodes, 4), torch.float32) in sig_b
    assert step_graphs.batch_signature(b.replace(hist_states=None)) != sig_b
