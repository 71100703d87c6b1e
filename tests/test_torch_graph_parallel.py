"""The port's graph parallelism (`hydragnn_tpu_torch.parallel.
graph_parallel`) against the JAX package's on the 8-device CPU mesh, the
port's slots all on the CPU (["cpu"] * 8):

* the host helpers (`partition_nodes`, `build_ring_buckets`,
  `shard_node_array`, `shard_edge_arrays`) bitwise, with the bucket
  invariants of tests/test_graph_parallel.py;
* the edge-sharded and ring layers on divisible and uneven N within
  rtol/atol 1e-5 of JAX's layers, and their VJPs within the same bound of
  `jax.vjp` of the same layers;
* on dyadic data (exact in float32 in any order) both modes bitwise the
  port's single-device segment sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hydragnn_tpu.parallel import graph_parallel as jgp
from hydragnn_tpu_torch.ops import segment as tseg
from hydragnn_tpu_torch.parallel import graph_parallel as tgp

torch.set_num_threads(1)

D = 8
CPU = ["cpu"] * D
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:D]), ("graph",))


def random_graph(n_nodes=200, n_edges=3000, f=16, seed=0, dyadic=False):
    rng = np.random.RandomState(seed)
    if dyadic:
        x = (rng.randint(-16, 17, (n_nodes, f)) / 8.0).astype(np.float32)
    else:
        x = rng.randn(n_nodes, f).astype(np.float32)
    send = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    recv = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    return x, send, recv


def jax_message(xi, xj, ea):
    # asymmetric so sender / receiver mix-ups are caught
    return xj * 2.0 + xi * 0.5


def port_message(xi, xj, ea):
    return xj * 2.0 + xi * 0.5


# --------------------------------------------------------- host helpers --
@pytest.mark.parametrize("n,shards", [(64, 8), (203, 8), (5, 8), (100, 3),
                                      (1, 1)])
def test_partition_nodes_matches_jax(n, shards):
    assert tgp.partition_nodes(n, shards) == jgp.partition_nodes(n, shards)


@pytest.mark.parametrize("n_nodes,n_edges,shards,masked,pad", [
    (64, 500, 8, False, 8), (203, 2000, 8, True, 8), (50, 300, 3, True, 4),
    (16, 40, 8, False, 8)])
def test_ring_buckets_match_jax_bitwise(n_nodes, n_edges, shards, masked,
                                        pad):
    _, send, recv = random_graph(n_nodes, n_edges, seed=n_nodes)
    mask = (np.arange(n_edges) % 5 != 0) if masked else None
    want = jgp.build_ring_buckets(send, recv, n_nodes, shards, mask, pad)
    got = tgp.build_ring_buckets(send, recv, n_nodes, shards, mask, pad)
    assert got.block == want.block
    for name in ("send_local", "recv_local", "edge_id", "mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_ring_bucket_invariants():
    """tests/test_graph_parallel.py:79-97 on the port's buckets."""
    _, send, recv = random_graph(n_nodes=64, n_edges=500, seed=2)
    b = tgp.build_ring_buckets(send, recv, 64, D)
    assert int(b.mask.sum()) == 500
    ids = b.edge_id[b.mask]
    assert sorted(ids.tolist()) == list(range(500))
    for d in range(D):
        for k in range(D):
            m = b.mask[d, k]
            if not m.any():
                continue
            sel = b.edge_id[d, k][m]
            assert np.all(recv[sel] // b.block == d)
            assert np.all(send[sel] // b.block == (d - k) % D)
            assert np.all(b.recv_local[d, k][m] == recv[sel] % b.block)
            assert np.all(b.send_local[d, k][m] == send[sel] % b.block)


@pytest.mark.parametrize("n", [200, 203, 3])
def test_shard_node_array_matches_jax_bitwise(n):
    x, _, _ = random_graph(n_nodes=n, n_edges=4)
    want = np.asarray(jgp.shard_node_array(jnp.asarray(x), D))
    got_np = tgp.shard_node_array(x, D)
    got_t = tgp.shard_node_array(torch.from_numpy(x), D)
    assert isinstance(got_np, np.ndarray)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("e,pad", [(3000, 8), (1001, 8), (7, 4)])
def test_shard_edge_arrays_match_jax_bitwise(e, pad):
    rng = np.random.RandomState(e)
    send = rng.randint(0, 50, e).astype(np.int32)
    attr = rng.randn(e, 3).astype(np.float32)
    want = jgp.shard_edge_arrays(D, send, attr, pad_multiple=pad)
    got = tgp.shard_edge_arrays(D, send, attr, pad_multiple=pad)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- layers --
def _edge_layers(mesh, n):
    jl = jgp.make_edge_sharded_layer(mesh, jax_message, n)
    tl = tgp.make_edge_sharded_layer(CPU, port_message, n)
    return jl, tl


@pytest.mark.parametrize("n_nodes,n_edges,seed", [(200, 3000, 0),
                                                 (203, 2000, 1)])
def test_edge_sharded_layer_and_vjp_match_jax(mesh, n_nodes, n_edges, seed):
    x, send, recv = random_graph(n_nodes, n_edges, seed=seed)
    mask, send_s, recv_s = tgp.shard_edge_arrays(D, send, recv)
    jl, tl = _edge_layers(mesh, n_nodes)
    args = (jnp.asarray(send_s), jnp.asarray(recv_s), jnp.asarray(mask))
    want, vjp = jax.vjp(lambda v: jl(v, *args), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl(xt, send_s, recv_s, mask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ct = np.random.RandomState(seed + 10).randn(*got.shape).astype(
        np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("n_nodes,n_edges,seed", [(208, 3000, 0),
                                                 (203, 2000, 1)])
def test_ring_layer_and_vjp_match_jax(mesh, n_nodes, n_edges, seed):
    x, send, recv = random_graph(n_nodes, n_edges, seed=seed)
    b = tgp.build_ring_buckets(send, recv, n_nodes, D)
    jl = jgp.make_ring_layer(mesh, jax_message)
    tl = tgp.make_ring_layer(CPU, port_message)
    args = (jnp.asarray(b.send_local), jnp.asarray(b.recv_local),
            jnp.asarray(b.mask))
    x_sh = tgp.shard_node_array(x, D)
    want, vjp = jax.vjp(lambda v: jl(v, *args), jnp.asarray(x_sh))
    xt = torch.from_numpy(x_sh).requires_grad_(True)
    got = tl(xt, b.send_local, b.recv_local, b.mask)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ct = np.random.RandomState(seed + 20).randn(*got.shape).astype(
        np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


def _single_device(x, send, recv):
    xt = torch.from_numpy(x)
    m = port_message(xt[torch.from_numpy(recv).long()],
                     xt[torch.from_numpy(send).long()], None)
    return tseg.segment_sum(m, torch.from_numpy(recv), x.shape[0])


@pytest.mark.parametrize("mode", ["edge", "ring"])
def test_both_modes_bitwise_single_device_on_dyadic_data(mode):
    """Dyadic features: every partial and every sum is exact in float32,
    so the slot order cannot show; both modes equal the single-device
    segment sum bit for bit."""
    n = 203
    x, send, recv = random_graph(n, 2500, seed=3, dyadic=True)
    want = _single_device(x, send, recv).numpy()
    if mode == "edge":
        mask, send_s, recv_s = tgp.shard_edge_arrays(D, send, recv)
        got = tgp.make_edge_sharded_layer(CPU, port_message, n)(
            torch.from_numpy(x), send_s, recv_s, mask).numpy()
    else:
        b = tgp.build_ring_buckets(send, recv, n, D)
        got = tgp.make_ring_layer(CPU, port_message)(
            tgp.shard_node_array(x, D), b.send_local, b.recv_local,
            b.mask).numpy().reshape(-1, x.shape[1])[:n]
    np.testing.assert_array_equal(got, want)


def test_edge_sharded_aggregate_composes_with_node_layers(mesh):
    """The aggregate is a building block inside a larger layer (pre / post
    node compute around it), as in JAX's composition test."""
    x, send, recv = random_graph(n_nodes=100, n_edges=1000, seed=3)
    w = np.random.RandomState(4).randn(16, 16).astype(np.float32) * 0.1
    mask, send_s, recv_s = tgp.shard_edge_arrays(D, send, recv)
    slots = tgp.Slots(CPU)
    agg = tgp.edge_sharded_aggregate(port_message, torch.from_numpy(x),
                                     send_s, recv_s, mask, 100, slots)
    got = torch.tanh(agg @ torch.from_numpy(w)).numpy()
    want = jnp.tanh(jax.ops.segment_sum(
        jax_message(x[recv], x[send], None), recv, 100) @ w)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_slots_refuse_mixed_device_types():
    with pytest.raises(ValueError, match="mix device types"):
        tgp.Slots(["cpu", "meta"])


def test_graph_parallel_modules_import_no_jax():
    """graph_parallel, composite and the pipe x data trainer load
    neither jax nor the JAX package."""
    import os
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.'); "
            "import hydragnn_tpu_torch.parallel.graph_parallel, "
            "hydragnn_tpu_torch.parallel.composite, "
            "hydragnn_tpu_torch.parallel.pipeline_trainer; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) "
            "or m == 'hydragnn_tpu' or m.startswith('hydragnn_tpu.')]; "
            "print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
