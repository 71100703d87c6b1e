"""Host-side batching and config completion of the port
(hydragnn_tpu_torch) against the JAX package: bitwise on the same inputs.
"""
import copy
import dataclasses
import json

import numpy as np
import pytest

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.graphs import packing as jpacking
from hydragnn_tpu.graphs.radius import radius_graph_pbc as j_radius_graph_pbc
from hydragnn_tpu.serving import engine as jengine
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs import packing as tpacking
from hydragnn_tpu_torch.graphs.radius import radius_graph_pbc
from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                 synthetic_molecules)
from hydragnn_tpu_torch.serving import engine as tengine

CSCE = "examples/csce/csce_gap.json"

_BATCH_FIELDS = ("x", "pos", "senders", "receivers", "node_graph",
                 "node_mask", "edge_mask", "graph_mask", "y_graph", "y_node",
                 "edge_attr", "nbr", "nbr_edge", "nbr_mask")


def to_jax_samples(samples):
    return [jbatch.GraphSample(x=s.x, pos=s.pos, senders=s.senders,
                               receivers=s.receivers, y_graph=s.y_graph,
                               y_node=s.y_node, edge_attr=s.edge_attr)
            for s in samples]


def assert_batches_equal(tb, jb):
    for name in _BATCH_FIELDS:
        t, j = getattr(tb, name), getattr(jb, name)
        assert (t is None) == (j is None), name
        if t is not None:
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype, name
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.fixture(scope="module")
def molecules():
    return synthetic_molecules(24, seed=7, min_atoms=3, max_atoms=12)


def test_synthetic_molecules_are_deterministic_and_bounded():
    a = synthetic_molecules(40, seed=3)
    b = synthetic_molecules(40, seed=3)
    for s, t in zip(a, b):
        np.testing.assert_array_equal(s.x, t.x)
        np.testing.assert_array_equal(s.senders, t.senders)
        np.testing.assert_array_equal(s.receivers, t.receivers)
        assert 10 <= s.num_nodes <= 60
        assert np.bincount(s.receivers, minlength=s.num_nodes).max() <= 20
    assert any(np.bincount(s.receivers, minlength=s.num_nodes).min() == 0
               for s in a)


@pytest.mark.parametrize("shape", [None, (200, 900, 9)])
def test_collate_bitwise(molecules, shape):
    js = to_jax_samples(molecules[:8])
    kw = {} if shape is None else dict(n_node=shape[0], n_edge=shape[1],
                                       n_graph=shape[2])
    tb = tbatch.collate(molecules[:8], **kw)
    jb = jbatch.collate(js, np_out=True, **kw)
    assert_batches_equal(tb, jb)


@pytest.mark.parametrize("k", [None, 16])
def test_neighbor_format_bitwise(molecules, k):
    tb = tbatch.with_neighbor_format(tbatch.collate(molecules), k=k)
    jb = jbatch.with_neighbor_format(
        jbatch.collate(to_jax_samples(molecules), np_out=True), k=k)
    assert_batches_equal(tb, jb)
    direct = tbatch.build_neighbor_tables(
        tb.senders.numpy(), tb.receivers.numpy(), tb.edge_mask.numpy(),
        tb.num_nodes, tb.num_edges, k=k)
    jdirect = jbatch.build_neighbor_tables(
        tb.senders.numpy(), tb.receivers.numpy(), tb.edge_mask.numpy(),
        tb.num_nodes, tb.num_edges, k=k)
    for a, b in zip(direct, jdirect):
        np.testing.assert_array_equal(a, b)


def test_neighbor_budget_and_bucket_spec_bitwise(molecules):
    big = synthetic_molecules(30, seed=1)
    for samples in (molecules, big):
        assert tbatch.neighbor_budget_for_dataset(samples) == \
            jbatch.neighbor_budget_for_dataset(to_jax_samples(samples))
    for mult in (8, 64):
        t, j = tbatch.BucketSpec(mult), jbatch.BucketSpec(mult)
        for n in (1, 7, 64, 65, 97, 129, 1000, 4097, 77777):
            assert t.bucket(n) == j.bucket(n)
            assert t.shapes(n, 3 * n, 5) == j.shapes(n, 3 * n, 5)


def test_choose_budget_and_bucket_ladder_bitwise():
    mols = synthetic_molecules(50, seed=2)
    nodes, edges = tpacking.sample_sizes(mols)
    jn, je = jpacking.sample_sizes(to_jax_samples(mols))
    np.testing.assert_array_equal(nodes, jn)
    np.testing.assert_array_equal(edges, je)
    for g in (1, 4, 32, 128):
        assert dataclasses.asdict(tpacking.choose_budget(nodes, edges, g)) \
            == dataclasses.asdict(jpacking.choose_budget(nodes, edges, g))
    for mbs, nb in ((32, 0), (128, 0), (128, 3), (5, 0)):
        t = tengine.bucket_ladder(nodes, edges, mbs, nb)
        j = jengine.bucket_ladder(nodes, edges, mbs, nb)
        assert [dataclasses.asdict(b) for b in t] == \
            [dataclasses.asdict(b) for b in j]
        for count, n, e in ((1, 10, 30), (3, 120, 900), (40, 900, 9000)):
            bt = tengine.select_bucket(t, count, n, e)
            bj = jengine.select_bucket(j, count, n, e)
            assert (None if bt is None else dataclasses.asdict(bt)) == \
                (None if bj is None else dataclasses.asdict(bj))


def test_gather_deg_update_and_build_model_config_bitwise():
    mols = synthetic_molecules(30, seed=4)
    jm = to_jax_samples(mols)
    np.testing.assert_array_equal(tcfg.gather_deg(mols), jcfg.gather_deg(jm))
    with open(CSCE) as f:
        base = json.load(f)
    tc = tcfg.update_config(copy.deepcopy(base), mols[:20], mols[20:25],
                            mols[25:])
    jc = jcfg.update_config(copy.deepcopy(base), jm[:20], jm[20:25], jm[25:])
    assert tc == jc
    arch = tc["NeuralNetwork"]["Architecture"]
    assert arch["max_neighbours"] == len(arch["pna_deg"]) - 1 <= 20
    assert dataclasses.asdict(tcfg.build_model_config(tc)) == \
        dataclasses.asdict(jcfg.build_model_config(jc))


def test_update_config_node_head_and_dtype_spellings():
    mols = synthetic_molecules(6, seed=5, min_atoms=4, max_atoms=4)
    for s in mols:
        s.y_node = np.ones((s.num_nodes, 2), np.float32)
    cfg = {"NeuralNetwork": {
        "Architecture": {"model_type": "PNA", "hidden_dim": 8,
                         "num_conv_layers": 2, "dtype": "float32",
                         "activation_function": "gelu",
                         "output_heads": {"node": {"num_headlayers": 1,
                                                   "dim_headlayers": [4],
                                                   "type": "mlp"}}},
        "Variables_of_interest": {"input_node_features": [0, 1],
                                  "output_index": [0], "type": ["node"],
                                  "output_dim": [2]},
        "Training": {"batch_size": 2}}}
    tc = tcfg.update_config(copy.deepcopy(cfg), mols)
    jc = jcfg.update_config(copy.deepcopy(cfg), to_jax_samples(mols))
    assert tc == jc
    assert dataclasses.asdict(tcfg.build_model_config(tc)) == \
        dataclasses.asdict(jcfg.build_model_config(jc))
    # the bf16 spellings and a dtype the port does not compute in
    # (float16) resolve as in the JAX package; float16 is refused, naming
    # its ROADMAP item, where a step would compute in it (C12)
    for dtype in ("bf16", "bfloat16", "BF16", "f32", "float16"):
        tc["NeuralNetwork"]["Architecture"]["dtype"] = dtype
        jc["NeuralNetwork"]["Architecture"]["dtype"] = dtype
        assert tcfg.build_model_config(tc).dtype == \
            jcfg.build_model_config(jc).dtype
    from hydragnn_tpu_torch.train.precision import (check_ported_precision,
                                                    resolve_precision)
    with pytest.raises(NotImplementedError, match="A5"):
        check_ported_precision(resolve_precision(
            tcfg.build_model_config(tc).dtype))


@pytest.mark.parametrize("max_neighbours", [None, 7, 40])
def test_radius_graph_pbc_bitwise(max_neighbours):
    """A small triclinic cell whose lattice planes lie closer than the
    cutoff, so several images of one atom (itself included) are
    neighbours and the cap's (d², sender, shift id) tie-break decides;
    plus an LJ-sized cubic cell, and a slab periodic in two axes."""
    rng = np.random.RandomState(3)
    cases = [
        (rng.rand(5, 3) * 1.4, np.array([[1.5, 0.0, 0.0], [0.3, 1.4, 0.0],
                                         [0.2, 0.1, 1.6]]), 2.0,
         (True, True, True)),
        (rng.rand(27, 3) * 3.6, np.eye(3) * 3.6, 2.0, (True, True, True)),
        (rng.rand(12, 3) * 2.0, np.eye(3) * 2.0, 1.7, (True, False, True)),
    ]
    # an exact tie: two atoms on a lattice, their images equidistant
    cases.append((np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                  np.eye(3), 1.0, (True, True, True)))
    for i, (pos, cell, r, pbc) in enumerate(cases):
        got = radius_graph_pbc(pos, cell, r, pbc, max_neighbours)
        want = j_radius_graph_pbc(pos, cell, r, pbc, max_neighbours)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        send, recv, _ = got
        if max_neighbours is None and i in (0, 3):  # self images
            assert np.any(send == recv)
        if max_neighbours is not None:
            assert np.bincount(recv).max() <= max_neighbours


def test_lj_configurations_bitwise():
    import sys
    sys.path.insert(0, ".")
    from examples.LennardJones.lj_data import generate_lj_dataset
    for kw in ({}, {"seed": 3, "normalize": False, "atoms_per_dim": 2}):
        got = lj_configurations(8, **kw)
        want = generate_lj_dataset(8, **kw)
        for s, t in zip(got, want):
            for name in ("x", "pos", "senders", "receivers", "edge_shifts",
                         "cell", "y_node", "energy", "forces"):
                a, b = getattr(s, name), getattr(t, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    # about 20 in-edges per atom at the defaults (27 atoms, cutoff 2.0)
    assert 15 < got[0].num_edges / got[0].num_nodes < 25 or kw
