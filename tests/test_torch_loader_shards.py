"""The port's loader with stacked shards (`GraphDataLoader(num_shards=M)`,
the pipeline's microbatches) against the JAX package's: for M = 2, 4 and
8, fixed shape, shuffled epochs and an unshuffled tail whose last shards
are partly or wholly padding, every field of every batch bitwise; and
`create_dataloaders(num_shards=M)`'s shared shape."""
import numpy as np
import pytest
import torch

from hydragnn_tpu.datasets.loader import GraphDataLoader as JLoader
from hydragnn_tpu.preprocess import load_data as jload
from hydragnn_tpu_torch.datasets.loader import (GraphDataLoader,
                                                stack_batches,
                                                unstack_batch)
from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
from tests.test_torch_train import to_jax_samples

torch.set_num_threads(1)

FIELDS = ("x", "pos", "senders", "receivers", "node_graph", "node_mask",
          "edge_mask", "graph_mask", "y_graph", "nbr", "nbr_edge",
          "nbr_mask")


def _samples(n=45):
    return synthetic_molecules(n, seed=4, min_atoms=3, max_atoms=12,
                               num_features=4)


def _same(tb, jb):
    for field in FIELDS:
        a, b = getattr(tb, field), getattr(jb, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, field
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), field)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("neighbor_format", [True, False])
def test_stacked_shards_match_jax_bitwise(shards, neighbor_format):
    samples = _samples()
    jsamples = to_jax_samples(samples)
    for shuffle in (True, False):
        port = GraphDataLoader(samples, 8, shuffle=shuffle, seed=3,
                               neighbor_format=neighbor_format,
                               num_shards=shards)
        ref = JLoader(jsamples, 8, shuffle=shuffle, seed=3,
                      neighbor_format=neighbor_format, async_workers=0,
                      num_shards=shards)
        assert (port.n_node, port.n_edge, port.n_graph, port.neighbor_k,
                port.graphs_per_shard) == (ref.n_node, ref.n_edge,
                                           ref.n_graph, ref.neighbor_k,
                                           ref.graphs_per_shard)
        assert len(port) == len(ref)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            pairs = list(zip(port, ref))
            assert len(pairs) == len(port)
            for tb, jb in pairs:
                assert tb.x.shape[0] == shards
                _same(tb, jb)
        if not shuffle:
            # the tail: 45 = 5 x 8 + 5 graphs, so its last shards hold
            # fewer graphs or none
            last = list(port)[-1]
            real = last.graph_mask.sum(1).tolist()
            assert sum(real) == 5 and real[-1] < port.graphs_per_shard
        assert port.padding_stats() == pytest.approx(ref.padding_stats())


def test_stack_and_unstack_are_inverse():
    samples = _samples(16)
    loader = GraphDataLoader(samples, 8, num_shards=4)
    batch = next(iter(loader))
    parts = unstack_batch(batch)
    assert len(parts) == 4
    again = stack_batches(parts)
    for field in FIELDS:
        a, b = getattr(batch, field), getattr(again, field)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    one = GraphDataLoader(samples, 8)
    b1 = next(iter(one))
    assert unstack_batch(b1)[0] is b1


def test_create_dataloaders_num_shards_matches_jax():
    samples = _samples()
    jsamples = to_jax_samples(samples)
    tr, va, te = samples[:30], samples[30:38], samples[38:]
    jtr, jva, jte = jsamples[:30], jsamples[30:38], jsamples[38:]
    port = create_dataloaders(tr, va, te, 8, neighbor_format=True,
                              num_shards=4)
    ref = jload.create_dataloaders(jtr, jva, jte, 8, num_shards=4,
                                   neighbor_format=True, async_workers=0)
    for p, r in zip(port, ref):
        assert (p.n_node, p.n_edge, p.n_graph, p.neighbor_k) == \
            (r.n_node, r.n_edge, r.n_graph, r.neighbor_k)
        for tb, jb in zip(p, r):
            _same(tb, jb)


def test_uneven_shards_raise():
    with pytest.raises(ValueError, match="divide evenly"):
        GraphDataLoader(_samples(8), 6, num_shards=4)
