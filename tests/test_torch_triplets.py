"""The port's host-side DimeNet data and bases against the JAX package's
on the CPU: the triplet tables (graphs/triplets.py) and the loaders'
`batch_transform` hook, bitwise; the spherical Bessel zeros and the
basis' normalizers, bitwise; `spherical_basis`, `spherical_jn` and
`legendre` within rtol 1e-5; MACE's radial bases and distance transforms
(ops/basis.py) within rtol 1e-5; and the BCC lattice copy
(graphs/synthetic.py `bcc_lattices`) against tests/deterministic_data.py,
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.datasets.loader import GraphDataLoader as JLoader
from hydragnn_tpu.graphs import triplets as jtrip
from hydragnn_tpu.ops import basis as jbasis
from hydragnn_tpu.ops import spherical as jsph
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs import triplets as ttrip
from hydragnn_tpu_torch.graphs.synthetic import (bcc_lattices,
                                                 lj_configurations,
                                                 synthetic_molecules)
from hydragnn_tpu_torch.ops import basis as tbasis
from hydragnn_tpu_torch.ops import spherical as tsph
from tests.test_torch_invariant_convs import FIELDS, jax_samples
from tests.test_torch_train import _jax_view

torch.set_num_threads(1)

TRIPLET_FIELDS = ("idx_kj", "idx_ji", "triplet_mask")
BASIS_TOL = dict(rtol=1e-5, atol=1e-6)


def datasets():
    """Molecules (open, some isolated atoms) and periodic LJ cells (a
    27-atom cube under a 2.0 cutoff: several images of one neighbour)."""
    return {"molecules": synthetic_molecules(10, seed=2, min_atoms=3,
                                             max_atoms=12, num_features=3),
            "lj": lj_configurations(5, seed=4)}


def assert_tables_equal(tb, jb):
    for f in TRIPLET_FIELDS:
        a, b = getattr(tb, f), getattr(jb, f)
        assert a is not None and b is not None, f
        assert a.numpy().dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)


@pytest.mark.parametrize("data", ["molecules", "lj"])
def test_counts_and_budget_match_jax(data):
    samples = datasets()[data]
    for s in samples:
        assert ttrip.count_triplets(s.senders, s.receivers) == \
            jtrip.count_triplets(s.senders, s.receivers)
        kj, ji = ttrip.sample_triplets(s.senders, s.receivers)
        jkj, jji = jtrip.sample_triplets(s.senders, s.receivers)
        np.testing.assert_array_equal(kj, jkj)
        np.testing.assert_array_equal(ji, jji)
    for g in (1, 4):
        assert ttrip.triplet_budget(samples, g) == \
            jtrip.triplet_budget(jax_samples(samples), g)


@pytest.mark.parametrize("with_samples", [True, False],
                         ids=["cached", "enumerated"])
@pytest.mark.parametrize("data", ["molecules", "lj"])
def test_triplet_tables_match_jax_bitwise(data, with_samples):
    """TripletTransform from the samples' cached tables and from the
    batch's edges (`add_triplets`): idx_kj, idx_ji and the mask bitwise,
    the padding triplets at the padding edge, every other field kept."""
    samples = datasets()[data]
    tb = tbatch.collate(samples)
    jb = _jax_view(tb)
    tt = ttrip.make_triplet_transform(samples, len(samples))
    jt = jtrip.make_triplet_transform(jax_samples(samples), len(samples))
    assert tt.budget == jt.budget
    if with_samples:
        got, want = tt(tb, samples), jt(jb, jax_samples(samples))
    else:
        got, want = tt(tb), jt(jb)
    assert_tables_equal(got, want)
    t = int(got.triplet_mask.sum())
    assert 0 < t < tt.budget
    assert (got.idx_kj[t:] == tb.num_edges - 1).all()
    assert (got.idx_ji[t:] == tb.num_edges - 1).all()
    for f in ("x", "pos", "senders", "receivers", "edge_mask"):
        assert torch.equal(getattr(got, f), getattr(tb, f)), f
    # the enumeration of the batch and the cached per-sample tables agree
    again = tt(tb) if with_samples else tt(tb, samples)
    assert_tables_equal(again, want)
    with pytest.raises(ValueError, match="exceeds budget"):
        ttrip.add_triplets(tb, t - 1)


@pytest.mark.parametrize("neighbor_format", [True, False],
                         ids=["dense", "edge"])
def test_loader_batch_transform_matches_jax_bitwise(neighbor_format):
    """The loaders with DimeNet's transform: shuffled batches over two
    epochs and the replayed unshuffled ones, every field bitwise (the
    neighbour tables built after the transform)."""
    samples = datasets()["lj"] + lj_configurations(6, seed=5)
    jsamples = jax_samples(samples)
    for shuffle in (True, False):
        port = GraphDataLoader(
            samples, 4, shuffle=shuffle, seed=3,
            neighbor_format=neighbor_format,
            batch_transform=ttrip.make_triplet_transform(samples, 4))
        ref = JLoader(jsamples, 4, shuffle=shuffle, seed=3,
                      neighbor_format=neighbor_format, async_workers=0,
                      batch_transform=jtrip.make_triplet_transform(
                          jsamples, 4))
        assert len(port) == len(ref)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            for tb, jb in zip(port, ref):
                assert_tables_equal(tb, jb)
                for f in ("senders", "receivers", "edge_mask", "nbr_edge",
                          "nbr_mask"):
                    a, b = getattr(tb, f), getattr(jb, f)
                    assert (a is None) == (b is None), f
                    if a is not None:
                        np.testing.assert_array_equal(a.numpy(),
                                                      np.asarray(b), f)


def test_maybe_triplet_transform_is_dimenet_only():
    samples = datasets()["lj"]
    assert ttrip.maybe_triplet_transform("PAINN", samples, 4) is None
    got = ttrip.maybe_triplet_transform("DimeNet", samples, 4)
    assert got.budget == jtrip.maybe_triplet_transform(
        "DimeNet", jax_samples(samples), 4).budget


def test_spherical_bessel_zeros_and_norms_bitwise():
    """The host tables the basis reads: zeros of j_l (brentq) and their
    normalizers 1 / |j_{l+1}(z)|, at LJ.json's (4, 8) and the test
    configs' (7, 6)."""
    from scipy import special
    for key in ((4, 8), (7, 6)):
        zeros = tsph.spherical_bessel_zeros(*key)
        np.testing.assert_array_equal(zeros, jsph.spherical_bessel_zeros(*key))
        want = np.stack([1.0 / np.abs(special.spherical_jn(l + 1, zeros[l]))
                         for l in range(key[0])])
        np.testing.assert_array_equal(tsph.spherical_norms(*key), want)
        for l in range(key[0]):
            assert np.abs(special.spherical_jn(l, zeros[l])).max() < 1e-9


def test_spherical_jn_and_legendre_match_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(0.5, 30.0, 200), [1e-9, 1e-3, 0.1]]
                       ).astype(np.float32)
    got = tsph.spherical_jn(4, torch.from_numpy(x))
    want = jsph.spherical_jn(4, jnp.asarray(x))
    for l, (g, w) in enumerate(zip(got, want)):
        keep = x >= 0.5            # the recurrence is ill-conditioned below
        np.testing.assert_allclose(g.numpy()[keep], np.asarray(w)[keep],
                                   err_msg=f"j_{l}", **BASIS_TOL)
        assert np.isfinite(g.numpy()).all()
    c = rng.uniform(-1, 1, 300).astype(np.float32)
    for l, (g, w) in enumerate(zip(tsph.legendre(6, torch.from_numpy(c)),
                                   jsph.legendre(6, jnp.asarray(c)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"P_{l}", **BASIS_TOL)


@pytest.mark.parametrize("key", [(4, 8), (7, 6)], ids=["LJ", "test"])
def test_spherical_basis_matches_jax(key):
    """sbf on the k->j lengths (0.8..2.0 of a 2.0 cutoff) and angles
    (0..pi) of random triplets."""
    rng = np.random.RandomState(1)
    d = rng.uniform(0.8, 2.0, 500).astype(np.float32)
    angle = rng.uniform(0.0, np.pi, 500).astype(np.float32)
    got = tsph.spherical_basis(torch.from_numpy(d), torch.from_numpy(angle),
                               2.0, *key, envelope_exponent=5)
    want = jsph.spherical_basis(jnp.asarray(d), jnp.asarray(angle), 2.0,
                                *key, envelope_exponent=5)
    assert got.shape == (500, key[0] * key[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BASIS_TOL)


@pytest.mark.parametrize("name", ["bessel", "gaussian", "chebyshev"])
def test_mace_radial_bases_match_jax(name):
    rng = np.random.RandomState(2)
    d = np.concatenate([rng.uniform(0.0, 2.5, 400), [0.0, 2.0]]
                       ).astype(np.float32)
    got = tbasis.RADIAL_BASES[name](torch.from_numpy(d), 2.0, 8)
    want = jbasis.RADIAL_BASES[name](jnp.asarray(d), 2.0, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BASIS_TOL)
    cut = tbasis.polynomial_cutoff(torch.from_numpy(d), 2.0)
    np.testing.assert_allclose(
        cut.numpy(), np.asarray(jbasis.polynomial_cutoff(jnp.asarray(d),
                                                         2.0)), **BASIS_TOL)
    assert float(cut[d >= 2.0].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["None", "Agnesi", "Soft"])
def test_mace_distance_transforms_match_jax(name):
    d = np.random.RandomState(3).uniform(0.05, 3.0, 400).astype(np.float32)
    got = tbasis.DISTANCE_TRANSFORMS[name](torch.from_numpy(d))
    want = jbasis.DISTANCE_TRANSFORMS[name](jnp.asarray(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BASIS_TOL)


@pytest.mark.parametrize("heads", [("graph",), ("node", "node")],
                         ids=["graph", "node-node"])
def test_bcc_lattices_match_deterministic_data_bitwise(heads):
    """graphs/synthetic.py's copy of the threshold rows' lattice: every
    field and dtype of tests/deterministic_data.py's samples."""
    from tests.deterministic_data import deterministic_graph_dataset
    want = deterministic_graph_dataset(num_configs=40, seed=6, heads=heads)
    got = bcc_lattices(40, seed=6, heads=heads)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, f)
