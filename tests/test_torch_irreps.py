"""The port's irreps algebra (ops/irreps.py) against the JAX package's on
the CPU: the complex-to-real change of basis and the real Clebsch-Gordan
tables bitwise; the real spherical harmonics (l <= 4) within rtol 1e-5
and their component normalization; the channel-wise tensor product
(weighted and not), `norm_per_l` and the output keys the MACE stack
sizes its layers by; the rotation equivariance of the harmonics and of
the product, as tests/test_irreps.py proves the JAX algebra's.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.ops import irreps as jir
from hydragnn_tpu_torch.ops import irreps as tir

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
TRIPLES = [(l1, l2, l3) for l1, l2 in itertools.product(range(4), repeat=2)
           for l3 in range(abs(l1 - l2), l1 + l2 + 1)]


def _rotation(seed):
    from scipy.spatial.transform import Rotation
    return Rotation.random(random_state=seed).as_matrix()


@pytest.mark.parametrize("l", range(5))
def test_complex_to_real_bitwise(l):
    np.testing.assert_array_equal(tir._complex_to_real(l),
                                  jir._complex_to_real(l))


@pytest.mark.parametrize("l1,l2,l3", TRIPLES,
                         ids=[f"{a}{b}{c}" for a, b, c in TRIPLES])
def test_clebsch_gordan_bitwise(l1, l2, l3):
    got = tir.clebsch_gordan(l1, l2, l3)
    want = jir.clebsch_gordan(l1, l2, l3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tir.cg_nonzero(l1, l2, l3) == bool(np.abs(want).max() != 0.0)


@pytest.mark.parametrize("normalize", [True, False])
def test_real_spherical_harmonics_match_jax(normalize):
    """l <= 4 on random vectors (unit ones without `normalize`), with
    the component normalization sum_m Y_lm² = 2l + 1."""
    rng = np.random.RandomState(0)
    v = rng.randn(300, 3).astype(np.float32)
    if not normalize:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    got = tir.real_spherical_harmonics(torch.from_numpy(v), 4,
                                       normalize=normalize)
    want = jir.real_spherical_harmonics(jnp.asarray(v), 4,
                                        normalize=normalize)
    assert sorted(got) == list(range(5))
    for l in range(5):
        assert got[l].shape == (300, 2 * l + 1)
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]),
                                   err_msg=f"l={l}", **TOL)
        np.testing.assert_allclose(np.sum(got[l].numpy() ** 2, axis=1),
                                   2 * l + 1, rtol=1e-4)
    with pytest.raises(ValueError, match="lmax 7"):
        tir.real_spherical_harmonics(torch.from_numpy(v), 7)


def _features(rng, ls, n=20, mul=4):
    return {l: rng.randn(n, mul, 2 * l + 1).astype(np.float32) for l in ls}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lmax_out", [0, 1, 2])
def test_tensor_product_matches_jax(lmax_out, weighted):
    """a {0, 1, 2} x b {0, 1, 2} (b broadcast over the channels, as
    MACE's harmonics are), each path weighted per channel or not; the
    output keys in walking order, as `tp_output_ls` predicts."""
    rng = np.random.RandomState(lmax_out)
    a = _features(rng, (0, 1, 2))
    b = {l: f[:, :1] for l, f in _features(rng, (0, 1, 2)).items()}
    paths = tir.tp_paths([0, 1, 2], [0, 1, 2], lmax_out)
    w = ({p: rng.randn(20, 4).astype(np.float32) for p in paths}
         if weighted else None)
    got = tir.tensor_product(
        {l: torch.from_numpy(f) for l, f in a.items()},
        {l: torch.from_numpy(f) for l, f in b.items()}, lmax_out,
        None if w is None else {p: torch.from_numpy(x) for p, x in w.items()})
    want = jir.tensor_product(
        {l: jnp.asarray(f) for l, f in a.items()},
        {l: jnp.asarray(f) for l, f in b.items()}, lmax_out,
        None if w is None else {p: jnp.asarray(x) for p, x in w.items()})
    assert list(got) == list(want) == tir.tp_output_ls([0, 1, 2], [0, 1, 2],
                                                       lmax_out)
    for l in want:
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]),
                                   err_msg=f"l={l}", **TOL)
    np.testing.assert_allclose(tir.norm_per_l(got).numpy(),
                               np.asarray(jir.norm_per_l(want)), **TOL)
    np.testing.assert_array_equal(tir.scalar_part(got).numpy(),
                                  got[0].numpy()[..., 0])


def _wigner_d(l, r, seed=0):
    """D_l(R) recovered from Y_l(R v) = D_l(R) Y_l(v) on 50 directions."""
    v = np.random.RandomState(seed).randn(50, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    y = tir.real_spherical_harmonics(torch.from_numpy(v), l)[l].numpy()
    yr = tir.real_spherical_harmonics(torch.from_numpy(v @ r.T),
                                      l)[l].numpy()
    d, *_ = np.linalg.lstsq(y, yr, rcond=None)
    return d.T


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 0), (1, 1, 1), (1, 1, 2),
                                      (2, 1, 1), (2, 2, 2)],
                         ids=["110", "111", "112", "211", "222"])
def test_tensor_product_is_equivariant(l1, l2, l3):
    """TP(D a, D b) = D TP(a, b) for a random rotation, on float64
    features (the harmonics' Wigner matrices are orthogonal)."""
    r = _rotation(3)
    d1, d2, d3 = (_wigner_d(l, r) for l in (l1, l2, l3))
    for d, l in ((d1, l1), (d2, l2), (d3, l3)):
        np.testing.assert_allclose(d @ d.T, np.eye(2 * l + 1), atol=1e-8)
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(5, 3, 2 * l1 + 1))
    b = torch.from_numpy(rng.randn(5, 3, 2 * l2 + 1))
    out = tir.tensor_product({l1: a}, {l2: b}, l3)
    rot = tir.tensor_product({l1: a @ torch.from_numpy(d1.T)},
                             {l2: b @ torch.from_numpy(d2.T)}, l3)
    np.testing.assert_allclose(rot[l3].numpy(), out[l3].numpy() @ d3.T,
                               atol=1e-5)
