"""The port's radial bases (ops/basis.py: EGNN's `sinc_expansion` and
`cosine_cutoff`, PNAPlus's `envelope` and `bessel_basis`) and segment ops
(ops/segment.py: `neighbor_softmax`, `segment_softmax`, `segment_std`)
against the JAX package's, values and gradients, on the CPU.

Bound: rtol 1e-4 / atol 1e-5 (TRAIN_TOL), on values and on the gradient
of a random projection of each output. The inputs are made from a numpy
seed; the distances include 0 (a padding edge's length floors at 1e-9 in
the sinc) and lengths beyond the cutoff. The softmaxes take masked rows,
a row or a segment whose entries are all masked, an empty segment and
tied maxima: an all-masked row gives 0 and a finite gradient, and
`segment_softmax`'s gradient through the segment maximum, which the JAX
package does not stop, is shared among the tied rows as JAX shares it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.ops import basis as jbasis
from hydragnn_tpu.ops import segment as jseg
from hydragnn_tpu_torch.ops import basis as tbasis
from hydragnn_tpu_torch.ops import segment as tseg

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)


def _value_and_grad(jfn, tfn, *arrays, proj_seed=0):
    """(port value, JAX value, port gradients, JAX gradients) of
    sum(f(*arrays) * c) with respect to the float arrays, c a random
    projection; non-float arrays pass through."""
    want = np.asarray(jfn(*[jnp.asarray(a) for a in arrays]))
    c = np.random.RandomState(proj_seed).randn(*want.shape).astype(
        np.float32)
    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]

    def jloss(*fl):
        args = [jnp.asarray(a) for a in arrays]
        for i, f in zip(floats, fl):
            args[i] = f
        return jnp.sum(jfn(*args) * c)
    jgrads = jax.grad(jloss, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(arrays[i]) for i in floats])
    targs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in floats:
        targs[i].requires_grad_(True)
    got = tfn(*targs)
    tgrads = torch.autograd.grad(torch.sum(got * torch.from_numpy(c)),
                                 [targs[i] for i in floats])
    return (got.detach().numpy(), want, [g.numpy() for g in tgrads],
            [np.asarray(g) for g in jgrads])


def _hold(got, want, tgrads, jgrads, tol=TRAIN_TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    for g, w in zip(tgrads, jgrads):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **tol)


def _distances(seed, cutoff):
    rng = np.random.RandomState(seed)
    d = rng.rand(200).astype(np.float32) * 1.3 * cutoff
    d[:3] = [0.0, cutoff, 1.5 * cutoff]
    return d


@pytest.mark.parametrize("cutoff", [1.8, 5.0])
@pytest.mark.parametrize("num", [6, 16])
def test_sinc_expansion_matches_jax(cutoff, num):
    d = _distances(1, cutoff)
    _hold(*_value_and_grad(
        lambda x: jbasis.sinc_expansion(x, cutoff, num),
        lambda x: tbasis.sinc_expansion(x, cutoff, num), d))


@pytest.mark.parametrize("cutoff", [1.8, 5.0])
def test_cosine_cutoff_matches_jax(cutoff):
    d = _distances(2, cutoff)
    got, want, tg, jg = _value_and_grad(
        lambda x: jbasis.cosine_cutoff(x, cutoff),
        lambda x: tbasis.cosine_cutoff(x, cutoff), d)
    _hold(got, want, tg, jg)
    assert got[1] == got[2] == 0.0          # at and beyond the cutoff


@pytest.mark.parametrize("exponent", [3, 5])
def test_envelope_matches_jax(exponent):
    x = (_distances(3, 1.0) * 0.75).clip(0.05, 1.0)
    _hold(*_value_and_grad(
        lambda v: jbasis.envelope(v, exponent),
        lambda v: tbasis.envelope(v, exponent), x))


def test_integer_pow_is_lax_integer_pow():
    x = np.random.RandomState(4).rand(64).astype(np.float32) + 0.5
    for n in range(1, 9):
        np.testing.assert_array_equal(
            tbasis.integer_pow(torch.from_numpy(x), n).numpy(),
            np.asarray(jax.lax.integer_pow(jnp.asarray(x), n)))


@pytest.mark.parametrize("num_radial,exponent", [(6, 5), (8, 3)])
def test_bessel_basis_matches_jax(num_radial, exponent):
    d = _distances(5, 1.8).clip(0.05, None)
    _hold(*_value_and_grad(
        lambda x: jbasis.bessel_basis(x, 1.8, num_radial, exponent),
        lambda x: tbasis.bessel_basis(x, 1.8, num_radial, exponent), d))


def _nbr_case(seed, heads):
    rng = np.random.RandomState(seed)
    n, k = 12, 5
    shape = (n, k) if heads is None else (n, k, heads)
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    mask = rng.rand(n, k) < 0.7
    mask[0] = False                          # an all-masked row
    mask[1] = True
    logits[2, :2] = 1.5                      # a tied maximum
    mask[2, :2] = True
    return logits, mask


@pytest.mark.parametrize("heads", [None, 3])
def test_neighbor_softmax_matches_jax(heads):
    logits, mask = _nbr_case(6, heads)
    got, want, tg, jg = _value_and_grad(jseg.neighbor_softmax,
                                        tseg.neighbor_softmax, logits, mask)
    _hold(got, want, tg, jg)
    assert (got[0] == 0).all() and (tg[0][0] == 0).all()
    sums = got.sum(axis=1)[1:]
    np.testing.assert_allclose(sums, np.ones_like(sums), rtol=1e-6)


def _segment_case(seed, heads):
    rng = np.random.RandomState(seed)
    e, n = 40, 9
    ids = rng.randint(0, n - 1, e).astype(np.int32)   # segment n-1 empty
    shape = (e,) if heads is None else (e, heads)
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    mask = rng.rand(e) < 0.8
    mask[ids == 0] = False                    # a segment all masked
    tied = np.nonzero((ids == 1) & mask)[0]
    logits[tied[:2]] = 2.5                    # a tied maximum
    logits[tied[2:]] = np.minimum(logits[tied[2:]], 2.0)
    return logits, ids, n, mask


@pytest.mark.parametrize("heads", [None, 4])
def test_segment_softmax_matches_jax(heads):
    logits, ids, n, mask = _segment_case(7, heads)
    got, want, tg, jg = _value_and_grad(
        lambda lg, m: jseg.segment_softmax(lg, jnp.asarray(ids), n, m),
        lambda lg, m: tseg.segment_softmax(lg, torch.from_numpy(ids), n, m),
        logits, mask)
    _hold(got, want, tg, jg)
    assert (got[~mask] == 0).all()
    sums = np.zeros((n,) + got.shape[1:], np.float32)
    np.add.at(sums, ids, got)
    live = np.unique(ids[mask])
    np.testing.assert_allclose(sums[live], np.ones_like(sums[live]),
                               rtol=1e-5)


@pytest.mark.parametrize("f", [1, 6])
def test_segment_std_matches_jax(f):
    rng = np.random.RandomState(8)
    e, n = 50, 10
    ids = rng.randint(0, n, e).astype(np.int32)
    data = rng.randn(e, f).astype(np.float32)
    mask = rng.rand(e) < 0.8
    data[ids == 3] = 0.25                     # a constant segment
    _hold(*_value_and_grad(
        lambda x, m: jseg.segment_std(x, jnp.asarray(ids), n, m),
        lambda x, m: tseg.segment_std(x, torch.from_numpy(ids), n, m),
        data, mask))
