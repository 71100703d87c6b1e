"""The irreps algebra of MACE (counterpart: hydragnn_tpu/ops/irreps.py).

Features of angular momentum l are [N, mul, 2l + 1] tensors in a dict
keyed by l. Real spherical harmonics use the "component" normalization
(sum_m Y_lm² = 2l + 1 on the unit sphere), m ordered -l..l (l = 1 is
(y, z, x)), no Condon-Shortley phase. The real Clebsch-Gordan tensors are
host numpy, derived once a process from sympy's complex coefficients by
the complex-to-real change of basis (bitwise the JAX package's tables),
and copied to a device once (`ops.scalars.device_constant`).
"""
from __future__ import annotations

import functools
from math import factorial, sqrt
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .scalars import device_constant, weak

# beyond l = 6 the tensor-product path count explodes and float32 CG
# precision degrades: a guard rail, as in the JAX package
LMAX_SUPPORTED = 6

IrrepsDict = Dict[int, torch.Tensor]  # {l: [..., mul, 2l+1]}


def real_spherical_harmonics(vec, lmax: int, normalize: bool = True,
                             eps: float = 1e-9) -> IrrepsDict:
    """vec [..., 3] -> {l: [..., 2l+1]} for l = 0..lmax:
    Y_lm = N_lm q_l^|m|(z) {B_|m|, A_|m|}(x, y), with A_m + i B_m =
    (x + i y)^m, q_l^m(z) = P_l^m(z) / (1 - z²)^(m/2) by the standard
    recurrences, N_lm = sqrt((2l+1) (l-|m|)! / (l+|m|)!) (times sqrt 2
    for m != 0)."""
    if lmax > LMAX_SUPPORTED:
        raise ValueError(
            f"lmax {lmax} > {LMAX_SUPPORTED}: spherical harmonics are "
            f"implemented up to l={LMAX_SUPPORTED}")
    if normalize:
        r = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True)
                       + weak(eps, vec))
        vec = vec / r
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]

    a = [torch.ones_like(x)]
    b = [torch.zeros_like(x)]
    for m in range(1, lmax + 1):
        a.append(x * a[m - 1] - y * b[m - 1])
        b.append(x * b[m - 1] + y * a[m - 1])

    q: List[Dict[int, torch.Tensor]] = [dict() for _ in range(lmax + 1)]
    dfact = 1.0  # (2m-1)!!
    for m in range(0, lmax + 1):
        if m > 0:
            dfact *= (2 * m - 1)
        q[m][m] = torch.full_like(z, dfact)
        if m + 1 <= lmax:
            q[m][m + 1] = (2 * m + 1) * z * q[m][m]
        for l in range(m + 2, lmax + 1):
            q[m][l] = (((2 * l - 1) * z * q[m][l - 1]
                        - (l + m - 1) * q[m][l - 2])
                       / torch.full((), l - m, dtype=z.dtype,
                                    device=z.device))

    out: IrrepsDict = {}
    for l in range(lmax + 1):
        cols = []
        for m in range(-l, l + 1):
            am = abs(m)
            n = sqrt((2 * l + 1) * factorial(l - am) / factorial(l + am))
            if m != 0:
                n *= sqrt(2.0)
            azi = b[am] if m < 0 else a[am]
            cols.append(weak(n, z) * q[am][l] * azi)
        out[l] = torch.stack(cols, dim=-1)
    return out


@functools.lru_cache(maxsize=None)
def _complex_to_real(l: int) -> np.ndarray:
    """Unitary U with Y_real = U @ Y_complex, rows ordered m = -l..l: m < 0
    rows combine +-|m| with i / sqrt 2, m > 0 with (-1)^m / sqrt 2."""
    dim = 2 * l + 1
    u = np.zeros((dim, dim), complex)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            u[i, -m + l] = 1j / np.sqrt(2) * (-1) ** m * -1
            u[i, m + l] = 1j / np.sqrt(2)
        elif m == 0:
            u[i, l] = 1.0
        else:
            u[i, m + l] = (-1) ** m / np.sqrt(2)
            u[i, -m + l] = 1 / np.sqrt(2)
    return u


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """The real-basis CG tensor C[m1, m2, m3] (float32), scaled to norm
    sqrt(2 l3 + 1)."""
    from sympy import S
    from sympy.physics.quantum.cg import CG
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    cc = np.zeros((d1, d2, d3), complex)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            c = CG(S(l1), S(m1), S(l2), S(m2), S(l3), S(m3)).doit()
            cc[m1 + l1, m2 + l2, m3 + l3] = float(c)
    u1, u2, u3 = _complex_to_real(l1), _complex_to_real(l2), \
        _complex_to_real(l3)
    c = np.einsum("am,bn,co,mno->abc", u1.conj(), u2.conj(), u3, cc)
    # the real-basis tensor is purely real or purely imaginary
    if np.abs(c.imag).max() > np.abs(c.real).max():
        c = c.imag
    else:
        c = c.real
    n = np.linalg.norm(c)
    if n > 0:
        c = c / n * np.sqrt(d3)
    return c.astype(np.float32)


@functools.lru_cache(maxsize=None)
def cg_nonzero(l1: int, l2: int, l3: int) -> bool:
    cg = clebsch_gordan(l1, l2, l3)
    return cg.size > 0 and np.abs(cg).max() != 0.0


def tp_paths(a_ls: Iterable[int], b_ls: Iterable[int], lmax_out: int
             ) -> List[Tuple[int, int, int]]:
    """Every (l1, l2, l3) with |l1 - l2| <= l3 <= min(l1 + l2, lmax_out),
    in the order `tensor_product` walks them (a's keys, then b's, then
    l3)."""
    return [(l1, l2, l3) for l1 in a_ls for l2 in b_ls
            for l3 in range(abs(l1 - l2), min(l1 + l2, lmax_out) + 1)]


def tp_output_ls(a_ls: Iterable[int], b_ls: Iterable[int],
                 lmax_out: int) -> List[int]:
    """The keys `tensor_product` of features with keys `a_ls` and `b_ls`
    gives, in its order (paths whose CG tensor vanishes give nothing)."""
    out: List[int] = []
    for l1, l2, l3 in tp_paths(list(a_ls), list(b_ls), lmax_out):
        if cg_nonzero(l1, l2, l3) and l3 not in out:
            out.append(l3)
    return out


def tensor_product(a: IrrepsDict, b: IrrepsDict, lmax_out: int,
                   weights: Dict[Tuple[int, int, int], torch.Tensor] = None
                   ) -> IrrepsDict:
    """Channel-wise tensor product: each path (l1, l2 -> l3) contracts
    a[l1] [..., mul, 2l1+1] and b[l2] (its mul axis broadcast) with the
    real CG tensor; `weights[(l1, l2, l3)]` [..., mul] scales a path's
    channels. Paths add into their l3 slot in walking order."""
    out: Dict[int, list] = {}
    for l1, l2, l3 in tp_paths(list(a), list(b), lmax_out):
        if not cg_nonzero(l1, l2, l3):
            continue
        fa, fb = a[l1], b[l2]
        cg = device_constant(("cg", l1, l2, l3),
                             functools.partial(clebsch_gordan, l1, l2, l3),
                             fa)
        fb = fb.expand(fa.shape[:-1] + fb.shape[-1:])
        term = torch.einsum("...ui,...uj,ijk->...uk", fa, fb, cg)
        if weights is not None and (l1, l2, l3) in weights:
            term = term * weights[(l1, l2, l3)][..., None]
        out.setdefault(l3, []).append(term)
    result: IrrepsDict = {}
    for l, terms in out.items():
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        result[l] = acc
    return result


def scalar_part(feats: IrrepsDict) -> torch.Tensor:
    """The [..., mul] invariant (l = 0) channel."""
    return feats[0][..., 0]


def norm_per_l(feats: IrrepsDict) -> torch.Tensor:
    """The invariant norms of each l, concatenated: [..., mul n_l]."""
    parts = [torch.sqrt(torch.sum(f * f, dim=-1) + weak(1e-12, f))
             for _, f in sorted(feats.items())]
    return torch.cat(parts, dim=-1)
