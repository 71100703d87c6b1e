"""DimeNet's spherical Bessel and Legendre bases (counterpart:
hydragnn_tpu/ops/spherical.py).

The zeros of the spherical Bessel functions j_l (scipy's brentq) and the
basis' normalizers are host numpy, computed once a process; their
float32 copies on a device are made once for each (device, dtype) at the
first forward, which on the card is an eager warm-up run before any CUDA
graph capture (a host-to-device copy cannot be captured). j_l runs the
upward recurrence from j_0 and j_1 with the JAX package's operation
order and its clamp of x at 1e-7 (the recurrence is ill-conditioned at
small x); the integer coefficients divide as true divisions, as JAX's
do.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .basis import envelope
from .scalars import const, device_constant, weak


@functools.lru_cache(maxsize=None)
def spherical_bessel_zeros(num_l: int, num_n: int) -> np.ndarray:
    """zeros[l, n] = the (n+1)-th positive zero of j_l (host, float64)."""
    from scipy import optimize, special
    zeros = np.zeros((num_l, num_n))
    # j_0's zeros are k pi; the zeros of j_l interlace those of j_{l-1}
    grid = np.arange(1, num_n + num_l + 2) * np.pi
    prev = grid
    zeros[0] = grid[:num_n]
    for l in range(1, num_l):
        f = lambda x: special.spherical_jn(l, x)
        cur = []
        for a, b in zip(prev[:-1], prev[1:]):
            cur.append(optimize.brentq(f, a + 1e-9, b - 1e-9))
        prev = np.asarray(cur)
        zeros[l] = prev[:num_n]
    return zeros


@functools.lru_cache(maxsize=None)
def spherical_norms(num_l: int, num_n: int) -> np.ndarray:
    """norm[l, n] = 1 / |j_{l+1}(zeros[l, n])| (DimeNet's appendix; host,
    float64)."""
    from scipy import special
    zeros = spherical_bessel_zeros(num_l, num_n)
    norm = np.zeros_like(zeros)
    for l in range(num_l):
        norm[l] = 1.0 / np.abs(special.spherical_jn(l + 1, zeros[l]))
    return norm


def spherical_jn(l_max: int, x):
    """[j_0(x), ..., j_{l_max}(x)] by the upward recurrence."""
    tiny = const(1e-7, x)
    x_safe = torch.where(torch.abs(x) < 1e-7, tiny, x)
    sin, cos = torch.sin(x_safe), torch.cos(x_safe)
    out = [sin / x_safe]
    if l_max >= 1:
        out.append(sin / (x_safe * x_safe) - cos / x_safe)
    for l in range(2, l_max + 1):
        out.append(const(2 * l - 1, x) / x_safe * out[-1] - out[-2])
    return out


def legendre(l_max: int, x):
    """[P_0(x), ..., P_{l_max}(x)] by the recurrence."""
    out = [torch.ones_like(x)]
    if l_max >= 1:
        out.append(x)
    for l in range(2, l_max + 1):
        out.append(((2 * l - 1) * x * out[-1] - (l - 1) * out[-2])
                   / const(l, x))
    return out


def spherical_basis(d, angle, cutoff: float, num_spherical: int,
                    num_radial: int, envelope_exponent: int = 5):
    """sbf[t, l num_radial + n] = env(d/c) j_l(z_ln d/c) norm_ln
    sqrt((2l+1)/4pi) P_l(cos angle): `d` is each triplet's k -> j edge
    length, `angle` its angle at j."""
    key = (num_spherical, num_radial)
    zeros = device_constant(
        ("sbf_zeros",) + key, lambda: spherical_bessel_zeros(*key), d)
    norm = device_constant(("sbf_norms",) + key,
                           lambda: spherical_norms(*key), d)
    x = d / weak(cutoff, d)
    env = envelope(x, envelope_exponent)
    pl = legendre(num_spherical - 1, torch.cos(angle))
    parts = []
    for l in range(num_spherical):
        jl = spherical_jn(l, x[..., None] * zeros[l])[l]   # [T, num_radial]
        yl = weak(math.sqrt((2 * l + 1) / (4 * math.pi)), d) * pl[l]
        parts.append(env[..., None] * jl * norm[l] * yl[..., None])
    return torch.cat(parts, dim=-1)
