"""Radial bases (counterpart: hydragnn_tpu/ops/basis.py): SchNet's
Gaussian smearing, the sinc expansion and cosine cutoff of EGNN, PAINN
and PNAEq, the Bessel basis with its polynomial envelope of PNAPlus and
DimeNet, and MACE's suite: its normalized Bessel, Gaussian and Chebyshev
bases, polynomial cutoff and Agnesi / Soft distance transforms
(`RADIAL_BASES`, `DISTANCE_TRANSFORMS`).

Python constants enter as JAX's weakly typed scalars do: rounded to the
data's dtype first (`ops.scalars.weak`). Integer powers multiply as
`lax.integer_pow` does (`integer_pow`), so float32 results and gradients
follow the JAX package's roundings.
"""
from __future__ import annotations

import math

import torch

from .scalars import weak


def integer_pow(x, n: int):
    """x ** n for an integer n >= 1 by binary exponentiation, the
    product order of `lax.integer_pow` (x ** 5 = x * (x²)²)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def gaussian_basis(d, start: float, stop: float, num_gaussians: int):
    """SchNet's GaussianSmearing: exp(-gamma (d - mu_k)²) over
    `num_gaussians` centres mu_k evenly spaced in [start, stop], with
    gamma = 0.5 / (mu_1 - mu_0)²."""
    # the centres in float32, rounded once to d's dtype, as JAX's
    # linspace gives them: torch.linspace in bf16 steps in bf16 and
    # differs between the CPU and the card
    mu = torch.linspace(start, stop, num_gaussians, dtype=torch.float32,
                        device=d.device).to(d.dtype)
    gamma = 0.5 / ((mu[1] - mu[0]) ** 2) if num_gaussians > 1 else 1.0
    diff = d[..., None] - mu
    return torch.exp(-gamma * diff * diff)


def envelope(x, exponent: int = 5):
    """DimeNet's smooth polynomial envelope u(x) on x = d / cutoff:
    1 / x + a x^(p-1) + b x^p + c x^(p+1), p = exponent + 1."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    xp = integer_pow(x, p - 1)
    inv = 1.0 / torch.maximum(x, torch.full((), weak(1e-9, x),
                                            dtype=x.dtype, device=x.device))
    return (inv + weak(a, x) * xp + weak(b, x) * xp * x
            + weak(c, x) * xp * x * x)


def bessel_basis(d, cutoff: float, num_radial: int,
                 envelope_exponent: int = 5):
    """Bessel radial basis with envelope: env(d / c) sin(n pi d / c),
    n = 1 .. num_radial."""
    freq = torch.arange(1, num_radial + 1, dtype=d.dtype,
                        device=d.device) * weak(math.pi, d)
    x = d / weak(cutoff, d)
    env = envelope(x, envelope_exponent)
    return env[..., None] * torch.sin(freq * x[..., None])


def cosine_cutoff(d, cutoff: float):
    """0.5 (cos(pi d / c) + 1) below the cutoff, 0 at and beyond it."""
    out = 0.5 * (torch.cos(weak(math.pi, d) * d / weak(cutoff, d)) + 1.0)
    return torch.where(d < cutoff, out, torch.zeros_like(out))


def sinc_expansion(d, cutoff: float, num_basis: int):
    """sin(n pi d / c) / d for n = 1 .. num_basis, with d floored at
    1e-9."""
    n = torch.arange(1, num_basis + 1, dtype=d.dtype, device=d.device)
    safe_d = torch.maximum(d, torch.full((), weak(1e-9, d), dtype=d.dtype,
                                         device=d.device))[..., None]
    return torch.sin(n * weak(math.pi, d) * safe_d / weak(cutoff, d)) \
        / safe_d


def bessel_basis_mace(d, cutoff: float, num_basis: int = 8):
    """MACE's Bessel basis sqrt(2 / c) sin(n pi d / c) / d, n = 1 ..
    num_basis, with d floored at 1e-9."""
    freq = torch.arange(1, num_basis + 1, dtype=d.dtype,
                        device=d.device) * weak(math.pi / cutoff, d)
    safe_d = torch.maximum(d, torch.full((), weak(1e-9, d), dtype=d.dtype,
                                         device=d.device))[..., None]
    return weak(math.sqrt(2.0 / cutoff), d) * torch.sin(freq * safe_d) \
        / safe_d


def gaussian_basis_mace(d, cutoff: float, num_basis: int = 8):
    """MACE's Gaussian basis: centres evenly spaced in [0, cutoff]."""
    return gaussian_basis(d, 0.0, cutoff, num_basis)


def chebyshev_basis(d, cutoff: float, num_basis: int = 8):
    """MACE's Chebyshev basis T_n(2 d / c - 1), n = 1 .. num_basis, by the
    recurrence T_{n+1} = 2 x T_n - T_{n-1} (smooth at x = +-1, where
    arccos' derivative is infinite)."""
    x = torch.clamp(2.0 * d / weak(cutoff, d) - 1.0, -1.0, 1.0)
    t_prev, t_cur = torch.ones_like(x), x
    out = [t_cur]
    for _ in range(num_basis - 1):
        t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
        out.append(t_cur)
    return torch.stack(out, dim=-1)


def polynomial_cutoff(d, cutoff: float, p: int = 6):
    """MACE's polynomial cutoff, smooth to order p at d = cutoff, 0 at and
    beyond it."""
    x = d / weak(cutoff, d)
    f = (1.0
         - weak(0.5 * (p + 1) * (p + 2), x) * integer_pow(x, p)
         + weak(p * (p + 2), x) * integer_pow(x, p + 1)
         - weak(0.5 * p * (p + 1), x) * integer_pow(x, p + 2))
    return torch.where(x < 1.0, f, torch.zeros_like(f))


def agnesi_transform(d, q: float = 0.9183, p: float = 4.5791,
                     a: float = 1.0):
    """MACE's Agnesi distance transform."""
    ad = weak(a, d) * d
    ap = torch.pow(ad, weak(q, d))
    return 1.0 / (1.0 + ap / (1.0 + torch.pow(ad, weak(q - p, d))))


def soft_transform(d, a: float = 0.2, b: float = 3.0):
    """MACE's Soft distance transform."""
    ad = weak(a, d) * d
    db = d / weak(b, d)
    return d * torch.tanh(db * db + ad) / torch.tanh(1.0 + ad)


RADIAL_BASES = {
    "bessel": bessel_basis_mace,
    "gaussian": gaussian_basis_mace,
    "chebyshev": chebyshev_basis,
}

DISTANCE_TRANSFORMS = {
    "None": lambda d: d,
    "Agnesi": agnesi_transform,
    "Soft": soft_transform,
}
