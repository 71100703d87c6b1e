"""Radial bases (counterpart: hydragnn_tpu/ops/basis.py): SchNet's
Gaussian smearing, EGNN's sinc expansion and cosine cutoff, PNAPlus's
Bessel basis with its polynomial envelope. The MACE and DimeNet bases
come with the models that use them (ROADMAP A7).

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
