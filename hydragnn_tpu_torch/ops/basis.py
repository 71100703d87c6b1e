"""Radial bases (counterpart: hydragnn_tpu/ops/basis.py). This slice
ports SchNet's Gaussian smearing; the other bases come with the models
that use them (ROADMAP A7)."""
from __future__ import annotations

import torch


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
