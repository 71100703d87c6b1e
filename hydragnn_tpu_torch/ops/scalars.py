"""Python scalars and reduced-precision tensors.

JAX applies a Python scalar to an array as a weakly typed value: it is
rounded to the array's dtype first, then the op runs and rounds once.
PyTorch does the same for an add or a subtraction on a bf16 tensor on
the CPU, but not on the card, which keeps the scalar in float32; its CPU
rsqrt of bf16 data is an approximation. The port's bf16 paths state the
rounding instead, so the CPU and the card compute the same bf16 values
and the JAX package's: `weak` rounds a scalar to a tensor's dtype on the
host, `rsqrt` computes in float32 and rounds once. For float32 tensors
both are what PyTorch does anyway.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def weak(value: float, like: torch.Tensor) -> float:
    """`value` rounded to `like`'s dtype, as a Python float (computed once
    for each value and dtype)."""
    return _rounded(float(value), like.dtype)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) computed in float32 and rounded once to x's dtype."""
    return torch.rsqrt(x.float()).to(x.dtype)
