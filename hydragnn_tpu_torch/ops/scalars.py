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

A Python scalar divided by a tensor is `reciprocal() * scalar` in
PyTorch, and a tensor divided by a Python scalar is a product with the
scalar's reciprocal on the card: where JAX's true division must be kept
(a recurrence that amplifies rounding), the scalar enters as a 0-d
tensor on the data's device (`const`). Host numpy tables a forward reads
(DimeNet's Bessel zeros, MACE's Clebsch-Gordan tensors) are copied to a
device once (`device_constant`), at a first call that on the card is an
eager warm-up run before any CUDA graph capture.
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


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` rounded to `like`'s dtype, as a 0-d tensor on its device (a
    fill, which a CUDA graph captures)."""
    return torch.full((), weak(value, like), dtype=like.dtype,
                      device=like.device)


_DEVICE_CONSTANTS: dict = {}


def device_constant(key, build, like: torch.Tensor) -> torch.Tensor:
    """The host array `build()` as a tensor of `like`'s dtype on its
    device, made once for each (key, device, dtype) (outside inference
    mode)."""
    full = (key, str(like.device), like.dtype)
    hit = _DEVICE_CONSTANTS.get(full)
    if hit is None:
        # a normal tensor, also when first asked for under inference
        # mode: later forwards differentiate through it
        with torch.inference_mode(False):
            hit = torch.as_tensor(build()).to(like.dtype).to(like.device)
        _DEVICE_CONSTANTS[full] = hit
    return hit


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) computed in float32 and rounded once to x's dtype."""
    return torch.rsqrt(x.float()).to(x.dtype)
