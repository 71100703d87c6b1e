"""Activation registry and masked losses (counterpart:
hydragnn_tpu/ops/activations.py), key for key. "prelu" is leaky-relu with
the fixed slope 0.25 and "gelu" the tanh approximation, as `jax.nn.gelu`
computes by default."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "relu": F.relu,
    "selu": F.selu,
    "prelu": lambda x: F.leaky_relu(x, 0.25),
    "elu": F.elu,
    "lrelu_01": lambda x: F.leaky_relu(x, 0.1),
    "lrelu_025": lambda x: F.leaky_relu(x, 0.25),
    "lrelu_05": lambda x: F.leaky_relu(x, 0.5),
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def activation_function_selection(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation '{name}'; known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def masked_loss(name: str, pred, target, mask, var=None):
    """Loss over the masked (real) entries only — padding contributes
    nothing (counterpart: hydragnn_tpu/ops/activations.py::masked_loss,
    name for name): a masked mean of the elementwise loss; "rmse" the
    square root of the masked mse; "GaussianNLLLoss" takes the predicted
    variance `var` (floored at 1e-6); "ce" the softmax cross-entropy over
    the last axis against one-hot or soft targets, one term per real
    row."""
    mask_f = mask.reshape(tuple(mask.shape) + (1,) * (pred.dim() - mask.dim()))
    one = torch.ones((), dtype=pred.dtype, device=pred.device)
    count = torch.maximum(torch.sum(mask_f * torch.ones_like(pred)), one)
    if name == "mse":
        return torch.sum(mask_f * (pred - target) ** 2) / count
    if name == "mae":
        return torch.sum(mask_f * torch.abs(pred - target)) / count
    if name == "rmse":
        return torch.sqrt(torch.sum(mask_f * (pred - target) ** 2) / count)
    if name == "smooth_l1":
        d = torch.abs(pred - target)
        v = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        return torch.sum(mask_f * v) / count
    if name == "GaussianNLLLoss":
        v = torch.maximum(var, torch.full((), 1e-6, dtype=var.dtype,
                                          device=var.device))
        nll = 0.5 * (torch.log(v) + (pred - target) ** 2 / v)
        return torch.sum(mask_f * nll) / count
    if name == "ce":
        row = -torch.sum(target * torch.log_softmax(pred, dim=-1), dim=-1)
        rmask = mask.reshape(tuple(mask.shape) + (1,) * (row.dim()
                                                         - mask.dim()))
        rows = torch.maximum(torch.sum(rmask * torch.ones_like(row)), one)
        return torch.sum(rmask * row) / rows
    raise ValueError(f"unknown loss '{name}'")
