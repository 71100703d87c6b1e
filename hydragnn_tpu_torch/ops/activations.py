"""Activation registry (counterpart: hydragnn_tpu/ops/activations.py),
key for key. "prelu" is leaky-relu with the fixed slope 0.25 and "gelu"
the tanh approximation, as `jax.nn.gelu` computes by default."""
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
