"""Shared building-block layers (counterpart: hydragnn_tpu/models/layers.py).

Submodules keep the Flax names (`dense_{i}`, `MLP_0`, `scale`/`bias`,
running `mean`/`var`) so weights carry across from the JAX package
mechanically (utils/weights.py)."""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.scalars import rsqrt, weak


class Dense(nn.Linear):
    """nn.Linear that computes as Flax's Dense does: in the promoted dtype
    of its input and weights (at bf16 the decoder meets float32 features,
    the masked mean pooling dividing bf16 sums by float32 counts, and runs
    in float32 with the bf16 weights widened), and below float32 with the
    bias added after the product is rounded, as a separate op. (A fused
    bias rounds once, and cuBLAS fuses it for some shapes and not for
    others, so the card and the CPU would round differently.) In float32
    it is nn.Linear."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        x, weight = x.to(dt), self.weight.to(dt)
        if self.bias is None:
            return F.linear(x, weight)
        if dt.itemsize < 4:
            return F.linear(x, weight) + self.bias.to(dt)
        return F.linear(x, weight, self.bias.to(dt))


class MLP(nn.Module):
    """Dense layers with the activation between them (and after the last
    with `activate_final`)."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 activation: Callable = F.relu, activate_final: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.features = list(features)
        self.activation = activation
        self.activate_final = activate_final
        d = in_dim
        for i, f in enumerate(self.features):
            setattr(self, f"dense_{i}", Dense(d, f, bias=use_bias))
            d = f
        self.out_dim = d

    def forward(self, x):
        n = len(self.features)
        for i in range(n):
            x = getattr(self, f"dense_{i}")(x)
            if i < n - 1 or self.activate_final:
                x = self.activation(x)
        return x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over real (masked) nodes only
    (counterpart: hydragnn_tpu/models/layers.py::MaskedBatchNorm).

    Training mode (`module.train()`) normalizes with the batch statistics
    of the masked rows, mean and biased variance, and updates the running
    statistics the Flax way, new = momentum * old + (1 - momentum) * batch
    with momentum 0.9 (torch's BatchNorm `momentum` means the other
    weight). The update runs under no_grad from the detached batch
    statistics, while the normalization itself stays differentiable, also
    with respect to the positions on the energy-force path. Eval mode
    normalizes every row with the running statistics,
    y = (x - mean) * rsqrt(var + eps) * scale + bias.

    All of it runs in x's dtype; under the mixed-precision step
    (train/train_step.py) the parameters and running statistics are bf16
    copies, and the step writes the updated copies back to the float32
    buffers."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, mask):
        if self.training:
            m = mask.to(x.dtype)[:, None]
            count = torch.maximum(torch.sum(m), torch.ones((), dtype=x.dtype,
                                                           device=x.device))
            mean = torch.sum(x * m, dim=0) / count
            var = torch.sum(m * (x - mean) ** 2, dim=0) / count
            with torch.no_grad():
                mom, rest = weak(self.momentum, x), weak(1 - self.momentum, x)
                self.mean.copy_(mom * self.mean + rest * mean.detach())
                self.var.copy_(mom * self.var + rest * var.detach())
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * rsqrt(var + weak(self.epsilon, x))
        return y * self.scale + self.bias


class MLPNode(nn.Module):
    """Node-level decoder head: one MLP shared by all nodes ("mlp"). The
    per-node weight banks ("mlp_per_node") come with ROADMAP item A4's
    remaining node heads."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, node_type: str = "mlp",
                 activation: Callable = F.relu):
        super().__init__()
        if node_type != "mlp":
            raise NotImplementedError(
                f"node head type {node_type!r} is not ported yet (ROADMAP "
                "A4: mlp_per_node and conv node heads)")
        self.MLP_0 = MLP(in_dim, list(hidden_dims) + [output_dim],
                         activation=activation)

    def forward(self, x):
        return self.MLP_0(x)
