"""Shared building-block layers (counterpart: hydragnn_tpu/models/layers.py).

Submodules keep the Flax names (`dense_{i}`, `MLP_0`, `scale`/`bias`,
running `mean`/`var`) so weights carry across from the JAX package
mechanically (utils/weights.py)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..kernels import segment as kseg
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
    """Node-level decoder head (counterpart:
    hydragnn_tpu/models/layers.py::MLPNode). "mlp": one MLP shared by all
    nodes. "mlp_per_node": a bank of weights per node index within its
    graph (`node_index_in_graph`, clipped to `num_nodes - 1`; config
    completion refuses it for graphs of varying size), parameters `w_{li}`
    [num_nodes, in, f] and `b_{li}` [num_nodes, f] under Flax's names.

    The bank rows are gathered by `kernels.segment.gather_rows`, whose
    gradient is the segment sum of the rows by bank index (the segment-sum
    kernel on the card, in a fixed order: no atomics). A weight bank is
    gathered as [num_nodes * in, f] rows, row (idx, i) for node input i,
    so the sum's width is f; each node's product is then a batched
    matrix-vector product."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, node_type: str = "mlp",
                 activation: Callable = F.relu, num_nodes: int = 1):
        super().__init__()
        self.node_type = node_type
        self.activation = activation
        dims = list(hidden_dims) + [output_dim]
        if node_type == "mlp":
            self.MLP_0 = MLP(in_dim, dims, activation=activation)
        elif node_type == "mlp_per_node":
            self.num_nodes = max(int(num_nodes), 1)
            self.dims = dims
            d = in_dim
            for li, f in enumerate(dims):
                setattr(self, f"w_{li}", nn.Parameter(
                    torch.zeros(self.num_nodes, d, f)))
                setattr(self, f"b_{li}", nn.Parameter(
                    torch.zeros(self.num_nodes, f)))
                d = f
        else:
            raise ValueError(f"unknown node head type {node_type!r}")

    def forward(self, x, node_index: Optional[torch.Tensor] = None):
        if self.node_type == "mlp":
            return self.MLP_0(x)
        if node_index is None:
            raise ValueError(
                f"node_type={self.node_type!r} heads need "
                "node_index_in_graph (per-node positional weights)")
        idx = torch.clamp(node_index, 0, self.num_nodes - 1)
        bias_layout = _bank_layout(idx, self.num_nodes)
        h = x
        for li in range(len(self.dims)):
            w, b = getattr(self, f"w_{li}"), getattr(self, f"b_{li}")
            d_in, f = w.shape[1], w.shape[2]
            rows = (idx.long()[:, None] * d_in
                    + torch.arange(d_in, device=idx.device)).reshape(-1)
            wg = kseg.gather_rows(w.reshape(-1, f), rows,
                                  _bank_layout(rows, self.num_nodes * d_in))
            bg = kseg.gather_rows(b, idx, bias_layout)
            h = torch.bmm(h[:, None, :].to(w.dtype),
                          wg.view(-1, d_in, f))[:, 0] + bg
            if li < len(self.dims) - 1:
                h = self.activation(h)
        return h


def _bank_layout(ids: torch.Tensor, n: int):
    """The CSR view of a bank gather's ids for its gradient's segment sum
    (None on the CPU, where the plain version runs)."""
    if ids.device.type == "cpu" or not torch.is_grad_enabled():
        return None
    return kseg.segment_layout(ids, n)


def node_index_in_graph(node_graph: torch.Tensor, num_graphs: int
                        ) -> torch.Tensor:
    """Each node's index within its graph: its position minus its graph's
    first position (counterpart: hydragnn_tpu/models/layers.py, bitwise).
    The graphs' node counts are a fixed-order sum (one-hot rows added
    along the nodes), so the card needs no atomic scatter."""
    n = node_graph.shape[0]
    onehot = (node_graph.long()[:, None]
              == torch.arange(num_graphs, device=node_graph.device))
    counts = onehot.to(torch.int32).sum(dim=0, dtype=torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32,
                                    device=node_graph.device),
                        torch.cumsum(counts, 0, dtype=torch.int32)[:-1]])
    return (torch.arange(n, dtype=torch.int32, device=node_graph.device)
            - starts[node_graph.long()])
