"""Energy and forces from a node-level energy head (counterpart:
hydragnn_tpu/train/loss.py, `energy_forces_from_node_head`). The losses
and their second derivatives come with the training slice (ROADMAP A5).
"""
from __future__ import annotations

import torch

from ..ops.segment import global_sum_pool


def energy_forces_from_node_head(model, batch):
    """(graph energies [G, 1], forces [N, 3]): head 0's first column is
    the per-node energy, a graph's energy is the masked sum of its nodes',
    and forces = -d(sum of the real graphs' energies)/d pos, taken with
    `torch.autograd.grad` with respect to the positions only. Runs under
    `torch.enable_grad()`, so it may be called from inference code, but
    not under `torch.inference_mode()`, whose tensors autograd refuses."""
    with torch.enable_grad():
        pos = batch.pos.detach().requires_grad_(True)
        b = batch.replace(pos=pos)
        outputs, _ = model(b)
        graph_e = global_sum_pool(outputs[0][:, :1], b.node_graph,
                                  b.num_graphs, b.node_mask)
        total = torch.sum(torch.where(b.graph_mask[:, None], graph_e,
                                      torch.zeros_like(graph_e)))
        (grad,) = torch.autograd.grad(total, pos)
    return graph_e.detach(), -grad
