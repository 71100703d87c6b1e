"""Multihead weighted loss and energy-force loss (counterpart:
hydragnn_tpu/train/loss.py).

Forces are -dE/dpos by `torch.autograd.grad` with respect to the
positions. Training takes that gradient with `create_graph=True`, so the
force loss differentiates it again with respect to the weights, through
the port's autograd Functions (`segment_sum`, `gather_rows`,
`filter_scatter`), whose backwards are themselves differentiable.
"""
from __future__ import annotations

from typing import List

import torch

from ..config.config import ModelConfig
from ..graphs.batch import GraphBatch
from ..ops.activations import masked_loss
from ..ops.segment import global_sum_pool


def head_targets(cfg: ModelConfig, batch: GraphBatch) -> List[torch.Tensor]:
    """Per-head targets sliced from the packed labels at the heads'
    static offsets."""
    targets = []
    for head in cfg.heads:
        y = batch.y_graph if head.head_type == "graph" else batch.y_node
        end = head.offset + head.output_dim
        if y is None or y.shape[1] < end:
            have = 0 if y is None else y.shape[1]
            raise ValueError(
                f"{head.head_type} head needs packed label columns "
                f"[{head.offset}:{end}) but the batch carries {have} — "
                "the dataset provides fewer targets than "
                "Variables_of_interest selects")
        targets.append(y[:, head.offset:end])
    return targets


def head_loss_mask(batch: GraphBatch, ih: int, head) -> torch.Tensor:
    """The loss mask of head `ih`: the real graphs for a graph head, the
    real nodes for a node head. (Mixture batches, whose `dataset_id`
    narrows the mask per head, come with the GFM slice, ROADMAP A9.)"""
    return batch.graph_mask if head.head_type == "graph" else batch.node_mask


def multihead_loss(cfg: ModelConfig, loss_name: str, outputs, outputs_var,
                   batch: GraphBatch):
    """(total, per-task losses): the task-weighted sum of each head's
    masked loss."""
    targets = head_targets(cfg, batch)
    tot = 0.0
    tasks = []
    for ih, head in enumerate(cfg.heads):
        mask = head_loss_mask(batch, ih, head)
        var = outputs_var[ih] if outputs_var is not None else None
        li = masked_loss(loss_name, outputs[ih], targets[ih], mask, var)
        tasks.append(li)
        tot = tot + cfg.task_weights[ih] * li
    return tot, tasks


def auto_force_weight(energy, forces, graph_mask, node_mask,
                      energy_weight: float = 1.0):
    """The force-loss weight that balances the two terms by the true
    labels' magnitudes over one batch's real entries:
    energy_weight * mean|E| / (mean|F| + 1e-8)."""
    gm = graph_mask[:, None]
    nm = node_mask[:, None]
    one = torch.ones((), dtype=energy.dtype, device=energy.device)
    e_mean = (torch.sum(torch.abs(energy) * gm)
              / torch.maximum(torch.sum(gm), one))
    f_mean = (torch.sum(torch.abs(forces) * nm)
              / torch.maximum(torch.sum(nm) * forces.shape[-1], one))
    return energy_weight * e_mean / (f_mean + 1e-8)


def energy_forces_from_node_head(forward, batch, create_graph: bool = False):
    """(graph energies [G, 1], forces [N, 3]) from `forward(batch) ->
    (outputs, outputs_var)` (the model, or train_step.make_forward_fn's
    mixed-precision forward, whose float32 outputs pool in float32): head
    0's first column is
    the per-node energy, a graph's energy is the masked sum of its nodes',
    and forces = -d(sum of the real graphs' energies)/d pos, taken with
    `torch.autograd.grad` with respect to the positions only. Runs under
    `torch.enable_grad()`, so it may be called from inference code, but
    not under `torch.inference_mode()`, whose tensors autograd refuses.

    Serving calls it as it is: energies detached, forces a plain tensor.
    Training passes `create_graph=True`: both keep their graph to the
    weights, so a loss on them can be differentiated again."""
    with torch.enable_grad():
        pos = batch.pos.detach().requires_grad_(True)
        b = batch.replace(pos=pos)
        outputs, _ = forward(b)
        graph_e = global_sum_pool(outputs[0][:, :1], b.node_graph,
                                  b.num_graphs, b.node_mask)
        total = torch.sum(torch.where(b.graph_mask[:, None], graph_e,
                                      torch.zeros_like(graph_e)))
        # zero forces where the energy does not read the positions (a
        # model without geometry), as jax.grad gives them
        (grad,) = torch.autograd.grad(total, pos, create_graph=create_graph,
                                      allow_unused=True,
                                      materialize_grads=True)
    if not create_graph:
        graph_e = graph_e.detach()
    return graph_e, -grad


def energy_force_loss(forward, cfg: ModelConfig, batch: GraphBatch,
                      loss_name: str = "mae", energy_weight: float = 1.0,
                      force_weight=1.0, create_graph: bool = True):
    """(total, aux): energy_weight * loss(E) + force_weight * loss(F) over
    the real graphs and nodes, with forces from
    `energy_forces_from_node_head`; `force_weight` "auto" balances them
    by `auto_force_weight`. aux holds the two losses and the predictions.
    `forward` as in `energy_forces_from_node_head`. The model's mode
    decides its BatchNorm statistics: in training mode
    the running statistics update once, detached, and the batch
    statistics stay in the force graph. `create_graph=False` (evaluation)
    returns losses without a graph to the weights."""
    graph_e, forces = energy_forces_from_node_head(forward, batch,
                                                   create_graph=create_graph)
    e_loss = masked_loss(loss_name, graph_e, batch.energy, batch.graph_mask)
    f_loss = masked_loss(loss_name, forces, batch.forces, batch.node_mask)
    if force_weight == "auto":
        force_weight = auto_force_weight(batch.energy, batch.forces,
                                         batch.graph_mask, batch.node_mask,
                                         energy_weight)
    total = energy_weight * e_loss + force_weight * f_loss
    return total, {"energy_loss": e_loss, "force_loss": f_loss,
                   "energy_pred": graph_e, "forces_pred": forces}
