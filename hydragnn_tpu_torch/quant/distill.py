"""Per-head student distillation for the int8 serving tier (counterpart:
hydragnn_tpu/quant/distill.py).

The int8 tier's error comes from the quantized conv stack; the decoder
stays float32, so its parameters are free to win accuracy back.
`distill_heads` fine-tunes exactly those (everything but the encoder's
convs and feature norms) through the quantized student forward against
the float32 teacher's outputs, one masked MSE a head.

Deterministic: no randomness, full-batch Adam (train/optimizer.py, the
optax rule) on one collated batch for a fixed number of steps, so two
calls return bitwise the same student.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..graphs.batch import GraphSample, collate
from ..telemetry.registry import get_registry
from ..train.optimizer import Optimizer
from ..utils.weights import export_jax_variables
from .calibrate import CalibrationScales, encoder_param_key, model_state
from .ptq import make_quantized_forward


def _distill_batch(samples: Sequence[GraphSample]):
    rup = lambda v: -(-int(v + 1) // 8) * 8  # noqa: E731
    n_node = rup(sum(int(s.num_nodes) for s in samples))
    n_edge = rup(sum(int(s.num_edges) for s in samples))
    batch = collate(list(samples), n_node=n_node, n_edge=n_edge,
                    n_graph=len(samples) + 1)
    return batch.replace(y_graph=None, y_node=None, energy=None,
                         forces=None)


def _head_mse(outputs, teacher, mcfg, batch) -> List[torch.Tensor]:
    """Per-head masked MSE between student and teacher: padding rows carry
    garbage on both sides and are left out."""
    g_mask = batch.graph_mask.to(torch.float32)
    n_mask = batch.node_mask.to(torch.float32)
    losses = []
    for ih, head in enumerate(mcfg.heads):
        mask = g_mask if head.head_type == "graph" else n_mask
        diff = outputs[ih].float() - teacher[ih].float()
        per_row = torch.sum(diff * diff, dim=-1)
        losses.append(torch.sum(per_row * mask)
                      / torch.clamp(torch.sum(mask), min=1.0))
    return losses


def distill_heads(model, variables, mcfg, calibration: CalibrationScales,
                  samples: Sequence[GraphSample], *, steps: int = 32,
                  lr: float = 1e-4, num_samples: Optional[int] = None
                  ) -> Tuple[dict, Dict[str, object]]:
    """Train the int8 tier's student heads against the float32 teacher.
    `variables` (a Flax tree, a TrainState or None for the model's own
    weights) seeds both; `model` itself is not changed. Returns
    `(student_variables, report)`: the Flax tree with every non-encoder
    parameter fine-tuned for up to `steps` full-batch Adam steps on the
    summed per-head MSE (the encoder's gradients are zeroed before each
    update, so its parameters and the batch statistics stay the
    teacher's bitwise); the best iterate by total loss is returned,
    iterate 0 being the teacher, so the student is never worse. The
    report has the JAX package's keys."""
    subset = list(samples)
    if num_samples is not None:
        subset = subset[:max(int(num_samples), 1)]
    if not subset:
        raise ValueError("distill_heads needs at least one sample")
    student = copy.deepcopy(model).eval()
    state = model_state(model, variables)
    if state is not None:
        student.load_state_dict(state)
    dev = next(student.parameters()).device
    batch = _distill_batch(subset).to(dev)
    num_conv = int(mcfg.num_conv_layers)
    names = [n for n, _ in student.named_parameters()]
    params = [p for _, p in student.named_parameters()]
    frozen = [encoder_param_key(n.split(".", 1)[0], num_conv) for n in names]
    if all(frozen):
        raise ValueError(
            "distill_heads found no head parameters to train — every "
            "top-level param key belongs to the encoder conv stack")
    with torch.no_grad():
        teacher, _ = student(batch)
    student_fwd = make_quantized_forward(student, mcfg, calibration)

    def losses_of():
        outs, _ = student_fwd(batch)
        return _head_mse(outs, teacher, mcfg, batch)

    tx = Optimizer("Adam", learning_rate=float(lr))
    opt_state = tx.init(params)
    with torch.no_grad():
        pre = [float(x) for x in losses_of()]
    best_total, best_losses, best_step = sum(pre), pre, 0
    best = [p.detach().clone() for p in params]
    for it in range(max(int(steps), 1)):
        losses = losses_of()
        grads = torch.autograd.grad(sum(losses), params, allow_unused=True,
                                    materialize_grads=True)
        grads = [torch.zeros_like(g) if fr else g
                 for g, fr in zip(grads, frozen)]
        updates, opt_state = tx.update(grads, opt_state, params)
        with torch.no_grad():
            torch._foreach_add_([p.detach() for p in params], updates)
            cur = [float(x) for x in losses_of()]
        if sum(cur) < best_total:
            best_total, best_losses, best_step = sum(cur), cur, it + 1
            best = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, b in zip(params, best):
            p.copy_(b)
    post = best_losses
    report = {
        "steps": int(steps), "lr": float(lr),
        "best_step": int(best_step),
        "samples": len(subset),
        "head_mse_vs_teacher_pre": pre,
        "head_mse_vs_teacher_post": post,
        "improved": bool(sum(post) < sum(pre)),
        "trained_param_keys": sorted({n.split(".", 1)[0]
                                      for n, fr in zip(names, frozen)
                                      if not fr}),
    }
    reg = get_registry()
    reg.counter_inc("quant.distillations_total",
                    help="head-wise distillation runs completed")
    reg.gauge_set("quant.distill_mse_post", float(sum(post)),
                  help="summed per-head MSE vs the fp32 teacher after "
                       "the most recent distillation")
    return export_jax_variables(student), report
