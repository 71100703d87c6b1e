"""Optimizers with optax's update rules (counterpart:
hydragnn_tpu/train/optimizer.py, whose `select_optimizer` builds
`optax.inject_hyperparams` over the registry below, optionally behind
`clip_by_global_norm` and inside `optax.MultiSteps`).

The rules are written out here as plain functions on lists of tensors
and follow optax, not `torch.optim`'s defaults: SGD's momentum trace
t = g + momentum t; Adam/AdamW/LAMB moments m = (1 - b1) g + b1 m with
the bias correction 1 - b^count divided into each moment and eps added
outside the square root; AdamW's decoupled weight decay (default 1e-2
here) added to the update before the learning rate; Adagrad's
accumulator starting at 0.1 with eps 1e-7 inside the square root; RMSprop
decaying at 0.9 with eps 1e-8 inside; Adadelta (rho 0.9, eps 1e-6) and
Adamax as optax computes them; LAMB's trust ratio ||param|| / ||update||
per tensor. The learning rate is a runtime hyperparameter (float32, as
`inject_hyperparams` stores it) that `set_learning_rate` changes between
steps. Updates are returned, not applied: the caller adds them to the
parameters (`optax.apply_updates`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

Tensors = List[torch.Tensor]

# optax.<factory>(lr) defaults, as the JAX registry calls them
_RULES = ("SGD", "Adam", "Adadelta", "Adagrad", "Adamax", "AdamW",
          "RMSprop", "FusedLAMB")


@dataclasses.dataclass
class OptState:
    """Optimizer state: the injected learning rate, the count of inner
    updates (optax's int32 `count`), the rule's per-tensor slots, and the
    gradient-accumulation state of `MultiSteps` (mini_step, the running
    mean of the micro-batch gradients, gradient_step)."""
    learning_rate: float
    count: int = 0
    slots: Dict[str, Tensors] = dataclasses.field(default_factory=dict)
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: Optional[Tensors] = None


def _f32(x: float) -> float:
    """x rounded to float32, kept as a Python float."""
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it."""
    return float(1 - torch.tensor(decay, dtype=torch.float32)
                 ** torch.tensor(float(count), dtype=torch.float32))


def _moment(g: Tensors, m: Tensors, decay: float, order: int) -> Tensors:
    """(1 - decay) g^order + decay m: optax's update_moment."""
    gp = g if order == 1 else torch._foreach_mul(g, g)
    return torch._foreach_add(torch._foreach_mul(gp, 1 - decay),
                              torch._foreach_mul(m, decay))


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(t * t))


class Optimizer:
    """One of the registry's update rules behind optional global-norm
    clipping, with an injectable learning rate and optional gradient
    accumulation: the port's counterpart of the optax transformation
    `select_optimizer` builds. `init(params)` -> OptState;
    `update(grads, state, params)` -> (updates, state), the state updated
    in place; updates are None on a micro-step that only accumulates."""

    def __init__(self, name: str, learning_rate: float = 1e-3,
                 weight_decay: float = 1e-2, momentum: float = 0.9,
                 grad_clip: Optional[float] = None, accumulate: int = 1):
        if name not in _RULES:
            raise ValueError(f"unknown optimizer '{name}'; known: "
                             f"{sorted(_RULES)}")
        self.name = name
        self.learning_rate = _f32(learning_rate)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.accumulate = max(int(accumulate), 1)

    # ------------------------------------------------------------ state --
    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        params = [p.detach() for p in params]
        name = self.name
        slots: Dict[str, Tensors] = {}
        if name == "SGD":
            slots["trace"] = _zeros(params)
        elif name in ("Adam", "AdamW", "FusedLAMB", "Adamax"):
            slots["mu"] = _zeros(params)
            slots["nu"] = _zeros(params)
        elif name == "Adadelta":
            slots["e_g"] = _zeros(params)
            slots["e_x"] = _zeros(params)
        elif name == "Adagrad":
            slots["sum_of_squares"] = [torch.full_like(p, 0.1)
                                       for p in params]
        elif name == "RMSprop":
            slots["nu"] = _zeros(params)
        state = OptState(learning_rate=self.learning_rate, slots=slots)
        if self.accumulate > 1:
            state.acc_grads = _zeros(params)
        return state

    # ----------------------------------------------------------- update --
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]):
        grads = list(grads)
        params = [p.detach() for p in params]
        if self.accumulate == 1:
            return self._inner(grads, state, params), state
        # optax.MultiSteps: a running mean of the micro-batch gradients,
        # one inner update every `accumulate` calls
        acc = state.acc_grads
        diff = torch._foreach_sub(grads, acc)
        acc = torch._foreach_add(acc, torch._foreach_div(
            diff, float(state.mini_step + 1)))
        if state.mini_step < self.accumulate - 1:
            state.acc_grads = acc
            state.mini_step += 1
            return None, state
        updates = self._inner(acc, state, params)
        state.acc_grads = _zeros(params)
        state.mini_step = 0
        state.gradient_step += 1
        return updates, state

    def _inner(self, g: Tensors, state: OptState, p: Tensors) -> Tensors:
        if self.grad_clip is not None:
            g = _clip_by_global_norm(g, self.grad_clip)
        u = self._rule(g, state, p)
        # scale_by_learning_rate: -lr * u, with lr the float32 hyperparameter
        return torch._foreach_mul(u, -state.learning_rate)

    def _rule(self, g: Tensors, state: OptState, p: Tensors) -> Tensors:
        name, s = self.name, state.slots
        if name == "SGD":
            s["trace"] = torch._foreach_add(
                g, torch._foreach_mul(s["trace"], self.momentum))
            return list(s["trace"])
        if name in ("Adam", "AdamW", "FusedLAMB"):
            eps = 1e-6 if name == "FusedLAMB" else 1e-8
            s["mu"] = _moment(g, s["mu"], 0.9, 1)
            s["nu"] = _moment(g, s["nu"], 0.999, 2)
            state.count += 1
            mu_hat = torch._foreach_div(s["mu"],
                                        _bias_correction(0.9, state.count))
            nu_hat = torch._foreach_div(s["nu"],
                                        _bias_correction(0.999, state.count))
            u = torch._foreach_div(mu_hat, torch._foreach_add(
                torch._foreach_sqrt(nu_hat), eps))
            if name == "AdamW":
                u = torch._foreach_add(
                    u, torch._foreach_mul(p, self.weight_decay))
            elif name == "FusedLAMB":
                u = [_trust_ratio(ui, pi) for ui, pi in zip(u, p)]
            return u
        if name == "Adamax":
            s["mu"] = _moment(g, s["mu"], 0.9, 1)
            s["nu"] = torch._foreach_maximum(
                torch._foreach_add(torch._foreach_abs(g), 1e-8),
                torch._foreach_mul(s["nu"], 0.999))
            state.count += 1
            mu_hat = torch._foreach_div(s["mu"],
                                        _bias_correction(0.9, state.count))
            return torch._foreach_div(mu_hat, s["nu"])
        if name == "Adadelta":
            rho, eps = 0.9, 1e-6
            s["e_g"] = _moment(g, s["e_g"], rho, 2)
            ratio = torch._foreach_div(
                torch._foreach_sqrt(torch._foreach_add(s["e_x"], eps)),
                torch._foreach_sqrt(torch._foreach_add(s["e_g"], eps)))
            u = torch._foreach_mul(ratio, g)
            s["e_x"] = _moment(u, s["e_x"], rho, 2)
            return u
        if name == "Adagrad":
            sos = torch._foreach_add(torch._foreach_mul(g, g),
                                     s["sum_of_squares"])
            s["sum_of_squares"] = sos
            return [torch.where(t > 0, torch.rsqrt(t + 1e-7),
                                torch.zeros_like(t)) * gi
                    for t, gi in zip(sos, g)]
        # RMSprop
        s["nu"] = _moment(g, s["nu"], 0.9, 2)
        return torch._foreach_mul(
            [torch.rsqrt(n + 1e-8) for n in s["nu"]], g)


def _clip_by_global_norm(g: Tensors, max_norm: float) -> Tensors:
    """optax.clip_by_global_norm: g unchanged when its global norm is
    below `max_norm`, else (g / norm) * max_norm."""
    norm = torch.sqrt(torch.sum(torch.stack(
        [torch.sum(t * t) for t in g])))
    return [torch.where(norm < max_norm, t, (t / norm) * max_norm)
            for t in g]


def _trust_ratio(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """optax.scale_by_trust_ratio for one tensor: u ||p|| / ||u||, or u
    when either norm is 0."""
    pn, un = _norm(p), _norm(u)
    ratio = torch.where((pn == 0) | (un == 0),
                        torch.ones((), dtype=p.dtype, device=p.device),
                        pn / un)
    return u * ratio


def select_optimizer(train_config: Dict[str, Any]) -> Optimizer:
    """The `Training.Optimizer` block -> Optimizer: `type` (default
    AdamW), `learning_rate` (default 1e-3), `weight_decay` (AdamW, default
    1e-2), `momentum` (SGD, default 0.9); `Training.grad_clip` clips by
    the global norm first; `Training.gradient_accumulation_steps` > 1
    averages that many micro-batch gradients per update (optax.MultiSteps).
    Every other key of the block is ignored, as the JAX registry ignores
    it."""
    opt_cfg = train_config.get("Optimizer", {"type": "AdamW"})
    return Optimizer(
        opt_cfg.get("type", "AdamW"), learning_rate=float(opt_cfg.get("learning_rate", 1e-3)),
        weight_decay=float(opt_cfg.get("weight_decay", 1e-2)),
        momentum=float(opt_cfg.get("momentum", 0.9)),
        grad_clip=train_config.get("grad_clip"),
        accumulate=int(train_config.get("gradient_accumulation_steps", 1)
                       or 1))


def get_learning_rate(opt_state: OptState) -> float:
    return float(opt_state.learning_rate)


def set_learning_rate(opt_state: OptState, lr: float) -> OptState:
    """Set the injected learning rate (stored in float32, as optax's
    inject_hyperparams stores it)."""
    opt_state.learning_rate = _f32(lr)
    return opt_state
