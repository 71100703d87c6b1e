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
    # ZeRO (parallel/spmd.ZeroPartition): the slots hold this rank's rows
    # of the leaves it splits; None keeps every slot whole
    zero: Any = None


def _f32(x: float) -> float:
    """x rounded to float32, kept as a Python float."""
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it."""
    return float(1 - torch.tensor(decay, dtype=torch.float32)
                 ** torch.tensor(float(count), dtype=torch.float32))


def _moment_(m: Tensors, g: Tensors, decay: float, order: int) -> None:
    """m <- (1 - decay) g^order + decay m, in place: optax's update_moment
    (the two products added in the other order, which IEEE addition does
    not see)."""
    gp = g if order == 1 else torch._foreach_mul(g, g)
    torch._foreach_mul_(m, decay)
    torch._foreach_add_(m, torch._foreach_mul(gp, 1 - decay))


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(t * t))


# the columns of a step's scalar row (`Optimizer.step_scalars`)
SCALARS = ("neg_lr", "bias_correction_1", "bias_correction_2", "micro_step")
# the rules that count their updates for a bias correction
_COUNTED = ("Adam", "AdamW", "FusedLAMB", "Adamax")


class Optimizer:
    """One of the registry's update rules behind optional global-norm
    clipping, with an injectable learning rate and optional gradient
    accumulation: the port's counterpart of the optax transformation
    `select_optimizer` builds. `init(params)` -> OptState;
    `update(grads, state, params)` -> (updates, state); updates are None
    on a micro-step that only accumulates.

    Capture-safe: every slot and the accumulator are updated in place
    (their tensors, and so their addresses, stay those `init` made), and
    the scalars that change from step to step (-lr, the bias corrections
    1 - b^count, the micro-step divisor) are read from a float32 device
    tensor, one row a step (`step_scalars`), that the caller of a CUDA
    graph refills before each replay. The host keeps the counters
    (`count`, `mini_step`, `gradient_step`, the learning rate) and
    computes each row exactly as the Python scalars were computed, so a
    row's values, and the update's bits on the CPU, are the same."""

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
    def init(self, params: Sequence[torch.Tensor], zero=None) -> OptState:
        """The rule's slots, zeroed (Adagrad's at 0.1), and the
        accumulator. With a ZeRO partition (`parallel.spmd.
        ZeroPartition`) each slot of a leaf it splits holds only this
        rank's rows; the accumulator stays whole (the global-norm clip
        reads all of it)."""
        params = [p.detach() for p in params]
        acc_like = params
        if zero is not None:
            params = zero.local(params)
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
        state = OptState(learning_rate=self.learning_rate, slots=slots,
                         zero=zero)
        if self.accumulate > 1:
            state.acc_grads = _zeros(acc_like)
        return state

    # ---------------------------------------------------- host scalars --
    def applies(self, state: OptState) -> bool:
        """Whether the next `update` on `state` is an inner update (not a
        micro-step that only accumulates)."""
        return state.mini_step >= self.accumulate - 1

    def step_scalars(self, state: OptState) -> List[float]:
        """The next update's scalar row (columns `SCALARS`), from the
        host's counters: -lr, 1 - 0.9^c and 1 - 0.999^c with c the count
        that update takes, and mini_step + 1."""
        count = state.count + 1
        return [-state.learning_rate, _bias_correction(0.9, count),
                _bias_correction(0.999, count), float(state.mini_step + 1)]

    def advance(self, state: OptState) -> None:
        """Move the host's counters over one `update`, as `update` does:
        what the host runs in place of a captured update."""
        applies = self.applies(state)
        if self.accumulate > 1:
            if not applies:
                state.mini_step += 1
                return
            state.mini_step = 0
            state.gradient_step += 1
        if self.name in _COUNTED:
            state.count += 1

    # ----------------------------------------------------------- update --
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor],
               scalars: Optional[torch.Tensor] = None):
        """`scalars`: this step's row of `step_scalars` as a float32
        tensor on the parameters' device (made here when None). With a
        ZeRO partition on `state` the updates of the leaves it splits are
        this rank's rows (`zero.local`), computed from the whole gradient
        (the clip's global norm, LAMB's trust ratio over whole leaves), so
        they are bitwise the rows of the whole update."""
        grads = list(grads)
        params = [p.detach() for p in params]
        if scalars is None:
            scalars = torch.tensor(self.step_scalars(state),
                                   dtype=torch.float32,
                                   device=params[0].device)
        applies = self.applies(state)
        if self.accumulate == 1:
            updates = self._inner(grads, state, params, scalars)
        else:
            # optax.MultiSteps: a running mean of the micro-batch
            # gradients, one inner update every `accumulate` calls
            acc = state.acc_grads
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_div_(diff, scalars[3])
            torch._foreach_add_(acc, diff)
            updates = None
            if applies:
                updates = self._inner(acc, state, params, scalars)
                torch._foreach_zero_(acc)
        self.advance(state)
        return updates, state

    def _inner(self, g: Tensors, state: OptState, p: Tensors,
               scalars: torch.Tensor) -> Tensors:
        if self.grad_clip is not None:
            g = _clip_by_global_norm(g, self.grad_clip)
        zero = state.zero
        p_rule = p if zero is None else zero.local(p)
        u = self._rule(g if zero is None else zero.local(g), state, p_rule,
                       scalars)
        if self.name == "FusedLAMB":
            # the trust ratio of each whole leaf: a ZeRO rank gathers the
            # others' rows of u first (a collective)
            if zero is not None:
                u = zero.gather(u)
            u = [_trust_ratio(ui, pi) for ui, pi in zip(u, p)]
            if zero is not None:
                u = zero.local(u)
        # scale_by_learning_rate: -lr * u, with lr the float32 hyperparameter
        return torch._foreach_mul(u, scalars[0])

    def update_has_collective(self, state: OptState) -> bool:
        """Whether `update` on `state` runs a collective (ZeRO's LAMB
        gather), which a CUDA graph under gloo cannot hold."""
        return state.zero is not None and self.name == "FusedLAMB"

    def _rule(self, g: Tensors, state: OptState, p: Tensors,
              scalars: torch.Tensor) -> Tensors:
        name, s = self.name, state.slots
        if name == "SGD":
            torch._foreach_mul_(s["trace"], self.momentum)
            torch._foreach_add_(s["trace"], g)
            return list(s["trace"])
        if name in ("Adam", "AdamW", "FusedLAMB"):
            eps = 1e-6 if name == "FusedLAMB" else 1e-8
            _moment_(s["mu"], g, 0.9, 1)
            _moment_(s["nu"], g, 0.999, 2)
            mu_hat = torch._foreach_div(s["mu"], scalars[1])
            nu_hat = torch._foreach_div(s["nu"], scalars[2])
            u = torch._foreach_div(mu_hat, torch._foreach_add(
                torch._foreach_sqrt(nu_hat), eps))
            if name == "AdamW":
                u = torch._foreach_add(
                    u, torch._foreach_mul(p, self.weight_decay))
            # FusedLAMB's trust ratio: `_inner`, over whole leaves
            return u
        if name == "Adamax":
            _moment_(s["mu"], g, 0.9, 1)
            torch._foreach_mul_(s["nu"], 0.999)
            torch._foreach_maximum_(s["nu"], torch._foreach_add(
                torch._foreach_abs(g), 1e-8))
            mu_hat = torch._foreach_div(s["mu"], scalars[1])
            return torch._foreach_div(mu_hat, s["nu"])
        if name == "Adadelta":
            rho, eps = 0.9, 1e-6
            _moment_(s["e_g"], g, rho, 2)
            ratio = torch._foreach_div(
                torch._foreach_sqrt(torch._foreach_add(s["e_x"], eps)),
                torch._foreach_sqrt(torch._foreach_add(s["e_g"], eps)))
            u = torch._foreach_mul(ratio, g)
            _moment_(s["e_x"], u, rho, 2)
            return u
        if name == "Adagrad":
            sos = s["sum_of_squares"]
            torch._foreach_add_(sos, torch._foreach_mul(g, g))
            return [torch.where(t > 0, torch.rsqrt(t + 1e-7),
                                torch.zeros_like(t)) * gi
                    for t, gi in zip(sos, g)]
        # RMSprop
        _moment_(s["nu"], g, 0.9, 2)
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
    inject_hyperparams stores it); the next step's scalar row carries
    it, on the CPU and into a captured step alike."""
    opt_state.learning_rate = _f32(lr)
    return opt_state
