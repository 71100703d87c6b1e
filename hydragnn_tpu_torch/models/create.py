"""Model factory (counterpart: hydragnn_tpu/models/create.py).

`create_model` builds the stack for a `ModelConfig` on a device (the card
unless the caller passes device="cpu"), initializes it like Flax would
(`init_params`) and returns it in eval mode. PNA and SchNet are ported;
every other `model_type` raises NotImplementedError naming the ROADMAP
item that brings it.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config.config import ModelConfig
from ..utils.devices import resolve_device
from .base import BaseStack
from .schnet import SCFStack
from .stacks import PNAStack

_PORTED = {"PNA": PNAStack, "SchNet": SCFStack}
# architecture keys each ported model needs, as the JAX package requires
_REQUIRED = {"PNA": ("pna_deg",),
             "SchNet": ("radius", "num_gaussians", "num_filters")}
_NOT_PORTED = {
    "GIN": "A7", "EGNN": "A7", "SAGE": "A7", "GAT": "A7", "MFC": "A7",
    "CGCNN": "A7", "PNAPlus": "A7", "DimeNet": "A7", "PAINN": "A7",
    "PNAEq": "A7", "MACE": "A7",
}


def model_class(model_type: str):
    if model_type in _PORTED:
        return _PORTED[model_type]
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported to hydragnn_tpu_torch "
            f"yet (ROADMAP item {_NOT_PORTED[model_type]})")
    raise ValueError(f"unknown model_type '{model_type}'; known: "
                     f"{sorted([*_PORTED, *_NOT_PORTED])}")


def _require(cfg: ModelConfig, *fields: str):
    for f in fields:
        if getattr(cfg, f) is None:
            raise ValueError(
                f"{cfg.model_type} requires architecture key '{f}'")


def create_model(cfg: ModelConfig, device="cuda", seed: int = 0) -> BaseStack:
    """Validate, build, initialize (`init_params`) and move to `device`;
    the model is returned in eval mode."""
    dev = resolve_device(device)
    cls = model_class(cfg.model_type)
    _require(cfg, *_REQUIRED[cfg.model_type])
    model = cls(cfg)
    init_params(model, seed=seed)
    return model.to(dev).eval()


def init_params(model: BaseStack, seed: int = 0) -> BaseStack:
    """Flax's default initializers from a seeded generator: Dense kernels
    lecun_normal (truncated normal, variance 1/fan_in), zero biases;
    MaskedBatchNorm scale 1, bias 0, running mean 0 and var 1. The
    config's `initial_bias` fills every head's final bias. The numbers
    differ from Flax's for the same seed; weights that must match the JAX
    package are carried across with utils/weights.py instead."""
    gen = torch.Generator().manual_seed(int(seed))
    # truncated-normal std correction of variance_scaling (truncation at
    # +-2 std shrinks the variance by this factor squared)
    trunc = 0.87962566103423978
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / trunc
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
        bias0 = model.cfg.initial_bias
        if bias0 is not None:
            for ih in range(len(model.cfg.heads)):
                head = getattr(model, f"head_{ih}")
                last = [m for m in head.modules() if isinstance(m, nn.Linear)]
                if last and last[-1].bias is not None:
                    last[-1].bias.fill_(float(bias0))
    return model
