"""Model factory (counterpart: hydragnn_tpu/models/create.py).

`create_model` builds the stack for a `ModelConfig` on a device (the card
unless the caller passes device="cpu"), initializes it like Flax would
(`init_params`) and returns it in eval mode. GIN, SAGE, GAT, MFC, CGCNN,
PNA, PNAPlus, SchNet, EGNN, DimeNet, PAINN, PNAEq and MACE: the JAX
package's 13 architectures.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from ..config.config import ModelConfig
from ..utils.devices import resolve_device
from .base import BaseStack
from .convs import GATv2Conv, GINConv, MFConv
from .dimenet import DIMEStack
from .egnn import EGCL, EGCLStack
from .layers import MLPNode
from .mace import LinearIrreps, MACEStack
from .painn import PAINNStack
from .pnaeq import PNAEqStack
from .schnet import SCFStack
from .stacks import (CGCNNStack, GATStack, GINStack, MFCStack, PNAPlusStack,
                     PNAStack, SAGEStack)

_PORTED = {"GIN": GINStack, "SAGE": SAGEStack, "GAT": GATStack,
           "MFC": MFCStack, "CGCNN": CGCNNStack, "PNA": PNAStack,
           "PNAPlus": PNAPlusStack, "SchNet": SCFStack, "EGNN": EGCLStack,
           "DimeNet": DIMEStack, "PAINN": PAINNStack, "PNAEq": PNAEqStack,
           "MACE": MACEStack}
# architecture keys each model needs, as the JAX package requires
_REQUIRED = {"PNA": ("pna_deg",),
             "PNAPlus": ("pna_deg", "radius", "num_radial",
                         "envelope_exponent"),
             "PNAEq": ("pna_deg", "radius"),
             "SchNet": ("radius", "num_gaussians", "num_filters"),
             "MFC": ("max_neighbours",),
             "DimeNet": ("radius", "num_radial", "num_spherical",
                         "int_emb_size", "basis_emb_size", "out_emb_size",
                         "num_before_skip", "num_after_skip",
                         "envelope_exponent"),
             "PAINN": ("radius",),
             "MACE": ("radius", "max_ell", "node_max_ell",
                      "avg_num_neighbors")}
_NOT_PORTED: dict = {}


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


def data_input_dim(cfg: ModelConfig, samples: Sequence) -> ModelConfig:
    """`cfg` with `input_dim` the width of the samples' node features, the
    width Flax sizes the first conv by at init (the config's is the count
    of `input_node_features`: the atomistic examples' samples carry
    x = [Z, pos, forces], 7 columns, under input_node_features [0..3],
    and the JAX package's models read all 7)."""
    if not samples or samples[0].x.shape[-1] == cfg.input_dim:
        return cfg
    return dataclasses.replace(cfg, input_dim=int(samples[0].x.shape[-1]))


def create_model(cfg: ModelConfig, device="cuda", seed: int = 0) -> BaseStack:
    """Validate, build, initialize (`init_params`) and move to `device`;
    the model is returned in eval mode."""
    dev = resolve_device(device)
    cls = model_class(cfg.model_type)
    _require(cfg, *_REQUIRED.get(cfg.model_type, ()))
    if cfg.model_type == "CGCNN" and cfg.hidden_dim != cfg.input_dim:
        # CGConv cannot change width
        cfg = dataclasses.replace(cfg, hidden_dim=cfg.input_dim)
    model = cls(cfg)
    init_params(model, seed=seed)
    return model.to(dev).eval()


def _lecun_normal(shape, fan_in: int, gen) -> torch.Tensor:
    # truncated normal at +-2 std whose variance is 1 / fan_in (the
    # truncation shrinks it by 0.8796..² , which the std undoes), as
    # Flax's variance_scaling(1, "fan_in", "truncated_normal")
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
    return w


def init_params(model: BaseStack, seed: int = 0) -> BaseStack:
    """Flax's default initializers from a seeded generator: Dense kernels
    lecun_normal, zero biases; MaskedBatchNorm scale 1, bias 0, running
    mean 0 and var 1; MFConv's banks [d, in, out] lecun_normal with
    fan_in d * in (Flax multiplies the receptive field in) and zero bank
    biases; GATv2's att [1, H, F] lecun_normal with fan_in H; MACE's
    LinearIrreps weights [mul_in, mul_out] lecun_normal; mlp_per_node
    banks [num_nodes, in, f] lecun_normal with fan_in num_nodes * in and
    zero bank biases; GIN's eps
    100 and EGNN's coords_range 3 (their constructors' values). The
    config's `initial_bias` fills every head's final bias. The numbers
    differ from Flax's for the same seed; weights that must match the JAX
    package are carried across with utils/weights.py instead."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(_lecun_normal(mod.weight.shape,
                                               mod.in_features, gen))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, MFConv):
                for w in (mod.w_l, mod.w_r):
                    w.copy_(_lecun_normal(w.shape, w.shape[0] * w.shape[1],
                                          gen))
                mod.b_l.zero_()
                mod.b_r.zero_()
            elif isinstance(mod, GATv2Conv):
                mod.att.copy_(_lecun_normal(mod.att.shape, mod.att.shape[1],
                                            gen))
            elif isinstance(mod, LinearIrreps):
                for w in mod.parameters(recurse=False):
                    w.copy_(_lecun_normal(w.shape, w.shape[0], gen))
            elif isinstance(mod, MLPNode) and mod.node_type == "mlp_per_node":
                for li in range(len(mod.dims)):
                    w = getattr(mod, f"w_{li}")
                    w.copy_(_lecun_normal(w.shape, w.shape[0] * w.shape[1],
                                          gen))
                    getattr(mod, f"b_{li}").zero_()
            elif isinstance(mod, GINConv):
                mod.eps.fill_(100.0)
            elif isinstance(mod, EGCL) and hasattr(mod, "coords_range"):
                mod.coords_range.fill_(3.0)
        bias0 = model.cfg.initial_bias
        if bias0 is not None:
            # the decoder's heads (MACE's readouts hold theirs, which the
            # JAX package leaves as they are)
            for ih in range(len(model.cfg.heads)):
                # a conv head projects through its bare Dense
                head = getattr(model, f"head_{ih}",
                               getattr(model, f"head_{ih}_out", None))
                if head is None:
                    continue
                last = [m for m in head.modules() if isinstance(m, nn.Linear)]
                if last and last[-1].bias is not None:
                    last[-1].bias.fill_(float(bias0))
    return model
