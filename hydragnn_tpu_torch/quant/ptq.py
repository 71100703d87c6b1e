"""Symmetric per-channel int8 products for the serving tier (counterpart:
hydragnn_tpu/quant/ptq.py).

The math, per calibrated `models.layers.Dense` (weight [out, in], the
activation scales `s_x` [in] from quant/calibrate.py):

* x_q = clip(round(x / s_x), -127, 127) as int8;
* the activation scales fold into the weight's input columns,
  w_fold[o, i] = w[o, i] * s_x[i];
* the weights quantize per output channel, s_w[o] = max_i |w_fold[o, i]|
  / 127 (1 where that is 0), w_q = clip(round(w_fold / s_w), -127, 127);
* the product is int8 x int8 with exact int32 accumulation, then one
  float32 multiply and the float32 bias: y = (x_q @ w_q^T) * s_w + b.

The int32 accumulation is exact, so the error against float32 is the two
roundings alone, the basis of the engine's SERVE_INT8_RTOL / ATOL = 2^-3.

The product is `torch._int_mm` (cuBLASLt's int8 GEMM on the card; the
JAX package's is a plain `dot_general` outside any Pallas kernel, so no
kernel is ported for it). On the card `_int_mm` takes more than 16 rows
and an inner and outer width that are multiples of 8: the operands are
padded with zero rows and columns there and the result sliced, which is
exact in int32.

The weights are quantized inside the forward from the live float32
parameters, so a serving bucket's CUDA graph quantizes them at every
replay and `swap_variables`' new weights are quantized at the next one,
with nothing recaptured. The activation scales are constants of the
program: device tensors made once a calibration, and the reason the
compile store keys int8 programs by the calibration's digest.
"""
from __future__ import annotations

import copy
import itertools

import torch
from torch import nn
import torch.nn.functional as F

from .calibrate import CalibrationScales, calibrated_layers


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exactly. On the card the
    operands are zero-padded to `_int_mm`'s shapes (M > 16, K and N
    multiples of 8) and the result sliced back."""
    if a.device.type != "cuda":
        # the CPU's _int_mm misreads a [1, N] operand whose row stride is
        # not N (the transpose of a [N, 1] weight: a Dense of one input
        # column), so that one gets a row-major copy
        if b.shape[0] == 1 and b.stride(0) != b.shape[1]:
            b = b.clone(memory_format=torch.contiguous_format)
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a, b)
    return out[:m, :n] if (mp, np_) != (m, n) else out


def quantize_weight(weight: torch.Tensor, s_x: torch.Tensor):
    """(w_q [out, in] int8, s_w [out] float32) of a Dense weight under the
    activation scales `s_x`."""
    w_fold = weight.float() * s_x[None, :]
    # a true division by a device tensor: CUDA divides by a Python scalar
    # as a product with its reciprocal, which rounds otherwise
    s_w = torch.amax(torch.abs(w_fold), dim=1) / torch.full(
        (), 127.0, device=w_fold.device)
    s_w = torch.where(s_w > 0, s_w, torch.ones_like(s_w))
    w_q = torch.clamp(torch.round(w_fold / s_w[:, None]),
                      -127.0, 127.0).to(torch.int8)
    return w_q, s_w


def quantize_input(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """x_q = clip(round(x / s_x), -127, 127) as int8."""
    return torch.clamp(torch.round(x.float() / s_x), -127.0,
                       127.0).to(torch.int8)


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias, s_x):
    """One calibrated int8 Dense: float32 in and out, the product in int8
    with int32 accumulation (the module docstring has the math). `weight`
    is the port's [out, in]; x may have any leading dimensions."""
    if weight.shape[1] != s_x.shape[0]:
        raise ValueError(
            f"int8_dense: calibration scales cover {s_x.shape[0]} input "
            f"channels but the kernel has {weight.shape[1]} — the "
            "calibration was taken on a different architecture; "
            "re-calibrate (quant/calibrate.py)")
    lead = x.shape[:-1]
    x_q = quantize_input(x, s_x).reshape(-1, x.shape[-1])
    w_q, s_w = quantize_weight(weight, s_x)
    acc = int_mm(x_q, w_q.t())
    y = acc.to(torch.float32) * s_w
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*lead, y.shape[-1])


class Int8Dense(nn.Module):
    """A calibrated Dense computed by `int8_dense`: it holds the float32
    layer's own weight and bias (so it reads their live values) and the
    layer's activation scales `s_x`."""

    def __init__(self, dense: nn.Module, s_x: torch.Tensor):
        super().__init__()
        self.weight = dense.weight
        self.bias = dense.bias
        self.s_x = s_x

    def forward(self, x):
        return int8_dense(x, self.weight, self.bias, self.s_x)


def make_quantized_forward(model, mcfg, calibration: CalibrationScales):
    """The int8 serving forward: `forward(batch) -> (outputs,
    outputs_var)`, as `train_step.make_forward_fn`'s. It is a copy of
    `model` that shares its parameters and buffers, with every calibrated
    Dense replaced by an `Int8Dense`; the heads, `graph_shared`, the
    norms and the head convs compute in float32, and `model` itself is
    left as it was. The scales become tensors on the model's device here,
    once."""
    dev = next(model.parameters()).device
    shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                model.buffers())}
    qmodel = copy.deepcopy(model, shared)
    for key, layer in calibrated_layers(qmodel,
                                        int(mcfg.num_conv_layers)).items():
        if key not in calibration.scales:
            continue
        s_x = torch.as_tensor(calibration.scales[key], dtype=torch.float32,
                              device=dev)
        *path, name = key.split("/")
        setattr(qmodel.get_submodule(".".join(path)), name,
                Int8Dense(layer, s_x))
    return qmodel
