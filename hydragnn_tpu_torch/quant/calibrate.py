"""Deterministic per-channel activation calibration for int8 PTQ
(counterpart: hydragnn_tpu/quant/calibrate.py, whose host-side helpers
this copies and holds bitwise).

The pass runs the float32 model over a calibration set and records, for
every encoder-conv `models.layers.Dense`, the per-input-channel absolute
maximum of the activations entering it (forward pre-hooks). Scales are
symmetric (amax / 127), so the int8 product needs no zero points
(quant/ptq.py).

Determinism is a contract:

* the same calibration set gives bitwise the same scales and digest.
  Per-sample ranges accumulate by `np.maximum`, so the result depends
  neither on the samples' order nor on how the set is sharded
  (`merge_calibrations`);
* every sample is collated alone, into the padded shape
  `_calibration_shape` gives for that sample alone (the JAX package
  takes one shape for the whole set; on the card cuBLAS's float32
  products round a row differently at another row count, so a shard's
  shape would change its scales), and padding rows are left out of the
  absmax:
  node-length inputs are masked by `node_mask`, edge-length ones by
  `edge_mask` (by their leading dimension; an input of any other shape,
  such as a 3-D [N, K, F] one, keeps all rows). Padding rows carry
  garbage (PNA's attenuation scaler turns a zero-degree padding row into
  ~1e3-1e4), which would quantize every real row to zero;
* keys are the layers' module names with "." as "/", the port keeping
  Flax's submodule names, so they are JAX's `"/".join(module.path)`.

The pass reports a `quant.calibrate` span and the
`quant.calibrations_total` / `quant.calibration_samples_total` counters
and the `quant.calibrated_layers` gauge into the telemetry registry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graphs.batch import GraphSample, collate
from ..models.layers import Dense
from ..telemetry import spans as _spans
from ..telemetry.registry import get_registry
from ..utils.weights import load_jax_variables


def encoder_conv_path(path: Sequence[str], num_conv_layers: int) -> bool:
    """True when a module `path` (root-relative names) lies inside the
    encoder's conv stack: top-level `conv_<i>` with i < num_conv_layers.
    Conv node heads reuse the prefix at num_conv_layers + 100 * head +
    layer and stay float32 (they are the distillation's target)."""
    if not path:
        return False
    name = str(path[0])
    if not name.startswith("conv_"):
        return False
    try:
        idx = int(name[len("conv_"):])
    except ValueError:
        return False
    return idx < int(num_conv_layers)


def encoder_param_key(key: str, num_conv_layers: int) -> bool:
    """True for the top-level parameter keys the encoder owns: its convs
    and their `feature_norm_<i>`. The rest (heads, `graph_shared`, head
    convs and norms) is what the distillation trains."""
    if encoder_conv_path((key,), num_conv_layers):
        return True
    return str(key).startswith("feature_norm_")


def scales_digest(scales: Dict[str, np.ndarray]) -> str:
    """sha256 over the sorted (key, float32 bytes) pairs: the identity the
    compile store keys int8 programs by (two calibrations share programs
    only if their scales are bitwise equal)."""
    h = hashlib.sha256()
    for key in sorted(scales):
        h.update(key.encode())
        h.update(b"=")
        h.update(np.ascontiguousarray(scales[key], np.float32).tobytes())
        h.update(b";")
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class CalibrationScales:
    """Per-layer per-input-channel scales (amax / 127; a channel that
    never fired takes the layer's largest scale, 1.0 for an all-silent
    layer), the absmax they came from (shard merges compose there), the
    sample count and the digest."""
    scales: Dict[str, np.ndarray]
    amax: Dict[str, np.ndarray]
    num_samples: int
    digest: str

    @staticmethod
    def from_amax(amax: Dict[str, np.ndarray],
                  num_samples: int) -> "CalibrationScales":
        scales = {}
        for key in sorted(amax):
            a = np.asarray(amax[key], np.float32)
            s = a / np.float32(127.0)
            # not a constant like 1.0: the activation scales fold into the
            # weight rows before the weights are quantized (quant/ptq.py),
            # and a large sentinel would set the per-output-channel absmax
            # and crush every calibrated row's weights to zero
            layer_max = np.float32(s.max()) if s.size else np.float32(0.0)
            fallback = layer_max if layer_max > 0 else np.float32(1.0)
            scales[key] = np.where(s > 0, s, fallback).astype(np.float32)
        return CalibrationScales(scales=scales,
                                 amax={k: np.asarray(v, np.float32)
                                       for k, v in sorted(amax.items())},
                                 num_samples=int(num_samples),
                                 digest=scales_digest(scales))


def merge_calibrations(parts: Sequence[CalibrationScales]
                       ) -> CalibrationScales:
    """The whole set's calibration from its shards': absmax max-reduced,
    counts added; any sharding merges to bitwise the one-pass scales."""
    if not parts:
        raise ValueError("merge_calibrations needs at least one part")
    amax: Dict[str, np.ndarray] = {}
    total = 0
    for part in parts:
        total += part.num_samples
        for key in sorted(part.amax):
            a = np.asarray(part.amax[key], np.float32)
            prev = amax.get(key)
            if prev is None:
                amax[key] = a.copy()
            elif prev.shape != a.shape:
                raise ValueError(
                    f"merge_calibrations: layer {key!r} has shape "
                    f"{a.shape} in one shard and {prev.shape} in "
                    "another — shards must calibrate the same "
                    "architecture")
            else:
                amax[key] = np.maximum(prev, a)
    return CalibrationScales.from_amax(amax, total)


def _calibration_shape(samples: Sequence[GraphSample]) -> tuple:
    """A collation shape for `samples`: their largest node and edge
    counts plus the padding slot, rounded up to 8, the edge axis moved 8
    further where the two coincide (the hooks tell node rows from edge
    rows by length). `calibrate` takes it for each sample alone."""
    max_n = max(int(s.num_nodes) for s in samples)
    max_e = max(int(s.num_edges) for s in samples)
    rup = lambda v: -(-int(v + 1) // 8) * 8  # noqa: E731
    n_node, n_edge = rup(max_n), rup(max_e)
    if n_edge == n_node:
        n_edge += 8
    return n_node, n_edge, 2


def model_state(model, state_or_variables) -> Optional[Dict[str, torch.Tensor]]:
    """The tensors a forward of `model` should read: None for the model's
    own; a TrainState's parameters and buffers; or a Flax
    `{"params", "batch_stats"}` tree carried across, on the model's
    device."""
    if state_or_variables is None:
        return None
    if hasattr(state_or_variables, "state_dict"):
        return dict(state_or_variables.state_dict())
    dev = next(model.parameters()).device
    return {k: v.to(dev) for k, v in
            load_jax_variables(state_or_variables).items()}


def calibrated_layers(model, num_conv_layers: int) -> Dict[str, Dense]:
    """{key: layer} of the encoder convs' Dense layers, keyed as JAX keys
    them ("/"-joined module path)."""
    return {name.replace(".", "/"): mod
            for name, mod in model.named_modules()
            if isinstance(mod, Dense)
            and encoder_conv_path(name.split("."), num_conv_layers)}


def calibrate(model, state_or_variables, mcfg,
              samples: Sequence[GraphSample], *,
              num_samples: Optional[int] = None,
              batch_transform=None) -> CalibrationScales:
    """The calibration pass: eager float32 eval forwards, on the model's
    device, over the first `num_samples` of `samples` (None: all),
    recording each encoder-conv Dense input's per-channel absmax on
    real rows. `state_or_variables`: see `model_state`."""
    subset: List[GraphSample] = list(samples)
    if num_samples is not None:
        subset = subset[:max(int(num_samples), 1)]
    if not subset:
        raise ValueError(
            "calibrate needs at least one calibration sample — int8 "
            "activation scales cannot be invented")
    layers = calibrated_layers(model, int(mcfg.num_conv_layers))
    state = model_state(model, state_or_variables)
    dev = next(model.parameters()).device
    amax: Dict[str, np.ndarray] = {}
    masks: Dict[int, torch.Tensor] = {}
    owner = threading.get_ident()

    def hook_for(key):
        def hook(mod, args):
            if threading.get_ident() != owner:
                return   # another thread's forward of a shared model
            x = args[0].detach().float()
            rows = x.reshape(-1, x.shape[-1])
            mask = masks.get(x.shape[0]) if x.dim() == 2 else None
            if mask is not None:
                rows = rows[mask]
            a = (rows.abs().amax(dim=0).cpu().numpy() if rows.numel()
                 else np.zeros((x.shape[-1],), np.float32))
            prev = amax.get(key)
            amax[key] = a if prev is None else np.maximum(prev, a)
        return hook

    handles = [mod.register_forward_pre_hook(hook_for(key))
               for key, mod in sorted(layers.items())]
    was_training = model.training
    model.eval()
    t0 = _spans.now()
    try:
        for sample in subset:
            n_node, n_edge, n_graph = _calibration_shape([sample])
            batch = collate([sample], n_node=n_node, n_edge=n_edge,
                            n_graph=n_graph)
            batch = batch.replace(y_graph=None, y_node=None, energy=None,
                                  forces=None)
            if batch_transform is not None:
                batch = batch_transform(batch)
            batch = batch.to(dev)
            masks.clear()
            masks[batch.node_mask.shape[0]] = batch.node_mask
            if batch.edge_mask is not None:
                masks[batch.edge_mask.shape[0]] = batch.edge_mask
            with torch.no_grad():
                if state is None:
                    model(batch)
                else:
                    torch.func.functional_call(model, state, (batch,))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if not amax:
        raise ValueError(
            "calibration recorded no conv-stack Dense activations — "
            f"model {type(model).__name__} exposes no encoder ``conv_<i>`` "
            "matmuls to quantize")
    result = CalibrationScales.from_amax(amax, len(subset))
    dur = _spans.now() - t0
    rec = _spans.current_recorder()
    if rec is not None:
        rec.add("quant.calibrate", t0, dur, "quant",
                {"samples": len(subset), "layers": len(result.scales),
                 "digest": result.digest[:12]})
    reg = get_registry()
    reg.counter_inc("quant.calibrations_total",
                    help="int8 calibration passes completed")
    reg.counter_inc("quant.calibration_samples_total",
                    float(len(subset)),
                    help="samples consumed by int8 calibration passes")
    reg.gauge_set("quant.calibrated_layers", float(len(result.scales)),
                  help="conv-stack Dense layers covered by the most "
                       "recent int8 calibration")
    return result
