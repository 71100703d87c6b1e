"""Carry Flax variables across to the port and back (the bridge between
the two packages; the JAX package has no counterpart).

`load_jax_variables(variables)` takes the Flax `{"params", "batch_stats"}`
tree as nested dicts of numpy arrays and returns a state dict for
`model.load_state_dict`; `export_jax_variables(model)` is its inverse, the
tree of numpy arrays a Flax model of the same config applies. The port
keeps Flax's submodule names as attribute names (`conv_{i}.pre_i`,
`feature_norm_{i}`, `graph_shared.dense_{j}`, `head_{ih}.dense_{j}`,
...), so the mapping is mechanical:

* Dense `kernel [in, out]` -> Linear `weight [out, in]`;
* Dense `bias`, MaskedBatchNorm `scale` / `bias` keep their names;
* the convs' own parameters keep their names and shapes: GIN's `eps`,
  GATv2's `att`, MFConv's banks `w_l` / `b_l` / `w_r` / `b_r`, EGNN's
  `coords_range`, and MACE's `LinearIrreps` weights `lin_l{l}`
  [mul_in, mul_out] (applied through an einsum, not as a Dense kernel:
  they cross untransposed);
* `batch_stats` `mean` / `var` -> the MaskedBatchNorm buffers.

An unknown collection or leaf name raises here; a missing or surplus
module path raises in `load_state_dict` (strict by default).
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# the convs' own parameters, carried as they are
_CONV_LEAVES = ("eps", "att", "w_l", "b_l", "w_r", "b_r", "coords_range")
_LEAVES = {"params": ("kernel", "bias", "scale") + _CONV_LEAVES,
           "batch_stats": ("mean", "var")}
# MACE's LinearIrreps weights, one per l
_IRREPS_LEAF = re.compile(r"lin_l\d+")


def _known_leaf(collection: str, name: str, module: str) -> bool:
    """Whether `name` is a leaf of `collection` the port holds; a conv's
    own parameters may sit at the root (a bare conv), the others lie
    under a module."""
    if collection == "params" and _IRREPS_LEAF.fullmatch(name):
        return bool(module)
    return name in _LEAVES[collection] and bool(module
                                                or name in _CONV_LEAVES)


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def load_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    unknown = set(variables) - set(_LEAVES)
    if unknown:
        raise KeyError(f"load_jax_variables: unknown collections "
                       f"{sorted(unknown)}; expected {sorted(_LEAVES)}")
    state: Dict[str, torch.Tensor] = OrderedDict()
    for collection in _LEAVES:
        for path, arr in _walk(variables.get(collection, {})):
            name, module = path[-1], ".".join(path[:-1])
            if not _known_leaf(collection, name, module):
                raise KeyError(f"load_jax_variables: unexpected "
                               f"{collection} leaf {'/'.join(path)}")
            if name == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"load_jax_variables: Dense kernel "
                                     f"{'/'.join(path)} has shape {arr.shape}")
                arr, name = arr.T, "weight"
            key = f"{module}.{name}" if module else name
            if key in state:
                raise KeyError(f"load_jax_variables: duplicate key {key}")
            state[key] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return state


def variables_signature(variables: Mapping) -> Dict[Tuple[str, ...], Tuple]:
    """{(collection, *path): (shape, dtype)} over a Flax tree's `params`
    and `batch_stats`: what a hot swap must keep (the serving engine's
    `swap_variables`)."""
    return {(coll,) + path: (arr.shape, arr.dtype)
            for coll in ("params", "batch_stats")
            for path, arr in _walk(variables.get(coll, {}) or {})}


def export_jax_variables(model) -> Dict[str, Dict]:
    """The Flax `{"params", "batch_stats"}` tree (nested dicts of float32
    numpy arrays) of a model's state dict, or of a `TrainState`'s:
    Linear `weight [out, in]` -> Dense `kernel [in, out]`; `bias`,
    `scale` -> params; the MaskedBatchNorm buffers `mean` / `var` ->
    batch_stats. `load_jax_variables` of the result loads back bitwise."""
    state = model.state_dict()
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *path, leaf = key.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            leaf, arr = "kernel", arr.T
        coll = "batch_stats" if leaf in _LEAVES["batch_stats"] else "params"
        if not _known_leaf(coll, leaf, ".".join(path)):
            raise KeyError(f"export_jax_variables: unexpected entry {key}")
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(arr, order="C")  # keeps a 0-d leaf 0-d
    return tree


def random_flax_variables(model, seed: int) -> Dict:
    """A Flax {"params", "batch_stats"} tree of numpy arrays for `model`'s
    architecture with random weights and running statistics from `seed`
    (numpy's generator): Dense kernels N(0, 1/fan_in), biases N(0, 0.1),
    norm scales 1 + N(0, 0.1), running means N(0, 0.3) and variances
    uniform in [0.5, 1.5); MFConv's banks N(0, 1/(d in)) and their biases
    N(0, 0.1), MACE's LinearIrreps weights N(0, 1/mul_in), GATv2's att
    N(0, 1/H), GIN's eps 100 + N(0, 1) and EGNN's
    coords_range 3 + N(0, 0.1) (their initial values, moved). The smoke
    run's and the diagnostics' weights."""
    rng = np.random.default_rng(seed)
    tree: Dict = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        shape = tuple(t.shape)
        if leaf == "weight":
            leaf = "kernel"
            shape = shape[::-1]
            val = rng.normal(0.0, shape[0] ** -0.5, shape)
        elif leaf in ("w_l", "w_r") or _IRREPS_LEAF.fullmatch(leaf):
            # MFConv's banks [d, in, out], LinearIrreps' [mul_in, mul_out]
            fan_in = shape[0] * (shape[1] if len(shape) == 3 else 1)
            val = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == "att":
            val = rng.normal(0.0, shape[1] ** -0.5, shape)
        elif leaf == "eps":
            val = 100.0 + rng.normal(0.0, 1.0, shape)
        elif leaf == "coords_range":
            val = 3.0 + rng.normal(0.0, 0.1, shape)
        elif leaf in ("bias", "b_l", "b_r"):
            val = rng.normal(0.0, 0.1, shape)
        elif leaf == "scale":
            val = 1.0 + rng.normal(0.0, 0.1, shape)
        elif leaf == "mean":
            val = rng.normal(0.0, 0.3, shape)
        else:
            val = 0.5 + rng.random(shape)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val.astype(np.float32)
    return tree
