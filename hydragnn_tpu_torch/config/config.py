"""JSON config system (counterpart: hydragnn_tpu/config/config.py).

`update_config` completes a reference-schema JSON config from the loaded
data and `build_model_config` freezes it into the hashable `ModelConfig`
the models are built from. Both are host-side numpy and must produce
exactly what the JAX package produces for the same config and data.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..train.precision import canonical_or_f32
from ..utils.envflags import env_str, env_strict_flag

PNA_MODELS = ["PNA", "PNAPlus", "PNAEq"]
EQUIVARIANT_MODELS = ["EGNN", "SchNet", "PNAEq", "PAINN", "MACE"]
EDGE_MODELS = ["PNAPlus", "PNA", "CGCNN", "SchNet", "EGNN", "DimeNet", "MACE"]

_ARCH_DEFAULT_NONE_KEYS = [
    "radius", "radial_type", "distance_transform", "num_gaussians",
    "num_filters", "envelope_exponent", "num_after_skip", "num_before_skip",
    "basis_emb_size", "int_emb_size", "out_emb_size", "num_radial",
    "num_spherical", "correlation", "max_ell", "node_max_ell",
]


def load_config(path_or_dict) -> Dict[str, Any]:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict) as f:
        return json.load(f)


def get_log_name_config(config: Dict[str, Any]) -> str:
    """The run's name, mangled from its hyperparameters as the JAX
    package names it: checkpoints live under ./logs/<name>/."""
    nn = config["NeuralNetwork"]
    arch = nn["Architecture"]
    train = nn["Training"]
    voi = nn["Variables_of_interest"]
    return (
        arch["model_type"]
        + "-r-" + str(arch.get("radius"))
        + "-ncl-" + str(arch["num_conv_layers"])
        + "-hd-" + str(arch["hidden_dim"])
        + "-ne-" + str(train["num_epoch"])
        + "-lr-" + str(train["Optimizer"].get("learning_rate"))
        + "-bs-" + str(train["batch_size"])
        + "-data-" + config.get("Dataset", {}).get("name", "dataset")
        + "-node_ft-" + "".join(str(x) for x in
                                voi.get("input_node_features", []))
        + "-task_weights-" + "".join(
            f"{w}-" for w in train.get("task_weights",
                                       arch.get("task_weights", [])))
    )


def update_config(config: Dict[str, Any], train_data, val_data=None,
                  test_data=None) -> Dict[str, Any]:
    """Config completion pass after data load: output dims, input dim,
    the PNA degree histogram (which also overwrites `max_neighbours` with
    the data's maximum in-degree) and the architecture defaults."""
    nn = config["NeuralNetwork"]
    train_cfg = nn["Training"]
    voi = nn["Variables_of_interest"]

    ds_cfg = nn.get("ds_config") or {}
    if (isinstance(ds_cfg, dict)
            and "gradient_accumulation_steps" in ds_cfg
            and "gradient_accumulation_steps" not in train_cfg):
        try:
            train_cfg["gradient_accumulation_steps"] = int(
                ds_cfg["gradient_accumulation_steps"])
        except (TypeError, ValueError):
            pass  # DeepSpeed's "auto" -> leave accumulation off

    sample0 = train_data[0]
    graph_size_variable = _graph_size_variable(train_data, val_data, test_data)
    if env_str("HYDRAGNN_USE_VARIABLE_GRAPH_SIZE") is not None:
        graph_size_variable = env_strict_flag(
            "HYDRAGNN_USE_VARIABLE_GRAPH_SIZE", graph_size_variable)

    nn = _update_config_NN_outputs(config, nn, sample0, graph_size_variable)
    arch = nn["Architecture"]

    arch["input_dim"] = len(voi["input_node_features"])

    if arch["model_type"] in PNA_MODELS:
        deg = getattr(train_data, "pna_deg", None)
        if deg is None:
            deg = gather_deg(train_data)
        arch["pna_deg"] = list(np.asarray(deg).astype(int).tolist())
        arch["max_neighbours"] = len(arch["pna_deg"]) - 1
    else:
        arch["pna_deg"] = None

    if arch["model_type"] == "MACE":
        avg = getattr(train_data, "avg_num_neighbors", None)
        if avg is None:
            avg = calculate_avg_deg(train_data)
        arch["avg_num_neighbors"] = float(avg)
    else:
        arch["avg_num_neighbors"] = None

    for key in _ARCH_DEFAULT_NONE_KEYS:
        arch.setdefault(key, None)

    arch = _update_config_edge_dim(arch)
    arch = _update_config_equivariance(arch)

    arch.setdefault("freeze_conv_layers", False)
    arch.setdefault("initial_bias", None)
    arch.setdefault("activation_function", "relu")
    arch.setdefault("SyncBatchNorm", False)
    train_cfg.setdefault("Optimizer", {"type": "AdamW"})
    train_cfg.setdefault("loss_function_type", "mse")
    train_cfg.setdefault("conv_checkpointing", False)
    train_cfg.setdefault("compute_grad_energy", False)

    _update_config_minmax(config, train_data)

    nn["Architecture"] = arch
    config["NeuralNetwork"] = nn
    return config


def _update_config_minmax(config, train_data):
    """x_minmax/y_minmax for output denormalization, from the
    `Dataset.minmax_*_feature` keys or the train dataset's attributes; a
    config asking for denormalization without either turns it off with a
    warning."""
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    if not voi.get("denormalize_output"):
        return
    ds = config.get("Dataset", {})
    node_mm = ds.get("minmax_node_feature",
                     getattr(train_data, "minmax_node_feature", None))
    graph_mm = ds.get("minmax_graph_feature",
                      getattr(train_data, "minmax_graph_feature", None))
    node_mm = None if node_mm is None else np.asarray(node_mm, np.float64)
    graph_mm = None if graph_mm is None else np.asarray(graph_mm, np.float64)

    y_minmax = []
    for otype, oidx in zip(voi["type"], voi["output_index"]):
        mm = graph_mm if otype == "graph" else node_mm
        if mm is None:
            logging.getLogger("hydragnn_tpu_torch").warning(
                "denormalize_output set but no minmax metadata available "
                "(no Dataset.minmax_*_feature keys and the dataset object "
                "carries none) — disabling denormalization")
            voi["denormalize_output"] = False
            return
        y_minmax.append(mm[:, int(oidx)].tolist())
    voi["y_minmax"] = y_minmax
    if node_mm is not None:
        voi["x_minmax"] = [node_mm[:, int(i)].tolist()
                           for i in voi["input_node_features"]]


def _graph_size_variable(*datasets) -> bool:
    size = None
    for ds in datasets:
        if ds is None:
            continue
        for s in ds:
            n = s.num_nodes
            if size is None:
                size = n
            elif n != size:
                return True
    return False


def _update_config_equivariance(arch):
    if arch.get("equivariance"):
        if arch["model_type"] not in EQUIVARIANT_MODELS:
            raise ValueError(
                "E(3) equivariance can only be ensured for "
                + ", ".join(EQUIVARIANT_MODELS)
                + f"; got model_type={arch['model_type']!r}")
    elif "equivariance" not in arch:
        arch["equivariance"] = False
    return arch


def _update_config_edge_dim(arch):
    arch["edge_dim"] = None
    if arch.get("edge_features"):
        if arch["model_type"] not in EDGE_MODELS:
            raise ValueError(
                "Edge features can only be used with "
                + ", ".join(EDGE_MODELS)
                + f"; got model_type={arch['model_type']!r}")
        arch["edge_dim"] = len(arch["edge_features"])
    elif arch["model_type"] == "CGCNN":
        arch["edge_dim"] = 0
    return arch


def _update_config_NN_outputs(config, nn, sample0, graph_size_variable):
    """Per-head output dims from the Dataset feature dims at
    `output_index`, else from sample 0's labels, else from
    `Variables_of_interest.output_dim`."""
    voi = nn["Variables_of_interest"]
    arch = nn["Architecture"]
    output_type = voi["type"]
    output_index = voi.get("output_index", list(range(len(output_type))))
    ds = config.get("Dataset", {})
    dims_list = []
    for ihead, ot in enumerate(output_type):
        if ot == "graph":
            if "graph_features" in ds:
                dims_list.append(int(ds["graph_features"]["dim"][output_index[ihead]]))
            elif sample0.y_graph is not None and len(
                    [t for t in output_type if t == "graph"]) == 1:
                dims_list.append(int(sample0.y_graph.shape[0]))
            else:
                dims_list.append(int(voi["output_dim"][ihead]))
        elif ot == "node":
            if (graph_size_variable
                    and arch["output_heads"]["node"]["type"] == "mlp_per_node"):
                raise ValueError(
                    '"mlp_per_node" is not allowed for variable graph size; '
                    'set output_heads.node.type to "mlp" or "conv"')
            if "node_features" in ds:
                dims_list.append(int(ds["node_features"]["dim"][output_index[ihead]]))
            elif sample0.y_node is not None and len(
                    [t for t in output_type if t == "node"]) == 1:
                dims_list.append(int(sample0.y_node.shape[1]))
            else:
                dims_list.append(int(voi["output_dim"][ihead]))
        else:
            raise ValueError("Unknown output type", ot)
    arch["output_dim"] = dims_list
    arch["output_type"] = output_type
    arch["num_nodes"] = sample0.num_nodes
    return nn


def gather_deg(dataset, max_deg_cap: int = 512) -> np.ndarray:
    """In-degree histogram over a dataset; isolated nodes count into
    hist[0]."""
    counts = np.zeros(max_deg_cap + 1, np.int64)
    maxd = 0
    for s in dataset:
        deg = np.bincount(np.asarray(s.receivers), minlength=s.num_nodes)
        full = np.bincount(deg, minlength=max_deg_cap + 1)[:max_deg_cap + 1]
        counts[:len(full)] += full
        maxd = max(maxd, int(deg.max(initial=0)))
    return counts[:maxd + 1]


def calculate_avg_deg(dataset) -> float:
    tot_e, tot_n = 0, 0
    for s in dataset:
        tot_e += s.num_edges
        tot_n += s.num_nodes
    return tot_e / max(tot_n, 1)


# ---------------------------------------------------------------------------
# Static (hashable) model config consumed by the models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadConfig:
    head_type: str                 # "graph" | "node"
    output_dim: int
    offset: int                    # static slice offset into y_graph / y_node
    name: str = ""
    num_sharedlayers: int = 2
    dim_sharedlayers: int = 32
    num_headlayers: int = 2
    dim_headlayers: Tuple[int, ...] = (32, 32)
    node_arch: str = "mlp"         # mlp | mlp_per_node | conv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Frozen architecture description, field for field the JAX
    package's ModelConfig."""
    model_type: str
    input_dim: int
    hidden_dim: int
    num_conv_layers: int
    heads: Tuple[HeadConfig, ...]
    activation: str = "relu"
    output_dim: Tuple[int, ...] = ()
    output_type: Tuple[str, ...] = ()
    task_weights: Tuple[float, ...] = ()
    num_nodes: int = 0
    edge_dim: Optional[int] = None
    radius: Optional[float] = None
    max_neighbours: Optional[int] = None
    pna_deg: Optional[Tuple[int, ...]] = None
    num_gaussians: Optional[int] = None
    num_filters: Optional[int] = None
    envelope_exponent: Optional[int] = None
    num_radial: Optional[int] = None
    num_spherical: Optional[int] = None
    int_emb_size: Optional[int] = None
    basis_emb_size: Optional[int] = None
    out_emb_size: Optional[int] = None
    num_before_skip: Optional[int] = None
    num_after_skip: Optional[int] = None
    equivariance: bool = False
    radial_type: Optional[str] = None
    distance_transform: Optional[str] = None
    correlation: Optional[Any] = None
    max_ell: Optional[int] = None
    node_max_ell: Optional[int] = None
    avg_num_neighbors: Optional[float] = None
    num_elements: int = 118
    var_output: int = 0            # GaussianNLL variance widening
    freeze_conv: bool = False
    initial_bias: Optional[float] = None
    conv_checkpointing: bool = False
    batch_norm: bool = True
    dtype: str = "float32"


def build_model_config(config: Dict[str, Any]) -> ModelConfig:
    """Completed JSON -> ModelConfig."""
    nn = config["NeuralNetwork"]
    arch = nn["Architecture"]
    train_cfg = nn.get("Training", {})
    loss = train_cfg.get("loss_function_type", "mse")
    var_output = 1 if loss == "GaussianNLLLoss" else 0

    heads: List[HeadConfig] = []
    goff, noff = 0, 0
    oh = arch.get("output_heads", {})
    for ot, od in zip(arch["output_type"], arch["output_dim"]):
        if ot == "graph":
            g = oh.get("graph", {})
            dh = g.get("dim_headlayers", [32] * g.get("num_headlayers", 2))
            heads.append(HeadConfig(
                head_type="graph", output_dim=int(od), offset=goff,
                num_sharedlayers=g.get("num_sharedlayers", 2),
                dim_sharedlayers=g.get("dim_sharedlayers", 32),
                num_headlayers=g.get("num_headlayers", len(dh)),
                dim_headlayers=tuple(dh)))
            goff += int(od)
        else:
            n = oh.get("node", {})
            dh = n.get("dim_headlayers", [32] * n.get("num_headlayers", 2))
            if n.get("type", "mlp") == "conv" and not dh:
                raise ValueError(
                    "output_heads.node.type='conv' requires "
                    "num_headlayers >= 1 / non-empty dim_headlayers")
            heads.append(HeadConfig(
                head_type="node", output_dim=int(od), offset=noff,
                num_headlayers=n.get("num_headlayers", len(dh)),
                dim_headlayers=tuple(dh),
                node_arch=n.get("type", "mlp")))
            noff += int(od)

    tw = train_cfg.get("task_weights", arch.get("task_weights"))
    if tw is None:
        tw = [1.0] * len(heads)

    return ModelConfig(
        model_type=arch["model_type"],
        input_dim=int(arch["input_dim"]),
        hidden_dim=int(arch["hidden_dim"]),
        num_conv_layers=int(arch["num_conv_layers"]),
        heads=tuple(heads),
        activation=arch.get("activation_function", "relu"),
        output_dim=tuple(int(d) for d in arch["output_dim"]),
        output_type=tuple(arch["output_type"]),
        task_weights=tuple(float(w) for w in tw),
        num_nodes=int(arch.get("num_nodes", 0)),
        edge_dim=arch.get("edge_dim"),
        radius=arch.get("radius"),
        max_neighbours=arch.get("max_neighbours"),
        pna_deg=tuple(arch["pna_deg"]) if arch.get("pna_deg") else None,
        num_gaussians=arch.get("num_gaussians"),
        num_filters=arch.get("num_filters"),
        envelope_exponent=arch.get("envelope_exponent"),
        num_radial=arch.get("num_radial"),
        num_spherical=arch.get("num_spherical"),
        int_emb_size=arch.get("int_emb_size"),
        basis_emb_size=arch.get("basis_emb_size"),
        out_emb_size=arch.get("out_emb_size"),
        num_before_skip=arch.get("num_before_skip"),
        num_after_skip=arch.get("num_after_skip"),
        equivariance=bool(arch.get("equivariance", False)),
        radial_type=arch.get("radial_type"),
        distance_transform=arch.get("distance_transform"),
        correlation=(tuple(arch["correlation"])
                     if isinstance(arch.get("correlation"), list)
                     else arch.get("correlation")),
        max_ell=arch.get("max_ell"),
        node_max_ell=arch.get("node_max_ell"),
        avg_num_neighbors=arch.get("avg_num_neighbors"),
        var_output=var_output,
        freeze_conv=bool(arch.get("freeze_conv_layers", False)),
        initial_bias=arch.get("initial_bias"),
        conv_checkpointing=bool(train_cfg.get("conv_checkpointing", False)),
        batch_norm=not bool(arch.get("equivariance", False)),
        dtype=canonical_or_f32(arch.get("dtype")),
    )
