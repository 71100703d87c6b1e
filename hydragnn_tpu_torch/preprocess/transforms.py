"""Sample-level transforms: input and target selection, rotation
normalization, graph construction and edge descriptors (counterpart:
hydragnn_tpu/preprocess/transforms.py).

Host numpy, bitwise the JAX package's samples: the same numpy routines in
the same order (the eigen-decomposition of `normalize_rotation`
included). Targets pack into dense per-graph (`y_graph`) and per-node
(`y_node`) arrays. `build_graph_samples` is serial; the JAX package's
worker pool, which builds the same samples, is ROADMAP A10.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graphs.batch import GraphSample
from ..graphs.radius import radius_graph, radius_graph_pbc


def update_predicted_values(types: Sequence[str], indices: Sequence[int],
                            graph_feats: np.ndarray,
                            node_feats: np.ndarray,
                            graph_feature_dims: Sequence[int],
                            node_feature_dims: Sequence[int],
                            ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Select per-config targets (reference: :237-278). Returns
    (y_graph [Dg], y_node [N, Dn])."""
    g_parts, n_parts = [], []
    g_offsets = np.concatenate([[0], np.cumsum(graph_feature_dims)]).astype(int)
    n_offsets = np.concatenate([[0], np.cumsum(node_feature_dims)]).astype(int)
    for t, i in zip(types, indices):
        if t == "graph":
            g_parts.append(np.atleast_1d(
                graph_feats[g_offsets[i]:g_offsets[i + 1]]))
        elif t == "node":
            n_parts.append(node_feats[:, n_offsets[i]:n_offsets[i + 1]])
        else:
            raise ValueError(f"unknown output type {t}")
    y_graph = np.concatenate(g_parts) if g_parts else None
    y_node = np.concatenate(n_parts, axis=1) if n_parts else None
    return y_graph, y_node


def update_atom_features(input_indices: Sequence[int], node_feats: np.ndarray,
                         node_feature_dims: Sequence[int]) -> np.ndarray:
    """Select input feature columns (reference: :281-292)."""
    offsets = np.concatenate([[0], np.cumsum(node_feature_dims)]).astype(int)
    cols = [node_feats[:, offsets[i]:offsets[i + 1]] for i in input_indices]
    return np.concatenate(cols, axis=1)


def normalize_rotation(pos: np.ndarray, return_rotation: bool = False):
    """Rotate to principal axes (reference: torch_geometric NormalizeRotation
    used at serialized_dataset_loader.py:123-125): eigenbasis of the
    covariance of centered positions, sign-fixed. With
    ``return_rotation=True`` also returns the rotation matrix so callers can
    co-rotate the cell (the reference rotates pos only and leaves the cell,
    which breaks PBC minimum images; we keep the frames consistent)."""
    centered = pos - pos.mean(axis=0, keepdims=True)
    cov = centered.T @ centered
    _, vecs = np.linalg.eigh(cov)
    vecs = vecs[:, ::-1]  # descending eigenvalue order
    # fix signs for determinism
    for k in range(3):
        col = vecs[:, k]
        j = np.argmax(np.abs(col))
        if col[j] < 0:
            vecs[:, k] = -col
    if np.linalg.det(vecs) < 0:
        vecs[:, 2] = -vecs[:, 2]
    rotated = (centered @ vecs).astype(np.float32)
    if return_rotation:
        return rotated, vecs.astype(np.float32)
    return rotated


def build_graph_sample(
    node_feature_matrix: np.ndarray,
    pos: np.ndarray,
    config: Dict,
    graph_feats: Optional[np.ndarray] = None,
    cell: Optional[np.ndarray] = None,
    forces: Optional[np.ndarray] = None,
    energy: Optional[float] = None,
    edges: Optional[Tuple] = None,
    with_targets: bool = True,
) -> GraphSample:
    """Full raw -> GraphSample path for one structure: rotation
    normalization, radius graph (+PBC), input/target selection, optional
    edge-length features (reference: SerializedDataLoader.load_serialized_data
    serialized_dataset_loader.py:103-171).

    ``edges=(senders, receivers, shifts_or_None)`` skips the radius-graph
    construction and uses the given edge list instead. Incompatible with
    ``rotational_invariance`` (the edges were built in the unrotated
    frame). ``with_targets=False`` skips target selection entirely
    (``y_graph``/``y_node`` stay None) so inference clients can pass a
    feature matrix whose target columns are zero-filled placeholders.
    """
    ds = config["Dataset"]
    nn = config["NeuralNetwork"]
    arch = nn["Architecture"]
    voi = nn["Variables_of_interest"]
    node_dims = ds["node_features"]["dim"]
    graph_dims = ds.get("graph_features", {}).get("dim", [])

    if ds.get("rotational_invariance", False):
        if edges is not None:
            raise ValueError(
                "precomputed edges cannot be combined with "
                "Dataset.rotational_invariance — the edge list was built "
                "in the unrotated frame, the rotated positions would "
                "disagree with it")
        pos, rot = normalize_rotation(pos, return_rotation=True)
        if cell is not None:
            # co-rotate the lattice so PBC minimum images stay correct
            cell = (np.asarray(cell) @ rot).astype(np.float32)

    radius = float(arch.get("radius") or 5.0)
    max_nb = arch.get("max_neighbours")
    if edges is not None:
        send, recv, shifts = edges
    elif arch.get("periodic_boundary_conditions", False):
        if cell is None:
            raise ValueError(
                "periodic_boundary_conditions=true requires a cell "
                "(3x3 lattice) on every sample")
        send, recv, shifts = radius_graph_pbc(pos, cell, radius,
                                              max_neighbours=max_nb)
    else:
        shifts = None
        send, recv = radius_graph(pos, radius, max_neighbours=max_nb)

    x = update_atom_features(voi["input_node_features"],
                             node_feature_matrix, node_dims)
    if with_targets:
        y_graph, y_node = update_predicted_values(
            voi["type"], voi["output_index"],
            graph_feats if graph_feats is not None
            else np.zeros(0, np.float32),
            node_feature_matrix, graph_dims, node_dims)
    else:
        y_graph = y_node = None

    edge_attr = None
    vec = pos[send] - pos[recv]
    if shifts is not None:
        vec = vec + shifts
    if arch.get("edge_features"):
        # edge length feature, globally normalized later
        # (reference: serialized_dataset_loader.py:127-164 Distance transform)
        edge_attr = np.linalg.norm(vec, axis=1, keepdims=True).astype(np.float32)

    # optional geometric descriptors appended to edge_attr (reference:
    # Dataset.Descriptors SphericalCoordinates / PointPairFeatures,
    # serialized_dataset_loader.py:70-76,167-171)
    descriptors = ds.get("Descriptors", [])
    if "SphericalCoordinates" in descriptors:
        edge_attr = _append_edge_attr(edge_attr, spherical_coordinates(vec))
    if "PointPairFeatures" in descriptors:
        edge_attr = _append_edge_attr(
            edge_attr, point_pair_features(pos, vec, send, recv))

    return GraphSample(x=x, pos=pos, senders=send, receivers=recv,
                       edge_attr=edge_attr, edge_shifts=shifts,
                       y_graph=y_graph, y_node=y_node, cell=cell,
                       energy=energy, forces=forces)


def build_graph_samples(items: Sequence[Dict], config: Dict
                        ) -> List[GraphSample]:
    """`build_graph_sample` over a list of kwargs dicts, in order: the
    JAX package's serial path (its worker pool gives the same samples and
    is ROADMAP A10)."""
    return [build_graph_sample(config=config, **kw) for kw in items]


def _append_edge_attr(edge_attr, extra):
    extra = extra.astype(np.float32)
    if edge_attr is None:
        return extra
    return np.concatenate([edge_attr, extra], axis=1)


def spherical_coordinates(vec: np.ndarray) -> np.ndarray:
    """Per-edge spherical coordinates [rho, theta, phi] of the edge vector
    (the torch_geometric Spherical transform the reference applies,
    serialized_dataset_loader.py:168)."""
    rho = np.linalg.norm(vec, axis=1)
    theta = np.arctan2(vec[:, 1], vec[:, 0])
    theta = theta + (theta < 0) * (2 * np.pi)
    phi = np.arccos(np.clip(vec[:, 2] / np.maximum(rho, 1e-12), -1.0, 1.0))
    return np.stack([rho, theta, phi], axis=1)


def point_pair_features(pos: np.ndarray, vec: np.ndarray,
                        send: np.ndarray, recv: np.ndarray) -> np.ndarray:
    """Per-edge point-pair features [d, angle(n_i, d), angle(n_j, d),
    angle(n_i, n_j)] (torch_geometric PointPairFeatures, reference
    serialized_dataset_loader.py:171). Atomistic data carries no surface
    normals, so the radially-outward direction from the structure centroid
    stands in for them — rotation-invariant and well-defined for point
    clouds."""
    center = pos.mean(axis=0, keepdims=True)
    normals = pos - center
    nrm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(nrm, 1e-12)
    d = np.linalg.norm(vec, axis=1)
    unit = vec / np.maximum(d[:, None], 1e-12)

    def angle(a, b):
        return np.arccos(np.clip(np.sum(a * b, axis=1), -1.0, 1.0))

    n_i = normals[recv]
    n_j = normals[send]
    return np.stack([d, angle(n_i, unit), angle(n_j, unit),
                     angle(n_i, n_j)], axis=1)


def normalize_edge_lengths(samples: Sequence[GraphSample]) -> None:
    """Divide the edge-LENGTH column (column 0) by the global max
    (reference: serialized_dataset_loader.py:148-164; the allreduce there
    becomes a host-side max since every process sees the same data or shards
    deterministically). Descriptor columns appended after the length
    (spherical angles, point-pair features) are left unscaled, matching the
    reference where descriptors are added after normalization
    (serialized_dataset_loader.py:167-171)."""
    gmax = 0.0
    for s in samples:
        if s.edge_attr is not None and s.edge_attr.size:
            gmax = max(gmax, float(s.edge_attr[:, 0].max()))
    if gmax > 0:
        for s in samples:
            if s.edge_attr is not None:
                s.edge_attr = s.edge_attr.copy()
                s.edge_attr[:, 0] = (s.edge_attr[:, 0] / gmax).astype(
                    np.float32)
