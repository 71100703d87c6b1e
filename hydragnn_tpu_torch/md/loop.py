"""MD in the loop: velocity-Verlet with forces served by the engine's
raw-structure path (counterpart: the reusable half of the JAX package's
examples/md_loop/md_loop.py, `lj_md_config` to `run_md`; its command
line, which trains first, is not ported).

    positions --submit_structure--> radius graph -> bucketed EF forward
        ^                                                   |
        +--- velocity-Verlet step <--- energy, forces ------+

Forces come from an EF engine (`ef_forward=True`: head 0 a node-level
energy head, forces = -dE/dpos), and a trajectory session's Verlet-skin
neighbour list (graphs/neighborlist.py) re-filters step t's candidates
at step t+1 instead of rebuilding the cell list.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..graphs.packing import choose_budget
from ..preprocess.transforms import build_graph_sample
from . import integrator as mdi


def lj_md_config(radius: float = 2.0, max_neighbours: int = 64,
                 hidden_dim: int = 32, num_conv_layers: int = 2,
                 num_gaussians: int = 16, num_epoch: int = 10,
                 batch_size: int = 16) -> Dict:
    """SchNet EF config of the single-species LJ system: a node-level
    energy head, PBC radius graphs, species-only node features; the
    shape of examples/LennardJones/LJ.json, sized for an MD demo."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "lj_md",
            "format": "memory",
            "node_features": {"name": ["species"], "dim": [1],
                              "column_index": [0]},
            "graph_features": {"name": [], "dim": [], "column_index": []},
        },
        "NeuralNetwork": {
            "Architecture": {
                "model_type": "SchNet",
                "radius": radius,
                "max_neighbours": max_neighbours,
                "num_gaussians": num_gaussians,
                "num_filters": hidden_dim,
                "num_radial": 8,
                "envelope_exponent": 5,
                "num_spherical": 4,
                "int_emb_size": 16,
                "basis_emb_size": 8,
                "out_emb_size": hidden_dim,
                "num_before_skip": 1,
                "num_after_skip": 1,
                "max_ell": 1,
                "node_max_ell": 1,
                "hidden_dim": hidden_dim,
                "num_conv_layers": num_conv_layers,
                "periodic_boundary_conditions": True,
                "output_heads": {
                    "node": {"num_headlayers": 2,
                             "dim_headlayers": [hidden_dim, hidden_dim],
                             "type": "mlp"},
                },
                "task_weights": [1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_index": [0],
                "type": ["node"],
                "output_dim": [1],
                "output_names": ["node_energy"],
            },
            "Training": {
                "num_epoch": num_epoch,
                "batch_size": batch_size,
                "perc_train": 0.8,
                "loss_function_type": "mae",
                "compute_grad_energy": True,
                "EarlyStopping": False,
                "Optimizer": {"type": "AdamW", "learning_rate": 0.005},
            },
        },
    }


def md_buckets(num_atoms: int, max_edges: int, headroom: float = 0.3,
               multiple: int = 64):
    """A one-bucket ladder for a fixed-size trajectory system, with
    `headroom` over the observed edge count (edges come and go as atoms
    cross the cutoff; a step that outgrows the bucket is rejected)."""
    return (choose_budget(
        np.asarray([num_atoms]),
        np.asarray([int(max_edges * (1.0 + headroom))]),
        1, multiple=multiple),)


def init_lattice(atoms_per_dim: int, lattice: float, jitter: float,
                 seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, cell): a perturbed simple-cubic lattice under PBC."""
    rng = np.random.RandomState(seed)
    n = atoms_per_dim ** 3
    box = atoms_per_dim * lattice
    grid = np.stack(np.meshgrid(*[np.arange(atoms_per_dim)] * 3,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    pos = (grid + 0.5) * lattice + rng.randn(n, 3) * jitter
    return pos.astype(np.float64), np.eye(3) * box


def maxwell_velocities(num_atoms: int, temperature: float, seed: int,
                       mass: float = 1.0) -> np.ndarray:
    """Zero-momentum Maxwell-Boltzmann velocities (reduced units)."""
    rng = np.random.RandomState(seed)
    vel = rng.randn(num_atoms, 3) * np.sqrt(temperature / mass)
    return vel - vel.mean(axis=0, keepdims=True)


def run_md(engine, config: Dict, pos0: np.ndarray, vel0: np.ndarray,
           cell: Optional[np.ndarray], node_features: np.ndarray, *,
           steps: int, dt: float, mass: float = 1.0,
           mode: str = "incremental", skin: Optional[float] = None,
           force_scale: float = 1.0,
           record_positions: bool = False) -> Dict:
    """Closed-loop velocity-Verlet through the serving engine, one
    engine round trip a step. `mode` picks the neighbour handling:

    * `incremental`: a trajectory session whose Verlet-skin list
      re-filters cached candidates (skin = `skin` or the engine's md_skin);
    * `rebuild`: a session at skin 0, a full rebuild every step;
    * `offline`: the client builds the sample (`build_graph_sample`) and
      submits the graph.

    All three emit the same edges and so, the forward being
    deterministic, the same trajectory bit for bit. Positions stay
    unwrapped; the integrator's grid (md/integrator.py) keeps every
    update exact. Returns steps/s, the rebuild fraction, the graph-build
    time, the energies and the final (pos, vel)."""
    arch = config["NeuralNetwork"]["Architecture"]
    pbc = bool(arch.get("periodic_boundary_conditions", False))
    ccell = mdi.quantize_cell(cell) if pbc else None
    session = None
    if mode == "incremental":
        session = engine.structure_session(skin=skin)
    elif mode == "rebuild":
        session = engine.structure_session(skin=0.0)
    elif mode != "offline":
        raise ValueError(
            f"mode must be incremental | rebuild | offline, got {mode!r}")

    def serve(pos):
        if mode == "offline":
            t0 = time.perf_counter()
            sample = build_graph_sample(node_features, pos, config,
                                        cell=ccell, with_targets=False)
            build_ms = (time.perf_counter() - t0) * 1e3
            fut = engine.submit(sample)
            fut.rebuilt = True
            fut.graph_build_ms = build_ms
            return fut
        return engine.submit_structure(pos, node_features, cell=ccell,
                                       session=session)

    pos, vd = mdi.init_state(pos0, vel0, dt)
    mdi.validate_ranges(float(np.abs(pos).max(initial=0.0)),
                        float(arch.get("radius") or 5.0)
                        + float(skin if skin is not None
                                else getattr(engine, "md_skin", 0.0)))
    s_hi, s_lo = mdi.force_scale_split(dt, force_scale, mass)
    res = serve(pos).result()
    ad2 = mdi.accel_term(np.asarray(res[1], np.float32), s_hi, s_lo)
    energies = [float(np.asarray(res[0]).ravel()[0])]
    rebuilds = 0
    build_ms_sum = 0.0
    positions = []
    t_start = time.perf_counter()
    for _ in range(steps):
        pos = mdi.drift(pos, vd, ad2)
        fut = serve(pos)
        res = fut.result()
        rebuilds += int(fut.rebuilt)
        build_ms_sum += fut.graph_build_ms
        ad2_new = mdi.accel_term(np.asarray(res[1], np.float32), s_hi,
                                 s_lo)
        vd = mdi.kick(vd, ad2, ad2_new)
        ad2 = ad2_new
        energies.append(float(np.asarray(res[0]).ravel()[0]))
        if record_positions:
            positions.append(pos.copy())
    wall = time.perf_counter() - t_start
    out = {
        "mode": mode,
        "steps": steps,
        "wall_s": wall,
        "steps_per_s": steps / wall if wall > 0 else None,
        "step_ms_mean": 1e3 * wall / steps,
        "rebuild_fraction": rebuilds / steps,
        "graph_build_ms_mean": build_ms_sum / steps,
        "energy_first": energies[0],
        "energy_last": energies[-1],
        "energies": energies,
        "final_pos": pos,
        "final_vel": vd / dt,
    }
    if record_positions:
        out["positions"] = positions
    return out
