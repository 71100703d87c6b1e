#!/usr/bin/env python3
"""Device times of the PNA kernels of two checkouts of this repository on
one card, in turns: B1 (`nbr_aggregate`, the dense layout) and B2
(`pna_edge_accumulators`, the edge list), forward and backward, float32
and bf16.

    python3 chip_ab.py OLD_ROOT NEW_ROOT [ROUNDS] [--steps]

Each turn runs this script with --child in one checkout's root, as a
process of its own: it builds that checkout's kernels, makes the csce
shapes of chip_smoke.py from seed 0 (the serving bucket, N 4,032, on both
layouts, and the training loader's batch, N 8,192, K 24, on both), and
times each kernel with that checkout's `chip_smoke.device_ms` (20 calls
in one CUDA graph, CUDA events, the median of 10 replays). Where a
checkout's `fused_mp` picks the edge-list forward's launch geometry
(`FORWARD_ROWS`), the forward is also timed at each geometry of
`FORWARD_VARIANTS` (keys `...rows<R>`, 0 the flat launch). A round runs
old, new, new, old. One JSON line per turn, then the median of each
checkout's turns per kernel and the ratio new / old (a geometry's
against the old checkout's forward).

With --steps a turn times training steps instead, with that checkout's
`chip_smoke.step_metrics`: LJ SchNet EF (examples/LennardJones/LJ.json
on 512 LJ cells, the edge list, batch 16) and csce PNA (dense, 512
molecules, batch 128), each its captured single step's call ms, device
ms and device events (one profiled call) and its replay alone.
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

import numpy as np

# the edge-list forward's receivers a block timed beside the default
FORWARD_VARIANTS = (0, 2, 4, 8)


def shapes(torch, dev):
    """(serving bucket on the dense layout, the same on the edge list, the
    training loader's batch, F): the csce shapes of chip_smoke.py, from
    seed 0, on `dev`."""
    import chip_smoke as cs
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.batch import (collate,
                                                 neighbor_budget_for_dataset,
                                                 with_neighbor_format)
    from hydragnn_tpu_torch.graphs.packing import sample_sizes
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.serving.engine import bucket_ladder, select_bucket

    with open(cs.CSCE_CONFIG) as fh:
        cfg = json.load(fh)
    samples = synthetic_molecules(cs.NUM_MOLECULES, seed=cs.SEED)
    n_tr, n_va = int(0.6 * len(samples)), int(0.2 * len(samples))
    splits = (samples[:n_tr], samples[n_tr:n_tr + n_va],
              samples[n_tr + n_va:])
    cfg = tcfg.update_config(cfg, *splits)
    f = tcfg.build_model_config(cfg).hidden_dim
    bs = int(cfg["NeuralNetwork"]["Training"]["batch_size"])
    first = (splits[2] * cs.ENGINE_REPEATS)[:cs.SERVE_MAX_BATCH]
    nodes, edges = sample_sizes(splits[2])
    top = select_bucket(bucket_ladder(nodes, edges, cs.SERVE_MAX_BATCH),
                        len(first), sum(s.num_nodes for s in first),
                        sum(s.num_edges for s in first))
    serve = collate(first, n_node=top.n_node, n_edge=top.n_edge,
                    n_graph=top.n_graph)
    serve_dense = with_neighbor_format(
        serve, k=neighbor_budget_for_dataset(samples)).to(dev)
    loader = create_dataloaders(*splits, bs, neighbor_format=True)[0]
    loader.set_epoch(0)
    return serve_dense, serve.to(dev), next(iter(loader)).to(dev), f


def step_child() -> None:
    """--steps: the captured step numbers of LJ EF and csce PNA."""
    sys.path[0] = os.getcwd()       # this checkout's package and smoke
    import torch

    import chip_smoke as cs
    from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                     synthetic_molecules)
    from hydragnn_tpu_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda")
    n_tr, n_va = int(0.6 * cs.NUM_MOLECULES), int(0.2 * cs.NUM_MOLECULES)
    times = {}
    for name, path, data, graphs, dense in (
            ("lj_ef", cs.LJ_CONFIG, lj_configurations(cs.NUM_LJ,
                                                      seed=cs.SEED), 16,
             False),
            ("csce_dense", cs.CSCE_CONFIG,
             synthetic_molecules(cs.NUM_MOLECULES, seed=cs.SEED), 128,
             True)):
        with open(path) as fh:
            cfg = json.load(fh)
        cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
        splits = (data[:n_tr], data[n_tr:n_tr + n_va], data[n_tr + n_va:])
        rec = cs.step_metrics(torch, cfg, splits, dev, name, graphs, 2)
        g = rec["graph_S1"]
        for key in ("step_ms", "device_ms_per_step",
                    "device_events_per_step", "replay_ms_per_step"):
            times[f"{name}.{key}"] = g[key]
    print(json.dumps({"root": os.getcwd(), "card": cs.card_line(),
                      "times": times}), flush=True)


def child() -> None:
    sys.path[0] = os.getcwd()       # this checkout's package and smoke
    import torch

    import chip_smoke as cs
    from hydragnn_tpu_torch.kernels import _build, fused_mp, nbr

    _build.build_all()
    dev = torch.device("cuda")
    serve_dense, serve, train, f = shapes(torch, dev)
    gen = torch.Generator(device="cpu").manual_seed(cs.SEED)

    def randn(n, dtype):
        return torch.randn(n, f, generator=gen).to(dev, dtype)

    times = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for shape, b in (("serving", serve_dense), ("loader", train)):
            args = (randn(b.num_nodes, dtype), randn(b.num_nodes, dtype),
                    b.nbr, b.nbr_mask)
            times[f"nbr_forward.{shape}.{tag}"] = cs.device_ms(
                torch, "nbr_aggregate", nbr.nbr_aggregate, args, 0.0)
        n = train.num_nodes
        tables = (train.nbr, train.nbr_mask)
        pi, pj = randn(n, dtype), randn(n, dtype)
        _, mn, mx, _, _ = nbr.nbr_aggregate(pi, pj, *tables)
        layout = nbr.neighbor_layout(*tables)
        grads = [randn(n, dtype) for _ in range(4)]
        times[f"nbr_backward.loader.{tag}"] = cs.device_ms(
            torch, "nbr_aggregate_bwd",
            lambda *a: nbr.nbr_aggregate_bwd(*a, 1e-5, layout),
            (pi, pj, *tables, mn, mx, *grads), 0.0)
        rows = getattr(fused_mp, "FORWARD_ROWS", None)
        for shape, b in (("serving", serve), ("loader", train)):
            n = b.num_nodes
            tables = (b.senders, b.receivers, b.edge_mask, n)
            args = (randn(n, dtype), randn(n, dtype), *tables,
                    fused_mp.edge_layout(*tables))
            key = f"edge_forward.{shape}.{tag}"
            times[key] = cs.device_ms(
                torch, "pna_edge_accumulators",
                fused_mp.pna_edge_accumulators, args, 0.0)
            for r in (FORWARD_VARIANTS if rows is not None else ()):
                default, rows[dtype] = rows[dtype], r
                times[f"{key}.rows{r}"] = cs.device_ms(
                    torch, "pna_edge_accumulators",
                    fused_mp.pna_edge_accumulators, args, 0.0)
                rows[dtype] = default
        n = train.num_nodes
        tables = (train.senders, train.receivers, train.edge_mask, n)
        lays = [fused_mp.edge_layout(*tables),
                fused_mp.edge_layout(tables[1], tables[0], tables[2], n)]
        if "edge_pos" in inspect.signature(fused_mp.pna_edge_bwd).parameters:
            lays.append(fused_mp.edge_positions(*lays))
        pi, pj = randn(n, dtype), randn(n, dtype)
        acc = fused_mp.pna_edge_accumulators(pi, pj, *tables, lays[0])
        grads = [randn(n, dtype) for _ in range(4)]
        times[f"edge_backward.loader.{tag}"] = cs.device_ms(
            torch, "pna_edge_bwd",
            lambda *a: fused_mp.pna_edge_bwd(*a, *lays),
            (pi, pj, *tables, acc[3], acc[4], *grads), 0.0)
    print(json.dumps({"root": os.getcwd(), "card": cs.card_line(),
                      "times": times}), flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        (step_child if "--steps" in sys.argv else child)()
        return 0
    args = [a for a in sys.argv[1:] if a != "--steps"]
    steps = ["--steps"] if "--steps" in sys.argv else []
    if len(args) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"old": os.path.abspath(args[0]),
             "new": os.path.abspath(args[1])}
    rounds = int(args[2]) if len(args) == 3 else 1
    runs = {"old": [], "new": []}
    for _ in range(rounds):
        for which in ("old", "new", "new", "old"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 *steps],
                cwd=roots[which], capture_output=True, text=True,
                timeout=900)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(which=which, **rec)), flush=True)
            runs[which].append(rec["times"])
    summary = {}
    for name in runs["new"][0]:
        ref = name if name in runs["old"][0] else name.rsplit(".", 1)[0]
        old = float(np.median([r[ref] for r in runs["old"]]))
        new = float(np.median([r[name] for r in runs["new"]]))
        summary[name] = dict(old_ms=old, new_ms=new, ratio=new / old)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
