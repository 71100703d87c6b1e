#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hydragnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases:

1. Print the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; build the CUDA kernels from hydragnn_tpu_torch/csrc with nvcc
   and print each compiled kernel's registers, spills and static shared
   memory from `-Xptxas -v`.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (128 molecule-sized graphs, F = 200)
   and on edge cases (isolated nodes, masked and padding edges, ids out of
   range). Min, max, count and degree must be equal; sums within
   rtol 2e-5 / atol 2e-5 (the two versions add in different orders).
   Time kernel, plain version and, where one PyTorch call computes the
   same function, that call (`index_add` for the segment sum): call
   time with CUDA events, device time from 20 calls in one CUDA graph
   (with the edge-list forward's launch geometry and its multiple of
   the bound; phase 7a prints the same at bf16).
   segment_sum is recorded at every shape the main paths give it (here
   the PNA pooling bucket and the loader's padding segment; phase 4 adds
   the EF shapes), each with its bound and `index_add`'s device time.
3. Serve the csce PNA model (examples/csce/csce_gap.json: 200 hidden,
   6 layers, one graph head) on 512 synthetic molecules with random
   Flax-shaped weights from a seed: `run_prediction(serve=True)` on the
   test split (dense neighbor layout, Serving.max_batch_size 128, the
   config's batch size), then an `InferenceEngine` on the edge-list layout
   over a burst of the test split repeated 8 times, then 160 timed
   bursts of the same. The engine's forwards are CUDA graphs, one per
   bucket, captured at warm-up (`engine_graphs` prints each bucket's
   capture time and, on the full batch's bucket, the replay's CUDA-event
   time, one profiled replay's device time and events, and the engine's
   whole forward). Every kernel
   must have launched on these paths; outputs must match the port's CPU
   run within rtol 1e-4 / atol 1e-5. The serving rate is all requests
   over the bursts' total wall time, and p50/p99 are taken over the pooled
   latencies of every request.
4. SchNet energies and forces (examples/LennardJones/LJ.json: 32 wide, 2
   equivariant layers, one node-energy head) on 512 Lennard-Jones cells of
   27 atoms with random Flax-shaped weights from a seed. First the
   filter-scatter kernel against its plain version at the engine's
   largest bucket (forward within rtol/atol 2e-5; its backward, dh within
   2e-5 and dw exact, against autograd through the plain version; the
   segment sum's backward likewise, the position gathers' bitwise on
   dyadic rows, whose sums no order rounds; forward and dh device
   times), the EF shapes of segment_sum (energy pooling at
   F = 1; the position gathers' backward at F = 3 on the filter layout,
   which must equal a fresh sort on every real node, and whose own
   backward must equal autograd through the plain sum of the rows the
   layout keeps), then an
   `InferenceEngine(ef_forward=True)` on the edge list over a burst of the
   test split repeated 8 times, matched against the same engine run on
   the CPU within rtol 1e-4 / atol 1e-5, then 60 timed bursts, the
   engine's graphs as in phase 3, and one profiled eager EF forward +
   backward (device time, launches, argsorts).

5. csce PNA training (`run_training` at the config's published width,
   512 molecules, batch 128, 2 steps an epoch): first the two PNA
   Functions' backward kernels (csrc/pna_backward.cu) at the training
   loader's shape (dense N 8,192, K 24, F 200, and the same batch as an
   edge list) against their plain versions, the torch-op VJPs, on the
   card (float32 random data within rtol/atol 2e-5, bf16 within one bf16
   ulp, the tie-rich dyadic cases bitwise) and, through the Functions,
   against autograd through the plain forwards; with the device times
   (20 calls in one CUDA graph) of the kernel, the torch-op VJP and plain
   autograd's backward beside the byte bound, each pass's device time
   from a profile of the graph's replays, by kernel name, the bytes of
   the dh buffer pass 1 writes and pass 2 streams, and the launches of
   one call of each; the dense forward at the same batch,
   float32 and bf16, bitwise against its plain version, with its device
   time beside its byte bound. Then the first step: loss
   card vs CPU within rtol 1e-4 / atol 1e-5, each gradient tensor through
   the kernels vs through the plain versions on the card within 1e-2
   relative L2 (card vs CPU and float64 gaps printed: float32 is a few
   percent off the float64 gradient in the middle layers here);
   3 epochs with SGD on the card and on the CPU (every epoch's train
   loss within rtol 1e-3, val/test within 1e-2), the config's AdamW 3
   epochs on the card twice (the main
   path: histories and parameters bitwise equal; every kernel counted) and
   once on the CPU (its gap printed: Adam turns gradients below its eps
   into lr-sized updates whose sign follows the summation order), one
   epoch on the edge list, `run_prediction` from the trained state (card
   vs CPU within rtol 1e-4 / atol 1e-5), and per path, on three routes
   (the eager step body, timed beside the graphs and never the route; the
   captured single step that run_training replays; a captured group of
   CSCE_GROUP steps, steps_per_call), the step time (CUDA events, median
   of 10 calls after 2 warm-up calls), one profiled call's device time
   and device events, the card's idle share, graphs/s, the graphs'
   capture times and the port's kernel launches in one captured step.
   Every run_training and engine here runs through its CUDA graphs.
6. LJ SchNet energy-force training (LJ.json at its widths, 512 cells,
   batch 16; 2 epochs of its 20, for time; on the edge list, the layout
   of the EF engine and of kernel 4): the same checks and numbers
   (groups of LJ_GROUP steps);
   the force loss differentiates the filter-scatter's and the segment
   sum's backwards again (`create_graph=True`).
7. bf16 at the same widths: kernels 2-4 in their bf16 instantiations
   against their plain bf16 versions at the main-path shapes (min, max,
   counts and degrees bitwise; sums within one bf16 ulp of max(|a|, |b|,
   2^-10), nbr_aggregate's mean and std within two; the bf16-exact
   tie-rich dyadic cases bitwise), each one's device time beside its bf16
   byte bound; csce PNA served at Serving.precision "bf16" through
   run_prediction (dense) and an InferenceEngine (edge list), card vs the
   CPU's bf16 run within 2^-5 (atol + rtol |ref|), the bf16-vs-float32
   gap printed, batched = single bitwise, the parity breadcrumbs, 40
   timed bursts, the engine's graphs; LJ SchNet EF served at bf16
   (energies and forces within 2^-5 of the CPU's bf16 engine, for the
   burst on the buckets it was served on and for each test cell alone on
   the smallest bucket, the
   bound's margin printed; batched = single bitwise); run_training at
   Architecture.dtype "bfloat16" for csce PNA (3 epochs dense, 1 on the
   edge list) and LJ EF (2 epochs): the first step's loss card vs CPU
   within 2^-5 relative, SGD card vs CPU within 2^-5 relative every epoch
   (LJ EF: printed; its bf16 force-loss gradients carry rounding noise
   that follows the summation order, and SGD runs part within a few
   steps), the config's optimizer twice on the card bitwise, float32
   masters, no non-finite step, and the step numbers and graph checks
   of phases 5-6 (with the casts' device time in each route). For
   LJ EF at bf16 also: the first step's weight gradients through the
   kernels vs the plain versions on the card (worst tensor within 0.6,
   all tensors within 0.04 relative L2, between the noise floor of the
   edge order and a control with filter_scatter's dh cut from the force
   loss, which must fail), and 12 SGD steps card vs CPU, the first 3
   within 2^-5, beside the plain versions' and float32's gaps.
8. Checkpoints: csce PNA with Checkpoint and checkpoint_every_n_epochs
   1, sent a real SIGTERM from a thread once its first COMMITTED step
   directory exists (under ./logs, removed afterwards) and resumed with
   `continue: 1`: its history and final parameters must equal an
   uninterrupted run's bitwise, and run_prediction from the BEST
   checkpoint the in-memory state's predictions; at float32 and bf16.
9. Batch packing: csce PNA trained through `run_training` with
   Training.batch_packing on the dense layout and the edge list (3
   epochs): the packed and the fixed budgets, their padding fractions,
   steps an epoch and the plan fingerprint; no CUDA graph captured after
   epoch 0; every kernel of the path launched; then the captured packed
   step against its eager body bitwise and its step time, device time,
   idle share and graphs/s over real graphs (phase 5's route numbers),
   printed beside phase 5's fixed-shape step.
10. PNA with edge lengths read from its own files:
   examples/eam/NiNb_EAM_energy.json at its published width (hidden 50,
   10 layers, batch 16; Visualization.create_plots turned off, 3 of its
   50 epochs, for time) on 512 NiNb cells written as AtomEye CFG files
   (`ninb_cfg_files`, the generator's defaults) to a temporary directory
   that Dataset.path names, trained by `run_training(config,
   datasets=None)` on the dense layout and the edge list (the main
   path, twice on the card bitwise); the first step (loss card vs CPU
   within rtol 1e-4 / atol 1e-5, gradients kernels vs plain versions
   within 1e-2 relative L2) on both layouts; SGD card vs CPU printed, not
   held, beside the CPU against itself at half its threads (this
   configuration's float32 first-step gradients are a few percent off
   float64 in the first layers on every device, the JAX package's
   included, and two float32 SGD runs part within a few steps);
   segment_sum at the edge list's unfused [E, 2F + 1] statistics (F 50,
   unsorted receivers) and at the packed pooling shape of phase 9; and
   `run_prediction` from the files with the trained state (normalized
   targets: the splits complete the config as plain lists, as in the JAX
   package, so denormalization is off), card vs CPU within rtol 1e-4 /
   atol 1e-5; the step numbers of phase 5 for both layouts.
11. EGNN and GIN: the OC20 energy config
   (examples/open_catalyst_2020/open_catalyst_energy.json: EGNN hidden
   50, 3 equivariant layers, radius 5 with PBC, edge lengths, graph head
   2 x 50 shared then [50, 25], batch 32, AdamW 1e-3; 3 epochs) and the
   forces config (node head [50, 25] -> 3, mae; 2 of its 3 epochs) on
   512 synthetic OC20 slabs (`oc20_slabs`), and qm9.json's GIN (hidden 5,
   6 layers, shared 2 x 5, heads [50, 25], radius 7, max_neighbours 5,
   batch 64; plots off and NeuralNetwork.Profile removed, which neither
   package reads; 2 epochs) on 512 synthetic QM9 molecules
   (`qm9_molecules`). Each trained through `run_training` on the dense
   layout and the edge list (captured steps): the first step (loss card
   vs CPU within rtol 1e-4 / atol 1e-5, gradients kernels vs plain
   within 1e-2 relative L2), two card runs bitwise, captured = eager
   bitwise and phase 5's step numbers; then served: `run_prediction`
   card vs CPU within rtol 1e-4 / atol 1e-5, an `InferenceEngine` (edge
   list) against the same engine on the CPU likewise, batched = single
   bitwise, the engine's graphs and SLICE_BURSTS timed bursts
   (requests/s, p50, p99). The trained EGNN's forward at bf16, card vs
   CPU within 2^-5. segment_sum at the new shapes (EGNN's [E, 50]
   message sum, [E, 3] coordinate mean and gathers' backwards, GIN's
   [E, 5], both poolings), each against its plain version beside its
   bound and `index_add`'s time. Each of phase 11's numbers is printed
   beside the card's name and power limit.
12. Serving with failure semantics, hot swap and raw structures
   (`serving_phase`), every number beside the card's name and power
   limit. (a) MD in the loop: `md/loop.lj_md_config` at LJ.json's
   architecture (SchNet 32 wide, 2 equivariant layers, 32 Gaussians,
   radius 2.0, max_neighbours 64, PBC, node head [32, 32]) with phase 6's
   trained weights, 1,728 atoms (12³ lattice 1.2, jitter 0.05, seed 1;
   Maxwell velocities at T 0.3, seed 2), dt 0.005, skin 0.3, served by
   one EF engine on `md_buckets`' one-bucket ladder, 60 steps in each
   mode (incremental, rebuild, offline): steps/s, step ms, graph build
   and serve ms, rebuild fraction, first and last energy. Held: the
   three trajectories bitwise equal, the first step card vs CPU within
   rtol 1e-4 / atol 1e-5, no capture after warm-up, B3 and B4 among the
   bucket graph's kernel nodes (= its launch counts); then B4 (forward,
   dh) and B3 (pooling, the gathers' backward) at the MD bucket against
   their plain versions, with device time and bound. (b) Eight threads,
   each its own session, 216-atom systems (seeds 0-7) through one EF
   engine (ladder from those systems with 30 % edge headroom,
   max_batch_size 8), 30 steps: steps/s summed, batch occupancy, rebuild
   fraction; each trajectory's step 1 against its own single-client CPU
   run. (c) The csce PNA engine (edge list) with max_queue 4 x 128 and a
   50 ms deadline: the closed-loop rate R, then seeded Poisson arrivals
   at 0.5, 0.9 and 1.5 R for 5 s each: offered, admitted, completed,
   QueueFullError, DeadlineExceededError, p50/p95/p99 and `health()`;
   every accepted future resolves, none pending after shutdown, nothing
   refused or expired at 0.5 R. (d) The plan serving-dispatch@2,5,6 with
   breaker 2 / 0.2 s: only the faulted batches fail, one trip, one probe,
   every result bitwise `forward_single`; `swap_variables` to a second
   seeded weight set with requests in flight: every result bitwise a
   fresh engine's on its weights, its version on the future, no capture,
   a mismatched tree refused first.
13. The device-resident trajectory farm (`farm_phase`, md/farm.py)
   through `InferenceEngine.trajectory_farm` with phase 12's MD config
   and phase 6's weights, each number beside the card's name and power
   limit. (a) Phase 12b's 216-atom systems (seeds k, 100 + k) on a
   one-bucket engine, T = 1, 64 and 512 trajectories, 64 steps, 8 a
   dispatch (one CUDA graph replay of 8 steps: drift, the skin check,
   the batched re-filter, the compaction, the T-fold EF forward, the
   kick), and T = 64 at 1 a dispatch: aggregate and per-trajectory
   steps/s, dispatches, effective steps a dispatch, rebuild swaps and
   fraction, capture ms, replay ms (CUDA events) and host ms (status
   read, rebuilds, swaps) a dispatch, a profiled replay's device ms a
   step, the idle share, the memory peak, the graph's B3 and B4 nodes;
   the dense layers' row independence at T = 512 ([T r, in] against T
   products of r rows), the routes the farm chose (trajectories a
   product) and their cost. (b) 8 systems of phase 12a's 1,728 atoms,
   32 steps, beside phase 12a's and 12b's session rates. Held: 4
   trajectories of T = 64 and 2 of (b) equal `run_md(mode=
   "incremental")` through the same engine (positions and velocities
   bitwise, energies within rtol 1e-9); T = 1 equals T = 64's
   trajectory 0 and K = 1 equals K = 8, bitwise; the registry's farm
   counters equal the runs'; B4 and B3 at both T-fold batches against
   their plain versions on exact dyadic data, bitwise, with device
   time, bound and `index_add`'s time.
14. The serving fleet (`fleet_phase`, serving/fleet.py, publish.py,
   autoscale.py): phase 3's csce PNA engine configuration and weights
   (edge list, max_batch_size 128) behind a ReplicaRouter of 2 engines
   on the card, each number beside the card's name and power limit.
   First `run_prediction` with `Serving.fleet.replicas` 2 and a compile
   store, held against phase 3's single-engine run within rtol 1e-4 /
   atol 1e-5 (its bitwise equality printed). (a) The replicas share a
   CompileStore in a temporary directory: replica 0 compiles every
   bucket fresh, replica 1 takes every bucket from the store; a burst of
   824 requests through the router, each result bitwise the single
   engine's forward on the bucket it was served on; whether a request's
   result is the same on every bucket that fits it; then 40 bursts
   through the fleet and through the single engine, alternating:
   requests/s, p50, p99. (d) A child process (`--fleet-replica`) points
   `_build.BUILD_ROOT` at an empty directory, warms one replica from the
   store and serves 256 requests: held 0 nvcc runs, every bucket a store
   hit, results bitwise (a)'s. (b) Seeded Poisson arrivals at 0.5 x the
   fleet's rate with `replica-kill` injected 0.6 s in, and 3
   kill-and-restart cycles under the stream (each capture next to the
   other replica's replays): every future resolves once with a result,
   redispatches and dropped duplicates counted, each restart 0 fresh,
   the reserved memory after the last cycle within one replica's ladder
   of the first's. (c) `hot_swap` to a second seeded weight set under
   the stream, then `swap-fail@0,1`: both versions echoed, the new one
   after the swap and after the failed one, no request failed, results
   bitwise a single engine's on the new weights. (e) Two BEST
   checkpoints through `save_model`: 3 SGD steps from the served weights
   (their running statistics kept) and the same with NaN weights; the
   CheckpointPublisher promotes the first and rolls back and
   quarantines the second under a stream; then a burst of 4 x 824
   requests, one QueueDepthAutoscaler step up (`add_replica` on the
   published version, warmed from the store) and one down after it.
   Every part holds B2 and B3 launched.
15. The last four architectures (`a7_phase`, models/dimenet.py,
   painn.py, pnaeq.py, mace.py) at examples/LennardJones/LJ.json's
   widths, each model type set as LennardJones.py sets it (hidden 32,
   2 layers, radius 2.0; DimeNet num_radial 8, num_spherical 4, int_emb
   16, basis_emb 8, out_emb 32; MACE max_ell 2, node_max_ell 1,
   correlation [2]), on phase 6's LJ cells. (a) PAINN, PNAEq and MACE:
   the first step (loss card vs CPU within rtol 1e-4 / atol 1e-5,
   gradients through the kernels vs the plain versions), 3 SGD steps
   card vs CPU (each loss within rtol 1e-3), energy-force run_training
   captured for 2 epochs on the dense layout and 1 on the edge list, and
   the step numbers (`step_metrics`: captured = eager bitwise first).
   (b) Their trained weights through InferenceEngine(ef_forward=True) on
   the card and the CPU: energies and real-node forces within rtol 1e-4
   / atol 1e-5 (or 4 float32 floors of the CPU's own rounding), every
   bucket's graph = its eager forward bitwise, timed bursts; DimeNet
   (seeded random weights) through run_prediction's loop, which it
   takes as in the JAX package, and its energies and real-node forces on
   the loader's triplet batches, card vs CPU. (c) The four threshold
   rows of tests/test_graphs_full.py on the card: the BCC lattice
   (graphs/synthetic.py `bcc_lattices`, 160 graphs, a graph head), 60
   epochs through run_training and run_prediction, RMSE under DimeNet
   0.50, PAINN 0.60, PNAEq 0.60, MACE 0.70, each row run again on the
   CPU from the same initialization as a witness, every epoch's train
   loss within rtol 1e-3 of the card's; DimeNet's training on the
   lattice's graph head (its parameter gradients are finite there): the
   first step as in (a), its gradients card vs CPU as one vector, and 3
   SGD steps card vs CPU. (d) segment_sum at each new shape of these
   paths, held against its plain version, with its bound and
   `index_add`'s time. Every path holds B3 launched.

The last line is {"ok": true, "device": {...}}; the line before it
holds the per-kernel JSON record (per-shape records under `shapes`,
kernels 2-4's bf16 readings under `bf16`; the two PNA backwards as rows
of their own, with their bf16 readings under `bf16`, the torch-op
VJP's device time as `plain_ms` and each pass's as `passes_ms`; the
dense forward's loader-shape reading under `loader`), the line before
that the card's
name and power limit, and before it an `a7: {...}` (phase 15), a
`fleet: {...}` (phase 14), a
`farm: {...}` (phase 13), a
`serving: {...}` (phase 12) and a `training: {...}` JSON line. Any
failure exits non-zero without the last
line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
NUM_MOLECULES = 512
ENGINE_REPEATS = 8             # a burst is the test split 8 times over
BURSTS = 160                   # timed bursts, after the main-path one
GRAPH_CALLS = 20               # wrapper calls per captured CUDA graph
SERVE_MAX_BATCH = 128          # Serving.max_batch_size = the config's batch
SUM_TOL = dict(rtol=2e-5, atol=2e-5)
SLICE_TOL = dict(rtol=1e-4, atol=1e-5)
LJ_CONFIG = "examples/LennardJones/LJ.json"
NUM_LJ = 512                   # LJ cells of 27 atoms
LJ_BURSTS = 60                 # timed EF bursts, after the main-path one
TRAIN_RTOL = 1e-3              # card vs cpu, every epoch's train loss
EVAL_RTOL = 1e-2               # and its val/test losses (eval-mode BN)
LJ_EPOCHS = 2                  # LJ.json trains 20 epochs; cut for time
CSCE_GROUP = 2                 # steps per call timed beside S = 1 (csce)
LJ_GROUP = 4                   # and LJ EF
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
CSCE_CONFIG = "examples/csce/csce_gap.json"
BF16_BOUND = 2.0 ** -5         # bf16 vs a reference: atol + rtol |ref|
BF16_BURSTS = 40               # timed bf16 engine bursts
# LJ bf16 first-step weight gradients, kernels vs plain versions on the
# card, relative L2: the worst tensor, and all tensors as one vector. Set
# between the noise floor (the plain versions vs themselves on the edges
# in another order, read by this script on an H100 machine: worst tensor
# 0.12-0.23, all 0.0058-0.011, on the card and over the CPU's orders)
# and the control `filter_dh_cut` (0.81 / 0.137)
LJ_GRAD_BOUND = 0.6
LJ_GRAD_BOUND_ALL = 0.04
LJ_FLOOR_ORDERS = 8            # edge orders sampled for the CPU's floor
LJ_SGD_STEPS = 12              # LJ SGD steps compared card vs cpu
LJ_SGD_HELD = 3                # of which the first held at bf16
PROFILE_ATTEMPTS = 3           # profiles of one call until one holds all


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """One line per compiled kernel of an `nvcc -Xptxas -v` log: its name
    and template arguments, registers, spill stores and loads (bytes) and
    static shared memory (bytes); errors as they are."""
    import re
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            size, rest = int(m.group(1)), m.group(2)
            args = ", ".join(
                ["float" if rest[size:].startswith("If") else "bf16"
                 if rest[size:].startswith("I13__nv_bfloat16") else "?"]
                + [v if t == "i" else ("true" if v == "1" else "false")
                   for t, v in re.findall(r"L([ib])(\d+)E", rest[size:])])
            kernel = f"{rest[:size]}<{args}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spills {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{kernel}: {m.group(1)} registers, {spills}, "
                       f"static smem {smem.group(1) if smem else 0} B")
        if "error" in line.lower():
            out.append(line.strip())
    return out


def cuda_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() in milliseconds (CUDA events)."""
    return float(np.median(step_events_ms(torch, fn, reps, warmup)))


def capture(torch, warm, body, keep_graph: bool = False):
    """A CUDA graph of body(), captured on a new stream after warm() ran
    there, so that what a first call sets up (segment_sum's per-stream
    tickets, autograd's graph) exists before the capture and is not
    captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream().wait_stream(side)
    graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep_graph
             else torch.cuda.CUDAGraph())
    with torch.cuda.graph(graph, stream=side):
        body()
    return graph


def device_ms(torch, name, fn, args, bound: float,
              kernels=None) -> float:
    """Device time per call of fn(*args), which launches one kernel:
    GRAPH_CALLS calls captured in one CUDA graph and replayed (CUDA events,
    median), so the wrapper's host time is left out and the gaps between
    the launches are counted in. Each call reads its own copy of the
    inputs, so none finds them in L2 from the call before. The graph is
    captured on the stream of the warm-up call, so the kernels' per-stream
    buffers (segment_sum's tickets) already exist and their set-up is not
    captured. Fails below `bound`, which no real kernel time can be.
    `kernels`, a dict keyed by kernel names, gets each one's device ms per
    launch from a profile of the graph's replays (`kernel_ms`)."""
    def copy(a):
        if isinstance(a, tuple):
            return tuple(copy(t) for t in a)
        return a.clone() if torch.is_tensor(a) else a
    copies = [[copy(a) for a in args] for _ in range(GRAPH_CALLS)]

    def calls():
        for c in copies:
            fn(*c)
    graph = capture(torch, lambda: fn(*args), calls)
    ms = cuda_ms(torch, graph.replay, reps=10) / GRAPH_CALLS
    if ms < bound:
        fail(f"{name}: device time {ms} ms below its bound {bound} ms")
    if kernels is not None:
        kernels.update(kernel_ms(torch, graph, kernels))
    return ms


def kernel_ms(torch, graph, names):
    """{name: device ms per call} of each named kernel in a profile of
    three replays of a graph of GRAPH_CALLS calls; "not measured" for a
    name the profile holds no device row of."""
    import re
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    _, _, rows = profile_rows(torch, prof)
    out = {}
    for name in names:
        pat = re.compile(r"\b" + name + r"<")
        hits = [(t, c) for t, key, c in rows if pat.search(key)]
        calls = sum(c for _, c in hits)
        out[name] = (sum(t for t, _ in hits) / 1e3 / calls if calls
                     else "not measured")
    return out


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, name, got, want, exact):
    """Max abs error of got vs want; fails on an inexact exact output or a
    sum outside SUM_TOL."""
    got = got.float()
    want = want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact and not torch.equal(got, want):
        fail(f"{name}: not equal to the plain version (max err {err})")
    if not exact and not torch.allclose(got, want, **SUM_TOL):
        fail(f"{name}: outside rtol/atol {SUM_TOL} (max err {err})")
    return err


def edge_geometry_name(rows):
    """The edge-list forward's launch geometry, as `forward_geometry`
    gives it."""
    return "flat" if rows == 0 else f"whole-warp rows, {rows} a block"


def check_kernels(torch, dense_batch, edge_batch, loader_batch, device, f):
    """Phase 2: every kernel against its plain version on the card, with
    F = the model's hidden width."""
    from hydragnn_tpu_torch.kernels import fused_mp, nbr, segment

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    records = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    # ---- nbr_aggregate: dense layout of the largest serving bucket
    n, k = dense_batch.nbr.shape
    pi, pj = randn(n, f), randn(n, f)
    nb, nm = dense_batch.nbr, dense_batch.nbr_mask
    odd = nb.clone()
    real = nm.nonzero()
    pick = real[torch.randperm(real.shape[0], generator=gen)[:64].to(device)]
    odd[pick[:, 0], pick[:, 1]] = n + 7        # out of range: counts as masked
    errs = []
    for idx in (nb, odd):
        got = nbr.nbr_aggregate(pi, pj, idx, nm)
        want = nbr.nbr_aggregate_plain(pi, pj, idx, nm)
        for name, g, w in zip(("mean", "min", "max", "std", "deg"), got, want):
            errs.append(compare(torch, f"nbr_aggregate.{name}", g, w,
                                exact=name in ("min", "max", "deg")))
    if float(want[4][-1]) != 0.0 or float(want[4].min()) != 0.0:
        fail("nbr_aggregate: expected zero-degree rows in the check batch")
    slots = int(nm.sum())
    ms = cuda_ms(torch, lambda: nbr.nbr_aggregate(pi, pj, nb, nm))
    plain = cuda_ms(torch, lambda: nbr.nbr_aggregate_plain(pi, pj, nb, nm))
    nbytes = 4 * (2 * n * f + n * k) + n * k + 4 * (4 * n * f + n)
    b_ms, b_by = bound_ms(nbytes, 6 * slots * f + 8 * n * f)
    dev = device_ms(torch, "nbr_aggregate", nbr.nbr_aggregate,
                    (pi, pj, nb, nm), b_ms)
    gather_bytes = nbytes - 4 * n * f + 4 * slots * f
    print(f"nbr_aggregate: N={n} K={k} F={f} real_slots={slots} "
          f"kernel_ms={ms:.4f} device_ms(graph)={dev:.4f} plain_ms={plain:.4f} "
          f"bound_ms={b_ms:.5f} (proj_j read once, L2 reuse) "
          f"bound_every_gather_ms={gather_bytes / HBM_BYTES_PER_S * 1e3:.5f}",
          flush=True)
    for label, stage in (("forward", False), ("backward pass 1", True)):
        for size, dt in ((4, "float32"), (2, "bf16")):
            rows, tpr, chunk, smem = nbr.row_geometry(k, f, 4, size, stage)
            print(f"  {label} {dt} geometry at K={k} F={f} VEC 4: {rows} "
                  f"rows of {tpr} threads a block, chunk {chunk}, dynamic "
                  f"shared memory {smem} B", flush=True)
    records["nbr_aggregate"] = dict(max_abs_err=max(errs), ms=ms,
                                    device_ms=dev,
                                    plain_ms=plain, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)

    # ---- pna_edge_aggregate: edge list of the engine's largest batch
    n = edge_batch.num_nodes
    e = edge_batch.num_edges
    pi, pj = randn(n, f), randn(n, f)
    send, recv, em = (edge_batch.senders, edge_batch.receivers,
                      edge_batch.edge_mask)
    em_odd = em & (torch.rand(e, generator=gen).to(device) > 0.05)
    recv_odd = recv.clone()
    recv_odd[:16] = n + 3                      # receivers out of range
    errs = []
    for r, m in ((recv, em), (recv_odd, em_odd)):
        got = fused_mp.pna_edge_accumulators(pi, pj, send, r, m, n)
        want = fused_mp.pna_edge_accumulators_plain(pi, pj, send, r, m, n)
        for name, g, w in zip(("s", "sq", "cnt", "min", "max"), got, want):
            errs.append(compare(torch, f"pna_edge_aggregate.{name}", g, w,
                                exact=name in ("cnt", "min", "max")))
    kept = int(em.sum())
    # the main path computes the CSR layout once per forward and shares it
    # across the layers: time the per-layer call with it, and it apart
    layout = fused_mp.edge_layout(send, recv, em, n)
    ms = cuda_ms(torch, lambda: fused_mp.pna_edge_accumulators(
        pi, pj, send, recv, em, n, layout))
    prep = cuda_ms(torch, lambda: fused_mp.edge_layout(send, recv, em, n))
    plain = cuda_ms(torch, lambda: fused_mp.pna_edge_accumulators_plain(
        pi, pj, send, recv, em, n))
    nbytes = 4 * 2 * n * f + 4 * 2 * e + e + 4 * (4 * n * f + n)
    b_ms, b_by = bound_ms(nbytes, 6 * kept * f)
    dev = device_ms(torch, "pna_edge_aggregate",
                    fused_mp.pna_edge_accumulators,
                    (pi, pj, send, recv, em, n, layout), b_ms)
    rows = fused_mp.forward_geometry(f, 4, torch.float32)
    print(f"pna_edge_aggregate: N={n} E={e} kept_edges={kept} F={f} "
          f"kernel_ms={ms:.4f} (layout given) device_ms(graph)={dev:.4f} "
          f"layout_prep_ms={prep:.4f} "
          f"plain_ms={plain:.4f} bound_ms={b_ms:.5f} ({dev / b_ms:.2f}x); "
          f"geometry {edge_geometry_name(rows)}", flush=True)
    records["pna_edge_aggregate"] = dict(max_abs_err=max(errs), ms=ms,
                                         device_ms=dev,
                                         plain_ms=plain, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=None,
                                         forward_rows=rows)

    # ---- segment_sum: the decoder's mean pooling of the serving bucket
    # (the record's main numbers), the loader's shape, and unsorted ids
    errs = []
    lb = loader_batch
    n = edge_batch.num_nodes
    g = edge_batch.num_graphs
    ids = edge_batch.node_graph
    data = randn(n, f) * edge_batch.node_mask[:, None]
    rnd = torch.randint(-2, g + 3, (n,), generator=gen,
                        dtype=torch.int32).to(device)  # unsorted, some out
    got = segment.segment_sum(data, rnd, g)
    errs.append(compare(torch, "segment_sum.unsorted", got,
                        segment.segment_sum_plain(data, rnd, g), exact=False))
    ms = cuda_ms(torch, lambda: segment.segment_sum(
        data, ids, g, indices_are_sorted=True))
    plain = cuda_ms(torch, lambda: segment.segment_sum_plain(data, ids, g))
    ids64 = ids.long()
    base = torch.zeros(g, f, device=device)
    lib_call = cuda_ms(torch, lambda: torch.index_add(base, 0, ids64, data))
    shapes = [segment_shape(torch, "pna_pooling", data, ids, g),
              segment_shape(torch, "loader", randn(lb.num_nodes, f)
                            * lb.node_mask[:, None], lb.node_graph,
                            lb.num_graphs)]
    pool = shapes[0]
    errs += [r["max_abs_err"] for r in shapes]
    print(f"segment_sum: E={n} N={g} F={f} kernel_ms={ms:.4f} "
          f"device_ms(graph)={pool['device_ms']:.4f} plain_ms={plain:.4f} "
          f"library_ms(index_add, graph)={pool['library_ms']:.4f} "
          f"library_call_ms(index_add)={lib_call:.4f} "
          f"bound_ms={pool['bound_ms']:.5f}", flush=True)
    records["segment_sum"] = dict(max_abs_err=max(errs), ms=ms,
                                  device_ms=pool["device_ms"],
                                  plain_ms=plain, bound_ms=pool["bound_ms"],
                                  bound_by=pool["bound_by"],
                                  library_ms=pool["library_ms"],
                                  library_call_ms=lib_call, shapes=shapes)
    return records


def segment_shape(torch, name, data, ids, n, layout=None, real=None,
                  sort=True, card=None):
    """One shape the main paths give segment_sum: the kernel against its
    plain version (on the rows `real` names, a count from row 0 or a
    mask, when a layout leaves rows out), its
    device time and `index_add`'s (each 20 calls in one CUDA graph), and
    its bound. Sorted ids unless a layout is given or `sort` is false
    (the kernel then argsorts them first, as the unfused PNA statistics
    ask it to). `card`, given, is printed beside the numbers."""
    from hydragnn_tpu_torch.kernels import segment

    e, f = data.shape
    sort = sort and layout is None

    def call(d, i, lay):
        return segment.segment_sum(d, i, n, indices_are_sorted=sort,
                                   layout=lay)
    # `real`: the rows compared, a count from row 0 or a boolean mask
    rows = (slice(0, n) if real is None else real if torch.is_tensor(real)
            else slice(0, real))
    err = compare(torch, f"segment_sum.{name}", call(data, ids, layout)[rows],
                  segment.segment_sum_plain(data, ids, n)[rows], exact=False)
    if layout is None:
        kept = e
        nbytes = 4 * (kept * f + kept + n * f)
    else:
        kept = int(layout[0][-1])
        nbytes = 4 * (kept * f + kept + n + 1 + n * f)
    b_ms, b_by = bound_ms(nbytes, kept * f)
    dev = device_ms(torch, f"segment_sum.{name}", call, (data, ids, layout),
                    b_ms)
    base = torch.zeros(n, f, device=data.device)
    lib = device_ms(torch, f"index_add.{name}",
                    lambda b, i, d: torch.index_add(b, 0, i, d),
                    (base, ids.long(), data), b_ms)
    # the sorted ids' row-pointer pass alone (the first of the two launches)
    rp = (device_ms(torch, f"segment_sum.{name}.row_ptr",
                    lambda i: segment.sorted_row_ptr(i, n), (ids,), 0.0)
          if sort else None)
    segs = (torch.bincount(ids.long().clamp(0, n), minlength=n + 1)[:n]
            if layout is None else torch.diff(layout[0]))
    print(f"segment_sum.{name}: E={e} N={n} F={f} "
          f"{'layout given' if layout is not None else 'sorted ids' if sort else 'unsorted ids'} "
          f"longest segment {int(segs.max())} rows, "
          f"C={segment.chunk_rows(f)}: device_ms={dev:.4f} "
          f"(row_ptr pass {rp}) bound_ms={b_ms:.5f} ({b_by}) "
          f"index_add device_ms={lib:.4f} max_abs_err={err:.3e}"
          + (f" (card: {card})" if card else ""), flush=True)
    return dict(shape=name, E=e, N=n, F=f, longest_segment=int(segs.max()),
                chunk_rows=segment.chunk_rows(f), device_ms=dev,
                row_ptr_device_ms=rp, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, max_abs_err=err)


def check_filter_scatter(torch, batch, device, f, dyadic=False):
    """Phase 4a: filter_scatter (forward and backward), and the backward
    of segment_sum and of the position gathers, against their plain
    versions on the card, at the EF engine's largest bucket. `dyadic`:
    the data are multiples of 1/64 in [-1, 1], whose sums and products
    are exact in float32 whatever the order, and the sums are held
    bitwise (a farm's T-fold batch holds hundreds of padding nodes of
    ~1,300 masked edges each, whose random float sums differ from the
    plain versions' atomic ones by more than the sums' rtol/atol)."""
    from hydragnn_tpu_torch.kernels import fused_mp, segment

    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)

    def dyadic_rows(*shape):
        return (torch.randint(-64, 65, shape, generator=gen).float()
                / 64.0).to(device)

    def randn(*shape):
        if dyadic:
            return dyadic_rows(*shape)
        return torch.randn(*shape, generator=gen).to(device)

    n, e = batch.num_nodes, batch.num_edges
    send, recv, em = batch.senders, batch.receivers, batch.edge_mask
    h, w = randn(n, f), randn(e, f)
    # the odd case: node 5 without in-edges, 5 % of the real edges
    # masked, receivers and senders out of range, and E cut to a length
    # that is a multiple of no block size
    cut = e - 37
    recv_odd = recv[:cut].clone()
    recv_odd[recv_odd == 5] = 6
    recv_odd[:16] = n + 3
    send_odd = send[:cut].clone()
    send_odd[16:24] = -1
    em_odd = em[:cut] & (torch.rand(cut, generator=gen).to(device) > 0.05)
    errs, grad_errs = [], []
    for hh, ww, s_, r_, m_ in ((h, w, send, recv, em),
                               (h, w[:cut].contiguous(), send_odd, recv_odd,
                                em_odd)):
        g = randn(n, f)
        got = []
        for fn in (fused_mp.filter_scatter, fused_mp.filter_scatter_plain):
            th = hh.clone().requires_grad_(True)
            tw = ww.clone().requires_grad_(True)
            out = fn(th, tw, s_, r_, m_, n)
            got.append((out,) + torch.autograd.grad((out * g).sum(),
                                                    (th, tw)))
        (out, dh, dw), (p_out, p_dh, p_dw) = got
        errs.append(compare(torch, "filter_scatter", out.detach(),
                            p_out.detach(), exact=dyadic))
        grad_errs.append(compare(torch, "filter_scatter.dh", dh, p_dh,
                                 exact=dyadic))
        grad_errs.append(compare(torch, "filter_scatter.dw", dw, p_dw,
                                 exact=True))
    if float(out.detach()[5].abs().max()) != 0.0 \
            or float(dh.abs().max()) == 0.0:
        fail("filter_scatter: expected an empty row 5 and a nonzero dh")
    # segment_sum's backward (the energy pooling) and the gathers' (the
    # forces' pos[senders] - pos[receivers])
    ids, g_n = batch.node_graph, batch.num_graphs
    data, gs = randn(n, 1), randn(g_n, 1)
    got = []
    for fn in (segment.segment_sum, segment.segment_sum_plain):
        td = data.clone().requires_grad_(True)
        got.append(torch.autograd.grad((fn(td, ids, g_n) * gs).sum(), td)[0])
    grad_errs.append(compare(torch, "segment_sum.backward", got[0], got[1],
                             exact=True))
    pos = randn(n, 3)
    # the gathers' backward sums every edge's row into its sender, the
    # padding node's thousands of padding edges included: on random
    # floats the plain version's atomic order (it changes from call to
    # call) can differ from the kernel's fixed order by more than the
    # sums' rtol/atol there, so it sums dyadic rows and is held bitwise
    ge = dyadic_rows(e, 3)
    got = []
    for fn in (segment.gather_rows, lambda x, i: x.index_select(0, i)):
        tp = pos.clone().requires_grad_(True)
        got.append(torch.autograd.grad((fn(tp, send) * ge).sum(), tp)[0])
    grad_errs.append(compare(torch, "gather_rows.backward", got[0], got[1],
                             exact=True))

    kept = int(em.sum())
    layout = fused_mp.filter_layouts(send, recv, em, n)
    layout_t = fused_mp.filter_layouts(recv, send, em, n)  # the dh call's
    g = randn(n, f)
    ms = cuda_ms(torch, lambda: fused_mp.filter_scatter(
        h, w, send, recv, em, n, layout))
    bwd_ms = cuda_ms(torch, lambda: fused_mp.filter_scatter(
        g, w, recv, send, em, n, layout_t))
    prep = cuda_ms(torch, lambda: fused_mp.filter_layouts(send, recv, em, n))
    plain = cuda_ms(torch, lambda: fused_mp.filter_scatter_plain(
        h, w, send, recv, em, n))
    # h (or g) once (it stays in L2), the kept edges' w rows and layout
    # entries, row_ptr, out; two float32 operations per kept edge and
    # feature. The dh call moves the same bytes.
    nbytes = 4 * (n * f + kept * f + 2 * kept + (n + 1) + n * f)
    b_ms, b_by = bound_ms(nbytes, 2 * kept * f)
    dram_ms = (nbytes + 4 * (kept - n) * f) / HBM_BYTES_PER_S * 1e3
    dev = device_ms(torch, "filter_scatter", fused_mp.filter_scatter,
                    (h, w, send, recv, em, n, layout), b_ms)
    dev_dh = device_ms(torch, "filter_scatter.dh", fused_mp.filter_scatter,
                       (g, w, recv, send, em, n, layout_t), b_ms)
    by_recv = fused_mp.edge_layout(send, recv, em, n)[2]
    identity = bool(torch.equal(by_recv[:kept].long(),
                                em.nonzero().flatten()))
    print(f"filter_scatter: N={n} E={e} kept_edges={kept} F={f} "
          f"kernel_ms={ms:.4f} (layouts given) backward_dh_ms={bwd_ms:.4f} "
          f"device_ms(graph)={dev:.4f} dh_device_ms(graph)={dev_dh:.4f} "
          f"layouts_prep_ms={prep:.4f} "
          f"plain_ms={plain:.4f} bound_ms={b_ms:.5f} (h read once, L2 "
          f"reuse) bound_every_gather_ms={dram_ms:.5f}; receiver-sorted "
          f"order is the identity on the kept edges: {identity}; max abs "
          f"err forward {max(errs):.3e}, backward {max(grad_errs):.3e}",
          flush=True)
    shapes = [dict(shape="forward", N=n, E=e, kept_edges=kept, F=f,
                   device_ms=dev, bound_ms=b_ms, bound_by=b_by),
              dict(shape="backward_dh", N=n, E=e, kept_edges=kept, F=f,
                   device_ms=dev_dh, bound_ms=b_ms, bound_by=b_by)]
    # the EF path's other segment sums: the energy pooling (F = 1, sorted)
    # and the position gathers' backward (F = 3) on the sender-sorted
    # filter layout, which must equal the fresh sort on every real node
    # real nodes by the mask: a farm's T-fold batch interleaves them with
    # each replica's padding nodes
    real_nodes = batch.node_mask
    nodes = int(real_nodes.sum())
    seg_shapes = [segment_shape(torch, "ef_energy_pooling",
                                randn(n, 1) * batch.node_mask[:, None],
                                batch.node_graph, batch.num_graphs)]
    by_recv, by_send = fused_mp.segment_layouts(layout)
    ge = randn(e, 3)
    for ids, lay in ((send, by_send), (recv, by_recv)):
        fresh = segment.segment_sum(ge, ids, n)
        reuse = segment.segment_sum(ge, ids, n, layout=lay)
        if not torch.equal(fresh[real_nodes], reuse[real_nodes]):
            fail("segment_sum: the filter layout's sum differs from the "
                 "fresh sort on a real node")
        # its backward: g[ids] on the rows the layout sums, 0 on the rows
        # it leaves out, as autograd through the plain sum of those rows
        kept_rows = segment.layout_rows(lay, e)[:, None]
        gn = randn(n, 3)
        got = []
        for fn in (lambda d: segment.segment_sum(d, ids, n, layout=lay),
                   lambda d: segment.segment_sum_plain(
                       torch.where(kept_rows, d, torch.zeros_like(d)), ids,
                       n)):
            td = ge.clone().requires_grad_(True)
            got.append(torch.autograd.grad((fn(td) * gn).sum(), td)[0])
        grad_errs.append(compare(torch, "segment_sum.layout_backward",
                                 got[0], got[1], exact=True))
    seg_shapes.append(segment_shape(torch, "ef_gather_backward", ge, send, n,
                                    layout=by_send, real=real_nodes))
    fresh_dev = device_ms(
        torch, "segment_sum.ef_gather_backward.fresh_sort",
        lambda d, i: segment.segment_sum(d, i, n), (ge, send),
        seg_shapes[-1]["bound_ms"])
    seg_shapes[-1]["fresh_sort_device_ms"] = fresh_dev
    print(f"segment_sum.ef_gather_backward: layout reuse equal to the "
          f"fresh sort on all {nodes} real nodes; the fresh sort's call "
          f"(argsort + row pointers + sum) device_ms={fresh_dev:.4f}",
          flush=True)
    return dict(max_abs_err=max(errs), backward_max_abs_err=max(grad_errs),
                ms=ms, device_ms=dev, backward_ms=bwd_ms,
                backward_device_ms=dev_dh, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shapes=shapes), seg_shapes


def schnet_phase(torch, device, card):
    """Phase 4: LJ SchNet energies and forces through the EF engine.
    Returns (filter_scatter record, segment_sum shapes, launches of the
    main-path burst, the LJ context phase 7 serves again)."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.batch import collate
    from hydragnn_tpu_torch.graphs.packing import sample_sizes
    from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import (InferenceEngine,
                                                   bucket_ladder,
                                                   select_bucket)
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)

    with open(LJ_CONFIG) as fh:
        base_cfg = json.load(fh)
    t0 = time.perf_counter()
    samples = lj_configurations(NUM_LJ, seed=SEED)
    n_tr = int(0.6 * NUM_LJ)
    n_va = int(0.2 * NUM_LJ)
    splits = (samples[:n_tr], samples[n_tr:n_tr + n_va],
              samples[n_tr + n_va:])
    test = splits[2]
    cfg = tcfg.update_config(copy.deepcopy(base_cfg), *splits)
    mcfg = tcfg.build_model_config(cfg)
    print(f"LJ data: {NUM_LJ} cells in {time.perf_counter() - t0:.1f} s; "
          f"model: {mcfg.model_type} hidden={mcfg.hidden_dim} "
          f"filters={mcfg.num_filters} gaussians={mcfg.num_gaussians} "
          f"radius={mcfg.radius} layers={mcfg.num_conv_layers} "
          f"equivariance={mcfg.equivariance} test_requests={len(test)} "
          f"in-edges/atom={test[0].num_edges / test[0].num_nodes:.1f}",
          flush=True)
    variables = random_flax_variables(create_model(mcfg, device="cpu"),
                                      SEED)

    requests = test * ENGINE_REPEATS
    first = requests[:SERVE_MAX_BATCH]
    nodes, edges = sample_sizes(test)
    top = select_bucket(bucket_ladder(nodes, edges, SERVE_MAX_BATCH),
                        len(first), sum(s.num_nodes for s in first),
                        sum(s.num_edges for s in first))
    edge_batch = collate(first, n_node=top.n_node, n_edge=top.n_edge,
                         n_graph=top.n_graph).replace(
        y_node=None, energy=None, forces=None).to(device)
    record, seg_shapes = check_filter_scatter(torch, edge_batch, device,
                                              mcfg.num_filters)
    torch.cuda.synchronize()

    def engine_on(dev):
        model = create_model(mcfg, device=dev)
        model.load_state_dict(load_jax_variables(variables))
        return InferenceEngine(model, mcfg, reference_samples=test,
                               max_batch_size=SERVE_MAX_BATCH,
                               neighbor_format=False, ef_forward=True,
                               device=dev)

    t0 = time.perf_counter()
    with engine_on("cpu") as cpu_engine:
        want = cpu_engine.predict(test, timeout=600)
    print(f"cpu reference EF run: {time.perf_counter() - t0:.1f} s",
          flush=True)

    engine = engine_on(device)
    try:
        engine.warmup()
        engine.reset_stats()
        tk.reset_launch_counts()
        futs = [engine.submit(s) for s in requests]
        results = [fut.result(timeout=600) for fut in futs]
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        singles = [(fut.bucket, engine.forward_single(s, bucket=fut.bucket))
                   for s, fut in list(zip(requests, futs))[:8]]
        engine.reset_stats()
        walls = []
        for _ in range(LJ_BURSTS):
            t0 = time.perf_counter()
            for fut in [engine.submit(s) for s in requests]:
                fut.result(timeout=600)
            walls.append(time.perf_counter() - t0)
        stats = engine.stats()
        model = engine.model
        engine_graphs(torch, engine, requests, "LJ EF engine")
    finally:
        engine.shutdown()
    print(f"EF engine (edge list): launches {counts}", flush=True)
    for name in ("filter_scatter", "filter_scatter_backward", "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the EF engine path")
    for i, (s, got, ref) in enumerate(zip(test, results, want)):
        if got[0].shape != (1,) or got[1].shape != (s.num_nodes, 3):
            fail(f"EF response {i}: shapes {got[0].shape} {got[1].shape}")
    e_got = np.stack([r[0] for r in results[:len(test)]])
    e_ref = np.stack([r[0] for r in want])
    f_got = np.concatenate([r[1] for r in results[:len(test)]])
    f_ref = np.concatenate([r[1] for r in want])
    err_e = float(np.abs(e_got - e_ref).max())
    err_f = float(np.abs(f_got - f_ref).max())
    print(f"EF engine card vs cpu: energies max abs err {err_e:.3e} (of "
          f"max |E| {np.abs(e_ref).max():.3e}), forces max abs err "
          f"{err_f:.3e} (of max |F| {np.abs(f_ref).max():.3e}); tolerance "
          f"{SLICE_TOL}", flush=True)
    for name, g, r in (("energies", e_got, e_ref), ("forces", f_got, f_ref)):
        if not np.isfinite(g).all() or not np.allclose(g, r, **SLICE_TOL):
            fail(f"EF engine {name} on the card vs CPU outside {SLICE_TOL}")
    if not np.abs(f_ref).max() > 0:
        fail("EF engine: the CPU reference forces are all zero")
    diff_e = max(float(np.abs(res[0] - single[0]).max())
                 for (_, single), res in zip(singles, results[:8]))
    diff_f = max(float(np.abs(res[1] - single[1]).max())
                 for (_, single), res in zip(singles, results[:8]))
    print(f"EF batched vs single on the same bucket: energies max abs diff "
          f"{diff_e:.3e}, forces max abs diff {diff_f:.3e}", flush=True)
    total = len(requests) * LJ_BURSTS
    if stats["count"] != total:
        fail(f"EF engine recorded {stats['count']} latencies for {total} "
             "requests")
    med = float(np.median(walls))
    slow = [w for w in walls if w > 2 * med]
    print(f"EF engine bursts: median {len(requests) / med:.1f} requests/s "
          f"(fastest {len(requests) / min(walls):.1f}, slowest "
          f"{len(requests) / max(walls):.1f}); {len(slow)} of {LJ_BURSTS} "
          f"took over twice the median wall", flush=True)
    print(f"EF engine: {total} requests in {LJ_BURSTS} bursts of "
          f"{len(requests)} (each submitted at once), {stats['batches']} "
          f"batches, {sum(walls):.4f} s: {total / sum(walls):.1f} "
          f"requests/s; over all requests p50 {stats['p50_ms']:.3f} ms, "
          f"p99 {stats['p99_ms']:.3f} ms (card: {card})", flush=True)

    fwd = cuda_ms(torch, lambda: energy_forces_from_node_head(
        model, edge_batch), reps=10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        energy_forces_from_node_head(model, edge_batch)
        torch.cuda.synchronize()
    dev_ms, n_launch, rows = profile_rows(torch, prof)
    argsorts = sum(ev.count for ev in prof.key_averages()
                   if ev.key == "aten::argsort")
    sort_launches = sum(r[2] for r in rows if "sort" in r[1].lower())
    print(f"EF forward+backward on the largest bucket (N={edge_batch.num_nodes}"
          f", E={edge_batch.num_edges}): {fwd:.3f} ms (CUDA events); "
          f"profile: device time {dev_ms:.3f} ms in "
          f"{n_launch} kernel launches; {argsorts} argsorts "
          f"({sort_launches} sort kernel launches, "
          f"{sum(r[0] for r in rows if 'sort' in r[1].lower()) / 1e3:.3f} "
          f"ms)", flush=True)
    for dev_t, key, count in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_t / 1e3:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    lj = dict(mcfg=mcfg, variables=variables, test=test, requests=requests,
              batch=edge_batch, want=want)
    return record, seg_shapes, counts, lj


def breakdown(torch, model, first, top, dense_batch, edge_batch, card):
    """Where a batch's time goes: host collation, one forward on the card
    per layout (CUDA events), and the profiler's device time by kernel for
    one edge-list forward."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch.graphs.batch import collate
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        collate(first, n_node=top.n_node, n_edge=top.n_edge,
                n_graph=top.n_graph).to(edge_batch.x.device)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    with torch.inference_mode():
        fwd_edge = cuda_ms(torch, lambda: model(edge_batch), reps=10)
        fwd_dense = cuda_ms(torch, lambda: model(dense_batch), reps=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(edge_batch)
            torch.cuda.synchronize()
    print(f"breakdown ({card}): collate+copy of {len(first)} requests "
          f"{host_ms:.2f} ms (host); forward edge-list N={edge_batch.num_nodes} "
          f"{fwd_edge:.3f} ms, dense N={dense_batch.num_nodes} "
          f"{fwd_dense:.3f} ms (CUDA events)", flush=True)
    total, n_launch, rows = profile_rows(torch, prof)
    print(f"profile of one edge-list forward: device time {total:.3f} "
          f"ms in {n_launch} kernel launches", flush=True)
    for dev, key, count in sorted(rows, reverse=True)[:10]:
        print(f"  {dev / 1e3:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)


SERVING_GRAPHS = {}


def engine_graphs(torch, engine, requests, label):
    """An engine's CUDA graphs (phases 3, 4, 7): each bucket's capture
    time (its warm-up runs included) and, on the bucket of the first
    SERVE_MAX_BATCH requests, the replayed forward's time (CUDA events,
    median of 20 replays), one profiled replay's device time and device
    events (held against the launch counters), and the engine's whole
    forward (host collate, copy into the static batch, replay, outputs to
    the host; wall time, median of 5). Held: each bucket's replay on the
    first requests that fit it equals its eager forward (the capture's
    body) bitwise, and the graph's kernel nodes the launches a replay
    counts. Call with the dispatcher idle. Recorded in
    SERVING_GRAPHS under `label`."""
    from concurrent.futures import Future

    from hydragnn_tpu_torch.serving.engine import _Request, select_bucket
    reqs = [_Request(s, Future()) for s in requests[:SERVE_MAX_BATCH]]
    bucket = select_bucket(engine.buckets, len(reqs),
                           sum(r.n for r in reqs), sum(r.e for r in reqs))
    cap = engine._graphs[bucket]
    for b in engine.buckets:      # each bucket's graph vs its eager body
        sub, n, e = [], 0, 0
        for r in reqs:
            if (len(sub) < b.cap_graphs and n + r.n <= b.cap_nodes
                    and e + r.e <= b.cap_edges):
                sub.append(r)
                n, e = n + r.n, e + r.e
        got, _ = engine._forward(sub, b)
        batch = engine._collate_bucket([r.sample for r in sub], b)
        want = [o.detach().cpu().numpy() for o in engine._run(
            batch.to(engine.device))]
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"{label}: bucket {b.n_node}x{b.n_edge}x{b.n_graph}: the "
                 "graph's outputs differ from the eager forward's")
    replay_ms = cuda_ms(torch, cap.replay, reps=20)
    nodes = check_graph_kernels(cap, f"{label} {bucket}")
    dev_ms, events, _, port = profiled_call(torch, cap.replay,
                                            f"{label} replay", hold=False)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine._forward(reqs, bucket)
        walls.append((time.perf_counter() - t0) * 1e3)
    rec = dict(graphs_equal_eager=True,
               capture_ms={f"{b.n_node}x{b.n_edge}x{b.n_graph}": ms
                           for b, ms in engine.capture_ms.items()},
               bucket=f"{bucket.n_node}x{bucket.n_edge}x{bucket.n_graph}",
               requests=len(reqs), replay_ms=replay_ms, device_ms=dev_ms,
               device_events=events, idle_share=max(0.0, 1 - dev_ms
                                                    / replay_ms),
               forward_wall_ms=float(np.median(walls)),
               port_kernel_nodes=nodes, port_kernels_in_profile=port)
    SERVING_GRAPHS[label] = rec
    print(f"{label} graphs: every bucket's replay bitwise equal to its "
          f"eager forward; capture ms by bucket {rec['capture_ms']}; "
          f"{len(reqs)} requests on bucket {rec['bucket']}: replay "
          f"{replay_ms:.3f} ms (CUDA events), device {dev_ms:.3f} ms in "
          f"{events} device events (idle share {rec['idle_share']:.3f}); "
          f"the engine's whole forward {rec['forward_wall_ms']:.3f} ms "
          f"(host collate + copy + replay + outputs to the host, wall); "
          f"the graph's hand-written kernel nodes (= a replay's launch "
          f"counts) {nodes}, in the profile {port}", flush=True)
    return rec


def profile_rows(torch, prof):
    """(device ms, kernel launches, rows) of a profiler run: the device
    events (kernels, copies, sets) and their time. The operator events
    that launched them carry the same device time as their own and are
    left out, or every kernel would count twice."""
    rows = []
    for ev in prof.key_averages():
        dev_t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
        if dev_t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_t, ev.key, ev.count))
    return (sum(r[0] for r in rows) / 1e3, sum(r[2] for r in rows), rows)


def autograd_device_ms(torch, name, make_loss, bound: float) -> float:
    """Device time per call of autograd's backward of make_loss()'s
    (loss, inputs): the forward runs once on a side stream, so that its
    backward ops run there, then GRAPH_CALLS calls of torch.autograd.grad
    on it are captured in one CUDA graph on that stream and replayed (CUDA
    events, median). Fails below `bound`."""
    made = []

    def warm():
        made[:] = make_loss()
        torch.autograd.grad(*made, retain_graph=True)

    def calls():
        for _ in range(GRAPH_CALLS):
            torch.autograd.grad(*made, retain_graph=True)
    graph = capture(torch, warm, calls)
    ms = cuda_ms(torch, graph.replay, reps=10) / GRAPH_CALLS
    if ms < bound:
        fail(f"{name}: device time {ms} ms below its bound {bound} ms")
    return ms


def call_launches(torch, fn, args) -> int:
    """Device launches (kernels, copies, sets) of one fn(*args): the nodes
    of a CUDA graph captured from the call (cuGraphGetNodes). The profiler
    missed the ctypes kernels' launches in all but the first of several
    short profiles in one process."""
    import ctypes
    graph = capture(torch, lambda: fn(*args), lambda: fn(*args),
                    keep_graph=True)
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        fail(f"cuGraphGetNodes failed with CUresult {err}")
    return count.value


def backward_routes(torch, kind, args):
    """(kernel, torch-op VJP): the backward kernel's wrapper and its plain
    version as functions of (proj_i, proj_j, 4 cotangents) on the tables
    of `args`, with the forward kernel's extrema and the layouts a
    training forward builds once."""
    from hydragnn_tpu_torch.kernels import fused_mp, nbr
    pi, pj, tables = args[0], args[1], args[2:]
    if kind == "dense":
        layout = nbr.neighbor_layout(*tables)
        _, mn, mx, _, _ = nbr.nbr_aggregate(pi, pj, *tables)
        return ((lambda a, b, *g: nbr.nbr_aggregate_bwd(
                    a, b, *tables, mn, mx, *g, 1e-5, layout)),
                (lambda a, b, *g: nbr.nbr_aggregate_vjp(
                    a, b, *tables, mn, mx, *g, 1e-5, layout)))
    send, recv, em, n = tables
    lay = fused_mp.edge_layout(send, recv, em, n)
    lay_t = fused_mp.edge_layout(recv, send, em, n)
    pos = fused_mp.edge_positions(lay, lay_t)
    acc = fused_mp.pna_edge_accumulators(pi, pj, send, recv, em, n, lay)
    return ((lambda a, b, *g: fused_mp.pna_edge_bwd(
                a, b, *tables, acc[3], acc[4], *g, lay, lay_t, pos)),
            (lambda a, b, *g: fused_mp.pna_edge_vjp(
                a, b, *tables, acc[3], acc[4], *g, lay, lay_t)))


def check_pna_backwards(torch, batch, device, f):
    """Phase 5a: the backward kernels of the two PNA Functions
    (csrc/pna_backward.cu) at the training loader's shape (dense N 8,192,
    K 24, F 200, and the same batch as an edge list). Held: the kernel
    against its plain version, the torch-op VJP (`nbr_aggregate_vjp`,
    `pna_edge_vjp`), on the card, float32 random data within SUM_TOL and
    the tie-rich dyadic cases bitwise, and bf16 random data within one
    bf16 ulp of the bf16 VJP, the bf16-exact dyadic cases bitwise; and,
    through the Functions, against autograd through the plain forwards
    (float32). Times, each from 20 calls in one CUDA graph: the kernel,
    the torch-op VJP and plain autograd's backward, beside the byte bound
    (float32 and bf16), and the device launches of one call of each."""
    from hydragnn_tpu_torch.graphs.synthetic import (tie_rich_edge_case,
                                                     tie_rich_neighbor_case)
    from hydragnn_tpu_torch.kernels import fused_mp, nbr

    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    def t(a, dtype=torch.float32):
        x = torch.from_numpy(np.asarray(a)).to(device)
        return x.to(dtype) if x.is_floating_point() else x

    def plain_forward(kind, pi, pj, args):
        if kind == "dense":
            return nbr.nbr_aggregate_plain(pi, pj, *args[2:])[:4]
        acc = fused_mp.pna_edge_accumulators_plain(pi, pj, *args[2:])
        return (acc[0], acc[1], acc[3], acc[4])

    records = {}
    n, k = batch.nbr.shape
    e = batch.num_edges
    for kind in ("dense", "edge"):
        tie_case = tie_rich_neighbor_case if kind == "dense" \
            else tie_rich_edge_case
        tables = ((batch.nbr, batch.nbr_mask) if kind == "dense" else
                  (batch.senders, batch.receivers, batch.edge_mask, n))
        extra = (dict(k=k) if kind == "dense" else {})
        errs, ulps = [], []
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            tie = tie_case(SEED, n=n, f=f, bf16_exact=bf16, **extra)
            cases = [((randn(n, f).to(dtype), randn(n, f).to(dtype))
                      + tables, [randn(n, f).to(dtype) for _ in range(4)],
                      False),
                     (tuple(t(a, dtype) for a in tie)
                      + (() if kind == "dense" else (n,)),
                      None, True)]
            for args, grads, dyadic in cases:
                if dyadic:
                    rng = np.random.RandomState(SEED)
                    grads = [t(rng.randint(-4, 5, (n, f)) / 8, dtype)
                             for _ in range(3)]
                    grads.insert(3 if kind == "dense" else 1,
                                 torch.zeros(n, f, device=device,
                                             dtype=dtype))
                kern, vjp = backward_routes(torch, kind, args)
                got = kern(args[0], args[1], *grads)
                want = vjp(args[0], args[1], *grads)
                label = (f"{kind} backward kernel vs torch-op VJP"
                         + (" bf16" if bf16 else "")
                         + (" (dyadic)" if dyadic else ""))
                for name, g, w in zip(("dproj_i", "dproj_j"), got, want):
                    if bf16:
                        ulps.append(compare_bf16(torch, f"{label} {name}", g,
                                                 w, exact=dyadic)[0])
                    else:
                        errs.append(compare(torch, f"{label} {name}", g, w,
                                            exact=dyadic))
                if bf16:
                    continue
                # through the Function, against autograd through the
                # plain forward
                pair = []
                for plain in (False, True):
                    pi = args[0].clone().requires_grad_(True)
                    pj = args[1].clone().requires_grad_(True)
                    if plain:
                        res = plain_forward(kind, pi, pj, args)
                    elif kind == "dense":
                        res = nbr.nbr_aggregate(pi, pj, *args[2:])[:4]
                    else:
                        acc = fused_mp.pna_edge_accumulators(pi, pj,
                                                             *args[2:])
                        res = (acc[0], acc[1], acc[3], acc[4])
                    loss = sum((r * g).sum() for r, g in zip(res, grads))
                    pair.append(torch.autograd.grad(loss, (pi, pj)))
                for name, got_, want_ in zip(("dproj_i", "dproj_j"), *pair):
                    errs.append(compare(
                        torch, f"{kind} backward {name} vs plain autograd"
                        + (" (dyadic)" if dyadic else ""), got_, want_,
                        exact=dyadic))

        # the timed backwards: random data at the loader's shape. The
        # bound counts the rows the function needs: the row-indexed
        # inputs of the rows with a kept slot (the loader's padding rows
        # have none), proj_j of the nodes a kept slot names
        if kind == "dense":
            idx = batch.nbr.long()
            kept = batch.nbr_mask & (idx >= 0) & (idx < n)
            rows_in = int(kept.any(1).sum())
            named = int(torch.unique(idx[kept]).numel())
        else:
            kept = fused_mp._kept_edges(*tables)
            rows_in = int(torch.unique(batch.receivers[kept]).numel())
            named = int(torch.unique(batch.senders[kept]).numel())
        slots = int(kept.sum())
        if kind == "dense":
            records["nbr_aggregate.loader"] = loader_forward(
                torch, randn, tables, rows_in, named, slots, f)
        timed = {}
        for dtype in (torch.float32, torch.bfloat16):
            args = (randn(n, f).to(dtype), randn(n, f).to(dtype)) + tables
            kern, vjp = backward_routes(torch, kind, args)
            passes = dict.fromkeys(BACKWARD_PASSES[kind])
            vargs = (args[0], args[1],
                     *[randn(n, f).to(dtype) for _ in range(4)])
            size = 2 if dtype == torch.bfloat16 else 4
            # proj_i, min, max and the 4 cotangents of rows_in rows and
            # proj_j of `named` rows in, the 2 gradients out on all N rows
            nbytes = size * (7 * rows_in + named + 2 * n) * f
            if kind == "dense":
                # the table and the neighbour layout read once
                nbytes += 5 * n * k + 4 * (slots + n + 1)
                flops = 30 * slots * f
            else:
                # the edges (2 ids and a mask) and the two layouts read once
                nbytes += 9 * e + 4 * 2 * (slots + n + 1)
                flops = 20 * slots * f
            # the kernel's dh buffer: N K or E rows allocated, the kept
            # slots' written once and read once
            dh_rows = n * k if kind == "dense" else e
            b_ms, b_by = bound_ms(nbytes, flops)
            # the first bound, which charged all N rows, for comparison
            all_rows = nbytes + size * 7 * (n - rows_in) * f \
                + size * (n - named) * f
            rec = dict(bound_ms=b_ms, bound_by=b_by,
                       bound_all_rows_ms=bound_ms(all_rows, flops)[0],
                       ms=cuda_ms(torch, lambda: kern(*vargs)),
                       device_ms=device_ms(torch, f"{kind} backward kernel",
                                           kern, vargs, b_ms, passes),
                       plain_ms=device_ms(torch, f"{kind} torch-op VJP",
                                          vjp, vargs, b_ms),
                       launches_per_call=call_launches(torch, kern, vargs),
                       plain_launches_per_call=call_launches(torch, vjp,
                                                             vargs),
                       passes_ms=passes,
                       dh_buffer_bytes=size * dh_rows * f,
                       dh_written_bytes=size * slots * f)
            if dtype == torch.float32:
                def make_loss():
                    pi = args[0].clone().requires_grad_(True)
                    pj = args[1].clone().requires_grad_(True)
                    res = plain_forward(kind, pi, pj, args)
                    return (sum((r * g).sum() for r, g in
                                zip(res, vargs[2:])), (pi, pj))
                rec["autograd_ms"] = autograd_device_ms(
                    torch, f"{kind} plain autograd backward", make_loss,
                    b_ms)
            timed[dtype] = rec
        name = ("nbr_aggregate.backward" if kind == "dense"
                else "pna_edge_aggregate.backward")
        width = f"K={k}" if kind == "dense" else f"E={e}"
        r32, r16 = timed[torch.float32], timed[torch.bfloat16]
        for label, r in (("", r32), (" bf16", r16)):
            print(f"{name}{label} passes (device ms a launch, profile of the "
                  f"graph's replays): {fmt_ms(r['passes_ms'])}; dh buffer "
                  f"{r['dh_buffer_bytes']} B allocated, "
                  f"{r['dh_written_bytes']} B written and read",
                  flush=True)
        print(f"{name}: N={n} {width} F={f} real={slots} rows with a slot="
              f"{rows_in} named={named} device_ms(graph): "
              f"kernel={r32['device_ms']:.4f} torch-op VJP="
              f"{r32['plain_ms']:.4f} plain autograd={r32['autograd_ms']:.4f}"
              f"; bound_ms={r32['bound_ms']:.5f} ({r32['bound_by']}; all "
              f"{n} rows charged: {r32['bound_all_rows_ms']:.5f}); "
              f"launches per call kernel={r32['launches_per_call']} "
              f"VJP={r32['plain_launches_per_call']}; kernel call_ms="
              f"{r32['ms']:.4f}; vs the plain versions max_abs_err="
              f"{max(errs):.3e} (random within SUM_TOL, tie-rich dyadic "
              "bitwise)", flush=True)
        print(f"{name} bf16: device_ms(graph): kernel={r16['device_ms']:.4f}"
              f" torch-op VJP={r16['plain_ms']:.4f}; bound_ms="
              f"{r16['bound_ms']:.5f} ({r16['bound_by']}); launches per "
              f"call kernel={r16['launches_per_call']} "
              f"VJP={r16['plain_launches_per_call']}; vs the bf16 VJP max "
              f"{max(ulps)} ulps (bound 1; dyadic bitwise)", flush=True)
        records[name] = dict(max_abs_err=max(errs), library_ms=None,
                             rows_with_slot=rows_in, named_rows=named, **r32,
                             bf16=dict(N=n, F=f, max_ulps=max(ulps),
                                       dyadic_bitwise=True, **r16))
    return records


def fmt_ms(times):
    return ", ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in times.items())


def loader_forward(torch, randn, tables, rows_in, named, slots, f):
    """B1's forward at the training loader's shape (phase 5a's batch),
    float32 and bf16: held bitwise against its plain version (every
    output), its device time (20 calls in one CUDA graph) beside the byte
    bound this batch needs (proj_i of the rows with a slot, proj_j of the
    named nodes, the table and mask, the five outputs on all N rows) and
    the bound that charges both projections on all N rows."""
    from hydragnn_tpu_torch.kernels import nbr
    n, k = tables[0].shape
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        size = 2 if dtype == torch.bfloat16 else 4
        args = (randn(n, f).to(dtype), randn(n, f).to(dtype)) + tables
        for name, g, w in zip(("mean", "min", "max", "std", "deg"),
                              nbr.nbr_aggregate(*args),
                              nbr.nbr_aggregate_plain(*args)):
            if not torch.equal(g, w):
                fail(f"nbr_aggregate {dtype} at the loader shape: {name} "
                     "not equal to the plain version")
        rest = 5 * n * k + size * (4 * n * f + n)
        flops = 6 * slots * f + 8 * n * f
        b_ms, b_by = bound_ms(size * (rows_in + named) * f + rest, flops)
        out["bf16" if size == 2 else "float32"] = dict(
            N=n, K=k, F=f, bound_ms=b_ms, bound_by=b_by,
            bound_all_rows_ms=bound_ms(size * 2 * n * f + rest, flops)[0],
            device_ms=device_ms(torch, "nbr_aggregate (loader)",
                                nbr.nbr_aggregate, args, b_ms),
            bitwise=True)
    r32, r16 = out["float32"], out["bf16"]
    print(f"nbr_aggregate at the loader shape: N={n} K={k} F={f} "
          f"real={slots}; device_ms(graph) float32={r32['device_ms']:.4f} "
          f"bf16={r16['device_ms']:.4f}; bound_ms float32="
          f"{r32['bound_ms']:.5f} bf16={r16['bound_ms']:.5f} (bytes of "
          f"this batch; all {n} rows charged: "
          f"{r32['bound_all_rows_ms']:.5f} / "
          f"{r16['bound_all_rows_ms']:.5f}); bitwise vs plain", flush=True)
    return out


def train_parts(torch, cfg, splits, device, group: int = 0):
    """What run_training builds, for the step measurements: (model,
    state, train step, train loader, completed config, model config); with
    `group` > 0 also the multi step of that many steps, last."""
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.triplets import maybe_triplet_transform
    from hydragnn_tpu_torch.models.create import create_model, data_input_dim
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    cfg = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = data_input_dim(tcfg.build_model_config(cfg), splits[0])
    tr = cfg["NeuralNetwork"]["Training"]
    nbr_fmt = bool(cfg["NeuralNetwork"]["Architecture"].get(
        "neighbor_format", True))
    bs = int(tr["batch_size"])
    loader = create_dataloaders(
        *splits, bs, neighbor_format=nbr_fmt,
        packing=bool(tr.get("batch_packing", False)),
        batch_transform=maybe_triplet_transform(
            mcfg.model_type, splits[0] + splits[1] + splits[2], bs))[0]
    model = create_model(mcfg, device=device, seed=SEED)
    tx = topt.select_optimizer(tr)
    state = tstep.TrainState.create(model, tx)
    fw = tr.get("force_loss_weight", 1.0)
    kw = dict(loss_name=tr.get("loss_function_type", "mse"),
              compute_grad_energy=bool(tr.get("compute_grad_energy", False)),
              energy_weight=float(tr.get("energy_loss_weight", 1.0)),
              force_weight=fw if fw == "auto" else float(fw))
    step = tstep.make_train_step(model, mcfg, tx, **kw)
    parts = (model, state, step, loader, cfg, mcfg)
    if group:
        parts += (tstep.make_multi_train_step(model, mcfg, tx, **kw),)
    return parts


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper of the model's path replaced by its plain
    PyTorch version under autograd (the yardstick on the same card)."""
    from hydragnn_tpu_torch.kernels import fused_mp, nbr, segment
    from hydragnn_tpu_torch.models import convs
    from hydragnn_tpu_torch.ops import segment as oseg

    def edge(pi, pj, s_, r_, m_, n, eps=1e-5, layout=None, layout_t=None,
             edge_pos=None):
        return oseg.pna_stats_epilogue(
            *fused_mp.pna_edge_accumulators_plain(pi, pj, s_, r_, m_, n), eps)

    patches = [
        (convs, "nbr_aggregate",
         lambda pi, pj, n_, m_, eps=1e-5, layout=None:
             nbr.nbr_aggregate_plain(pi, pj, n_, m_, eps)),
        (convs, "pna_edge_aggregate", edge),
        (oseg._seg_kernel, "segment_sum",
         lambda d, i, n, indices_are_sorted=False, layout=None:
             segment.segment_sum_plain(d, i, n)),
        (fused_mp, "filter_scatter",
         lambda h, w, s_, r_, m_, n, layout=None:
             fused_mp.filter_scatter_plain(h, w, s_, r_, m_, n)),
        (segment, "gather_rows", lambda x, i, layout=None:
             x.index_select(0, i))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def first_step_gradients(torch, cfg, splits, card):
    """The first training batch's loss and parameter gradients from one
    seeded initialization: on the card through the kernels, on the card
    through the plain versions, on the CPU, and on the CPU in float64.

    Held: the loss, card vs CPU, within SLICE_TOL; and for every tensor
    the relative L2 gap of its gradient through the kernels vs through
    the plain versions on the card, at most 1e-2 (or ten times the CPU
    float32 gradient's own relative error against float64): a lost
    gradient path gives 1. A tensor whose CPU float32 gradient misses
    float64 by more than half (0 but for rounding, as a bias ahead of a
    batch norm) is held only within all the tensors as one vector (the
    same bound, from the vectors' gaps): alone its relative gap compares
    two roundings.
    Printed, not held: card vs CPU, the largest entry errors and how many
    entries lie outside SLICE_TOL. At csce width float32 misses the
    float64 gradient of a middle layer by up to a few percent (the PNA
    std aggregator's sq / c - mean² cancels; the isolated atoms'
    attenuation scaler lifts their features to ~1e4 and the batch norms
    carry them), more on the card than on the CPU, so two devices cannot
    agree entry by entry at rtol 1e-4."""
    from hydragnn_tpu_torch.train import train_step as tstep
    runs = {}
    for tag, dev, dtype in (("card", card, torch.float32),
                            ("card_plain", card, torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        model, state, _, loader, cfg_c, mcfg = train_parts(torch, cfg,
                                                           splits, dev)
        model.to(dtype)
        tr = cfg_c["NeuralNetwork"]["Training"]
        loader.set_epoch(0)
        batch = next(iter(loader)).to(dev)
        batch = batch.replace(**{
            k: getattr(batch, k).to(dtype) for k in (
                "x", "pos", "y_graph", "y_node", "edge_attr", "edge_shifts",
                "energy", "forces") if getattr(batch, k) is not None})
        model.train()
        with (plain_versions() if tag == "card_plain"
              else contextlib.nullcontext()):
            total, _ = tstep.make_loss_fn(
                model, mcfg, tr.get("loss_function_type", "mse"),
                compute_grad_energy=bool(tr.get("compute_grad_energy")))(
                    batch)
            grads = torch.autograd.grad(total, list(model.parameters()),
                                        allow_unused=True,
                                        materialize_grads=True)
        runs[tag] = (float(total.detach()),
                     [g.detach().cpu().double() for g in grads],
                     [k for k, _ in model.named_parameters()])
    l_card, g_card, names = runs["card"]
    l_cpu, g_cpu, _ = runs["cpu"]
    if not np.isclose(l_card, l_cpu, **SLICE_TOL):
        fail(f"first step loss card {l_card} vs cpu {l_cpu}")
    rec = dict(loss_gap=abs(l_card - l_cpu), kernels_vs_plain=0.0,
               card_cpu=0.0, outside=0, elements=0, rel_l2_card_cpu=0.0,
               rel_l2_kernels_plain=0.0, rel_l2_cpu_f64=0.0)

    def rel(x, y):
        return float((x - y).norm() / max(float(y.norm()), 1e-30))
    worst = []
    gap2 = ref2 = cpu2 = f64_2 = dev2 = b2 = 0.0
    noise = []
    for name, a, p_, b, w in zip(names, g_card, runs["card_plain"][1],
                                 g_cpu, runs["cpu64"][1]):
        q = rel(b, w)
        gap2 += float((a - p_).norm()) ** 2
        ref2 += float(p_.norm()) ** 2
        cpu2 += float((b - w).norm()) ** 2
        f64_2 += float(w.norm()) ** 2
        dev2 += float((a - b).norm()) ** 2
        b2 += float(b.norm()) ** 2
        if q > 0.5:
            # more rounding than gradient (a bias ahead of a batch norm,
            # whose gradient is 0 but for rounding): held with all the
            # tensors as one vector below, not alone
            noise.append(name)
            continue
        bound = max(1e-2, 10 * q)
        if not rel(a, p_) <= bound:
            fail(f"first step gradient {name}: kernels vs plain versions "
                 f"on the card relative L2 gap {rel(a, p_)} above {bound} "
                 f"(cpu float32 vs float64 {q})")
        worst.append((rel(a, b), name, rel(a, w), q))
        rec["kernels_vs_plain"] = max(rec["kernels_vs_plain"],
                                      float((a - p_).abs().max()))
        rec["card_cpu"] = max(rec["card_cpu"], float((a - b).abs().max()))
        rec["outside"] += int((~torch.isclose(a, b, **SLICE_TOL)).sum())
        rec["elements"] += a.numel()
        if float(w.abs().max()) > 1e-12:   # not 0 but for rounding
            rec["rel_l2_card_cpu"] = max(rec["rel_l2_card_cpu"], rel(a, b))
            rec["rel_l2_kernels_plain"] = max(rec["rel_l2_kernels_plain"],
                                              rel(a, p_))
            rec["rel_l2_cpu_f64"] = max(rec["rel_l2_cpu_f64"], q)
    rec["worst_card_cpu"] = [
        dict(tensor=n, card_cpu=r, card_f64=c, cpu_f64=q)
        for r, n, c, q in sorted(worst, reverse=True)[:4]]
    rec["rounding_only_tensors"] = noise
    rec["rel_l2_kernels_plain_all"] = (gap2 / max(ref2, 1e-60)) ** 0.5
    rec["rel_l2_cpu_f64_all"] = (cpu2 / max(f64_2, 1e-60)) ** 0.5
    rec["rel_l2_card_cpu_all"] = (dev2 / max(b2, 1e-60)) ** 0.5
    bound = max(1e-2, 10 * rec["rel_l2_cpu_f64_all"])
    if not rec["rel_l2_kernels_plain_all"] <= bound:
        fail(f"first step gradients as one vector: kernels vs plain "
             f"versions on the card relative L2 gap "
             f"{rec['rel_l2_kernels_plain_all']} above {bound} (cpu "
             f"float32 vs float64 {rec['rel_l2_cpu_f64_all']})")
    return rec


def history_gaps(card_hist, cpu_hist, keys=("train_loss", "val_loss",
                                             "test_loss")):
    """{key: max relative gap over the epochs} of two histories."""
    return {k: max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(card_hist[k], cpu_hist[k])) for k in keys}


# the port's launch counters -> the kernels whose launches they count, as
# a profile names them (segment_sum's row-pointer pass is not counted)
# the two kernels of a PNA backward call, pass 1 then pass 2
BACKWARD_PASSES = {"dense": ("nbr_bwd_rows_kernel", "dh_cols_kernel"),
                   "edge": ("edge_bwd_rows_kernel", "dh_cols_kernel")}
PROFILED_KERNELS = {
    ("segment_sum",): ("segment_sum_kernel",),
    ("nbr_aggregate",): ("nbr_aggregate_kernel",),
    ("pna_edge_aggregate",): ("pna_edge_kernel",),
    ("filter_scatter", "filter_scatter_backward"): ("filter_scatter_kernel",),
    ("nbr_aggregate_backward", "pna_edge_aggregate_backward"): (
        "nbr_bwd_rows_kernel", "edge_bwd_rows_kernel", "dh_cols_kernel"),
}


def graph_kernels(graph):
    """{kernel identifier: nodes} of a captured CUDA graph's kernel nodes
    (a graph kept with keep_graph=True), read from the CUDA driver API
    (cuGraphGetNodes, cuGraphKernelNodeGetParams, cuFuncGetName or
    cuKernelGetName), each mangled name cut to its identifier."""
    import ctypes
    import re
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            fail(f"{what} failed with CUresult {err}")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2",
                         cu.cuGraphKernelNodeGetParams)
    out = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:          # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func first, the CUkernel at byte 56
        params = (ctypes.c_void_p * 16)()
        check(get_params(ctypes.c_void_p(node), params),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params[0])),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params[7])),
                  "cuKernelGetName")
        mangled = name.value.decode()
        m = re.match(r"_Z(\d+)(\w+)", mangled)
        ident = m.group(2)[:int(m.group(1))] if m else mangled
        out[ident] = out.get(ident, 0) + 1
    return out


def check_graph_kernels(cap, label):
    """{kernels: nodes} of the port's kernels in a captured step's graph,
    held equal to the launches its replay adds to the launch counters."""
    nodes = graph_kernels(cap.graph)
    seen = {}
    for counters, names in PROFILED_KERNELS.items():
        got = sum(nodes.get(k, 0) for k in names)
        want = sum(cap.launches[c] for c in counters)
        if got != want:
            fail(f"{label}: the graph holds {got} nodes of "
                 f"{'/'.join(names)}, a replay adds {want} to the launch "
                 "counters")
        seen["/".join(names)] = got
    return seen


def check_profiled_kernels(rows, before, after, label, hold=True):
    """{kernels: launches} of the port's kernels in a profile's rows,
    held equal to the launch counters' change over the profiled run, so
    that the profile's device time and launches are known to hold every
    hand-written kernel the run launched. With hold=False a difference
    is returned under "differs" instead of failing."""
    import re
    seen = {}
    for counters, names in PROFILED_KERNELS.items():
        pat = re.compile(r"\b(" + "|".join(names) + r")<")
        got = sum(count for _, key, count in rows if pat.search(key))
        want = sum(after[c] - before[c] for c in counters)
        if got != want:
            if hold:
                fail(f"{label}: the profile holds {got} launches of "
                     f"{'/'.join(names)}, the launch counters {want}")
            seen.setdefault("differs", {})["/".join(names)] = [got, want]
        seen["/".join(names)] = got
    return seen


def step_events_ms(torch, call, reps: int = 10, warm: int = 2):
    """CUDA-event times (ms) of `reps` calls of call(), after `warm`."""
    for _ in range(warm):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def profiled_call(torch, call, label, hold=True):
    """(device ms, device events, rows, the port's kernels in the
    profile) of one call(), profiled; fails unless the profile holds as
    many launches of each hand-written kernel as the launch counters
    counted (a replayed graph adds its captured launches). hold=False
    reports a difference (under "differs") instead: in a long process
    the profiler has been seen to drop some of a graph replay's ctypes
    kernels (measured on one H100), so a graph is held by its own nodes instead
    (`check_graph_kernels`). It has dropped one of an eager call's too
    (on one H100): with hold, a profile that misses a launch is taken
    again, up to PROFILE_ATTEMPTS times, and only one that holds every
    launch is used."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch import kernels as tk
    for attempt in range(PROFILE_ATTEMPTS):
        before = tk.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        dev_ms, launches, rows = profile_rows(torch, prof)
        port = check_profiled_kernels(rows, before, tk.launch_counts(),
                                      label, hold=False)
        if not hold or "differs" not in port:
            return dev_ms, launches, rows, port
        print(f"{label}: profile {attempt + 1} dropped launches "
              f"{port['differs']} (profile vs counters); profiling again",
              flush=True)
    fail(f"{label}: {PROFILE_ATTEMPTS} profiles each missed launches the "
         f"counters counted: {port['differs']}")


def bf16_cast_cost(torch, model, batch):
    """What a bf16 step casts at each forward, alone: every parameter and
    buffer and the batch's float fields, float32 -> bf16
    (train_step._cast_variables, cast_floats), captured in one CUDA graph:
    its replay time (CUDA events, median of 20) and its nodes. The share
    of the step a grouped cast (ROADMAP A5.4b) could take back."""
    from hydragnn_tpu_torch.train import train_step as tstep

    def cast():
        tstep._cast_variables(model, torch.bfloat16)
        tstep.cast_floats(batch, torch.bfloat16)
    graph = capture(torch, cast, cast)
    return dict(device_ms=cuda_ms(torch, graph.replay, reps=20),
                nodes=call_launches(torch, cast, ()))


def graph_parity(torch, cfg, splits, device, label, group):
    """Held bitwise: a captured group of `group` steps and then a captured
    single step, against as many eager steps (the bodies they were
    captured from) from the same seeded state on the same batches: each
    step's metrics and every parameter, running statistic and optimizer
    slot afterwards."""
    runs = []
    for graphed in (False, True):
        _, state, step, loader, _, _, multi = train_parts(
            torch, cfg, splits, device, group)
        loader.set_epoch(0)
        batches = [b.to(device) for b, _ in zip(loader, range(group))]
        if graphed:
            state, m = multi(state, batches)
            losses = m["loss"].cpu().tolist()
            state, m = step(state, batches[0])
        else:
            losses = []
            for b in batches:
                state, m = step.eager(state, b)
                losses.append(float(m["loss"]))
            state, m = step.eager(state, batches[0])
        losses.append(float(m["loss"]))
        opt = state.opt_state
        tensors = [t.detach().cpu() for t in state.state_dict().values()] + [
            t.cpu() for ts in opt.slots.values() for t in ts]
        runs.append((losses, tensors, (state.step, opt.count)))
    (la, ta, ca), (lb, tb, cb) = runs
    same = la == lb and ca == cb and all(
        torch.equal(a, b) for a, b in zip(ta, tb))
    print(f"{label}: a captured group of {group} steps and a captured "
          f"single step vs {group + 1} eager steps: losses {lb}; "
          f"metrics, parameters, statistics and slots bitwise equal: "
          f"{same}", flush=True)
    if not same:
        fail(f"{label}: captured steps differ from the eager steps")
    return same


def step_metrics(torch, cfg, splits, device, label, real_graphs, group,
                 card=None):
    """Per training path, three routes on one state: the eager step body
    (`TrainStep.eager`, a measurement beside the graphs, never the route),
    the captured single step (the S = 1 graph run_training replays) and
    the captured group of `group` steps (steps_per_call). Each: call time
    (CUDA events, median of 10 after 2 warm-up calls), per-step time,
    device time and device events (kernels, copies, sets) of one profiled
    call, the card's idle share within it, graphs/s (over `real_graphs`
    a step or, given None, the timed batches' mean real graphs); the
    graphs' capture times, the port's kernel launches inside one captured
    step, and for a
    bf16 path the forward's casts alone (`bf16_cast_cost`). Held first:
    `graph_parity`. Fails unless each captured graph holds as many nodes
    of each hand-written kernel as a replay adds to the launch counters,
    and the eager call's profile as many launches as the counters counted
    (the graph routes' profiles are reported beside them). `card`, given,
    is printed beside each route's numbers."""
    parity = graph_parity(torch, cfg, splits, device, label, group)
    model, state, step, loader, _, _, multi = train_parts(
        torch, cfg, splits, device, group)
    loader.set_epoch(0)
    batches = [b.to(device) for b, _ in zip(loader, range(group))]
    if real_graphs is None:
        # packed batches: the timed batches' mean count of real graphs
        real_graphs = float(np.mean([int(b.graph_mask.sum())
                                     for b in batches]))
    turn = [0]

    def nxt():
        turn[0] += 1
        return batches[turn[0] % len(batches)]

    def eager():
        step.eager(state, nxt())

    def single():
        step(state, nxt())

    def grouped():
        multi(state, batches)

    step(state, batches[0])
    multi(state, batches)
    torch.cuda.synchronize()
    cap1 = next(iter(step.steps.graphs.values()))
    capg = next(iter(multi.steps.graphs.values()))
    graph_nodes = {"S1": check_graph_kernels(cap1, f"{label} S1"),
                   f"S{group}": check_graph_kernels(capg, f"{label} S{group}")}
    out = {"graphs_equal_eager": parity,
           "port_kernel_nodes": graph_nodes,
           "capture_ms": {"S1": cap1.capture_ms,
                          f"S{group}": capg.capture_ms},
           "kernel_launches_per_captured_step": {
               k: v for k, v in cap1.launches.items() if v}}
    for name, call, n, cap in (("eager", eager, 1, None),
                               ("graph_S1", single, 1, cap1),
                               (f"graph_S{group}", grouped, group, capg)):
        times = step_events_ms(torch, call)
        call_ms = float(np.median(times))
        dev_ms, events, rows, port = profiled_call(
            torch, call, f"{label} {name}", hold=cap is None)
        rec = dict(call_ms=call_ms, step_ms=call_ms / n,
                   step_ms_range=[min(times) / n, max(times) / n],
                   device_ms_per_step=dev_ms / n,
                   device_events_per_step=events / n,
                   port_kernel_launches=port,
                   idle_share=max(0.0, 1.0 - dev_ms / call_ms),
                   graphs_per_s=real_graphs * n / call_ms * 1e3)
        if cap is not None:
            # the graph alone: its replays back to back
            rec["replay_ms_per_step"] = float(np.median(
                step_events_ms(torch, cap.replay))) / n
        if name == "eager":
            rec["scatter_kernels"] = sorted(
                {key[:70] for _, key, _ in rows if any(
                    w in key.lower() for w in ("scatter", "indexfunc",
                                               "index_add", "atomic",
                                               "index_put"))})
        out[name] = rec
        print(f"{label} train step, {name} ({real_graphs} graphs a step): "
              f"{rec['step_ms']:.3f} ms a step (median of 10 calls of "
              f"{n}; {rec['step_ms_range'][0]:.3f}-"
              f"{rec['step_ms_range'][1]:.3f}); one profiled call: device "
              f"{rec['device_ms_per_step']:.3f} ms and "
              f"{rec['device_events_per_step']:.0f} device events a step; "
              f"idle share {rec['idle_share']:.3f}; "
              f"{rec['graphs_per_s']:.1f} graphs/s"
              + (f"; the graph's replay alone {rec['replay_ms_per_step']:.3f}"
                 " ms a step" if cap is not None else "")
              + f"; hand-written kernels in the profile: {port}"
              + (f" (card: {card})" if card else ""), flush=True)
        for dev_t, key, count in sorted(rows, reverse=True)[:6]:
            print(f"  {dev_t / 1e3:8.3f} ms  x{count:<4d} {key[:90]}",
                  flush=True)
    if "bf16" in label:
        out["bf16_casts"] = bf16_cast_cost(torch, model, batches[0])
        print(f"{label}: the forward's float32 -> bf16 casts alone, one "
              f"graph: {out['bf16_casts']}", flush=True)
    print(f"{label}: capture ms {out['capture_ms']} (warm-up runs "
          f"included); port kernel launches in one captured step "
          f"{out['kernel_launches_per_captured_step']}; the graphs' kernel "
          f"nodes (= a replay's launch counts) {graph_nodes}", flush=True)
    return out


def training_phase(torch, label, base_cfg, splits, device, num_epoch,
                   real_graphs, counted):
    """Phases 5b-5c / 6: one configuration trained through run_training.
    The first step (`first_step_gradients`); SGD with momentum (the
    config's widths and learning rate) on the card and on the CPU, every
    epoch's train loss within rtol TRAIN_RTOL and val/test losses within
    EVAL_RTOL (eval-mode batch norm reads running statistics, which carry
    every step's difference). The config's own optimizer on
    the card twice (the main path, counted): bitwise-equal histories and
    parameters; its gap to a CPU run is printed, not held (Adam turns
    gradient noise below its eps into full-size updates). Returns (the
    main run's (state, model, completed config), launches, record)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    cfg = copy.deepcopy(base_cfg)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = num_epoch
    sgd = copy.deepcopy(cfg)
    opt = cfg["NeuralNetwork"]["Training"]["Optimizer"]
    sgd["NeuralNetwork"]["Training"]["Optimizer"] = {
        "type": "SGD", "learning_rate": opt.get("learning_rate", 1e-3)}
    first = first_step_gradients(torch, sgd, splits, device)
    print(f"{label} first step: loss card vs cpu {first['loss_gap']:.3e}; "
          f"largest relative L2 gap of a gradient tensor: kernels vs plain "
          f"versions on the card {first['rel_l2_kernels_plain']:.3e}, card "
          f"vs cpu {first['rel_l2_card_cpu']:.3e}, cpu float32 vs float64 "
          f"{first['rel_l2_cpu_f64']:.3e}; largest entry error kernels vs "
          f"plain {first['kernels_vs_plain']:.3e}, card vs cpu "
          f"{first['card_cpu']:.3e} ({first['outside']} of "
          f"{first['elements']} entries outside {SLICE_TOL}); widest card "
          f"vs cpu gaps: {first['worst_card_cpu']}", flush=True)

    t0 = time.perf_counter()
    _, h_cpu, _, _ = run_training(copy.deepcopy(sgd), datasets=splits,
                                  device="cpu")
    t_cpu = time.perf_counter() - t0
    _, h_card, _, _ = run_training(copy.deepcopy(sgd), datasets=splits,
                                   device=device)
    gaps = history_gaps(h_card, h_cpu)
    print(f"{label} SGD {num_epoch} epochs card vs cpu ({t_cpu:.1f} s on "
          f"the cpu): relative gaps {gaps}; card train {h_card['train_loss']}"
          f" val {h_card['val_loss']} test {h_card['test_loss']}", flush=True)
    for k, v in gaps.items():
        bound = TRAIN_RTOL if k == "train_loss" else EVAL_RTOL
        if not v <= bound:
            fail(f"{label}: SGD {k} card vs cpu gap {v} above {bound}")

    runs = []
    launches = {}
    for i in range(2):
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist, model, completed = run_training(
            copy.deepcopy(cfg), datasets=splits, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i == 0:
            launches = tk.launch_counts()
            counted(launches)
            main = (state, model, completed)
        runs.append((hist, {k: v.detach().cpu().clone()
                            for k, v in state.state_dict().items()}, wall))
    (h0, s0, w0), (h1, s1, w1) = runs
    same = all(h0[k] == h1[k] for k in h0) and all(
        torch.equal(v, s1[k]) for k, v in s0.items())
    print(f"{label} {opt['type']} {num_epoch} epochs on the card twice "
          f"({w0:.1f} s, {w1:.1f} s): histories and parameters bitwise "
          f"equal: {same}; train {h0['train_loss']} val {h0['val_loss']} "
          f"test {h0['test_loss']} lr {h0['lr']}; launches {launches}",
          flush=True)
    if not same:
        fail(f"{label}: two card runs from one seed differ")
    for k in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(h0[k]).all():
            fail(f"{label}: non-finite {k} {h0[k]}")
    if sum(h0["nonfinite_steps"]):
        fail(f"{label}: non-finite steps {h0['nonfinite_steps']}")
    t0 = time.perf_counter()
    _, h_cpu_cfg, _, _ = run_training(copy.deepcopy(cfg), datasets=splits,
                                      device="cpu")
    print(f"{label} {opt['type']} card vs cpu ({time.perf_counter() - t0:.1f}"
          f" s on the cpu), not held: relative gaps "
          f"{history_gaps(h0, h_cpu_cfg)}; cpu train "
          f"{h_cpu_cfg['train_loss']} val {h_cpu_cfg['val_loss']}", flush=True)
    record = dict(first_step=first, sgd_relative_gaps=gaps,
                  config_optimizer_relative_gaps=history_gaps(h0, h_cpu_cfg),
                  bitwise_repeat=same, history=h0)
    return main, launches, record


# ----------------------------------------------------------------- bf16 --

def bf16_ulps(torch, got, want):
    """Largest |got - want| in bf16 ulps of max(|got|, |want|, 2^-10)."""
    g, w = got.float(), want.float()
    scale = torch.maximum(torch.maximum(g.abs(), w.abs()),
                          torch.full_like(g, 2.0 ** -10))
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return float(((g - w).abs() / ulp).max()) if g.numel() else 0.0


def compare_bf16(torch, name, got, want, exact, ulps=1):
    """(bf16 ulps, max abs err) of a bf16 kernel output vs its plain
    version; fails when an exact output differs or a sum lies more than
    `ulps` bf16 ulps away."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        fail(f"{name}: dtypes {got.dtype} / {want.dtype}, expected bf16")
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite kernel output")
    u = bf16_ulps(torch, got, want)
    if exact and not torch.equal(got, want):
        fail(f"{name}: not equal to the plain bf16 version ({u} ulps)")
    if u > ulps:
        fail(f"{name}: {u} bf16 ulps from the plain version (bound {ulps})")
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    return u, err


def bf16_gap(got, ref):
    """max(|got - ref| - (2^-5 + 2^-5 |ref|)): <= 0 within the bf16
    bound."""
    g = np.asarray(got, np.float64)
    r = np.asarray(ref, np.float64)
    return float((np.abs(g - r) - (BF16_BOUND + BF16_BOUND * np.abs(r)))
                 .max())


def check_bf16_kernels(torch, dense_batch, edge_batch, lj_batch, device, f,
                       f_lj):
    """Phase 7a: kernels 2-4 in their bf16 instantiations against their
    plain bf16 versions on the card, at the main paths' shapes: random
    data (min, max, counts and degrees bitwise; sums within one bf16 ulp,
    nbr_aggregate's mean and std, past its sums, within two) and the
    bf16-exact tie-rich dyadic cases (bitwise); each one's call time,
    device time (20 calls in one CUDA graph) and plain version's time
    beside its bf16 byte bound."""
    from hydragnn_tpu_torch.graphs.synthetic import (tie_rich_edge_case,
                                                     tie_rich_neighbor_case)
    from hydragnn_tpu_torch.kernels import fused_mp, nbr

    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device).bfloat16()

    def t(a):
        x = torch.from_numpy(np.asarray(a)).to(device)
        return x.bfloat16() if x.dtype == torch.float32 else x

    records = {}
    # ---- nbr_aggregate, dense layout of the largest serving bucket
    n, k = dense_batch.nbr.shape
    pi, pj = randn(n, f), randn(n, f)
    nb, nm = dense_batch.nbr, dense_batch.nbr_mask
    names = ("mean", "min", "max", "std", "deg")
    res = [compare_bf16(torch, f"nbr_aggregate.bf16.{name}", g, w,
                        exact=name in ("min", "max", "deg"), ulps=2)
           for name, g, w in zip(names, nbr.nbr_aggregate(pi, pj, nb, nm),
                                 nbr.nbr_aggregate_plain(pi, pj, nb, nm))]
    dy = [t(a) for a in tie_rich_neighbor_case(SEED, n=n, k=k, f=f,
                                               bf16_exact=True)]
    for name, g, w in zip(names, nbr.nbr_aggregate(*dy),
                          nbr.nbr_aggregate_plain(*dy)):
        compare_bf16(torch, f"nbr_aggregate.bf16.{name} (dyadic)", g, w,
                     exact=True)
    slots = int(nm.sum())
    ms = cuda_ms(torch, lambda: nbr.nbr_aggregate(pi, pj, nb, nm))
    plain = cuda_ms(torch, lambda: nbr.nbr_aggregate_plain(pi, pj, nb, nm))
    # bf16 projections once, the int32 table and the mask, five bf16
    # outputs
    nbytes = 2 * 2 * n * f + 4 * n * k + n * k + 2 * (4 * n * f + n)
    b_ms, b_by = bound_ms(nbytes, 6 * slots * f + 8 * n * f)
    dev = device_ms(torch, "nbr_aggregate.bf16", nbr.nbr_aggregate,
                    (pi, pj, nb, nm), b_ms)
    records["nbr_aggregate"] = dict(
        N=n, K=k, F=f, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, max_ulps=max(u for u, _ in res),
        max_abs_err=max(e for _, e in res), dyadic_bitwise=True)

    # ---- pna_edge_aggregate, edge list of the engine's largest batch
    n, e = edge_batch.num_nodes, edge_batch.num_edges
    pi, pj = randn(n, f), randn(n, f)
    send, recv, em = (edge_batch.senders, edge_batch.receivers,
                      edge_batch.edge_mask)
    names = ("s", "sq", "cnt", "min", "max")
    res = [compare_bf16(torch, f"pna_edge_aggregate.bf16.{name}", g, w,
                        exact=name in ("cnt", "min", "max"))
           for name, g, w in zip(names, fused_mp.pna_edge_accumulators(
               pi, pj, send, recv, em, n),
               fused_mp.pna_edge_accumulators_plain(pi, pj, send, recv, em,
                                                    n))]
    dy = [t(a) for a in tie_rich_edge_case(SEED, n=n, f=f, bf16_exact=True)]
    for name, g, w in zip(names, fused_mp.pna_edge_accumulators(*dy, n),
                          fused_mp.pna_edge_accumulators_plain(*dy, n)):
        compare_bf16(torch, f"pna_edge_aggregate.bf16.{name} (dyadic)", g,
                     w, exact=True)
    kept = int(em.sum())
    layout = fused_mp.edge_layout(send, recv, em, n)
    ms = cuda_ms(torch, lambda: fused_mp.pna_edge_accumulators(
        pi, pj, send, recv, em, n, layout))
    plain = cuda_ms(torch, lambda: fused_mp.pna_edge_accumulators_plain(
        pi, pj, send, recv, em, n))
    nbytes = 2 * 2 * n * f + 4 * 2 * e + e + 2 * (4 * n * f + n)
    b_ms, b_by = bound_ms(nbytes, 6 * kept * f)
    dev = device_ms(torch, "pna_edge_aggregate.bf16",
                    fused_mp.pna_edge_accumulators,
                    (pi, pj, send, recv, em, n, layout), b_ms)
    rows = fused_mp.forward_geometry(f, 4, torch.bfloat16)
    records["pna_edge_aggregate"] = dict(
        N=n, E=e, F=f, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, max_ulps=max(u for u, _ in res),
        max_abs_err=max(e_ for _, e_ in res), dyadic_bitwise=True,
        forward_rows=rows)
    print(f"pna_edge_aggregate bf16: {dev / b_ms:.2f}x its bound; geometry "
          f"{edge_geometry_name(rows)}", flush=True)

    # ---- filter_scatter and its dh, the EF engine's largest bucket
    n, e, f = lj_batch.num_nodes, lj_batch.num_edges, f_lj
    send, recv, em = lj_batch.senders, lj_batch.receivers, lj_batch.edge_mask
    layout = fused_mp.filter_layouts(send, recv, em, n)
    layout_t = fused_mp.filter_layouts(recv, send, em, n)
    rng = np.random.RandomState(SEED)
    res = []
    for dyadic in (False, True):
        if dyadic:   # multiples of 2^-3 in [-2, 2]: exact products, sums
            h, w, g = (t((rng.randint(-16, 17, s) / 8).astype(np.float32))
                       for s in ((n, f), (e, f), (n, f)))
        else:
            h, w, g = randn(n, f), randn(e, f), randn(n, f)
        pairs = ((fused_mp.filter_scatter(h, w, send, recv, em, n, layout),
                  fused_mp.filter_scatter_plain(h, w, send, recv, em, n)),
                 (fused_mp.filter_scatter(g, w, recv, send, em, n, layout_t),
                  fused_mp.filter_scatter_plain(g, w, recv, send, em, n)))
        for name, (got, want) in zip(("forward", "dh"), pairs):
            res.append(compare_bf16(
                torch, f"filter_scatter.bf16.{name}"
                + (" (dyadic)" if dyadic else ""), got, want, exact=dyadic))
    h, w, g = randn(n, f), randn(e, f), randn(n, f)
    kept = int(em.sum())
    ms = cuda_ms(torch, lambda: fused_mp.filter_scatter(
        h, w, send, recv, em, n, layout))
    plain = cuda_ms(torch, lambda: fused_mp.filter_scatter_plain(
        h, w, send, recv, em, n))
    # h once (L2), the kept edges' w rows, the layout, out: bf16 rows
    nbytes = 2 * (n * f + kept * f + n * f) + 4 * (2 * kept + n + 1)
    b_ms, b_by = bound_ms(nbytes, 2 * kept * f)
    dev = device_ms(torch, "filter_scatter.bf16", fused_mp.filter_scatter,
                    (h, w, send, recv, em, n, layout), b_ms)
    dev_dh = device_ms(torch, "filter_scatter.bf16.dh",
                       fused_mp.filter_scatter,
                       (g, w, recv, send, em, n, layout_t), b_ms)
    records["filter_scatter"] = dict(
        N=n, E=e, F=f, ms=ms, device_ms=dev, backward_device_ms=dev_dh,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        max_ulps=max(u for u, _ in res),
        max_abs_err=max(e_ for _, e_ in res), dyadic_bitwise=True)
    for name, r in records.items():
        shape = " ".join(f"{k}={r[k]}" for k in ("N", "K", "E", "F") if k in r)
        print(f"{name} bf16: {shape} kernel_ms={r['ms']:.4f} "
              f"device_ms(graph)={r['device_ms']:.4f}"
              + (f" dh_device_ms(graph)={r['backward_device_ms']:.4f}"
                 if "backward_device_ms" in r else "")
              + f" plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}); vs plain bf16: max {r['max_ulps']} ulps, "
              f"max abs err {r['max_abs_err']:.3e}; tie-rich dyadic bitwise",
              flush=True)
    return records


def pna_bf16_serving(torch, device, card, base_cfg, splits, variables, mcfg,
                     preds32, counted):
    """Phase 7b: csce PNA served at bf16 (Serving.precision "bf16")
    through run_prediction (dense layout) and an InferenceEngine with
    compute_dtype "bfloat16" (edge list): card vs the CPU's bf16
    run_prediction within 2^-5 on every test graph, the gap to the
    card's float32 predictions printed, batched = single bitwise, the
    futures' parity breadcrumbs, then BF16_BURSTS timed bursts."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import (SERVE_REDUCED_ATOL,
                                                   SERVE_REDUCED_RTOL,
                                                   InferenceEngine)
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    test = splits[2]
    cfg = copy.deepcopy(base_cfg)
    cfg["Serving"] = {"max_batch_size": SERVE_MAX_BATCH, "precision": "bf16"}
    t0 = time.perf_counter()
    _, ref = run_prediction(copy.deepcopy(cfg), splits, variables,
                            serve=False, device="cpu")
    t_cpu = time.perf_counter() - t0
    tk.reset_launch_counts()
    _, got = run_prediction(copy.deepcopy(cfg), splits, variables,
                            serve=True)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    counted(counts)
    for name in ("nbr_aggregate_bf16", "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the bf16 run_prediction path")
    if got[0].shape != (len(test), 1) or not np.isfinite(got[0]).all():
        fail(f"bf16 run_prediction: shape {got[0].shape}")
    gap = bf16_gap(got[0], ref[0])
    if gap > 0:
        fail(f"bf16 run_prediction card vs cpu outside 2^-5 (by {gap})")
    print(f"bf16 run_prediction(serve=True, dense): launches {counts}; card "
          f"vs cpu bf16 ({t_cpu:.1f} s on the cpu) max abs err "
          f"{float(np.abs(got[0] - ref[0]).max()):.3e} (bound 2^-5 + 2^-5 "
          f"|ref|, margin {-gap:.3e}); bf16 vs float32 on the card max abs "
          f"gap {float(np.abs(got[0] - preds32[0]).max()):.3e} (of max "
          f"|pred| {float(np.abs(preds32[0]).max()):.3e})", flush=True)

    model = create_model(mcfg, device=device)
    model.load_state_dict(load_jax_variables(variables))
    engine = InferenceEngine(model, mcfg, reference_samples=test,
                             max_batch_size=SERVE_MAX_BATCH,
                             neighbor_format=False, compute_dtype="bf16",
                             device=device)
    requests = test * ENGINE_REPEATS
    try:
        engine.warmup()
        engine.reset_stats()
        tk.reset_launch_counts()
        futs = [engine.submit(s) for s in requests]
        results = [fut.result(timeout=600) for fut in futs]
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        counted(counts)
        crumbs = all(fut.parity == "tolerance"
                     and fut.parity_rtol == SERVE_REDUCED_RTOL == BF16_BOUND
                     and fut.parity_atol == SERVE_REDUCED_ATOL == BF16_BOUND
                     for fut in futs)
        stats = engine.stats()
        singles = [engine.forward_single(s, bucket=fut.bucket)
                   for s, fut in list(zip(requests, futs))[:8]]
        engine.reset_stats()
        walls = []
        for _ in range(BF16_BURSTS):
            t0 = time.perf_counter()
            for fut in [engine.submit(s) for s in requests]:
                fut.result(timeout=600)
            walls.append(time.perf_counter() - t0)
        timed = engine.stats()
        engine_graphs(torch, engine, requests, "csce PNA bf16 engine")
    finally:
        engine.shutdown()
    for name in ("pna_edge_aggregate_bf16", "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the bf16 engine path")
    if not crumbs or (stats["compute_dtype"], stats["parity"]) != (
            "bfloat16", "tolerance"):
        fail(f"bf16 engine breadcrumbs: futures {crumbs}, stats "
             f"{stats['compute_dtype']} {stats['parity']}")
    bitwise = all(np.array_equal(a, b) for res, single in
                  zip(results[:8], singles) for a, b in zip(res, single))
    if not bitwise:
        fail("bf16 engine: batched outputs differ from the single forward")
    eng = np.stack([r[0] for r in results[:len(test)]])
    gap = bf16_gap(eng, ref[0])
    if not np.isfinite(eng).all() or gap > 0:
        fail(f"bf16 engine card vs cpu outside 2^-5 (by {gap})")
    total = len(requests) * BF16_BURSTS
    print(f"bf16 engine (edge list): launches {counts}; card vs cpu bf16 "
          f"max abs err {float(np.abs(eng - ref[0]).max()):.3e}; batched = "
          f"single bitwise: {bitwise}; breadcrumbs parity "
          f"{stats['parity']} rtol/atol 2^-5, stats compute_dtype "
          f"{stats['compute_dtype']}; {total} requests in {BF16_BURSTS} "
          f"bursts, {sum(walls):.4f} s: {total / sum(walls):.1f} requests/s;"
          f" p50 {timed['p50_ms']:.3f} ms, p99 {timed['p99_ms']:.3f} ms "
          f"(card: {card})", flush=True)
    return dict(rate=total / sum(walls), p50_ms=timed["p50_ms"],
                p99_ms=timed["p99_ms"])


def bf16_module_gaps(torch, lj, device):
    """Where bf16 LJ outputs part between the CPU and the card: every
    module's output (a forward hook on each) from the frozen bf16
    forward of the burst's first batch on both devices, printed (max
    |x|, max gap, the share of real elements that differ). The first
    module whose outputs differ in many elements names the op that
    rounds differently. Called before a bf16 LJ check fails."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import train_step as tstep
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    batch = lj["batch"].to("cpu")
    real = batch.node_mask
    outs = {}
    for dev in ("cpu", device):
        model = create_model(lj["mcfg"], device=dev)
        model.load_state_dict(load_jax_variables(lj["variables"]))
        rec = outs[str(dev)] = {}

        def hook(name, rec=rec):
            def record(mod, inp, res):
                res = res[0] if isinstance(res, (tuple, list)) else res
                if torch.is_tensor(res):
                    rec[name] = res.detach().float().cpu()
            return record
        handles = [m.register_forward_hook(hook(n))
                   for n, m in model.named_modules() if n]
        with torch.no_grad():
            tstep.make_forward_fn(model, lj["mcfg"], "bfloat16",
                                  frozen=True)(batch.to(dev))
        for h in handles:
            h.remove()
    print("bf16 module outputs, card vs cpu (real rows):", flush=True)
    for name, x in outs["cpu"].items():
        y = outs[str(device)][name]
        if x.shape[:1] == real.shape:
            x, y = x[real], y[real]
        d = y - x
        print(f"  {name:36s} max |x| {float(x.abs().max()):.3e} max gap "
              f"{float(d.abs().max()):.3e} differing "
              f"{float((d != 0).float().mean()):.4f}", flush=True)


def lj_bf16_serving(torch, device, lj, counted):
    """Phase 7c: LJ SchNet energies and forces from a bf16 EF engine,
    card vs the same engine on the CPU, within 2^-5: the card's burst
    (each test cell's first response) against the CPU's single forward
    on the bucket the burst served it on, and each test cell served
    alone on the smallest bucket on both devices; the card's batched
    burst = single bitwise. The margin of the bound is printed, and the
    bf16-vs-float32 gap."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.utils.weights import load_jax_variables

    def engine_on(dev):
        model = create_model(lj["mcfg"], device=dev)
        model.load_state_dict(load_jax_variables(lj["variables"]))
        return InferenceEngine(model, lj["mcfg"],
                               reference_samples=lj["test"],
                               max_batch_size=SERVE_MAX_BATCH,
                               neighbor_format=False, ef_forward=True,
                               compute_dtype="bf16", device=dev)

    test, requests = lj["test"], lj["requests"]
    engine = engine_on(device)
    try:
        engine.warmup()
        tk.reset_launch_counts()
        futs = [engine.submit(s) for s in requests]
        results = [fut.result(timeout=600) for fut in futs]
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        counted(counts)
        batched = [engine.forward_single(s, bucket=fut.bucket)
                   for s, fut in list(zip(requests, futs))[:8]]
        singles = [engine.forward_single(s) for s in test]
        engine_graphs(torch, engine, requests, "LJ EF bf16 engine")
    finally:
        engine.shutdown()
    t0 = time.perf_counter()
    with engine_on("cpu") as cpu_engine:
        want = [cpu_engine.forward_single(s) for s in test]
        want_burst = [cpu_engine.forward_single(s, bucket=fut.bucket)
                      for s, fut in zip(test, futs)]
    t_cpu = time.perf_counter() - t0
    for name in ("filter_scatter_bf16", "filter_scatter_backward_bf16",
                 "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the bf16 EF engine path")
    gaps, bad = {}, []
    for i, name in enumerate(("energies", "forces")):
        def flat(rs):
            return np.concatenate([r[i].reshape(-1) for r in rs])
        r32 = flat(lj["want"])
        for key, got, ref in (("burst", flat(results[:len(test)]),
                               flat(want_burst)),
                              ("alone", flat(singles), flat(want))):
            gap = bf16_gap(got, ref)
            gaps[f"{name}_{key}"] = dict(
                max_abs_err=float(np.abs(got - ref).max()), margin=-gap,
                of_bound=float((np.abs(got - ref) / (
                    BF16_BOUND + BF16_BOUND * np.abs(ref))).max()))
            if not np.isfinite(got).all() or gap > 0:
                bad.append(f"bf16 EF {name} ({key}) card vs cpu outside 2^-5"
                           f" (by {gap})")
        gaps[f"{name}_vs_float32"] = (float(np.abs(flat(singles) - r32)
                                            .max()), float(np.abs(r32).max()))
    bitwise = all(np.array_equal(a, b) for res, single in
                  zip(results[:8], batched) for a, b in zip(res, single))
    print(f"bf16 EF engine (edge list): launches {counts}; card vs cpu bf16 "
          f"({t_cpu:.1f} s on the cpu), the burst against the cpu on the "
          f"burst's buckets and each cell alone on the smallest bucket (max "
          f"abs err, margin to 2^-5 + 2^-5 |ref|, largest share of the "
          f"bound used): {json.dumps(gaps)}; batched = single bitwise: "
          f"{bitwise}", flush=True)
    if bad:
        bf16_module_gaps(torch, lj, device)
        fail("; ".join(bad))
    if not bitwise:
        fail("bf16 EF engine: batched outputs differ from the single forward")
    return gaps


@contextlib.contextmanager
def filter_dh_cut():
    """The control that the LJ gradient check must catch: filter_scatter's
    dh detached from the graph of the force loss, as a backward that
    lost its own gradient would leave it (the forces keep their values;
    the force loss's weight gradients lose every term through dh)."""
    from hydragnn_tpu_torch.kernels import fused_mp
    cls = fused_mp._FilterScatter
    orig = cls.backward

    def backward(ctx, g):
        dh, *rest = orig(ctx, g)
        return (None if dh is None else dh.detach(), *rest)
    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = staticmethod(orig)


def permute_edges(torch, batch, seed):
    """The batch with its edge list in another (seeded) order: the same
    graph, whose sums add their terms in another order."""
    p = torch.randperm(batch.num_edges,
                       generator=torch.Generator().manual_seed(seed))
    p = p.to(batch.senders.device)
    return batch.replace(**{k: getattr(batch, k)[p] for k in (
        "senders", "receivers", "edge_mask", "edge_attr", "edge_shifts")
        if getattr(batch, k) is not None})


def lj_bf16_gradients(torch, cfg, splits, card):
    """Phase 7e: the first LJ EF training batch's weight gradients at
    bf16 from one seeded initialization; the force loss runs a second
    backward through the bf16 filter_scatter, its dh and the gathers.
    Gaps are relative L2, of the worst tensor and of all tensors as one
    vector, over the tensors whose float32 gradient on the CPU is within
    2^-5 of float64's (the rest are 0 but for rounding). Held: the
    kernels vs the plain versions on the card within LJ_GRAD_BOUND and
    LJ_GRAD_BOUND_ALL, and the control (`filter_dh_cut`) above both,
    so that the check can fail. Printed:
    the noise floors (the plain versions vs themselves on the edges in
    another order: one on the card, LJ_FLOOR_ORDERS on the CPU, their
    largest gap and range), card vs CPU through the
    kernels and through the plain versions (the witness that the card's
    gap to the CPU is rounding, not the kernels), each run vs float64."""
    from hydragnn_tpu_torch.train import train_step as tstep
    f32 = copy.deepcopy(cfg)
    f32["NeuralNetwork"]["Architecture"]["dtype"] = "float32"
    runs = {}
    orders = [f"cpu_perm{k}" for k in range(LJ_FLOOR_ORDERS)]
    for tag, dev, ctx, perm in (
            ("card", card, contextlib.nullcontext, None),
            ("card_plain", card, plain_versions, None),
            ("card_plain_perm", card, plain_versions, SEED + 1),
            ("control", card, filter_dh_cut, None),
            ("cpu", "cpu", contextlib.nullcontext, None),
            *[(t, "cpu", contextlib.nullcontext, SEED + 1 + k)
              for k, t in enumerate(orders)],
            ("cpu32", "cpu", contextlib.nullcontext, None),
            ("cpu64", "cpu", contextlib.nullcontext, None)):
        model, _, _, loader, cfg_c, mcfg = train_parts(
            torch, f32 if tag in ("cpu32", "cpu64") else cfg, splits, dev)
        tr = cfg_c["NeuralNetwork"]["Training"]
        loader.set_epoch(0)
        batch = next(iter(loader)).to(dev)
        if tag == "cpu64":
            model.to(torch.float64)
            batch = tstep.cast_floats(batch, torch.float64)
        if perm is not None:
            batch = permute_edges(torch, batch, perm)
        model.train()
        with ctx():
            total, _ = tstep.make_loss_fn(
                model, mcfg, tr.get("loss_function_type", "mse"),
                compute_grad_energy=True)(batch)
            grads = torch.autograd.grad(total, list(model.parameters()),
                                        allow_unused=True,
                                        materialize_grads=True)
        runs[tag] = [g.detach().cpu().double() for g in grads]
    names = [k for k, _ in model.named_parameters()]

    def rel(a, b, i):
        return float((runs[a][i] - runs[b][i]).norm()) / max(
            float(runs[b][i].norm()), 1e-30)
    # a tensor whose float32 gradient misses float64 by more than 2^-5
    # (a bias ahead of a batch norm: 0 but for rounding) is left out
    kept = [i for i in range(len(names)) if rel("cpu32", "cpu64", i)
            <= BF16_BOUND]

    pairs = {"kernels_vs_plain": ("card", "card_plain"),
             "control_vs_plain": ("control", "card_plain"),
             "floor_card": ("card_plain_perm", "card_plain"),
             **{t: (t, "cpu") for t in orders},
             "card_vs_cpu": ("card", "cpu"),
             "card_plain_vs_cpu": ("card_plain", "cpu"),
             "card_vs_f64": ("card", "cpu64"),
             "cpu_vs_f64": ("cpu", "cpu64"),
             "cpu32_vs_f64": ("cpu32", "cpu64")}
    per = {k: [rel(a, b, i) for i in kept] for k, (a, b) in pairs.items()}
    together = {k: float(np.sqrt(sum(
        float((runs[a][i] - runs[b][i]).norm()) ** 2 for i in kept) / sum(
        float(runs[b][i].norm()) ** 2 for i in kept)))
        for k, (a, b) in pairs.items()}
    # the CPU's floor: the largest over the edge orders, and their range
    floor_range = [min(max(per[t]) for t in orders),
                   max(max(per[t]) for t in orders),
                   min(together[t] for t in orders),
                   max(together[t] for t in orders)]
    per["floor_cpu"] = [max(v) for v in zip(*(per.pop(t) for t in orders))]
    together["floor_cpu"] = max(together.pop(t) for t in orders)
    rec = {k: max(zip(v, (names[i] for i in kept))) for k, v in per.items()}
    print(f"LJ SchNet EF bf16 first step, weight gradients: worst relative "
          f"L2 gap over {len(kept)} of {len(names)} tensors (the rest are 0"
          f" but for rounding): "
          + "; ".join(f"{k} {v[0]:.4e} ({v[1]})" for k, v in rec.items())
          + f"; bound {LJ_GRAD_BOUND}; all kept tensors as one vector "
          f"(bound {LJ_GRAD_BOUND_ALL}): "
          + json.dumps({k: float(f"{v:.4e}") for k, v in together.items()})
          + f"; the CPU's floor over {LJ_FLOOR_ORDERS} edge orders: worst "
          f"tensor {floor_range[0]:.4e}-{floor_range[1]:.4e}, all "
          f"{floor_range[2]:.4e}-{floor_range[3]:.4e}", flush=True)
    print("  per tensor (" + ", ".join(per) + "): " + json.dumps(
        {names[i]: [float(f"{v[j]:.4e}") for v in per.values()]
         for j, i in enumerate(kept)}), flush=True)
    if not (rec["kernels_vs_plain"][0] <= LJ_GRAD_BOUND
            and together["kernels_vs_plain"] <= LJ_GRAD_BOUND_ALL):
        fail(f"LJ bf16 first-step gradients, kernels vs plain versions on "
             f"the card: worst tensor {rec['kernels_vs_plain']} (bound "
             f"{LJ_GRAD_BOUND}), all {together['kernels_vs_plain']} (bound "
             f"{LJ_GRAD_BOUND_ALL})")
    if not (rec["control_vs_plain"][0] > LJ_GRAD_BOUND
            and together["control_vs_plain"] > LJ_GRAD_BOUND_ALL):
        fail(f"LJ bf16 first-step gradients: the control (dh cut from the "
             f"force loss) lies within a bound ({rec['control_vs_plain']}, "
             f"all {together['control_vs_plain']}): the check cannot fail")
    return dict(worst={k: v[0] for k, v in rec.items()},
                together=together, floor_cpu_range=floor_range)


def lj_sgd_steps(torch, cfg, splits, card):
    """Phase 7e: LJ_SGD_STEPS SGD steps (the config's learning rate) of
    the LJ EF training step from one seeded initialization, at bf16 on
    the card through the kernels and through the plain versions and on
    the CPU, and at float32 on the card and the CPU: each step's loss,
    relative gap to the CPU's at the same precision. Held: the first
    LJ_SGD_HELD steps through the kernels within 2^-5; the rest printed,
    with the plain versions' gaps beside them."""
    from hydragnn_tpu_torch.train import train_step as tstep
    lr = cfg["NeuralNetwork"]["Training"]["Optimizer"].get("learning_rate",
                                                          1e-3)
    losses = {}
    for tag, dev, dtype, ctx in (
            ("card", card, "bfloat16", contextlib.nullcontext),
            ("card_plain", card, "bfloat16", plain_versions),
            ("cpu", "cpu", "bfloat16", contextlib.nullcontext),
            ("card32", card, "float32", contextlib.nullcontext),
            ("cpu32", "cpu", "float32", contextlib.nullcontext)):
        c = copy.deepcopy(cfg)
        c["NeuralNetwork"]["Architecture"]["dtype"] = dtype
        c["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "SGD",
                                                       "learning_rate": lr}
        _, state, step, loader, _, _ = train_parts(torch, c, splits, dev)
        loader.set_epoch(0)
        losses[tag] = []
        with ctx():
            for b, _ in zip(loader, range(LJ_SGD_STEPS)):
                state, met = step(state, b.to(dev))
                losses[tag].append(float(met["loss"]))

    def gaps(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(losses[a], losses[b])]
    rec = dict(bf16=gaps("card", "cpu"), bf16_plain=gaps("card_plain", "cpu"),
               float32=gaps("card32", "cpu32"), losses_cpu=losses["cpu"])
    print(f"LJ SchNet EF SGD, {LJ_SGD_STEPS} steps, per-step loss relative "
          f"gap card vs cpu: bf16 through the kernels "
          f"{[f'{g:.2e}' for g in rec['bf16']]}; bf16 through the plain "
          f"versions {[f'{g:.2e}' for g in rec['bf16_plain']]}; float32 "
          f"{[f'{g:.2e}' for g in rec['float32']]}; held: the first "
          f"{LJ_SGD_HELD} bf16 steps within 2^-5", flush=True)
    for i, g in enumerate(rec["bf16"][:LJ_SGD_HELD]):
        if not g <= BF16_BOUND:
            fail(f"LJ bf16 SGD step {i}: loss card vs cpu gap {g} above "
                 "2^-5")
    return rec


def bf16_training_phase(torch, label, base_cfg, splits, device, num_epoch,
                        counted, required, hold_history=True):
    """Phase 7d: one configuration trained at Architecture.dtype
    "bfloat16" through run_training: the first step's loss card vs CPU
    within 2^-5 relative; SGD on the card and on the CPU, every epoch's
    losses within 2^-5 relative (printed only when not `hold_history`:
    the LJ force loss's bf16 weight gradients carry rounding noise of up
    to ~15 % a tensor that follows the summation order on either device,
    and SGD runs part within a few steps, the plain versions on the card
    as fast as the kernels: `lj_bf16_gradients` and `lj_sgd_steps` hold
    LJ instead); the config's optimizer on the card
    twice (counted), histories and parameters bitwise equal,
    nonfinite_steps 0, every parameter and buffer float32."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.train import train_step as tstep
    cfg = copy.deepcopy(base_cfg)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = num_epoch
    cfg["NeuralNetwork"]["Architecture"]["dtype"] = "bfloat16"
    sgd = copy.deepcopy(cfg)
    opt = cfg["NeuralNetwork"]["Training"]["Optimizer"]
    sgd["NeuralNetwork"]["Training"]["Optimizer"] = {
        "type": "SGD", "learning_rate": opt.get("learning_rate", 1e-3)}
    first = {}
    for dev in ("cpu", device):
        model, _, _, loader, cfg_c, mcfg = train_parts(torch, sgd, splits,
                                                       dev)
        tr = cfg_c["NeuralNetwork"]["Training"]
        loader.set_epoch(0)
        model.train()
        loss, _ = tstep.make_loss_fn(
            model, mcfg, tr.get("loss_function_type", "mse"),
            compute_grad_energy=bool(tr.get("compute_grad_energy")))(
                next(iter(loader)).to(dev))
        first[str(dev)] = float(loss.detach())
    first_gap = abs(first[str(device)] - first["cpu"]) / abs(first["cpu"])
    if not first_gap <= BF16_BOUND:
        fail(f"{label} bf16: first step loss card vs cpu gap {first_gap}")
    t0 = time.perf_counter()
    _, h_cpu, _, _ = run_training(copy.deepcopy(sgd), splits, device="cpu")
    t_cpu = time.perf_counter() - t0
    _, h_card, _, _ = run_training(copy.deepcopy(sgd), splits, device=device)
    gaps = history_gaps(h_card, h_cpu)
    print(f"{label} bf16: first step loss card vs cpu {first_gap:.3e} "
          f"relative; SGD {num_epoch} epochs card vs cpu ({t_cpu:.1f} s on "
          f"the cpu): relative gaps {gaps} ("
          + ("held" if hold_history else "printed, not held")
          + f"); card train {h_card['train_loss']} val {h_card['val_loss']}"
          f"; cpu train {h_cpu['train_loss']} val {h_cpu['val_loss']}",
          flush=True)
    for k, v in gaps.items():
        if hold_history and not v <= BF16_BOUND:
            fail(f"{label} bf16: SGD {k} card vs cpu gap {v} above 2^-5")
    runs = []
    for i in range(2):
        tk.reset_launch_counts()
        state, hist, _, _ = run_training(copy.deepcopy(cfg), splits,
                                         device=device)
        torch.cuda.synchronize()
        if i == 0:
            counts = tk.launch_counts()
            counted(counts)
        runs.append((hist, {k: v.detach().cpu().clone()
                            for k, v in state.state_dict().items()}))
    (h0, s0), (h1, s1) = runs
    same = all(h0[k] == h1[k] for k in h0) and all(
        torch.equal(v, s1[k]) for k, v in s0.items())
    masters = all(v.dtype == torch.float32 for v in s0.values())
    print(f"{label} bf16 {opt['type']} {num_epoch} epochs on the card twice:"
          f" bitwise equal: {same}; float32 masters: {masters}; nonfinite "
          f"steps {h0['nonfinite_steps']}; train {h0['train_loss']} val "
          f"{h0['val_loss']}; launches {counts}", flush=True)
    if not same:
        fail(f"{label} bf16: two card runs from one seed differ")
    if not masters or sum(h0["nonfinite_steps"]) \
            or not np.isfinite(h0["train_loss"]).all():
        fail(f"{label} bf16: masters {masters}, nonfinite steps "
             f"{h0['nonfinite_steps']}, train {h0['train_loss']}")
    for name in required:
        if counts[name] == 0:
            fail(f"{name} never launched on the {label} bf16 training path")
    return dict(first_step_loss_gap=first_gap, sgd_relative_gaps=gaps,
                sgd_history_held=hold_history, bitwise_repeat=same,
                launches=counts)


def resume_phase(torch, device, base_cfg, splits, counted):
    """Phase 8: csce PNA at full width with Checkpoint and
    checkpoint_every_n_epochs 1, sent a real SIGTERM from a thread once
    its first COMMITTED step directory exists, resumed with `continue: 1`:
    its train/val/test/lr history and final parameters must equal an
    uninterrupted run's bitwise, and run_prediction from the BEST
    checkpoint the in-memory state's predictions; at float32 and bf16.
    The process's SIGTERM disposition meanwhile only sets the preemption
    flag, so a signal that came late could not kill the run."""
    import glob
    import os
    import shutil
    import signal
    import threading

    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.train import trainer
    keys = ("train_loss", "val_loss", "test_loss", "lr")
    record = {}
    prev = signal.signal(signal.SIGTERM,
                         lambda signum, frame: trainer.request_preemption())
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = copy.deepcopy(base_cfg)
            cfg["NeuralNetwork"]["Architecture"]["dtype"] = dtype
            cfg["Dataset"] = {"name": f"chip_smoke_resume_{dtype}"}
            tr = cfg["NeuralNetwork"]["Training"]
            epochs = int(tr["num_epoch"])
            run_dir = os.path.join("logs", get_log_name_config(cfg))
            shutil.rmtree(run_dir, ignore_errors=True)
            twin, h_twin, _, _ = run_training(copy.deepcopy(cfg), splits,
                                              device=device)
            twin = {k: v.detach().cpu().clone()
                    for k, v in twin.state_dict().items()}
            tr.update(Checkpoint=True, checkpoint_every_n_epochs=1)
            pattern = os.path.join(run_dir, "checkpoint", "step_*",
                                   "COMMITTED")

            def kill():
                while not glob.glob(pattern):
                    time.sleep(0.001)
                os.kill(os.getpid(), signal.SIGTERM)
            killer = threading.Thread(target=kill, daemon=True)
            trainer.clear_preemption()
            killer.start()
            _, h_cut, _, _ = run_training(copy.deepcopy(cfg), splits,
                                          device=device)
            killer.join(timeout=60)
            cut = len(h_cut["train_loss"])
            if not trainer.preemption_requested() or cut >= epochs:
                fail(f"resume {dtype}: the SIGTERM did not cut the run "
                     f"({cut} of {epochs} epochs)")
            trainer.clear_preemption()
            saved = sorted(os.listdir(os.path.join(run_dir, "checkpoint")))
            tr["continue"] = 1
            tk.reset_launch_counts()
            state, h_res, model, completed = run_training(
                copy.deepcopy(cfg), splits, device=device)
            torch.cuda.synchronize()
            counted(tk.launch_counts())
            same_h = all(h_res[k] == h_twin[k] for k in keys)
            same_p = all(torch.equal(v, state.state_dict()[k].cpu())
                         for k, v in twin.items())
            _, mem = run_prediction(completed, splits, state=state,
                                    model=model)
            _, best = run_prediction(completed, splits, checkpoint="best")
            same_pred = bool(np.array_equal(mem[0], best[0]))
            print(f"resume {dtype}: SIGTERM after the first commit cut the "
                  f"run at {cut} of {epochs} epochs (saved: {saved}); "
                  f"resumed history bitwise equal: {same_h}; parameters "
                  f"bitwise equal: {same_p}; run_prediction from BEST = "
                  f"in-memory, bitwise: {same_pred}; train "
                  f"{h_res['train_loss']}", flush=True)
            if not (same_h and same_p and same_pred):
                fail(f"resume {dtype}: not bitwise equal to the "
                     "uninterrupted run")
            record[dtype] = dict(cut_after_epochs=cut, history_bitwise=same_h,
                                 params_bitwise=same_p,
                                 prediction_bitwise=same_pred)
            shutil.rmtree(run_dir, ignore_errors=True)
    finally:
        signal.signal(signal.SIGTERM, prev)
        trainer.clear_preemption()
    return record


# ---------------------------------------------- packing, edge features --

EAM_CONFIG = "examples/eam/NiNb_EAM_energy.json"
NUM_NINB = 512                 # NiNb cells of 32 atoms (CFG files)
EAM_EPOCHS = 3                 # NiNb_EAM_energy.json trains 50; cut for time
# the eam SGD histories, card against CPU, may part by at most this many
# times the widest gap of two float32 CPU runs of the same configuration
# in other orders (each layout at half the threads, and the two layouts)
HISTORY_FLOOR_TIMES = 2.0
PACK_EPOCHS = 3


def loader_shape(loader):
    """What a loader's epoch 0 looks like: its batch shape, steps and
    padding (and, packed, its plan's fingerprint)."""
    loader.set_epoch(0)
    out = dict(n_node=loader.n_node, n_edge=loader.n_edge,
               n_graph=loader.n_graph, steps=len(loader),
               **{k: v for k, v in loader.padding_stats().items()})
    if loader.packing:
        out["plan_fp"] = loader.global_plan_fingerprint()
        out["lookahead"] = loader.pack_budget.lookahead
    return out


def packing_phase(torch, base_cfg, splits, device, batch_size, counted,
                  fixed_paths):
    """Phase 9: csce PNA trained packed through run_training on both
    layouts (the main path, counted). Held: every kernel of the path
    launched, no CUDA graph captured after epoch 0, finite losses, and
    (step_metrics) the captured packed steps equal to their eager bodies
    bitwise. Printed: both budgets, padding, steps an epoch, plan_fp,
    and the packed step's numbers beside phase 5's fixed-shape ones."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    out = {}
    for label, dense, kernels in (
            ("dense", True, ("nbr_aggregate", "nbr_aggregate_backward",
                             "segment_sum")),
            ("edge", False, ("pna_edge_aggregate",
                             "pna_edge_aggregate_backward", "segment_sum"))):
        cfg = copy.deepcopy(base_cfg)
        cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
        tr = cfg["NeuralNetwork"]["Training"]
        tr.update(batch_packing=True, num_epoch=PACK_EPOCHS)
        shapes = {mode: loader_shape(create_dataloaders(
            *splits, batch_size, neighbor_format=dense,
            packing=mode == "packed")[0]) for mode in ("fixed", "packed")}
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        _, hist, _, _ = run_training(copy.deepcopy(cfg), datasets=splits,
                                     device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tk.launch_counts()
        counted(counts)
        name = f"csce PNA packed ({'dense' if dense else 'edge list'})"
        print(f"{name}: budgets fixed {shapes['fixed']} packed "
              f"{shapes['packed']}; {PACK_EPOCHS} epochs in {wall:.2f} s: "
              f"train {hist['train_loss']} val {hist['val_loss']}; padding "
              f"nodes {hist['padding_frac_nodes']} edges "
              f"{hist['padding_frac_edges']}; CUDA graphs captured an epoch "
              f"{hist['graph_captures']}; launches {counts}", flush=True)
        for k in kernels:
            if counts[k] == 0:
                fail(f"{k} never launched on the packed {label} path")
        if any(hist["graph_captures"][1:]) or not hist["graph_captures"][0]:
            fail(f"{name}: CUDA graphs captured an epoch "
                 f"{hist['graph_captures']} (some after epoch 0)")
        if not np.isfinite(hist["train_loss"] + hist["val_loss"]).all():
            fail(f"{name}: non-finite losses")
        rec = step_metrics(torch, cfg, splits, device, name, None, CSCE_GROUP)
        fixed = fixed_paths[f"csce_pna_{label}"]["graph_S1"]
        packed = rec["graph_S1"]

        def per_graph(r):
            """Device ms per real graph: device ms a step over the real
            graphs a step (graphs/s times the step time)."""
            return r["device_ms_per_step"] / (r["graphs_per_s"]
                                              * r["step_ms"] / 1e3)
        rec["device_ms_per_real_graph"] = {"packed": per_graph(packed),
                                           "fixed": per_graph(fixed)}
        print(f"{name} vs fixed, captured S = 1: step "
              f"{packed['step_ms']:.3f} vs {fixed['step_ms']:.3f} ms, device "
              f"{packed['device_ms_per_step']:.3f} vs "
              f"{fixed['device_ms_per_step']:.3f} ms, idle "
              f"{packed['idle_share']:.3f} vs {fixed['idle_share']:.3f}, "
              f"{packed['graphs_per_s']:.1f} vs {fixed['graphs_per_s']:.1f} "
              f"real graphs/s; steps an epoch {shapes['packed']['steps']} vs "
              f"{shapes['fixed']['steps']}; device ms per real graph "
              f"{per_graph(packed):.5f} vs {per_graph(fixed):.5f}",
              flush=True)
        rec["run"] = dict(history=hist, wall_s=wall, loaders=shapes,
                          launches=counts)
        out[f"csce_pna_{label}_packed"] = rec
    return out


def hold_sgd_histories(runs):
    """Phase 10's SGD histories: for each split, the card's relative gap
    to the CPU on each layout may be at most HISTORY_FLOOR_TIMES times
    the widest gap of two float32 CPU runs of the configuration (each
    layout against itself at half its threads, and the two layouts
    against each other). This configuration's float32 gradients are a few
    percent off float64 on any device, so no pair of float32 runs agrees
    to the 1e-3 of the other paths; a card fault that drifts training
    parts by more than float32 order does."""
    cross = history_gaps(runs["edge"]["cpu"], runs["dense"]["cpu"])
    floor = {k: max(cross[k], *(r["half_threads"][k] for r in runs.values()))
             for k in cross}
    bound = {k: HISTORY_FLOOR_TIMES * v for k, v in floor.items()}
    card = {label: r["card"] for label, r in runs.items()}
    print(f"eam SGD histories, card vs cpu {card}; float32 floor {floor} "
          f"(the two layouts on the cpu: {cross}); held at "
          f"{HISTORY_FLOOR_TIMES} x the floor: {bound}", flush=True)
    for label, r in runs.items():
        for k, gap in r["card"].items():
            if not gap <= bound[k]:
                fail(f"eam PNA lengths ({label}): SGD {k} card vs cpu "
                     f"{gap:.4f} beyond {HISTORY_FLOOR_TIMES} x the float32 "
                     f"floor {floor[k]:.4f}")
    return floor, bound


def eam_phase(torch, device, counted, packed_batch):
    """Phase 10: NiNb_EAM_energy.json (PNA with edge lengths) at its
    published width from its own CFG files. Returns (per-path records,
    segment_sum shape records)."""
    import os
    import tempfile

    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.graphs.synthetic import ninb_cfg_files
    from hydragnn_tpu_torch.preprocess.load_data import (
        create_dataloaders, load_datasets_from_config)
    with open(EAM_CONFIG) as fh:
        base = json.load(fh)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ninb_")
    try:
        t0 = time.perf_counter()
        ninb_cfg_files(os.path.join(tmp, "NiNb_solid_solution"), NUM_NINB,
                       seed=SEED)
        base["Dataset"]["path"]["total"] = os.path.join(
            tmp, "NiNb_solid_solution")
        # plots are ROADMAP A10, which run_training refuses; the run is cut
        # to EAM_EPOCHS of the config's epochs
        base["Visualization"]["create_plots"] = False
        base["Verbosity"]["level"] = 0
        published = base["NeuralNetwork"]["Training"]["num_epoch"]
        base["NeuralNetwork"]["Training"]["num_epoch"] = EAM_EPOCHS
        splits = load_datasets_from_config(base)
        arch = base["NeuralNetwork"]["Architecture"]
        bs = int(base["NeuralNetwork"]["Training"]["batch_size"])
        print(f"phase 10: {EAM_CONFIG} (PNA hidden {arch['hidden_dim']}, "
              f"{arch['num_conv_layers']} layers, edge_features "
              f"{arch['edge_features']}, radius {arch['radius']} periodic, "
              f"batch {bs}; {EAM_EPOCHS} of {published} epochs, plots off) "
              f"on {NUM_NINB} NiNb cells of {splits[0][0].num_nodes} atoms "
              f"as CFG files ({time.perf_counter() - t0:.1f} s to write and "
              f"read); splits {[len(s) for s in splits]}", flush=True)
        out, shapes, sgd_runs = {}, [], {}
        for label, dense in (("dense", True), ("edge", False)):
            cfg = copy.deepcopy(base)
            cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
            name = f"eam PNA lengths ({'dense' if dense else 'edge list'})"
            tk.reset_launch_counts()
            t0 = time.perf_counter()
            state, hist, model, done = run_training(copy.deepcopy(cfg),
                                                    device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = tk.launch_counts()
            counted(counts)
            print(f"{name}: run_training(datasets=None) {EAM_EPOCHS} epochs "
                  f"(AdamW) in {wall:.2f} s: train {hist['train_loss']} val "
                  f"{hist['val_loss']}; CUDA graphs an epoch "
                  f"{hist['graph_captures']}; launches {counts}", flush=True)
            if counts["segment_sum"] == 0:
                fail(f"segment_sum never launched on the {name} path")
            for k in ("nbr_aggregate", "pna_edge_aggregate"):
                if counts[k]:
                    fail(f"{name}: {k} launched; edge features route "
                         "unfused, as in the JAX package")
            if not np.isfinite(hist["train_loss"] + hist["val_loss"]).all():
                fail(f"{name}: non-finite losses")
            voi = done["NeuralNetwork"]["Variables_of_interest"]
            if voi.get("denormalize_output") or "y_minmax" in voi:
                fail(f"{name}: the reader's min-max reached the completed "
                     "config (the JAX package completes it from plain "
                     "lists, denormalization off)")
            # the main path again: two card runs from one seed, bitwise
            state2, hist2, _, _ = run_training(copy.deepcopy(cfg),
                                               device=device)
            same = all(hist[k] == hist2[k] for k in hist) and all(
                torch.equal(v, state2.state_dict()[k])
                for k, v in state.state_dict().items())
            if not same:
                fail(f"{name}: two card runs from one seed differ")
            sgd = copy.deepcopy(cfg)
            sgd["NeuralNetwork"]["Training"]["Optimizer"] = {
                "type": "SGD", "learning_rate": base["NeuralNetwork"][
                    "Training"]["Optimizer"]["learning_rate"]}
            first = first_step_gradients(torch, sgd, splits, device)
            t0 = time.perf_counter()
            _, h_cpu, _, _ = run_training(copy.deepcopy(sgd), device="cpu")
            t_cpu = time.perf_counter() - t0
            _, h_card, _, _ = run_training(copy.deepcopy(sgd), device=device)
            gaps = history_gaps(h_card, h_cpu)
            # the CPU against itself at half its threads (other GEMM and
            # reduction orders): how far two float32 runs of this
            # configuration part
            threads = torch.get_num_threads()
            torch.set_num_threads(max(1, threads // 2))
            try:
                _, h_half, _, _ = run_training(copy.deepcopy(sgd),
                                               device="cpu")
            finally:
                torch.set_num_threads(threads)
            floor = history_gaps(h_half, h_cpu)
            sgd_runs[label] = dict(card=gaps, half_threads=floor, cpu=h_cpu)
            print(f"{name} first step: loss card vs cpu "
                  f"{first['loss_gap']:.3e}; gradients kernels vs plain "
                  f"{first['rel_l2_kernels_plain']:.3e}, card vs cpu "
                  f"{first['rel_l2_card_cpu']:.3e}, cpu float32 vs float64 "
                  f"{first['rel_l2_cpu_f64']:.3e} (relative L2, worst "
                  f"tensor; as one vector: kernels vs plain "
                  f"{first['rel_l2_kernels_plain_all']:.3e}, cpu float32 vs "
                  f"float64 {first['rel_l2_cpu_f64_all']:.3e}; widest card "
                  f"vs cpu: {first['worst_card_cpu']}); "
                  f"two card runs bitwise: {same}; SGD {EAM_EPOCHS} epochs "
                  f"card vs cpu ({t_cpu:.1f} s on the cpu): relative gaps "
                  f"{gaps}; the cpu at half its threads vs the cpu: "
                  f"{floor}", flush=True)
            trues, preds = run_prediction(copy.deepcopy(cfg), state=state,
                                          model=model, device=device)
            trues_c, preds_c = run_prediction(copy.deepcopy(cfg),
                                              state=state, model=model,
                                              device="cpu")
            err = float(np.abs(preds[0] - preds_c[0]).max())
            # normalized targets (the reader's min-max scaling), in [0, 1]
            if preds[0].shape != (sum(s.num_nodes for s in splits[2]), 1) \
                    or not np.isfinite(preds[0]).all() \
                    or not np.allclose(preds[0], preds_c[0], **SLICE_TOL) \
                    or not np.array_equal(trues[0], trues_c[0]) \
                    or not (-1e-6 <= trues[0].min() <= trues[0].max()
                            <= 1 + 1e-6):
                fail(f"{name}: run_prediction card vs cpu max err {err}, "
                     f"shape {preds[0].shape}, normalized targets "
                     f"{trues[0].min()}..{trues[0].max()}")
            rmse = float(np.sqrt(np.mean((preds[0] - trues[0]) ** 2)))
            print(f"{name}: run_prediction from its files, normalized "
                  f"targets (denormalization off, as in the JAX package): "
                  f"card vs cpu max abs err {err:.3e}; test RMSE "
                  f"{rmse:.4f}", flush=True)
            rec = step_metrics(torch, cfg, splits, device, name, bs,
                               CSCE_GROUP)
            rec["run"] = dict(history=hist, wall_s=wall, launches=counts,
                              first_step=first, bitwise_repeat=same,
                              sgd_relative_gaps=gaps,
                              sgd_cpu_half_threads_gaps=floor,
                              prediction_card_cpu=err, test_rmse=rmse)
            out[f"eam_pna_{label}"] = rec

        floor, bound = hold_sgd_histories(sgd_runs)
        for label in sgd_runs:
            out[f"eam_pna_{label}"]["run"].update(sgd_float32_floor=floor,
                                                  sgd_bound=bound)

        # segment_sum at this slice's new shapes, each over the layout the
        # main path builds once a step (models/stacks.py conv_args): on
        # the edge list the unfused statistics [E, 2F + 1] by receivers
        # and the gathers' gradients [E, F] by receivers and by senders;
        # on the dense layout the gathers' gradients [N K, F] by the
        # table's neighbour ids into N and by its edge ids into E. The
        # rows a layout leaves out (masked) are 0, as on the main path.
        # Then the packed pooling over phase 9's graph slots.
        from hydragnn_tpu_torch.kernels.segment import segment_layout
        f = int(arch["hidden_dim"])
        gen = torch.Generator(device=device).manual_seed(SEED)
        for dense in (False, True):
            loader = create_dataloaders(*splits, bs,
                                        neighbor_format=dense)[0]
            loader.set_epoch(0)
            b = next(iter(loader)).to(device)
            n = b.num_nodes
            if dense:
                keep = b.nbr_mask.reshape(-1)
                g = torch.randn(keep.shape[0], f, device=device,
                                generator=gen) * keep[:, None]
                for name, ids, segs in (
                        ("eam_dense_gather_nbr_bwd", b.nbr, n),
                        ("eam_dense_gather_edge_bwd", b.nbr_edge,
                         b.num_edges)):
                    ids = ids.reshape(-1)
                    shapes.append(segment_shape(
                        torch, name, g, ids, segs,
                        layout=segment_layout(ids, segs, keep)))
                continue
            keep = b.edge_mask
            recv = segment_layout(b.receivers, n, keep)
            h = torch.randn(b.num_edges, f, device=device, generator=gen)
            stats = torch.cat([h, h * h, torch.ones_like(h[:, :1])], dim=-1)
            shapes.append(segment_shape(
                torch, "eam_edge_stats",
                (stats * keep[:, None]).contiguous(), b.receivers, n,
                layout=recv))
            g = torch.randn(b.num_edges, f, device=device,
                            generator=gen) * keep[:, None]
            shapes.append(segment_shape(torch, "eam_edge_gather_recv_bwd", g,
                                        b.receivers, n, layout=recv))
            shapes.append(segment_shape(
                torch, "eam_edge_gather_send_bwd", g, b.senders, n,
                layout=segment_layout(b.senders, n, keep)))
        pb = packed_batch
        x = torch.randn(pb.num_nodes, 200, device=device, generator=gen)
        shapes.append(segment_shape(torch, "packed_pooling",
                                    x * pb.node_mask[:, None], pb.node_graph,
                                    pb.num_graphs))
        return out, shapes
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------- phase 11 --
OC20_ENERGY = "examples/open_catalyst_2020/open_catalyst_energy.json"
OC20_FORCES = "examples/open_catalyst_2020/open_catalyst_forces.json"
QM9_CONFIG = "examples/qm9/qm9.json"
NUM_SLABS = 512                # OC20 slabs of 29 atoms
NUM_QM9 = 512                  # QM9 molecules of 6-16 atoms
FORCES_EPOCHS = 2              # open_catalyst_forces.json trains 3
SLICE_BURSTS = 20              # timed engine bursts of each path
SLICE_GROUP = 2                # steps per call timed beside S = 1


def slice_paths(torch):
    """Phase 11's three configurations: (label, config, splits, epochs)
    of the OC20 energy and forces EGNN on synthetic slabs and qm9.json's
    GIN on synthetic molecules, each split by its perc_train as the
    examples split."""
    from hydragnn_tpu_torch.graphs.synthetic import oc20_slabs, qm9_molecules
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    slabs = oc20_slabs(NUM_SLABS, seed=SEED)
    mols = qm9_molecules(NUM_QM9, seed=SEED)
    out = []
    for label, path, data, epochs in (
            ("OC20 EGNN energy", OC20_ENERGY, slabs, None),
            ("OC20 EGNN forces", OC20_FORCES, slabs, FORCES_EPOCHS),
            ("qm9 GIN", QM9_CONFIG, mols, None)):
        with open(path) as fh:
            cfg = json.load(fh)
        if label == "qm9 GIN":
            # the two keys off the port's path: plots (ROADMAP A10), and a
            # Profile under NeuralNetwork, which neither package reads
            # (the JAX package reads a top-level Profile only)
            cfg["Visualization"]["create_plots"] = False
            cfg["NeuralNetwork"].pop("Profile")
            print(f"{label}: {path} with Visualization.create_plots "
                  "turned off and NeuralNetwork.Profile removed; "
                  "architecture, widths, batch size and optimizer as "
                  "published", flush=True)
        tr = cfg["NeuralNetwork"]["Training"]
        epochs = epochs or int(tr["num_epoch"])
        splits = split_dataset(data, float(tr["perc_train"]))
        out.append((label, cfg, splits, epochs))
    return out


def engine_bursts(torch, engine, requests, bursts):
    """`bursts` bursts of `requests`, each submitted at once, after one
    warm-up burst: (requests/s over the bursts' wall time, p50 ms, p99 ms
    over every request)."""
    for fut in [engine.submit(r) for r in requests]:
        fut.result(timeout=600)
    engine.reset_stats()
    t0 = time.perf_counter()
    for _ in range(bursts):
        for fut in [engine.submit(r) for r in requests]:
            fut.result(timeout=600)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    if stats["count"] != bursts * len(requests):
        fail(f"engine recorded {stats['count']} latencies for "
             f"{bursts * len(requests)} requests")
    return dict(requests_per_s=bursts * len(requests) / wall,
                p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
                requests=len(requests), bursts=bursts)


def slice_serving(torch, label, model, done, splits, device, card,
                  counted):
    """A trained model served (`done`, its completed config):
    run_prediction from its weights, card vs CPU,
    then an InferenceEngine on the edge list over the test split repeated
    ENGINE_REPEATS times, card vs the same engine on the CPU (each within
    SLICE_TOL, or FLOOR_TIMES the float32 floor where that is wider:
    `hold_card_cpu`), batched = single on the same bucket bitwise, the
    engine's graphs (`engine_graphs`) and SLICE_BURSTS timed bursts."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    mcfg = model.cfg
    test = splits[2]
    node_head = mcfg.heads[0].head_type == "node"
    models, predicted = {}, {}
    for dev in (device, "cpu"):
        models[dev] = create_model(mcfg, device=dev)
        models[dev].load_state_dict(model.state_dict())
        tk.reset_launch_counts()
        predicted[dev] = run_prediction(copy.deepcopy(done), splits,
                                        model=models[dev], device=dev,
                                        serve=False)
        if dev == device:
            torch.cuda.synchronize()
            counted(tk.launch_counts())
    (trues, preds), (trues_c, preds_c) = predicted[device], predicted["cpu"]
    floors = {dense: float32_floor(torch, model, splits, dense)
              for dense in (True, False)}
    dense = bool(done["NeuralNetwork"]["Architecture"].get(
        "neighbor_format", True))
    if not np.array_equal(trues[0], trues_c[0]):
        fail(f"{label}: run_prediction targets differ, card vs cpu")
    layer_gaps = None
    if not np.allclose(preds[0], preds_c[0], **SLICE_TOL):
        layer_gaps = float32_layer_gaps(torch, model, splits, device, dense)
    err_rp = hold_card_cpu(f"{label}: run_prediction", preds[0], preds_c[0],
                           floors[dense])
    requests = test * ENGINE_REPEATS
    outs = {}
    for dev in (device, "cpu"):
        engine = InferenceEngine(models[dev], mcfg, reference_samples=test,
                                 max_batch_size=SERVE_MAX_BATCH,
                                 neighbor_format=False, device=dev)
        try:
            engine.warmup()
            tk.reset_launch_counts()
            futs = [engine.submit(r) for r in requests]
            results = [f.result(timeout=600) for f in futs]
            if dev == device:
                counts = tk.launch_counts()
                counted(counts)
                if counts["segment_sum"] == 0:
                    fail(f"{label}: segment_sum never launched on the "
                         "engine path")
                singles = [(f.bucket, engine.forward_single(r,
                                                            bucket=f.bucket))
                           for r, f in list(zip(requests, futs))[:8]]
                bitwise = all(np.array_equal(res[0], one[0]) for
                              (_, one), res in zip(singles, results[:8]))
                if not bitwise:
                    fail(f"{label}: engine batched != single on one bucket")
                graphs = engine_graphs(torch, engine, requests,
                                       f"{label} engine")
                rate = engine_bursts(torch, engine, requests, SLICE_BURSTS)
            outs[dev] = results
        finally:
            engine.shutdown()
    got = np.concatenate([r[0].reshape(-1) for r in outs[device]])
    want = np.concatenate([r[0].reshape(-1) for r in outs["cpu"]])
    err_eng = hold_card_cpu(f"{label}: engine", got, want, floors[False])
    print(f"{label} serving: run_prediction card vs cpu max abs err "
          f"{err_rp:.3e} (the cpu's float32 vs float64 {floors[dense]:.3e}, "
          f"edge list {floors[False]:.3e}; bound {SLICE_TOL} or "
          f"{FLOOR_TIMES:g} floors); engine ({'node' if node_head else 'graph'} head, "
          f"edge list) card vs cpu max abs err {err_eng:.3e}; batched = "
          f"single bitwise; launches {counts}; {rate['bursts']} bursts of "
          f"{rate['requests']} requests: {rate['requests_per_s']:.1f} "
          f"requests/s, p50 {rate['p50_ms']:.3f} ms, p99 "
          f"{rate['p99_ms']:.3f} ms (card: {card})", flush=True)
    return dict(prediction_card_cpu=err_rp, engine_card_cpu=err_eng,
                float32_floor_dense=floors[True],
                float32_floor_edge=floors[False],
                float32_layer_gaps=layer_gaps,
                batched_equals_single=True, launches=counts, graphs=graphs,
                **rate)


def float32_floor(torch, model, splits, dense):
    """The float32 rounding of a model's outputs on the test split: max
    |float32 - float64| of its CPU forward on the split collated as one
    batch (dense: with run_prediction's neighbour budget), over real
    graphs or nodes."""
    from hydragnn_tpu_torch.graphs.batch import (collate,
                                                 neighbor_budget_for_dataset,
                                                 with_neighbor_format)
    from hydragnn_tpu_torch.models.create import create_model
    b = collate(splits[2])
    if dense:
        b = with_neighbor_format(b, k=neighbor_budget_for_dataset(
            splits[0] + splits[1] + splits[2]))
    outs = []
    for dt in (torch.float32, torch.float64):
        m = create_model(model.cfg, device="cpu").to(dt)
        m.load_state_dict(model.state_dict())
        with torch.no_grad():
            out, _ = m(b.replace(**{k: getattr(b, k).to(dt) for k in (
                "x", "pos", "edge_attr", "edge_shifts")
                if getattr(b, k) is not None}))
        outs.append(out[0].double())
    rows = (b.node_mask if model.cfg.heads[0].head_type == "node"
            else b.graph_mask)
    return float((outs[0] - outs[1])[rows].abs().max())


FLOOR_TIMES = 4.0              # card vs cpu, in float32 floors


def float32_layer_gaps(torch, model, splits, device, dense):
    """Where a model's float32 outputs part card vs CPU: each conv's and
    norm's output on the test split (one batch), card and CPU float32
    against the CPU at float64, max abs over real nodes, beside the
    largest |value|. Printed before a serving hold falls back to the
    float32 floor."""
    from hydragnn_tpu_torch.graphs.batch import (collate,
                                                 neighbor_budget_for_dataset,
                                                 with_neighbor_format)
    from hydragnn_tpu_torch.models.create import create_model
    b = collate(splits[2])
    if dense:
        b = with_neighbor_format(b, k=neighbor_budget_for_dataset(
            splits[0] + splits[1] + splits[2]))
    feats = {}
    for tag, dev, dt in (("card", device, torch.float32),
                         ("cpu", "cpu", torch.float32),
                         ("cpu64", "cpu", torch.float64)):
        m = create_model(model.cfg, device=dev).to(dt)
        m.load_state_dict(model.state_dict())
        bb = b.replace(**{k: getattr(b, k).to(dt) for k in (
            "x", "pos", "edge_attr", "edge_shifts")
            if getattr(b, k) is not None}).to(dev)
        out = []
        with torch.no_grad():
            cargs = m.conv_args(bb)
            x, pos = bb.x, bb.pos
            for i in range(m.cfg.num_conv_layers):
                x, pos = getattr(m, f"conv_{i}")(x, pos, bb, cargs)
                out.append((f"conv_{i}", x.double().cpu()))
                if m.use_batch_norm:
                    x = getattr(m, f"feature_norm_{i}")(x, bb.node_mask)
                    out.append((f"feature_norm_{i}", x.double().cpu()))
                x = m.act(x)
        feats[tag] = out
    rows = b.node_mask
    gaps = []
    for (name, card), (_, cpu), (_, ref) in zip(*feats.values()):
        card, cpu, ref = card[rows], cpu[rows], ref[rows]
        gaps.append(dict(layer=name, scale=float(ref.abs().max()),
                         card=float((card - ref).abs().max()),
                         cpu=float((cpu - ref).abs().max())))
    print("float32 rounding by layer, card / cpu against the cpu at "
          "float64 (max abs; largest |value|): " + "; ".join(
              f"{g['layer']} {g['card']:.2e} / {g['cpu']:.2e} "
              f"({g['scale']:.3g})" for g in gaps), flush=True)
    return gaps


def hold_card_cpu(name, got, want, floor):
    """Card vs CPU within SLICE_TOL or, where the float32 floor is wider,
    within FLOOR_TIMES the floor (`float32_floor`): the CPU's own float32
    rounding, which the card's may exceed (qm9.json's GIN trained on an
    H100: card vs CPU 1.84e-5 against a floor of 5.9e-6 on predictions
    of 0.01-0.24, every kernel held against its plain version); a lost
    path or a wrong kernel misses it by orders. Fails otherwise. Returns
    the max abs error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    within = np.abs(got - want) <= np.maximum(
        SLICE_TOL["atol"] + SLICE_TOL["rtol"] * np.abs(want),
        FLOOR_TIMES * floor)
    if got.shape != want.shape or not np.isfinite(got).all() \
            or not within.all():
        fail(f"{name} card vs cpu max err {err}, shape {got.shape}; "
             f"float32 floor {floor}")
    return err


def slice_training(torch, label, cfg, splits, epochs, device, card,
                   counted):
    """One phase 11 configuration trained through run_training (captured
    steps) on the dense layout and the edge list. Per layout: the first
    step (`first_step_gradients`: loss card vs CPU within SLICE_TOL,
    gradients kernels vs plain versions within 1e-2 relative L2), the
    config's optimizer on the card twice (bitwise equal histories and
    parameters; the first counted), and the step numbers
    (`step_metrics`, which first holds captured = eager bitwise).
    Returns (the dense run's model and completed config, {path:
    record})."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    bs = int(cfg["NeuralNetwork"]["Training"]["batch_size"])
    out, model, completed = {}, None, None
    for dense in (True, False):
        c = copy.deepcopy(cfg)
        c["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
        c["NeuralNetwork"]["Training"]["num_epoch"] = epochs
        name = f"{label} ({'dense' if dense else 'edge list'})"
        sgd = copy.deepcopy(c)
        sgd["NeuralNetwork"]["Training"]["Optimizer"] = {
            "type": "SGD", "learning_rate": c["NeuralNetwork"]["Training"][
                "Optimizer"].get("learning_rate", 1e-3)}
        first = first_step_gradients(torch, sgd, splits, device)
        runs = []
        for i in range(2):
            tk.reset_launch_counts()
            t0 = time.perf_counter()
            state, hist, m, done = run_training(copy.deepcopy(c),
                                                datasets=splits,
                                                device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if i == 0:
                counts = tk.launch_counts()
                counted(counts)
                if dense:
                    model, completed = m, done
            runs.append((hist, {k: v.detach().cpu().clone()
                                for k, v in state.state_dict().items()},
                         wall))
        (h0, s0, w0), (h1, s1, w1) = runs
        same = all(h0[k] == h1[k] for k in h0) and all(
            torch.equal(v, s1[k]) for k, v in s0.items())
        if not same:
            fail(f"{name}: two card runs from one seed differ")
        if counts["segment_sum"] == 0:
            fail(f"{name}: segment_sum never launched")
        if not np.isfinite(h0["train_loss"] + h0["val_loss"]).all() \
                or sum(h0["nonfinite_steps"]):
            fail(f"{name}: non-finite losses {h0}")
        print(f"{name}: run_training {epochs} epochs "
              f"({c['NeuralNetwork']['Training']['Optimizer']['type']}) in "
              f"{w0:.2f} s and {w1:.2f} s, bitwise equal: {same}; train "
              f"{h0['train_loss']} val {h0['val_loss']}; CUDA graphs an "
              f"epoch {h0['graph_captures']}; launches {counts}; first step: "
              f"loss card vs cpu {first['loss_gap']:.3e}, gradients kernels "
              f"vs plain {first['rel_l2_kernels_plain']:.3e} (relative L2, "
              f"worst tensor; as one vector "
              f"{first['rel_l2_kernels_plain_all']:.3e}), card vs cpu "
              f"{first['rel_l2_card_cpu']:.3e}, cpu float32 vs float64 "
              f"{first['rel_l2_cpu_f64']:.3e} (card: {card})", flush=True)
        rec = step_metrics(torch, c, splits, device, name, bs, SLICE_GROUP,
                           card=card)
        rec["run"] = dict(history=h0, wall_s=w0, launches=counts,
                          first_step=first, bitwise_repeat=same)
        out["_".join(label.lower().split()) + ("_dense" if dense
                                              else "_edge")] = rec
    return model, completed, out


def egnn_bf16_forward(torch, model, splits, device, card):
    """The trained EGNN's forward at bf16 (train_step.make_forward_fn) on
    a loader batch, card vs CPU within 2^-5 (atol + rtol |ref|), the gap
    to float32 printed."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train.train_step import make_forward_fn
    mcfg = model.cfg
    loader = create_dataloaders(*splits, 32, neighbor_format=False)[0]
    loader.set_epoch(0)
    batch = next(iter(loader))
    outs = {}
    for dev in (device, "cpu"):
        m = create_model(mcfg, device=dev)
        m.load_state_dict(model.state_dict())
        before = tk.launch_counts()["segment_sum"]
        with torch.no_grad():
            got, _ = make_forward_fn(m, mcfg, "bf16", frozen=True)(
                batch.to(dev))
            ref32, _ = m(batch.to(dev))
        if dev == device and tk.launch_counts()["segment_sum"] == before:
            fail("EGNN bf16 forward: segment_sum never launched")
        outs[str(dev)] = (got[0].cpu().numpy(), ref32[0].cpu().numpy())
    gm = batch.graph_mask.numpy()
    card16, card32 = (o[gm] for o in outs[str(device)])
    cpu16 = outs["cpu"][0][gm]
    gap = bf16_gap(card16, cpu16)
    if not np.isfinite(card16).all() or gap > 0:
        fail(f"EGNN bf16 forward card vs cpu outside 2^-5 (by {gap})")
    rec = dict(card_cpu=float(np.abs(card16 - cpu16).max()), margin=-gap,
               bf16_vs_float32=float(np.abs(card16 - card32).max()))
    print(f"OC20 EGNN energy bf16 forward (edge list, {int(gm.sum())} "
          f"slabs): card vs cpu max abs err {rec['card_cpu']:.3e} (bound "
          f"2^-5 + 2^-5 |ref|, margin {rec['margin']:.3e}); bf16 vs float32 "
          f"on the card {rec['bf16_vs_float32']:.3e} (card: {card})",
          flush=True)
    return rec


def slice_segment_shapes(torch, paths, device, card):
    """segment_sum at each new shape of phase 11's paths, on the loader's
    first batch, each over the layout the path builds once a step
    (models/base.py `aggregation_layouts`), beside its bound and
    `index_add`'s time: EGNN's [E, 50] message sum and [E, 3] coordinate
    mean by receivers and its gathers' gradients (by senders on the
    edge list, by the table's edge ids on the dense layout), GIN's [E, 5]
    sum and its dense gather's gradient [N K, 5], and both poolings."""
    from hydragnn_tpu_torch.kernels.segment import segment_layout
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = []
    for label, cfg, splits, _ in paths:
        if label == "OC20 EGNN forces":
            continue            # the energy config's shapes
        tag = "egnn" if "EGNN" in label else "gin"
        f = int(cfg["NeuralNetwork"]["Architecture"]["hidden_dim"])
        bs = int(cfg["NeuralNetwork"]["Training"]["batch_size"])
        for dense in (False, True):
            loader = create_dataloaders(*splits, bs,
                                        neighbor_format=dense)[0]
            loader.set_epoch(0)
            b = next(iter(loader)).to(device)
            n = b.num_nodes
            if dense:
                keep = b.nbr_mask.reshape(-1)
                ids, segs = ((b.nbr_edge, b.num_edges) if tag == "egnn"
                             else (b.nbr, n))
                ids = ids.reshape(-1)
                g = torch.randn(keep.shape[0], f, device=device,
                                generator=gen) * keep[:, None]
                shapes.append(segment_shape(
                    torch, f"{tag}_dense_gather_bwd", g, ids, segs,
                    layout=segment_layout(ids, segs, keep), card=card))
                continue
            keep = b.edge_mask
            recv = segment_layout(b.receivers, n, keep)
            for name, width in ((f"{tag}_edge_sum", f),
                                ("egnn_edge_coord_mean", 3)):
                if name == "egnn_edge_coord_mean" and tag != "egnn":
                    continue
                m = torch.randn(b.num_edges, width, device=device,
                                generator=gen) * keep[:, None]
                shapes.append(segment_shape(torch, name, m, b.receivers, n,
                                            layout=recv, card=card))
            if tag == "egnn":
                g = torch.randn(b.num_edges, f, device=device,
                                generator=gen) * keep[:, None]
                shapes.append(segment_shape(
                    torch, "egnn_gather_send_bwd", g, b.senders, n,
                    layout=segment_layout(b.senders, n, keep), card=card))
            x = torch.randn(n, f, device=device, generator=gen)
            shapes.append(segment_shape(torch, f"{tag}_pooling",
                                        x * b.node_mask[:, None],
                                        b.node_graph, b.num_graphs,
                                        card=card))
    return shapes


def slice_phase(torch, device, card, counted):
    """Phase 11: EGNN and GIN (`slice_paths`) trained (`slice_training`)
    and served (`slice_serving`), EGNN's bf16 forward
    (`egnn_bf16_forward`) and segment_sum at the new shapes
    (`slice_segment_shapes`). Returns ({path: record}, shapes)."""
    t_phase = time.perf_counter()
    paths = slice_paths(torch)
    records, serving = {}, {}
    energy_model = None
    for label, cfg, splits, epochs in paths:
        arch = cfg["NeuralNetwork"]["Architecture"]
        print(f"phase 11: {label}: {arch['model_type']} hidden "
              f"{arch['hidden_dim']}, {arch['num_conv_layers']} layers, "
              f"batch {cfg['NeuralNetwork']['Training']['batch_size']}, "
              f"{epochs} epochs; {sum(len(s) for s in splits)} graphs "
              f"(splits {[len(s) for s in splits]}) of "
              f"{splits[0][0].num_nodes} nodes and "
              f"{splits[0][0].num_edges} edges (the first) (card: {card})",
              flush=True)
        model, done, recs = slice_training(torch, label, cfg, splits,
                                           epochs, device, card, counted)
        records.update(recs)
        serving[label] = slice_serving(torch, label, model, done, splits,
                                       device, card, counted)
        if label == "OC20 EGNN energy":
            energy_model = model
    records["oc20_egnn_energy_bf16_forward"] = egnn_bf16_forward(
        torch, energy_model, paths[0][2], device, card)
    records["serving"] = serving
    shapes = slice_segment_shapes(torch, paths, device, card)
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s (card: "
          f"{card})", flush=True)
    return records, shapes


# ----------------------------------------------------------- phase 12 --
MD_ATOMS_PER_DIM = 12          # 1,728 atoms, BENCH_MD's count
MD_STEPS = 60                  # steps in each neighbour mode
MD_DT, MD_TEMP, MD_SKIN = 0.005, 0.3, 0.3
MD_MODES = ("incremental", "rebuild", "offline")
MD_CLIENTS = 8                 # concurrent trajectories, 6³ atoms each
MD_CLIENT_STEPS = 30
POS_ATOL = 1e-6                # step-1 positions, card vs cpu
OPEN_LOOP_S = 5.0              # seconds of arrivals at each rate
OPEN_LOOP_RATES = (0.5, 0.9, 1.5)   # multiples of the closed-loop rate
OPEN_LOOP_DEADLINE_MS = 50.0   # ~10x the csce forward (PERF.md section 5)
OPEN_LOOP_WAIT_MS = 2.0        # bench.py BENCH_SERVE_WAIT_MS's default
CLOSED_LOOP_BURSTS = 10


def md_system(atoms_per_dim, seed_pos, seed_vel):
    """(pos0, cell, vel0, node features) of md_loop's LJ lattice: lattice
    1.2, jitter 0.05, Maxwell velocities at MD_TEMP."""
    from hydragnn_tpu_torch.md.loop import init_lattice, maxwell_velocities
    pos0, cell = init_lattice(atoms_per_dim, 1.2, 0.05, seed=seed_pos)
    vel0 = maxwell_velocities(len(pos0), MD_TEMP, seed=seed_vel)
    return pos0, cell, vel0, np.ones((len(pos0), 1), np.float32)


def md_config():
    """`md/loop.lj_md_config` at examples/LennardJones/LJ.json's
    architecture: num_gaussians 32 and equivariance on, as LJ.json has
    them (the coordinate update reaches no energy)."""
    from hydragnn_tpu_torch.md.loop import lj_md_config
    cfg = lj_md_config(num_gaussians=32)
    cfg["NeuralNetwork"]["Architecture"]["equivariance"] = True
    return cfg


def md_model(lj_state, cfg, frames):
    """The MD config completed on `frames`, with phase 6's trained
    weights when `lj_state` is given, else seeded random ones. Returns
    (completed config, model config, a function making the model on a
    device, the weights' label)."""
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    done = tcfg.update_config(copy.deepcopy(cfg), frames)
    mcfg = tcfg.build_model_config(done)
    if lj_state is not None:
        weights = {k: v.detach().cpu() for k, v in
                   lj_state.state_dict().items()}
        label = "phase 6's trained LJ.json weights"
    else:
        weights = load_jax_variables(random_flax_variables(
            create_model(mcfg, device="cpu"), SEED + 12))
        label = f"seeded random weights (seed {SEED + 12})"

    def on(dev):
        model = create_model(mcfg, device=dev)
        model.load_state_dict(weights)
        return model
    return done, mcfg, on, label


def md_in_the_loop(torch, device, card, counted, lj_state):
    """Phase 12a: velocity-Verlet MD of 1,728 LJ atoms through
    `submit_structure` on the card, MD_STEPS steps in each neighbour mode;
    the modes' trajectories bitwise equal, the first step card vs CPU
    within SLICE_TOL, no capture after warm-up, and B3 and B4 in the
    bucket's graph (its kernel nodes against the launch counters).
    Returns (record, filter_scatter shapes, segment_sum shapes)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.graphs.batch import collate
    from hydragnn_tpu_torch.md import integrator as mdi
    from hydragnn_tpu_torch.md.loop import md_buckets, run_md
    from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
    from hydragnn_tpu_torch.serving.engine import InferenceEngine

    pos0, cell, vel0, nf = md_system(MD_ATOMS_PER_DIM, 1, 2)
    n = len(pos0)
    cfg = md_config()
    frame0 = build_graph_sample(nf, pos0, cfg, cell=cell,
                                with_targets=False)
    done, mcfg, model_on, weights = md_model(lj_state, cfg, [frame0])
    buckets = md_buckets(n, frame0.num_edges)

    def engine_on(dev):
        return InferenceEngine(
            model_on(dev), mcfg, buckets=buckets, proto_sample=frame0,
            max_batch_size=1, max_wait_ms=0.0, structure_config=done,
            md_skin=MD_SKIN, ef_forward=True, device=dev)

    qpos0 = mdi.init_state(pos0, vel0, MD_DT)[0]
    qcell = mdi.quantize_cell(cell)
    with engine_on("cpu") as cpu_engine:
        want = cpu_engine.submit_structure(qpos0, nf, cell=qcell).result()
    engine = engine_on(device)
    try:
        engine.warmup()
        captures = engine.stats()["captures"]
        first = engine.submit_structure(qpos0, nf, cell=qcell).result()
        err_e = float(np.abs(first[0] - want[0]).max())
        err_f = float(np.abs(first[1] - want[1]).max())
        fmax = float(np.abs(want[1]).max())
        print(f"phase 12a: LJ SchNet MD, {n} atoms ({MD_ATOMS_PER_DIM}³), {frame0.num_edges}"
              f" edges at step 0, bucket {buckets[0].n_node}x"
              f"{buckets[0].n_edge}x{buckets[0].n_graph}; {weights}; first "
              f"step card vs cpu: energy max abs err {err_e:.3e}, forces "
              f"{err_f:.3e} (max |F| {fmax:.3e}; tolerance {SLICE_TOL})",
              flush=True)
        for name, g, w in (("energy", first[0], want[0]),
                           ("forces", first[1], want[1])):
            if not np.isfinite(g).all() or not np.allclose(g, w,
                                                           **SLICE_TOL):
                fail(f"MD first step {name}: card vs cpu outside "
                     f"{SLICE_TOL}")
        nodes = check_graph_kernels(engine._graphs[buckets[0]], "MD bucket")
        for key in ("segment_sum_kernel", "filter_scatter_kernel"):
            if not nodes.get(key):
                fail(f"MD bucket graph holds no {key} node: {nodes}")
        runs = {}
        tk.reset_launch_counts()
        for mode in MD_MODES:
            runs[mode] = run_md(engine, done, pos0, vel0, cell, nf,
                                steps=MD_STEPS, dt=MD_DT, mode=mode,
                                skin=MD_SKIN if mode == "incremental"
                                else None)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        counted(counts)
        stats, health = engine.stats(), engine.health()
        batch = collate([frame0], n_node=buckets[0].n_node,
                        n_edge=buckets[0].n_edge,
                        n_graph=buckets[0].n_graph).replace(
            y_node=None, energy=None, forces=None).to(device)
    finally:
        engine.shutdown()
    for name in ("segment_sum", "filter_scatter", "filter_scatter_backward"):
        if counts[name] == 0:
            fail(f"{name} never launched on the MD path")
    if stats["captures"] != captures:
        fail(f"MD: {stats['captures'] - captures} captures during the run")
    inc = runs["incremental"]
    for mode in MD_MODES[1:]:
        r = runs[mode]
        if not (r["energies"] == inc["energies"]
                and np.array_equal(r["final_pos"], inc["final_pos"])
                and np.array_equal(r["final_vel"], inc["final_vel"])):
            fail(f"MD: the {mode} trajectory differs from the incremental "
                 "one")
    if not np.isfinite(inc["energies"]).all():
        fail("MD: non-finite energy")
    rec = dict(atoms=n, steps=MD_STEPS, dt=MD_DT, skin=MD_SKIN,
               edges_step0=frame0.num_edges,
               bucket=f"{buckets[0].n_node}x{buckets[0].n_edge}x"
                      f"{buckets[0].n_graph}", weights=weights,
               first_step_err=dict(energy=err_e, forces=err_f, max_f=fmax),
               kernel_nodes=nodes, launches=counts, modes={},
               trajectories_bitwise_equal=True,
               captures_during_run=stats["captures"] - captures,
               nbr_rebuild_fraction=health["nbr_rebuild_fraction"])
    for mode, r in runs.items():
        serve = r["step_ms_mean"] - r["graph_build_ms_mean"]
        rec["modes"][mode] = dict(
            steps_per_s=r["steps_per_s"], step_ms=r["step_ms_mean"],
            graph_build_ms=r["graph_build_ms_mean"], serve_ms=serve,
            rebuild_fraction=r["rebuild_fraction"],
            energy_first=r["energy_first"], energy_last=r["energy_last"])
        print(f"MD {mode}: {r['steps_per_s']} steps/s, step "
              f"{r['step_ms_mean']} ms = graph build "
              f"{r['graph_build_ms_mean']} ms + serve {serve} ms; rebuild "
              f"fraction {r['rebuild_fraction']}; energy first "
              f"{r['energy_first']} last {r['energy_last']} (card: {card})",
              flush=True)
    print(f"MD: the three modes' positions, velocities and energies "
          f"bitwise equal; no capture during the run; bucket graph's "
          f"hand-written kernel nodes {nodes}; launches over the three "
          f"runs {counts}", flush=True)
    # B4 and B3 at the MD bucket's shapes, against their plain versions
    fs_rec, seg_shapes = check_filter_scatter(torch, batch, device,
                                              mcfg.num_filters)
    fs_shapes = [dict(s, shape=f"md_{s['shape']}", max_abs_err=fs_rec[
        "max_abs_err" if s["shape"] == "forward" else
        "backward_max_abs_err"]) for s in fs_rec["shapes"]]
    seg_shapes = [dict(s, shape=s["shape"].replace("ef_", "md_"))
                  for s in seg_shapes]
    return rec, fs_shapes, seg_shapes


def md_clients(torch, device, card, counted, lj_state):
    """Phase 12b: MD_CLIENTS threads, each with its own trajectory session
    (216 atoms, seeds 0-7), through one EF engine whose ladder is built
    from those systems (30 % edge headroom, max_batch_size MD_CLIENTS),
    MD_CLIENT_STEPS steps each; every trajectory's step 1 against its own
    single-client run on the CPU within SLICE_TOL (energies) and POS_ATOL
    (positions); every future resolved."""
    import threading

    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.graphs.packing import sample_sizes
    from hydragnn_tpu_torch.md.loop import run_md
    from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
    from hydragnn_tpu_torch.serving.engine import (InferenceEngine,
                                                   bucket_ladder)
    systems = [md_system(6, k, 100 + k) for k in range(MD_CLIENTS)]
    cfg = md_config()
    frames = [build_graph_sample(nf, p, cfg, cell=c, with_targets=False)
              for p, c, _, nf in systems]
    done, mcfg, model_on, weights = md_model(lj_state, cfg, frames)
    nodes, edges = sample_sizes(frames)
    buckets = bucket_ladder(nodes, (edges * 1.3).astype(np.int64),
                            MD_CLIENTS)

    def engine_on(dev, batch):
        return InferenceEngine(
            model_on(dev), mcfg, buckets=buckets, proto_sample=frames[0],
            max_batch_size=batch, max_wait_ms=2.0, structure_config=done,
            md_skin=MD_SKIN, ef_forward=True, device=dev)

    with engine_on("cpu", 1) as cpu_engine:
        want = [run_md(cpu_engine, done, p, v, c, nf, steps=1, dt=MD_DT,
                       mode="incremental") for p, c, v, nf in systems]
    engine = engine_on(device, MD_CLIENTS)
    out, errors = [None] * MD_CLIENTS, []
    try:
        engine.warmup()
        engine.reset_stats()
        barrier = threading.Barrier(MD_CLIENTS)

        def client(k):
            p, c, v, nf = systems[k]
            try:
                barrier.wait()
                out[k] = run_md(engine, done, p, v, c, nf,
                                steps=MD_CLIENT_STEPS, dt=MD_DT,
                                mode="incremental", record_positions=True)
            except Exception as exc:  # noqa: BLE001 — failed below
                errors.append(f"client {k}: {exc!r}")

        tk.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(MD_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        counted(counts)
        stats, health = engine.stats(), engine.health()
    finally:
        engine.shutdown()
    if errors or any(t.is_alive() for t in threads):
        fail(f"MD clients: {errors or 'a client did not finish'}")
    gaps_e, gaps_p = [], []
    for k, (got, ref) in enumerate(zip(out, want)):
        e_g, e_w = np.asarray(got["energies"][:2]), np.asarray(
            ref["energies"][:2])
        gaps_e.append(float(np.abs(e_g - e_w).max()))
        gaps_p.append(float(np.abs(got["positions"][0]
                                   - ref["final_pos"]).max()))
        if not np.allclose(e_g, e_w, **SLICE_TOL) or gaps_p[-1] > POS_ATOL:
            fail(f"MD client {k}: step 1 card vs its single-client cpu run:"
                 f" energies {e_g} vs {e_w}, positions {gaps_p[-1]}")
    steps = MD_CLIENTS * MD_CLIENT_STEPS
    rec = dict(clients=MD_CLIENTS, atoms=len(systems[0][0]),
               steps_each=MD_CLIENT_STEPS, weights=weights,
               buckets=[f"{b.n_node}x{b.n_edge}x{b.n_graph}"
                        for b in buckets],
               steps_per_s=steps / wall, wall_s=wall,
               batch_occupancy=stats["batch_occupancy"],
               batches=stats["batches"], p50_ms=stats["p50_ms"],
               p99_ms=stats["p99_ms"],
               rebuild_fraction=health["nbr_rebuild_fraction"],
               step1_energy_gap=max(gaps_e), step1_pos_gap=max(gaps_p),
               launches=counts)
    print(f"phase 12b: {MD_CLIENTS} concurrent MD sessions of "
          f"{rec['atoms']} atoms, {MD_CLIENT_STEPS} steps each: "
          f"{rec['steps_per_s']} steps/s summed over clients ({wall} s), "
          f"{stats['batches']} batches, mean batch occupancy "
          f"{stats['batch_occupancy']}, request p50 {stats['p50_ms']} ms "
          f"p99 {stats['p99_ms']} ms, rebuild fraction "
          f"{health['nbr_rebuild_fraction']}; step 1 vs single-client cpu "
          f"runs: energy gap {max(gaps_e):.3e}, position gap "
          f"{max(gaps_p):.3e}; buckets {rec['buckets']}; launches {counts} "
          f"(card: {card})", flush=True)
    for name in ("segment_sum", "filter_scatter"):
        if counts[name] == 0:
            fail(f"{name} never launched on the concurrent MD path")
    return rec


def open_loop(torch, device, card, counted, csce):
    """Phase 12c: the csce PNA engine (edge list) with max_queue 4 x
    max_batch_size, a OPEN_LOOP_DEADLINE_MS deadline and the coalescing
    window of the JAX package's open-loop bench (`bench.py` BENCH_SERVE,
    BENCH_SERVE_WAIT_MS): the closed-loop rate R (bursts of the repeated
    test split, as phase 3, cut to the admission bound), then seeded
    Poisson arrivals at OPEN_LOOP_RATES x R for OPEN_LOOP_S each. Every
    accepted future resolves with a result or a serving error (tallied
    by a done-callback, so no future outlives its resolution), none is
    pending after shutdown, and at the lowest rate nothing is refused or
    expires.

    The lowest rate runs once first with the heap as it is, measured and
    not held; then the heap of the run so far is frozen out of the
    collector (`gc.freeze`, as a serving process freezes its start-up
    heap) for the held rates: one full collection over this process's
    data of the earlier phases holds the interpreter longer than the
    deadline (the time of one is printed). Collections during each rate
    are counted and printed."""
    import collections
    import gc
    import threading

    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.serving.engine import (InferenceEngine,
                                                   ServingError)
    requests = csce["requests"]
    engine = InferenceEngine(
        csce["model"], csce["mcfg"], reference_samples=csce["test"],
        max_batch_size=SERVE_MAX_BATCH, max_wait_ms=OPEN_LOOP_WAIT_MS,
        neighbor_format=False, max_queue=4 * SERVE_MAX_BATCH,
        default_deadline_ms=OPEN_LOOP_DEADLINE_MS, device=device)
    rng = np.random.default_rng(0)
    recs = {}
    outcome = collections.Counter()
    lock = threading.Lock()

    def tally(fut):
        exc = fut.exception()
        name = ("ok" if exc is None else type(exc).__name__
                if isinstance(exc, ServingError) else f"other: {exc!r}")
        with lock:
            outcome[name] += 1

    def resolved():
        with lock:
            return sum(outcome.values())

    pauses = []

    def gc_pause(phase, info):
        if phase == "start":
            gc_pause.t0 = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - gc_pause.t0))

    admitted = [0]             # accepted over every rate

    def drive(mult, rate, label):
        """Poisson arrivals at mult x rate for OPEN_LOOP_S; returns the
        rate's record once every accepted future has resolved."""
        offered = int(mult * rate * OPEN_LOOP_S)
        at = np.cumsum(rng.exponential(1.0 / (mult * rate), offered))
        before = engine.health()
        engine.reset_stats()
        with lock:
            seen = dict(outcome)
        del pauses[:]
        queue_full = 0
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(offered):
            delay = at[i] - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            try:
                fut = engine.submit(requests[i % len(requests)])
            except ServingError as exc:
                if type(exc).__name__ != "QueueFullError":
                    fail(f"open loop: submit refused with {exc!r}")
                queue_full += 1
                continue
            admitted[0] += 1
            fut.add_done_callback(tally)
        sent = time.perf_counter() - t0
        t_wait = time.perf_counter()
        while resolved() < admitted[0]:
            if time.perf_counter() - t_wait > 600:
                fail("open loop: futures unresolved after 600 s")
            time.sleep(0.005)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        counted(counts)
        stats, health = engine.stats(), engine.health()
        with lock:
            got = {k: v - seen.get(k, 0) for k, v in outcome.items()
                   if v > seen.get(k, 0)}
        expired = health["deadline_expired"] - before["deadline_expired"]
        rec = dict(rate_x_r=mult, offered_per_s=mult * rate,
                   offered=offered, send_s=sent,
                   admitted=offered - queue_full,
                   completed=got.get("ok", 0), queue_full=queue_full,
                   deadline_exceeded=got.get("DeadlineExceededError", 0),
                   outcomes=got, p50_ms=stats["p50_ms"],
                   p95_ms=stats["p95_ms"], p99_ms=stats["p99_ms"],
                   batches=stats["batches"],
                   batch_occupancy=stats["batch_occupancy"],
                   max_queue_depth=stats["max_queue_depth"],
                   gc_collections=len(pauses),
                   gc_full_collections=sum(g == 2 for g, _ in pauses),
                   gc_max_pause_ms=1e3 * max([d for _, d in pauses]
                                             or [0.0]),
                   health=health, launches=counts)
        print(f"open loop {label} ({mult * rate} requests/s offered over "
              f"{sent} s): offered {offered}, admitted {rec['admitted']}, "
              f"completed {rec['completed']}, QueueFullError {queue_full},"
              f" DeadlineExceededError {rec['deadline_exceeded']} (engine "
              f"count {expired}); completed p50 {stats['p50_ms']} ms p95 "
              f"{stats['p95_ms']} ms p99 {stats['p99_ms']} ms; "
              f"{stats['batches']} batches, occupancy "
              f"{stats['batch_occupancy']}, max queue depth "
              f"{stats['max_queue_depth']}; {len(pauses)} collections "
              f"({rec['gc_full_collections']} full), longest "
              f"{rec['gc_max_pause_ms']:.3f} ms; health {health} (card: "
              f"{card})", flush=True)
        if set(got) - {"ok", "DeadlineExceededError"} \
                or health["batch_failures"]:
            fail(f"open loop {label}: outcomes {got}")
        for name in ("pna_edge_aggregate", "segment_sum"):
            if counts[name] == 0:
                fail(f"{name} never launched on the open-loop path")
        return rec, expired

    gc.callbacks.append(gc_pause)
    try:
        engine.warmup()
        burst = requests[:engine.max_queue]
        walls = []
        for _ in range(CLOSED_LOOP_BURSTS):
            t0 = time.perf_counter()
            for f in [engine.submit(s, deadline_ms=0) for s in burst]:
                f.result(timeout=600)
            walls.append(time.perf_counter() - t0)
        rate = len(burst) * CLOSED_LOOP_BURSTS / sum(walls)
        print(f"phase 12c: csce PNA engine closed-loop rate R = {rate} "
              f"requests/s ({CLOSED_LOOP_BURSTS} bursts of "
              f"{len(burst)}); open loop at {OPEN_LOOP_RATES} x R, "
              f"max_queue {engine.max_queue}, deadline "
              f"{OPEN_LOOP_DEADLINE_MS} ms, max_wait "
              f"{OPEN_LOOP_WAIT_MS} ms (card: {card})", flush=True)
        # the lowest rate once with the heap as it is: measured, not held
        unfrozen, _ = drive(OPEN_LOOP_RATES[0], rate,
                            f"{OPEN_LOOP_RATES[0]} x R, heap not frozen")
        t0 = time.perf_counter()
        gc.collect()
        full_gc_ms = (time.perf_counter() - t0) * 1e3
        gc.freeze()
        print(f"a full collection of this process's heap: {full_gc_ms} ms; "
              f"heap frozen (card: {card})", flush=True)
        for mult in OPEN_LOOP_RATES:
            recs[f"{mult}R"], expired = drive(mult, rate, f"{mult} x R")
            if mult == OPEN_LOOP_RATES[0] and (
                    recs[f"{mult}R"]["queue_full"] or expired):
                fail(f"open loop at {mult} x R: "
                     f"{recs[f'{mult}R']['queue_full']} refused, "
                     f"{expired} expired")
    finally:
        engine.shutdown()
        gc.callbacks.remove(gc_pause)
        gc.unfreeze()
    if resolved() != admitted[0]:
        fail("open loop: a future pending after shutdown")
    return dict(closed_loop_rate=rate, max_wait_ms=OPEN_LOOP_WAIT_MS,
                full_collection_ms=full_gc_ms, heap_not_frozen=unfrozen,
                rates=recs)


def fault_and_swap(torch, device, card, csce):
    """Phase 12d: on the csce engine with the plan serving-dispatch@2,5,6,
    breaker_threshold 2 and breaker_reset_s 0.2, one request at a time:
    only the faulted batches fail, the breaker trips once and one probe
    closes it, and every served result (the one after each fault too)
    equals forward_single bitwise. Then swap_variables to a second seeded
    weight set mid-stream: results bitwise those of fresh engines on each
    set, the version on each future, no capture, and a mismatched tree
    refused before any change."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import (CircuitOpenError,
                                                   InferenceEngine)
    from hydragnn_tpu_torch.utils.faults import (InjectedFault,
                                                 install_fault_plan,
                                                 parse_fault_plan)
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    mcfg, test = csce["mcfg"], csce["test"]
    v0 = csce["variables"]
    v1 = random_flax_variables(create_model(mcfg, device="cpu"), SEED + 1)

    def engine_on(variables, **kw):
        model = create_model(mcfg, device=device)
        model.load_state_dict(load_jax_variables(variables))
        kw.setdefault("max_batch_size", 1)
        return InferenceEngine(model, mcfg, reference_samples=test,
                               max_wait_ms=0.0, neighbor_format=False,
                               device=device, **kw)

    engine = engine_on(v0, breaker_threshold=2, breaker_reset_s=0.2)
    try:
        engine.warmup()
        install_fault_plan(parse_fault_plan("serving-dispatch@2,5,6"))
        outcome = []
        for i in range(9):
            if i == 7:
                try:
                    engine.submit(test[i])
                    fail("faults: the open breaker admitted a request")
                except CircuitOpenError:
                    outcome.append("refused")
                time.sleep(0.25)
            f = engine.submit(test[i])
            exc = f.exception(timeout=600)
            if exc is None:
                ref = engine.forward_single(test[i], bucket=f.bucket)
                if not all(np.array_equal(a, b)
                           for a, b in zip(f.result(), ref)):
                    fail(f"faults: request {i} differs from forward_single")
                outcome.append("ok")
            elif isinstance(exc, InjectedFault):
                outcome.append("fault")
            else:
                fail(f"faults: request {i} failed with {exc!r}")
        install_fault_plan(None)
        health = engine.health()
    finally:
        install_fault_plan(None)
        engine.shutdown()
    expect = ["ok", "ok", "fault", "ok", "ok", "fault", "fault", "refused",
              "ok", "ok"]
    if outcome != expect or health["trip_count"] != 1 \
            or health["probe_count"] != 1 or health["state"] != "closed" \
            or health["batch_failures"] != 3:
        fail(f"faults: outcome {outcome} (expected {expect}), health "
             f"{health}")
    print(f"phase 12d: fault plan serving-dispatch@2,5,6, breaker 2 / 0.2 s:"
          f" outcome {outcome}; trips {health['trip_count']}, probes "
          f"{health['probe_count']}, state {health['state']}; every result "
          f"bitwise forward_single (card: {card})", flush=True)

    # one request a batch, so each result has a fresh engine's
    # forward_single on the same inputs to equal bit for bit
    requests = csce["requests"][:384]
    late = len(requests) // 3   # submitted after the swap
    engine = engine_on(v0, model_version="v0")
    fresh = {name: engine_on(v) for name, v in (("v0", v0), ("v1", v1))}
    try:
        engine.warmup()
        captured = (dict(engine.capture_ms), engine.stats()["captures"])
        bad = copy.deepcopy(v1)
        bad["params"].pop(sorted(bad["params"])[0])
        try:
            engine.swap_variables(bad, "bad")
            fail("swap: a mismatched tree was accepted")
        except ValueError:
            pass
        futs = [engine.submit(s) for s in requests[:-late]]
        while sum(f.done() for f in futs) < len(futs) // 2:
            time.sleep(0.001)
        engine.swap_variables(v1, "v1")     # with requests in flight
        futs += [engine.submit(s) for s in requests[-late:]]
        for s, f in zip(requests, futs):
            res = f.result(timeout=600)
            ref = fresh[f.model_version].forward_single(s, bucket=f.bucket)
            if not all(np.array_equal(a, b) for a, b in zip(res, ref)):
                fail(f"swap: a {f.model_version} result differs from a "
                     "fresh engine's")
        versions = [f.model_version for f in futs]
        k = versions.count("v0")
        if versions != ["v0"] * k + ["v1"] * (len(futs) - k) \
                or not 0 < k <= len(futs) - late:
            fail(f"swap: versions {versions}")
        if (dict(engine.capture_ms), engine.stats()["captures"]) != captured:
            fail("swap: a bucket was captured again")
    finally:
        engine.shutdown()
        for e in fresh.values():
            e.shutdown()
    print(f"swap_variables mid-stream: {len(requests)} requests, {k} served "
          f"by v0 and {len(requests) - k} by v1 (the last {late} submitted "
          f"after the swap), each bitwise a fresh engine's on its weights, "
          f"its version on every future; no capture; a mismatched tree "
          f"refused first (card: {card})", flush=True)
    return dict(fault_outcome=outcome, trip_count=health["trip_count"],
                probe_count=health["probe_count"], swap_bitwise=True)


def serving_phase(torch, device, card, counted, lj_state, csce):
    """Phase 12: MD in the loop, concurrent trajectories, open-loop
    serving with admission bounds, failure semantics and hot swap.
    Returns (record, filter_scatter shapes, segment_sum shapes)."""
    t0 = time.perf_counter()
    md, fs_shapes, seg_shapes = md_in_the_loop(torch, device, card,
                                               counted, lj_state)
    rec = dict(md=md,
               md_clients=md_clients(torch, device, card, counted,
                                     lj_state),
               open_loop=open_loop(torch, device, card, counted, csce),
               faults=fault_and_swap(torch, device, card, csce))
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 12 took {rec['seconds']:.1f} s (card: {card})",
          flush=True)
    return rec, fs_shapes, seg_shapes


# ----------------------------------------------------------- phase 13 --
FARM_TRAJ = (1, 64, 512)       # 216-atom trajectories a farm (phase 12b's)
FARM_STEPS = 64
FARM_K = 8                     # MD steps a dispatch (one graph replay)
FARM_HELD = 4                  # of the T = 64 run, held against run_md
FARM_BIG_TRAJ = 8              # 1,728-atom trajectories (phase 12a's system)
FARM_BIG_STEPS = 32
FARM_BIG_HELD = 2
FARM_E_RTOL = 1e-9             # energies vs the session (the JAX bound)


def farm_engine(torch, device, lj_state, systems):
    """A warmed one-bucket EF engine for `systems`, as phase 12a builds
    its own: `md_buckets` over the largest initial edge count of the
    first 8 (30 % headroom; the systems are one lattice jittered by 0.05,
    and a farm step past the bucket fails the run): (engine, completed
    config, model config, weights label)."""
    from hydragnn_tpu_torch.md.loop import md_buckets
    from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    cfg = md_config()
    frames = [build_graph_sample(nf, p, cfg, cell=c, with_targets=False)
              for p, c, _, nf in systems[:8]]
    done, mcfg, model_on, weights = md_model(lj_state, cfg, frames[:1])
    buckets = md_buckets(len(systems[0][0]),
                         max(f.num_edges for f in frames))
    engine = InferenceEngine(
        model_on(device), mcfg, buckets=buckets, proto_sample=frames[0],
        max_batch_size=1, max_wait_ms=0.0, structure_config=done,
        md_skin=MD_SKIN, ef_forward=True, device=device)
    engine.warmup()
    return engine, done, mcfg, weights


def farm_run(torch, engine, systems, T, steps, k, label, card):
    """systems[:T] through `engine.trajectory_farm`, `steps` steps, k a
    dispatch: (result, record, farm). The record holds the rates, the
    dispatches, the rebuild swaps, the capture, the replays' CUDA-event
    ms and the host's ms a dispatch (status read and swaps), a profiled
    replay's device ms a step, the idle share (1 - replays / wall), the
    memory peak, the graph's kernel nodes and the run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch import kernels as tk
    pos = np.stack([s[0] for s in systems[:T]])
    vel = np.stack([s[2] for s in systems[:T]])
    cell, nf = systems[0][1], systems[0][3]
    farm = engine.trajectory_farm(dt=MD_DT, skin=MD_SKIN,
                                  steps_per_dispatch=k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = tk.launch_counts()
    res = farm.run(pos, vel, steps, node_features=nf, cell=cell)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    launches = {name: after[name] - before[name] for name in after}
    peak = torch.cuda.max_memory_allocated()
    (cap,) = farm.graphs.values()
    nodes = check_graph_kernels(cap, f"farm {label}")
    for key in ("segment_sum_kernel", "filter_scatter_kernel"):
        if not nodes.get(key):
            fail(f"farm {label}: its graph holds no {key} node: {nodes}")
    # one profiled replay: the run is over, every trajectory is inactive
    # and the replay does a dispatch's work without changing the state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cap.graph.replay()
        torch.cuda.synchronize()
    dev_ms, events, _ = profile_rows(torch, prof)
    n = res["atoms"]
    disp = res["dispatches"]
    rec = dict(
        trajectories=T, atoms=n, steps=steps, steps_per_dispatch=k,
        aggregate_steps_per_s=T * steps / res["wall_s"],
        per_traj_steps_per_s=steps / res["wall_s"], wall_s=res["wall_s"],
        dispatches=disp,
        steps_per_dispatch_effective=res["steps_per_dispatch_effective"],
        rebuild_swaps=res["rebuild_swaps"],
        rebuild_fraction=res["rebuild_fraction"],
        cand_capacity=res["cand_capacity"],
        max_degree_capacity=res["max_degree_capacity"],
        capture_ms=res["capture_ms"],
        replay_ms_per_dispatch=res["replay_s"] / disp * 1e3,
        host_ms_per_dispatch=res["host_s"] / disp * 1e3,
        idle_share=1.0 - res["replay_s"] / res["wall_s"],
        profiled_device_ms_per_step=(dev_ms / k if dev_ms
                                     else "not measured"),
        profiled_events_per_replay=events,
        memory_peak_bytes=peak, memory_peak_above_start_bytes=peak - base,
        kernel_nodes=nodes, launches=launches)
    print(f"farm {label}: T={T} x {n} atoms, {steps} steps, K={k}: "
          f"{rec['aggregate_steps_per_s']} steps/s aggregate, "
          f"{rec['per_traj_steps_per_s']} per trajectory ({res['wall_s']} "
          f"s); {disp} dispatches, {rec['steps_per_dispatch_effective']} "
          f"effective steps a dispatch and trajectory; {res['rebuild_swaps']}"
          f" rebuild swaps, rebuild fraction {res['rebuild_fraction']}; "
          f"capture {res['capture_ms']} ms; replay "
          f"{rec['replay_ms_per_dispatch']} ms a dispatch, profiled device "
          f"{rec['profiled_device_ms_per_step']} ms a step ({events} "
          f"device events a replay); host {rec['host_ms_per_dispatch']} ms "
          f"a dispatch; idle share {rec['idle_share']}; memory peak {peak} "
          f"B ({peak - base} above the start); graph kernel nodes {nodes}; "
          f"candidate capacity {res['cand_capacity']}, degree capacity "
          f"{res['max_degree_capacity']} (card: {card})", flush=True)
    return res, rec, farm


def farm_gemm_rows(torch, farm, batch, T):
    """{dense layer: rows, and whether its [T r, in] product and its
    input gradient's [T r, out] @ W equal T products of r rows bitwise}
    at the farm's T-fold shapes, on random inputs from a seed."""
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
    seen = {}

    def hook(name):
        def record(mod, inputs, output):
            seen.setdefault(name, (mod, inputs[0].shape[0]))
        return record
    hooks = [mod.register_forward_hook(hook(name))
             for name, mod in farm.model.named_modules()
             if isinstance(mod, torch.nn.Linear)]
    try:
        energy_forces_from_node_head(farm.model, batch)
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device=batch.pos.device).manual_seed(SEED + 13)
    out = {}
    with torch.no_grad():
        for name, (mod, rows) in sorted(seen.items()):
            r = rows // T
            x = torch.randn(rows, mod.in_features, generator=gen,
                            device=batch.pos.device)
            go = torch.randn(rows, mod.out_features, generator=gen,
                             device=batch.pos.device)
            y, gi = mod(x), go @ mod.weight
            fwd = all(torch.equal(y[t * r:(t + 1) * r],
                                  mod(x[t * r:(t + 1) * r]))
                      for t in range(T))
            bwd = all(torch.equal(gi[t * r:(t + 1) * r],
                                  go[t * r:(t + 1) * r] @ mod.weight)
                      for t in range(T))
            out[name] = dict(rows=rows, rows_per_trajectory=r,
                             features=[mod.in_features, mod.out_features],
                             forward_bitwise=fwd, backward_bitwise=bwd)
    return out


def farm_route_cost(torch, farm, batch):
    """Device ms of the farm's EF forward + backward at `batch`, captured
    in a CUDA graph (median of 10 replays), with every linear layer as
    one product and with the farm's routes (several products where the
    probe found the one product's bits differ from the session's): what
    the routes cost a step."""
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head

    def ef():
        return energy_forces_from_node_head(farm.model, batch)
    out = {}
    for label, ctx in (("one_product", contextlib.nullcontext),
                       ("routed", farm.routed)):
        with ctx():
            graph = capture(torch, ef, ef)
        out[label] = cuda_ms(torch, graph.replay, reps=10)
        del graph
    return out


def hold_farm(res, runs, label):
    """Each (trajectory, run_md result) pair: positions and velocities
    bitwise, energies within FARM_E_RTOL; returns whether the energies
    were bitwise too."""
    bitwise_e = True
    for t, seq in runs:
        if not (np.array_equal(res["final_pos"][t], seq["final_pos"])
                and np.array_equal(res["final_vel"][t], seq["final_vel"])):
            fail(f"farm {label}: trajectory {t} differs from run_md: "
                 f"positions {np.abs(res['final_pos'][t] - seq['final_pos']).max()}"
                 f", velocities "
                 f"{np.abs(res['final_vel'][t] - seq['final_vel']).max()}")
        for key in ("energy_first", "energy_last"):
            got, want = float(res[key][t]), float(seq[key])
            if not np.isclose(got, want, rtol=FARM_E_RTOL, atol=0.0):
                fail(f"farm {label}: trajectory {t} {key} {got} vs run_md "
                     f"{want} (rtol {FARM_E_RTOL})")
            bitwise_e &= got == want
    return bitwise_e


def farm_phase(torch, device, card, counted, lj_state, session_rates):
    """Phase 13: the device-resident trajectory farm (md/farm.py) through
    `InferenceEngine.trajectory_farm`, the MD config of phase 12 with
    phase 6's weights. (a) 216-atom systems (phase 12b's, seeds k and
    100 + k), T = 1, 64 and 512, FARM_STEPS steps, K = FARM_K; (b)
    FARM_BIG_TRAJ systems of 1,728 atoms (phase 12a's, seeds 1 + k and
    2 + 1000 k), FARM_BIG_STEPS steps. Holds: FARM_HELD trajectories of
    T = 64 and FARM_BIG_HELD of (b) equal `run_md(mode="incremental")`
    through the same engine (positions and velocities bitwise, energies
    within FARM_E_RTOL); T = 1 equals trajectory 0 of T = 64; K = 1
    equals K = FARM_K at T = 64; B3 and B4 in every farm graph; the
    registry's farm counters equal the runs'. Printed: each run's
    numbers, the dense layers' row independence at T = 512, and B3's
    and B4's device times at the T-fold shapes. Returns (record,
    filter_scatter shapes, segment_sum shapes)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.md.loop import run_md
    from hydragnn_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                       set_registry)
    t_phase = time.perf_counter()
    reg = MetricsRegistry()
    prev = set_registry(reg)
    fs_shapes, seg_shapes = [], []
    try:
        systems = [md_system(6, k, 100 + k) for k in range(max(FARM_TRAJ))]
        engine, done, mcfg, weights = farm_engine(torch, device, lj_state,
                                                  systems)
        runs, results = {}, {}
        try:
            b = engine.buckets[0]
            print(f"phase 13a: trajectory farm, 216-atom LJ systems, "
                  f"bucket {b.n_node}x{b.n_edge}x{b.n_graph}; {weights}",
                  flush=True)
            for T in FARM_TRAJ:
                tk.reset_launch_counts()
                results[T], runs[f"T{T}"], farm = farm_run(
                    torch, engine, systems, T, FARM_STEPS, FARM_K,
                    f"216 atoms T={T}", card)
                counted(runs[f"T{T}"]["launches"])
                if T == max(FARM_TRAJ):
                    big_batch = farm.batch_now()
                    gemm = farm_gemm_rows(torch, farm, big_batch, T)
                    routes = dict(farm.dense_routes)
                    route_ms = farm_route_cost(torch, farm, big_batch)
                    print(f"farm GEMM rows at T={T}: [T r, in] products "
                          f"vs T products of r rows: " + json.dumps(gemm),
                          flush=True)
                    print(f"farm dense routes at T={T} (trajectories a "
                          f"product): {routes}; the EF "
                          f"forward + backward at the T-fold batch, device "
                          f"ms (one graph): every layer one product "
                          f"{route_ms['one_product']}, routed "
                          f"{route_ms['routed']} (card: {card})",
                          flush=True)
                del farm
            k1, runs["T64_K1"], _ = farm_run(
                torch, engine, systems, FARM_TRAJ[1], FARM_STEPS, 1,
                "216 atoms T=64 K=1", card)
            counted(runs["T64_K1"]["launches"])
            res64 = results[FARM_TRAJ[1]]
            cell, nf = systems[0][1], systems[0][3]
            held = [(t, run_md(engine, done, systems[t][0], systems[t][2],
                               cell, nf, steps=FARM_STEPS, dt=MD_DT,
                               mode="incremental", skin=MD_SKIN))
                    for t in range(FARM_HELD)]
        finally:
            engine.shutdown()
        bitwise_e = hold_farm(res64, held, "T=64")
        for key in ("final_pos", "final_vel"):
            if not np.array_equal(results[1][key][0], res64[key][0]):
                fail(f"farm: T=1 {key} differs from trajectory 0 of T=64")
            if not np.array_equal(k1[key], res64[key]):
                fail(f"farm: K=1 {key} differs from K={FARM_K} at T=64")
        print(f"farm holds (216 atoms): {FARM_HELD} trajectories of T=64 "
              f"bitwise run_md's positions and velocities, energies "
              f"within rtol {FARM_E_RTOL} (bitwise: {bitwise_e}); T=1 = "
              f"trajectory 0 of T=64 and K=1 = K={FARM_K} bitwise; "
              f"{FARM_HELD} sessions' rebuild fractions "
              f"{[s['rebuild_fraction'] for _, s in held]}", flush=True)
        # B4 and B3 at the T-fold shapes, against their plain versions
        fs_rec, seg = check_filter_scatter(torch, big_batch, device,
                                           mcfg.num_filters, dyadic=True)
        tag = f"farm{max(FARM_TRAJ)}"
        fs_shapes += [dict(s, shape=f"{tag}_{s['shape']}",
                           max_abs_err=fs_rec[
                               "max_abs_err" if s["shape"] == "forward"
                               else "backward_max_abs_err"])
                      for s in fs_rec["shapes"]]
        seg_shapes += [dict(s, shape=s["shape"].replace("ef_", f"{tag}_"))
                       for s in seg]
        del big_batch

        # (b) 1,728 atoms
        big = [md_system(MD_ATOMS_PER_DIM, 1 + k, 2 + 1000 * k)
               for k in range(FARM_BIG_TRAJ)]
        engine, done, mcfg, _ = farm_engine(torch, device, lj_state, big)
        try:
            tk.reset_launch_counts()
            res_b, runs["big"], farm = farm_run(
                torch, engine, big, FARM_BIG_TRAJ, FARM_BIG_STEPS, FARM_K,
                f"1,728 atoms T={FARM_BIG_TRAJ}", card)
            counted(runs["big"]["launches"])
            b_batch = farm.batch_now()
            del farm
            held_b = [(t, run_md(engine, done, big[t][0], big[t][2],
                                 big[t][1], big[t][3],
                                 steps=FARM_BIG_STEPS, dt=MD_DT,
                                 mode="incremental", skin=MD_SKIN))
                      for t in range(FARM_BIG_HELD)]
        finally:
            engine.shutdown()
        bitwise_e_b = hold_farm(res_b, held_b, "1,728 atoms")
        fs_rec, seg = check_filter_scatter(torch, b_batch, device,
                                           mcfg.num_filters, dyadic=True)
        tag = f"farm{FARM_BIG_TRAJ}x1728"
        fs_shapes += [dict(s, shape=f"{tag}_{s['shape']}",
                           max_abs_err=fs_rec[
                               "max_abs_err" if s["shape"] == "forward"
                               else "backward_max_abs_err"])
                      for s in fs_rec["shapes"]]
        seg_shapes += [dict(s, shape=s["shape"].replace("ef_", f"{tag}_"))
                       for s in seg]
        print(f"farm (1,728 atoms): {runs['big']['aggregate_steps_per_s']} "
              f"steps/s aggregate over {FARM_BIG_TRAJ} trajectories beside "
              f"phase 12a's session {session_rates['md_incremental']} "
              f"steps/s and phase 12b's {session_rates['md_clients']} "
              f"summed over 8 216-atom sessions; {FARM_BIG_HELD} "
              f"trajectories bitwise run_md's, energies bitwise: "
              f"{bitwise_e_b} (card: {card})", flush=True)
    finally:
        set_registry(prev)
    snap = reg.snapshot()
    want_steps = sum(r["trajectories"] * r["steps"] for r in runs.values())
    want_disp = sum(r["dispatches"] for r in runs.values())
    got_steps = snap["md.farm_steps_total"]["values"][()]
    got_disp = snap["md.farm_dispatches_total"]["values"][()]
    if (got_steps, got_disp) != (want_steps, want_disp):
        fail(f"farm registry: steps {got_steps} dispatches {got_disp}, the "
             f"runs' {want_steps} / {want_disp}")
    events = [e for e in reg.events if e["name"] == "farm_run"]
    if len(events) != len(runs):
        fail(f"farm registry: {len(events)} farm_run events for "
             f"{len(runs)} runs")
    rec = dict(runs=runs, gemm_rows=gemm, dense_routes=routes,
               route_device_ms=route_ms,
               energies_bitwise=dict(t64=bitwise_e, big=bitwise_e_b),
               registry=dict(steps=got_steps, dispatches=got_disp),
               session_rates=session_rates,
               seconds=time.perf_counter() - t_phase)
    print(f"farm registry: md.farm_steps_total {got_steps}, "
          f"md.farm_dispatches_total {got_disp} (the runs' counts); "
          f"phase 13 took {rec['seconds']:.1f} s (card: {card})",
          flush=True)
    return rec, fs_shapes, seg_shapes


# ----------------------------------------------------------- phase 14 --
FLEET_REPLICAS = 2
FLEET_BURSTS = 40              # closed-loop bursts, fleet and single each
FLEET_OPEN_S = 5.0             # seconds of open-loop arrivals with faults
FLEET_OPEN_RATE = 0.5          # of the fleet's closed-loop rate
FLEET_KILL_AT = 0.6            # the injected kill, seconds into the stream
FLEET_CYCLES = 3               # kill-and-restart cycles under the stream
FLEET_CYCLE_GAP_S = 0.5        # stream seconds between two cycles
FLEET_CHILD_REQUESTS = 256     # the fresh process's burst
FLEET_SWAP_S = 1.5             # stream seconds around each hot swap
PUBLISH_STEPS = 3              # SGD steps of the good candidate
PUBLISH_LR = 1e-5
AUTOSCALE_BURSTS = 4           # bursts of the repeated test split at once


def csce_setup(torch):
    """Phase 3's csce PNA data, completed config and seeded weights:
    (base config, splits, model config, Flax variables)."""
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.utils.weights import random_flax_variables
    with open(CSCE_CONFIG) as fh:
        base_cfg = json.load(fh)
    samples = synthetic_molecules(NUM_MOLECULES, seed=SEED)
    n_tr = int(0.6 * NUM_MOLECULES)
    n_va = int(0.2 * NUM_MOLECULES)
    splits = (samples[:n_tr], samples[n_tr:n_tr + n_va],
              samples[n_tr + n_va:])
    cfg = tcfg.update_config(copy.deepcopy(base_cfg), *splits)
    mcfg = tcfg.build_model_config(cfg)
    variables = random_flax_variables(create_model(mcfg, device="cpu"), SEED)
    return base_cfg, splits, mcfg, variables


def csce_engine_factory(mcfg, test, variables, device, store=None):
    """factory(idx) of phase 3's engine configuration (edge list,
    max_batch_size SERVE_MAX_BATCH), each with its own model copy."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.utils.weights import load_jax_variables

    def make(idx=0):
        model = create_model(mcfg, device=device)
        model.load_state_dict(load_jax_variables(variables))
        return InferenceEngine(model, mcfg, reference_samples=test,
                               max_batch_size=SERVE_MAX_BATCH,
                               neighbor_format=False, compile_store=store,
                               model_version="v0", device=device)
    return make


def bucket_name(b) -> str:
    return f"{b.n_node}x{b.n_edge}x{b.n_graph}"


class FleetStream:
    """Seeded Poisson arrivals at `rate` requests/s through `router` on a
    thread, cycling through `requests`, until `stop()`; each future is
    tallied by a done-callback (a future resolves once, so the tally
    equals the futures once all resolved)."""

    def __init__(self, router, requests, rate, seed):
        import threading
        self.router, self.requests, self.rate = router, requests, rate
        self.rng = np.random.default_rng(seed)
        self.futs = []
        self.resolved = 0
        self.errors = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.t0 = time.perf_counter()
        self._thread.start()
        return self

    def _tally(self, fut):
        exc = fut.exception()
        with self._lock:
            self.resolved += 1
            if exc is not None:
                self.errors.append(repr(exc))

    def _run(self):
        at, i = 0.0, 0
        while not self._stop.is_set():
            at += self.rng.exponential(1.0 / self.rate)
            delay = at - (time.perf_counter() - self.t0)
            if delay > 0:
                time.sleep(delay)
            fut = self.router.submit(self.requests[i % len(self.requests)])
            fut.add_done_callback(self._tally)
            self.futs.append(fut)
            i += 1

    def stop(self, timeout=600):
        self._stop.set()
        self._thread.join()
        self.seconds = time.perf_counter() - self.t0
        t_wait = time.perf_counter()
        while True:
            with self._lock:
                if self.resolved == len(self.futs):
                    break
            if time.perf_counter() - t_wait > timeout:
                fail(f"fleet stream: {len(self.futs) - self.resolved} "
                     "futures unresolved")
            time.sleep(0.005)
        return self.futs


def fleet_closed_loop(router, single, requests, card):
    """(a)'s bursts: FLEET_BURSTS of the repeated test split through the
    router and through the single engine, alternating; requests/s over
    the walls, p50/p99 over every request of each, and the host ms the
    caller spends submitting a burst (the router's routing on top of
    the engine's admission)."""
    walls = {"fleet": [], "single": []}
    submit_ms = {"fleet": [], "single": []}
    router.reset_stats()
    single.reset_stats()
    for _ in range(FLEET_BURSTS):
        for name, server in (("fleet", router), ("single", single)):
            t0 = time.perf_counter()
            futs = [server.submit(s) for s in requests]
            submit_ms[name].append((time.perf_counter() - t0) * 1e3)
            for f in futs:
                f.result(timeout=600)
            walls[name].append(time.perf_counter() - t0)
    out = {}
    for name, st in (("fleet", router.stats()), ("single", single.stats())):
        total = len(requests) * FLEET_BURSTS
        out[name] = dict(requests_per_s=total / sum(walls[name]),
                         median_burst_requests_per_s=len(requests)
                         / float(np.median(walls[name])),
                         p50_ms=st["p50_ms"], p99_ms=st["p99_ms"],
                         batches=st["batches"], count=st["count"],
                         submit_ms_median=float(np.median(submit_ms[name])))
        if st["count"] != total:
            fail(f"fleet closed loop: {name} recorded {st['count']} "
                 f"latencies for {total} requests")
    out["per_replica_requests"] = {
        i: st["requests"] for i, st in router.stats()["replicas"].items()}
    print(f"phase 14a: closed loop, {FLEET_BURSTS} bursts of "
          f"{len(requests)} each: fleet of {FLEET_REPLICAS} "
          f"{out['fleet']['requests_per_s']:.1f} requests/s (median burst "
          f"{out['fleet']['median_burst_requests_per_s']:.1f}), p50 "
          f"{out['fleet']['p50_ms']:.3f} ms, p99 {out['fleet']['p99_ms']:.3f}"
          f" ms, {out['fleet']['batches']} batches, submitting a burst "
          f"{out['fleet']['submit_ms_median']:.2f} ms "
          f"({out['per_replica_requests']} by replica); single engine "
          f"{out['single']['requests_per_s']:.1f} requests/s (median burst "
          f"{out['single']['median_burst_requests_per_s']:.1f}), p50 "
          f"{out['single']['p50_ms']:.3f} ms, p99 "
          f"{out['single']['p99_ms']:.3f} ms, {out['single']['batches']} "
          f"batches, submitting {out['single']['submit_ms_median']:.2f} ms "
          f"(card: {card})", flush=True)
    return out


def fleet_child(store_dir: str, out_path: str) -> int:
    """(d) in a fresh process: the kernel build root points at an empty
    temporary directory, one replica warms from the populated store and
    serves a burst; writes its results, buckets, nvcc runs and compile
    counts to `out_path` (npz + json)."""
    import tempfile
    from pathlib import Path

    import torch
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.kernels import _build
    from hydragnn_tpu_torch.utils.devices import CompileStore
    empty = tempfile.mkdtemp(prefix="hydragnn_build_")
    _build.BUILD_ROOT = Path(empty)
    t0 = time.perf_counter()
    device = torch.device("cuda")
    _, splits, mcfg, variables = csce_setup(torch)
    test = splits[2]
    requests = (test * ENGINE_REPEATS)[:FLEET_CHILD_REQUESTS]
    make = csce_engine_factory(mcfg, test, variables, device,
                               CompileStore(store_dir))
    with make() as engine:
        t_warm = time.perf_counter()
        engine.warmup()
        warm_s = time.perf_counter() - t_warm
        tk.reset_launch_counts()
        futs = [engine.submit(s) for s in requests]
        res = [f.result(timeout=600)[0] for f in futs]
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        st = engine.stats()
    np.savez(out_path + ".npz", out=np.stack(res),
             buckets=np.array([[f.bucket.n_node, f.bucket.n_edge,
                                f.bucket.n_graph] for f in futs]))
    installed = sorted(p.name for p in Path(empty).rglob("*.so"))
    with open(out_path + ".json", "w") as fh:
        json.dump(dict(nvcc_runs=_build.nvcc_runs,
                       compile_count=st["compile_count"],
                       compile_store_hits=st["compile_store_hits"],
                       compile_fresh=st["compile_fresh"],
                       captures=st["captures"], launches=counts,
                       installed=installed, warmup_s=warm_s,
                       seconds=time.perf_counter() - t0), fh)
    return 0


def sgd_candidate(torch, mcfg, variables, batch, device, steps, lr):
    """`steps` SGD steps (lr) from `variables` on `batch` through the
    port's train step, with the running statistics put back to the
    served ones: (TrainState, its Flax tree)."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_train_step)
    from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                                  load_jax_variables)
    model = create_model(mcfg, device=device)
    model.load_state_dict(load_jax_variables(variables))
    tx = select_optimizer({"Optimizer": {"type": "SGD",
                                         "learning_rate": lr}})
    state = TrainState.create(model, tx)
    step = make_train_step(model, mcfg, tx)
    for _ in range(steps):
        state, _ = step.eager(state, batch)
    served = load_jax_variables(variables)
    with torch.no_grad():
        for name, t in state.batch_stats.items():
            t.copy_(served[name])
    model.eval()
    return state, export_jax_variables(state)


def fleet_phase(torch, device, card, counted, csce):
    """Phase 14: csce PNA through a ReplicaRouter of FLEET_REPLICAS
    engines (phase 3's configuration and weights) on the card."""
    import gc
    import shutil
    import tempfile

    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.graphs.batch import collate
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.autoscale import QueueDepthAutoscaler
    from hydragnn_tpu_torch.serving.config import (AutoscaleConfig,
                                                   resolve_publish)
    from hydragnn_tpu_torch.serving.fleet import (ReplicaRouter,
                                                  SwapFailedError)
    from hydragnn_tpu_torch.serving.publish import CheckpointPublisher
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    from hydragnn_tpu_torch.utils.checkpoint import save_model
    from hydragnn_tpu_torch.utils.devices import CompileStore
    from hydragnn_tpu_torch.utils.faults import (install_fault_plan,
                                                 parse_fault_plan)
    from hydragnn_tpu_torch.utils.weights import random_flax_variables
    t_phase = time.perf_counter()
    mcfg, test, v0 = csce["mcfg"], csce["test"], csce["variables"]
    requests = csce["requests"]
    v1 = random_flax_variables(create_model(mcfg, device="cpu"), SEED + 1)
    tmp = tempfile.mkdtemp(prefix="hydragnn_fleet_")
    store_dir = f"{tmp}/store"
    store = CompileStore(store_dir)
    rec = {}

    def count(label, need=("pna_edge_aggregate", "segment_sum")):
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        counted(counts)
        for name in need:
            if counts[name] == 0:
                fail(f"fleet {label}: {name} never launched")
        return counts

    try:
        # run_prediction through two replicas sharing a store
        fleet_cfg = copy.deepcopy(csce["base_cfg"])
        fleet_cfg["Serving"] = {"max_batch_size": SERVE_MAX_BATCH,
                                "fleet": {"replicas": FLEET_REPLICAS,
                                          "compile_store": f"{tmp}/rp"}}
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        _, preds_f = run_prediction(fleet_cfg, csce["splits"], v0,
                                    serve=True)
        rp_s = time.perf_counter() - t0
        rp_counts = count("run_prediction", ("nbr_aggregate", "segment_sum"))
        diff = float(np.abs(preds_f[0] - csce["preds"][0]).max())
        rp_bitwise = bool(np.array_equal(preds_f[0], csce["preds"][0]))
        # a request's result depends on its bucket on the card (14a's
        # probe) and the batches a run forms depend on timing: held
        # within SLICE_TOL, its bitwise equality printed
        if preds_f[0].shape != csce["preds"][0].shape or not np.allclose(
                preds_f[0], csce["preds"][0], **SLICE_TOL):
            fail(f"run_prediction through the fleet vs the single engine: "
                 f"max abs diff {diff}")
        rec["run_prediction"] = dict(
            seconds=rp_s, bitwise_single_engine=rp_bitwise,
            max_abs_diff_single_engine=diff, launches=rp_counts,
            store_entries=len(os.listdir(f"{tmp}/rp")))
        print(f"phase 14: run_prediction with Serving.fleet.replicas "
              f"{FLEET_REPLICAS} and a compile store: {rp_s:.2f} s, "
              f"{rec['run_prediction']['store_entries']} store entries; vs "
              f"phase 3's single-engine run_prediction: bitwise "
              f"{rp_bitwise}, max abs diff {diff:.3e}; launches {rp_counts}"
              f" (card: {card})", flush=True)

        # (a) warm-up from the store, the closed loop, bitwise holds
        single = csce_engine_factory(mcfg, test, v0, device)()
        single.warmup()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved(device)
        router = ReplicaRouter(
            csce_engine_factory(mcfg, test, v0, device, store),
            FLEET_REPLICAS)
        reports = router.warmup()
        torch.cuda.synchronize()
        ladder = (torch.cuda.memory_reserved(device) - mem0) / FLEET_REPLICAS
        if not (reports[0]["fresh"] == reports[0]["compiled"] > 0
                and reports[1]["store_hits"] == reports[1]["compiled"]
                and reports[1]["fresh"] == 0):
            fail(f"fleet warm-up reports {reports}")
        print(f"phase 14a: warm-up reports {reports}; one replica's ladder "
              f"{ladder / 2**20:.1f} MiB reserved (card: {card})",
              flush=True)
        tk.reset_launch_counts()
        futs = [router.submit(s) for s in requests]
        first = [f.result(timeout=600) for f in futs]
        a_counts = count("closed loop")
        refs = {}

        def reference(i, bucket):
            key = (i % len(test), bucket)
            if key not in refs:
                refs[key] = single.forward_single(test[i % len(test)],
                                                  bucket=bucket)
            return refs[key]
        mismatched = sum(
            not all(np.array_equal(a, b) for a, b in
                    zip(res, reference(i, f.bucket)))
            for i, (f, res) in enumerate(zip(futs, first)))
        if mismatched:
            fail(f"fleet: {mismatched} of {len(futs)} results differ from "
                 "the single engine's forward on their bucket")
        by_replica = {r: sum(f.replica == r for f in futs)
                      for r in range(FLEET_REPLICAS)}
        # is a request's result the same on every bucket that fits it?
        invariant = True
        for s in test[:8]:
            outs = [single.forward_single(s, bucket=b)[0]
                    for b in single.buckets
                    if s.num_nodes <= b.cap_nodes
                    and s.num_edges <= b.cap_edges]
            invariant &= all(np.array_equal(outs[0], o) for o in outs)
        closed = fleet_closed_loop(router, single, requests, card)
        rec["a"] = dict(warmup=reports, ladder_bytes=ladder,
                        bitwise_requests=len(futs),
                        buckets_checked=sorted({bucket_name(b)
                                                for _, b in refs}),
                        by_replica=by_replica, launches=a_counts,
                        bucket_invariant=bool(invariant), **closed)
        print(f"phase 14a: {len(futs)} routed results bitwise the single "
              f"engine's forward on their bucket ({by_replica} by replica, "
              f"{len(rec['a']['buckets_checked'])} buckets); a request's "
              f"result equal on every bucket that fits it: {invariant}; "
              f"launches {a_counts} (card: {card})", flush=True)

        # (d) a fresh process warms a replica from the populated store
        t0 = time.perf_counter()
        out_path = f"{tmp}/child"
        child = subprocess.run(
            [sys.executable, __file__, "--fleet-replica", store_dir,
             out_path], capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            fail(f"fleet child exited {child.returncode}: "
                 f"{child.stderr[-3000:]}")
        with open(out_path + ".json") as fh:
            d = json.load(fh)
        got = np.load(out_path + ".npz")
        bmap = {(b.n_node, b.n_edge, b.n_graph): b for b in single.buckets}
        diff_d = 0
        for i, (out, bk) in enumerate(zip(got["out"], got["buckets"])):
            want = reference(i, bmap[tuple(int(x) for x in bk)])[0]
            diff_d += not np.array_equal(out, want)
        if d["nvcc_runs"] != 0 or d["compile_fresh"] != 0 or \
                d["compile_store_hits"] != d["compile_count"] or diff_d or \
                d["launches"]["pna_edge_aggregate"] == 0 or \
                d["launches"]["segment_sum"] == 0:
            fail(f"fleet fresh process: {d}, {diff_d} results differ")
        rec["d"] = dict(d, bitwise_requests=len(got["out"]),
                        wall_s=time.perf_counter() - t0)
        print(f"phase 14d: a fresh process with an empty build root: "
              f"{d['nvcc_runs']} nvcc runs, {d['compile_store_hits']} of "
              f"{d['compile_count']} buckets from the store, "
              f"{len(d['installed'])} libraries installed, warm-up "
              f"{d['warmup_s']:.2f} s, {len(got['out'])} results bitwise "
              f"(a)'s, launches {d['launches']}; {rec['d']['wall_s']:.1f} s "
              f"(card: {card})", flush=True)

        # (b) open loop at FLEET_OPEN_RATE x the closed-loop rate: an
        # injected replica-kill, then restarts under the stream
        rate = FLEET_OPEN_RATE * closed["fleet"]["requests_per_s"]
        install_fault_plan(parse_fault_plan(
            f"replica-kill@{int(rate * FLEET_KILL_AT)}"))
        router.reset_stats()
        before = router.health()
        tk.reset_launch_counts()
        stream = FleetStream(router, requests, rate, SEED + 14).start()
        restarts, reserved = [], []
        for cycle in range(FLEET_CYCLES):
            if cycle:
                time.sleep(FLEET_CYCLE_GAP_S)
                router.kill_replica(1)
            t_wait = time.perf_counter()
            while router.kill_count <= before["kills"] + cycle:
                if time.perf_counter() - t_wait > 60:
                    fail("fleet: the injected replica-kill never fired")
                time.sleep(0.001)
            dead = [i for i, h in router.health()["replicas"].items()
                    if not h["alive"]]
            old = router._replicas[int(dead[0])].engine
            restarts.append(router.restart_replica(int(dead[0])))
            old._dispatcher.join(timeout=60)
            reserved.append(torch.cuda.memory_reserved(device))
        install_fault_plan(None)
        rest = FLEET_OPEN_S - (time.perf_counter() - stream.t0)
        if rest > 0:
            time.sleep(rest)
        futs = stream.stop()
        b_counts = count("open loop")
        health, stats = router.health(), router.stats()
        done = health["requests_done"] - before["requests_done"]
        rec["b"] = dict(
            offered_per_s=rate, seconds=stream.seconds, offered=len(futs),
            resolved_callbacks=stream.resolved, requests_done=done,
            failed=len(stream.errors), errors=stream.errors[:5],
            redispatches=health["redispatches"] - before["redispatches"],
            duplicate_resolutions=health["duplicate_resolutions"]
            - before["duplicate_resolutions"],
            stale_failures=health["stale_failures"]
            - before["stale_failures"],
            kills=health["kills"] - before["kills"],
            restarts=restarts, reserved_bytes=reserved,
            p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
            launches=b_counts)
        print(f"phase 14b: open loop {rate:.1f} requests/s for "
              f"{stream.seconds:.2f} s with replica-kill and "
              f"{FLEET_CYCLES} kill-and-restart cycles: offered "
              f"{len(futs)}, resolved {stream.resolved} (router "
              f"{done}), failed {len(stream.errors)}, redispatches "
              f"{rec['b']['redispatches']}, duplicate resolutions dropped "
              f"{rec['b']['duplicate_resolutions']}, stale failures "
              f"{rec['b']['stale_failures']}; restarts fresh "
              f"{[r['fresh'] for r in restarts]}, store hits "
              f"{[r['store_hits'] for r in restarts]}, warm-up s "
              f"{[round(r['warmup_s'], 3) for r in restarts]}; reserved MiB "
              f"after each cycle {[round(m / 2**20, 1) for m in reserved]}"
              f" (one ladder {ladder / 2**20:.1f}); p50 {stats['p50_ms']:.3f}"
              f" ms p99 {stats['p99_ms']:.3f} ms (card: {card})", flush=True)
        if stream.errors or done != len(futs) or \
                stream.resolved != len(futs) or \
                rec["b"]["kills"] != FLEET_CYCLES or \
                any(r["fresh"] for r in restarts) or \
                reserved[-1] - reserved[0] > ladder:
            fail(f"fleet open loop: {rec['b']}")

        # (c) hot swap mid-stream, then an injected swap-fail
        single.swap_variables(v1, "v1")
        tk.reset_launch_counts()
        stream = FleetStream(router, requests, rate, SEED + 15).start()
        time.sleep(FLEET_SWAP_S)
        swap = router.hot_swap(v1, "v1")
        n_after = len(stream.futs)
        time.sleep(FLEET_SWAP_S)
        install_fault_plan(parse_fault_plan("swap-fail@0,1"))
        try:
            router.hot_swap(v0, "v0-bad")
            fail("fleet: the swap-fail injection did not fail the swap")
        except SwapFailedError as exc:
            swap_fail = exc.report
        install_fault_plan(None)
        n_refused = len(stream.futs)
        time.sleep(FLEET_SWAP_S)
        futs = stream.stop()
        c_counts = count("hot swap")
        versions = [f.model_version for f in futs if f.exception() is None]
        late = [f for f in futs[n_after:]]
        post = [(i, f) for i, f in enumerate(futs) if i >= n_after][:16]
        swapped = sum(
            not all(np.array_equal(a, b) for a, b in zip(
                f.result(), single.forward_single(
                    requests[i % len(requests)], bucket=f.bucket)))
            for i, f in post)
        rec["c"] = dict(
            requests=len(futs), failed=len(stream.errors),
            versions=sorted(set(versions)),
            after_swap_versions=sorted({f.model_version for f in late}),
            after_swap_fail_versions=sorted(
                {f.model_version for f in futs[n_refused:]}),
            swap=swap, swap_fail=swap_fail,
            bitwise_after_swap=len(post) - swapped, launches=c_counts)
        print(f"phase 14c: hot swap to v1 under {rate:.1f} requests/s: "
              f"{len(futs)} requests, failed {len(stream.errors)}, versions "
              f"echoed {rec['c']['versions']}, after the swap "
              f"{rec['c']['after_swap_versions']}, after the swap-fail "
              f"injection {rec['c']['after_swap_fail_versions']} (its "
              f"report: failed {[f['replica'] for f in swap_fail['failed']]})"
              f"; {len(post) - swapped} of {len(post)} post-swap results "
              f"bitwise a v1 engine's (card: {card})", flush=True)
        if stream.errors or rec["c"]["versions"] != ["v0", "v1"] or \
                rec["c"]["after_swap_versions"] != ["v1"] or \
                rec["c"]["after_swap_fail_versions"] != ["v1"] or swapped:
            fail(f"fleet hot swap: {rec['c']}")
        router.hot_swap(v0, "v0")
        single.swap_variables(v0, "v0")

        # (e) the publisher, then one autoscaler cycle
        log = "fleet_publish"
        ckpt = f"{tmp}/logs"
        batch = collate(csce["splits"][0][:SERVE_MAX_BATCH]).to(device)
        good, good_vars = sgd_candidate(torch, mcfg, v0, batch, device,
                                        PUBLISH_STEPS, PUBLISH_LR)
        save_model(good, log, path=ckpt, mark_best=True, best_val=1.0)
        tx = select_optimizer({"Optimizer": {"type": "SGD",
                                             "learning_rate": PUBLISH_LR}})
        template = TrainState.create(create_model(mcfg, device=device), tx)
        cfg = dataclasses.replace(
            resolve_publish({}), poll_interval_s=0.05, window_pairs=16,
            min_pairs=8)
        pub = CheckpointPublisher(router, template, log, path=ckpt,
                                  incumbent_variables=v0,
                                  incumbent_version="v0", config=cfg)
        tk.reset_launch_counts()
        stream = FleetStream(router, requests, rate / 2, SEED + 16).start()
        promoted = pub.poll_once()
        with torch.no_grad():
            for t in good.params.values():
                t.view(-1)[0] = float("nan")
        good.step += PUBLISH_STEPS
        save_model(good, log, path=ckpt, mark_best=True, best_val=0.5)
        rolled = pub.poll_once()
        futs = stream.stop()
        health = router.health()
        rec["e_publish"] = dict(
            promoted=promoted, rolled_back=rolled, snapshot=pub.snapshot(),
            requests=len(futs), failed=len(stream.errors),
            fleet_versions=sorted({h["model_version"] for h in
                                   health["replicas"].values()
                                   if h["alive"]}),
            quarantined=health["quarantined_versions"])
        print(f"phase 14e: publisher under {rate / 2:.1f} requests/s: "
              f"best:step_{PUBLISH_STEPS} {promoted and promoted['action']} "
              f"(verdict {promoted and promoted.get('verdict')}); the "
              f"poisoned best:step_{2 * PUBLISH_STEPS} "
              f"{rolled and rolled['action']} (max rel err "
              f"{rolled and rolled.get('verdict', {}).get('max_rel_err')}); "
              f"fleet on {rec['e_publish']['fleet_versions']}, quarantined "
              f"{health['quarantined_versions']}; {len(futs)} requests, "
              f"failed {len(stream.errors)} (card: {card})", flush=True)
        if not promoted or promoted["action"] != "promoted" or \
                not rolled or rolled["action"] != "rolled_back" or \
                stream.errors or rec["e_publish"]["fleet_versions"] != \
                [f"best:step_{PUBLISH_STEPS}"] or \
                f"best:step_{2 * PUBLISH_STEPS}" not in \
                health["quarantined_versions"]:
            fail(f"fleet publisher: {rec['e_publish']}")
        scaler = QueueDepthAutoscaler(router, config=AutoscaleConfig(
            min_replicas=FLEET_REPLICAS, max_replicas=FLEET_REPLICAS + 1,
            high_depth=SERVE_MAX_BATCH / 2, low_depth=0.5, cooldown_s=0.0))
        burst = [router.submit(s) for s in requests * AUTOSCALE_BURSTS]
        up = scaler.step()
        added = router.health()["replicas"].get(str(FLEET_REPLICAS), {})
        for f in burst:
            f.exception(timeout=600)
        down = scaler.step()
        e_counts = count("publisher and autoscaler")
        failed = sum(f.exception() is not None for f in burst)
        rec["e_autoscale"] = dict(
            scale_up=up, scale_down=down, snapshot=scaler.snapshot(),
            added_version=added.get("model_version"),
            burst=len(burst), failed=failed,
            served_by=sorted({f.replica for f in burst
                              if f.exception() is None}),
            launches=e_counts)
        print(f"phase 14e: autoscaler under a burst of {len(burst)}: "
              f"{up and up['action']} (replica {up and up['replica']}, "
              f"signal {up and up['avg_depth']}, fresh compiles "
              f"{up and up['fresh_compiles']}, warm-up "
              f"{up and round(up['warmup_s'], 3)} s, joined on "
              f"{added.get('model_version')}), then {down and down['action']}"
              f" (replica {down and down['replica']}); burst served by "
              f"replicas {rec['e_autoscale']['served_by']}, failed {failed}"
              f" (card: {card})", flush=True)
        if not up or up["action"] != "scale_up" or up["fresh_compiles"] or \
                added.get("model_version") != f"best:step_{PUBLISH_STEPS}" \
                or not down or down["action"] != "scale_down" or failed:
            fail(f"fleet autoscaler: {rec['e_autoscale']}")
        router.shutdown()
        single.shutdown()
        rec["store"] = store.stats()
    finally:
        install_fault_plan(None)
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14 took {rec['seconds']:.1f} s (card: {card})", flush=True)
    return rec


# ----------------------------------------------------------- phase 15 --
A7_MODELS = ("PAINN", "PNAEq", "MACE")
A7_GROUP = 2                   # steps per call timed beside S = 1
A7_SGD_STEPS = 3               # SGD steps held card vs cpu
LATTICE_SGD_LR = 0.05          # DimeNet's lattice SGD steps
A7_REPEATS = 2                 # an EF burst is the test split twice over
A7_BURSTS = 10                 # timed EF bursts of each model
LATTICE_GRAPHS = 160           # tests/test_graphs_full.py's lattice rows
LATTICE_EPOCHS = 60
THRESHOLDS = {"DimeNet": 0.50, "PAINN": 0.60, "PNAEq": 0.60, "MACE": 0.70}
LATTICE_EXTRA = {"MACE": dict(max_ell=2, node_max_ell=1, correlation=[2])}
# tests/utils.py's BASE_CONFIG: the threshold rows' configuration
LATTICE_CONFIG = {
    "Verbosity": {"level": 0},
    "Dataset": {
        "name": "unit_test", "format": "unit_test",
        "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1],
                          "column_index": [0, 6, 7]},
        "graph_features": {"name": ["sum_x_x2_x3"], "dim": [1],
                           "column_index": [0]}},
    "NeuralNetwork": {
        "Architecture": {
            "radius": 1.0, "max_neighbours": 100, "num_gaussians": 10,
            "envelope_exponent": 5, "int_emb_size": 8, "basis_emb_size": 4,
            "out_emb_size": 16, "num_after_skip": 1, "num_before_skip": 1,
            "num_radial": 6, "num_spherical": 7, "num_filters": 16,
            "max_ell": 1, "node_max_ell": 1, "hidden_dim": 8,
            "num_conv_layers": 2, "equivariance": False,
            "output_heads": {"graph": {
                "num_sharedlayers": 2, "dim_sharedlayers": 4,
                "num_headlayers": 2, "dim_headlayers": [10, 10]}},
            "task_weights": [1.0]},
        "Variables_of_interest": {
            "input_node_features": [0], "output_names": ["sum_x_x2_x3"],
            "output_index": [0], "type": ["graph"],
            "denormalize_output": False},
        "Training": {
            "num_epoch": LATTICE_EPOCHS, "perc_train": 0.7,
            "EarlyStopping": False, "patience": 10,
            "loss_function_type": "mse", "batch_size": 32,
            "Optimizer": {"type": "AdamW", "learning_rate": 0.005},
            "task_weights": [1.0]}}}


def a7_config(model_type):
    """LJ.json with `model_type`, equivariance on but for DimeNet, as
    examples/LennardJones/LennardJones.py sets them; its widths as
    published."""
    with open(LJ_CONFIG) as fh:
        cfg = json.load(fh)
    cfg["NeuralNetwork"]["Architecture"].update(
        model_type=model_type, equivariance=model_type != "DimeNet")
    return cfg


def sgd_steps_card_cpu(torch, cfg, splits, device, steps):
    """`steps` captured train steps on the card and eager ones on the CPU
    from one seeded initialization on the first loader batches: each
    loss held within TRAIN_RTOL. Returns the relative gaps."""
    losses = {}
    for dev in (device, "cpu"):
        _, state, step, loader, _, _ = train_parts(torch, cfg, splits, dev)
        loader.set_epoch(0)
        got = []
        for b, _ in zip(loader, range(steps)):
            state, m = step(state, b.to(dev))
            got.append(float(m["loss"]))
        losses[str(dev)] = got
    card, cpu = losses[str(device)], losses["cpu"]
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card, cpu)]
    if not np.isfinite(card).all() or max(gaps) > TRAIN_RTOL:
        fail(f"SGD steps card {card} vs cpu {cpu}: gaps {gaps} above "
             f"{TRAIN_RTOL}")
    return dict(card=card, cpu=cpu, relative_gaps=gaps)


def a7_training(torch, model_type, splits, device, card, counted):
    """(a): one model trained on the energy-force path. Returns (the
    dense run's model, its completed config, record)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    cfg = a7_config(model_type)
    tr = cfg["NeuralNetwork"]["Training"]
    tr["num_epoch"] = LJ_EPOCHS
    bs = int(tr["batch_size"])
    label = f"LJ {model_type} EF"
    sgd = copy.deepcopy(cfg)
    sgd["NeuralNetwork"]["Training"]["Optimizer"] = {
        "type": "SGD", "learning_rate": tr["Optimizer"]["learning_rate"]}
    first = first_step_gradients(torch, sgd, splits, device)
    steps = sgd_steps_card_cpu(torch, sgd, splits, device, A7_SGD_STEPS)
    print(f"{label} first step: loss card vs cpu {first['loss_gap']:.3e}; "
          f"gradients kernels vs plain {first['rel_l2_kernels_plain']:.3e} "
          f"(relative L2, worst tensor; as one vector "
          f"{first['rel_l2_kernels_plain_all']:.3e}), card vs cpu "
          f"{first['rel_l2_card_cpu']:.3e}, cpu float32 vs float64 "
          f"{first['rel_l2_cpu_f64']:.3e}; {A7_SGD_STEPS} SGD steps card "
          f"{steps['card']} vs cpu {steps['cpu']} (relative gaps "
          f"{steps['relative_gaps']}) (card: {card})", flush=True)
    runs, out = {}, None
    for dense, epochs in ((True, LJ_EPOCHS), (False, 1)):
        c = copy.deepcopy(cfg)
        c["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
        c["NeuralNetwork"]["Training"]["num_epoch"] = epochs
        layout = "dense" if dense else "edge list"
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist, model, done = run_training(copy.deepcopy(c),
                                                datasets=splits,
                                                device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tk.launch_counts()
        counted(counts)
        if counts["segment_sum"] == 0:
            fail(f"{label} ({layout}): segment_sum never launched")
        for k in ("train_loss", "val_loss", "test_loss"):
            if not np.isfinite(hist[k]).all():
                fail(f"{label} ({layout}): non-finite {k} {hist[k]}")
        if sum(hist["nonfinite_steps"]) or sum(hist["graph_captures"][1:]):
            fail(f"{label} ({layout}): non-finite steps "
                 f"{hist['nonfinite_steps']} or captures after epoch 0 "
                 f"{hist['graph_captures']}")
        print(f"{label} ({layout}): run_training {epochs} epochs "
              f"({tr['Optimizer']['type']}) in {wall:.2f} s; train "
              f"{hist['train_loss']} val {hist['val_loss']} test "
              f"{hist['test_loss']}; CUDA graphs an epoch "
              f"{hist['graph_captures']}; launches {counts} (card: {card})",
              flush=True)
        runs[layout] = dict(history=hist, wall_s=wall, launches=counts)
        if dense:
            out = (model, done)
    rec = step_metrics(torch, cfg, splits, device, label, bs, A7_GROUP,
                       card=card)
    rec["run"] = dict(first_step=first, sgd_steps=steps, runs=runs)
    return out[0], out[1], rec


def ef_float32_floor(torch, model, batch):
    """The CPU's own float32 rounding of a model's energies and forces
    on `batch`: max |float32 - float64| over real graphs and nodes."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
    outs = []
    for dt in (torch.float32, torch.float64):
        m = create_model(model.cfg, device="cpu").to(dt)
        m.load_state_dict(model.state_dict())
        b = batch.replace(**{k: getattr(batch, k).to(dt) for k in (
            "x", "pos", "edge_shifts") if getattr(batch, k) is not None})
        e, f = energy_forces_from_node_head(m, b)
        outs.append((e.double()[batch.graph_mask],
                     f.detach().double()[batch.node_mask]))
    return max(float((outs[0][0] - outs[1][0]).abs().max()),
               float((outs[0][1] - outs[1][1]).abs().max()))


def a7_serving(torch, model_type, model, test, device, card, counted):
    """(b) for PAINN, PNAEq, MACE: the trained weights served through
    InferenceEngine(ef_forward=True) on the edge list, card vs CPU."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.graphs.batch import collate
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    label = f"LJ {model_type} EF engine"
    mcfg = model.cfg
    requests = test * A7_REPEATS
    results = {}
    for dev in ("cpu", device):
        m = create_model(mcfg, device=dev)
        m.load_state_dict(model.state_dict())
        engine = InferenceEngine(m, mcfg, reference_samples=test,
                                 max_batch_size=SERVE_MAX_BATCH,
                                 neighbor_format=False, ef_forward=True,
                                 device=dev)
        try:
            engine.warmup()
            tk.reset_launch_counts()
            futs = [engine.submit(s) for s in requests]
            results[str(dev)] = [f.result(timeout=600) for f in futs]
            if dev == device:
                torch.cuda.synchronize()
                counts = tk.launch_counts()
                counted(counts)
                if counts["segment_sum"] == 0:
                    fail(f"{label}: segment_sum never launched")
                singles = [(f.bucket, engine.forward_single(s,
                                                            bucket=f.bucket))
                           for s, f in list(zip(requests, futs))[:8]]
                if not all(np.array_equal(r[0], one[0])
                           and np.array_equal(r[1], one[1])
                           for (_, one), r in zip(singles,
                                                  results[str(dev)][:8])):
                    fail(f"{label}: batched != single on one bucket")
                graphs = engine_graphs(torch, engine, requests, label)
                rate = engine_bursts(torch, engine, requests, A7_BURSTS)
        finally:
            engine.shutdown()
    got, want = results[str(device)], results["cpu"]
    e_got = np.concatenate([r[0].reshape(-1) for r in got])
    e_ref = np.concatenate([r[0].reshape(-1) for r in want])
    f_got = np.concatenate([r[1].reshape(-1) for r in got])
    f_ref = np.concatenate([r[1].reshape(-1) for r in want])
    floor = 0.0
    if not (np.allclose(e_got, e_ref, **SLICE_TOL)
            and np.allclose(f_got, f_ref, **SLICE_TOL)):
        floor = ef_float32_floor(torch, model, collate(test[:16]))
    err_e = hold_card_cpu(f"{label} energies", e_got, e_ref, floor)
    err_f = hold_card_cpu(f"{label} forces", f_got, f_ref, floor)
    if not np.abs(f_ref).max() > 0:
        fail(f"{label}: the CPU's forces are all zero")
    print(f"{label}: card vs cpu energies max abs err {err_e:.3e} (of max "
          f"|E| {np.abs(e_ref).max():.3e}), forces {err_f:.3e} (of max |F| "
          f"{np.abs(f_ref).max():.3e}); bound {SLICE_TOL}"
          + (f" or {FLOOR_TIMES:g} x the float32 floor {floor:.3e}"
             if floor else "") + f"; batched = single bitwise; launches "
          f"{counts}; {rate['bursts']} bursts of {rate['requests']} "
          f"requests: {rate['requests_per_s']:.1f} requests/s, p50 "
          f"{rate['p50_ms']:.3f} ms, p99 {rate['p99_ms']:.3f} ms (card: "
          f"{card})", flush=True)
    return dict(energies_card_cpu=err_e, forces_card_cpu=err_f,
                float32_floor=floor, launches=counts, graphs=graphs, **rate)


def dimenet_serving(torch, splits, device, card, counted):
    """(b) for DimeNet (seeded random weights): run_prediction's loop on
    the card and the CPU (the engine takes no triplet tables: the JAX
    package falls back the same way), and the energies and real-node
    forces of the loader's triplet batches, card vs CPU."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.triplets import maybe_triplet_transform
    from hydragnn_tpu_torch.models.create import create_model, data_input_dim
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    label = "LJ DimeNet"
    cfg = a7_config("DimeNet")
    done = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = data_input_dim(tcfg.build_model_config(done), splits[0])
    variables = random_flax_variables(create_model(mcfg, device="cpu"), SEED)
    bs = int(cfg["NeuralNetwork"]["Training"]["batch_size"])
    preds, walls = {}, {}
    for dev in (device, "cpu"):
        m = create_model(mcfg, device=dev)
        m.load_state_dict(load_jax_variables(variables))
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        preds[str(dev)] = run_prediction(copy.deepcopy(cfg), splits,
                                         model=m, device=dev, serve=True)
        if dev == device:
            torch.cuda.synchronize()
            walls["first"] = time.perf_counter() - t0
            counts = tk.launch_counts()
            counted(counts)
            if counts["segment_sum"] == 0:
                fail(f"{label}: segment_sum never launched")
            t0 = time.perf_counter()
            run_prediction(copy.deepcopy(cfg), splits, model=m, device=dev,
                           serve=False)
            torch.cuda.synchronize()
            walls["again"] = time.perf_counter() - t0
    batches = -(-len(splits[2]) // bs)
    (trues, got), (trues_c, want) = preds[str(device)], preds["cpu"]
    if not np.array_equal(trues[0], trues_c[0]):
        fail(f"{label}: run_prediction targets differ, card vs cpu")
    transform = maybe_triplet_transform("DimeNet", splits[0] + splits[1]
                                        + splits[2], bs)
    loader = create_dataloaders(*splits, bs, neighbor_format=False,
                                batch_transform=transform)[2]
    batch = next(iter(loader))
    floor = 0.0
    ef = {}
    for dev in (device, "cpu"):
        m = create_model(mcfg, device=dev)
        m.load_state_dict(load_jax_variables(variables))
        e, f = energy_forces_from_node_head(m, batch.to(dev))
        ef[str(dev)] = (e.cpu().numpy()[batch.graph_mask.numpy()],
                        f.cpu().numpy()[batch.node_mask.numpy()])
        if dev == "cpu":
            cpu_model = m
    (e_got, f_got), (e_ref, f_ref) = ef[str(device)], ef["cpu"]
    if not (np.allclose(got[0], want[0], **SLICE_TOL)
            and np.allclose(e_got, e_ref, **SLICE_TOL)
            and np.allclose(f_got, f_ref, **SLICE_TOL)):
        floor = ef_float32_floor(torch, cpu_model, batch)
    err_p = hold_card_cpu(f"{label} run_prediction", got[0], want[0], floor)
    err_e = hold_card_cpu(f"{label} energies", e_got, e_ref, floor)
    err_f = hold_card_cpu(f"{label} forces", f_got, f_ref, floor)
    rec = dict(prediction_card_cpu=err_p, energies_card_cpu=err_e,
               forces_card_cpu=err_f, float32_floor=floor, launches=counts,
               ms_per_batch=walls["again"] * 1e3 / batches,
               first_call_ms_per_batch=walls["first"] * 1e3 / batches,
               batches=batches, triplets_per_batch=int(
                   batch.triplet_mask.sum()), triplet_budget=int(
                   batch.idx_kj.shape[0]))
    print(f"{label} (random weights, seed {SEED}): run_prediction "
          f"(serve=True falls back to the loop) card vs cpu max abs err "
          f"{err_p:.3e}; {batches} batches of {bs}: "
          f"{rec['ms_per_batch']:.2f} ms a batch (wall, the second call; "
          f"first call {rec['first_call_ms_per_batch']:.2f}); loader batch "
          f"({rec['triplets_per_batch']} triplets of a budget of "
          f"{rec['triplet_budget']}) energies card vs cpu {err_e:.3e}, "
          f"real-node forces {err_f:.3e}; bound {SLICE_TOL}"
          + (f" or {FLOOR_TIMES:g} x the float32 floor {floor:.3e}"
             if floor else "") + f"; launches {counts} (card: {card})",
          flush=True)
    return rec


def lattice_config(model_type):
    """LATTICE_CONFIG for one of the four rows."""
    cfg = copy.deepcopy(LATTICE_CONFIG)
    cfg["NeuralNetwork"]["Architecture"].update(
        model_type=model_type, **LATTICE_EXTRA.get(model_type, {}))
    return cfg


def dimenet_lattice_training(torch, splits, device, card):
    """(c) for DimeNet, its training held on the card on the lattice's
    graph head, whose parameter gradients are finite (LJ's energy-force
    gradient is NaN at the padding triplets, as in JAX, ROADMAP C): the
    first batch's loss card vs CPU and its gradients, kernels vs plain
    versions on the card (`first_step_gradients`) and card vs CPU as one
    vector within the same bound, max(1e-2, 10 x the CPU float32
    gradient's own error against float64); then A7_SGD_STEPS SGD steps
    card vs CPU. The triplet gathers' and scatter's backwards all run
    here."""
    cfg = lattice_config("DimeNet")
    cfg["NeuralNetwork"]["Training"]["Optimizer"] = {
        "type": "SGD", "learning_rate": LATTICE_SGD_LR}
    first = first_step_gradients(torch, cfg, splits, device)
    bound = max(1e-2, 10 * first["rel_l2_cpu_f64_all"])
    if not first["rel_l2_card_cpu_all"] <= bound:
        fail(f"lattice DimeNet first step gradients as one vector: card vs "
             f"cpu relative L2 gap {first['rel_l2_card_cpu_all']} above "
             f"{bound}")
    steps = sgd_steps_card_cpu(torch, cfg, splits, device, A7_SGD_STEPS)
    print(f"lattice DimeNet first step: loss card vs cpu "
          f"{first['loss_gap']:.3e}; gradients kernels vs plain "
          f"{first['rel_l2_kernels_plain']:.3e} (relative L2, worst tensor; "
          f"as one vector {first['rel_l2_kernels_plain_all']:.3e}), card vs "
          f"cpu {first['rel_l2_card_cpu']:.3e} (as one vector "
          f"{first['rel_l2_card_cpu_all']:.3e}; bound {bound:.3e}), cpu "
          f"float32 vs float64 {first['rel_l2_cpu_f64_all']:.3e}; "
          f"{A7_SGD_STEPS} SGD steps (lr {LATTICE_SGD_LR}) card "
          f"{steps['card']} vs cpu {steps['cpu']} (relative gaps "
          f"{steps['relative_gaps']}) (card: {card})", flush=True)
    return dict(first_step=first, sgd_steps=steps)


def lattice_rows(torch, device, card, counted):
    """(c): the four threshold rows of tests/test_graphs_full.py trained
    and predicted on the card, each held under its threshold, and run
    again on the CPU from the same initialization as a witness: every
    epoch's train loss card vs CPU held within TRAIN_RTOL (a row that
    ends in the graph-mean basin on one device only fails here); both
    RMSEs and the graph-mean predictor's are printed. DimeNet's training
    is held besides (`dimenet_lattice_training`)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.graphs.synthetic import bcc_lattices
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    samples = bcc_lattices(LATTICE_GRAPHS, heads=("graph",))
    splits = split_dataset(samples, 0.7)
    out = {"DimeNet_training": dimenet_lattice_training(torch, splits,
                                                        device, card)}
    for model_type in ("DimeNet", "PAINN", "PNAEq", "MACE"):
        cfg = lattice_config(model_type)
        runs = {}
        for dev in (device, "cpu"):
            tk.reset_launch_counts()
            t0 = time.perf_counter()
            state, hist, model, done = run_training(copy.deepcopy(cfg),
                                                    datasets=splits,
                                                    device=dev)
            trues, preds = run_prediction(done, datasets=splits,
                                          state=state, model=model,
                                          device=dev)
            if dev == device:
                torch.cuda.synchronize()
                counts = tk.launch_counts()
                counted(counts)
                if counts["segment_sum"] == 0:
                    fail(f"lattice {model_type}: segment_sum never "
                         "launched")
            runs[str(dev)] = dict(
                rmse=float(np.sqrt(np.mean((trues[0] - preds[0]) ** 2))),
                wall_s=time.perf_counter() - t0,
                train_loss=[float(v) for v in hist["train_loss"]])
        got, cpu = runs[str(device)], runs["cpu"]
        rmse = got["rmse"]
        mean_rmse = float(np.sqrt(np.mean((trues[0] - trues[0].mean())
                                          ** 2)))
        gaps = [abs(a - b) / max(abs(b), 1e-12)
                for a, b in zip(got["train_loss"], cpu["train_loss"])]
        parted = next((i for i, g in enumerate(gaps) if g > TRAIN_RTOL),
                      None)
        print(f"lattice {model_type}: {LATTICE_EPOCHS} epochs on "
              f"{len(splits[0])} graphs, run_training + run_prediction "
              f"{got['wall_s']:.1f} s (cpu witness {cpu['wall_s']:.1f} s); "
              f"test RMSE card {rmse:.4f}, cpu {cpu['rmse']:.4f}, graph-mean "
              f"predictor {mean_rmse:.4f} (threshold "
              f"{THRESHOLDS[model_type]}); final train loss card "
              f"{got['train_loss'][-1]:.4e}, cpu {cpu['train_loss'][-1]:.4e};"
              f" train loss card vs cpu at most {max(gaps):.3e} relative "
              f"over the epochs (bound {TRAIN_RTOL}); launches {counts} "
              f"(card: {card})", flush=True)
        if not np.isfinite(rmse) or rmse >= THRESHOLDS[model_type]:
            fail(f"lattice {model_type}: RMSE {rmse} not under "
                 f"{THRESHOLDS[model_type]}")
        if parted is not None:
            fail(f"lattice {model_type}: train loss card "
                 f"{got['train_loss'][parted]} vs cpu "
                 f"{cpu['train_loss'][parted]} at epoch {parted}, above "
                 f"{TRAIN_RTOL} relative")
        out[model_type] = dict(rmse=rmse, threshold=THRESHOLDS[model_type],
                               cpu_rmse=cpu["rmse"],
                               graph_mean_rmse=mean_rmse,
                               train_loss_gap=max(gaps),
                               wall_s=got["wall_s"],
                               cpu_wall_s=cpu["wall_s"], launches=counts,
                               train_loss=got["train_loss"],
                               cpu_train_loss=cpu["train_loss"])
    return out


def a7_segment_shapes(torch, splits, device, card):
    """(d): segment_sum at each new shape of phase 15's paths, on LJ
    loader batches of LJ.json's batch size (hidden 32), each over the
    layout its path builds once a forward (`aggregation_layouts`, and
    DimeNet's triplet layouts), beside its bound and `index_add`'s time:
    DimeNet's triplet scatter [T, int_emb] -> E by idx_ji and the
    gradient of its [T, int_emb] gather by idx_kj; PAINN's vector
    channel [E, 3 x 32] by receivers; PNAEq's packed statistics
    [E, 2 x 32 + 1]; MACE's l = 0 and l = 1 messages [E, 32 (2l+1)]; the
    dense layout's gather gradient of the vector channel [N K, 96] by
    the table's edge ids; MACE's
    position centring [N, 3] by graph."""
    from hydragnn_tpu_torch.graphs.triplets import make_triplet_transform
    from hydragnn_tpu_torch.kernels.segment import segment_layout
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    cfg = a7_config("DimeNet")
    arch = cfg["NeuralNetwork"]["Architecture"]
    f, bs = int(arch["hidden_dim"]), int(cfg["NeuralNetwork"]["Training"][
        "batch_size"])
    gen = torch.Generator(device=device).manual_seed(SEED)

    def rnd(rows, width, keep):
        return torch.randn(rows, width, device=device,
                           generator=gen) * keep[:, None]
    shapes = []
    transform = make_triplet_transform(splits[0] + splits[1] + splits[2],
                                       bs)
    for dense in (False, True):
        loader = create_dataloaders(*splits, bs, neighbor_format=dense,
                                    batch_transform=transform)[0]
        loader.set_epoch(0)
        b = next(iter(loader)).to(device)
        n, e = b.num_nodes, b.num_edges
        if dense:
            keep = b.nbr_mask.reshape(-1)
            ids = b.nbr_edge.reshape(-1)
            shapes.append(segment_shape(
                torch, "a7_dense_vector_gather_bwd", rnd(keep.shape[0],
                                                         3 * f, keep),
                ids, e, layout=segment_layout(ids, e, keep), card=card))
            continue
        tm = b.triplet_mask
        width = int(arch["int_emb_size"])
        for name, ids in (("dimenet_triplet_scatter", b.idx_ji),
                          ("dimenet_triplet_gather_bwd", b.idx_kj)):
            shapes.append(segment_shape(
                torch, name, rnd(tm.shape[0], width, tm), ids, e,
                layout=segment_layout(ids, e), card=card))
        keep = b.edge_mask
        recv = segment_layout(b.receivers, n, keep)
        for name, width in (("painn_vector_sum", 3 * f),
                            ("pnaeq_edge_statistics", 2 * f + 1),
                            ("mace_l0_messages", f),
                            ("mace_l1_messages", 3 * f)):
            shapes.append(segment_shape(torch, name, rnd(e, width, keep),
                                        b.receivers, n, layout=recv,
                                        card=card))
        shapes.append(segment_shape(torch, "mace_position_centring",
                                    rnd(n, 3, b.node_mask), b.node_graph,
                                    b.num_graphs, card=card))
    return shapes


def a7_phase(torch, device, card, counted, lj_splits):
    """Phase 15: (a) PAINN, PNAEq and MACE trained (`a7_training`), (b)
    served (`a7_serving`; DimeNet `dimenet_serving`), (c) the lattice
    rows and DimeNet's training (`lattice_rows`), (d) segment_sum at the
    new shapes (`a7_segment_shapes`). Returns (record, shapes, the
    phase's launches)."""
    t_phase = time.perf_counter()
    phase_launches = {}

    def count(counts):
        counted(counts)
        for name, c in counts.items():
            phase_launches[name] = phase_launches.get(name, 0) + c
    print(f"phase 15: DimeNet, PAINN, PNAEq, MACE at {LJ_CONFIG}'s widths "
          f"on {sum(len(s) for s in lj_splits)} LJ cells (splits "
          f"{[len(s) for s in lj_splits]}) (card: {card})", flush=True)
    rec = {"training": {}, "serving": {}}
    for model_type in A7_MODELS:
        model, _, rec["training"][model_type] = a7_training(
            torch, model_type, lj_splits, device, card, count)
        rec["serving"][model_type] = a7_serving(
            torch, model_type, model, lj_splits[2], device, card, count)
    rec["serving"]["DimeNet"] = dimenet_serving(torch, lj_splits, device,
                                                card, count)
    rec["lattice"] = lattice_rows(torch, device, card, count)
    shapes = a7_segment_shapes(torch, lj_splits, device, card)
    rec["launches"] = phase_launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15 launches: {phase_launches}; phase 15 took "
          f"{rec['seconds']:.1f} s (card: {card})", flush=True)
    return rec, shapes, phase_launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs the port on "
              "the card only", file=sys.stderr)
        return 2
    try:
        import hydragnn_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import hydragnn_tpu_torch ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 2
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.batch import (collate,
                                                 neighbor_budget_for_dataset,
                                                 BucketSpec,
                                                 with_neighbor_format)
    from hydragnn_tpu_torch.graphs.packing import sample_sizes
    from hydragnn_tpu_torch.kernels import _build
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import (InferenceEngine,
                                                   bucket_ladder,
                                                   select_bucket)
    from hydragnn_tpu_torch.utils.devices import resolve_device
    from hydragnn_tpu_torch.utils.weights import load_jax_variables

    # ---------------------------------------------------------- phase 1
    card = card_line()
    device = resolve_device("cuda")
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s: "
          f"{sorted(libs)}", flush=True)
    for stem, log in sorted(_build.build_log.items()):
        for line in ptxas_report(log):
            print(f"  [{stem}] {line}", flush=True)

    # ------------------------------------------------------------ data
    base_cfg, splits, mcfg, variables = csce_setup(torch)
    samples = [s for split in splits for s in split]
    n_tr, n_va = len(splits[0]), len(splits[1])
    test = splits[2]
    cfg = tcfg.update_config(copy.deepcopy(base_cfg), *splits)
    batch_size = int(cfg["NeuralNetwork"]["Training"]["batch_size"])
    print(f"model: {mcfg.model_type} hidden={mcfg.hidden_dim} "
          f"layers={mcfg.num_conv_layers} input_dim={mcfg.input_dim} "
          f"max_neighbours={cfg['NeuralNetwork']['Architecture']['max_neighbours']} "
          f"batch_size={batch_size} test_requests={len(test)}", flush=True)

    # the batches the serving paths hand the kernels: the largest bucket
    # with SERVE_MAX_BATCH requests, on each layout
    requests = (test * ENGINE_REPEATS)
    first = requests[:SERVE_MAX_BATCH]
    nodes, edges = sample_sizes(test)
    top = select_bucket(bucket_ladder(nodes, edges, SERVE_MAX_BATCH),
                        len(first), sum(s.num_nodes for s in first),
                        sum(s.num_edges for s in first))
    edge_batch = collate(first, n_node=top.n_node, n_edge=top.n_edge,
                         n_graph=top.n_graph)
    dense_batch = with_neighbor_format(
        edge_batch, k=neighbor_budget_for_dataset(samples)).to(device)
    edge_batch = edge_batch.to(device)
    # the loader's shape (room for batch_size largest graphs): its padding
    # graph is one segment of thousands of rows, an edge case of the pooling
    bs = BucketSpec(64)
    loader_batch = collate(
        test[:batch_size],
        n_node=bs.bucket(max(s.num_nodes for s in samples) * batch_size + 1),
        n_edge=bs.bucket(max(s.num_edges for s in samples) * batch_size + 1),
        n_graph=batch_size + 1).to(device)

    # ---------------------------------------------------------- phase 2
    records = check_kernels(torch, dense_batch, edge_batch, loader_batch,
                            device, mcfg.hidden_dim)
    torch.cuda.synchronize()

    # ---------------------------------------------------------- phase 3
    t0 = time.perf_counter()
    trues_cpu, preds_cpu = run_prediction(copy.deepcopy(base_cfg), splits,
                                          variables, serve=False,
                                          device="cpu")
    print(f"cpu reference run: {time.perf_counter() - t0:.1f} s", flush=True)

    launches = {}
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    serve_cfg = copy.deepcopy(base_cfg)
    serve_cfg["Serving"] = {"max_batch_size": SERVE_MAX_BATCH}
    trues, preds = run_prediction(serve_cfg, splits, variables, serve=True)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    print(f"run_prediction(serve=True, dense layout): "
          f"{time.perf_counter() - t0:.2f} s, launches {counts}", flush=True)
    for name in ("nbr_aggregate", "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the run_prediction path")
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c
    if not np.array_equal(trues[0], trues_cpu[0]):
        fail("run_prediction targets differ from the CPU run")
    if preds[0].shape != (len(test), 1) or not np.isfinite(preds[0]).all():
        fail(f"run_prediction predictions: shape {preds[0].shape}, finite "
             f"{np.isfinite(preds[0]).all()}")
    err_rp = float(np.abs(preds[0] - preds_cpu[0]).max())
    if not np.allclose(preds[0], preds_cpu[0], **SLICE_TOL):
        fail(f"run_prediction on the card vs CPU: max err {err_rp}")
    print(f"run_prediction card vs cpu: max abs err {err_rp:.3e} "
          f"(tolerance {SLICE_TOL})", flush=True)

    model = create_model(mcfg, device=device)
    model.load_state_dict(load_jax_variables(variables))
    engine = InferenceEngine(model, mcfg, reference_samples=test,
                             max_batch_size=SERVE_MAX_BATCH,
                             neighbor_format=False, device=device)
    try:
        engine.warmup()
        engine.reset_stats()
        tk.reset_launch_counts()
        futs = [engine.submit(s) for s in requests]
        results = [fut.result(timeout=600) for fut in futs]
        counts = tk.launch_counts()
        singles = [(fut.bucket, engine.forward_single(s, bucket=fut.bucket))
                   for s, fut in list(zip(requests, futs))[:8]]
        # the timed bursts; the main-path burst above was their warm-up
        engine.reset_stats()
        walls = []
        for _ in range(BURSTS):
            t0 = time.perf_counter()
            for fut in [engine.submit(s) for s in requests]:
                fut.result(timeout=600)
            walls.append(time.perf_counter() - t0)
        stats = engine.stats()      # pooled over every request of every burst
        engine_graphs(torch, engine, requests, "csce PNA engine")
    finally:
        engine.shutdown()
    print(f"engine (edge list): launches {counts}", flush=True)
    for name in ("pna_edge_aggregate", "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the engine path")
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c
    got = np.stack([r[0] for r in results[:len(test)]])
    err_eng = float(np.abs(got - preds_cpu[0]).max())
    if not np.isfinite(got).all() or not np.allclose(got, preds_cpu[0],
                                                     **SLICE_TOL):
        fail(f"engine on the card vs CPU: max err {err_eng}")
    bitwise = max(float(np.abs(res[0] - single[0]).max())
                  for (_, single), res in zip(singles, results[:8]))
    print(f"engine card vs cpu: max abs err {err_eng:.3e}; batched vs "
          f"single on the same bucket: max abs diff {bitwise:.3e}",
          flush=True)
    total = len(requests) * BURSTS
    if stats["count"] != total:
        fail(f"engine recorded {stats['count']} latencies for {total} "
             "requests")
    med = float(np.median(walls))
    slow = [w for w in walls if w > 2 * med]
    half = BURSTS // 2
    print(f"engine bursts: median {len(requests) / med:.1f} requests/s "
          f"(fastest {len(requests) / min(walls):.1f}, slowest "
          f"{len(requests) / max(walls):.1f}); {len(slow)} of {BURSTS} took "
          f"over twice the median wall, {sum(slow) - len(slow) * med:.4f} s "
          f"beyond it; first half {len(requests) * half / sum(walls[:half]):.1f}"
          f", second half "
          f"{len(requests) * (BURSTS - half) / sum(walls[half:]):.1f} "
          "requests/s", flush=True)
    print(f"engine: {total} requests in {BURSTS} bursts of {len(requests)} "
          f"(each submitted at once), {stats['batches']} batches, "
          f"{sum(walls):.4f} s: {total / sum(walls):.1f} requests/s; over "
          f"all requests p50 {stats['p50_ms']:.3f} ms, p99 "
          f"{stats['p99_ms']:.3f} ms (card: {card})", flush=True)

    breakdown(torch, model, first, top, dense_batch, edge_batch, card)

    # ---------------------------------------------------------- phase 4
    records["filter_scatter"], seg_shapes, counts, lj = schnet_phase(
        torch, device, card)
    records["segment_sum"]["shapes"] += seg_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in seg_shapes])
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c

    # ---------------------------------------------------------- phase 5
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders

    def counted(counts):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    loader = create_dataloaders(*splits, batch_size, neighbor_format=True)[0]
    loader.set_epoch(0)
    train_batch = next(iter(loader)).to(device)
    steps_per_epoch = len(loader)
    print(f"phase 5: csce PNA training, {len(splits[0])} train molecules, "
          f"batch {batch_size}, {steps_per_epoch} steps an epoch; loader "
          f"batch N={train_batch.num_nodes} E={train_batch.num_edges} "
          f"K={train_batch.nbr.shape[1]}", flush=True)
    records.update(check_pna_backwards(torch, train_batch, device,
                                       mcfg.hidden_dim))
    records["nbr_aggregate"]["loader"] = records.pop("nbr_aggregate.loader")
    epochs = int(base_cfg["NeuralNetwork"]["Training"]["num_epoch"])
    (state, t_model, completed), counts, pna_rec = training_phase(
        torch, "csce PNA (dense)", base_cfg, splits, device, epochs,
        batch_size, counted)
    for name in ("nbr_aggregate", "nbr_aggregate_backward", "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the dense training path")
    edge_cfg = copy.deepcopy(base_cfg)
    edge_cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    edge_cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    tk.reset_launch_counts()
    _, h_edge, _, _ = run_training(copy.deepcopy(edge_cfg), datasets=splits,
                                   device=device)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    counted(counts)
    print(f"csce PNA (edge list) 1 epoch on the card: train "
          f"{h_edge['train_loss']} val {h_edge['val_loss']}; launches "
          f"{counts}", flush=True)
    for name in ("pna_edge_aggregate", "pna_edge_aggregate_backward",
                 "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the edge-list training path")
    if not np.isfinite(h_edge["train_loss"]).all():
        fail("edge-list training: non-finite loss")
    trues_t, preds_t = run_prediction(completed, splits, state=state,
                                      model=t_model)
    _, preds_tc = run_prediction(completed, splits, state=state,
                                 model=t_model, device="cpu")
    err_tp = float(np.abs(preds_t[0] - preds_tc[0]).max())
    if preds_t[0].shape != (len(test), 1) or not np.isfinite(
            preds_t[0]).all() or not np.allclose(preds_t[0], preds_tc[0],
                                                 **SLICE_TOL):
        fail(f"run_prediction from the trained state: shape "
             f"{preds_t[0].shape}, card vs cpu max err {err_tp}")
    rmse = float(np.sqrt(np.mean((preds_t[0] - trues_t[0]) ** 2)))
    print(f"run_prediction from the trained state: card vs cpu max abs err "
          f"{err_tp:.3e}; test RMSE {rmse:.4f}", flush=True)
    train_paths = {"csce_pna_dense": step_metrics(
        torch, base_cfg, splits, device, "csce PNA (dense)", batch_size,
        CSCE_GROUP)}
    train_paths["csce_pna_edge"] = step_metrics(
        torch, edge_cfg, splits, device, "csce PNA (edge list)", batch_size,
        CSCE_GROUP)
    train_paths["csce_pna_dense"]["run"] = pna_rec

    # ---------------------------------------------------------- phase 6
    from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
    with open(LJ_CONFIG) as fh:
        lj_cfg = json.load(fh)
    # the edge list, the layout the EF engine serves and kernel 4 walks
    # (run_training's default is the dense layout)
    lj_cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    lj_samples = lj_configurations(NUM_LJ, seed=SEED)
    lj_splits = (lj_samples[:n_tr], lj_samples[n_tr:n_tr + n_va],
                 lj_samples[n_tr + n_va:])
    lj_bs = int(lj_cfg["NeuralNetwork"]["Training"]["batch_size"])
    print(f"phase 6: LJ SchNet energy-force training, {len(lj_splits[0])} "
          f"train cells, batch {lj_bs}, {LJ_EPOCHS} epochs (LJ.json: "
          f"{lj_cfg['NeuralNetwork']['Training']['num_epoch']}, cut for "
          "time; widths as published), edge list", flush=True)
    lj_main, counts, lj_rec = training_phase(torch, "LJ SchNet EF", lj_cfg,
                                             lj_splits, device, LJ_EPOCHS,
                                             lj_bs, counted)
    for name in ("filter_scatter", "filter_scatter_backward",
                 "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the EF training path")
    lj_cfg_cut = copy.deepcopy(lj_cfg)
    lj_cfg_cut["NeuralNetwork"]["Training"]["num_epoch"] = LJ_EPOCHS
    train_paths["lj_schnet_ef"] = step_metrics(
        torch, lj_cfg_cut, lj_splits, device, "LJ SchNet EF", lj_bs,
        LJ_GROUP)
    train_paths["lj_schnet_ef"]["run"] = lj_rec
    for rec in (pna_rec, lj_rec):
        rec.pop("history")

    # ---------------------------------------------------------- phase 7
    bf16_launches = {}

    def counted_bf16(counts):
        counted(counts)
        for name, c in counts.items():
            bf16_launches[name] = bf16_launches.get(name, 0) + c

    print("phase 7: bf16 through the kernels' bf16 instantiations, at the "
          "published widths", flush=True)
    bf16_records = check_bf16_kernels(torch, dense_batch, edge_batch,
                                      lj["batch"], device, mcfg.hidden_dim,
                                      lj["mcfg"].num_filters)
    serving_bf16 = pna_bf16_serving(torch, device, card, base_cfg, splits,
                                    variables, mcfg, preds, counted_bf16)
    lj_serving_bf16 = lj_bf16_serving(torch, device, lj, counted_bf16)
    bf16_runs = {
        "csce_pna_dense_bf16": bf16_training_phase(
            torch, "csce PNA (dense)", base_cfg, splits, device, epochs,
            counted_bf16, ("nbr_aggregate_bf16", "nbr_aggregate_backward",
                           "nbr_aggregate_backward_bf16", "segment_sum")),
        "csce_pna_edge_bf16": bf16_training_phase(
            torch, "csce PNA (edge list)", edge_cfg, splits, device, 1,
            counted_bf16, ("pna_edge_aggregate_bf16",
                           "pna_edge_aggregate_backward",
                           "pna_edge_aggregate_backward_bf16",
                           "segment_sum")),
        "lj_schnet_ef_bf16": bf16_training_phase(
            torch, "LJ SchNet EF", lj_cfg, lj_splits, device, LJ_EPOCHS,
            counted_bf16, ("filter_scatter_bf16",
                           "filter_scatter_backward_bf16", "segment_sum"),
            hold_history=False)}
    lj_bf16_cfg = copy.deepcopy(lj_cfg)
    lj_bf16_cfg["NeuralNetwork"]["Architecture"]["dtype"] = "bfloat16"
    bf16_runs["lj_schnet_ef_bf16"].update(
        first_step_gradients=lj_bf16_gradients(torch, lj_bf16_cfg,
                                               lj_splits, device),
        sgd_steps=lj_sgd_steps(torch, lj_cfg, lj_splits, device))
    for key, cfg_, data, label, graphs, group in (
            ("csce_pna_dense_bf16", base_cfg, splits, "csce PNA (dense)",
             batch_size, CSCE_GROUP),
            ("csce_pna_edge_bf16", edge_cfg, splits,
             "csce PNA (edge list)", batch_size, CSCE_GROUP),
            ("lj_schnet_ef_bf16", lj_cfg_cut, lj_splits, "LJ SchNet EF",
             lj_bs, LJ_GROUP)):
        cfg_ = copy.deepcopy(cfg_)
        cfg_["NeuralNetwork"]["Architecture"]["dtype"] = "bfloat16"
        train_paths[key] = step_metrics(torch, cfg_, data, device,
                                        f"{label} bf16", graphs, group)
        train_paths[key]["run"] = bf16_runs[key]
    train_paths["csce_pna_engine_bf16"] = serving_bf16
    train_paths["lj_ef_engine_bf16"] = lj_serving_bf16
    print(f"phase 7 launches (bf16 main paths): {bf16_launches}; "
          f"segment_sum on the float32-accumulated sums: "
          f"{bf16_launches['segment_sum']}", flush=True)

    # ---------------------------------------------------------- phase 8
    resume = resume_phase(torch, device, base_cfg, splits, counted)

    # ---------------------------------------------------------- phase 9
    print("phase 9: batch packing, csce PNA at its published width",
          flush=True)
    train_paths.update(packing_phase(torch, base_cfg, splits, device,
                                     batch_size, counted, train_paths))
    packed_loader = create_dataloaders(*splits, batch_size,
                                       neighbor_format=False, packing=True)[0]
    packed_loader.set_epoch(0)
    packed_batch = next(iter(packed_loader)).to(device)

    # ---------------------------------------------------------- phase 10
    eam_paths, eam_shapes = eam_phase(torch, device, counted, packed_batch)
    train_paths.update(eam_paths)
    records["segment_sum"]["shapes"] += eam_shapes

    # ---------------------------------------------------------- phase 11
    slice_records, slice_shapes = slice_phase(torch, device, card, counted)
    train_paths.update(slice_records)
    records["segment_sum"]["shapes"] += slice_shapes

    # ---------------------------------------------------------- phase 12
    csce = dict(model=model, mcfg=mcfg, test=test, requests=requests,
                variables=variables)
    serving, md_fs_shapes, md_seg_shapes = serving_phase(
        torch, device, card, counted, lj_main[0], csce)
    records["filter_scatter"]["shapes"] += md_fs_shapes
    records["filter_scatter"]["max_abs_err"] = max(
        [records["filter_scatter"]["max_abs_err"]]
        + [r["max_abs_err"] for r in md_fs_shapes])
    records["segment_sum"]["shapes"] += md_seg_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in eam_shapes + slice_shapes
           + md_seg_shapes])
    # ---------------------------------------------------------- phase 13
    farm, farm_fs_shapes, farm_seg_shapes = farm_phase(
        torch, device, card, counted, lj_main[0],
        dict(md_incremental=serving["md"]["modes"]["incremental"][
            "steps_per_s"], md_clients=serving["md_clients"]["steps_per_s"]))
    records["filter_scatter"]["shapes"] += farm_fs_shapes
    records["filter_scatter"]["max_abs_err"] = max(
        [records["filter_scatter"]["max_abs_err"]]
        + [r["max_abs_err"] for r in farm_fs_shapes])
    records["segment_sum"]["shapes"] += farm_seg_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in farm_seg_shapes])
    farm_launches = {}
    for run in farm["runs"].values():
        for name, c in run["launches"].items():
            farm_launches[name] = farm_launches.get(name, 0) + c

    # ---------------------------------------------------------- phase 14
    fleet = fleet_phase(torch, device, card, counted,
                        dict(csce, base_cfg=base_cfg, splits=splits,
                             preds=preds))
    fleet_launches = {}
    for part in ("a", "b", "c"):
        for name, c in fleet[part]["launches"].items():
            fleet_launches[name] = fleet_launches.get(name, 0) + c

    # ---------------------------------------------------------- phase 15
    a7, a7_shapes, a7_launches = a7_phase(torch, device, card, counted,
                                          lj_splits)
    records["segment_sum"]["shapes"] += a7_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in a7_shapes])

    print("training: " + json.dumps({"card": card, "paths": train_paths,
                                     "resume": resume,
                                     "serving_graphs": SERVING_GRAPHS}),
          flush=True)
    print("serving: " + json.dumps(dict(serving, card=card)), flush=True)
    print("farm: " + json.dumps(dict(farm, card=card)), flush=True)
    print("fleet: " + json.dumps(dict(fleet, card=card)), flush=True)
    print("a7: " + json.dumps(dict(a7, card=card)), flush=True)

    for name, c in launches.items():
        if c == 0:
            fail(f"{name} never launched on the main path")
    sources = {"segment_sum": ("hydragnn_tpu_torch/csrc/segment_sum.cu",
                               "hydragnn_tpu/kernels/segment_pallas.py:98"),
               "nbr_aggregate": ("hydragnn_tpu_torch/csrc/nbr_aggregate.cu",
                                 "hydragnn_tpu/kernels/nbr_pallas.py:134"),
               "pna_edge_aggregate": (
                   "hydragnn_tpu_torch/csrc/pna_edge_aggregate.cu",
                   "hydragnn_tpu/kernels/fused_mp_pallas.py:389"),
               "filter_scatter": (
                   "hydragnn_tpu_torch/csrc/filter_scatter.cu",
                   "hydragnn_tpu/kernels/fused_mp_pallas.py:187")}
    def per_captured_step(counter):
        """{training path: launches of `counter` in its captured step}."""
        return {path: rec["kernel_launches_per_captured_step"][counter]
                for path, rec in train_paths.items()
                if counter in rec.get("kernel_launches_per_captured_step",
                                      {})}
    kernels = []
    for name in ("segment_sum", "nbr_aggregate", "pna_edge_aggregate",
                 "filter_scatter"):
        src, rep = sources[name]
        extra = ({"backward_launches": launches["filter_scatter_backward"]}
                 if name == "filter_scatter" else {})
        if name in bf16_records:
            extra["bf16"] = dict(launches=launches[f"{name}_bf16"],
                                 **bf16_records[name])
        extra["launches_per_captured_step"] = per_captured_step(name)
        if name in serving["md"]["launches"]:
            extra["launches_md_path"] = serving["md"]["launches"][name]
        if fleet_launches.get(name):
            extra["launches_fleet_path"] = fleet_launches[name]
        if farm_launches.get(name):
            extra["launches_farm_path"] = farm_launches[name]
            if name == "filter_scatter":
                extra["backward_launches_farm_path"] = farm_launches[
                    "filter_scatter_backward"]
        if a7_launches.get(name):
            extra["launches_a7_path"] = a7_launches[name]
        if name == "filter_scatter":
            extra["backward_launches_per_captured_step"] = \
                per_captured_step("filter_scatter_backward")
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=launches[name],
                            **extra, **records[name]))
    # the two PNA Functions' backward kernels (the TPU kernels' custom
    # VJPs remat in XLA at the lines given); plain_ms is the torch-op VJP's
    for name, rep, counter in (
            ("nbr_aggregate.backward",
             "hydragnn_tpu/kernels/nbr_pallas.py:149",
             "nbr_aggregate_backward"),
            ("pna_edge_aggregate.backward",
             "hydragnn_tpu/kernels/fused_mp_pallas.py:374",
             "pna_edge_aggregate_backward")):
        rec = dict(records[name])
        rec["bf16"] = dict(launches=launches[f"{counter}_bf16"],
                           **rec["bf16"])
        kernels.append(dict(name=name, route="cuda",
                            source="hydragnn_tpu_torch/csrc/pna_backward.cu",
                            replaces=rep, launches=launches[counter],
                            launches_per_captured_step=per_captured_step(
                                counter),
                            **rec))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-replica"]:
        sys.exit(fleet_child(*sys.argv[2:4]))
    sys.exit(main())
