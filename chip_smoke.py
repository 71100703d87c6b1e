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
   over a burst of the test split repeated 8 times, then 80 timed
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
   the 512 slabs of the OC20 example's extxyz chunks
   (`generate_oc20_dataset`, 8 chunks of 64 frames, read by
   `datasets.atomistic.load_oc20` at radius 5 and max_neighbours 512, as
   the example's train.py reads them), and qm9.json's GIN (hidden 5,
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
   one-bucket engine, T = 1, 64 and 512 trajectories, 64 steps (T =
   512: 16, for time), 8 a dispatch (one CUDA graph replay of 8 steps: drift, the skin check,
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
   CPU from the same initialization as a witness for its first 12
   epochs, each of their train losses within rtol 1e-3 of the card's;
   DimeNet's training on the
   lattice's graph head (its parameter gradients are finite there): the
   first step as in (a), its gradients card vs CPU as one vector, and 3
   SGD steps card vs CPU. (d) segment_sum at each new shape of these
   paths, held against its plain version, with its bound and
   `index_add`'s time. Every path holds B3 launched.
16. csce PNA on its users' data and training telemetry (`smiles_phase`,
   run after phase 9, beside the csce numbers it is read against),
   each number beside the card's name and power limit. (a)
   examples/csce/csce_gap.json at its published width (hidden 200, 6
   layers, batch 128) on 2,048 molecules of the csce example's CSV
   (`generate_csce_csv`) featurized into bond graphs
   (`datasets.smiles.csce_splits`: 12 node columns, in-degree at most 4)
   on both layouts: the first step (loss card vs CPU within rtol 1e-4 /
   atol 1e-5, gradients kernels vs plain), captured = eager bitwise and
   the step numbers (`step_metrics`), printed beside phase 5's and 9's
   radius-graph steps with the two data's in-degrees; run_training on
   the edge list (1 epoch); an InferenceEngine (edge list, seeded
   weights) over the test split repeated 8 times (batched = single
   bitwise, finite) and SLICE_BURSTS timed bursts beside phase 3's
   rate and p99. (c) The dense main path: run_training for 3 epochs
   with Training.Telemetry.enabled and Profile {enable: 1, target_epoch:
   1}: telemetry.jsonl, trace.json, metrics.prom and the epoch's
   profiler trace exist and parse; every epoch's train_mfu in (0, 1];
   the FLOP probe (`step_cost_flops`) equal on the kernel route and the
   plain route, and equal to the session's; the last epoch's achieved
   FLOP/s within 10 % of the probe's FLOPs over a CUDA-event-timed
   captured step, fed the loader's host batch as run_training feeds it
   (its copy to the card is in the trainer's step time too); and the
   session's cost, host ms a captured step with
   and without it. B1, B2 and B3 launched on these paths ((b) is phase
   11's data).
17. The int8 serving tier, remat and the training fault sites
   (`quant_phase`, quant/, serving/engine.py at compute_dtype "int8",
   models/base.py remat, the fault sites), run after phase 15 on phase
   3's csce PNA engine configuration (hidden 200, 6 layers, edge list,
   max_batch_size 128) with phase 3's weights and requests, each number
   beside the card's name and power limit. (a) Calibration on the card
   on 32 test samples (seconds; two passes bitwise; a merge of 4 shards
   bitwise one pass; scales card vs CPU); an int8 and a float32 engine
   over phase 3's burst: the int8 breadcrumbs, the largest gap over the
   2^-3 bound against the float32 engine (printed, with the CPU's on
   the same scales: the reference's own int8 tier misses it on these
   molecules, ROADMAP C) and held within it on the test molecules
   without an isolated atom (an int8 engine calibrated on them), card
   int8 vs CPU int8 within 1e-3 max abs, and the eager int8 forward of
   one batch too (the x_q elements that differ printed), `int8_dense` on
   identical inputs (x_q, w_q, s_w, the int32 accumulator) bitwise card
   vs CPU, batched = single, the bucket graph = its eager forward, a
   `swap_variables` equal to a fresh int8 engine on the new weights with
   no recapture; 20 bursts of each engine in turn (requests/s, p50, p99)
   and one post_nn product's device ms, int8 (quantize and dequantize
   included) beside the float32 matmul. B2 and B3 launched. (b) A
   ReplicaRouter of one int8 and one float32 replica under
   TierPolicy(priority_min=1, quota=0.25), half the burst at priority
   1: dispatch shares (float32 within its quota), downgrades; each
   future's tier, replica and bound agree; the int8 replica killed, the
   test split falls back to float32 with 0 futures lost. (c)
   `distill_heads` (8 steps at lr 3e-4, 32 molecules without an
   isolated atom) twice bitwise, with an update kept (best step > 0,
   the head MSE lower); the same on the first 32 test molecules
   printed.
   (d) The dense csce training step with Training.conv_checkpointing:
   loss and every gradient bitwise the step without it, captured =
   eager (`graph_parity`), each captured step's kernel nodes = its
   launches (the recompute's included), peak allocated MiB and captured
   step ms beside the step without remat. (e) run_training for 3
   epochs with Checkpoint, killed by a forward-step plan in epoch 1 and
   resumed with `continue: 1`: the trajectory bitwise the uninterrupted
   run's.
18. Data-parallel training (hydragnn_tpu_torch/parallel/), run last, on
   phase 3's csce data at csce_gap.json's width. (a) A world-1 NCCL group
   in this process (`init_distributed` over tcp://localhost): one dense
   epoch of run_training, captured (the forward + backward graph, the
   all-reduce between the graphs, the update graph), bitwise the same
   epoch with no group; the SPMD step's ms and its collectives' ms beside
   the single-device step's on the loader's batch. (b) Two ranks sharing
   the card over gloo, children of this script (`--spmd-rank`), each with
   a time bound: run_training with num_shards=2 for one epoch with the
   config's AdamW, ZeRO off then on (the default 2^14 threshold), then
   with SGD on the card and on the CPU in the same group: the ranks
   bitwise each other, ZeRO bitwise no ZeRO, SGD card vs CPU within
   TRAIN_RTOL / EVAL_RTOL (phase 5's standing bound, which it holds on
   SGD too); each rank's optimizer-state bytes, its step ms and the
   collectives' share of it (timed alone: the work before them is
   waited for first). (c) LJ SchNet EF with
   num_shards=2 for two steps (HYDRAGNN_MAX_NUM_BATCH), so B4 runs on
   both ranks. B1 (and its backward), B3 and B4 launched.

19. Pipeline parallelism (hydragnn_tpu_torch/parallel/pipeline*.py),
   run last, its stages on 4 streams of the one card
   (`pipeline_devices=[cuda:0] * 4`, printed). (a)
   examples/deep_stack/deep_stack_32l.json at its published width
   (SchNet, hidden 64, 32 layers, 4 stages x 8 microbatches, 1f1b, full
   remat) on 512 BCC lattices at its radius 2.0 and max_neighbours 64, on
   the edge list so B4 runs in every block: run_training for 2 epochs,
   captured (finite, the train loss falls); one SGD step card vs CPU
   from the same seed (HYDRAGNN_MAX_NUM_BATCH=1): its loss within rtol
   1e-4, the val / test losses after it within EVAL_RTOL; the captured
   step's ms and one profiled replay's device ms.
   (b) At that shape: the pipelined forward bitwise the sequential one,
   remat on bitwise off (one step's parameters), captured bitwise eager,
   gpipe bitwise 1f1b and the sequential stack on exactly representable
   data (integer features, quarter-integer weights, one in-edge a node);
   the peak allocated MiB of one step under gpipe without remat and
   under 1f1b with full remat; the captured step's ms on 4 streams and
   on one, beside the closed-form train bubble. (c) csce_gap.json (6
   layers, width 200) with pipeline_stages 2 for one epoch, dense: B1
   and its backward inside the stages. (d) LJ.json (equivariant SchNet,
   a node mlp head) with pipeline_stages 2 on the edge list, two steps:
   the coordinates ride the carried activation and B4's double backward
   runs through the stages. B1, B3 and B4 launched.

20. Graph parallelism and the pipeline's data axis (hydragnn_tpu_torch/
   parallel/graph_parallel.py, composite.py, pipeline_trainer.py), run
   last, the slots and rings on streams of the one card. (a) The
   edge-sharded and ring layers on 4 streams, forward and VJP, on a
   graph of N 131,072 nodes, E 4,194,304 edges and F 64 made from the
   seed (the [E, F] messages 1 GiB; a stand-in for a structure too
   large for one card, not chemistry), held against the single-device
   B3 sum within SUM_TOL and bitwise on dyadic data; each mode's ms, B3's
   launches a slot and the peak allocated MiB beside the single-device
   route; B3 at the slot and ring-bucket shapes (`segment_shape`). (b)
   csce_gap.json with graph_shards 2 through run_training, one epoch of
   SGD, with num_shards 1 (2 slots) and 2 (4 slots): finite, B3 inside
   the shards and no fused PNA kernel; num_shards 1 held against the
   single-device edge-list run on the card within rtol 2e-3 / atol 1e-5
   (JAX's bound); the first composed SGD step card vs CPU
   (`first_step_card_cpu`: the loss and the parameters after it within
   1e-4, the update as one vector within the gradients' standing bound);
   the captured composed step bitwise the eager one; its ms beside the
   single-device captured step's. (c) LJ.json with graph_shards 2, two
   steps: B4 forward and dh inside the shards, finite, the first step
   card vs CPU as in (b). (d) csce PNA (dense) over 2 stages x 2 data
   shards x 2 microbatches: the loss bitwise the pipe-only run's on the
   same 4 microbatches, the parameters after two SGD steps within rtol
   5e-6 / atol 1e-7, AdamW with ZeRO bitwise without, B1 and its
   backward inside the stages of each pipe x data run, the step's ms
   beside pipe-only's. The reference runs (the single-device B3 sum and
   edge-list run, the pipe-only run) are counted apart from the graph
   slots' and rings' launches.

21. Multi-dataset GFM training (hydragnn_tpu_torch/parallel/
   multidataset.py, train/gfm.py, telemetry/gfm.py, examples/gfm.py,
   examples/multidataset.py). (a) examples/gfm/gfm_mixture.json at its
   published width (GIN, hidden 32, 3 conv layers, 3 graph heads, batch
   8) on the three synthetic members (48/32/40 samples) for its 4
   epochs through `hydragnn_tpu_torch.examples.gfm.run` on the card: one
   CUDA graph for the run's train step; the first step's loss and each
   task_<i> within rtol 1e-4 of the same step on the CPU at float64 (a
   worker), and of the CPU's float32 run within 1e-4 or FLOOR_TIMES x
   that run's own float32 error, where wider; the same driver under SGD
   (momentum 0, the config's learning rate) on the card: each epoch's
   per-head train and val losses within 1e-3 of the same run on the CPU
   at float64 or FLOOR_TIMES x the split's float32 floor (the CPU
   float32 run's widest gap to float64 over the split's epochs and
   heads), where wider; card vs the CPU float32 run printed, with
   whether 1e-3 held there (under the driver's Adam two CPU float32 runs
   of the same graphs part by up to ~100 % and more, so Adam's epochs
   are not compared); a 2-member sub-mixture trained under the full
   mixture's pinned budget, then the third member: no capture added; on
   dyadic members with one-hot head weights the head-masked captured
   step bitwise the plain one in every parameter; the captured step's
   ms, graphs/s and each epoch's wall s; B3 at the first packed batch's
   shapes (`gfm_segment_shapes`: GIN's 32-wide sum by receivers, the
   sender gathers' gradient, the pooling). (b)
   examples/multidataset/gfm_energy.json at its width (EGNN, hidden 50,
   3 layers, batch 32) over OC2020 + OC2022 (limit 200 each) through
   `hydragnn_tpu_torch.examples.multidataset` as two gloo ranks sharing
   the card (children `--gfm-rank`), rank r on shard r: the first SPMD
   step's loss card vs a CPU step of the same weights in the same group
   within rtol 1e-4 on each rank; a first SPMD SGD step from those
   weights card vs CPU (`md_first_step`, PR 20's bounds: the loss and
   the parameters after it within 1e-4, the averaged gradient within
   max(1e-2, 10 x the CPU float32 one's gap to float64)); B3 at each
   rank's first batch (EGNN's 50-wide message sum and sender gathers'
   gradient, its coordinate mean, the pooling), one rank at a time; one
   epoch through the driver; the step's ms, its collectives' share and
   graphs/s. B3 launched on both paths (`launches_gfm_path`); the shapes
   of (a) and (b) join the segment_sum record's `shapes`.
22. Sampled training on one giant graph (parallel/partition.py,
   preprocess/sampling.py, telemetry/sampling.py, the historical cache in
   models/base.py and train/train_step.py, examples/ogbn.py). (a)
   examples/ogbn/ogbn_arxiv.json at its published width (SAGE, hidden 64,
   2 layers, a 2-layer 64-wide node head, "ce", batch 512, fanouts
   [10, 5], 4 range partitions, K 0) on synthetic_arxiv(OGBN_NODES) for
   its 3 epochs through `hydragnn_tpu_torch.examples.ogbn.run` on the
   card: one CUDA graph for the run's train step; the final val_acc at
   least OGBN_MIN_VAL_ACC; a run stopped after epoch 1 and resumed with
   --resume ends with the uninterrupted run's history and param_digest,
   bit for bit; the first step (the driver's construction, the config's
   rate under SGD) card vs the CPU (workers): the loss within 1e-4 of
   float64 (and the driver's Adam run's first loss), the parameters after
   it within 1e-4 relative L2 of float32 and the update within max(1e-2,
   10 x the CPU float32 update's gap to float64) (`first_step_card_cpu`'s bounds); the
   CPU's plan_fp the card host's; seeds/s, each epoch's wall s. (b) the
   library path at ogbn-arxiv's scale and widths (synthetic_arxiv(169,343
   nodes, 128 features, 40 classes), built in a spawned process while (a)
   runs), the config's model, batch, fanouts and 4 range partitions as
   rank 0 of a world of 1 (partitions 1-3 remote), under SGD at K 0 and
   K 4: per mode one capture while the refresh flag follows K's cadence,
   the first step captured = eager bitwise (metrics, parameters, the
   tables' real rows), the first step card vs CPU (a worker, on the
   tables' rows the batch reads: `compact_tables`): the loss within 1e-4,
   the parameters within 1e-4 relative L2, at K 4 the refreshed rows
   within SLICE_TOL, versions, hist_frac and staleness equal; then
   SAMPLING_STEPS steps from the background loader, each loss read on
   the host, and the window's wall ms a step; the captured step's ms
   (its graph replayed alone, CUDA events, median), the idle share (1 -
   the steps' replay ms / the window's wall), the host's ms a sampled
   batch (synchronous), the loader's
   sampler_overlap_frac, the remote and local bytes a batch, hist_frac
   and staleness; B3 at the first batch's shapes (`sampling_shapes`:
   SAGE's mean by receivers and the sender gather's gradient at F 128
   and 64, over the layouts, the masked edges left out). B3's launches
   on both paths (`launches_sampling_path`); the shapes join the
   segment_sum record's `shapes`.

Trimmed for time (the smoke took 680-1,080 s of its 1,200 and ran
past it once): the SGD runs held card vs CPU in phases 5, 7 and 10 take
SGD_HELD_EPOCHS (1) of their 3 epochs, and phases 5 and 6 make no CPU
run with the config's optimizer (its gap to the card was printed, never
held); the plain autograd backward of phase 5a is timed over
AUTOGRAD_CALLS calls. The longest CPU reference runs (phases 5-7's and
10's SGD histories, phase 7c's CPU EF engine, phase 15's lattice
witness, 19a's SGD step) run in CPU_WORKERS spawned worker processes
while the card goes on (`cpu_submit`, `cpu_then`); their checks are
the same and are all made before the JSON records print, and the
workers are idle before phase 12's open loop, whose check reads host
latency.

The last line is {"ok": true, "device": {...}}; the line before it
holds the per-kernel JSON record (per-shape records under `shapes`,
kernels 2-4's bf16 readings under `bf16`; the two PNA backwards as rows
of their own, with their bf16 readings under `bf16`, the torch-op
VJP's device time as `plain_ms` and each pass's as `passes_ms`; the
dense forward's loader-shape reading under `loader`), the line before
that the card's
name and power limit, and before it a `sampling: {...}` (phase 22), a
`gfm: {...}` (phase 21), a
`graph_parallel: {...}` (phase 20), a `pipeline: {...}` (phase 19), a
`spmd: {...}` (phase 18), a
`quant: {...}` (phase 17), a
`smiles: {...}` (phase 16), an
`a7: {...}` (phase 15), a
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
import types

import numpy as np

SEED = 0
NUM_MOLECULES = 512
ENGINE_REPEATS = 8             # a burst is the test split 8 times over
BURSTS = 80                    # timed bursts, after the main-path one
GRAPH_CALLS = 20               # wrapper calls per captured CUDA graph
AUTOGRAD_CALLS = 2             # plain autograd backwards a graph (~0.1 s)
AUTOGRAD_REPS = 5              # and the graph's timed replays
SERVE_MAX_BATCH = 128          # Serving.max_batch_size = the config's batch
SUM_TOL = dict(rtol=2e-5, atol=2e-5)
SLICE_TOL = dict(rtol=1e-4, atol=1e-5)
LJ_CONFIG = "examples/LennardJones/LJ.json"
NUM_LJ = 512                   # LJ cells of 27 atoms
LJ_BURSTS = 60                 # timed EF bursts, after the main-path one
TRAIN_RTOL = 1e-3              # card vs cpu, every epoch's train loss
EVAL_RTOL = 1e-2               # and its val/test losses (eval-mode BN)
LJ_EPOCHS = 2                  # LJ.json trains 20 epochs; cut for time
SGD_HELD_EPOCHS = 1            # SGD card vs CPU epochs (csce_gap.json: 3)
CSCE_GROUP = 2                 # steps per call timed beside S = 1 (csce)
LJ_GROUP = 4                   # and LJ EF
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8
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
# Throwaway kernels launched at the start of every profile, before the
# work it measures. On one H100 (torch 2.11) the profiler loses the first
# device events of each window, more the longer the process has run:
# about one kernel every 14 s of its age (`chip_profile_probe.py`), so
# ~80 near the end of this script. The primer takes that loss instead of
# the measured work, and its own rows are left out of every profile.
PROFILE_PRIMER = 256
PRIMER_KEY = r"neg_kernel_cuda.*\bshort\b"   # int16 neg: used nowhere else


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    if _cpu.pool is not None:
        _cpu.pool.terminate()
    sys.exit(1)


# ------------------------------------------------------ CPU references --
# The longest CPU reference runs (phases 5-7's SGD histories, phase 15's
# lattice witness, phase 19a's SGD step) run in CPU_WORKERS worker
# processes while the card goes on: a phase hands its run to
# `cpu_submit` and the check that reads the result to `cpu_then`;
# `cpu_settle` waits for every run and makes those checks before the
# records are printed, so a failed check still fails the smoke. Outside
# `main` (a phase function called from a driver) the run is made in
# process and checked at once.
CPU_WORKERS = 3
CPU_WORKER_THREADS = 2
_cpu = types.SimpleNamespace(pool=None, pending=[])


def _cpu_worker_init(threads: int) -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""     # the workers run the CPU
    import torch
    torch.set_num_threads(threads)


def cpu_start() -> None:
    import multiprocessing
    _cpu.pool = multiprocessing.get_context("spawn").Pool(
        CPU_WORKERS, initializer=_cpu_worker_init,
        initargs=(CPU_WORKER_THREADS,))


def cpu_submit(fn, *args, **kwargs):
    """fn(*args, **kwargs) on a worker; what `cpu_then` reads."""
    if _cpu.pool is None:
        return types.SimpleNamespace(get=lambda v=fn(*args, **kwargs): v)
    return _cpu.pool.apply_async(fn, args, kwargs)


def cpu_then(result, check) -> None:
    """check(the submitted run's value), now or at `cpu_settle`."""
    if _cpu.pool is None:
        check(result.get())
    else:
        _cpu.pending.append((result, check))


def cpu_drain() -> None:
    """Wait until the workers are idle (before phases whose checks read
    host latency), making no check yet."""
    t0 = time.perf_counter()
    for result, _ in _cpu.pending:
        result.wait()
    print(f"cpu references: workers idle after {time.perf_counter() - t0:.1f}"
          " s", flush=True)


def cpu_settle() -> None:
    t0 = time.perf_counter()
    n = len(_cpu.pending)
    while _cpu.pending:
        result, check = _cpu.pending.pop(0)
        check(result.get())
    _cpu.pool.close()
    _cpu.pool.join()
    _cpu.pool = None
    print(f"cpu references: {n} checks settled after waiting "
          f"{time.perf_counter() - t0:.1f} s for the workers", flush=True)


def cpu_training(cfg, splits, env=None, threads=None, **kwargs):
    """(history, wall s) of run_training(cfg) on the CPU, under `env` and
    at `threads` threads (the worker's own when None)."""
    import torch
    from hydragnn_tpu_torch import run_training
    own = torch.get_num_threads()
    torch.set_num_threads(threads or own)
    t0 = time.perf_counter()
    try:
        with env_set(**(env or {})):
            _, hist, _, _ = run_training(cfg, datasets=splits, device="cpu",
                                         **kwargs)
    finally:
        torch.set_num_threads(own)
    return hist, time.perf_counter() - t0


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

    def replays():
        for _ in range(3):
            graph.replay()
    _, _, rows = profile_rows(torch, device_profile(torch, replays))
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
    prof = device_profile(
        torch, lambda: energy_forces_from_node_head(model, edge_batch))
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
        prof = device_profile(torch, lambda: model(edge_batch))
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


def device_profile(torch, call):
    """torch.profiler over call() and a synchronize, with PROFILE_PRIMER
    throwaway kernels launched and synchronized before it inside the
    window (see PROFILE_PRIMER); the primer's rows are left out by
    profile_rows. The profile's `primer_seen` is how many of them it
    holds: 0 means the loss may have reached call()'s own events."""
    import re

    from torch.profiler import ProfilerActivity, profile
    primer = torch.zeros(1, dtype=torch.int16, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PRIMER):
            torch.neg(primer)
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    pat = re.compile(PRIMER_KEY)
    prof.primer_seen = sum(ev.count for ev in prof.key_averages()
                           if ev.device_type == torch.autograd.DeviceType.CUDA
                           and pat.search(ev.key))
    return prof


def profile_rows(torch, prof):
    """(device ms, kernel launches, rows) of a profiler run: the device
    events (kernels, copies, sets) and their time, the primer's left
    out. The operator events that launched them carry the same device
    time as their own and are left out, or every kernel would count
    twice."""
    import re
    pat = re.compile(PRIMER_KEY)
    rows = []
    for ev in prof.key_averages():
        dev_t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
        if (dev_t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not pat.search(ev.key)):
            rows.append((dev_t, ev.key, ev.count))
    return (sum(r[0] for r in rows) / 1e3, sum(r[2] for r in rows), rows)


def autograd_device_ms(torch, name, make_loss, bound: float) -> float:
    """Device time per call of autograd's backward of make_loss()'s
    (loss, inputs): the forward runs once on a side stream, so that its
    backward ops run there, then AUTOGRAD_CALLS calls of
    torch.autograd.grad on it are captured in one CUDA graph on that
    stream and replayed (CUDA events, median of AUTOGRAD_REPS; a call
    takes ~0.1 s, so few calls make the median). Fails below `bound`."""
    made = []

    def warm():
        made[:] = make_loss()
        torch.autograd.grad(*made, retain_graph=True)

    def calls():
        for _ in range(AUTOGRAD_CALLS):
            torch.autograd.grad(*made, retain_graph=True)
    graph = capture(torch, warm, calls)
    ms = cuda_ms(torch, graph.replay, reps=AUTOGRAD_REPS,
                 warmup=1) / AUTOGRAD_CALLS
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
    counted (a replayed graph adds its captured launches). The port's
    kernels carry "primer_lost", how many of the profile's primer
    kernels it lost (`device_profile`). hold=False reports a difference
    (under "differs") instead, and a graph is held by its own nodes
    (`check_graph_kernels`). With hold, a profile that misses a launch,
    or holds none of its primer, is taken again, up to PROFILE_ATTEMPTS
    times, and only one that holds every launch is used: now and then
    a profile on one H100 loses most or all of its device events."""
    from hydragnn_tpu_torch import kernels as tk
    for attempt in range(PROFILE_ATTEMPTS):
        before = tk.launch_counts()
        prof = device_profile(torch, call)
        dev_ms, launches, rows = profile_rows(torch, prof)
        port = check_profiled_kernels(rows, before, tk.launch_counts(),
                                      label, hold=False)
        port["primer_lost"] = PROFILE_PRIMER - prof.primer_seen
        if not hold or ("differs" not in port and prof.primer_seen):
            return dev_ms, launches, rows, port
        named = {key[:100]: count for _, key, count in rows
                 if any(n.split("/")[0] in key
                        for n in port.get("differs", ()))}
        print(f"{label}: profile {attempt + 1} dropped launches "
              f"{port.get('differs', {})} (profile vs counters; the "
              f"profile's rows of those kernels {named}) and "
              f"{port['primer_lost']} of its {PROFILE_PRIMER} primer "
              "kernels; profiling again", flush=True)
    fail(f"{label}: {PROFILE_ATTEMPTS} profiles each missed launches the "
         f"counters counted or every primer kernel: "
         f"{port.get('differs', {})}, primer lost {port['primer_lost']}")


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
    parameters; no CPU run of it (Adam turns gradient noise below its eps
    into full-size updates, so its gap to the CPU holds nothing). Returns
    (the main run's (state, model, completed config), launches,
    record)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    cfg = copy.deepcopy(base_cfg)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = num_epoch
    sgd = copy.deepcopy(cfg)
    opt = cfg["NeuralNetwork"]["Training"]["Optimizer"]
    sgd["NeuralNetwork"]["Training"]["Optimizer"] = {
        "type": "SGD", "learning_rate": opt.get("learning_rate", 1e-3)}
    sgd["NeuralNetwork"]["Training"]["num_epoch"] = min(num_epoch,
                                                        SGD_HELD_EPOCHS)
    num_epoch_sgd = sgd["NeuralNetwork"]["Training"]["num_epoch"]
    cpu_run = cpu_submit(cpu_training, copy.deepcopy(sgd), splits)
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

    _, h_card, _, _ = run_training(copy.deepcopy(sgd), datasets=splits,
                                   device=device)
    record = dict(first_step=first)

    def hold_sgd(run):
        h_cpu, t_cpu = run
        gaps = history_gaps(h_card, h_cpu)
        print(f"{label} SGD {num_epoch_sgd} epochs card vs cpu ({t_cpu:.1f} "
              f"s on a cpu worker): relative gaps {gaps}; card train "
              f"{h_card['train_loss']} val {h_card['val_loss']} test "
              f"{h_card['test_loss']}", flush=True)
        for k, v in gaps.items():
            bound = TRAIN_RTOL if k == "train_loss" else EVAL_RTOL
            if not v <= bound:
                fail(f"{label}: SGD {k} card vs cpu gap {v} above {bound}")
        record["sgd_relative_gaps"] = gaps
    cpu_then(cpu_run, hold_sgd)

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
    record.update(bitwise_repeat=same, history=h0)
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
    run_prediction loop (Architecture.dtype "bfloat16": the loop
    computes at the train-side precision, as in the JAX package) within
    2^-5 on every test graph, the gap to the
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
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg["NeuralNetwork"]["Architecture"]["dtype"] = "bfloat16"
    t0 = time.perf_counter()
    _, ref = run_prediction(ref_cfg, splits, variables, serve=False,
                            device="cpu")
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
    cpu_run = cpu_submit(cpu_ef_engine, lj["mcfg"], lj["variables"], test,
                         [fut.bucket for fut in futs[:len(test)]], "bf16")
    for name in ("filter_scatter_bf16", "filter_scatter_backward_bf16",
                 "segment_sum"):
        if counts[name] == 0:
            fail(f"{name} never launched on the bf16 EF engine path")
    bitwise = all(np.array_equal(a, b) for res, single in
                  zip(results[:8], batched) for a, b in zip(res, single))
    if not bitwise:
        fail("bf16 EF engine: batched outputs differ from the single forward")
    gaps = {}

    def hold_cpu(run):
        want, want_burst, t_cpu = run
        bad = []
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
                    bad.append(f"bf16 EF {name} ({key}) card vs cpu outside "
                               f"2^-5 (by {gap})")
            gaps[f"{name}_vs_float32"] = (float(np.abs(flat(singles) - r32)
                                                .max()),
                                          float(np.abs(r32).max()))
        print(f"bf16 EF engine (edge list): launches {counts}; card vs cpu "
              f"bf16 ({t_cpu:.1f} s on a cpu worker), the burst against the "
              f"cpu on the burst's buckets and each cell alone on the "
              f"smallest bucket (max abs err, margin to 2^-5 + 2^-5 |ref|, "
              f"largest share of the bound used): {json.dumps(gaps)}; "
              f"batched = single bitwise: {bitwise}", flush=True)
        if bad:
            bf16_module_gaps(torch, lj, device)
            fail("; ".join(bad))
    cpu_then(cpu_run, hold_cpu)
    return gaps


def cpu_ef_engine(mcfg, variables, test, buckets, compute_dtype):
    """A CPU EF engine's single forward of each test cell, alone on the
    smallest bucket and on `buckets`, and the wall s of both."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    t0 = time.perf_counter()
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    with InferenceEngine(model, mcfg, reference_samples=test,
                         max_batch_size=SERVE_MAX_BATCH,
                         neighbor_format=False, ef_forward=True,
                         compute_dtype=compute_dtype, device="cpu") as eng:
        want = [eng.forward_single(s) for s in test]
        want_burst = [eng.forward_single(s, bucket=b)
                      for s, b in zip(test, buckets)]
    return want, want_burst, time.perf_counter() - t0


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
    sgd["NeuralNetwork"]["Training"]["num_epoch"] = min(num_epoch,
                                                        SGD_HELD_EPOCHS)
    cpu_run = cpu_submit(cpu_training, copy.deepcopy(sgd), splits)
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
    _, h_card, _, _ = run_training(copy.deepcopy(sgd), splits, device=device)
    record = dict(first_step_loss_gap=first_gap,
                  sgd_history_held=hold_history)

    def hold_sgd(run):
        h_cpu, t_cpu = run
        gaps = history_gaps(h_card, h_cpu)
        print(f"{label} bf16: first step loss card vs cpu {first_gap:.3e} "
              f"relative; SGD {sgd['NeuralNetwork']['Training']['num_epoch']}"
              f" epochs card vs cpu ({t_cpu:.1f} s on a cpu worker): "
              f"relative gaps {gaps} ("
              + ("held" if hold_history else "printed, not held")
              + f"); card train {h_card['train_loss']} val "
              f"{h_card['val_loss']}; cpu train {h_cpu['train_loss']} val "
              f"{h_cpu['val_loss']}", flush=True)
        for k, v in gaps.items():
            if hold_history and not v <= BF16_BOUND:
                fail(f"{label} bf16: SGD {k} card vs cpu gap {v} above 2^-5")
        record["sgd_relative_gaps"] = gaps
    cpu_then(cpu_run, hold_sgd)
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
    record.update(bitwise_repeat=same, launches=counts)
    return record


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


def eam_sgd(base, dense):
    """Phase 10's SGD config on one layout."""
    sgd = copy.deepcopy(base)
    sgd["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
    sgd["NeuralNetwork"]["Training"]["Optimizer"] = {
        "type": "SGD", "learning_rate": base["NeuralNetwork"]["Training"][
            "Optimizer"]["learning_rate"]}
    sgd["NeuralNetwork"]["Training"]["num_epoch"] = min(EAM_EPOCHS,
                                                        SGD_HELD_EPOCHS)
    return sgd


def cpu_training_series(runs):
    """`cpu_training(*run)` for each run, one after another."""
    return [cpu_training(*run) for run in runs]


def eam_setup(torch):
    """Phase 10's CFG files and config, written ahead of the phase so
    that its CPU runs start early: the SGD config of each layout on the
    CPU at this process's threads and at half of them (other GEMM and
    reduction orders: how far two float32 runs of this configuration
    part), one after another on one worker. Returns the setup dict that
    `eam_phase` takes."""
    import atexit
    import shutil
    import tempfile

    from hydragnn_tpu_torch.graphs.synthetic import ninb_cfg_files
    from hydragnn_tpu_torch.preprocess.load_data import (
        load_datasets_from_config)
    with open(EAM_CONFIG) as fh:
        base = json.load(fh)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ninb_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    t0 = time.perf_counter()
    ninb_cfg_files(os.path.join(tmp, "NiNb_solid_solution"), NUM_NINB,
                   seed=SEED)
    base["Dataset"]["path"]["total"] = os.path.join(tmp,
                                                    "NiNb_solid_solution")
    # plots are ROADMAP A10, which run_training refuses; the run is cut to
    # EAM_EPOCHS of the config's epochs
    base["Visualization"]["create_plots"] = False
    base["Verbosity"]["level"] = 0
    published = base["NeuralNetwork"]["Training"]["num_epoch"]
    base["NeuralNetwork"]["Training"]["num_epoch"] = EAM_EPOCHS
    splits = load_datasets_from_config(base)
    write_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    layouts = (("dense", True), ("edge", False))
    cpu_runs = cpu_submit(cpu_training_series, [
        (eam_sgd(base, dense), None, None, t)
        for _, dense in layouts for t in (threads, max(1, threads // 2))])
    return dict(tmp=tmp, base=base, splits=splits, published=published,
                write_s=write_s, threads=threads,
                layouts=layouts, cpu_runs=cpu_runs)


def eam_phase(torch, device, counted, packed_batch, setup):
    """Phase 10: NiNb_EAM_energy.json (PNA with edge lengths) at its
    published width from its own CFG files (`eam_setup`). Returns
    (per-path records, segment_sum shape records)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    base, splits, layouts, threads = (setup["base"], setup["splits"],
                                      setup["layouts"], setup["threads"])
    try:
        arch = base["NeuralNetwork"]["Architecture"]
        bs = int(base["NeuralNetwork"]["Training"]["batch_size"])
        print(f"phase 10: {EAM_CONFIG} (PNA hidden {arch['hidden_dim']}, "
              f"{arch['num_conv_layers']} layers, edge_features "
              f"{arch['edge_features']}, radius {arch['radius']} periodic, "
              f"batch {bs}; {EAM_EPOCHS} of {setup['published']} epochs, "
              f"plots off) on {NUM_NINB} NiNb cells of "
              f"{splits[0][0].num_nodes} atoms as CFG files "
              f"({setup['write_s']:.1f} s to write and read); splits "
              f"{[len(s) for s in splits]}", flush=True)
        out, shapes, sgd_runs, card_sgd = {}, [], {}, {}
        for label, dense in layouts:
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
            sgd = eam_sgd(base, dense)
            first = first_step_gradients(torch, sgd, splits, device)
            _, card_sgd[label], _, _ = run_training(copy.deepcopy(sgd),
                                                    device=device)
            print(f"{name} first step: loss card vs cpu "
                  f"{first['loss_gap']:.3e}; gradients kernels vs plain "
                  f"{first['rel_l2_kernels_plain']:.3e}, card vs cpu "
                  f"{first['rel_l2_card_cpu']:.3e}, cpu float32 vs float64 "
                  f"{first['rel_l2_cpu_f64']:.3e} (relative L2, worst "
                  f"tensor; as one vector: kernels vs plain "
                  f"{first['rel_l2_kernels_plain_all']:.3e}, cpu float32 vs "
                  f"float64 {first['rel_l2_cpu_f64_all']:.3e}; widest card "
                  f"vs cpu: {first['worst_card_cpu']}); "
                  f"two card runs bitwise: {same}", flush=True)
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
                              prediction_card_cpu=err, test_rmse=rmse)
            out[f"eam_pna_{label}"] = rec

        cpu_runs = iter(setup["cpu_runs"].get())
        for label, dense in layouts:
            (h_cpu, t_cpu), (h_half, _) = next(cpu_runs), next(cpu_runs)
            gaps = history_gaps(card_sgd[label], h_cpu)
            floor = history_gaps(h_half, h_cpu)
            sgd_runs[label] = dict(card=gaps, half_threads=floor, cpu=h_cpu)
            out[f"eam_pna_{label}"]["run"].update(
                sgd_relative_gaps=gaps, sgd_cpu_half_threads_gaps=floor)
            print(f"eam PNA lengths ({'dense' if dense else 'edge list'}): "
                  f"SGD {min(EAM_EPOCHS, SGD_HELD_EPOCHS)} epochs card vs "
                  f"cpu ({t_cpu:.1f} s on a cpu worker at {threads} "
                  f"threads): relative gaps {gaps}; the cpu at "
                  f"{max(1, threads // 2)} threads vs the cpu: {floor}",
                  flush=True)
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
        shutil.rmtree(setup["tmp"], ignore_errors=True)


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
    of the OC20 energy and forces EGNN on the slabs of the OC20 example's
    extxyz chunks (`generate_oc20_dataset`, read by `load_oc20` at the
    config's radius and min(max_neighbours, 512), as its train.py reads
    them) and qm9.json's GIN on synthetic molecules, each split by its
    perc_train as the examples split."""
    import tempfile
    from hydragnn_tpu_torch.datasets.atomistic import load_oc20
    from hydragnn_tpu_torch.graphs.synthetic import (generate_oc20_dataset,
                                                     qm9_molecules)
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    with open(OC20_ENERGY) as fh:
        arch = json.load(fh)["NeuralNetwork"]["Architecture"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_oc20_") as tmp:
        # the example's extxyz chunks, read as its train.py reads them
        generate_oc20_dataset(tmp, num_chunks=NUM_SLABS // 64,
                              frames_per_chunk=64, seed=SEED)
        slabs = load_oc20(tmp, radius=arch["radius"],
                          max_neighbours=min(arch["max_neighbours"], 512),
                          limit=NUM_SLABS)
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
FARM_STEPS_LARGEST = 16        # the largest farm's (a rate; no hold reads it)
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
    dev_ms, events, _ = profile_rows(
        torch, device_profile(torch, cap.graph.replay))
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
    100 + k), T = 1, 64 and 512, FARM_STEPS steps (T = 512:
    FARM_STEPS_LARGEST), K = FARM_K; (b)
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
                steps = (FARM_STEPS_LARGEST if T == max(FARM_TRAJ)
                         else FARM_STEPS)
                results[T], runs[f"T{T}"], farm = farm_run(
                    torch, engine, systems, T, steps, FARM_K,
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


def cpu_lattice_witness(cfg, splits):
    """One lattice row trained and predicted on the CPU: its test RMSE,
    wall s and train losses."""
    from hydragnn_tpu_torch import run_prediction, run_training
    t0 = time.perf_counter()
    state, hist, model, done = run_training(cfg, datasets=splits,
                                            device="cpu")
    trues, preds = run_prediction(done, datasets=splits, state=state,
                                  model=model, device="cpu")
    return dict(rmse=float(np.sqrt(np.mean((trues[0] - preds[0]) ** 2))),
                wall_s=time.perf_counter() - t0,
                train_loss=[float(v) for v in hist["train_loss"]])


def lattice_rows(torch, device, card, counted):
    """(c): the four threshold rows of tests/test_graphs_full.py trained
    and predicted on the card, each held under its threshold, and run
    again on the CPU from the same initialization as a witness (on a CPU
    worker, `cpu_lattice_witness`): every epoch's train loss card vs CPU
    held within TRAIN_RTOL (a row that ends in the graph-mean basin on
    one device only fails here); both RMSEs and the graph-mean
    predictor's are printed. DimeNet's training is held besides
    (`dimenet_lattice_training`)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.graphs.synthetic import bcc_lattices
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    samples = bcc_lattices(LATTICE_GRAPHS, heads=("graph",))
    splits = split_dataset(samples, 0.7)
    rows = ("DimeNet", "PAINN", "PNAEq", "MACE")
    witness = {m: cpu_submit(cpu_lattice_witness, lattice_config(m), splits)
               for m in rows}
    out = {"DimeNet_training": dimenet_lattice_training(torch, splits,
                                                        device, card)}
    for model_type in rows:
        cfg = lattice_config(model_type)
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist, model, done = run_training(copy.deepcopy(cfg),
                                                datasets=splits,
                                                device=device)
        trues, preds = run_prediction(done, datasets=splits, state=state,
                                      model=model, device=device)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        counted(counts)
        if counts["segment_sum"] == 0:
            fail(f"lattice {model_type}: segment_sum never launched")
        got = dict(rmse=float(np.sqrt(np.mean((trues[0] - preds[0]) ** 2))),
                   wall_s=time.perf_counter() - t0,
                   train_loss=[float(v) for v in hist["train_loss"]])
        rmse = got["rmse"]
        mean_rmse = float(np.sqrt(np.mean((trues[0] - trues[0].mean())
                                          ** 2)))
        if not np.isfinite(rmse) or rmse >= THRESHOLDS[model_type]:
            fail(f"lattice {model_type}: RMSE {rmse} not under "
                 f"{THRESHOLDS[model_type]}")
        out[model_type] = dict(rmse=rmse, threshold=THRESHOLDS[model_type],
                               graph_mean_rmse=mean_rmse,
                               wall_s=got["wall_s"], launches=counts,
                               train_loss=got["train_loss"])

        def hold_witness(cpu, model_type=model_type, got=got,
                         mean_rmse=mean_rmse, counts=counts):
            gaps = [abs(a - b) / max(abs(b), 1e-12)
                    for a, b in zip(got["train_loss"], cpu["train_loss"])]
            parted = next((i for i, g in enumerate(gaps) if g > TRAIN_RTOL),
                          None)
            print(f"lattice {model_type}: {LATTICE_EPOCHS} epochs on "
                  f"{len(splits[0])} graphs, run_training + run_prediction "
                  f"{got['wall_s']:.1f} s (cpu witness {cpu['wall_s']:.1f} "
                  f"s on a cpu worker); test RMSE card {got['rmse']:.4f}, "
                  f"cpu {cpu['rmse']:.4f}, graph-mean predictor "
                  f"{mean_rmse:.4f} (threshold {THRESHOLDS[model_type]}); "
                  f"final train loss card {got['train_loss'][-1]:.4e}, cpu "
                  f"{cpu['train_loss'][-1]:.4e}; train loss card vs cpu at "
                  f"most {max(gaps):.3e} relative over the epochs (bound "
                  f"{TRAIN_RTOL}); launches {counts} (card: {card})",
                  flush=True)
            if parted is not None:
                fail(f"lattice {model_type}: train loss card "
                     f"{got['train_loss'][parted]} vs cpu "
                     f"{cpu['train_loss'][parted]} at epoch {parted}, above "
                     f"{TRAIN_RTOL} relative")
            out[model_type].update(cpu_rmse=cpu["rmse"],
                                   train_loss_gap=max(gaps),
                                   cpu_wall_s=cpu["wall_s"],
                                   cpu_train_loss=cpu["train_loss"])
        cpu_then(witness[model_type], hold_witness)
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


# ----------------------------------------------------------- phase 16 --
NUM_SMILES = 2048              # csce molecules featurized from SMILES
SMILES_EPOCHS = 3              # the telemetry run (csce_gap.json's 3)
SESSION_STEPS = 30             # captured steps timed with and without a session
MFU_RTOL = 0.10                # achieved vs probe FLOPs / event-timed step


def in_degrees(samples):
    """(mean, max) in-degree over every node of `samples`."""
    deg = np.concatenate([np.bincount(s.receivers, minlength=s.num_nodes)
                          for s in samples])
    return float(deg.mean()), int(deg.max())


def smiles_splits(tmp):
    """csce_gap.json's data as its example builds it: the port's
    `generate_csce_csv` CSV of NUM_SMILES molecules featurized into bond
    graphs (datasets/smiles.py `csce_splits`, 12 node columns)."""
    from hydragnn_tpu_torch.datasets.smiles import csce_splits
    from hydragnn_tpu_torch.graphs.synthetic import generate_csce_csv
    return csce_splits(generate_csce_csv(tmp, NUM_SMILES, seed=SEED))


def check_telemetry_artifacts(out_dir, profile_dir, epochs):
    """The three session artifacts and the epoch's profiler trace exist
    and parse; returns the JSONL epoch events."""
    import glob
    with open(os.path.join(out_dir, "telemetry.jsonl")) as f:
        events = [json.loads(line) for line in f]
    with open(os.path.join(out_dir, "trace.json")) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"}
    with open(os.path.join(out_dir, "metrics.prom")) as f:
        prom = f.read()
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(traces) != 1:
        fail(f"telemetry: {len(traces)} profiler traces in {profile_dir}")
    with open(traces[0]) as f:
        profiled = json.load(f)["traceEvents"]
    epoch_events = [e for e in events if e["kind"] == "epoch"]
    if len(epoch_events) != epochs or (events[0]["name"],
                                       events[-1]["name"]) != ("start",
                                                               "end"):
        fail(f"telemetry.jsonl events {[e['name'] for e in events]}")
    for name in ("hydragnn_train_mfu", "hydragnn_train_achieved_flops_per_s",
                 "hydragnn_train_input_bound_frac"):
        if name not in prom:
            fail(f"telemetry: {name} not in metrics.prom")
    if not {"train_epoch", "step_dispatch", "dataload_wait"} <= spans:
        fail(f"telemetry: trace.json spans {sorted(spans)}")
    kernels = sum(e.get("cat") == "kernel" for e in profiled)
    print(f"telemetry artifacts: {len(events)} JSONL events, "
          f"{len(spans)} span names, {len(prom.splitlines())} lines of "
          f"metrics.prom; the epoch's profiler trace {len(profiled)} "
          f"events, {kernels} of them kernels", flush=True)
    if kernels == 0:
        fail("telemetry: the profiler trace holds no kernel")
    return epoch_events


def session_cost(torch, step, state, batch):
    """Host ms a captured step with the train pass's instruments (a live
    session: the stall monitor's timers and spans into its recorder)
    and without: SESSION_STEPS steps, each with the trainer's metric
    read, in turns."""
    from hydragnn_tpu_torch.telemetry.session import (TelemetryConfig,
                                                      TelemetrySession)
    from hydragnn_tpu_torch.train.trainer import _accumulate
    from hydragnn_tpu_torch.utils.profiling import HostStallMonitor
    import tempfile
    out = {"off": [], "on": []}
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(3):
            for mode in ("off", "on"):
                session = (TelemetrySession(TelemetryConfig(enabled=True),
                                            tmp) if mode == "on" else None)
                stall = HostStallMonitor()
                timer = (stall.step_timer if session is not None
                         else contextlib.nullcontext)
                acc = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SESSION_STEPS):
                    with timer():
                        _, m = step(state, batch)
                        _accumulate(acc, m)
                out[mode].append((time.perf_counter() - t0) * 1e3
                                 / SESSION_STEPS)
                if session is not None:
                    session.finalize()
    return {k: float(np.median(v)) for k, v in out.items()}


def smiles_phase(torch, device, card, counted, radius):
    """Phase 16: (a) csce PNA at its published width on SMILES bond
    graphs, (c) its telemetry on the card ((b), OC20 EGNN from extxyz
    chunks, is phase 11's data). `radius`: phases 3, 5 and 9's numbers
    on the radius graphs, printed beside these. Returns the record."""
    import tempfile
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.train.train_step import step_cost_flops
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    t_phase = time.perf_counter()
    with open(CSCE_CONFIG) as fh:
        base_cfg = json.load(fh)
    bs = int(base_cfg["NeuralNetwork"]["Training"]["batch_size"])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_smiles_") as tmp:
        splits = smiles_splits(tmp)
        samples = [s for split in splits for s in split]
        deg = in_degrees(samples)
        print(f"phase 16: csce PNA on SMILES bond graphs: {NUM_SMILES} "
              f"molecules from generate_csce_csv, {len(samples)} "
              f"featurized (splits {[len(s) for s in splits]}), "
              f"{np.mean([s.num_nodes for s in samples]):.1f} atoms a "
              f"molecule, in-degree mean {deg[0]:.2f} max {deg[1]} "
              f"(the radius graphs': mean {radius['in_degree'][0]:.2f} max "
              f"{radius['in_degree'][1]}); hidden "
              f"{base_cfg['NeuralNetwork']['Architecture']['hidden_dim']}, "
              f"{base_cfg['NeuralNetwork']['Architecture']['num_conv_layers']}"
              f" layers, batch {bs} (card: {card})", flush=True)
        rec = dict(molecules=len(samples), in_degree_mean=deg[0],
                   in_degree_max=deg[1], paths={}, launches={})

        # (a) both layouts: first step, captured = eager, step numbers
        for dense in (True, False):
            c = copy.deepcopy(base_cfg)
            c["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
            layout = "dense" if dense else "edge"
            name = f"csce PNA SMILES ({'dense' if dense else 'edge list'})"
            first = first_step_gradients(torch, c, splits, device)
            path = step_metrics(torch, c, splits, device, name, bs,
                                CSCE_GROUP, card=card)
            path["first_step"] = first
            rec["paths"][layout] = path
            fixed = radius["paths"][f"csce_pna_{layout}"]["graph_S1"]
            packed = radius["paths"][f"csce_pna_{layout}_packed"]["graph_S1"]
            print(f"{name}: first step loss card vs cpu "
                  f"{first['loss_gap']:.3e}; captured S1 "
                  f"{path['graph_S1']['step_ms']:.3f} ms a step, "
                  f"{path['graph_S1']['graphs_per_s']:.1f} graphs/s; the "
                  f"radius graphs (phase 5) {fixed['step_ms']:.3f} ms, "
                  f"{fixed['graphs_per_s']:.1f} graphs/s, packed (phase 9) "
                  f"{packed['step_ms']:.3f} ms, {packed['graphs_per_s']:.1f}"
                  f" graphs/s (card: {card})", flush=True)

        # the edge list's main path: run_training, 1 epoch
        edge_cfg = copy.deepcopy(base_cfg)
        edge_cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
        edge_cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
        os.chdir(tmp)
        try:
            tk.reset_launch_counts()
            _, h_edge, _, _ = run_training(copy.deepcopy(edge_cfg),
                                           datasets=splits, device=device)
            torch.cuda.synchronize()
            counts = tk.launch_counts()
            counted(counts)
            rec["launches"]["run_training_edge"] = counts
            if not np.isfinite(h_edge["train_loss"]).all():
                fail("SMILES edge-list training: non-finite loss")

            # (c) the dense main path with a session and the Profile block
            tel_cfg = copy.deepcopy(base_cfg)
            tel_cfg["NeuralNetwork"]["Training"]["num_epoch"] = SMILES_EPOCHS
            tel_cfg["NeuralNetwork"]["Training"]["Telemetry"] = {
                "enabled": True, "dir": "telemetry"}
            tel_cfg["Profile"] = {"enable": 1, "target_epoch": 1}
            tk.reset_launch_counts()
            t0 = time.perf_counter()
            state, hist, _, done = run_training(copy.deepcopy(tel_cfg),
                                                datasets=splits,
                                                device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = tk.launch_counts()
            counted(counts)
            rec["launches"]["run_training_dense_telemetry"] = counts
            from hydragnn_tpu_torch.config.config import get_log_name_config
            epochs = check_telemetry_artifacts(
                "telemetry", os.path.join("logs", get_log_name_config(done),
                                          "profile"), SMILES_EPOCHS)
        finally:
            os.chdir(cwd)
        for kernel in ("nbr_aggregate", "nbr_aggregate_backward",
                       "segment_sum"):
            if rec["launches"]["run_training_dense_telemetry"][kernel] == 0:
                fail(f"{kernel} never launched on the SMILES dense path")
        for kernel in ("pna_edge_aggregate", "pna_edge_aggregate_backward",
                       "segment_sum"):
            if rec["launches"]["run_training_edge"][kernel] == 0:
                fail(f"{kernel} never launched on the SMILES edge path")
        mfu, achieved = hist.get("mfu", []), hist.get(
            "achieved_flops_per_s", [])
        if len(mfu) != SMILES_EPOCHS or not all(0.0 < m <= 1.0 for m in mfu):
            fail(f"telemetry: train_mfu {mfu} (not one in (0, 1] an epoch)")
        if not np.isfinite(hist["train_loss"]).all():
            fail("SMILES telemetry training: non-finite loss")

        # the probe: kernel route = plain route; the session's count; the
        # achieved rate against a CUDA-event-timed captured step
        model, st, step, loader, _, _ = train_parts(torch, base_cfg, splits,
                                                    device)
        loader.set_epoch(0)
        host_batch = next(iter(loader))
        batch = host_batch.to(device)
        flops = step_cost_flops(step, batch)
        with plain_versions():
            flops_plain = step_cost_flops(step, batch)
        if flops != flops_plain or not flops > 0:
            fail(f"FLOP probe: kernel route {flops}, plain route "
                 f"{flops_plain}")
        last = epochs[-1]
        run_flops = (last["timing"]["achieved_flops_per_s"]
                     * last["timing"]["epoch_step_s"] / last["data"]["batches"])
        if not np.isclose(run_flops, flops, rtol=1e-6):
            fail(f"FLOP probe: the session's {run_flops} vs {flops}")
        step(st, batch)             # capture
        # timed as the trainer's step timer times a step: the loader's
        # host batch placed on the card (run_training's place_fn), the
        # replay, then the card's end
        event_ms = float(np.median(step_events_ms(
            torch, lambda: step(st, host_batch.to(device)))))
        expected = flops / (event_ms * 1e-3)
        gap = achieved[-1] / expected - 1.0
        cost = session_cost(torch, step, st, batch)
        print(f"telemetry (csce PNA SMILES dense, {SMILES_EPOCHS} epochs in "
              f"{wall:.2f} s): train_mfu {mfu}, train_achieved_flops_per_s "
              f"{achieved}; the probe {flops:.6e} matmul FLOPs a step (plain "
              f"route {flops_plain:.6e}); a CUDA-event-timed captured step "
              f"{event_ms:.3f} ms -> {expected:.6e} FLOP/s, the last "
              f"epoch's achieved {achieved[-1]:.6e} ({gap:+.3%}); the "
              f"session's cost: {cost['on']:.3f} ms a step with it, "
              f"{cost['off']:.3f} ms without (host wall, step + metric "
              f"read) (card: {card})", flush=True)
        if abs(gap) > MFU_RTOL:
            fail(f"telemetry: achieved {achieved[-1]} vs probe over a timed "
                 f"step {expected}: {gap:+.3%} (bound {MFU_RTOL:.0%})")
        rec["telemetry"] = dict(
            mfu=mfu, achieved_flops_per_s=achieved, probe_flops=flops,
            probe_flops_plain=flops_plain, captured_step_ms=event_ms,
            achieved_vs_timed_step=gap, session_on_ms=cost["on"],
            session_off_ms=cost["off"], epoch_events=epochs, wall_s=wall)

        # the engine on the bond graphs (edge list), seeded weights
        from hydragnn_tpu_torch.config import config as tcfg
        from hydragnn_tpu_torch.models.create import data_input_dim
        done_cfg = tcfg.update_config(copy.deepcopy(base_cfg), *splits)
        mcfg = data_input_dim(tcfg.build_model_config(done_cfg), splits[0])
        variables = random_flax_variables(create_model(mcfg, device="cpu"),
                                          SEED)
        model = create_model(mcfg, device=device)
        model.load_state_dict(load_jax_variables(variables))
        test = splits[2]
        requests = test * ENGINE_REPEATS
        engine = InferenceEngine(model, mcfg, reference_samples=test,
                                 max_batch_size=SERVE_MAX_BATCH,
                                 neighbor_format=False, device=device)
        try:
            engine.warmup()
            tk.reset_launch_counts()
            futs = [engine.submit(r) for r in requests]
            results = [f.result(timeout=600) for f in futs]
            counts = tk.launch_counts()
            counted(counts)
            rec["launches"]["engine_edge"] = counts
            for (r, f), res in list(zip(zip(requests, futs), results))[:8]:
                one = engine.forward_single(r, bucket=f.bucket)
                if not np.array_equal(res[0], one[0]):
                    fail("SMILES engine: batched != single on one bucket")
            if not all(np.isfinite(res[0]).all() for res in results):
                fail("SMILES engine: non-finite prediction")
            rate = engine_bursts(torch, engine, requests, SLICE_BURSTS)
        finally:
            engine.shutdown()
        if counts["pna_edge_aggregate"] == 0 or counts["segment_sum"] == 0:
            fail(f"SMILES engine: launches {counts}")
        rec["engine"] = rate
        print(f"csce PNA SMILES engine (edge list): {rate['bursts']} bursts "
              f"of {rate['requests']} requests: {rate['requests_per_s']:.1f}"
              f" requests/s, p99 {rate['p99_ms']:.3f} ms; the radius graphs' "
              f"engine (phase 3) {radius['engine']['requests_per_s']:.1f} "
              f"requests/s, p99 {radius['engine']['p99_ms']:.3f} ms; "
              f"launches {counts} (card: {card})", flush=True)
    rec["b_launches"] = {k: sum(c.get(k, 0) for c in rec["launches"].values())
                         for k in ("nbr_aggregate", "nbr_aggregate_backward",
                                   "pna_edge_aggregate",
                                   "pna_edge_aggregate_backward",
                                   "segment_sum")}
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 16: B1/B2/B3 launches on its paths {rec['b_launches']}; "
          f"took {rec['wall_s']:.1f} s (card: {card})", flush=True)
    return rec


QUANT_CALIB = 32               # phase 17: calibration samples
QUANT_SHARDS = 4               # and the shards merged to one pass
QUANT_BURSTS = 20              # timed bursts, int8 and float32 in turn
QUANT_DISTILL_STEPS = 8
QUANT_DISTILL_LR = 3e-4
# int8 card vs CPU int8 on the same scales (max abs, on real rows): float32
# rounding before the quantizer alone, which moves an x_q by one level at
# most; an H100 80GB HBM3 at 700 W reads 1.6e-5 (phase 17a)
INT8_CARD_CPU_ATOL = 1e-3


def quant_phase(torch, device, card, counted, csce):
    """Phase 17: the int8 serving tier (quant/, the engine's
    compute_dtype "int8") on phase 3's csce PNA configuration at
    csce_gap.json's published width, with phase 3's weights and requests;
    remat (Training.conv_checkpointing) and the training fault sites on
    phase 5's csce training. Every number beside the card's name and
    power limit. Returns (record, launches of the int8 engine's main
    path)."""
    import gc
    import os
    import shutil
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.quant import (calibrate, distill_heads,
                                          make_quantized_forward,
                                          merge_calibrations)
    from hydragnn_tpu_torch.quant.calibrate import calibrated_layers
    from hydragnn_tpu_torch.quant.ptq import (Int8Dense, int8_dense, int_mm,
                                              quantize_input,
                                              quantize_weight)
    from hydragnn_tpu_torch.serving.engine import (SERVE_INT8_ATOL,
                                                   SERVE_INT8_RTOL,
                                                   InferenceEngine)
    from hydragnn_tpu_torch.serving.fleet import ReplicaRouter, TierPolicy
    from hydragnn_tpu_torch.train import train_step as tstep
    from hydragnn_tpu_torch.utils.faults import InjectedFault
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    mcfg, test, requests = csce["mcfg"], csce["test"], csce["requests"]
    variables = csce["variables"]
    t_phase = time.perf_counter()
    out = {"card": card}
    print(f"phase 17: the int8 serving tier, csce PNA hidden "
          f"{mcfg.hidden_dim}, {mcfg.num_conv_layers} layers (card: {card})",
          flush=True)

    def model_on(dev, v=variables):
        m = create_model(mcfg, device=dev)
        m.load_state_dict(load_jax_variables(v))
        return m

    def engine(dev, dtype, calib, v=variables, tier=None):
        return InferenceEngine(model_on(dev, v), mcfg, reference_samples=test,
                               max_batch_size=SERVE_MAX_BATCH,
                               neighbor_format=False, compute_dtype=dtype,
                               quant_calibration=calib, tier=tier,
                               device=dev)

    def same_scales(a, b):
        return (sorted(a.scales) == sorted(b.scales) and a.digest == b.digest
                and all(np.array_equal(a.amax[k], b.amax[k]) for k in a.amax))

    def ratio(got, want):
        """largest |got - want| / (atol + rtol |want|) of the 2^-3 bound"""
        return float(np.max(np.abs(got - want)
                            / (SERVE_INT8_ATOL + SERVE_INT8_RTOL
                               * np.abs(want))))

    # ------------------------------------------------ (a) calibration
    model = model_on(device)
    t0 = time.perf_counter()
    calib = calibrate(model, None, mcfg, test, num_samples=QUANT_CALIB)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    again = calibrate(model, None, mcfg, test, num_samples=QUANT_CALIB)
    step = QUANT_CALIB // QUANT_SHARDS
    merged = merge_calibrations([
        calibrate(model, None, mcfg, test[i:i + step])
        for i in range(0, QUANT_CALIB, step)])
    if not same_scales(calib, again):
        fail("phase 17: two calibrations on the card differ")
    if not same_scales(calib, merged):
        fail(f"phase 17: a merge of {QUANT_SHARDS} shards differs from one "
             "pass")
    calib_cpu = calibrate(model_on("cpu"), None, mcfg, test,
                          num_samples=QUANT_CALIB)
    # the molecules without an isolated atom, where the 2^-3 contract
    # holds (an isolated atom's PNA attenuation sets the scales in both
    # packages, ROADMAP C), calibrated on themselves
    iso = [s for s in test
           if (np.bincount(s.receivers, minlength=s.num_nodes) > 0).all()]
    calib_iso = calibrate(model, None, mcfg, iso, num_samples=QUANT_CALIB)
    scale_gap = max(float(np.max(np.abs(calib.scales[k] - calib_cpu.scales[k])
                                 / calib_cpu.scales[k]))
                    for k in calib.scales)
    out["calibration"] = dict(
        samples=QUANT_CALIB, layers=len(calib.scales), seconds=calib_s,
        digest=calib.digest[:12], repeat_bitwise=True,
        merge_of_shards_bitwise=QUANT_SHARDS,
        scales_rel_gap_card_cpu=scale_gap,
        digest_equal_card_cpu=calib.digest == calib_cpu.digest)
    print(f"phase 17a: calibration of {len(calib.scales)} layers on "
          f"{QUANT_CALIB} samples in {calib_s:.3f} s; repeat and a merge of "
          f"{QUANT_SHARDS} shards bitwise; scales card vs cpu: largest "
          f"relative gap {scale_gap:.3e} (card: {card})", flush=True)

    # --------------------------------- (a) int8 vs float32, the main path
    e8 = engine(device, "int8", calib)
    e32 = engine(device, "float32", None)
    launches = {}
    try:
        e8.warmup()
        e32.warmup()
        captures = e8.stats()["captures"]
        tk.reset_launch_counts()
        futs8 = [e8.submit(s) for s in requests]
        res8 = [f.result(timeout=600) for f in futs8]
        torch.cuda.synchronize()
        launches = tk.launch_counts()
        counted(launches)
        for name in ("pna_edge_aggregate", "segment_sum"):
            if launches[name] == 0:
                fail(f"phase 17: {name} never launched on the int8 engine "
                     "path")
        res32 = e32.predict(requests, timeout=600)
        for f in futs8:
            if (f.parity, f.parity_rtol, f.parity_atol, f.tier) != (
                    "tolerance", SERVE_INT8_RTOL, SERVE_INT8_ATOL, "int8"):
                fail("phase 17: an int8 future's breadcrumbs are wrong")
        got8 = np.concatenate([r[0] for r in res8])
        got32 = np.concatenate([r[0] for r in res32])
        if not np.isfinite(got8).all() or got8.shape != got32.shape:
            fail("phase 17: int8 engine results not finite or misshapen")
        contract_card = ratio(got8, got32)
        for s, f, r in list(zip(requests, futs8, res8))[:8]:
            single = e8.forward_single(s, bucket=f.bucket)
            if not np.array_equal(single[0], r[0]):
                fail("phase 17: int8 batched != single on the same bucket")
        s0, b0 = requests[0], futs8[0].bucket
        eager = e8._run(e8._collate_bucket([s0], b0).to(device))[0]
        if not np.array_equal(e8.forward_single(s0, bucket=b0)[0],
                              eager.cpu().numpy()[0]):
            fail("phase 17: the int8 bucket graph != its eager forward")
        # card against the CPU, same scales
        e8_cpu = engine("cpu", "int8", calib)
        e32_cpu = engine("cpu", "float32", None)
        try:
            cpu8 = np.concatenate([r[0] for r in e8_cpu.predict(test)])
            cpu32 = np.concatenate([r[0] for r in e32_cpu.predict(test)])
        finally:
            e8_cpu.shutdown()
            e32_cpu.shutdown()
        card8 = got8[:len(test)]
        gap_card_cpu = float(np.abs(card8 - cpu8).max())
        if not gap_card_cpu <= INT8_CARD_CPU_ATOL:
            fail(f"phase 17: int8 card vs cpu max abs {gap_card_cpu} over "
                 f"{INT8_CARD_CPU_ATOL}")
        contract_cpu = ratio(cpu8, cpu32)
        # x_q card vs cpu over every calibrated layer of one batch
        batch = e8._collate_bucket(test[:16], b0)
        seen = {}
        outs = {}
        for tag, m, dev in (("card", e8.model, device),
                            ("cpu", model_on("cpu"), torch.device("cpu"))):
            qmodel = make_quantized_forward(m, mcfg, calib)
            hooks = [mod.register_forward_pre_hook(
                lambda mod, args, tag=tag, name=name: seen.setdefault(
                    tag, []).append((name, args[0].detach(), quantize_input(
                        args[0], mod.s_x).cpu())))
                for name, mod in qmodel.named_modules()
                if isinstance(mod, Int8Dense)]
            try:
                with torch.no_grad():
                    outs[tag] = qmodel(batch.to(dev))[0][0].cpu()
            finally:
                for h in hooks:
                    h.remove()
        xq_diff = sum(int((a[2] != b[2]).sum())
                      for a, b in zip(seen["card"], seen["cpu"]))
        xq_total = sum(a[2].numel() for a in seen["card"])
        out_gap = float((outs["card"] - outs["cpu"]).abs()[
            batch.graph_mask].max())
        if not out_gap <= INT8_CARD_CPU_ATOL:
            fail(f"phase 17: int8 eager forward card vs cpu max abs "
                 f"{out_gap} over {INT8_CARD_CPU_ATOL}")
        # int8_dense on identical inputs: a hidden layer's post_nn product
        key = "conv_1/post_nn"
        mod = calibrated_layers(e8.model, mcfg.num_conv_layers)[key]
        idx = [n for n, _, _ in seen["card"]].index(key.replace("/", "."))
        x = seen["card"][idx][1]
        parts = {}
        for tag, dev in (("card", device), ("cpu", torch.device("cpu"))):
            xs, ws = x.to(dev), mod.weight.detach().to(dev)
            sx = torch.as_tensor(calib.scales[key], device=dev)
            xq = quantize_input(xs, sx)
            wq, sw = quantize_weight(ws, sx)
            parts[tag] = [t.cpu() for t in (xq, wq, sw, int_mm(xq, wq.t()))]
        for name, a, b in zip(("x_q", "w_q", "s_w", "acc"), parts["card"],
                              parts["cpu"]):
            if not torch.equal(a, b):
                fail(f"phase 17: int8_dense {name} differs card vs cpu on "
                     "identical inputs")
        # hot swap: re-quantized at the next replay, nothing recaptured
        other = random_flax_variables(model_on("cpu"), SEED + 17)
        e8.swap_variables(other, "v1")
        futs = [e8.submit(s) for s in test]
        swapped = [f.result(timeout=600) for f in futs]
        fresh = engine(device, "int8", calib, v=other)
        try:
            for s, f, r in zip(test, futs, swapped):
                want = fresh.forward_single(s, bucket=f.bucket)
                if f.model_version != "v1" or not np.array_equal(r[0],
                                                                 want[0]):
                    fail("phase 17: after swap_variables the int8 engine "
                         "differs from a fresh one on the new weights")
        finally:
            fresh.shutdown()
        if e8.stats()["captures"] != captures:
            fail("phase 17: swap_variables recaptured a bucket")
        e8.swap_variables(variables, "v0")
        # the 2^-3 contract held where it applies: the test molecules
        # whose every atom has a neighbour, calibrated on themselves
        e8_iso = engine(device, "int8", calib_iso)
        try:
            iso8 = np.concatenate([r[0] for r in e8_iso.predict(
                iso, timeout=600)])
        finally:
            e8_iso.shutdown()
        iso32 = np.concatenate([r[0] for r in e32.predict(iso,
                                                          timeout=600)])
        contract_iso = ratio(iso8, iso32)
        if not np.isfinite(iso8).all() or not contract_iso <= 1.0:
            fail(f"phase 17: int8 engine vs float32 engine on the "
                 f"{len(iso)} molecules without isolated atoms: gap / 2^-3 "
                 f"bound {contract_iso}")
        # speed: bursts in turn
        for e in (e8, e32):
            e.reset_stats()
        walls = {"int8": 0.0, "float32": 0.0}
        for _ in range(QUANT_BURSTS):
            for tag, e in (("int8", e8), ("float32", e32)):
                t0 = time.perf_counter()
                for f in [e.submit(s) for s in requests]:
                    f.result(timeout=600)
                walls[tag] += time.perf_counter() - t0
        speed = {}
        for tag, e in (("int8", e8), ("float32", e32)):
            st = e.stats()
            speed[tag] = dict(
                requests_per_s=len(requests) * QUANT_BURSTS / walls[tag],
                p50_ms=st["p50_ms"], p99_ms=st["p99_ms"])
        # one post_nn product at the largest bucket's rows: device time
        # of GRAPH_CALLS calls in one graph, int8 (its quantize and
        # dequantize included) beside the float32 matmul; the int8
        # function's bound is its bytes (x, w, b, y in float32) or its
        # int8 operations at the data sheet's 1,979 TOP/s
        top = e8.buckets[-1]
        rng = np.random.default_rng(SEED)
        xin = torch.as_tensor(rng.random((top.n_node, mod.in_features))
                              .astype(np.float32), device=device)
        w = mod.weight.detach()
        bias = mod.bias.detach()
        sx = torch.as_tensor(calib.scales[key], device=device)
        m_, k_, n_ = top.n_node, mod.in_features, mod.out_features
        nbytes = 4 * (m_ * k_ + k_ * n_ + n_ + k_ + m_ * n_)
        int8_bound = max(nbytes / HBM_BYTES_PER_S,
                         2 * m_ * k_ * n_ / INT8_OPS_PER_S) * 1e3
        int8_ms = device_ms(torch, "int8 post_nn", int8_dense,
                            (xin, w, bias, sx), int8_bound)
        f32_ms = device_ms(torch, "float32 post_nn", torch.matmul,
                           (xin, w.t()), 0.0)
    finally:
        e8.shutdown()
        e32.shutdown()
    out["engine"] = dict(
        contract_ratio_card=contract_card, contract_ratio_cpu=contract_cpu,
        contract_met=contract_card <= 1.0,
        contract_ratio_no_isolated_atoms=contract_iso,
        molecules_no_isolated_atoms=len(iso),
        int8_card_vs_cpu_max_abs=gap_card_cpu,
        x_q_differ_card_cpu=[xq_diff, xq_total],
        eager_output_gap_card_cpu=out_gap, batched_equals_single=True,
        graph_equals_eager=True, swap_equals_fresh=True,
        captures=captures, launches=launches, speed=speed,
        post_nn_product_ms=dict(shape=[m_, k_, n_],
                                int8_with_quantize=int8_ms,
                                int8_bound=int8_bound,
                                float32_matmul=f32_ms))
    print(f"phase 17a: int8 engine vs float32 engine on {len(requests)} "
          f"requests: largest gap / 2^-3 bound {contract_card:.3f} (the "
          f"CPU's, same scales: {contract_cpu:.3f}; over 1 the bound is "
          f"not met); on the {len(iso)} test molecules without an "
          f"isolated atom, calibrated on them: {contract_iso:.4f} (held "
          f"<= 1); int8 card vs cpu max abs {gap_card_cpu:.3e} (held <= "
          f"{INT8_CARD_CPU_ATOL}); x_q "
          f"differing card vs cpu {xq_diff} of {xq_total} on one batch "
          f"(output gap {out_gap:.3e}); int8_dense x_q/w_q/s_w/acc bitwise "
          f"card vs cpu; batched = single, graph = eager and swap = fresh "
          f"bitwise, {captures} captures; launches {launches} "
          f"(card: {card})", flush=True)
    print(f"phase 17a: int8 {speed['int8']['requests_per_s']:.1f} "
          f"requests/s, p50 {speed['int8']['p50_ms']:.3f} ms, p99 "
          f"{speed['int8']['p99_ms']:.3f} ms; float32 "
          f"{speed['float32']['requests_per_s']:.1f}, p50 "
          f"{speed['float32']['p50_ms']:.3f}, p99 "
          f"{speed['float32']['p99_ms']:.3f} ({QUANT_BURSTS} bursts of "
          f"{len(requests)} each, in turn); {key} product {m_}x{k_}x{n_}, "
          f"device ms in a graph: int8 with its quantize and dequantize "
          f"{int8_ms:.4f} (bound {int8_bound:.4f}), float32 matmul "
          f"{f32_ms:.4f} (card: {card})", flush=True)

    # ------------------------------------------------ (b) tiered fleet
    router = ReplicaRouter(
        lambda idx: engine(device, "int8" if idx == 0 else "float32",
                           calib if idx == 0 else None),
        2, tier_policy=TierPolicy(fast="int8", accurate="float32",
                                  priority_min=1, quota=0.25))
    try:
        router.warmup()
        futs = [router.submit(s, priority=i % 2)
                for i, s in enumerate(requests)]
        [f.result(timeout=600) for f in futs]
        for f in futs:
            want = ("int8", 0, SERVE_INT8_RTOL) if f.replica == 0 else (
                "float32", 1, 0.0)
            if (f.tier, f.replica, f.parity_rtol) != want:
                fail(f"phase 17b: future tier {f.tier} on replica "
                     f"{f.replica} with bound {f.parity_rtol}")
        st = router.stats()
        shares = {t: n / len(requests)
                  for t, n in st["tier_dispatches"].items()}
        downgrades = st["tier_downgrades"]
        if shares.get("float32", 0.0) > 0.25 + 1.0 / len(requests):
            fail(f"phase 17b: accurate share {shares} over its quota")
        router.kill_replica(0)
        futs = [router.submit(s, priority=0) for s in test]
        done = [f for f in futs if f.exception(timeout=600) is None]
        lost = len(futs) - len(done)
        if lost or any(f.tier != "float32" for f in done):
            fail(f"phase 17b: {lost} futures lost after the kill")
        fallbacks = router.stats()["tier_fallbacks"]
        if fallbacks < len(test):
            fail(f"phase 17b: {fallbacks} fallbacks for {len(test)} "
                 "requests")
    finally:
        router.shutdown()
    out["fleet"] = dict(shares=shares, downgrades=downgrades,
                        fallbacks_after_kill=fallbacks, lost=lost)
    print(f"phase 17b: tiered fleet (int8 + float32, quota 0.25, half the "
          f"requests priority 1): dispatch shares {shares}, downgrades "
          f"{downgrades}; int8 replica killed: {len(test)} requests, "
          f"{fallbacks} fallbacks, {lost} lost (card: {card})", flush=True)

    # ------------------------------------------------ (c) distillation
    # on the molecules without an isolated atom and their calibration:
    # with one, the int8 outputs sit on a few levels and no step of
    # QUANT_DISTILL_LR's order lowers the loss (printed for the record)
    runs = [distill_heads(model, None, mcfg, calib_iso, iso,
                          steps=QUANT_DISTILL_STEPS, lr=QUANT_DISTILL_LR,
                          num_samples=QUANT_CALIB) for _ in range(2)]
    (s1, r1), (s2, r2) = runs

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", tree[k]
    l1, l2 = list(leaves(s1)), list(leaves(s2))
    if r1 != r2 or [k for k, _ in l1] != [k for k, _ in l2] or not all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(l1, l2)):
        fail("phase 17c: two distillations on the card differ")
    pre, post = (sum(r1["head_mse_vs_teacher_pre"]),
                 sum(r1["head_mse_vs_teacher_post"]))
    if r1["best_step"] == 0 or not post < pre:
        fail(f"phase 17c: no update kept (best step {r1['best_step']}, "
             f"head MSE {pre} -> {post})")
    _, r_all = distill_heads(model, None, mcfg, calib, test,
                             steps=QUANT_DISTILL_STEPS, lr=QUANT_DISTILL_LR,
                             num_samples=QUANT_CALIB)
    out["distill"] = dict(steps=QUANT_DISTILL_STEPS, lr=QUANT_DISTILL_LR,
                          samples=len(iso[:QUANT_CALIB]), mse_pre=pre,
                          mse_post=post, best_step=r1["best_step"],
                          bitwise_repeat=True,
                          isolated_atoms_included=dict(
                              best_step=r_all["best_step"],
                              mse_pre=sum(r_all["head_mse_vs_teacher_pre"]),
                              mse_post=sum(
                                  r_all["head_mse_vs_teacher_post"])))
    print(f"phase 17c: distill_heads {QUANT_DISTILL_STEPS} steps at lr "
          f"{QUANT_DISTILL_LR} on {len(iso[:QUANT_CALIB])} molecules "
          f"without an isolated atom: head MSE vs the teacher {pre:.6e} -> "
          f"{post:.6e} (best step {r1['best_step']}); two runs bitwise; on "
          f"the first {QUANT_CALIB} test molecules, isolated atoms "
          f"included, best step {r_all['best_step']} "
          f"({sum(r_all['head_mse_vs_teacher_pre']):.6e} -> "
          f"{sum(r_all['head_mse_vs_teacher_post']):.6e}) (card: {card})",
          flush=True)

    # ------------------------------------------------ (d) remat
    base_cfg, splits = csce["base_cfg"], csce["splits"]
    remat_cfg = copy.deepcopy(base_cfg)
    remat_cfg["NeuralNetwork"]["Training"]["conv_checkpointing"] = True
    label = "csce PNA (dense) remat"
    graph_parity(torch, remat_cfg, splits, device, label, CSCE_GROUP)
    rec = {}
    grads = {}
    for tag, cfg_ in (("plain", base_cfg), ("remat", remat_cfg)):
        m, state, step_, loader, _, mcfg_ = train_parts(torch, cfg_, splits,
                                                        device)
        loader.set_epoch(0)
        batch = next(iter(loader)).to(device)
        loss_fn = tstep.make_loss_fn(m, mcfg_, "mse")
        m.train()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        total, _ = loss_fn(batch)
        g = torch.autograd.grad(total, list(m.parameters()))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        grads[tag] = (float(total.detach()),
                      [t.detach().clone() for t in g])
        del g, total
        # the captured step on a fresh copy, once the eager pass's garbage
        # is collected: a capture during which the collector frees a
        # default-stream backward's tensors fails
        # (cudaErrorStreamCaptureImplicit), with or without remat
        gc.collect()
        m, state, step_, loader, _, _ = train_parts(torch, cfg_, splits,
                                                    device)
        step_(state, batch)
        torch.cuda.synchronize()
        cap = next(iter(step_.steps.graphs.values()))
        nodes = check_graph_kernels(cap, f"csce PNA (dense) {tag} S1")
        ms = float(np.median(step_events_ms(torch,
                                            lambda: step_(state, batch))))
        rec[tag] = dict(peak_mib_forward_backward=peak, step_ms=ms,
                        kernel_nodes=nodes,
                        launches_per_captured_step={
                            k: v for k, v in cap.launches.items() if v})
    (la, ga), (lb, gb) = grads["plain"], grads["remat"]
    if la != lb or not all(torch.equal(a, b) for a, b in zip(ga, gb)):
        fail("phase 17d: the remat step's loss or gradients differ from "
             "the step without remat")
    out["remat"] = dict(rec, loss_and_gradients_bitwise=True,
                        captured_equals_eager=True)
    print(f"phase 17d: conv_checkpointing: loss and every gradient bitwise "
          f"the step without it; captured = eager; peak allocated "
          f"{rec['remat']['peak_mib_forward_backward']:.1f} MiB vs "
          f"{rec['plain']['peak_mib_forward_backward']:.1f} without; captured "
          f"step {rec['remat']['step_ms']:.3f} ms vs "
          f"{rec['plain']['step_ms']:.3f}; kernel nodes (= launches, the "
          f"recompute's included) {rec['remat']['kernel_nodes']} vs "
          f"{rec['plain']['kernel_nodes']} (card: {card})", flush=True)

    # ------------------------------------------------ (e) fault sites
    keys = ("train_loss", "val_loss", "test_loss", "lr")
    cfg = copy.deepcopy(base_cfg)
    cfg["Dataset"] = {"name": "chip_smoke_faults"}
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(num_epoch=3, Checkpoint=True, checkpoint_every_n_epochs=1)
    run_dir = os.path.join("logs", get_log_name_config(cfg))
    shutil.rmtree(run_dir, ignore_errors=True)
    _, h_ref, _, _ = run_training(copy.deepcopy(cfg), splits, device=device)
    shutil.rmtree(run_dir, ignore_errors=True)
    # the kill lands in epoch 1, after epoch 0's save committed
    per_epoch = max(len(splits[0]) // int(tr["batch_size"]), 1)
    plan = f"forward-step@{per_epoch + per_epoch // 2}"
    kill = copy.deepcopy(cfg)
    kill["NeuralNetwork"]["Training"]["fault_plan"] = plan
    try:
        run_training(kill, splits, device=device)
        fail(f"phase 17e: {plan} did not stop the run")
    except InjectedFault as exc:
        killed = str(exc)
    cfg["NeuralNetwork"]["Training"]["continue"] = 1
    _, h_res, _, _ = run_training(copy.deepcopy(cfg), splits, device=device)
    shutil.rmtree(run_dir, ignore_errors=True)
    if any(h_res[k] != h_ref[k] for k in keys):
        fail("phase 17e: the resumed trajectory differs from the "
             "uninterrupted one")
    out["faults"] = dict(plan=plan, raised=killed,
                         trajectory_bitwise=True,
                         train_loss=h_res["train_loss"])
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17e: {killed}; resumed with continue: 1, the train/val/"
          f"test/lr trajectory {h_res['train_loss']} bitwise the "
          f"uninterrupted run's (card: {card})", flush=True)
    print(f"phase 17: {out['seconds']:.1f} s", flush=True)
    return out, launches


# --------------------------------------------------------------- phase 18

SPMD_WORLD = 2                 # ranks sharing the card over gloo (18b-c)
SPMD_TIMEOUT_S = 420           # the children's bound, build and CPU epoch in
SPMD_TIMED_STEPS = 10          # steps timed after 2 warm-up steps
SPMD_LJ_STEPS = 2              # 18c: LJ SchNet EF steps a rank
# the kernels each part's path runs
SPMD_KERNELS = ("nbr_aggregate", "nbr_aggregate_backward", "segment_sum")
SPMD_LJ_KERNELS = ("filter_scatter", "filter_scatter_backward",
                   "segment_sum")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def state_digest(state_dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(state_dict.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def time_train_steps(torch, step, state, batch, steps=SPMD_TIMED_STEPS):
    """(ms a step, collectives' ms a step or None): `steps` calls of a
    train step on one placed batch after 2 warm-up calls (the capture
    among them), each call's metrics read on the host, the last one
    synchronized."""
    for _ in range(2):
        state, m = step(state, batch)
        float(m["loss"])
    if hasattr(step, "reset_timing"):
        step.reset_timing()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        float(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    coll = getattr(step, "collective_ms", None)
    return ms, (None if coll is None else coll / steps)


def spmd_step_times(torch, cfg, splits, device, zero=False):
    """The SPMD step of this rank (and, outside a group of W > 1, the
    single-device step) timed on the rank's first loader batch of a
    fresh seeded model: {spmd_ms, collective_ms, collective_share,
    single_ms}."""
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel.mesh import get_comm_size_and_rank
    from hydragnn_tpu_torch.parallel.multiprocess import (allreduce_max_int,
                                                          slice_by_process)
    from hydragnn_tpu_torch.parallel.spmd import (SpmdTrainStep,
                                                  make_zero_partition)
    from hydragnn_tpu_torch.preprocess.load_data import (create_dataloaders,
                                                         loader_budgets)
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_train_step)
    world = get_comm_size_and_rank()[0]
    full = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = tcfg.build_model_config(full)
    tr = full["NeuralNetwork"]["Training"]
    local = int(tr["batch_size"]) // world
    parts = [slice_by_process(s, underflow="replicate") for s in splits]
    n_node, n_edge, k = loader_budgets(sum(parts, []), local, True,
                                       reduce_fn=allreduce_max_int)
    loader = create_dataloaders(*parts, local, neighbor_format=True,
                                n_node=n_node, n_edge=n_edge,
                                neighbor_k=k)[0]
    loader.set_epoch(0)
    batch = next(iter(loader)).to(device)
    out = {}
    model = create_model(mcfg, device=device)
    tx = select_optimizer(tr)
    part = (make_zero_partition(list(model.parameters()))
            if zero else None)
    state = TrainState.create(model, tx, zero=part)
    spmd = SpmdTrainStep(model, mcfg, tx)
    out["spmd_ms"], out["collective_ms"] = time_train_steps(
        torch, spmd, state, batch)
    out["collective_share"] = out["collective_ms"] / out["spmd_ms"]
    if world == 1:
        model = create_model(mcfg, device=device)
        state = TrainState.create(model, tx)
        out["single_ms"], _ = time_train_steps(
            torch, make_train_step(model, mcfg, tx), state, batch)
    return out


def spmd_child(rank: str, world: str, rdzv: str, out_path: str) -> int:
    """18b-c in one rank of SPMD_WORLD sharing the card over gloo: csce
    PNA run_training with num_shards=world for one epoch, ZeRO off, ZeRO
    on and on the CPU; the ZeRO-off and -on steps timed; then LJ SchNet
    EF for SPMD_LJ_STEPS steps. Writes the histories, state digests,
    optimizer bytes, timings and launch counts as JSON to `out_path`."""
    import torch
    import torch.distributed as dist
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
    from hydragnn_tpu_torch.kernels import _build
    from hydragnn_tpu_torch.parallel.mesh import init_distributed
    rank, world = int(rank), int(world)
    t_start = time.perf_counter()
    # the ranks share the host's cores (the CPU run's intra-op threads)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    device = torch.device("cuda", 0)
    init_distributed(coordinator=f"file://{rdzv}", num_processes=world,
                     process_id=rank, timeout_s=120, backend="gloo",
                     device=device)
    _build.build_all()
    base_cfg, splits, _, _ = csce_setup(torch)
    cfg = copy.deepcopy(base_cfg)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    out = {"rank": rank, "runs": {}, "timing": {}, "launches": {}}
    sgd = {"type": "SGD", "learning_rate": cfg["NeuralNetwork"]["Training"][
        "Optimizer"].get("learning_rate", 1e-3)}
    # the config's optimizer (AdamW: two slots for ZeRO to split) with and
    # without ZeRO; SGD on the card and on the CPU for the standing
    # card-vs-CPU bound (Adam turns gradient noise below its eps into
    # full-size updates: phase 5 holds SGD too)
    for name, zero, dev, opt in (("card", False, device, None),
                                 ("card_zero", True, device, None),
                                 ("card_sgd", False, device, sgd),
                                 ("cpu_sgd", False, "cpu", sgd)):
        c = copy.deepcopy(cfg)
        if opt is not None:
            c["NeuralNetwork"]["Training"]["Optimizer"] = dict(opt)
        c["NeuralNetwork"]["Training"]["Optimizer"][
            "use_zero_redundancy"] = zero
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist, model, _ = run_training(c, datasets=splits, device=dev,
                                             num_shards=world)
        if dev is device:
            torch.cuda.synchronize()
            out["launches"][name] = tk.launch_counts()
        out["runs"][name] = dict(
            history={k: hist[k] for k in ("train_loss", "val_loss",
                                          "test_loss")},
            digest=state_digest(state.state_dict()),
            opt_bytes=sum(t.numel() * t.element_size()
                          for ts in state.opt_state.slots.values()
                          for t in ts),
            seconds=time.perf_counter() - t0)
        if name in ("card", "card_zero"):
            out["timing"][name] = spmd_step_times(torch, c, splits, device,
                                                  zero=zero)
    with open(LJ_CONFIG) as fh:
        lj_cfg = json.load(fh)
    lj_cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    lj_cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    n_tr, n_va = int(0.6 * NUM_LJ), int(0.2 * NUM_LJ)
    lj = lj_configurations(NUM_LJ, seed=SEED)
    os.environ["HYDRAGNN_MAX_NUM_BATCH"] = str(SPMD_LJ_STEPS)
    tk.reset_launch_counts()
    state, hist, _, _ = run_training(
        lj_cfg, datasets=(lj[:n_tr], lj[n_tr:n_tr + n_va], lj[n_tr + n_va:]),
        device=device, num_shards=world)
    torch.cuda.synchronize()
    del os.environ["HYDRAGNN_MAX_NUM_BATCH"]
    out["launches"]["lj"] = tk.launch_counts()
    out["runs"]["lj"] = dict(
        history={k: hist[k] for k in ("train_loss", "val_loss",
                                      "test_loss")},
        digest=state_digest(state.state_dict()), steps=int(state.step))
    out["seconds"] = time.perf_counter() - t_start
    with open(out_path + ".tmp", "w") as fh:
        json.dump(out, fh)
    os.replace(out_path + ".tmp", out_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spmd_phase(torch, device, card, counted, csce):
    """Phase 18 (see the module docstring): (record, launches)."""
    import tempfile

    import torch.distributed as dist
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.parallel.mesh import init_distributed
    base_cfg, splits = csce["base_cfg"], csce["splits"]
    cfg = copy.deepcopy(base_cfg)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    rec, launches = {}, {}

    def add(counts):
        counted(counts)
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    # (a) a world-1 NCCL group in this process, beside no group
    t0 = time.perf_counter()
    _, h_ref, model_ref, _ = run_training(copy.deepcopy(cfg), datasets=splits,
                                          device=device)
    torch.cuda.synchronize()
    ref = state_digest(model_ref.state_dict())
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    world = init_distributed(coordinator=f"tcp://127.0.0.1:{free_port()}",
                             num_processes=1, process_id=0, timeout_s=120,
                             device=device)
    try:
        if world != (1, 0) or dist.get_backend() != "nccl":
            fail(f"phase 18a: group {world}, backend {dist.get_backend()}")
        tk.reset_launch_counts()
        _, h_grp, model_grp, _ = run_training(copy.deepcopy(cfg),
                                              datasets=splits, device=device)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        add(counts)
        got = state_digest(model_grp.state_dict())
        same = got == ref and all(h_grp[k] == h_ref[k] for k in
                                  ("train_loss", "val_loss", "test_loss"))
        times = spmd_step_times(torch, cfg, splits, device)
    finally:
        dist.destroy_process_group()
    print(f"phase 18a: csce PNA (dense) one epoch in a world-1 NCCL group, "
          f"captured (the all-reduce between the forward+backward graph and "
          f"the update graph): bitwise no group: {same}; train "
          f"{h_grp['train_loss']} val {h_grp['val_loss']}; launches {counts}"
          f"; SPMD step {times['spmd_ms']:.3f} ms (collectives "
          f"{times['collective_ms']:.3f} ms, share "
          f"{times['collective_share']:.3f}) vs the single-device step "
          f"{times['single_ms']:.3f} ms on the same batch (phase 5's "
          f"captured step: "
          f"{csce['paths']['csce_pna_dense']['graph_S1']['step_ms']:.3f}"
          f" ms); {time.perf_counter() - t0:.1f} s (card: {card})",
          flush=True)
    if not same:
        fail("phase 18a: the world-1 group's run differs from no group")
    for name in SPMD_KERNELS:
        if counts.get(name, 0) == 0:
            fail(f"phase 18a: {name} never launched")
    rec["a"] = dict(bitwise_no_group=same, allreduce_route="between graphs",
                    launches=counts, **times)

    # (b, c) two ranks sharing the card over gloo
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hydragnn_spmd_") as tmp:
        procs = []
        for r in range(SPMD_WORLD):
            log = open(f"{tmp}/rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, __file__, "--spmd-rank", str(r),
                 str(SPMD_WORLD), f"{tmp}/rdzv", f"{tmp}/rank{r}.json"],
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + SPMD_TIMEOUT_S
        bad = []
        try:
            for r, (proc, log) in enumerate(procs):
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    bad.append(f"rank {r} outlasted {SPMD_TIMEOUT_S} s")
                    break
                if proc.returncode != 0:
                    bad.append(f"rank {r} exited {proc.returncode}")
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        if bad:
            tails = []
            for r in range(SPMD_WORLD):
                with open(f"{tmp}/rank{r}.log") as fh:
                    tails.append(f"--- rank {r}\n{fh.read()[-3000:]}")
            fail("phase 18b: " + "; ".join(bad) + "\n" + "\n".join(tails))
        ranks = []
        for r in range(SPMD_WORLD):
            with open(f"{tmp}/rank{r}.json") as fh:
                ranks.append(json.load(fh))
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        for part in ("card", "card_zero", "card_sgd", "lj"):
            add(r["launches"][part])
    equal_ranks = all(r["runs"][k]["digest"] == r0["runs"][k]["digest"]
                      and r["runs"][k]["history"] == r0["runs"][k]["history"]
                      for r in ranks for k in r0["runs"])
    zero_same = all(r["runs"]["card_zero"]["digest"] ==
                    r["runs"]["card"]["digest"] and
                    r["runs"]["card_zero"]["history"] ==
                    r["runs"]["card"]["history"] for r in ranks)
    gaps = history_gaps(r0["runs"]["card_sgd"]["history"],
                        r0["runs"]["cpu_sgd"]["history"])
    for r in ranks:
        t = r["timing"]
        print(f"phase 18b: rank {r['rank']}: optimizer state "
              f"{r['runs']['card']['opt_bytes']} bytes, ZeRO "
              f"{r['runs']['card_zero']['opt_bytes']} bytes; step "
              f"{t['card']['spmd_ms']:.3f} ms (collectives "
              f"{t['card']['collective_ms']:.3f} ms, share "
              f"{t['card']['collective_share']:.3f}), ZeRO "
              f"{t['card_zero']['spmd_ms']:.3f} ms (collectives "
              f"{t['card_zero']['collective_ms']:.3f} ms, share "
              f"{t['card_zero']['collective_share']:.3f}); launches "
              f"{r['launches']['card']}; {r['seconds']:.1f} s", flush=True)
    print(f"phase 18b: csce PNA num_shards={SPMD_WORLD}, two ranks on one "
          f"card over gloo, one epoch: ranks bitwise {equal_ranks}; ZeRO "
          f"bitwise no ZeRO {zero_same}; SGD card vs cpu (same group) "
          f"relative gaps {gaps}; train "
          f"{r0['runs']['card']['history']['train_loss']}"
          f" val {r0['runs']['card']['history']['val_loss']}; {wall:.1f} s "
          f"(card: {card})", flush=True)
    lj_h = r0["runs"]["lj"]["history"]
    print(f"phase 18c: LJ SchNet EF num_shards={SPMD_WORLD}, "
          f"{r0['runs']['lj']['steps']} steps a rank: train "
          f"{lj_h['train_loss']} val {lj_h['val_loss']}; launches "
          f"{[r['launches']['lj'] for r in ranks]} (card: {card})",
          flush=True)
    if not equal_ranks:
        fail("phase 18b: the two ranks' runs differ")
    if not zero_same:
        fail("phase 18b: ZeRO's run differs from the replicated run")
    for k, v in gaps.items():
        bound = TRAIN_RTOL if k == "train_loss" else EVAL_RTOL
        if not v <= bound:
            fail(f"phase 18b: {k} card vs cpu gap {v} above {bound}")
    for r in ranks:
        for part, names in (("card", SPMD_KERNELS),
                            ("card_zero", SPMD_KERNELS),
                            ("card_sgd", SPMD_KERNELS),
                            ("lj", SPMD_LJ_KERNELS)):
            for name in names:
                if r["launches"][part].get(name, 0) == 0:
                    fail(f"phase 18: {name} never launched on rank "
                         f"{r['rank']}'s {part} path")
        if r["runs"]["lj"]["steps"] != SPMD_LJ_STEPS or not np.isfinite(
                r["runs"]["lj"]["history"]["train_loss"]).all():
            fail(f"phase 18c: rank {r['rank']}: {r['runs']['lj']}")
    rec["b"] = dict(ranks_bitwise=equal_ranks, zero_bitwise=zero_same,
                    card_cpu_relative_gaps=gaps, wall_s=wall,
                    allreduce_route="between graphs (gloo)",
                    ranks=[dict(rank=r["rank"], timing=r["timing"],
                                opt_bytes={k: r["runs"][k]["opt_bytes"]
                                           for k in ("card", "card_zero")},
                                seconds=r["seconds"]) for r in ranks])
    rec["c"] = dict(history=lj_h, launches=[r["launches"]["lj"]
                                            for r in ranks])
    return rec, launches

# ------------------------------------------------------------- phase 19 --
PIPE_CONFIG = "examples/deep_stack/deep_stack_32l.json"
NUM_PIPE = 512                 # BCC lattices
PIPE_EPOCHS = 2                # deep_stack_32l.json trains 10; cut for time
PIPE_STAGES_19C = 2            # csce PNA and LJ SchNet's pipelines
PIPE_KERNELS = ("filter_scatter", "filter_scatter_backward", "segment_sum")


@contextlib.contextmanager
def env_set(**values):
    """os.environ with `values` set, put back after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pipe_parts(torch, cfg, splits, device, stages, **step_kw):
    """(model, state, step, batch) of a pipelined config: the model made
    from its seed on `stages` stage devices all `device`, its train step
    (the config's schedule and remat unless `step_kw` says otherwise) and
    the first stacked loader batch on `device`."""
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import data_input_dim
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    from hydragnn_tpu_torch.utils.envflags import resolve_pipeline
    done = tcfg.update_config(copy.deepcopy(cfg), *splits)
    arch, tr = (done["NeuralNetwork"]["Architecture"],
                done["NeuralNetwork"]["Training"])
    mcfg = data_input_dim(tcfg.build_model_config(done), splits[0])
    micro, sched, remat, _ = resolve_pipeline(tr, stages)
    loader = create_dataloaders(
        *splits, int(tr["batch_size"]),
        neighbor_format=bool(arch.get("neighbor_format", True)),
        num_shards=micro)[0]
    loader.set_epoch(0)
    batch = next(iter(loader)).to(device)
    model = tpt.create_pipeline_model(mcfg, [device] * stages)
    tx = select_optimizer(tr)
    kw = dict(schedule=sched, remat=remat is not None, remat_policy=remat)
    kw.update(step_kw)
    make = (tpt.make_pipeline_ef_train_step if tr.get("compute_grad_energy")
            else tpt.make_pipeline_train_step)
    step = make(model, tx, tr.get("loss_function_type", "mse"), **kw)
    return model, TrainState.create(model, tx), step, batch


def pipe_config():
    """deep_stack_32l.json on the edge list (B4 in every block; the
    dense default sums the filter by K slots in torch ops)."""
    with open(PIPE_CONFIG) as fh:
        cfg = json.load(fh)
    cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    return cfg


def deep_stack_training(torch, device, card, add, splits, devs):
    """19a: (record). run_training of the deep stack on the card, held
    finite and falling; the first step card vs CPU; SGD card vs CPU."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    cfg = pipe_config()
    tr = cfg["NeuralNetwork"]["Training"]
    tr["num_epoch"] = PIPE_EPOCHS
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist, model, done = run_training(
        copy.deepcopy(cfg), datasets=splits, device=device,
        pipeline_devices=devs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    add(counts)
    print(f"phase 19a: deep_stack_32l.json (SchNet hidden 64, 32 layers, "
          f"4 stages x {tr['pipeline_microbatches']} microbatches, "
          f"{tr['pipeline_schedule']}, remat {tr['pipeline_remat']}) on "
          f"{len(splits[0])} train lattices, batch {tr['batch_size']}, "
          f"{PIPE_EPOCHS} of {json.load(open(PIPE_CONFIG))['NeuralNetwork']['Training']['num_epoch']} "
          f"epochs, edge list, pipeline_devices {[str(d) for d in devs]}: "
          f"{wall:.1f} s; train {hist['train_loss']} val {hist['val_loss']}"
          f" test {hist['test_loss']}; graph captures "
          f"{hist['graph_captures']}; launches {counts}", flush=True)
    if model is not None:
        fail("phase 19a: a pipelined run_training returned a model")
    for k in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(hist[k]).all():
            fail(f"phase 19a: non-finite {k} {hist[k]}")
    if not hist["train_loss"][-1] < hist["train_loss"][0]:
        fail(f"phase 19a: the train loss did not fall {hist['train_loss']}")
    for name in PIPE_KERNELS:
        if counts[name] == 0:
            fail(f"phase 19a: {name} never launched in the stages")
    # SGD card vs CPU from the same seed, one step: its train loss is the
    # first step's, held within 1e-4; val / test after it within EVAL_RTOL
    sgd = copy.deepcopy(cfg)
    sgd["NeuralNetwork"]["Training"].update(
        num_epoch=1, Optimizer={"type": "SGD", "learning_rate": 1e-3})
    env = dict(HYDRAGNN_MAX_NUM_BATCH=1)
    cpu_run = cpu_submit(cpu_training, copy.deepcopy(sgd), splits, env, 4,
                         pipeline_devices=["cpu"] * 4)
    with env_set(**env):
        _, h_card, _, _ = run_training(
            copy.deepcopy(sgd), datasets=splits, device=device,
            pipeline_devices=[device] * 4)
    rec = {}

    def hold_sgd(run):
        h_cpu, t_cpu = run
        gaps = history_gaps(h_card, h_cpu)
        losses = {str(device): h_card["train_loss"][0],
                  "cpu": h_cpu["train_loss"][0]}
        print(f"phase 19a SGD first step card vs cpu ({t_cpu:.1f} s on a "
              f"cpu worker): train loss card {losses[str(device)]!r} cpu "
              f"{losses['cpu']!r}; relative gaps {gaps} (first step 1e-4, "
              f"val/test {EVAL_RTOL})", flush=True)
        for k, v in gaps.items():
            bound = 1e-4 if k == "train_loss" else EVAL_RTOL
            if not v <= bound:
                fail(f"phase 19a: SGD {k} card vs cpu gap {v} above {bound}")
        rec.update(first_step_losses=losses,
                   first_step_gap=gaps["train_loss"], sgd_gaps=gaps)
    cpu_then(cpu_run, hold_sgd)
    # the captured step alone: CUDA events, one profiled replay
    model, st, step, batch = pipe_parts(torch, cfg, splits, device, 4)
    times = step_events_ms(torch, lambda: step(st, batch), reps=5)
    cap = next(iter(step.steps.graphs.values()))
    prof = device_profile(torch, cap.replay)
    dev_ms, events, _ = profile_rows(torch, prof)
    step_ms = float(np.median(times))
    graphs = int(batch.graph_mask.sum())
    print(f"phase 19a captured step: {step_ms:.3f} ms (median of 5; "
          f"{min(times):.3f}-{max(times):.3f}), one replay's device "
          f"{dev_ms:.3f} ms in {events} device events, idle share "
          f"{max(0.0, 1 - dev_ms / step_ms):.3f}, {graphs} graphs a step "
          f"({graphs / step_ms * 1e3:.1f} graphs/s); kernel launches a "
          f"step {dict((k, v) for k, v in cap.launches.items() if v)} "
          f"(card: {card})", flush=True)
    rec.update(history={k: hist[k] for k in ("train_loss", "val_loss",
                                             "test_loss")},
               wall_s=wall, launches=counts, step_ms=step_ms,
               step_ms_range=[min(times), max(times)], device_ms=dev_ms,
               device_events=events, graphs_per_step=graphs,
               launches_per_step={k: v for k, v in cap.launches.items()
                                  if v})
    return rec


def exact_problem(torch, device, n, f, layers, micro):
    """Integer features, signed permutation weights with integer biases,
    one in-edge a node: over 32 layers every value stays a small integer
    and every gradient a sum of integer products, exact in float32 in
    any order."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(-1, 2, (micro, n, f)).astype(
        np.float32)).to(device)
    st = [(torch.from_numpy(rng.permutation(n)).to(device),
           torch.from_numpy(rng.permutation(n)).to(device))
          for _ in range(micro)]
    lins = []
    for _ in range(layers):
        lin = torch.nn.Linear(f, f).to(device)
        w = np.zeros((f, f), np.float32)
        w[np.arange(f), rng.permutation(f)] = rng.choice([-1.0, 1.0], f)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(
                rng.randint(-1, 2, (f,)).astype(np.float32)))
        lins.append(lin)
    return x, st, lins


def exact_schedules(torch, device, n, f, layers, stages, micro):
    """gpipe, 1f1b (windows of S) and the sequential stack's gradients
    on exact data, on the stage streams: (all bitwise, max |grad|)."""
    from hydragnn_tpu_torch.parallel import pipeline as tpipe
    x, st, lins = exact_problem(torch, device, n, f, layers, micro)
    params = [p for lin in lins for p in lin.parameters()]
    per = layers // stages

    def layer(lin, h, s):
        send, recv = s
        # one in-edge a node: the scatter moves each row to its receiver
        return torch.relu(lin(torch.zeros_like(h).index_add_(
            0, recv, h[send])))

    apply = tpipe.make_pipeline_apply([device] * stages, layer, layers)
    stage_layers = [lins[s * per:(s + 1) * per] for s in range(stages)]

    def grads(outs):
        g = torch.autograd.grad(
            torch.stack([(o ** 2).sum() for o in outs]).sum() / micro,
            params)
        tpipe.join_stage_streams([device] * stages)
        return g
    seq = []
    for m in range(micro):
        h = x[m]
        for lin in lins:
            h = layer(lin, h, st[m])
        seq.append(h)
    g_seq = grads(seq)
    g_gpipe = grads(apply(stage_layers, list(x), [st] * stages))
    g_1f1b = [torch.zeros_like(p) for p in params]
    for w in range(micro // stages):
        sl = slice(w * stages, (w + 1) * stages)
        torch._foreach_add_(g_1f1b, list(grads(apply(
            stage_layers, list(x[sl]), [st[sl]] * stages))))
    same = all(torch.equal(a, b) for g in (g_gpipe, g_1f1b)
               for a, b in zip(g, g_seq))
    return same, max(float(g.abs().max()) for g in g_seq)


def peak_step_mib(torch, step, state, batch):
    """Peak allocated MiB above the live tensors of one eager step."""
    snap = state.copy()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step.eager(state, batch)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    state.restore(snap)
    return peak


def pipeline_contracts(torch, device, card, splits):
    """19b: the schedule's contracts on the card at the deep-stack shape;
    (record)."""
    from hydragnn_tpu_torch.datasets.loader import unstack_batch
    from hydragnn_tpu_torch.parallel import pipeline as tpipe
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    cfg = pipe_config()
    tr = cfg["NeuralNetwork"]["Training"]
    S, M = int(tr["pipeline_stages"]), int(tr["pipeline_microbatches"])
    model, state, step, batch = pipe_parts(torch, cfg, splits, device, S)
    micros = unstack_batch(batch)
    with torch.no_grad():
        pipe = tpt.make_pipeline_forward(model)(micros)
        seq = tpt.make_pipeline_forward(model, pipelined=False)(micros)
    fwd_same = all(torch.equal(a[0][0], b[0][0]) for a, b in zip(pipe, seq))

    def params_after(run):
        snap = state.copy()
        run()
        torch.cuda.synchronize()
        out = [p.detach().clone() for p in state.params.values()]
        state.restore(snap)
        return out
    plain = tpt.make_pipeline_train_step(model, step.steps.tx,
                                         schedule="1f1b")
    remat_after = params_after(lambda: step.eager(state, batch))
    plain_after = params_after(lambda: plain.eager(state, batch))
    remat_same = all(torch.equal(a, b)
                     for a, b in zip(remat_after, plain_after))
    captured_after = params_after(lambda: step(state, batch))
    captured_same = all(torch.equal(a, b)
                        for a, b in zip(captured_after, remat_after))
    n = int(batch.x.shape[1])
    exact_same, gmax = exact_schedules(
        torch, device, n, int(model.cfg.hidden_dim),
        int(model.cfg.num_conv_layers), S, M)
    print(f"phase 19b at the deep-stack shape ({M} microbatches of N={n}, "
          f"32 layers, width {model.cfg.hidden_dim}, {S} streams): "
          f"pipelined forward bitwise sequential {fwd_same}; one 1f1b step "
          f"remat full vs off bitwise {remat_same}; captured vs eager "
          f"bitwise {captured_same}; gpipe and 1f1b vs sequential gradients "
          f"on exact data bitwise {exact_same} (max |grad| {gmax})",
          flush=True)
    for ok, what in ((fwd_same, "pipelined vs sequential forward"),
                     (remat_same, "remat on vs off"),
                     (captured_same, "captured vs eager"),
                     (exact_same and gmax > 0, "gpipe/1f1b on exact data")):
        if not ok:
            fail(f"phase 19b: {what} not bitwise")
    gpipe = tpt.make_pipeline_train_step(model, step.steps.tx,
                                         schedule="gpipe")
    mib = {"gpipe_no_remat": peak_step_mib(torch, gpipe, state, batch),
           "1f1b_remat_full": peak_step_mib(torch, step, state, batch)}
    print(f"phase 19b peak allocated MiB above the live tensors, one eager "
          f"step: gpipe without remat {mib['gpipe_no_remat']:.1f}, 1f1b "
          f"with full remat {mib['1f1b_remat_full']:.1f} (ratio "
          f"{mib['gpipe_no_remat'] / mib['1f1b_remat_full']:.2f}) "
          f"(card: {card})", flush=True)
    one = tpt.make_pipeline_train_step(model, step.steps.tx, schedule="1f1b",
                                       remat=True, stage_streams=False)
    timing = {}
    for name, st_ in (("streams_4", step), ("stream_1", one),
                      ("streams_4_again", step), ("stream_1_again", one)):
        snap = state.copy()
        times = step_events_ms(torch, lambda: st_(state, batch), reps=5)
        state.restore(snap)
        timing[name] = float(np.median(times))
    bubble = tpipe.train_bubble_fraction(S, M, "1f1b")
    print(f"phase 19b captured 1f1b + remat step ms (median of 5, in "
          f"turns): {timing}; closed-form train bubble {bubble:.4f} "
          f"(train ticks {tpipe.train_step_ticks(S, M, '1f1b')}) (card: "
          f"{card})", flush=True)
    return dict(forward_bitwise=fwd_same, remat_bitwise=remat_same,
                captured_bitwise=captured_same, exact_bitwise=exact_same,
                peak_mib=mib, step_ms=timing, train_bubble=bubble)


def pipeline_phase(torch, device, card, counted, csce, lj_splits):
    """Phase 19 (see the module docstring): (record, launches)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.graphs.synthetic import bcc_lattices
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        counted(counts)
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    cfg = pipe_config()
    arch = cfg["NeuralNetwork"]["Architecture"]
    samples = bcc_lattices(NUM_PIPE, radius=float(arch["radius"]),
                           max_neighbours=int(arch["max_neighbours"]),
                           seed=SEED)
    splits = split_dataset(samples,
                           float(cfg["NeuralNetwork"]["Training"][
                               "perc_train"]))
    # the caller's choice, printed: every stage on the one card
    devs = [torch.device("cuda", 0) if device.type == "cuda" else device
            ] * int(cfg["NeuralNetwork"]["Training"]["pipeline_stages"])
    t0 = time.perf_counter()
    rec = {"a": deep_stack_training(torch, devs[0], card, add, splits, devs)}
    rec["a"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["b"] = pipeline_contracts(torch, devs[0], card, splits)
    rec["b"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # (c) csce PNA through two stages, dense: B1 and its backward
    pna = copy.deepcopy(csce["base_cfg"])
    pna["NeuralNetwork"]["Training"].update(
        pipeline_stages=PIPE_STAGES_19C, pipeline_norm="layernorm",
        num_epoch=1)
    tk.reset_launch_counts()
    _, h_pna, _, _ = run_training(pna, datasets=csce["splits"],
                                  device=device,
                                  pipeline_devices=[device] * 2)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    add(counts)
    print(f"phase 19c: csce PNA (6 layers, width 200) over 2 stages, one "
          f"epoch, dense: train {h_pna['train_loss']} val "
          f"{h_pna['val_loss']}; launches {counts}", flush=True)
    for name in ("nbr_aggregate", "nbr_aggregate_backward", "segment_sum"):
        if counts[name] == 0:
            fail(f"phase 19c: {name} never launched in the stages")
    if not np.isfinite(h_pna["train_loss"]).all():
        fail(f"phase 19c: non-finite loss {h_pna['train_loss']}")
    # (d) LJ SchNet EF through two stages, the coordinates carried
    with open(LJ_CONFIG) as fh:
        lj = json.load(fh)
    lj["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    lj["NeuralNetwork"]["Training"].update(
        pipeline_stages=PIPE_STAGES_19C, pipeline_norm="layernorm",
        num_epoch=1)
    tk.reset_launch_counts()
    with env_set(HYDRAGNN_MAX_NUM_BATCH=2):
        _, h_lj, _, _ = run_training(lj, datasets=lj_splits, device=device,
                                     pipeline_devices=[device] * 2)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    add(counts)
    print(f"phase 19d: LJ SchNet EF (equivariant, node mlp head) over 2 "
          f"stages, two steps, edge list: train {h_lj['train_loss']} "
          f"energy {h_lj['energy_loss']} force {h_lj['force_loss']}; "
          f"launches {counts}", flush=True)
    for name in PIPE_KERNELS:
        if counts[name] == 0:
            fail(f"phase 19d: {name} never launched in the stages")
    for k in ("train_loss", "energy_loss", "force_loss"):
        if not np.isfinite(h_lj[k]).all():
            fail(f"phase 19d: non-finite {k} {h_lj[k]}")
    rec.update(c=dict(history=h_pna["train_loss"]),
               d=dict(train_loss=h_lj["train_loss"],
                      force_loss=h_lj["force_loss"]),
               cd_phase_s=time.perf_counter() - t0,
               wall_s=time.perf_counter() - t_phase,
               launches=launches)
    print(f"phase 19 took {rec['wall_s']:.1f} s; launches {launches} "
          f"(card: {card})", flush=True)
    return rec, launches


# ------------------------------------------------------------- phase 20 --
GP_NODES = 131072              # 20a: the graph of the graph_parallel layers
GP_EDGES = 4194304             # [E, F] float32 messages: 1 GiB
GP_F = 64
GP_SLOTS = 4                   # streams of the one card
GP_REPS = 5                    # timed calls a mode
COMPOSED_GRAPH_SHARDS = 2      # 20b-c
COMPOSED_LR = 1e-3             # the SGD runs held card vs single / CPU
HISTORY_TOL = dict(rtol=2e-3, atol=1e-5)   # JAX tests/test_composite.py
PIPE_DATA_SHARDS = 2           # 20d
PARITY_TOL = dict(rtol=5e-6, atol=1e-7)    # JAX tests/test_pipeline_config


def gp_message(xi, xj, ea):
    return xj * 2.0 + xi * 0.5


def gp_mode_run(torch, layer, args, x, ct):
    """(output, gradient of x) of one forward + VJP of a layer."""
    xg = x.detach().requires_grad_(True)
    out = layer(xg, *args)
    (g,) = torch.autograd.grad(out, xg, ct)
    layer.slots.join()
    return out.detach(), g


def gp_peak_mib(torch, call):
    """Peak allocated MiB above the live tensors of call()."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def gp_layers(torch, device, card, add, reference):
    """20a: the edge-sharded and ring layers on GP_SLOTS streams against
    the single-device B3 sum; (record, segment_sum shapes)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.kernels import segment
    from hydragnn_tpu_torch.parallel import graph_parallel as gp
    n, e, f, D = GP_NODES, GP_EDGES, GP_F, GP_SLOTS
    rng = np.random.default_rng(SEED)
    send = rng.integers(0, n, e, dtype=np.int64).astype(np.int32)
    recv = rng.integers(0, n, e, dtype=np.int64).astype(np.int32)
    mask, send_s, recv_s = gp.shard_edge_arrays(D, send, recv)
    t0 = time.perf_counter()
    buckets = gp.build_ring_buckets(send, recv, n, D)
    host_s = time.perf_counter() - t0
    dev_t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
    edge_args = (dev_t(send_s, torch.int32), dev_t(recv_s, torch.int32),
                 dev_t(mask, torch.bool))
    ring_args = (dev_t(buckets.send_local, torch.int32),
                 dev_t(buckets.recv_local, torch.int32),
                 dev_t(buckets.mask, torch.bool))
    send_t, recv_t = dev_t(send, torch.int64), dev_t(recv, torch.int64)
    edge = gp.make_edge_sharded_layer([device] * D, gp_message, n)
    ring = gp.make_ring_layer([device] * D, gp_message)
    block = buckets.block

    def single(x):
        m = gp_message(segment.gather_rows(x, recv_t),
                       segment.gather_rows(x, send_t), None)
        return segment.segment_sum(m.contiguous(), recv_t, n)

    single.slots = types.SimpleNamespace(join=lambda: None)
    modes = {
        "single": (single, (), lambda x: x, lambda o: o),
        "edge_sharded": (edge, edge_args, lambda x: x, lambda o: o),
        "ring": (ring, ring_args, lambda x: gp.shard_node_array(x, D),
                 lambda o: o.reshape(-1, f)[:n])}
    rec = {"N": n, "E": e, "F": f, "slots": D, "ring_block": block,
           "ring_bucket_rows": int(buckets.mask.shape[-1]),
           "ring_buckets_host_s": host_s}
    for data in ("random", "dyadic"):
        if data == "random":
            x = torch.randn(n, f, generator=torch.Generator().manual_seed(
                SEED)).to(device)
        else:
            x = (torch.randint(-16, 17, (n, f), generator=torch.Generator()
                               .manual_seed(SEED + 1)) / 8.0).to(device)
        ct = (torch.randint(-8, 9, (n, f), generator=torch.Generator()
                            .manual_seed(SEED + 2)) / 8.0).to(device)
        outs = {}
        for name, (layer, args, into, back) in modes.items():
            xin = into(x)
            cin = into(ct)
            out, g = gp_mode_run(torch, layer, args, xin, cin)
            outs[name] = (back(out), back(g))
        ref = outs["single"]
        for name in ("edge_sharded", "ring"):
            for j, what in enumerate(("forward", "vjp")):
                got, want = outs[name][j], ref[j]
                err = float((got - want).abs().max())
                ok = (torch.equal(got, want) if data == "dyadic"
                      else torch.allclose(got, want, **SUM_TOL))
                rec[f"{name}_{what}_{data}_max_abs_err"] = err
                if not ok:
                    fail(f"phase 20a: {name} {what} on {data} data vs the "
                         f"single-device sum: max err {err}")
    # launches a call, times and peak memory, each mode on random data
    x = torch.randn(n, f, generator=torch.Generator().manual_seed(SEED)
                    ).to(device)
    ct = torch.randn(n, f, generator=torch.Generator().manual_seed(
        SEED + 3)).to(device)
    for name, (layer, args, into, back) in modes.items():
        xin, cin = into(x), into(ct)
        tk.reset_launch_counts()
        with torch.no_grad():
            layer(xin, *args)
        torch.cuda.synchronize()
        fwd_launches = tk.launch_counts()["segment_sum"]
        tk.reset_launch_counts()
        gp_mode_run(torch, layer, args, xin, cin)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        (reference if name == "single" else add)(counts)
        with torch.no_grad():
            fwd = step_events_ms(torch, lambda: layer(xin, *args),
                                 reps=GP_REPS)
        both = step_events_ms(
            torch, lambda: gp_mode_run(torch, layer, args, xin, cin),
            reps=GP_REPS)
        mib = gp_peak_mib(torch, lambda: gp_mode_run(torch, layer, args,
                                                     xin, cin))
        slots = 1 if name == "single" else D
        rec[name] = dict(forward_ms=float(np.median(fwd)),
                         forward_vjp_ms=float(np.median(both)),
                         peak_mib=mib, b3_forward_launches=fwd_launches,
                         b3_forward_launches_per_slot=fwd_launches / slots,
                         b3_forward_vjp_launches=counts["segment_sum"])
        print(f"phase 20a {name}: forward {rec[name]['forward_ms']:.3f} ms, "
              f"forward + VJP {rec[name]['forward_vjp_ms']:.3f} ms (median "
              f"of {GP_REPS}); B3 launches a forward {fwd_launches} "
              f"({fwd_launches / slots:g} a slot), a forward + VJP "
              f"{counts['segment_sum']}; peak allocated {mib:.1f} MiB above "
              f"the live tensors (card: {card})", flush=True)
        if name != "single" and fwd_launches == 0:
            fail(f"phase 20a: B3 never launched in the {name} slots")
    print(f"phase 20a: N={n} E={e} F={f} on {D} streams, ring block "
          f"{block}, bucket rows {rec['ring_bucket_rows']} (host bucketing "
          f"{host_s:.2f} s); held vs the single-device B3 sum: within "
          f"{SUM_TOL} on random data, bitwise on dyadic data, forward and "
          f"VJP: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rec.items()
                      if k.endswith("max_abs_err"))
          + f" (card: {card})", flush=True)
    # B3 at the shapes these paths give it, with its bound
    chunk = gp.edge_chunks(e, D)[0]
    ids = recv_t[chunk].to(torch.int32).contiguous()
    data = torch.randn(ids.shape[0], f, generator=torch.Generator()
                       .manual_seed(SEED + 4)).to(device)
    shapes = [segment_shape(torch, "gp_edge_shard", data, ids, n,
                            layout=segment.segment_layout(ids, n),
                            card=card)]
    r, m = ring_args[1][0][0], ring_args[2][0][0]
    # the padding rows of a bucket are zero, as the layer's masked messages
    data = torch.randn(r.shape[0], f, generator=torch.Generator()
                       .manual_seed(SEED + 5)).to(device) * m[:, None]
    shapes.append(segment_shape(torch, "gp_ring_bucket", data, r, block,
                                layout=segment.segment_layout(r, block, m),
                                real=None, card=card))
    return rec, shapes


def composed_parts(torch, cfg, splits, mcfg, device, data, variables,
                   dtype=None):
    """(model, state, train step, first batch) of a composed csce / LJ
    config on `device`: the model from the Flax variables (and it and the
    batch's floats in `dtype` when given), SGD, graph slots
    [device] * (data * COMPOSED_GRAPH_SHARDS)."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel import composite
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    tr = cfg["NeuralNetwork"]["Training"]
    loader = create_dataloaders(*splits, int(tr["batch_size"]),
                                neighbor_format=False, num_shards=data)[0]
    loader.set_epoch(0)
    grid = composite.ComposedGrid(
        [device] * (data * COMPOSED_GRAPH_SHARDS), data,
        COMPOSED_GRAPH_SHARDS)
    batch = composite.place_composed_batch(next(iter(loader)), grid)
    model = create_model(mcfg, device=device)
    model.load_state_dict(load_jax_variables(variables))
    if dtype is not None:
        model.to(dtype)
        batch = batch.replace(**{
            k: getattr(batch, k).to(dtype) for k in (
                "x", "pos", "y_graph", "y_node", "edge_attr", "edge_shifts",
                "energy", "forces") if getattr(batch, k) is not None})
    tx = select_optimizer({"Optimizer": {"type": "SGD",
                                         "learning_rate": COMPOSED_LR}})
    step = composite.make_composed_train_step(
        model, mcfg, tx, grid, tr.get("loss_function_type", "mse"),
        compute_grad_energy=bool(tr.get("compute_grad_energy", False)))
    return model, TrainState.create(model, tx), step, batch


def cpu_composed_step(cfg, splits, mcfg, variables, dtype, threads):
    """One composed SGD step on the CPU (the slots CPU devices) in
    `dtype` ("float32" / "float64") at `threads` threads: (loss, the
    parameters after it, SGD's trace) as float64 numpy vectors."""
    import torch
    own = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return composed_step_vectors(torch, cfg, splits, mcfg,
                                     torch.device("cpu"), variables,
                                     getattr(torch, dtype))
    finally:
        torch.set_num_threads(own)


def composed_step_vectors(torch, cfg, splits, mcfg, device, variables,
                          dtype):
    model, st, step, batch = composed_parts(torch, cfg, splits, mcfg,
                                            device, 1, variables, dtype)
    _, m = step(st, batch)
    return (float(m["loss"]),
            torch.cat([p.detach().reshape(-1).cpu().double()
                       for p in st.params.values()]).numpy(),
            torch.cat([t.detach().reshape(-1).cpu().double()
                       for t in st.opt_state.slots["trace"]]).numpy())


def first_step_card_cpu(torch, cfg, splits, mcfg, device, variables, label):
    """The first composed SGD step on the card, and on the CPU and on the
    CPU in float64 (the slots CPU devices; two CPU workers), from the
    same weights and batch. Held: the loss card vs CPU within 1e-4
    relative, and the parameters after the step as one vector within
    1e-4 relative L2; the update (SGD's trace after one step: the
    gradient it applied, through the cross-slot reductions' backwards
    and, under EF, the double backward through B4 dh on each shard) card
    vs CPU as one vector within max(1e-2, 10 x the CPU float32 update's
    own relative L2 error against float64), `first_step_gradients`'
    bound. Returns the record, filled and printed when the CPU runs are
    checked (`cpu_then`)."""
    cpu_runs = [cpu_submit(cpu_composed_step, cfg, splits, mcfg, variables,
                           dtype, 4) for dtype in ("float32", "float64")]
    card_run = composed_step_vectors(torch, cfg, splits, mcfg, device,
                                     variables, torch.float32)
    rec = {}

    def rel(x, y):
        return float((x - y).norm() / max(float(y.norm()), 1e-30))

    def hold(cpu64):
        (l_card, p_card, u_card), (l_cpu, p_cpu, u_cpu), (_, _, u_64) = (
            [x if isinstance(x, float) else torch.from_numpy(x) for x in r]
            for r in (card_run, cpu_runs[0].get(), cpu64))
        rec.update(card=l_card, cpu=l_cpu,
                   gap=abs(l_card - l_cpu) / max(abs(l_cpu), 1e-12),
                   params_rel_l2=rel(p_card, p_cpu),
                   update_rel_l2=rel(u_card, u_cpu),
                   update_cpu_f64_rel_l2=rel(u_cpu, u_64))
        rec["update_bound"] = max(1e-2, 10 * rec["update_cpu_f64_rel_l2"])
        print(f"phase {label}: {first_step_text(rec)}", flush=True)
        for key, bound in (("gap", 1e-4), ("params_rel_l2", 1e-4),
                           ("update_rel_l2", rec["update_bound"])):
            if not rec[key] <= bound:
                fail(f"phase 20 {label}: first step card vs cpu {key} "
                     f"{rec[key]} above {bound} ({rec})")
    cpu_then(cpu_runs[1], hold)
    return rec


def first_step_text(r):
    return (f"first SGD step card vs cpu: loss {r['card']!r} / {r['cpu']!r}"
            f" (gap {r['gap']:.2e}, bound 1e-4), parameters after it "
            f"{r['params_rel_l2']:.2e} (relative L2, bound 1e-4), the "
            f"update {r['update_rel_l2']:.2e} (bound "
            f"{r['update_bound']:.2e}; cpu float32 vs float64 "
            f"{r['update_cpu_f64_rel_l2']:.2e})")


def captured_vs_eager(torch, model, state, step, batch):
    """Whether one captured step equals one eager step bitwise (metrics
    and every parameter), from the same state."""
    snap = state.copy()
    _, m_e = step.eager(state, batch)
    torch.cuda.synchronize()
    eager = [p.detach().clone() for p in state.params.values()]
    m_e = {k: v.clone() for k, v in m_e.items()}
    state.restore(snap)
    _, m_c = step(state, batch)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in
               zip(eager, state.params.values())) and all(
        torch.equal(m_e[k], m_c[k]) for k in m_e)
    state.restore(snap)
    return same


def composed_csce(torch, device, card, add, reference, csce):
    """20b: (record)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.train.train_step import make_train_step
    cfg = copy.deepcopy(csce["base_cfg"])
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(num_epoch=1, Optimizer={"type": "SGD",
                                      "learning_rate": COMPOSED_LR})
    single_cfg = copy.deepcopy(cfg)
    single_cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = False
    cfg["NeuralNetwork"]["Architecture"]["graph_shards"] = \
        COMPOSED_GRAPH_SHARDS
    rec = {}
    tk.reset_launch_counts()
    _, h_single, _, _ = run_training(copy.deepcopy(single_cfg),
                                     datasets=csce["splits"], device=device)
    torch.cuda.synchronize()
    reference(tk.launch_counts())
    for data in (1, 2):
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        _, hist, model, _ = run_training(
            copy.deepcopy(cfg), datasets=csce["splits"], device=device,
            num_shards=data,
            graph_devices=[device] * (data * COMPOSED_GRAPH_SHARDS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tk.launch_counts()
        add(counts)
        print(f"phase 20b: csce PNA graph_shards {COMPOSED_GRAPH_SHARDS} "
              f"num_shards {data} ({data * COMPOSED_GRAPH_SHARDS} slots on "
              f"one card), one epoch SGD lr {COMPOSED_LR}: {wall:.1f} s; "
              f"train {hist['train_loss']} val {hist['val_loss']} test "
              f"{hist['test_loss']}; graph captures {hist['graph_captures']};"
              f" launches {counts}", flush=True)
        for k in ("train_loss", "val_loss", "test_loss"):
            if not np.isfinite(hist[k]).all():
                fail(f"phase 20b: non-finite {k} {hist[k]}")
        if counts["segment_sum"] == 0:
            fail("phase 20b: B3 never launched in the graph shards")
        if counts["pna_edge_aggregate"] or counts["nbr_aggregate"]:
            fail(f"phase 20b: a fused PNA kernel ran on the sharded route "
                 f"({counts})")
        rec[f"num_shards_{data}"] = dict(
            history={k: hist[k] for k in ("train_loss", "val_loss",
                                          "test_loss")},
            wall_s=wall, launches=counts)
        if data == 1:
            gaps = {k: max(abs(a - b) / max(abs(b), 1e-12) for a, b in
                           zip(hist[k], h_single[k]))
                    for k in ("train_loss", "val_loss", "test_loss")}
            ok = all(np.allclose(hist[k], h_single[k], **HISTORY_TOL)
                     for k in gaps)
            print(f"phase 20b: num_shards 1 vs the single-device edge-list "
                  f"run on the card: train {h_single['train_loss']}; "
                  f"relative gaps {gaps} (bound {HISTORY_TOL})", flush=True)
            if not ok:
                fail(f"phase 20b: history vs single device {gaps}")
            rec["single_history"] = h_single["train_loss"]
            rec["history_gaps"] = gaps
    first = first_step_card_cpu(
        torch, cfg, csce["splits"], csce["mcfg"], device,
        csce["variables"], "20b")
    model, state, step, batch = composed_parts(
        torch, cfg, csce["splits"], csce["mcfg"], device, 1,
        csce["variables"])
    same = captured_vs_eager(torch, model, state, step, batch)
    if not same:
        fail("phase 20b: the captured composed step differs from the eager")
    times = step_events_ms(torch, lambda: step(state, batch), reps=5)
    cap = next(iter(step.steps.graphs.values()), None)
    single = make_train_step(model, csce["mcfg"], step.steps.tx, "mse")
    times_1 = step_events_ms(torch, lambda: single(state, batch), reps=5)
    rec.update(first_step=first, captured_bitwise_eager=same,
               step_ms=float(np.median(times)),
               single_device_step_ms=float(np.median(times_1)),
               launches_per_step={k: v for k, v in (
                   cap.launches if cap else {}).items() if v})
    print(f"phase 20b: captured composed step "
          f"bitwise the eager {same}; captured step "
          f"{rec['step_ms']:.3f} ms on "
          f"{COMPOSED_GRAPH_SHARDS} streams vs the single-device edge-list "
          f"step {rec['single_device_step_ms']:.3f} ms (median of 5); "
          f"launches a composed step {rec['launches_per_step']} (card: "
          f"{card})", flush=True)
    return rec


def composed_lj(torch, device, card, add, lj_splits):
    """20c: LJ SchNet EF with graph_shards 2; (record)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import create_model, data_input_dim
    from hydragnn_tpu_torch.utils.weights import random_flax_variables
    with open(LJ_CONFIG) as fh:
        lj = json.load(fh)
    lj["NeuralNetwork"]["Architecture"].update(
        neighbor_format=False, graph_shards=COMPOSED_GRAPH_SHARDS)
    lj["NeuralNetwork"]["Training"]["num_epoch"] = 1
    tk.reset_launch_counts()
    with env_set(HYDRAGNN_MAX_NUM_BATCH=2):
        _, hist, _, _ = run_training(
            copy.deepcopy(lj), datasets=lj_splits, device=device,
            graph_devices=[device] * COMPOSED_GRAPH_SHARDS)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    add(counts)
    for k in ("train_loss", "energy_loss", "force_loss"):
        if not np.isfinite(hist[k]).all():
            fail(f"phase 20c: non-finite {k} {hist[k]}")
    for name in ("filter_scatter", "filter_scatter_backward",
                 "segment_sum"):
        if counts[name] == 0:
            fail(f"phase 20c: {name} never launched in the graph shards")
    done = tcfg.update_config(copy.deepcopy(lj), *lj_splits)
    mcfg = data_input_dim(tcfg.build_model_config(done), lj_splits[0])
    variables = random_flax_variables(create_model(mcfg, device="cpu"),
                                      SEED)
    first = first_step_card_cpu(torch, lj, lj_splits, mcfg, device,
                                variables, "20c")
    print(f"phase 20c: LJ SchNet EF (equivariant) graph_shards "
          f"{COMPOSED_GRAPH_SHARDS}, two steps, edge list: train "
          f"{hist['train_loss']} energy {hist['energy_loss']} force "
          f"{hist['force_loss']}; launches {counts} (B4 forward / dh "
          f"{counts['filter_scatter']} / {counts['filter_scatter_backward']}"
          f" over {COMPOSED_GRAPH_SHARDS} shards) (card: {card})",
          flush=True)
    return dict(train_loss=hist["train_loss"], force_loss=hist["force_loss"],
                launches=counts, first_step=first)


def pipe_data(torch, device, card, add, reference, csce):
    """20d: csce PNA over 2 stages x 2 data shards against the pipe-only
    run on the same 4 microbatches; (record)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.models.create import data_input_dim
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    S, D, M = PIPE_STAGES_19C, PIPE_DATA_SHARDS, 2
    cfg = copy.deepcopy(csce["base_cfg"])
    splits = csce["splits"]
    done = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = data_input_dim(tcfg.build_model_config(done), splits[0])
    loader = create_dataloaders(
        *splits, int(cfg["NeuralNetwork"]["Training"]["batch_size"]),
        neighbor_format=True, num_shards=D * M)[0]
    loader.set_epoch(0)
    batch = next(iter(loader)).to(device)

    def parts(opt, **kw):
        # the same seeded weights every time
        model = tpt.create_pipeline_model(mcfg, [device] * S)
        tx = select_optimizer({"Optimizer": dict(opt)})
        step = tpt.make_pipeline_train_step(model, tx, schedule="1f1b", **kw)
        return model, TrainState.create(model, tx), step

    sgd = {"type": "SGD", "learning_rate": COMPOSED_LR}
    adamw = cfg["NeuralNetwork"]["Training"]["Optimizer"]
    runs, launches = {}, {}
    for name, opt, kw in (
            ("pipe_only", sgd, {}),
            ("pipe_data", sgd, dict(data_shards=D)),
            ("pipe_data_adamw", adamw, dict(data_shards=D)),
            ("pipe_data_adamw_zero", adamw, dict(data_shards=D,
                                                 zero_opt=True))):
        model, state, step = parts(opt, **kw)
        tk.reset_launch_counts()
        _, m = step(state, batch)
        _, m2 = step(state, batch)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        runs[name] = (state, m, m2, step)
        launches[name] = {k: v for k, v in counts.items() if v}
        if name == "pipe_only":
            reference(counts)
            continue
        add(counts)
        for n_ in ("nbr_aggregate", "nbr_aggregate_backward"):
            if counts[n_] == 0:
                fail(f"phase 20d: {n_} never launched in the stages of "
                     f"the {name} run")
    a, b = runs["pipe_only"], runs["pipe_data"]
    loss_same = torch.equal(a[1]["loss"], b[1]["loss"])
    gaps = []
    params_ok = True
    for k, v in a[0].params.items():
        w = b[0].params[k]
        gaps.append(float((v - w).detach().abs().max()))
        params_ok &= bool(torch.allclose(w, v, **PARITY_TOL))
    z0, z1 = runs["pipe_data_adamw"], runs["pipe_data_adamw_zero"]
    zero_same = all(torch.equal(v, z1[0].params[k])
                    for k, v in z0[0].params.items()) and all(
        torch.equal(x, y) for name in z0[0].opt_state.slots
        for x, y in zip(z0[0].opt_state.slots[name],
                        z1[0].opt_state.slots[name]))
    step, state = b[3], b[0]
    times = step_events_ms(torch, lambda: step(state, batch), reps=5)
    times_1 = step_events_ms(torch, lambda: a[3](a[0], batch), reps=5)
    rec = dict(loss_bitwise=loss_same, loss=float(a[1]["loss"]),
               params_max_abs_gap=max(gaps), params_within=params_ok,
               zero_bitwise=zero_same, step_ms=float(np.median(times)),
               pipe_only_step_ms=float(np.median(times_1)),
               launches=launches)
    print(f"phase 20d: csce PNA (6 layers, width 200, dense) over {S} "
          f"stages x {D} data shards x {M} microbatches on "
          f"{S * D} streams vs the pipe-only run on the same {D * M} "
          f"microbatches: first-step loss bitwise {loss_same} "
          f"({rec['loss']!r}); parameters after two SGD steps max gap "
          f"{max(gaps):.3e} (within {PARITY_TOL}: {params_ok}); AdamW "
          f"ZeRO on vs off bitwise {zero_same}; captured step "
          f"{rec['step_ms']:.3f} ms vs pipe-only "
          f"{rec['pipe_only_step_ms']:.3f} ms (median of 5); launches "
          f"by run (two steps each) {launches} (card: {card})", flush=True)
    for ok, what in ((loss_same, "loss vs the pipe-only run not bitwise"),
                     (params_ok, "parameters vs the pipe-only run"),
                     (zero_same, "ZeRO on vs off not bitwise")):
        if not ok:
            fail(f"phase 20d: {what}")
    return rec


def graph_phase(torch, device, card, counted, csce, lj_splits):
    """Phase 20 (see the module docstring): (record, launches, segment_sum
    shapes)."""
    t_phase = time.perf_counter()
    launches, ref_launches = {}, {}

    def tally(into):
        def add(counts):
            counted(counts)
            for name, c in counts.items():
                into[name] = into.get(name, 0) + c
        return add
    # the graph slots' and rings' runs; the reference runs apart
    add, reference = tally(launches), tally(ref_launches)

    dev = torch.device("cuda", 0) if device.type == "cuda" else device
    rec = {}
    t0 = time.perf_counter()
    rec["a"], shapes = gp_layers(torch, dev, card, add, reference)
    rec["a"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["b"] = composed_csce(torch, dev, card, add, reference, csce)
    rec["b"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["c"] = composed_lj(torch, dev, card, add, lj_splits)
    rec["c"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["d"] = pipe_data(torch, dev, card, add, reference, csce)
    rec["d"]["phase_s"] = time.perf_counter() - t0
    rec.update(wall_s=time.perf_counter() - t_phase, launches=launches,
               reference_launches=ref_launches)
    print(f"phase 20 took {rec['wall_s']:.1f} s; launches in the graph "
          f"slots and pipe x data rings {launches}; in the reference runs "
          f"{ref_launches} (card: {card})", flush=True)
    return rec, launches, shapes


# ------------------------------------------------------------- phase 21 --
GFM_SIZES = "48,32,40"         # examples/gfm/train_gfm.py's members
GFM_FIRST_RTOL = 1e-4          # 21a: the first step, card vs cpu
GFM_VAL_RTOL = 1e-3            # 21a: each epoch's per-head losses
GFM_DYADIC_SIZES = (6, 6, 6)   # 21a: the masked-vs-plain members
GFM_DYADIC_LR = 0.5
GFM_TIMED_STEPS = 20
GFM_KERNELS = ("segment_sum",)
MD_WORLD = 2                   # 21b: ranks sharing the card over gloo
MD_LIMIT = 200                 # samples a member (train.py's default)
MD_FIRST_RTOL = 1e-4
MD_TIMEOUT_S = 360             # the children's bound, start-up included


def gfm_args(job_dir, device, epochs=None):
    from hydragnn_tpu_torch.examples import gfm
    argv = ["--job-dir", job_dir, "--device", device, "--sizes", GFM_SIZES]
    if epochs is not None:
        argv += ["--num-epochs", str(epochs)]
    return gfm.parse_args(argv)


def gfm_sgd():
    """21a's SGD (momentum 0) at gfm_mixture.json's learning rate: the
    optimizer its per-epoch card-vs-CPU holds train with."""
    from hydragnn_tpu_torch.examples import gfm
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    lr = gfm.load_gfm_config()["NeuralNetwork"]["Training"]["Optimizer"][
        "learning_rate"]
    return Optimizer("SGD", learning_rate=float(lr), momentum=0.0)


def gfm_run(device, sgd=False, quiet=False, epochs=None):
    """The GFM driver's run on `device` from the same seed (its Adam, or
    `gfm_sgd` with `sgd`) -> (result, run)."""
    import io
    import tempfile
    from hydragnn_tpu_torch.examples import gfm
    out = io.StringIO() if quiet else sys.stdout
    with tempfile.TemporaryDirectory(prefix="hydragnn_gfm_") as tmp, \
            contextlib.redirect_stdout(out):
        return gfm.run(gfm_args(tmp, device, epochs),
                       optimizer=gfm_sgd() if sgd else None)


def gfm_cpu_run(sgd=False):
    """21a's CPU witness (a worker): `gfm_run` on the CPU -> {the first
    step's metrics, with `sgd` each epoch's per-head train and val
    losses, seconds}. The driver's Adam run takes one epoch: its holds
    read the first step alone."""
    t0 = time.perf_counter()
    _, info = gfm_run("cpu", sgd=sgd, quiet=True,
                      epochs=None if sgd else 1)
    return dict(first=info.first_metrics, train=info.train_head_losses,
                val=info.val_head_losses, seconds=time.perf_counter() - t0)


def gfm_f64_sgd_run():
    """21a's float64 witness (a worker): the GFM driver's run, its loaders
    and seed, on the CPU at float64 under SGD (momentum 0, the config's
    learning rate: one update is -lr g, as the driver's SGD step) ->
    {the first step's loss and task_<i> (before its update), each epoch's
    per-head train and val losses}."""
    import torch
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.examples import gfm
    from hydragnn_tpu_torch.graphs.synthetic import (build_members,
                                                     split_members)
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel.multidataset import GfmMixtureLoader
    from hydragnn_tpu_torch.train.gfm import (GfmEpochAccumulator,
                                              apply_head_weights)
    from hydragnn_tpu_torch.train.loss import multihead_loss
    from hydragnn_tpu_torch.utils.envflags import resolve_gfm
    args = gfm_args(".", "cpu")
    config = gfm.load_gfm_config(args.inputfile)
    tr = config["NeuralNetwork"]["Training"]
    mixture, head_weights = resolve_gfm(tr)
    train, val = split_members(build_members(
        sizes=[int(v) for v in args.sizes.split(",")],
        seed=args.data_seed))
    config = tcfg.update_config(config,
                                [s for v in train.values() for s in v])
    mcfg = tcfg.build_model_config(config)
    batch = int(tr["batch_size"])
    loader = GfmMixtureLoader(train, batch, cfg=mcfg, weights=mixture,
                              seed=args.seed)
    val_loader = GfmMixtureLoader(val, batch, cfg=mcfg, seed=args.seed)
    hcfg = apply_head_weights(mcfg, head_weights)
    model = create_model(mcfg, device="cpu", seed=args.seed).double()
    params = list(model.parameters())
    lr = float(np.float32(gfm_sgd().learning_rate))

    def losses(b):
        b = b.replace(**{k: getattr(b, k).double()
                         for k in ("x", "pos", "y_graph")})
        out, var = model(b)
        total, tasks = multihead_loss(hcfg, "mse", out, var, b)
        return total, {f"task_{i}": t for i, t in enumerate(tasks)}
    first, train_losses, val_losses = None, [], []
    for epoch in range(int(tr["num_epoch"])):
        loader.set_epoch(epoch)
        acc = GfmEpochAccumulator(loader.member_names)
        for b in loader:
            model.train()
            total, tasks = losses(b)
            if first is None:
                first = dict(loss=float(total.detach()),
                             **{k: float(v.detach())
                                for k, v in tasks.items()})
            grads = torch.autograd.grad(total, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.sub_(lr * g)
            acc.update(b, {k: float(v.detach()) for k, v in tasks.items()})
        train_losses.append(acc.summary()["head_losses"])
        val_loader.set_epoch(0)
        vacc = GfmEpochAccumulator(loader.member_names)
        model.eval()
        with torch.no_grad():
            for b in val_loader:
                _, tasks = losses(b)
                vacc.update(b, {k: float(v) for k, v in tasks.items()})
        val_losses.append(vacc.summary()["head_losses"])
    return dict(first=first, train=train_losses, val=val_losses)


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def gfm_zero_added(torch, device, mcfg, config):
    """21a: a 2-member sub-mixture under the full mixture's pinned budget
    first, then the full mixture, through one step: its graphs after
    each, and the launches."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.graphs.synthetic import (build_members,
                                                     split_members)
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel.multidataset import GfmMixtureLoader
    from hydragnn_tpu_torch.train.gfm import make_gfm_train_step
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    train = split_members(build_members(
        sizes=[int(v) for v in GFM_SIZES.split(",")]))[0]
    batch = int(config["NeuralNetwork"]["Training"]["batch_size"])
    full = GfmMixtureLoader(train, batch, cfg=mcfg, seed=0)
    sub = GfmMixtureLoader({n: train[n] for n in ("alpha", "beta")}, batch,
                           seed=0, pack_budget=full.pack_budget)
    model = create_model(mcfg, device=device, seed=0)
    tx = Optimizer("Adam", learning_rate=1e-3)
    state = TrainState.create(model, tx)
    step = make_gfm_train_step(model, mcfg, tx, num_datasets=3)
    tk.reset_launch_counts()
    graphs = []
    for ld in (sub, full):
        ld.set_epoch(0)
        for b in ld:
            state, m = step(state, b.to(device))
        float(m["loss"])
        graphs.append(len(step.steps.graphs))
    torch.cuda.synchronize()
    return dict(sub_graphs=graphs[0], full_graphs=graphs[1],
                added=graphs[1] - graphs[0],
                sub_steps=len(sub), full_steps=len(full)), tk.launch_counts()


def gfm_masked_vs_plain(torch, device):
    """21a: on each dyadic member, with one-hot head weights, the
    head-masked captured step and the plain captured step from the same
    seed (3 steps each: warm-up, capture, replay) -> the tensors that
    differ (none held) and the launches."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.examples import gfm
    from hydragnn_tpu_torch.graphs.batch import BucketSpec, collate
    from hydragnn_tpu_torch.graphs.synthetic import build_members
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.gfm import apply_head_weights
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_train_step)
    members = build_members(sizes=GFM_DYADIC_SIZES, seed=1, dyadic=True)
    done = tcfg.update_config(gfm.load_gfm_config(),
                              [s for v in members.values() for s in v])
    mcfg = tcfg.build_model_config(done)
    differ = {}
    tk.reset_launch_counts()
    for d, name in enumerate(sorted(members)):
        onehot = tuple(1.0 if i == d else 0.0 for i in range(3))
        b = collate(members[name], bucket=BucketSpec(multiple=64))
        ids = torch.where(b.graph_mask, torch.tensor(d, dtype=torch.int32),
                          torch.tensor(-1, dtype=torch.int32))
        out = []
        for batch in (b.replace(dataset_id=ids), b):
            model = create_model(mcfg, device=device, seed=2)
            tx = Optimizer("SGD", learning_rate=GFM_DYADIC_LR, momentum=0.0)
            state = TrainState.create(model, tx)
            step = make_train_step(model, apply_head_weights(mcfg, onehot),
                                   tx)
            for _ in range(3):
                state, m = step(state, batch.to(device))
            out.append(({k: v.detach().clone() for k, v in
                         state.state_dict().items()}, m,
                        len(step.steps.graphs)))
        (s_gfm, m_gfm, g_gfm), (s_plain, m_plain, g_plain) = out
        differ[name] = [k for k in s_plain
                        if not torch.equal(s_gfm[k], s_plain[k])]
        if not torch.equal(m_gfm[f"task_{d}"], m_plain[f"task_{d}"]):
            differ[name].append(f"task_{d}")
        if (g_gfm, g_plain) != (1, 1):
            differ[name].append(f"graphs {g_gfm}, {g_plain}")
    torch.cuda.synchronize()
    return differ, tk.launch_counts()


def gfm_epoch_rows(card_runs, cpu, ref):
    """Each (split, epoch, head) loss: the card's float32 run against the
    reference `ref` and the CPU's float32 run `cpu`, and the CPU's gap to
    `ref`; the split's floor is the CPU's widest gap over its epochs and
    heads."""
    rows = []
    for split in ("train", "val"):
        floor = max(relative_gap(got[n], want[n])
                    for got, want in zip(cpu[split], ref[split])
                    for n in want)
        for e, (got, want, c) in enumerate(zip(card_runs[split],
                                                ref[split], cpu[split])):
            for name in want:
                rows.append(dict(
                    split=split, epoch=e, head=name,
                    gap=relative_gap(got[name], want[name]),
                    card_cpu=relative_gap(got[name], c[name]),
                    floor=floor,
                    bound=max(GFM_VAL_RTOL, FLOOR_TIMES * floor)))
    return rows


def gfm_rows_text(rows):
    return str([(r["split"], r["epoch"], r["head"], "%.2e" % r["gap"],
                 "%.2e" % r["card_cpu"], "%.2e" % r["floor"],
                 "%.2e" % r["bound"]) for r in rows])


def gfm_segment_shapes(torch, b, tag, f, card):
    """segment_sum at the shapes one batch `b` of a phase 21 path (on the
    card) gives it, each over the layout the stack builds once a step
    (models/base.py `aggregation_layouts`): the [E, f] sum by receivers
    and the sender gathers' [E, f] gradient by senders, EGNN's [E, 3]
    coordinate mean, the dense gather's gradient where the batch holds
    the table, and the [N, f] pooling; seeded random data, zero on the
    rows the layouts leave out (`segment_shape`: held against the plain
    version, timed beside index_add)."""
    from hydragnn_tpu_torch.kernels.segment import segment_layout
    dev = b.x.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = b.num_nodes
    keep = b.edge_mask

    def rand(rows, width, mask=None):
        x = torch.randn(rows, width, device=dev, generator=gen)
        return x if mask is None else x * mask[:, None]
    recv = segment_layout(b.receivers, n, keep)
    shapes = [segment_shape(torch, f"{tag}_edge_sum", rand(b.num_edges, f,
                                                           keep),
                            b.receivers, n, layout=recv, card=card)]
    if "egnn" in tag:
        shapes.append(segment_shape(
            torch, f"{tag}_edge_coord_mean", rand(b.num_edges, 3, keep),
            b.receivers, n, layout=recv, card=card))
    shapes.append(segment_shape(
        torch, f"{tag}_gather_send_bwd", rand(b.num_edges, f, keep),
        b.senders, n, layout=segment_layout(b.senders, n, keep), card=card))
    if b.nbr is not None:
        slots = b.nbr_mask.reshape(-1)
        ids, segs = ((b.nbr_edge, b.num_edges) if "egnn" in tag
                     else (b.nbr, n))
        ids = ids.reshape(-1)
        shapes.append(segment_shape(
            torch, f"{tag}_dense_gather_bwd", rand(slots.shape[0], f, slots),
            ids, segs, layout=segment_layout(ids, segs, slots), card=card))
    shapes.append(segment_shape(torch, f"{tag}_pooling",
                                rand(n, f, b.node_mask), b.node_graph,
                                b.num_graphs, card=card))
    return shapes


def gfm_mixture(torch, device, card, add, counted):
    """21a (see the module docstring)."""
    from hydragnn_tpu_torch import kernels as tk
    cpu_adam = cpu_submit(gfm_cpu_run)
    cpu_sgd = cpu_submit(gfm_cpu_run, sgd=True)
    cpu_f64 = cpu_submit(gfm_f64_sgd_run)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    result, info = gfm_run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    add(counts)
    info.loader.set_epoch(0)
    first = next(iter(info.loader))
    step_ms, _ = time_train_steps(torch, info.step, info.state,
                                  first.to(device), steps=GFM_TIMED_STEPS)
    graphs_after = len(info.step.steps.graphs)
    real = int(first.graph_mask.sum())
    shapes = gfm_segment_shapes(torch, first.to(device), "gfm_gin",
                                info.mcfg.hidden_dim, card)
    # the per-epoch holds' run: the same driver under SGD
    tk.reset_launch_counts()
    _, sgd_info = gfm_run("cuda", sgd=True, quiet=True)
    torch.cuda.synchronize()
    counted(tk.launch_counts())
    zero, z_counts = gfm_zero_added(torch, device, info.mcfg, info.config)
    counted(z_counts)
    differ, m_counts = gfm_masked_vs_plain(torch, device)
    counted(m_counts)
    rec = dict(config="examples/gfm/gfm_mixture.json", sizes=GFM_SIZES,
               epochs=len(info.epoch_s), plan_fp=result["plan_fp"],
               train_captures=info.train_captures,
               captures_after_timing=graphs_after,
               step_ms=step_ms, graphs_per_step=real,
               step_graphs_per_s=real / step_ms * 1e3,
               driver_graphs_per_s=result["graphs_per_s"],
               epoch_s=info.epoch_s, run_s=wall,
               history=result["history"], first=info.first_metrics,
               zero_added=zero, masked_vs_plain_differ=differ,
               launches=counts)
    print(f"phase 21a: gfm_mixture.json (GIN hidden "
          f"{info.mcfg.hidden_dim}, {info.mcfg.num_conv_layers} layers, 3 "
          f"graph heads, batch {info.loader.batch_size}) on members "
          f"{GFM_SIZES}, {len(info.epoch_s)} epochs through "
          f"hydragnn_tpu_torch.examples.gfm: plan_fp={result['plan_fp']}; "
          f"train step captures {info.train_captures} (after "
          f"{GFM_TIMED_STEPS} timed steps {graphs_after}); captured step "
          f"{step_ms:.3f} ms for {real} graphs "
          f"({rec['step_graphs_per_s']:.1f} graphs/s), the driver's "
          f"{result['graphs_per_s']:.1f} graphs/s over its epochs (eval and "
          f"checkpoints in); epoch wall s "
          f"{[round(t, 3) for t in info.epoch_s]}; train loss "
          f"{result['history']['train_loss']}; launches {counts} "
          f"(card: {card})", flush=True)
    print(f"phase 21a: sub-mixture (alpha, beta) under the full budget "
          f"{zero['sub_graphs']} graph(s), then the full mixture "
          f"{zero['full_graphs']}: {zero['added']} added; masked vs plain "
          f"step on dyadic members, tensors that differ: {differ} "
          f"(card: {card})", flush=True)
    if info.train_captures != 1 or graphs_after != 1:
        fail(f"phase 21a: {info.train_captures} train step captures in the "
             f"run ({graphs_after} after the timed steps), not 1")
    if zero["sub_graphs"] != 1 or zero["added"] != 0:
        fail(f"phase 21a: the third member added captures: {zero}")
    if any(differ.values()):
        fail(f"phase 21a: the head-masked step differs from the plain one "
             f"{differ}")
    for name in GFM_KERNELS:
        if counts.get(name, 0) == 0:
            fail(f"phase 21a: {name} never launched on the GFM path")

    def check_first(cpu):
        """The first step (Adam's run; before any update): card vs the
        CPU at float64 within GFM_FIRST_RTOL; card vs the CPU at float32
        within that or FLOOR_TIMES x the CPU's float32 error, where wider
        (on small masked means the CPU's float32 error reaches 4e-4)."""
        f64 = cpu_f64.get()["first"]
        rows = {}
        for k in f64:
            floor = relative_gap(cpu["first"][k], f64[k])
            rows[k] = dict(
                card_f64=relative_gap(info.first_metrics[k], f64[k]),
                card_cpu=relative_gap(info.first_metrics[k],
                                      cpu["first"][k]),
                cpu_floor=floor,
                bound=max(GFM_FIRST_RTOL, FLOOR_TIMES * floor))
        rec["first_step"] = rows
        print(f"phase 21a first step (loss, task_<i>): card vs cpu float64 "
              f"{ {k: '%.2e' % r['card_f64'] for k, r in rows.items()} } "
              f"(held at {GFM_FIRST_RTOL}); card vs cpu float32 "
              f"{ {k: '%.2e' % r['card_cpu'] for k, r in rows.items()} }, "
              f"the cpu's float32 error "
              f"{ {k: '%.2e' % r['cpu_floor'] for k, r in rows.items()} } "
              f"(held at {GFM_FIRST_RTOL} or {FLOOR_TIMES} x it) "
              f"(card: {card})", flush=True)
        for k, r in rows.items():
            if not r["card_f64"] <= GFM_FIRST_RTOL:
                fail(f"phase 21a: first step {k} card vs cpu float64 "
                     f"{r['card_f64']} above {GFM_FIRST_RTOL}")
            if not r["card_cpu"] <= r["bound"]:
                fail(f"phase 21a: first step {k} card vs cpu {r['card_cpu']}"
                     f" above {r['bound']}")

    def check_epochs(cpu):
        """Each epoch's per-head losses of the SGD run: the card's against
        the CPU's float64 run within GFM_VAL_RTOL or FLOOR_TIMES x the
        split's float32 floor (the CPU float32 run's widest gap to
        float64: one draw of a chaotic divergence, which the host's CPU
        moves), where wider; card vs the CPU's float32 run printed, with
        whether 1e-3 held there."""
        rows = gfm_epoch_rows(
            dict(train=sgd_info.train_head_losses,
                 val=sgd_info.val_head_losses), cpu, cpu_f64.get())
        within = all(r["card_cpu"] <= GFM_VAL_RTOL for r in rows)
        rec["sgd_epochs"] = dict(rows=rows, card_cpu_within_1e3=within,
                                 cpu_s=cpu["seconds"])
        print(f"phase 21a SGD (lr as the config's, momentum 0), per-head "
              f"losses (split, epoch, head, card vs cpu float64, card vs "
              f"cpu float32, float32 floor, bound) {gfm_rows_text(rows)}; "
              f"card vs cpu float32 all within {GFM_VAL_RTOL}: {within} "
              f"(cpu run {cpu['seconds']:.1f} s; card: {card})", flush=True)
        for r in rows:
            if not r["gap"] <= r["bound"]:
                fail(f"phase 21a: SGD epoch {r['epoch']} {r['split']} "
                     f"{r['head']} card vs cpu float64 {r['gap']} above "
                     f"{r['bound']} (float32 floor {r['floor']})")
    cpu_then(cpu_adam, check_first)
    cpu_then(cpu_sgd, check_epochs)
    return rec, shapes


def md_sgd_step(torch, r, init, batch, device):
    """21b's held step: one SPMD SGD step (COMPOSED_LR) of the driver's
    model and config from the weights `init` on `device`, in the group ->
    (loss, the parameters after it, SGD's trace: the averaged gradient it
    applied) as float64 tensors on the CPU."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel.spmd import SpmdTrainStep
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    model = create_model(r.mcfg, device=device)
    model.load_state_dict(init)
    tx = select_optimizer({"Optimizer": {"type": "SGD",
                                         "learning_rate": COMPOSED_LR}})
    st = TrainState.create(model, tx)
    _, m = SpmdTrainStep(model, r.mcfg, tx, r.loss_name)(st,
                                                         batch.to(device))
    return (float(m["loss"]),
            torch.cat([p.detach().reshape(-1).cpu().double()
                       for p in st.params.values()]),
            torch.cat([t.detach().reshape(-1).cpu().double()
                       for t in st.opt_state.slots["trace"]]))


def md_f64_gradient(torch, r, init, batch):
    """21b's float64 witness: the gradient `md_sgd_step` applies (the
    group's mean of each rank's loss gradient), on the CPU at float64."""
    import torch.distributed as dist
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.loss import multihead_loss
    model = create_model(r.mcfg, device="cpu")
    model.load_state_dict(init)
    model.double().train()
    b = batch.replace(**{k: getattr(batch, k).double() for k in (
        "x", "pos", "y_graph", "y_node", "edge_attr", "edge_shifts",
        "energy", "forces") if getattr(batch, k) is not None})
    out, var = model(b)
    total, _ = multihead_loss(r.mcfg, r.loss_name, out, var, b)
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    return flat / dist.get_world_size()


def md_first_step(torch, r, init, batch):
    """21b: `md_sgd_step` on the card and on the CPU, and the float64
    gradient -> the record `first_step_text` prints (PR 20's
    `first_step_card_cpu` numbers and bounds)."""
    def rel(x, y):
        return float((x - y).norm() / max(float(y.norm()), 1e-30))
    l_card, p_card, u_card = md_sgd_step(torch, r, init, batch, r.device)
    l_cpu, p_cpu, u_cpu = md_sgd_step(torch, r, init, batch,
                                      torch.device("cpu"))
    u_64 = md_f64_gradient(torch, r, init, batch)
    rec = dict(card=l_card, cpu=l_cpu,
               gap=abs(l_card - l_cpu) / max(abs(l_cpu), 1e-12),
               params_rel_l2=rel(p_card, p_cpu),
               update_rel_l2=rel(u_card, u_cpu),
               update_cpu_f64_rel_l2=rel(u_cpu, u_64))
    rec["update_bound"] = max(1e-2, 10 * rec["update_cpu_f64_rel_l2"])
    return rec


def md_child(rank: str, world: str, rdzv: str, out_path: str,
             job_dir: str) -> int:
    """21b in one rank of MD_WORLD sharing the card over gloo: the
    multi-dataset driver's setup, the first SPMD step on the card and on
    the CPU from the same weights (the same group), the captured step
    timed, then one epoch through the driver. Writes JSON to
    `out_path`."""
    import torch
    import torch.distributed as dist
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.examples import multidataset as md
    from hydragnn_tpu_torch.kernels import _build
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel.spmd import SpmdTrainStep
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    rank, world = int(rank), int(world)
    t_start = time.perf_counter()
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    args = md.parse_args([
        "--job-dir", job_dir, "--device", "cuda", "--limit", str(MD_LIMIT),
        "--num_epoch", "1", "--rank", str(rank), "--world", str(world),
        "--rdzv", f"file://{rdzv}", "--backend", "gloo"])
    _build.build_all()
    r = md.setup(args)
    init = {k: v.detach().cpu().clone()
            for k, v in r.model.state_dict().items()}
    first = next(iter(r.loader))
    out = {"rank": rank, "member": r.names[r.loader.assignment[rank]],
           "graphs": int(first.graph_mask.sum()),
           "train_sizes": [len(s[0]) for s in r.splits],
           "steps_per_epoch": len(r.loader)}
    tk.reset_launch_counts()
    state, m = r.train_step(r.state, first.to(r.device))
    card = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    out["launches_first"] = tk.launch_counts()
    cpu_model = create_model(r.mcfg, device="cpu")
    cpu_model.load_state_dict(init)
    tx = select_optimizer(r.train_cfg)
    _, cm = SpmdTrainStep(cpu_model, r.mcfg, tx, r.loss_name)(
        TrainState.create(cpu_model, tx), first)
    out["first"] = {"card": card, "cpu": {k: float(v) for k, v in
                                          cm.items()}}
    out["first_sgd"] = md_first_step(torch, r, init, first)
    # B3 at this rank's shapes, one rank at a time on the shared card
    member = out["member"].lower()
    for turn in range(world):
        if turn == rank:
            out["shapes"] = gfm_segment_shapes(
                torch, first.to(r.device), f"md_{member}_egnn",
                r.mcfg.hidden_dim, None)
        dist.barrier()
    ms, coll = time_train_steps(torch, r.train_step, state,
                                first.to(r.device))
    out["timing"] = dict(step_ms=ms, collective_ms=coll,
                         collective_share=coll / ms,
                         graphs_per_s=world * out["graphs"] / ms * 1e3)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    _, hist, _ = md.run(args)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = tk.launch_counts()
    out["history"] = {k: hist[k] for k in ("train_loss", "val_loss",
                                           "test_loss")}
    out["seconds"] = time.perf_counter() - t_start
    with open(out_path + ".tmp", "w") as fh:
        json.dump(out, fh)
    os.replace(out_path + ".tmp", out_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def md_ranks(torch, card, add):
    """21b (see the module docstring)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hydragnn_md_") as tmp:
        procs = []
        for r in range(MD_WORLD):
            log = open(f"{tmp}/rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, __file__, "--gfm-rank", str(r),
                 str(MD_WORLD), f"{tmp}/rdzv", f"{tmp}/rank{r}.json",
                 f"{tmp}/job"], stdout=log, stderr=subprocess.STDOUT),
                log))
        deadline = time.monotonic() + MD_TIMEOUT_S
        bad = []
        try:
            for r, (proc, log) in enumerate(procs):
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    bad.append(f"rank {r} outlasted {MD_TIMEOUT_S} s")
                    break
                if proc.returncode != 0:
                    bad.append(f"rank {r} exited {proc.returncode}")
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        if bad:
            tails = []
            for r in range(MD_WORLD):
                with open(f"{tmp}/rank{r}.log") as fh:
                    tails.append(f"--- rank {r}\n{fh.read()[-3000:]}")
            fail("phase 21b: " + "; ".join(bad) + "\n" + "\n".join(tails))
        ranks = []
        for r in range(MD_WORLD):
            with open(f"{tmp}/rank{r}.json") as fh:
                ranks.append(json.load(fh))
    wall = time.perf_counter() - t0
    launches = {}
    for r in ranks:
        for part in ("launches_first", "launches"):
            for name, c in r[part].items():
                launches[name] = launches.get(name, 0) + c
    add(launches)
    gaps = [relative_gap(r["first"]["card"]["loss"],
                         r["first"]["cpu"]["loss"]) for r in ranks]
    for r, gap in zip(ranks, gaps):
        t = r["timing"]
        print(f"phase 21b: rank {r['rank']} (shard of {r['member']}, "
              f"{r['graphs']} graphs a step, {r['steps_per_epoch']} steps "
              f"an epoch): first step loss card {r['first']['card']['loss']}"
              f" cpu {r['first']['cpu']['loss']} (relative gap {gap:.2e}, "
              f"held at {MD_FIRST_RTOL}); captured SPMD step "
              f"{t['step_ms']:.3f} ms, collectives {t['collective_ms']:.3f} "
              f"ms (share {t['collective_share']:.3f}), "
              f"{t['graphs_per_s']:.1f} graphs/s over the {MD_WORLD} ranks; "
              f"one epoch through the driver {r['run_s']:.1f} s, history "
              f"{r['history']}; launches {r['launches']}; {r['seconds']:.1f}"
              f" s (card: {card})", flush=True)
    shapes = [sh for r in ranks for sh in r["shapes"]]
    for r in ranks:
        print(f"phase 21b: rank {r['rank']} "
              f"{first_step_text(r['first_sgd'])} (card: {card})", flush=True)
    for sh in shapes:
        print(f"phase 21b: segment_sum.{sh['shape']}: E={sh['E']} "
              f"N={sh['N']} F={sh['F']} device_ms={sh['device_ms']:.4f} "
              f"bound_ms={sh['bound_ms']:.5f} ({sh['bound_by']}) index_add "
              f"device_ms={sh['library_ms']:.4f} max_abs_err="
              f"{sh['max_abs_err']:.3e} (card: {card})", flush=True)
    print(f"phase 21b: gfm_energy.json (EGNN hidden 50, 3 layers, batch 32) "
          f"over OC2020 + OC2022 (limit {MD_LIMIT}), {MD_WORLD} gloo ranks "
          f"on one card: {wall:.1f} s (card: {card})", flush=True)
    for r, gap in zip(ranks, gaps):
        if not gap <= MD_FIRST_RTOL:
            fail(f"phase 21b: rank {r['rank']} first step loss card vs cpu "
                 f"{gap} above {MD_FIRST_RTOL}")
        sgd = r["first_sgd"]
        for key, bound in (("gap", MD_FIRST_RTOL),
                           ("params_rel_l2", MD_FIRST_RTOL),
                           ("update_rel_l2", sgd["update_bound"])):
            if not sgd[key] <= bound:
                fail(f"phase 21b: rank {r['rank']} first SGD step card vs "
                     f"cpu {key} {sgd[key]} above {bound} ({sgd})")
        for name in GFM_KERNELS:
            if r["launches"].get(name, 0) == 0:
                fail(f"phase 21b: {name} never launched on rank "
                     f"{r['rank']}'s driver run")
        if not np.isfinite(r["history"]["train_loss"]).all():
            fail(f"phase 21b: rank {r['rank']}: {r['history']}")
    if ranks[0]["history"] != ranks[1]["history"]:
        fail("phase 21b: the two ranks' histories differ")
    return dict(wall_s=wall, first_relative_gaps=gaps,
                ranks=[{k: r[k] for k in ("rank", "member", "graphs",
                                          "timing", "history", "run_s",
                                          "launches", "seconds",
                                          "first_sgd")}
                       for r in ranks]), shapes


def gfm_phase(torch, device, card, counted):
    """Phase 21 (see the module docstring): (record, launches, segment_sum
    shapes)."""
    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        counted(counts)
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
    rec = {}
    t0 = time.perf_counter()
    rec["a"], shapes = gfm_mixture(torch, device, card, add, counted)
    rec["a"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["b"], md_shapes = md_ranks(torch, card, add)
    rec["b"]["phase_s"] = time.perf_counter() - t0
    rec.update(wall_s=time.perf_counter() - t_phase, launches=launches)
    print(f"phase 21 took {rec['wall_s']:.1f} s; launches on the GFM paths "
          f"{launches} (card: {card})", flush=True)
    return rec, launches, shapes + md_shapes


OGBN_NODES = 20000             # 22a: the driver's graph (JAX's reading run)
OGBN_MIN_VAL_ACC = 0.9         # 22a: the final epoch's val_acc
OGBN_FIRST_RTOL = 1e-4         # 22a: the first step's loss, card vs cpu
ARXIV = dict(num_nodes=169343, feat_dim=128, num_classes=40, seed=0)
SAMPLING_KS = (0, 4)           # 22b: exact, then the historical cache
SAMPLING_STEPS = 20            # 22b: captured steps timed a mode
SAMPLING_HOST_BATCHES = 5      # 22b: batches built synchronously, timed
SAMPLING_KERNELS = ("segment_sum",)


def ogbn_args(job_dir, device, epochs=None, *extra):
    from hydragnn_tpu_torch.examples import ogbn
    argv = ["--job-dir", job_dir, "--device", device, "--num-nodes",
            str(OGBN_NODES), *extra]
    if epochs is not None:
        argv += ["--num-epochs", str(epochs)]
    return ogbn.parse_args(argv)


def ogbn_run(job_dir, device="cuda", epochs=None, *extra):
    """The ogbn driver's run (its stdout in the smoke's) -> (result,
    run)."""
    from hydragnn_tpu_torch.examples import ogbn
    return ogbn.run(ogbn_args(job_dir, device, epochs, *extra))


def ogbn_parts(device, dtype=None):
    """The driver's construction at OGBN_NODES on `device`: (plan_fp, the
    first batch of epoch 0 on the device, the seeded model (at `dtype`
    when given), its config, the config's learning rate)."""
    from hydragnn_tpu_torch.examples import ogbn
    from hydragnn_tpu_torch.graphs.synthetic import load_ogbn
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.sampling import NeighborSamplingLoader
    from hydragnn_tpu_torch.utils.envflags import resolve_sampling
    args = ogbn_args(".", "cpu")
    config = ogbn.load_ogbn_config(args.inputfile)
    tr = config["NeuralNetwork"]["Training"]
    fanouts, _, parts, mode = resolve_sampling(tr)
    data = load_ogbn(None, num_nodes=args.num_nodes, seed=args.data_seed)
    loader = NeighborSamplingLoader(
        x=data.x, y_node=data.y_onehot, senders=data.senders,
        receivers=data.receivers, train_nodes=data.train_idx,
        batch_size=int(tr["batch_size"]), fanouts=fanouts, seed=args.seed,
        num_partitions=parts, partition_mode=mode, num_layers=2,
        async_workers=0)
    loader.set_epoch(0)
    batch = next(iter(loader)).to(device)
    mcfg = ogbn.complete_config(config, data)
    model = create_model(mcfg, device=device, seed=args.seed)
    if dtype is not None:
        model = model.to(dtype)
        batch = batch.replace(x=batch.x.to(dtype), y_node=batch.y_node.to(
            dtype))
    lr = float(tr["Optimizer"]["learning_rate"])
    return loader.plan_fingerprint(), batch, model, mcfg, lr


def flat_params(model):
    import torch
    return torch.cat([p.detach().reshape(-1).double().cpu()
                      for p in model.parameters()])


def ogbn_cpu_first_step(dtype_name):
    """22a's CPU witness (a worker): the driver's construction on the
    CPU at float32 or float64 -> {plan_fp, the first step's loss, the
    parameters after one SGD step at the config's rate (momentum 0) and
    the update it applied, as numpy}. At float64 the step is written
    out (p - lr g), as the port's optimizer keeps float32 scalars."""
    import torch
    from hydragnn_tpu_torch.train.train_step import make_sampled_loss_fn
    dtype = getattr(torch, dtype_name)
    plan_fp, batch, model, mcfg, lr = ogbn_parts("cpu", dtype)
    before = flat_params(model)
    model.train()
    params = list(model.parameters())
    total = make_sampled_loss_fn(model, mcfg)(batch)[0]
    grads = torch.autograd.grad(total, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    after = flat_params(model)
    return dict(plan_fp=plan_fp, loss=float(total.detach()),
                params=after.numpy(), update=(before - after).numpy())


def ogbn_card_first_step(torch, device):
    """22a: the same first SGD step on the card through the captured
    sampled step -> (loss, parameters after it, the update)."""
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_sampled_train_step)
    _, batch, model, mcfg, lr = ogbn_parts(device)
    before = flat_params(model)
    tx = Optimizer("SGD", learning_rate=lr, momentum=0.0)
    state = TrainState.create(model, tx)
    step = make_sampled_train_step(model, mcfg, tx)
    _, m = step(state, batch)
    after = flat_params(model)
    return float(m["loss"]), after, before - after


def ogbn_driver(torch, device, card, add):
    """22a (see the module docstring)."""
    import tempfile
    from hydragnn_tpu_torch import kernels as tk
    cpu32 = cpu_submit(ogbn_cpu_first_step, "float32")
    cpu64 = cpu_submit(ogbn_cpu_first_step, "float64")
    with tempfile.TemporaryDirectory(prefix="hydragnn_ogbn_") as tmp:
        full_dir = os.path.join(tmp, "full")
        cut_dir = os.path.join(tmp, "cut")
        os.makedirs(full_dir)
        os.makedirs(cut_dir)
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        result, info = ogbn_run(full_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tk.launch_counts()
        add(counts)
        # the kill-and-resume leg: stop after epoch 1, then --resume
        tk.reset_launch_counts()
        ogbn_run(cut_dir, "cuda", 1)
        resumed, _ = ogbn_run(cut_dir, "cuda", None, "--resume")
        torch.cuda.synchronize()
        add(tk.launch_counts())
    tk.reset_launch_counts()
    loss_card, params_card, update_card = ogbn_card_first_step(torch,
                                                               device)
    torch.cuda.synchronize()
    add(tk.launch_counts())
    hist = result["history"]
    rec = dict(config="examples/ogbn/ogbn_arxiv.json", num_nodes=OGBN_NODES,
               plan_fp=result["plan_fp"], history=hist,
               seeds_per_s=info.seeds_per_s, epoch_s=info.epoch_s,
               run_s=wall, train_captures=info.train_captures,
               first=info.first_metrics, launches=counts,
               resume_bitwise=(resumed["history"] == hist
                               and resumed["param_digest"]
                               == result["param_digest"]),
               param_digest=result["param_digest"])
    mcfg = info.mcfg
    print(f"phase 22a: ogbn_arxiv.json ({mcfg.model_type} hidden "
          f"{mcfg.hidden_dim}, {mcfg.num_conv_layers} layers, batch "
          f"{info.loader.batch_size}, fanouts {list(info.loader.fanouts)}, "
          f"{info.loader.num_partitions} partitions) on synthetic_arxiv("
          f"{OGBN_NODES}) through hydragnn_tpu_torch.examples.ogbn: "
          f"plan_fp={result['plan_fp']}; train loss {hist['train_loss']}, "
          f"val loss {hist['val_loss']}, val_acc {hist['val_acc']}; "
          f"{info.seeds_per_s:.1f} seeds/s over the epochs (eval and "
          f"checkpoints in), epoch wall s "
          f"{[round(t, 3) for t in info.epoch_s]}; train step captures "
          f"{info.train_captures}; launches {counts}; stopped after epoch "
          f"1 and resumed: history and param_digest bitwise "
          f"{rec['resume_bitwise']} (card: {card})", flush=True)
    if info.train_captures != 1:
        fail(f"phase 22a: {info.train_captures} train step captures in the "
             "run, not 1")
    if not hist["val_acc"][-1] >= OGBN_MIN_VAL_ACC:
        fail(f"phase 22a: final val_acc {hist['val_acc'][-1]} below "
             f"{OGBN_MIN_VAL_ACC}")
    if not rec["resume_bitwise"]:
        fail(f"phase 22a: the resumed run differs from the uninterrupted "
             f"one: {resumed['history']} vs {hist}, "
             f"{resumed['param_digest']} vs {result['param_digest']}")
    for name in SAMPLING_KERNELS:
        if counts.get(name, 0) == 0:
            fail(f"phase 22a: {name} never launched on the sampled path")

    def check_first(c32):
        """The first step: its loss card vs the CPU at float64 within
        OGBN_FIRST_RTOL (the driver's Adam run's and the SGD step's, the
        same forward); the SGD step's parameters after it card vs the
        CPU at float32 within 1e-4 relative L2, and its update within
        max(1e-2, 10 x the CPU float32 update's gap to float64)
        (`first_step_card_cpu`'s bounds)."""
        c64 = cpu64.get()

        def rel(x, y):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            return float(np.linalg.norm(x - y) / max(np.linalg.norm(y),
                                                     1e-30))
        r = dict(card=loss_card, driver=info.first_metrics["loss"],
                 cpu=c32["loss"], cpu64=c64["loss"],
                 gap=relative_gap(loss_card, c64["loss"]),
                 driver_gap=relative_gap(info.first_metrics["loss"],
                                         c64["loss"]),
                 params_rel_l2=rel(params_card.numpy(), c32["params"]),
                 update_rel_l2=rel(update_card.numpy(), c32["update"]),
                 update_cpu_f64_rel_l2=rel(c32["update"], c64["update"]),
                 plan_fp_cpu=c32["plan_fp"])
        r["update_bound"] = max(1e-2, 10 * r["update_cpu_f64_rel_l2"])
        rec["first_step"] = r
        print(f"phase 22a first step: loss card {r['card']!r} (the driver's "
              f"{r['driver']!r}), cpu float32 {r['cpu']!r}, cpu float64 "
              f"{r['cpu64']!r}: card vs float64 {r['gap']:.2e}, the "
              f"driver's {r['driver_gap']:.2e} (bound {OGBN_FIRST_RTOL}); "
              f"SGD parameters after it card vs cpu {r['params_rel_l2']:.2e} "
              f"(relative L2, bound 1e-4), the update "
              f"{r['update_rel_l2']:.2e} (bound {r['update_bound']:.2e}; "
              f"cpu float32 vs float64 {r['update_cpu_f64_rel_l2']:.2e}); "
              f"plan_fp on the cpu {r['plan_fp_cpu']} (card: {card})",
              flush=True)
        for key, bound in (("gap", OGBN_FIRST_RTOL),
                           ("driver_gap", OGBN_FIRST_RTOL),
                           ("params_rel_l2", 1e-4),
                           ("update_rel_l2", r["update_bound"])):
            if not r[key] <= bound:
                fail(f"phase 22a: first step {key} {r[key]} above {bound} "
                     f"({r})")
        if r["plan_fp_cpu"] != result["plan_fp"]:
            fail(f"phase 22a: plan_fp {result['plan_fp']} on the card host, "
                 f"{r['plan_fp_cpu']} on the cpu")
    cpu_then(cpu32, check_first)
    return rec


def arxiv_graph():
    """22b's graph (a worker): synthetic_arxiv at ogbn-arxiv's size and
    widths."""
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_arxiv
    t0 = time.perf_counter()
    g = synthetic_arxiv(**ARXIV)
    return g, time.perf_counter() - t0


def compact_tables(batch, tables):
    """The rows of `tables` one historical batch reads and writes, as a
    small table whose dump row is last, and the batch's node_global
    mapped onto it: (local batch, local tables, the global ids of the
    local rows). A step on them computes what it computes on the whole
    tables at those rows."""
    import torch
    from hydragnn_tpu_torch.preprocess.sampling import HistTables
    ng = tables.feat.shape[0] - 1
    ids = batch.node_global.long()
    uniq, inv = torch.unique(ids, return_inverse=True)
    real = uniq < ng
    uniq = uniq[real]
    local = torch.where(ids < ng, inv, torch.full_like(inv, uniq.shape[0]))
    rows = torch.cat([uniq, torch.tensor([ng], device=uniq.device)])
    small = HistTables(tables.feat[rows].clone(),
                       tables.layers[:, rows].clone(),
                       tables.versions[rows].clone())
    return batch.replace(node_global=local.to(torch.int32)), small, uniq


def sampled_cpu_step(mcfg, weights, batch, tables, lr):
    """22b's CPU witness (a worker): one eager SGD step (momentum 0) of
    the sampled step from `weights` on `batch` (and, historical, the
    compact `tables`, refresh on) -> (metrics, parameters after it, the
    tables after it as numpy or None)."""
    import torch
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_sampled_train_step)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.items()})
    tx = Optimizer("SGD", learning_rate=lr, momentum=0.0)
    state = TrainState.create(model, tx)
    hist = tables is not None
    step = make_sampled_train_step(model, mcfg, tx,
                                   staleness_k=SAMPLING_KS[-1] if hist else 0)
    out = step(state, batch, tables, True) if hist else step(state, batch)
    m = out[-1]
    return ({k: float(v) for k, v in m.items()}, flat_params(model).numpy(),
            None if not hist else (tables.layers.numpy(),
                                   tables.versions.numpy()))


def sampling_mode(torch, device, card, g, mcfg, lr, staleness_k):
    """22b, one mode: the library path (loader, captured step, tables) at
    ogbn-arxiv's scale -> (record, its B3 launches, the first batch)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.sampling import (HistTables,
                                                        NeighborSamplingLoader,
                                                        init_hist_tables)
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_sampled_train_step)
    common = dict(x=g.x, y_node=g.y_onehot, senders=g.senders,
                  receivers=g.receivers, train_nodes=g.train_idx,
                  batch_size=512, fanouts=(10, 5), seed=SEED,
                  num_partitions=4, staleness_k=staleness_k, num_layers=2)
    t0 = time.perf_counter()
    sync = NeighborSamplingLoader(async_workers=0, **common)
    it = iter(sync)
    host = [next(it) for _ in range(SAMPLING_HOST_BATCHES)]
    host_ms = (time.perf_counter() - t0) * 1e3 / SAMPLING_HOST_BATCHES
    loader = NeighborSamplingLoader(**common)
    hist = staleness_k > 0
    model = create_model(mcfg, device=device, seed=SEED)
    tx = Optimizer("SGD", learning_rate=lr, momentum=0.0)
    state = TrainState.create(model, tx)
    step = make_sampled_train_step(model, mcfg, tx, staleness_k=staleness_k)
    tables = (init_hist_tables(g.x, mcfg.hidden_dim, mcfg.num_conv_layers,
                               device=device) if hist else None)
    first = host[0].to(device)
    # the CPU witness of the first step, from the same weights
    weights = {k: v.detach().cpu().numpy() for k, v in
               model.state_dict().items()}
    if hist:
        b_local, small, rows = compact_tables(first, tables)
        cpu_ref = cpu_submit(sampled_cpu_step, mcfg, weights,
                             b_local.to("cpu"), HistTables(
                                 *(t.cpu() for t in small.tensors())), lr)
    else:
        cpu_ref = cpu_submit(sampled_cpu_step, mcfg, weights,
                             first.to("cpu"), None, lr)
    args = (tables, True) if hist else ()
    snap = state.copy()
    snap_tables = tables.copy() if hist else None
    tk.reset_launch_counts()
    m_e = step.eager(state, first, *args)[-1]
    torch.cuda.synchronize()
    eager = (flat_params(model), {k: v.clone() for k, v in m_e.items()},
             None if not hist else (tables.layers.clone(),
                                    tables.versions.clone()))
    state.restore(snap)
    if hist:
        tables.restore(snap_tables)
    m_c = step(state, first, *args)[-1]
    torch.cuda.synchronize()
    ng = g.x.shape[0]
    same = (torch.equal(flat_params(model), eager[0])
            and all(torch.equal(m_c[k], eager[1][k]) for k in m_c)
            and (not hist or (
                torch.equal(tables.layers[:, :ng], eager[2][0][:, :ng])
                and torch.equal(tables.versions[:ng], eager[2][1][:ng]))))
    card_first = ({k: float(v) for k, v in m_c.items()}, flat_params(model),
                  None if not hist else (tables.layers[:, rows].cpu(),
                                         tables.versions[rows].cpu()))
    counts = tk.launch_counts()
    # the timed window: batches from the background loader, each step's
    # loss read on the host as the driver reads it
    tk.reset_launch_counts()
    loader.set_epoch(0)
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, b in zip(range(SAMPLING_STEPS), loader):
        b = b.to(device)
        out = (step(state, b, tables, (i + 1) % staleness_k == 0) if hist
               else step(state, b))
        metrics.append({k: float(v) for k, v in out[-1].items()})
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    for name, c in tk.launch_counts().items():
        counts[name] = counts.get(name, 0) + c
    # the captured step's device time: its graph replayed alone
    graph = next(iter(step.steps.graphs.values())).graph
    replay = step_events_ms(torch, graph.replay, reps=SAMPLING_STEPS)
    replay_ms = float(np.median(replay))
    stats = loader.fetch_stats()
    rec = dict(staleness_k=staleness_k, N=first.num_nodes,
               E=first.num_edges, real_edges=int(first.edge_mask.sum()),
               host_ms_per_batch=host_ms,
               step_ms=replay_ms, replay_ms_all=replay,
               wall_ms_per_step=window_ms / SAMPLING_STEPS,
               window_ms=window_ms,
               idle_share=max(0.0, 1.0 - SAMPLING_STEPS * replay_ms
                              / window_ms),
               sampler_overlap_frac=stats["sampler_overlap_frac"],
               consumer_wait_s=loader.overlap_stats.get("consumer_wait_s"),
               remote_bytes_per_batch=stats["remote_bytes_per_batch"],
               local_bytes_per_batch=stats["local_bytes_per_batch"],
               captures=len(step.steps.graphs), captured_eq_eager=same,
               launches=counts, losses=[m["loss"] for m in metrics])
    if hist:
        rec["hist_frac"] = [m["hist_frac"] for m in metrics]
        rec["hist_staleness"] = [m["hist_staleness"] for m in metrics]
    print(f"phase 22b K={staleness_k}: batch N={rec['N']} E={rec['E']} "
          f"({rec['real_edges']} real edges); captured step "
          f"{rec['step_ms']:.3f} ms (its graph replayed alone, CUDA events, "
          f"median of {SAMPLING_STEPS}); {SAMPLING_STEPS} steps from the "
          f"background loader {window_ms:.1f} ms "
          f"({rec['wall_ms_per_step']:.1f} ms a step), idle share "
          f"{rec['idle_share']:.3f}; host {host_ms:.1f} ms a sampled batch "
          f"(synchronous), "
          f"sampler_overlap_frac {rec['sampler_overlap_frac']:.3f}; "
          f"remote bytes a batch {rec['remote_bytes_per_batch']:.0f}, local "
          f"{rec['local_bytes_per_batch']:.0f}; captures {rec['captures']};"
          f" captured = eager bitwise {same}"
          + (f"; hist_frac {rec['hist_frac'][-1]:.4f}, staleness "
             f"{[round(s, 3) for s in rec['hist_staleness']]}" if hist
             else "") + f"; launches {counts} (card: {card})", flush=True)
    if rec["captures"] != 1:
        fail(f"phase 22b K={staleness_k}: {rec['captures']} captures, not 1")
    if not same:
        fail(f"phase 22b K={staleness_k}: the captured step differs from the "
             "eager step")

    def check_cpu(ref):
        m_cpu, p_cpu, t_cpu = ref
        m_card, p_card, t_card = card_first
        gap = relative_gap(m_card["loss"], m_cpu["loss"])
        p_rel = float(np.linalg.norm(p_card.numpy() - p_cpu)
                      / np.linalg.norm(p_cpu))
        r = dict(loss_gap=gap, params_rel_l2=p_rel)
        if hist:
            lay_cpu, ver_cpu = t_cpu
            u = t_card[0].shape[1]
            r["tables_max_abs"] = float(np.abs(
                t_card[0].numpy() - lay_cpu[:, :u]).max())
            r["versions_equal"] = bool(np.array_equal(t_card[1].numpy(),
                                                      ver_cpu[:u]))
            r["tables_close"] = bool(np.allclose(
                t_card[0].numpy(), lay_cpu[:, :u], **SLICE_TOL))
            for k in ("hist_frac", "hist_staleness"):
                r[k] = (m_card[k], m_cpu[k])
        rec["card_cpu"] = r
        print(f"phase 22b K={staleness_k} first step card vs cpu: {r} "
              f"(loss rtol 1e-4, parameters 1e-4 relative L2, tables "
              f"{SLICE_TOL}; card: {card})", flush=True)
        if not (gap <= 1e-4 and p_rel <= 1e-4):
            fail(f"phase 22b K={staleness_k}: first step card vs cpu {r}")
        if hist and not (r["versions_equal"] and r["tables_close"]
                         and m_card["hist_frac"] == m_cpu["hist_frac"]
                         and m_card["hist_staleness"]
                         == m_cpu["hist_staleness"]):
            fail(f"phase 22b K={staleness_k}: refreshed tables or hist "
                 f"metrics card vs cpu {r}")
    cpu_then(cpu_ref, check_cpu)
    return rec, counts, first


def sampling_shapes(torch, b, card):
    """B3 at a sampled batch's shapes (`segment_shape`): SAGE's mean by
    receivers and the sender gather's gradient at layer 0's width (the
    features, 128) and layer 1's (hidden, 64), each over the layout the
    stack builds (the masked edges, all on the padding node, left out);
    compared on the real rows."""
    from hydragnn_tpu_torch.kernels.segment import segment_layout
    dev = b.x.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, keep = b.num_nodes, b.edge_mask
    shapes = []
    for tag, ids in (("recv_mean", b.receivers), ("send_gather_bwd",
                                                  b.senders)):
        layout = segment_layout(ids, n, keep)
        for f in (b.x.shape[1], 64):
            data = torch.randn(b.num_edges, f, device=dev,
                               generator=gen) * keep[:, None]
            shapes.append(segment_shape(
                torch, f"ogbn_sage_{tag}_f{f}", data, ids, n, layout=layout,
                real=b.node_mask, card=card))
    return shapes


def sampling_library(torch, device, card, add, graph_job):
    """22b (see the module docstring)."""
    from hydragnn_tpu_torch.examples import ogbn
    g, gen_s = graph_job.get()
    config = ogbn.load_ogbn_config()
    mcfg = ogbn.complete_config(config, g)
    lr = float(config["NeuralNetwork"]["Training"]["Optimizer"][
        "learning_rate"])
    rec = dict(graph=dict(ARXIV, edges=int(g.senders.size), generate_s=gen_s))
    shapes = None
    for k in SAMPLING_KS:
        rec[f"k{k}"], counts, first = sampling_mode(torch, device, card, g,
                                                    mcfg, lr, k)
        add(counts)
        if shapes is None:
            shapes = sampling_shapes(torch, first, card)
    r0, r4 = rec["k0"], rec[f"k{SAMPLING_KS[-1]}"]
    print(f"phase 22b: synthetic_arxiv({ARXIV['num_nodes']}) "
          f"{rec['graph']['edges']} edges (generated in {gen_s:.1f} s); "
          f"remote bytes a batch K=0 {r0['remote_bytes_per_batch']:.0f} vs "
          f"K={SAMPLING_KS[-1]} {r4['remote_bytes_per_batch']:.0f}; step "
          f"{r0['step_ms']:.3f} vs {r4['step_ms']:.3f} ms (card: {card})",
          flush=True)
    return rec, shapes


def sampling_phase(torch, device, card, counted):
    """Phase 22 (see the module docstring): (record, launches, segment_sum
    shapes)."""
    import multiprocessing
    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        counted(counts)
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
    # 22b's graph builds in a process of its own while 22a runs
    pool = multiprocessing.get_context("spawn").Pool(
        1, initializer=_cpu_worker_init, initargs=(1,))
    try:
        graph_job = pool.apply_async(arxiv_graph)
        rec = {}
        t0 = time.perf_counter()
        rec["a"] = ogbn_driver(torch, device, card, add)
        rec["a"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["b"], shapes = sampling_library(torch, device, card, add,
                                            graph_job)
        rec["b"]["phase_s"] = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    rec.update(wall_s=time.perf_counter() - t_phase, launches=launches)
    print(f"phase 22 took {rec['wall_s']:.1f} s; launches on the sampled "
          f"paths {launches} (card: {card})", flush=True)
    for name in SAMPLING_KERNELS:
        if launches.get(name, 0) == 0:
            fail(f"phase 22: {name} never launched on the sampled paths")
    return rec, launches, shapes


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
    t_smoke = time.perf_counter()
    cpu_start()

    def stamp(phase):
        """the command's elapsed time at a phase's start, for trimming"""
        print(f"phase {phase} starts at "
              f"{time.perf_counter() - t_smoke:.1f} s", flush=True)
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
    stamp(2)
    records = check_kernels(torch, dense_batch, edge_batch, loader_batch,
                            device, mcfg.hidden_dim)
    torch.cuda.synchronize()

    # ---------------------------------------------------------- phase 3
    stamp(3)
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
    phase3_engine = dict(requests_per_s=total / sum(walls),
                         p99_ms=stats["p99_ms"])
    print(f"engine: {total} requests in {BURSTS} bursts of {len(requests)} "
          f"(each submitted at once), {stats['batches']} batches, "
          f"{sum(walls):.4f} s: {total / sum(walls):.1f} requests/s; over "
          f"all requests p50 {stats['p50_ms']:.3f} ms, p99 "
          f"{stats['p99_ms']:.3f} ms (card: {card})", flush=True)

    breakdown(torch, model, first, top, dense_batch, edge_batch, card)

    # ---------------------------------------------------------- phase 4
    stamp(4)
    records["filter_scatter"], seg_shapes, counts, lj = schnet_phase(
        torch, device, card)
    records["segment_sum"]["shapes"] += seg_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in seg_shapes])
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c

    # ---------------------------------------------------------- phase 5
    stamp(5)
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
    stamp(6)
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
    stamp(7)
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
    stamp(8)
    eam = eam_setup(torch)      # phase 10's files, its CPU runs started
    resume = resume_phase(torch, device, base_cfg, splits, counted)

    # ---------------------------------------------------------- phase 9
    stamp(9)
    print("phase 9: batch packing, csce PNA at its published width",
          flush=True)
    train_paths.update(packing_phase(torch, base_cfg, splits, device,
                                     batch_size, counted, train_paths))
    packed_loader = create_dataloaders(*splits, batch_size,
                                       neighbor_format=False, packing=True)[0]
    packed_loader.set_epoch(0)
    packed_batch = next(iter(packed_loader)).to(device)

    # ---------------------------------------------------------- phase 16
    stamp(16)
    # run beside phases 5 and 9, whose csce numbers it prints its own by
    smiles = smiles_phase(torch, device, card, counted, dict(
        in_degree=in_degrees(samples), paths=train_paths,
        engine=phase3_engine))

    # ---------------------------------------------------------- phase 10
    stamp(10)
    eam_paths, eam_shapes = eam_phase(torch, device, counted, packed_batch,
                                      eam)
    train_paths.update(eam_paths)
    records["segment_sum"]["shapes"] += eam_shapes

    # ---------------------------------------------------------- phase 11
    stamp(11)
    slice_records, slice_shapes = slice_phase(torch, device, card, counted)
    train_paths.update(slice_records)
    records["segment_sum"]["shapes"] += slice_shapes

    # ---------------------------------------------------------- phase 12
    stamp(12)
    cpu_drain()     # the open loop's check reads host latency
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
    stamp(13)
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
    stamp(14)
    fleet = fleet_phase(torch, device, card, counted,
                        dict(csce, base_cfg=base_cfg, splits=splits,
                             preds=preds))
    fleet_launches = {}
    for part in ("a", "b", "c"):
        for name, c in fleet[part]["launches"].items():
            fleet_launches[name] = fleet_launches.get(name, 0) + c

    # ---------------------------------------------------------- phase 15
    stamp(15)
    a7, a7_shapes, a7_launches = a7_phase(torch, device, card, counted,
                                          lj_splits)
    records["segment_sum"]["shapes"] += a7_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in a7_shapes])

    # ---------------------------------------------------------- phase 17
    stamp(17)
    quant, quant_launches = quant_phase(
        torch, device, card, counted,
        dict(csce, base_cfg=base_cfg, splits=splits))

    # ---------------------------------------------------------- phase 18
    stamp(18)
    spmd, spmd_launches = spmd_phase(torch, device, card, counted,
                                     dict(base_cfg=base_cfg, splits=splits,
                                          mcfg=mcfg, paths=train_paths))

    # ---------------------------------------------------------- phase 19
    stamp(19)
    pipeline, pipe_launches = pipeline_phase(
        torch, device, card, counted,
        dict(base_cfg=base_cfg, splits=splits), lj_splits)

    # ---------------------------------------------------------- phase 20
    stamp(20)
    graphs, gp_launches, gp_shapes = graph_phase(
        torch, device, card, counted,
        dict(base_cfg=base_cfg, splits=splits, mcfg=mcfg,
             variables=variables), lj_splits)
    records["segment_sum"]["shapes"] += gp_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in gp_shapes])

    # ---------------------------------------------------------- phase 21
    stamp(21)
    gfm_rec, gfm_launches, gfm_shapes = gfm_phase(torch, device, card,
                                                  counted)
    records["segment_sum"]["shapes"] += gfm_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in gfm_shapes])

    # ---------------------------------------------------------- phase 22
    stamp(22)
    ogbn_rec, sampling_launches, sampling_seg = sampling_phase(
        torch, device, card, counted)
    records["segment_sum"]["shapes"] += sampling_seg
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in sampling_seg])

    stamp("cpu")
    cpu_settle()
    print("training: " + json.dumps({"card": card, "paths": train_paths,
                                     "resume": resume,
                                     "serving_graphs": SERVING_GRAPHS}),
          flush=True)
    print("serving: " + json.dumps(dict(serving, card=card)), flush=True)
    print("farm: " + json.dumps(dict(farm, card=card)), flush=True)
    print("fleet: " + json.dumps(dict(fleet, card=card)), flush=True)
    print("a7: " + json.dumps(dict(a7, card=card)), flush=True)
    print("smiles: " + json.dumps(dict(smiles, card=card)), flush=True)
    print("quant: " + json.dumps(quant), flush=True)
    print("spmd: " + json.dumps(dict(spmd, card=card)), flush=True)
    print("pipeline: " + json.dumps(dict(pipeline, card=card)), flush=True)
    print("graph_parallel: " + json.dumps(dict(graphs, card=card)),
          flush=True)
    print("gfm: " + json.dumps(dict(gfm_rec, card=card)), flush=True)
    print("sampling: " + json.dumps(dict(ogbn_rec, card=card)), flush=True)

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
        if smiles["b_launches"].get(name):
            extra["launches_smiles_path"] = smiles["b_launches"][name]
        if quant_launches.get(name):
            extra["launches_quant_path"] = quant_launches[name]
        if spmd_launches.get(name):
            extra["launches_spmd_path"] = spmd_launches[name]
            if name == "filter_scatter":
                extra["backward_launches_spmd_path"] = spmd_launches[
                    "filter_scatter_backward"]
        if pipe_launches.get(name):
            extra["launches_pipeline_path"] = pipe_launches[name]
            if name == "filter_scatter":
                extra["backward_launches_pipeline_path"] = pipe_launches[
                    "filter_scatter_backward"]
        if gp_launches.get(name):
            extra["launches_graph_parallel_path"] = gp_launches[name]
            if name == "filter_scatter":
                extra["backward_launches_graph_parallel_path"] = \
                    gp_launches["filter_scatter_backward"]
        if gfm_launches.get(name):
            extra["launches_gfm_path"] = gfm_launches[name]
        if sampling_launches.get(name):
            extra["launches_sampling_path"] = sampling_launches[name]
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
                            launches_spmd_path=spmd_launches.get(counter, 0),
                            launches_pipeline_path=pipe_launches.get(
                                counter, 0),
                            launches_graph_parallel_path=gp_launches.get(
                                counter, 0),
                            **rec))
    stamp("end")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-replica"]:
        sys.exit(fleet_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--spmd-rank"]:
        sys.exit(spmd_child(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--gfm-rank"]:
        sys.exit(md_child(*sys.argv[2:7]))
    sys.exit(main())
