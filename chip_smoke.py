#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hydragnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases:

1. Print the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; build the CUDA kernels from hydragnn_tpu_torch/csrc with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (128 molecule-sized graphs, F = 200)
   and on edge cases (isolated nodes, masked and padding edges, ids out of
   range). Min, max, count and degree must be equal; sums within
   rtol 2e-5 / atol 2e-5 (the two versions add in different orders).
   Time kernel, plain version and, where one PyTorch call computes the
   same function, that call (`index_add` for the segment sum): call
   time with CUDA events, device time from 20 calls in one CUDA graph.
   segment_sum is recorded at every shape the main paths give it (here
   the PNA pooling bucket and the loader's padding segment; phase 4 adds
   the EF shapes), each with its bound and `index_add`'s device time.
3. Serve the csce PNA model (examples/csce/csce_gap.json: 200 hidden,
   6 layers, one graph head) on 512 synthetic molecules with random
   Flax-shaped weights from a seed: `run_prediction(serve=True)` on the
   test split (dense neighbor layout, Serving.max_batch_size 128, the
   config's batch size), then an `InferenceEngine` on the edge-list layout
   over a burst of the test split repeated 8 times, then 160 timed
   bursts of the same. Every kernel
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
   segment sum's and the position gathers' backward likewise; forward
   and dh device times), the EF shapes of segment_sum (energy pooling at
   F = 1; the position gathers' backward at F = 3 on the filter layout,
   which must equal a fresh sort on every real node, and whose own
   backward must equal autograd through the plain sum of the rows the
   layout keeps), then an
   `InferenceEngine(ef_forward=True)` on the edge list over a burst of the
   test split repeated 8 times, matched against the same engine run on
   the CPU within rtol 1e-4 / atol 1e-5, then 60 timed bursts and
   one profiled EF forward + backward (device time, launches, argsorts).

The last line is {"ok": true, "device": {...}}; the line before it
holds the per-kernel JSON record (per-shape records under `shapes`), the
line before that the card's name and power limit. Any failure exits
non-zero without that line.
"""
from __future__ import annotations

import copy
import json
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
CSCE_CONFIG = "examples/csce/csce_gap.json"


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


def cuda_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() in milliseconds (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(torch, name, fn, args, bound: float) -> float:
    """Device time per call of fn(*args), which launches one kernel:
    GRAPH_CALLS calls captured in one CUDA graph and replayed (CUDA events,
    median), so the wrapper's host time is left out and the gaps between
    the launches are counted in. Each call reads its own copy of the
    inputs, so none finds them in L2 from the call before. The graph is
    captured on the stream of the warm-up call, so the kernels' per-stream
    buffers (segment_sum's tickets) already exist and their set-up is not
    captured. Fails below `bound`, which no real kernel time can be."""
    def copy(a):
        if isinstance(a, tuple):
            return tuple(copy(t) for t in a)
        return a.clone() if torch.is_tensor(a) else a
    copies = [[copy(a) for a in args] for _ in range(GRAPH_CALLS)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for c in copies:
            fn(*c)
    ms = cuda_ms(torch, graph.replay, reps=10) / GRAPH_CALLS
    if ms < bound:
        fail(f"{name}: device time {ms} ms below its bound {bound} ms")
    return ms


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


def flax_shaped_variables(model, seed: int):
    """A Flax {"params", "batch_stats"} tree of numpy arrays for `model`'s
    architecture, with random weights and running statistics."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        shape = tuple(t.shape)
        if leaf == "weight":
            leaf = "kernel"
            shape = shape[::-1]
            val = rng.normal(0.0, shape[0] ** -0.5, shape)
        elif leaf == "bias":
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
    print(f"pna_edge_aggregate: N={n} E={e} kept_edges={kept} F={f} "
          f"kernel_ms={ms:.4f} (layout given) device_ms(graph)={dev:.4f} "
          f"layout_prep_ms={prep:.4f} "
          f"plain_ms={plain:.4f} bound_ms={b_ms:.5f}", flush=True)
    records["pna_edge_aggregate"] = dict(max_abs_err=max(errs), ms=ms,
                                         device_ms=dev,
                                         plain_ms=plain, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=None)

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


def segment_shape(torch, name, data, ids, n, layout=None, real=None):
    """One shape the main paths give segment_sum: the kernel against its
    plain version (on rows [:real] when a layout leaves rows out), its
    device time and `index_add`'s (each 20 calls in one CUDA graph), and
    its bound. Sorted ids unless a layout is given."""
    from hydragnn_tpu_torch.kernels import segment

    e, f = data.shape
    sort = layout is None

    def call(d, i, lay):
        return segment.segment_sum(d, i, n, indices_are_sorted=sort,
                                   layout=lay)
    rows = slice(0, n if real is None else real)
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
          if layout is None else None)
    segs = (torch.bincount(ids.long().clamp(0, n), minlength=n + 1)[:n]
            if layout is None else torch.diff(layout[0]))
    print(f"segment_sum.{name}: E={e} N={n} F={f} "
          f"{'layout given' if layout is not None else 'sorted ids'} "
          f"longest segment {int(segs.max())} rows, "
          f"C={segment.chunk_rows(f)}: device_ms={dev:.4f} "
          f"(row_ptr pass {rp}) bound_ms={b_ms:.5f} ({b_by}) "
          f"index_add device_ms={lib:.4f} max_abs_err={err:.3e}",
          flush=True)
    return dict(shape=name, E=e, N=n, F=f, longest_segment=int(segs.max()),
                chunk_rows=segment.chunk_rows(f), device_ms=dev,
                row_ptr_device_ms=rp, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, max_abs_err=err)


def check_filter_scatter(torch, batch, device, f):
    """Phase 4a: filter_scatter (forward and backward), and the backward
    of segment_sum and of the position gathers, against their plain
    versions on the card, at the EF engine's largest bucket."""
    from hydragnn_tpu_torch.kernels import fused_mp, segment

    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)

    def randn(*shape):
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
                            p_out.detach(), exact=False))
        grad_errs.append(compare(torch, "filter_scatter.dh", dh, p_dh,
                                 exact=False))
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
    ge = randn(e, 3)
    got = []
    for fn in (segment.gather_rows, lambda x, i: x.index_select(0, i)):
        tp = pos.clone().requires_grad_(True)
        got.append(torch.autograd.grad((fn(tp, send) * ge).sum(), tp)[0])
    grad_errs.append(compare(torch, "gather_rows.backward", got[0], got[1],
                             exact=False))

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
    nodes = int(batch.node_mask.sum())
    seg_shapes = [segment_shape(torch, "ef_energy_pooling",
                                randn(n, 1) * batch.node_mask[:, None],
                                batch.node_graph, batch.num_graphs)]
    by_recv, by_send = fused_mp.segment_layouts(layout)
    ge = randn(e, 3)
    for ids, lay in ((send, by_send), (recv, by_recv)):
        fresh = segment.segment_sum(ge, ids, n)
        reuse = segment.segment_sum(ge, ids, n, layout=lay)
        if not torch.equal(fresh[:nodes], reuse[:nodes]):
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
                                    layout=by_send, real=nodes))
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
    Returns (filter_scatter record, launches of the main-path burst)."""
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
    from hydragnn_tpu_torch.utils.weights import load_jax_variables

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
    variables = flax_shaped_variables(create_model(mcfg, device="cpu"),
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
    rows = []
    for ev in prof.key_averages():
        dev_t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
        if dev_t > 0:
            rows.append((dev_t, ev.key, ev.count))
    argsorts = sum(ev.count for ev in prof.key_averages()
                   if ev.key == "aten::argsort")
    sort_launches = sum(r[2] for r in rows if "sort" in r[1].lower())
    print(f"EF forward+backward on the largest bucket (N={edge_batch.num_nodes}"
          f", E={edge_batch.num_edges}): {fwd:.3f} ms (CUDA events); "
          f"profile: device time {sum(r[0] for r in rows) / 1e3:.3f} ms in "
          f"{sum(r[2] for r in rows)} kernel launches; {argsorts} argsorts "
          f"({sort_launches} sort kernel launches, "
          f"{sum(r[0] for r in rows if 'sort' in r[1].lower()) / 1e3:.3f} "
          f"ms)", flush=True)
    for dev_t, key, count in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_t / 1e3:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    return record, seg_shapes, counts


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
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
    total = sum(r[0] for r in rows)
    print(f"profile of one edge-list forward: device time {total / 1e3:.3f} "
          f"ms in {sum(r[2] for r in rows)} kernel launches", flush=True)
    for dev, key, count in sorted(rows, reverse=True)[:10]:
        print(f"  {dev / 1e3:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)


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
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.batch import (collate,
                                                 neighbor_budget_for_dataset,
                                                 BucketSpec,
                                                 with_neighbor_format)
    from hydragnn_tpu_torch.graphs.packing import sample_sizes
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
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
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  [{stem}] {line.strip()}", flush=True)

    # ------------------------------------------------------------ data
    with open(CSCE_CONFIG) as fh:
        base_cfg = json.load(fh)
    samples = synthetic_molecules(NUM_MOLECULES, seed=SEED)
    n_tr = int(0.6 * NUM_MOLECULES)
    n_va = int(0.2 * NUM_MOLECULES)
    splits = (samples[:n_tr], samples[n_tr:n_tr + n_va],
              samples[n_tr + n_va:])
    test = splits[2]
    cfg = tcfg.update_config(copy.deepcopy(base_cfg), *splits)
    mcfg = tcfg.build_model_config(cfg)
    batch_size = int(cfg["NeuralNetwork"]["Training"]["batch_size"])
    print(f"model: {mcfg.model_type} hidden={mcfg.hidden_dim} "
          f"layers={mcfg.num_conv_layers} input_dim={mcfg.input_dim} "
          f"max_neighbours={cfg['NeuralNetwork']['Architecture']['max_neighbours']} "
          f"batch_size={batch_size} test_requests={len(test)}", flush=True)
    variables = flax_shaped_variables(create_model(mcfg, device="cpu"), SEED)

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
    records["filter_scatter"], seg_shapes, counts = schnet_phase(
        torch, device, card)
    records["segment_sum"]["shapes"] += seg_shapes
    records["segment_sum"]["max_abs_err"] = max(
        [records["segment_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for r in seg_shapes])
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c

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
    kernels = []
    for name in ("segment_sum", "nbr_aggregate", "pna_edge_aggregate",
                 "filter_scatter"):
        src, rep = sources[name]
        extra = ({"backward_launches": launches["filter_scatter_backward"]}
                 if name == "filter_scatter" else {})
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=launches[name],
                            **extra, **records[name]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
