// filter_scatter: the Hopper kernel that replaces
// hydragnn_tpu/kernels/fused_mp_pallas.py::fused_filter_scatter
// (SchNet's continuous-filter aggregation).
//
//   out[n, c] = sum over the kept edges e into node n of
//               h[send[e], c] * w[e, c]      (float32)
//
// and 0 on a node with no kept edge.
//
// Layout. The wrapper (hydragnn_tpu_torch/kernels/fused_mp.py) drops
// masked and out-of-range edges and stable-sorts the rest by receiver:
// row_ptr [N + 1], the senders in that order, and `order`, the edge id of
// each sorted position, so that w, which stays in edge order, is read as
// w[order[j]]. The backward's dh is the same sum over the transposed
// edges (g gathered by receiver, summed into senders): the wrapper calls
// this kernel again with the sender-sorted layout, so neither direction
// needs atomics, and the sums are the same on every run and wherever a
// graph sits in the batch.
//
// Bound. Device-memory bytes: w once (E * F * 4), one h row per kept edge
// (h itself, N * F * 4, stays in the 50 MB L2), the layout (row_ptr, the
// sorted senders and the order) and out (N * F * 4). Two float32
// operations per kept edge and feature are far below the card's rate.
//
// Design. The TPU kernel gathered h and scattered the products with
// one-hot MXU matmuls over (node block x edge tile) grid steps, carrying
// an accumulator in VMEM and holding all of h there (a 4 MB bound). Here
// the [E, F] products never exist and N has no bound. A receiver is owned
// by a group of `el` edge lanes x F / VEC feature threads (at F = 32: 4
// edge lanes x 8 float4 groups, one warp): edge lane l adds the products
// of the receiver's edges l, l + el, l + 2 el, ... (ranked from the
// receiver's own first edge) in float32 registers, and the lanes combine
// by a fixed shuffle tree, so the order of every sum depends only on the
// receiver's own edges. The earlier one-thread-per-receiver walk kept
// under one wave of warps on the card and waited on two dependent index
// loads per edge; here a block's receivers own one contiguous span of the
// sorted senders and order, which the block first copies into shared
// memory with coalesced loads (in tiles of kTile entries when the span is
// longer), so every h and w row load issues without a dependent global
// index load, and there are el times as many warps. Products and sums
// round separately (__fmul_rn, __fadd_rn) as the plain version's
// h[send] * w and segment sum do: nvcc contracts no FMA.
//
// bf16 (T = __nv_bfloat16): each product is rounded to bf16, as the plain
// version's bf16 h[send] * w is, the sum accumulates in float32 and out is
// stored as bf16 once (fused_mp_pallas.py:137-146 and the JAX route's
// `_accum_f32`). The dh call runs the same instantiation.
#include "rows.cuh"

constexpr int kFsThreads = 256;
constexpr int kTile = 1024;  // staged layout entries per tile

// How a block is cut for F / VEC = fv feature groups: `el` edge lanes of
// `tpr` threads per receiver, `rpb` receivers per block, and `passes`
// over the features. Up to 32 groups, up to 32 / fv edge lanes, so that
// one receiver's el * fv threads lie inside one warp; above that one lane
// of min(fv, kFsThreads) threads, each taking groups c, c + tpr, ... in
// `passes` passes over the receiver's edges (more than one only past
// kFsThreads groups), so any F runs.
struct FsShape {
  int el;
  int rpb;
  int tpr;
  int passes;
};

static FsShape fs_shape(int fv) {
  if (fv > 32) {
    const int tpr = fv < kFsThreads ? fv : kFsThreads;
    return {1, kFsThreads / tpr, tpr, (fv + tpr - 1) / tpr};
  }
  int el = 1;
  while (el * 2 * fv <= 32) el *= 2;
  return {el, (kFsThreads / 32) * (32 / (el * fv)), fv, 1};
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kFsThreads)
filter_scatter_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const int32_t* __restrict__ send_sorted,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ row_ptr, int n, int f,
                      FsShape sh, T* __restrict__ out) {
  __shared__ int32_t s_send[kTile];
  __shared__ int32_t s_order[kTile];
  const int fv = f / VEC;
  const int el = sh.el, rpb = sh.rpb;
  const int tid = threadIdx.x;
  int local, lane, c0;
  bool active;
  if (fv <= 32) {  // groups of el * fv threads, warp-aligned
    const int gs = el * fv;
    const int wl = tid & 31;
    const int g = wl / gs;
    local = (tid >> 5) * (32 / gs) + g;
    active = g < 32 / gs;
    lane = (wl - g * gs) / fv;
    c0 = (wl - g * gs - lane * fv) * VEC;
  } else {
    local = tid / sh.tpr;
    active = local < rpb;
    lane = 0;
    c0 = (tid - local * sh.tpr) * VEC;
  }
  const int first = blockIdx.x * rpb;
  const int row = first + local;
  active = active && row < n;
  const int span_beg = row_ptr[first];
  const int span_end = row_ptr[min(first + rpb, n)];
  const int beg = active ? row_ptr[row] : 0;
  const int end = active ? row_ptr[row + 1] : 0;
  // every thread runs every pass (the tiles' barriers need the block)
  for (int pass = 0; pass < sh.passes; ++pass) {
    const int c = c0 + pass * sh.tpr * VEC;
    const bool on = active && c < f;
    Vec<VEC> acc = fill_vec<VEC>(0.f);
    for (int t0 = span_beg; t0 < span_end; t0 += kTile) {
      const int t1 = min(t0 + kTile, span_end);
      __syncthreads();  // the previous tile is consumed
      for (int i = t0 + tid; i < t1; i += blockDim.x) {
        s_send[i - t0] = send_sorted[i];
        s_order[i - t0] = order[i];
      }
      __syncthreads();
      // this lane's edges in the tile: rank (j - beg) % el == lane
      int j = beg + lane;
      if (j < t0) j += (t0 - j + el - 1) / el * el;
      const int jend = on ? min(end, t1) : 0;
      // unrolled so that several gathers are in flight before their adds
#pragma unroll 4
      for (; j < jend; j += el) {
        const Vec<VEC> hv =
            load_vec<VEC>(h + (long long)s_send[j - t0] * f + c);
        const Vec<VEC> wv =
            load_vec<VEC>(w + (long long)s_order[j - t0] * f + c);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc.v[i] =
              __fadd_rn(acc.v[i], rnd<T>(__fmul_rn(hv.v[i], wv.v[i])));
      }
    }
    // fixed tree over the edge lanes: lane l takes lane l + s, s = el/2..1
    for (int s = el >> 1; s >= 1; s >>= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc.v[i] = __fadd_rn(acc.v[i],
                             __shfl_down_sync(0xffffffffu, acc.v[i], s * fv));
    }
    if (on && lane == 0) store_vec<VEC>(out + (long long)row * f + c, acc);
  }
}

template <typename T>
static int launch(const T* h, const T* w, const int32_t* send_sorted,
                  const int32_t* order, const int32_t* row_ptr, int n, int f,
                  int vec, T* out, void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  const FsShape sh = fs_shape(f / vec);
  const unsigned blocks = (unsigned)((n + sh.rpb - 1) / sh.rpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    filter_scatter_kernel<T, 4><<<blocks, kFsThreads, 0, st>>>(
        h, w, send_sorted, order, row_ptr, n, f, sh, out);
  } else {
    filter_scatter_kernel<T, 1><<<blocks, kFsThreads, 0, st>>>(
        h, w, send_sorted, order, row_ptr, n, f, sh, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int hg_filter_scatter_f32(const float* h, const float* w,
                                     const int32_t* send_sorted,
                                     const int32_t* order,
                                     const int32_t* row_ptr, int n, int f,
                                     int vec, float* out, void* stream) {
  return launch<float>(h, w, send_sorted, order, row_ptr, n, f, vec, out,
                       stream);
}

extern "C" int hg_filter_scatter_bf16(const bf16* h, const bf16* w,
                                      const int32_t* send_sorted,
                                      const int32_t* order,
                                      const int32_t* row_ptr, int n, int f,
                                      int vec, bf16* out, void* stream) {
  return launch<bf16>(h, w, send_sorted, order, row_ptr, n, f, vec, out,
                      stream);
}
