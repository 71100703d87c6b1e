// pna_edge_aggregate: the Hopper kernel that replaces
// hydragnn_tpu/kernels/fused_mp_pallas.py::fused_pna_edge_aggregate
// (its accumulator part, _fused_pna_accums).
//
// Over the kept edges e into node n, with h_e = proj_i[n] + proj_j[send[e]]:
//   s = sum h_e, sq = sum h_e^2 (float32, in edge order), cnt = #edges,
//   mn / mx = min / max of h_e (0 on a node with no kept edge).
// The mean/std epilogue stays outside the kernel, in the shared
// ops/segment.pna_stats_epilogue, as on the TPU.
//
// Layout. The wrapper (hydragnn_tpu_torch/kernels/fused_mp.py) drops masked
// and out-of-range edges, stable-sorts the rest by receiver and hands in
// row_ptr [N + 1] and the senders in that order, as _masked_ids prepared
// the ids for the TPU kernel. A stable sort keeps each node's edges in
// their original order, so sums are the same on every run.
//
// Bound. Device-memory bytes: proj_i once, one proj_j row per kept edge,
// the sorted senders and row_ptr, and the outputs (four [N, F] float32
// arrays and cnt). proj_j fits in the 50 MB L2 at the csce shape.
//
// Design. The TPU kernel gathered with one-hot MXU matmuls and reduced
// min/max with chunked masked broadcasts over (edge tile x node block)
// grid steps. Here one thread owns VEC features of one receiver and walks
// its CSR edge range, keeping all four accumulators in registers: one
// pass, no atomics, no [E, F] tensor. Two launch geometries, picked by
// the wrapper per element type (kernels/fused_mp.py::forward_geometry)
// and compiled apart (kFlat): flat (`rows` 0: blocks of kRowThreads
// threads over the (row, feature group) pairs, so a warp may span two
// receivers) or whole-warp rows (slots.cuh: `rows` receivers a block,
// each on ceil(F / VEC) threads rounded up to a warp). On the H100
// whole-warp rows read faster at float32, the flat one at bf16 (PERF.md
// §6).
//
// bf16 (T = __nv_bfloat16). The message is bf16(pi + pj) and its square
// bf16(h * h); s and sq accumulate in float32 and, like cnt, are handed
// back as bf16 (fused_mp_pallas.py:336-340 casts its float32 sums to the
// data dtype); min and max are exact bf16 values. At VEC 4 the messages
// are computed on packed bf16 pairs (slots.cuh: add.rn / mul.rn, min /
// max; the bits of rounding the float32 ops), kGather gathers in flight
// before their adds: the float path spent a conversion on every rounding
// and was instruction-bound, slower than float32 on half the bytes.
#include "slots.cuh"

template <typename T, int VEC, bool kFlat>
__global__ void pna_edge_kernel(const T* __restrict__ proj_i,
                                const T* __restrict__ proj_j,
                                const int32_t* __restrict__ send_sorted,
                                const int32_t* __restrict__ row_ptr, int n,
                                int f, T* __restrict__ s_out,
                                T* __restrict__ sq_out,
                                T* __restrict__ cnt_out,
                                T* __restrict__ mn_out,
                                T* __restrict__ mx_out) {
  int row, c;
  if constexpr (kFlat) {
    const int fv = f / VEC;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * fv) return;
    row = (int)(t / fv);
    c = (int)(t % fv) * VEC;
  } else {
    row = blockIdx.x * blockDim.y + threadIdx.y;
    c = threadIdx.x * VEC;
    if (row >= n || c >= f) return;
  }
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  const long long o = (long long)row * f + c;
  Vec<VEC> s = fill_vec<VEC>(0.f), sq = fill_vec<VEC>(0.f);
  Vec<VEC> lo, hi;
  if constexpr (kPacked<T, VEC>) {
    const Pairs pi = ldg_pairs(proj_i + o);
    Pairs lo2 = fill_pairs(INFINITY), hi2 = fill_pairs(-INFINITY);
    // kGather edges at a time: the group's loads, then its adds in order
    for (int e = beg; e < end; e += kGather) {
      Pairs r[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u)
        if (e + u < end)
          r[u] = ldg_pairs(proj_j + (long long)send_sorted[e + u] * f + c);
#pragma unroll
      for (int u = 0; u < kGather; ++u)
        if (e + u < end) add_message_pairs(pi, r[u], s, sq, lo2, hi2);
    }
    lo = to_vec(lo2);
    hi = to_vec(hi2);
  } else {
    const Vec<VEC> pi = load_vec<VEC>(proj_i + o);
    lo = fill_vec<VEC>(FLT_MAX);
    hi = fill_vec<VEC>(-FLT_MAX);
    // unrolled so that several gathers are in flight before their adds
#pragma unroll 4
    for (int e = beg; e < end; ++e) {
      const int j = send_sorted[e];
      const Vec<VEC> pj = load_vec<VEC>(proj_j + (long long)j * f + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float h = rnd<T>(__fadd_rn(pi.v[i], pj.v[i]));
        s.v[i] = __fadd_rn(s.v[i], h);
        sq.v[i] = __fadd_rn(sq.v[i], rnd<T>(__fmul_rn(h, h)));
        lo.v[i] = fminf(lo.v[i], h);
        hi.v[i] = fmaxf(hi.v[i], h);
      }
    }
  }
  if (end == beg) {
    lo = fill_vec<VEC>(0.f);
    hi = fill_vec<VEC>(0.f);
  }
  store_vec<VEC>(s_out + o, s);
  store_vec<VEC>(sq_out + o, sq);
  store_vec<VEC>(mn_out + o, lo);
  store_vec<VEC>(mx_out + o, hi);
  if (c == 0) store_one(cnt_out + row, (float)(end - beg));
}

template <typename T, int VEC>
static int launch_vec(const T* proj_i, const T* proj_j,
                      const int32_t* send_sorted, const int32_t* row_ptr,
                      int n, int f, int rows, T* s, T* sq, T* cnt, T* mn,
                      T* mx, cudaStream_t st) {
  if (rows == 0) {
    pna_edge_kernel<T, VEC, true>
        <<<row_blocks(n, f, VEC), kRowThreads, 0, st>>>(
            proj_i, proj_j, send_sorted, row_ptr, n, f, s, sq, cnt, mn, mx);
    return (int)cudaGetLastError();
  }
  dim3 grid, block;
  const cudaError_t err = row_launch(n, f, VEC, rows, 0, &grid, &block);
  if (err != cudaSuccess) return (int)err;
  pna_edge_kernel<T, VEC, false><<<grid, block, 0, st>>>(
      proj_i, proj_j, send_sorted, row_ptr, n, f, s, sq, cnt, mn, mx);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* proj_i, const T* proj_j,
                  const int32_t* send_sorted, const int32_t* row_ptr, int n,
                  int f, int vec, int rows, T* s, T* sq, T* cnt, T* mn,
                  T* mx, void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch_vec<T, 4>(proj_i, proj_j, send_sorted, row_ptr, n, f, rows,
                            s, sq, cnt, mn, mx, st);
  if (vec == 1)
    return launch_vec<T, 1>(proj_i, proj_j, send_sorted, row_ptr, n, f, rows,
                            s, sq, cnt, mn, mx, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hg_pna_edge_aggregate_f32(const float* proj_i,
                                         const float* proj_j,
                                         const int32_t* send_sorted,
                                         const int32_t* row_ptr, int n, int f,
                                         int vec, int rows, float* s,
                                         float* sq, float* cnt, float* mn,
                                         float* mx, void* stream) {
  return launch<float>(proj_i, proj_j, send_sorted, row_ptr, n, f, vec, rows,
                       s, sq, cnt, mn, mx, stream);
}

extern "C" int hg_pna_edge_aggregate_bf16(const bf16* proj_i,
                                          const bf16* proj_j,
                                          const int32_t* send_sorted,
                                          const int32_t* row_ptr, int n,
                                          int f, int vec, int rows, bf16* s,
                                          bf16* sq, bf16* cnt, bf16* mn,
                                          bf16* mx, void* stream) {
  return launch<bf16>(proj_i, proj_j, send_sorted, row_ptr, n, f, vec, rows,
                      s, sq, cnt, mn, mx, stream);
}
