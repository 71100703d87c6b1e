// nbr_aggregate: the Hopper kernel that replaces
// hydragnn_tpu/kernels/nbr_pallas.py::fused_neighbor_aggregate.
//
// For every node n over its K neighbour slots (nbr [N, K], nbr_mask [N, K]):
//   h_k  = proj_i[n] + proj_j[nbr[n, k]]          (masked slots skipped)
//   mean = sum h / max(cnt, 1)
//   std  = sqrt(max(sum h^2 / max(cnt, 1) - mean^2, 0) + eps)
//   min, max over the slots (0 on a row with no slot), degree = cnt.
// The [N, K, F] message tensor is never formed. A slot whose index lies
// outside [0, N) counts as masked (the plain version does the same).
//
// Bound. Device-memory bytes: proj_i once, one proj_j row per real slot,
// the index and mask tables, and the four [N, F] outputs plus deg.
// proj_j ([N, F] float32, about 3.6 MB at the csce serving shape) fits in
// the 50 MB L2, so after its first touch the gathers are L2 hits: the
// bound with L2 reuse counts proj_j once, the DRAM-only bound counts every
// gathered row.
//
// Design. The TPU kernel rebuilt each slot with a one-hot x proj_j matmul
// on the MXU. Here a row owns whole warps and each thread VEC features of
// it (slots.cuh): the row's first warp compacts the kept slots into a
// list in shared memory; each thread then gathers its features of the
// listed proj_j rows kGather at a time, all of a group's loads issued
// before the group's adds, and keeps sum, sum of squares, min and max in
// float32 registers, slot after slot. The epilogue is the TPU kernel's
// (nbr_pallas.py:78-87), rounded like the plain PyTorch version (no FMA
// contraction). On the H100 the kernel is latency- and issue-bound, not
// byte-bound: staging a row's gathers in shared memory with cp.async (the
// backward's pass 1 does) cost more residency than it saved, and deeper
// groups more registers than they saved (PERF.md §6).
//
// bf16 (T = __nv_bfloat16). The slot message is bf16(pi + pj) and its
// square bf16(h * h), as the bf16 ops of the plain version round them;
// at VEC 4 they are packed bf16 adds and multiplies on pairs (slots.cuh),
// min and max packed bf16 min / max of the rounded messages (exact).
// Sums accumulate in float32 in slot order and are stored as bf16 once
// (the JAX route's float32 accumulation, ops/segment.py `_accum_f32`, not
// the Pallas kernel's bf16 accumulators); the count is exact. The
// epilogue rounds to bf16 after every operation, as PyTorch's bf16 ops
// do; the wrapper hands in eps already rounded to bf16 (ops/scalars.py).
#include "slots.cuh"

template <typename T, int VEC>
__global__ void nbr_aggregate_kernel(
    const T* __restrict__ proj_i, const T* __restrict__ proj_j,
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask, int n,
    int k, int f, float eps, T* __restrict__ mean, T* __restrict__ mn,
    T* __restrict__ mx, T* __restrict__ sd, T* __restrict__ deg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cnt[kMaxRowsPerBlock];
  const int ly = threadIdx.y;
  const int row = blockIdx.x * blockDim.y + ly;
  int* ids = reinterpret_cast<int*>(smem) + (size_t)ly * k;
  if (threadIdx.x < 32) {
    const int cnt = compact_slots(nbr, mask, nullptr, n, k, row,
                                  threadIdx.x, ids, nullptr);
    if (threadIdx.x == 0) s_cnt[ly] = cnt;
  }
  __syncthreads();

  const int c = threadIdx.x * VEC;
  if (row >= n || c >= f) return;
  const int cnt = s_cnt[ly];
  const long long o = (long long)row * f + c;
  Vec<VEC> s = fill_vec<VEC>(0.f), sq = fill_vec<VEC>(0.f);
  Vec<VEC> lo, hi;
  // walks the list kGather slots at a time: the group's loads, then its
  // adds in slot order
  auto walk = [&](auto load, auto add) {
    for (int beg = 0; beg < cnt; beg += kGather) {
      decltype(load(0)) r[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u)
        if (beg + u < cnt) r[u] = load(ids[beg + u]);
#pragma unroll
      for (int u = 0; u < kGather; ++u)
        if (beg + u < cnt) add(r[u]);
    }
  };
  if constexpr (kPacked<T, VEC>) {
    const Pairs pi = ldg_pairs(proj_i + o);
    Pairs lo2 = fill_pairs(INFINITY), hi2 = fill_pairs(-INFINITY);
    walk([&](int j) { return ldg_pairs(proj_j + (long long)j * f + c); },
         [&](const Pairs& pj) { add_message_pairs(pi, pj, s, sq, lo2, hi2); });
    lo = to_vec(lo2);
    hi = to_vec(hi2);
  } else {
    const Vec<VEC> pi = load_vec<VEC>(proj_i + o);
    lo = fill_vec<VEC>(FLT_MAX);
    hi = fill_vec<VEC>(-FLT_MAX);
    walk([&](int j) { return load_vec<VEC>(proj_j + (long long)j * f + c); },
         [&](const Vec<VEC>& pj) {
#pragma unroll
           for (int i = 0; i < VEC; ++i) {
             const float h = rnd<T>(__fadd_rn(pi.v[i], pj.v[i]));
             s.v[i] = __fadd_rn(s.v[i], h);
             sq.v[i] = __fadd_rn(sq.v[i], rnd<T>(__fmul_rn(h, h)));
             lo.v[i] = fminf(lo.v[i], h);
             hi.v[i] = fmaxf(hi.v[i], h);
           }
         });
  }

  const float count = (float)cnt;  // exact: a sum of ones
  const float cs = fmaxf(count, 1.f);
  const bool has = cnt > 0;
  Vec<VEC> o_mean, o_sd, o_mn, o_mx;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    // every rnd<T> is the store of one op of the plain version
    const float m = rnd<T>(__fdiv_rn(rnd<T>(s.v[i]), cs));
    const float var = fmaxf(
        rnd<T>(__fsub_rn(rnd<T>(__fdiv_rn(rnd<T>(sq.v[i]), cs)),
                         rnd<T>(__fmul_rn(m, m)))),
        0.f);
    o_mean.v[i] = m;
    o_sd.v[i] = __fsqrt_rn(rnd<T>(__fadd_rn(var, eps)));
    o_mn.v[i] = has ? lo.v[i] : 0.f;
    o_mx.v[i] = has ? hi.v[i] : 0.f;
  }
  store_vec<VEC>(mean + o, o_mean);
  store_vec<VEC>(sd + o, o_sd);
  store_vec<VEC>(mn + o, o_mn);
  store_vec<VEC>(mx + o, o_mx);
  if (c == 0) store_one(deg + row, count);
}

template <typename T, int VEC>
static int launch_vec(const T* proj_i, const T* proj_j, const int32_t* nbr,
                      const uint8_t* mask, int n, int k, int f, int rows,
                      size_t smem, float eps, T* mean, T* mn, T* mx, T* sd,
                      T* deg, cudaStream_t s) {
  dim3 grid, block;
  cudaError_t err = row_launch(n, f, VEC, rows, smem, &grid, &block);
  if (err == cudaSuccess)
    err = allow_dynamic_smem<&nbr_aggregate_kernel<T, VEC>>();
  if (err != cudaSuccess) return (int)err;
  nbr_aggregate_kernel<T, VEC><<<grid, block, smem, s>>>(
      proj_i, proj_j, nbr, mask, n, k, f, eps, mean, mn, mx, sd, deg);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* proj_i, const T* proj_j, const int32_t* nbr,
                  const uint8_t* mask, int n, int k, int f, int vec,
                  int rows, int smem, float eps, T* mean, T* mn, T* mx,
                  T* sd, T* deg, void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch_vec<T, 4>(proj_i, proj_j, nbr, mask, n, k, f, rows, smem,
                            eps, mean, mn, mx, sd, deg, s);
  if (vec == 1)
    return launch_vec<T, 1>(proj_i, proj_j, nbr, mask, n, k, f, rows, smem,
                            eps, mean, mn, mx, sd, deg, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hg_nbr_aggregate_f32(const float* proj_i, const float* proj_j,
                                    const int32_t* nbr, const uint8_t* mask,
                                    int n, int k, int f, int vec, int rows,
                                    int smem, float eps, float* mean,
                                    float* mn, float* mx, float* sd,
                                    float* deg, void* stream) {
  return launch<float>(proj_i, proj_j, nbr, mask, n, k, f, vec, rows, smem,
                       eps, mean, mn, mx, sd, deg, stream);
}

extern "C" int hg_nbr_aggregate_bf16(const bf16* proj_i, const bf16* proj_j,
                                     const int32_t* nbr, const uint8_t* mask,
                                     int n, int k, int f, int vec, int rows,
                                     int smem, float eps, bf16* mean,
                                     bf16* mn, bf16* mx, bf16* sd, bf16* deg,
                                     void* stream) {
  return launch<bf16>(proj_i, proj_j, nbr, mask, n, k, f, vec, rows, smem,
                      eps, mean, mn, mx, sd, deg, stream);
}
