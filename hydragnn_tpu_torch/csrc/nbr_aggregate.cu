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
// on the MXU. Here one thread owns VEC features of one node: the block
// stages its nodes' K indices and masks in shared memory once, then each
// thread loops over K, gathering proj_j rows with coalesced loads and
// keeping sum, sum of squares, min and max in float32 registers. The
// epilogue is the TPU kernel's (nbr_pallas.py:78-87), rounded like the
// plain PyTorch version (no FMA contraction).
//
// bf16 (T = __nv_bfloat16). The slot message is bf16(pi + pj) and its
// square bf16(h * h), as the bf16 ops of the plain version round them;
// sums accumulate in float32 in slot order and are stored as bf16 once
// (the JAX route's float32 accumulation, ops/segment.py `_accum_f32`, not
// the Pallas kernel's bf16 accumulators); min and max are taken on the
// rounded messages, so they are exact; the count is exact. The epilogue
// rounds to bf16 after every operation, as PyTorch's bf16 ops do; the
// wrapper hands in eps already rounded to bf16 (ops/scalars.py). Half
// the bytes of the float32 instantiation move.
#include "rows.cuh"

template <typename T, int VEC>
__global__ void nbr_aggregate_kernel(
    const T* __restrict__ proj_i, const T* __restrict__ proj_j,
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask, int n,
    int k, int f, int rows_per_block, float eps, T* __restrict__ mean,
    T* __restrict__ mn, T* __restrict__ mx, T* __restrict__ sd,
    T* __restrict__ deg) {
  extern __shared__ int s_slot[];  // [rows_per_block, k]; -1 = empty slot
  const int fv = f / VEC;
  const int row0 = blockIdx.x * rows_per_block;
  for (int i = threadIdx.x; i < rows_per_block * k; i += blockDim.x) {
    const int r = row0 + i / k;
    int j = -1;
    if (r < n) {
      const long long o = (long long)r * k + i % k;
      const int idx = nbr[o];
      if (mask[o] && idx >= 0 && idx < n) j = idx;
    }
    s_slot[i] = j;
  }
  __syncthreads();

  const int ly = threadIdx.x / fv;
  const int row = row0 + ly;
  if (ly >= rows_per_block || row >= n) return;
  const int c = (threadIdx.x % fv) * VEC;
  const Vec<VEC> pi = load_vec<VEC>(proj_i + (long long)row * f + c);
  Vec<VEC> s = fill_vec<VEC>(0.f), sq = fill_vec<VEC>(0.f);
  Vec<VEC> lo = fill_vec<VEC>(FLT_MAX), hi = fill_vec<VEC>(-FLT_MAX);
  float cnt = 0.f;
  const int* slots = s_slot + ly * k;
  // unrolled so that several gathers are in flight before their adds
#pragma unroll 4
  for (int kk = 0; kk < k; ++kk) {
    const int j = slots[kk];
    if (j < 0) continue;
    const Vec<VEC> pj = load_vec<VEC>(proj_j + (long long)j * f + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = rnd<T>(__fadd_rn(pi.v[i], pj.v[i]));
      s.v[i] = __fadd_rn(s.v[i], h);
      sq.v[i] = __fadd_rn(sq.v[i], rnd<T>(__fmul_rn(h, h)));
      lo.v[i] = fminf(lo.v[i], h);
      hi.v[i] = fmaxf(hi.v[i], h);
    }
    cnt = __fadd_rn(cnt, 1.f);
  }

  const float cs = fmaxf(cnt, 1.f);
  const bool has = cnt > 0.f;
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
  const long long o = (long long)row * f + c;
  store_vec<VEC>(mean + o, o_mean);
  store_vec<VEC>(sd + o, o_sd);
  store_vec<VEC>(mn + o, o_mn);
  store_vec<VEC>(mx + o, o_mx);
  if (c == 0) store_one(deg + row, cnt);
}

template <typename T>
static int launch(const T* proj_i, const T* proj_j, const int32_t* nbr,
                  const uint8_t* mask, int n, int k, int f, int vec,
                  float eps, T* mean, T* mn, T* mx, T* sd, T* deg,
                  void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  const int fv = f / vec;
  if (fv > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem_cap = 48 * 1024;
  int rows_per_block = fv >= 256 ? 1 : 256 / fv;
  while (rows_per_block > 1 &&
         (size_t)rows_per_block * k * sizeof(int) > smem_cap)
    rows_per_block /= 2;
  const size_t smem = (size_t)rows_per_block * k * sizeof(int);
  if (smem > smem_cap) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  const int threads = rows_per_block * fv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    nbr_aggregate_kernel<T, 4><<<blocks, threads, smem, s>>>(
        proj_i, proj_j, nbr, mask, n, k, f, rows_per_block, eps, mean, mn, mx,
        sd, deg);
  } else {
    nbr_aggregate_kernel<T, 1><<<blocks, threads, smem, s>>>(
        proj_i, proj_j, nbr, mask, n, k, f, rows_per_block, eps, mean, mn, mx,
        sd, deg);
  }
  return (int)cudaGetLastError();
}

extern "C" int hg_nbr_aggregate_f32(const float* proj_i, const float* proj_j,
                                    const int32_t* nbr, const uint8_t* mask,
                                    int n, int k, int f, int vec, float eps,
                                    float* mean, float* mn, float* mx,
                                    float* sd, float* deg, void* stream) {
  return launch<float>(proj_i, proj_j, nbr, mask, n, k, f, vec, eps, mean, mn,
                       mx, sd, deg, stream);
}

extern "C" int hg_nbr_aggregate_bf16(const bf16* proj_i, const bf16* proj_j,
                                     const int32_t* nbr, const uint8_t* mask,
                                     int n, int k, int f, int vec, float eps,
                                     bf16* mean, bf16* mn, bf16* mx, bf16* sd,
                                     bf16* deg, void* stream) {
  return launch<bf16>(proj_i, proj_j, nbr, mask, n, k, f, vec, eps, mean, mn,
                      mx, sd, deg, stream);
}
