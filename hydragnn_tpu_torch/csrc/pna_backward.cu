// pna_backward: the Hopper backward kernels of the two PNA aggregations,
// the gradients that hydragnn_tpu/kernels/nbr_pallas.py::_bwd and
// hydragnn_tpu/kernels/fused_mp_pallas.py::_pna_bwd compute (the TPU
// kernels have no backward kernel: their custom VJPs differentiate the
// unfused XLA reference). The functions are the closed forms of
// hydragnn_tpu_torch/kernels/nbr.py::nbr_aggregate_vjp and
// kernels/fused_mp.py::pna_edge_vjp, which stay the plain versions.
//
// With h = proj_i[i] + proj_j[j] on the kept slots (i, j) (the dense
// [N, K] table: slot (i, k) names j = nbr[i, k]; the edge list: edge e
// runs from j = send[e] into i = recv[e]):
//   dh   = a[i] + 2 h b[i] + [h == mn[i]] smin[i] + [h == mx[i]] smax[i]
//   dproj_i[i] = sum of dh over row i's slots
//   dproj_j[j] = sum of dh over the slots that name j
// where smin = g_min / ties (the slots that reach the minimum share its
// cotangent evenly, as JAX's min VJP does), likewise smax, and
//   edge list: a = g_s, b = g_sq (the accumulators' cotangents);
//   dense:     a = ds = (g_mean - dvar mean - dvar mean) / c,
//              b = dsq = dvar / c, c = max(count, 1),
//              dvar = g_std / (2 std) times 1 / 0.5 / 0 as
//              var = sq / c - mean^2 lies above / at / below 0.
//
// Bound. Device-memory bytes: proj_i, proj_j, mn, mx and the four
// cotangents read once, the two gradients written once, the index tables
// (the dense table and its mask, or the edges) and the CSR layouts read
// once: about 10 [N, F] arrays, 0.02 ms at the csce loader shape (N 8,192,
// F 200, float32). The torch-op VJP moves more than 2 GB: it materializes
// about 15 [N, K, F] (or [E, F]) temporaries.
//
// Design: two launches, no atomics, nothing of size [N, K, F] or [E, F].
// * Pass 1, by row: one thread owns VEC features of row i (the forward
//   kernels' shape). It walks the row's slots once, recomputing h and (for
//   the dense layout) s, sq and the count in the forward kernel's slot
//   order, so the variance branch is the one the card's forward took, and
//   counts the ties with mn and mx; forms the row's coefficients; walks
//   the slots again to sum dh into dproj_i; and stores the coefficients
//   pass 2 needs ([N, F] each: ds, dsq, smin, smax, or smin, smax).
// * Pass 2, by column: one thread owns VEC features of j and walks j's
//   range of a CSR view sorted by j (the dense layout's slot ids, i =
//   slot / K; the edge list's receivers in sender order, i = recv), which
//   the forward built once per batch. It recomputes h, gathers row i's
//   seven [N, F] rows (proj_i, a, b, mn, mx, smin, smax), mostly L2 hits
//   (7 x 6.55 MB at the loader shape), and sums dh in float32 in the
//   layout's order.
// Every sum is taken in a fixed order: two runs give the same bits. The
// launches allocate nothing and read no size from the device, so they
// can be captured into a CUDA graph.
//
// Arithmetic. _rn intrinsics throughout: nvcc contracts nothing into an
// FMA, so the recomputed h equals the forward's bit for bit (a tie that
// a contracted add missed would lose its min/max gradient) and every
// coefficient rounds where the torch-op VJP rounds.
//
// bf16 (T = __nv_bfloat16). Every op of the torch-op VJP that stores a
// bf16 tensor is a rnd<T> here, in its order (so ds subtracts dvar mean
// twice); counts and ties are counted in float32 and rounded to T where
// the VJP casts them; the sums over slots accumulate in float32 and are
// stored once.
#include "rows.cuh"

// dh of one slot with message h, from its row's coefficients
template <typename T>
__device__ __forceinline__ float slot_grad(float h, float a, float b,
                                           float lo, float smin, float hi,
                                           float smax) {
  const float hb = rnd<T>(__fmul_rn(h, b));
  float d = rnd<T>(__fadd_rn(a, rnd<T>(__fmul_rn(2.f, hb))));
  if (h == lo) d = rnd<T>(__fadd_rn(d, smin));
  if (h == hi) d = rnd<T>(__fadd_rn(d, smax));
  return d;
}

// g / max(ties, 1), the tie count cast to T first
template <typename T>
__device__ __forceinline__ float share(float g, float ties) {
  return rnd<T>(__fdiv_rn(g, rnd<T>(fmaxf(ties, 1.f))));
}

// ---------------------------------------------------------------- dense --
template <typename T, int VEC>
__global__ void nbr_bwd_rows_kernel(
    const T* __restrict__ proj_i, const T* __restrict__ proj_j,
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const T* __restrict__ mn, const T* __restrict__ mx,
    const T* __restrict__ g_mean, const T* __restrict__ g_min,
    const T* __restrict__ g_max, const T* __restrict__ g_std, int n, int k,
    int f, int rows_per_block, float eps, T* __restrict__ ds_out,
    T* __restrict__ dsq_out, T* __restrict__ smin_out,
    T* __restrict__ smax_out, T* __restrict__ d_i) {
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
  const long long o = (long long)row * f + c;
  const Vec<VEC> pi = load_vec<VEC>(proj_i + o);
  const Vec<VEC> lo = load_vec<VEC>(mn + o);
  const Vec<VEC> hi = load_vec<VEC>(mx + o);
  const int* slots = s_slot + ly * k;

  // walk 1: the sums in the forward kernel's slot order, and the ties
  Vec<VEC> s = fill_vec<VEC>(0.f), sq = fill_vec<VEC>(0.f);
  Vec<VEC> tlo = fill_vec<VEC>(0.f), thi = fill_vec<VEC>(0.f);
  float cnt = 0.f;
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
      if (h == lo.v[i]) tlo.v[i] = __fadd_rn(tlo.v[i], 1.f);
      if (h == hi.v[i]) thi.v[i] = __fadd_rn(thi.v[i], 1.f);
    }
    cnt = __fadd_rn(cnt, 1.f);
  }

  // the row's coefficients, in the torch-op VJP's op order
  const float cs = rnd<T>(fmaxf(cnt, 1.f));
  const Vec<VEC> gm = load_vec<VEC>(g_mean + o);
  const Vec<VEC> gsd = load_vec<VEC>(g_std + o);
  const Vec<VEC> gmin = load_vec<VEC>(g_min + o);
  const Vec<VEC> gmax = load_vec<VEC>(g_max + o);
  Vec<VEC> ds, dsq, smin, smax;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float m = rnd<T>(__fdiv_rn(rnd<T>(s.v[i]), cs));
    const float var = rnd<T>(__fsub_rn(rnd<T>(__fdiv_rn(rnd<T>(sq.v[i]), cs)),
                                       rnd<T>(__fmul_rn(m, m))));
    const float sd =
        rnd<T>(__fsqrt_rn(rnd<T>(__fadd_rn(fmaxf(var, 0.f), eps))));
    float dv = rnd<T>(__fdiv_rn(gsd.v[i], rnd<T>(__fmul_rn(2.f, sd))));
    dv = var > 0.f ? dv : (var == 0.f ? rnd<T>(__fmul_rn(dv, 0.5f)) : 0.f);
    const float dvm = rnd<T>(__fmul_rn(dv, m));
    ds.v[i] = rnd<T>(__fdiv_rn(
        rnd<T>(__fsub_rn(rnd<T>(__fsub_rn(gm.v[i], dvm)), dvm)), cs));
    dsq.v[i] = rnd<T>(__fdiv_rn(dv, cs));
    smin.v[i] = share<T>(gmin.v[i], tlo.v[i]);
    smax.v[i] = share<T>(gmax.v[i], thi.v[i]);
  }

  // walk 2: dproj_i
  Vec<VEC> acc = fill_vec<VEC>(0.f);
#pragma unroll 4
  for (int kk = 0; kk < k; ++kk) {
    const int j = slots[kk];
    if (j < 0) continue;
    const Vec<VEC> pj = load_vec<VEC>(proj_j + (long long)j * f + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = rnd<T>(__fadd_rn(pi.v[i], pj.v[i]));
      acc.v[i] = __fadd_rn(acc.v[i],
                           slot_grad<T>(h, ds.v[i], dsq.v[i], lo.v[i],
                                        smin.v[i], hi.v[i], smax.v[i]));
    }
  }
  store_vec<VEC>(d_i + o, acc);
  store_vec<VEC>(ds_out + o, ds);
  store_vec<VEC>(dsq_out + o, dsq);
  store_vec<VEC>(smin_out + o, smin);
  store_vec<VEC>(smax_out + o, smax);
}

// ------------------------------------------------------------ edge list --
template <typename T, int VEC>
__global__ void edge_bwd_rows_kernel(
    const T* __restrict__ proj_i, const T* __restrict__ proj_j,
    const int32_t* __restrict__ send_sorted,
    const int32_t* __restrict__ row_ptr, const T* __restrict__ mn,
    const T* __restrict__ mx, const T* __restrict__ g_s,
    const T* __restrict__ g_sq, const T* __restrict__ g_min,
    const T* __restrict__ g_max, int n, int f, T* __restrict__ smin_out,
    T* __restrict__ smax_out, T* __restrict__ d_i) {
  const int fv = f / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * fv) return;
  const int row = (int)(t / fv);
  const int c = (int)(t % fv) * VEC;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  const long long o = (long long)row * f + c;
  const Vec<VEC> pi = load_vec<VEC>(proj_i + o);
  const Vec<VEC> lo = load_vec<VEC>(mn + o);
  const Vec<VEC> hi = load_vec<VEC>(mx + o);

  // walk 1: the ties
  Vec<VEC> tlo = fill_vec<VEC>(0.f), thi = fill_vec<VEC>(0.f);
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const Vec<VEC> pj =
        load_vec<VEC>(proj_j + (long long)send_sorted[e] * f + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = rnd<T>(__fadd_rn(pi.v[i], pj.v[i]));
      if (h == lo.v[i]) tlo.v[i] = __fadd_rn(tlo.v[i], 1.f);
      if (h == hi.v[i]) thi.v[i] = __fadd_rn(thi.v[i], 1.f);
    }
  }
  const Vec<VEC> gmin = load_vec<VEC>(g_min + o);
  const Vec<VEC> gmax = load_vec<VEC>(g_max + o);
  Vec<VEC> smin, smax;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    smin.v[i] = share<T>(gmin.v[i], tlo.v[i]);
    smax.v[i] = share<T>(gmax.v[i], thi.v[i]);
  }

  // walk 2: dproj_i
  const Vec<VEC> a = load_vec<VEC>(g_s + o);
  const Vec<VEC> b = load_vec<VEC>(g_sq + o);
  Vec<VEC> acc = fill_vec<VEC>(0.f);
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const Vec<VEC> pj =
        load_vec<VEC>(proj_j + (long long)send_sorted[e] * f + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = rnd<T>(__fadd_rn(pi.v[i], pj.v[i]));
      acc.v[i] = __fadd_rn(acc.v[i],
                           slot_grad<T>(h, a.v[i], b.v[i], lo.v[i], smin.v[i],
                                        hi.v[i], smax.v[i]));
    }
  }
  store_vec<VEC>(d_i + o, acc);
  store_vec<VEC>(smin_out + o, smin);
  store_vec<VEC>(smax_out + o, smax);
}

// ------------------------------------------------------- pass 2, shared --
// dproj_j[j] = sum of dh over j's range of the column-sorted CSR view:
// entry e names row i = ids[e] / div (dense: slot ids, div = K; edge
// list: receivers in sender order, div = 1).
template <typename T, int VEC>
__global__ void bwd_cols_kernel(
    const T* __restrict__ proj_i, const T* __restrict__ proj_j,
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ mn, const T* __restrict__ mx,
    const T* __restrict__ smin, const T* __restrict__ smax,
    const int32_t* __restrict__ col_ptr, const int32_t* __restrict__ ids,
    int div, int n, int f, T* __restrict__ d_j) {
  const int fv = f / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * fv) return;
  const int col = (int)(t / fv);
  const int c = (int)(t % fv) * VEC;
  const int beg = col_ptr[col];
  const int end = col_ptr[col + 1];
  const Vec<VEC> pj = load_vec<VEC>(proj_j + (long long)col * f + c);
  Vec<VEC> acc = fill_vec<VEC>(0.f);
#pragma unroll 2
  for (int e = beg; e < end; ++e) {
    const long long o = (long long)(ids[e] / div) * f + c;
    const Vec<VEC> pi = load_vec<VEC>(proj_i + o);
    const Vec<VEC> va = load_vec<VEC>(a + o);
    const Vec<VEC> vb = load_vec<VEC>(b + o);
    const Vec<VEC> lo = load_vec<VEC>(mn + o);
    const Vec<VEC> hi = load_vec<VEC>(mx + o);
    const Vec<VEC> s0 = load_vec<VEC>(smin + o);
    const Vec<VEC> s1 = load_vec<VEC>(smax + o);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float h = rnd<T>(__fadd_rn(pi.v[i], pj.v[i]));
      acc.v[i] = __fadd_rn(acc.v[i], slot_grad<T>(h, va.v[i], vb.v[i], lo.v[i],
                                                   s0.v[i], hi.v[i], s1.v[i]));
    }
  }
  store_vec<VEC>(d_j + (long long)col * f + c, acc);
}

template <typename T>
static int launch_cols(const T* proj_i, const T* proj_j, const T* a,
                       const T* b, const T* mn, const T* mx, const T* smin,
                       const T* smax, const int32_t* col_ptr,
                       const int32_t* ids, int div, int n, int f, int vec,
                       T* d_j, cudaStream_t st) {
  const unsigned blocks = row_blocks(n, f, vec);
  if (vec == 4) {
    bwd_cols_kernel<T, 4><<<blocks, kRowThreads, 0, st>>>(
        proj_i, proj_j, a, b, mn, mx, smin, smax, col_ptr, ids, div, n, f, d_j);
  } else {
    bwd_cols_kernel<T, 1><<<blocks, kRowThreads, 0, st>>>(
        proj_i, proj_j, a, b, mn, mx, smin, smax, col_ptr, ids, div, n, f, d_j);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_nbr(const T* proj_i, const T* proj_j, const int32_t* nbr,
                      const uint8_t* mask, const T* mn, const T* mx,
                      const T* g_mean, const T* g_min, const T* g_max,
                      const T* g_std, const int32_t* col_ptr,
                      const int32_t* slot_ids, int n, int k, int f, int vec,
                      float eps, T* ds, T* dsq, T* smin, T* smax, T* d_i,
                      T* d_j, void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  const int fv = f / vec;
  if (fv > 1024 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem_cap = 48 * 1024;
  int rows_per_block = fv >= 256 ? 1 : 256 / fv;
  while (rows_per_block > 1 &&
         (size_t)rows_per_block * k * sizeof(int) > smem_cap)
    rows_per_block /= 2;
  const size_t smem = (size_t)rows_per_block * k * sizeof(int);
  if (smem > smem_cap) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  const int threads = rows_per_block * fv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    nbr_bwd_rows_kernel<T, 4><<<blocks, threads, smem, st>>>(
        proj_i, proj_j, nbr, mask, mn, mx, g_mean, g_min, g_max, g_std, n, k,
        f, rows_per_block, eps, ds, dsq, smin, smax, d_i);
  } else {
    nbr_bwd_rows_kernel<T, 1><<<blocks, threads, smem, st>>>(
        proj_i, proj_j, nbr, mask, mn, mx, g_mean, g_min, g_max, g_std, n, k,
        f, rows_per_block, eps, ds, dsq, smin, smax, d_i);
  }
  const int err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  return launch_cols<T>(proj_i, proj_j, ds, dsq, mn, mx, smin, smax, col_ptr,
                        slot_ids, k, n, f, vec, d_j, st);
}

template <typename T>
static int launch_edge(const T* proj_i, const T* proj_j, const T* mn,
                       const T* mx, const T* g_s, const T* g_sq,
                       const T* g_min, const T* g_max, const int32_t* row_ptr,
                       const int32_t* send_sorted, const int32_t* col_ptr,
                       const int32_t* recv_sorted, int n, int f, int vec,
                       T* smin, T* smax, T* d_i, T* d_j, void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  const unsigned blocks = row_blocks(n, f, vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    edge_bwd_rows_kernel<T, 4><<<blocks, kRowThreads, 0, st>>>(
        proj_i, proj_j, send_sorted, row_ptr, mn, mx, g_s, g_sq, g_min, g_max,
        n, f, smin, smax, d_i);
  } else {
    edge_bwd_rows_kernel<T, 1><<<blocks, kRowThreads, 0, st>>>(
        proj_i, proj_j, send_sorted, row_ptr, mn, mx, g_s, g_sq, g_min, g_max,
        n, f, smin, smax, d_i);
  }
  const int err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  return launch_cols<T>(proj_i, proj_j, g_s, g_sq, mn, mx, smin, smax, col_ptr,
                        recv_sorted, 1, n, f, vec, d_j, st);
}

#define HG_NBR_BWD(SUFFIX, T)                                                  \
  extern "C" int hg_nbr_aggregate_bwd_##SUFFIX(                                \
      const T* proj_i, const T* proj_j, const int32_t* nbr,                    \
      const uint8_t* mask, const T* mn, const T* mx, const T* g_mean,          \
      const T* g_min, const T* g_max, const T* g_std, const int32_t* col_ptr,  \
      const int32_t* slot_ids, int n, int k, int f, int vec, float eps, T* ds, \
      T* dsq, T* smin, T* smax, T* d_i, T* d_j, void* stream) {                \
    return launch_nbr<T>(proj_i, proj_j, nbr, mask, mn, mx, g_mean, g_min,     \
                         g_max, g_std, col_ptr, slot_ids, n, k, f, vec, eps,   \
                         ds, dsq, smin, smax, d_i, d_j, stream);               \
  }

#define HG_EDGE_BWD(SUFFIX, T)                                                 \
  extern "C" int hg_pna_edge_aggregate_bwd_##SUFFIX(                           \
      const T* proj_i, const T* proj_j, const T* mn, const T* mx,              \
      const T* g_s, const T* g_sq, const T* g_min, const T* g_max,             \
      const int32_t* row_ptr, const int32_t* send_sorted,                      \
      const int32_t* col_ptr, const int32_t* recv_sorted, int n, int f,        \
      int vec, T* smin, T* smax, T* d_i, T* d_j, void* stream) {               \
    return launch_edge<T>(proj_i, proj_j, mn, mx, g_s, g_sq, g_min, g_max,     \
                          row_ptr, send_sorted, col_ptr, recv_sorted, n, f,    \
                          vec, smin, smax, d_i, d_j, stream);                  \
  }

HG_NBR_BWD(f32, float)
HG_NBR_BWD(bf16, bf16)
HG_EDGE_BWD(f32, float)
HG_EDGE_BWD(bf16, bf16)
