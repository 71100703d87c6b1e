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
// Design: two launches, no atomics.
// * Edge list, pass 1, by row: one thread owns VEC features of row i (the
//   forward kernels' shape). It walks the row's edges once to count the
//   ties with mn and mx; forms smin and smax; walks the edges again to sum
//   dh into dproj_i; and stores the coefficients pass 2 needs ([N, F]
//   each: smin, smax). Pass 2, by column: one thread owns VEC features of
//   j and walks j's range of the sender-sorted CSR view, which the
//   forward built once per batch. It recomputes h, gathers row i's seven
//   [N, F] rows (proj_i, a, b, mn, mx, smin, smax), mostly L2 hits, and
//   sums dh in float32 in the layout's order.
// * Dense layout, pass 1, by row, on the forward's geometry
//   (slots.cuh: a row owns whole warps, its kept slots compacted into a
//   list, their proj_j rows staged in shared memory with cp.async, all
//   of a chunk's gathers in flight at once). Walk 1 reads the staged rows
//   for s, sq and the ties in the forward kernel's slot order, so the
//   variance branch is the one the card's forward took; the row's
//   coefficients follow; walk 2 reads the same staged rows again (a row
//   longer than one chunk is gathered again, chunk after chunk) and sums
//   dh into dproj_i, and writes each slot's dh, rounded to T, to the
//   slot's position in the column-sorted layout (`slot_pos`, built with
//   the layout once per forward): a buffer of N K rows, whose first
//   row_ptr[N] (the kept slots) are written. Pass 2, by column, streams
//   that buffer: dproj_j[j] is the float32 sum of the rows of j's range
//   in the layout's order, stored once. The values and the order are
//   those of the first design, which gathered seven [N, F] rows per slot
//   in pass 2 (about 284 MB of L2 traffic at the loader shape), so the
//   result is the same bit for bit. The buffer gives up that design's
//   "no [E, F]-sized temporary": its written rows (40.6 MB at float32 at
//   the loader shape) move about 81 MB, written once and read once.
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
// stored once. The dense pass 1 at VEC 4 recomputes h, h^2 and each
// slot's dh on bf16 pairs (slots.cuh: packed add.rn / mul.rn, the same
// bits), and writes dh without a conversion.
#include <type_traits>

#include "slots.cuh"

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
    const int32_t* __restrict__ slot_pos, const T* __restrict__ mn,
    const T* __restrict__ mx, const T* __restrict__ g_mean,
    const T* __restrict__ g_min, const T* __restrict__ g_max,
    const T* __restrict__ g_std, int n, int k, int f, int chunk, float eps,
    T* __restrict__ dh, T* __restrict__ d_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cnt[kMaxRowsPerBlock];
  const int rows = blockDim.y;
  const int ly = threadIdx.y;
  const int row = blockIdx.x * rows + ly;
  T* stage = reinterpret_cast<T*>(smem) + (size_t)ly * chunk * f;
  int* ids = reinterpret_cast<int*>(
                 smem + stage_bytes(rows, chunk, f, sizeof(T))) +
             (size_t)ly * 2 * k;
  int* at = ids + k;
  if (threadIdx.x < 32) {
    const int cnt = compact_slots(nbr, mask, slot_pos, n, k, row,
                                  threadIdx.x, ids, at);
    if (threadIdx.x == 0) s_cnt[ly] = cnt;
  }
  __syncthreads();

  const int c = threadIdx.x * VEC;
  if (row >= n || c >= f) return;
  const int cnt = s_cnt[ly];
  const long long o = (long long)row * f + c;
  if (cnt == 0) {
    store_vec<VEC>(d_i + o, fill_vec<VEC>(0.f));
    return;
  }
  const Vec<VEC> lo = load_vec<VEC>(mn + o);
  const Vec<VEC> hi = load_vec<VEC>(mx + o);
  // h of one staged slot: floats, or bf16 pairs (rounded by one packed add)
  using Slot = std::conditional_t<kPacked<T, VEC>, Pairs, Vec<VEC>>;
  Slot pi;
  if constexpr (kPacked<T, VEC>) {
    pi = ldg_pairs(proj_i + o);
  } else {
    pi = load_vec<VEC>(proj_i + o);
  }
  auto message = [&](int u) {
    if constexpr (kPacked<T, VEC>) {
      Slot h = lds_pairs(stage + (size_t)u * f + c);
#pragma unroll
      for (int q = 0; q < 2; ++q) h.v[q] = __hadd2_rn(pi.v[q], h.v[q]);
      return h;
    } else {
      Slot h = lds_vec<VEC>(stage + (size_t)u * f + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) h.v[i] = rnd<T>(__fadd_rn(pi.v[i], h.v[i]));
      return h;
    }
  };

  // walk 1: the sums in the forward kernel's slot order, and the ties
  Vec<VEC> s = fill_vec<VEC>(0.f), sq = fill_vec<VEC>(0.f);
  Vec<VEC> tlo = fill_vec<VEC>(0.f), thi = fill_vec<VEC>(0.f);
  for (int beg = 0; beg < cnt; beg += chunk) {
    const int num = min(chunk, cnt - beg);
    stage_rows<T, VEC>(stage, proj_j, ids + beg, num, f, c);
    for (int u = 0; u < num; ++u) {
      const Slot m = message(u);
      Vec<VEC> h, hh;
      if constexpr (kPacked<T, VEC>) {
        Slot sq2;
#pragma unroll
        for (int q = 0; q < 2; ++q) sq2.v[q] = __hmul2_rn(m.v[q], m.v[q]);
        h = to_vec(m);
        hh = to_vec(sq2);
      } else {
        h = m;
#pragma unroll
        for (int i = 0; i < VEC; ++i) hh.v[i] = rnd<T>(__fmul_rn(h.v[i], h.v[i]));
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s.v[i] = __fadd_rn(s.v[i], h.v[i]);
        sq.v[i] = __fadd_rn(sq.v[i], hh.v[i]);
        if (h.v[i] == lo.v[i]) tlo.v[i] = __fadd_rn(tlo.v[i], 1.f);
        if (h.v[i] == hi.v[i]) thi.v[i] = __fadd_rn(thi.v[i], 1.f);
      }
    }
  }

  // the row's coefficients, in the torch-op VJP's op order
  const float cs = rnd<T>((float)cnt);  // cnt >= 1: max(count, 1) = count
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

  // walk 2: dproj_i, and each slot's dh to its place in the column layout
  const unsigned n_slots = (unsigned)n * (unsigned)k;
  Vec<VEC> acc = fill_vec<VEC>(0.f);
  Slot a2, b2, lo2, hi2, s0, s1;  // the coefficients as pairs
  if constexpr (kPacked<T, VEC>) {
    a2 = to_pairs(ds);
    b2 = to_pairs(dsq);
    lo2 = to_pairs(lo);
    hi2 = to_pairs(hi);
    s0 = to_pairs(smin);
    s1 = to_pairs(smax);
  }
  for (int beg = 0; beg < cnt; beg += chunk) {
    const int num = min(chunk, cnt - beg);
    if (cnt > chunk) stage_rows<T, VEC>(stage, proj_j, ids + beg, num, f, c);
    for (int u = 0; u < num; ++u) {
      const Slot m = message(u);
      const int p = at[beg + u];
      T* out = dh + (long long)p * f + c;
      if constexpr (kPacked<T, VEC>) {
        // slot_grad on pairs: the same roundings, two features each
        Slot d;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const __nv_bfloat162 hb = __hmul2_rn(m.v[q], b2.v[q]);
          __nv_bfloat162 x = __hadd2_rn(a2.v[q], __hadd2_rn(hb, hb));
          x = blend(__heq2_mask(m.v[q], lo2.v[q]), __hadd2_rn(x, s0.v[q]), x);
          x = blend(__heq2_mask(m.v[q], hi2.v[q]), __hadd2_rn(x, s1.v[q]), x);
          d.v[q] = x;
        }
        const Vec<VEC> df = to_vec(d);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc.v[i] = __fadd_rn(acc.v[i], df.v[i]);
        if ((unsigned)p < n_slots) st_pairs(out, d);
      } else {
        Vec<VEC> d;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          d.v[i] = slot_grad<T>(m.v[i], ds.v[i], dsq.v[i], lo.v[i], smin.v[i],
                                hi.v[i], smax.v[i]);
          acc.v[i] = __fadd_rn(acc.v[i], d.v[i]);
        }
        if ((unsigned)p < n_slots) store_vec<VEC>(out, d);
      }
    }
  }
  store_vec<VEC>(d_i + o, acc);
}

// dproj_j[col] = the float32 sum, in order, of the dh rows of col's range
// [col_ptr[col], col_ptr[col + 1]) of the column-sorted layout, 8 rows'
// loads issued before their adds
template <typename T, int VEC>
__global__ void nbr_bwd_cols_kernel(const T* __restrict__ dh,
                                    const int32_t* __restrict__ col_ptr,
                                    int n, int f, T* __restrict__ d_j) {
  const int fv = f / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * fv) return;
  const int col = (int)(t / fv);
  const int c = (int)(t % fv) * VEC;
  const int end = col_ptr[col + 1];
  int e = col_ptr[col];
  Vec<VEC> acc = fill_vec<VEC>(0.f);
  for (; e + 8 <= end; e += 8) {
    Vec<VEC> v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = load_vec<VEC>(dh + (long long)(e + u) * f + c);
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc.v[i] = __fadd_rn(acc.v[i], v[u].v[i]);
  }
  for (; e < end; ++e) {
    const Vec<VEC> v = load_vec<VEC>(dh + (long long)e * f + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc.v[i] = __fadd_rn(acc.v[i], v.v[i]);
  }
  store_vec<VEC>(d_j + (long long)col * f + c, acc);
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

// ---------------------------------------------------- edge list, pass 2 --
// dproj_j[j] = sum of dh over j's range of the column-sorted CSR view:
// entry e names row i = ids[e] / div (the edge list's receivers in sender
// order, div = 1).
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

template <typename T, int VEC>
static int launch_nbr_vec(const T* proj_i, const T* proj_j,
                          const int32_t* nbr, const uint8_t* mask,
                          const int32_t* slot_pos, const int32_t* col_ptr,
                          const T* mn, const T* mx, const T* g_mean,
                          const T* g_min, const T* g_max, const T* g_std,
                          int n, int k, int f, int rows, int chunk,
                          size_t smem, float eps, T* dh, T* d_i, T* d_j,
                          cudaStream_t st) {
  dim3 grid, block;
  cudaError_t err = chunk < 1 ? cudaErrorInvalidValue
                              : row_launch(n, f, VEC, rows, smem, &grid,
                                           &block);
  if (err == cudaSuccess)
    err = allow_dynamic_smem<&nbr_bwd_rows_kernel<T, VEC>>();
  if (err != cudaSuccess) return (int)err;
  nbr_bwd_rows_kernel<T, VEC><<<grid, block, smem, st>>>(
      proj_i, proj_j, nbr, mask, slot_pos, mn, mx, g_mean, g_min, g_max,
      g_std, n, k, f, chunk, eps, dh, d_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nbr_bwd_cols_kernel<T, VEC><<<row_blocks(n, f, VEC), kRowThreads, 0, st>>>(
      dh, col_ptr, n, f, d_j);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_nbr(const T* proj_i, const T* proj_j, const int32_t* nbr,
                      const uint8_t* mask, const int32_t* slot_pos,
                      const int32_t* col_ptr, const T* mn, const T* mx,
                      const T* g_mean, const T* g_min, const T* g_max,
                      const T* g_std, int n, int k, int f, int vec, int rows,
                      int chunk, int smem, float eps, T* dh, T* d_i, T* d_j,
                      void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  if (k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HG_NBR_BWD_ARGS                                                    \
  proj_i, proj_j, nbr, mask, slot_pos, col_ptr, mn, mx, g_mean, g_min,     \
      g_max, g_std, n, k, f, rows, chunk, (size_t)smem, eps, dh, d_i, d_j, \
      st
  if (vec == 4) return launch_nbr_vec<T, 4>(HG_NBR_BWD_ARGS);
  if (vec == 1) return launch_nbr_vec<T, 1>(HG_NBR_BWD_ARGS);
#undef HG_NBR_BWD_ARGS
  return (int)cudaErrorInvalidValue;
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

#define HG_NBR_BWD(SUFFIX, T)                                                 \
  extern "C" int hg_nbr_aggregate_bwd_##SUFFIX(                               \
      const T* proj_i, const T* proj_j, const int32_t* nbr,                   \
      const uint8_t* mask, const int32_t* slot_pos, const int32_t* col_ptr,   \
      const T* mn, const T* mx, const T* g_mean, const T* g_min,              \
      const T* g_max, const T* g_std, int n, int k, int f, int vec, int rows, \
      int chunk, int smem, float eps, T* dh, T* d_i, T* d_j, void* stream) {  \
    return launch_nbr<T>(proj_i, proj_j, nbr, mask, slot_pos, col_ptr, mn,   \
                         mx, g_mean, g_min, g_max, g_std, n, k, f, vec, rows, \
                         chunk, smem, eps, dh, d_i, d_j, stream);             \
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
