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
// Design: two launches, no atomics, on both layouts alike.
// * Pass 1, by row (receiver), on the forward's whole-warp geometry
//   (slots.cuh: a row owns whole warps; the row's proj_j rows staged in
//   shared memory with cp.async, all of a chunk's gathers in flight at
//   once; a row longer than one chunk is gathered again, chunk after
//   chunk, for walk 2). The dense layout first compacts the row's kept
//   slots into a list; the edge list's are compact already, the senders
//   of the receiver-sorted layout's range [row_ptr[i], row_ptr[i + 1]).
//   Walk 1 reads the staged rows for the ties (and, dense, for s and sq
//   in the forward kernel's slot order, so the variance branch is the
//   one the card's forward took); the row's coefficients follow; walk 2
//   reads the same staged rows again, sums dh into dproj_i, and writes
//   each slot's dh, rounded to T, to the slot's position in the
//   column-sorted layout (dense: `slot_pos`; edge list: `edge_pos`, the
//   sender-sorted position of each receiver-sorted edge; both built with
//   the layouts once per forward). The edge list's row loads its seven
//   [F] coefficient rows while its gathers fly.
// * Pass 2, by column, streams that buffer (dh_cols_kernel): dproj_j[j]
//   is the float32 sum of the rows of j's range of the column-sorted
//   layout, in the layout's order, stored once.
// The buffer has N K (dense) or E (edge list) rows, of which the kept
// slots' are written, each once, and read once: its size is known
// without reading the mask. The values and the order are those of the
// first design, which gathered seven [N, F] rows per slot in pass
// 2 (proj_i, a, b, mn, mx, smin, smax: about 284 MB of L2 traffic at the
// dense loader shape) and, on the edge list, stored smin and smax for it;
// so the result is the same bit for bit. The buffer gives up that
// design's "no [E, F]-sized temporary": its written rows (40.6 MB at
// float32 at the dense loader shape) move about 81 MB.
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
// stored once. Pass 1 at VEC 4 recomputes h, h^2 and each slot's dh on
// bf16 pairs (slots.cuh: packed add.rn / mul.rn, the same bits), and
// writes dh without a conversion.
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


// ------------------------------------------------ pass 1, both layouts --
// a thread's features of one [N, F] row: floats, or bf16 pairs at VEC 4
template <typename T, int VEC>
using Row = std::conditional_t<kPacked<T, VEC>, Pairs, Vec<VEC>>;

template <typename T, int VEC>
__device__ __forceinline__ Row<T, VEC> load_row(const T* p) {
  if constexpr (kPacked<T, VEC>) {
    return ldg_pairs(p);
  } else {
    return load_vec<VEC>(p);
  }
}

// h of one staged slot: pi plus the staged proj_j features, rounded to T
// (on bf16 pairs by one packed add)
template <typename T, int VEC>
__device__ __forceinline__ Row<T, VEC> message(const Row<T, VEC>& pi,
                                               const T* staged) {
  if constexpr (kPacked<T, VEC>) {
    Pairs h = lds_pairs(staged);
#pragma unroll
    for (int q = 0; q < 2; ++q) h.v[q] = __hadd2_rn(pi.v[q], h.v[q]);
    return h;
  } else {
    Vec<VEC> h = lds_vec<VEC>(staged);
#pragma unroll
    for (int i = 0; i < VEC; ++i) h.v[i] = rnd<T>(__fadd_rn(pi.v[i], h.v[i]));
    return h;
  }
}

// Walk 1 over a row's cnt slots (the proj_j rows ids[0, cnt)), staged a
// chunk at a time: the ties with lo and hi and, with kSums, the sums s
// and sq in slot order (the forward kernels' order)
template <typename T, int VEC, bool kSums>
__device__ __forceinline__ void walk_stats(
    T* stage, const T* __restrict__ proj_j, const int* ids, int cnt,
    int chunk, int f, int c, const Row<T, VEC>& pi, const Vec<VEC>& lo,
    const Vec<VEC>& hi, Vec<VEC>& s, Vec<VEC>& sq, Vec<VEC>& tlo,
    Vec<VEC>& thi) {
  for (int beg = 0; beg < cnt; beg += chunk) {
    const int num = min(chunk, cnt - beg);
    stage_rows<T, VEC>(stage, proj_j, ids + beg, num, f, c);
    for (int u = 0; u < num; ++u) {
      const Row<T, VEC> m = message<T, VEC>(pi, stage + (size_t)u * f + c);
      Vec<VEC> h, hh;
      if constexpr (kPacked<T, VEC>) {
        h = to_vec(m);
        if constexpr (kSums) {
          Pairs sq2;
#pragma unroll
          for (int q = 0; q < 2; ++q) sq2.v[q] = __hmul2_rn(m.v[q], m.v[q]);
          hh = to_vec(sq2);
        }
      } else {
        h = m;
        if constexpr (kSums) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            hh.v[i] = rnd<T>(__fmul_rn(h.v[i], h.v[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (kSums) {
          s.v[i] = __fadd_rn(s.v[i], h.v[i]);
          sq.v[i] = __fadd_rn(sq.v[i], hh.v[i]);
        }
        if (h.v[i] == lo.v[i]) tlo.v[i] = __fadd_rn(tlo.v[i], 1.f);
        if (h.v[i] == hi.v[i]) thi.v[i] = __fadd_rn(thi.v[i], 1.f);
      }
    }
  }
}

// Walk 2 over the same slots: each slot's dh from the row's coefficients
// (a, b, the extrema and their shares), summed into the returned float32
// dproj_i in slot order and stored, rounded to T, at row at[u] of dh
// where at[u] < limit. A row of one chunk finds it still staged.
template <typename T, int VEC>
__device__ __forceinline__ Vec<VEC> walk_grads(
    T* stage, const T* __restrict__ proj_j, const int* ids, const int* at,
    int cnt, int chunk, int f, int c, const Row<T, VEC>& pi,
    const Vec<VEC>& a, const Vec<VEC>& b, const Vec<VEC>& lo,
    const Vec<VEC>& smin, const Vec<VEC>& hi, const Vec<VEC>& smax,
    T* __restrict__ dh, unsigned limit) {
  Vec<VEC> acc = fill_vec<VEC>(0.f);
  Row<T, VEC> a2, b2, lo2, hi2, s0, s1;  // the coefficients as pairs
  if constexpr (kPacked<T, VEC>) {
    a2 = to_pairs(a);
    b2 = to_pairs(b);
    lo2 = to_pairs(lo);
    hi2 = to_pairs(hi);
    s0 = to_pairs(smin);
    s1 = to_pairs(smax);
  }
  for (int beg = 0; beg < cnt; beg += chunk) {
    const int num = min(chunk, cnt - beg);
    if (cnt > chunk) stage_rows<T, VEC>(stage, proj_j, ids + beg, num, f, c);
    for (int u = 0; u < num; ++u) {
      const Row<T, VEC> m = message<T, VEC>(pi, stage + (size_t)u * f + c);
      const int p = at[beg + u];
      T* out = dh + (long long)p * f + c;
      if constexpr (kPacked<T, VEC>) {
        // slot_grad on pairs: the same roundings, two features each
        Pairs d;
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
        if ((unsigned)p < limit) st_pairs(out, d);
      } else {
        Vec<VEC> d;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          d.v[i] = slot_grad<T>(m.v[i], a.v[i], b.v[i], lo.v[i], smin.v[i],
                                hi.v[i], smax.v[i]);
          acc.v[i] = __fadd_rn(acc.v[i], d.v[i]);
        }
        if ((unsigned)p < limit) store_vec<VEC>(out, d);
      }
    }
  }
  return acc;
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
  const Row<T, VEC> pi = load_row<T, VEC>(proj_i + o);

  // walk 1: the sums in the forward kernel's slot order, and the ties
  Vec<VEC> s = fill_vec<VEC>(0.f), sq = fill_vec<VEC>(0.f);
  Vec<VEC> tlo = fill_vec<VEC>(0.f), thi = fill_vec<VEC>(0.f);
  walk_stats<T, VEC, true>(stage, proj_j, ids, cnt, chunk, f, c, pi, lo, hi,
                           s, sq, tlo, thi);

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
  const Vec<VEC> acc = walk_grads<T, VEC>(
      stage, proj_j, ids, at, cnt, chunk, f, c, pi, ds, dsq, lo, smin, hi,
      smax, dh, (unsigned)n * (unsigned)k);
  store_vec<VEC>(d_i + o, acc);
}

// ------------------------------------------------------------ edge list --
// Receiver `row`'s kept edges are [row_ptr[row], row_ptr[row + 1]) of the
// receiver-sorted layout: senders send_sorted[.], and edge_pos[.] their
// rows of dh (the edges' positions in the sender-sorted layout).
template <typename T, int VEC>
__global__ void edge_bwd_rows_kernel(
    const T* __restrict__ proj_i, const T* __restrict__ proj_j,
    const int32_t* __restrict__ send_sorted,
    const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ edge_pos, const T* __restrict__ mn,
    const T* __restrict__ mx, const T* __restrict__ g_s,
    const T* __restrict__ g_sq, const T* __restrict__ g_min,
    const T* __restrict__ g_max, int n, int e, int f, int chunk,
    T* __restrict__ dh, T* __restrict__ d_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int c = threadIdx.x * VEC;
  if (row >= n || c >= f) return;
  const int beg = row_ptr[row];
  const int cnt = row_ptr[row + 1] - beg;
  const long long o = (long long)row * f + c;
  if (cnt == 0) {
    store_vec<VEC>(d_i + o, fill_vec<VEC>(0.f));
    return;
  }
  // the row's seven inputs, loaded while walk 1's gathers fly
  const Row<T, VEC> pi = load_row<T, VEC>(proj_i + o);
  const Vec<VEC> lo = load_vec<VEC>(mn + o);
  const Vec<VEC> hi = load_vec<VEC>(mx + o);
  const Vec<VEC> a = load_vec<VEC>(g_s + o);
  const Vec<VEC> b = load_vec<VEC>(g_sq + o);
  const Vec<VEC> gmin = load_vec<VEC>(g_min + o);
  const Vec<VEC> gmax = load_vec<VEC>(g_max + o);
  T* stage = reinterpret_cast<T*>(smem) + (size_t)threadIdx.y * chunk * f;
  const int* ids = send_sorted + beg;

  // walk 1: the ties
  Vec<VEC> unused, tlo = fill_vec<VEC>(0.f), thi = fill_vec<VEC>(0.f);
  walk_stats<T, VEC, false>(stage, proj_j, ids, cnt, chunk, f, c, pi, lo,
                            hi, unused, unused, tlo, thi);
  Vec<VEC> smin, smax;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    smin.v[i] = share<T>(gmin.v[i], tlo.v[i]);
    smax.v[i] = share<T>(gmax.v[i], thi.v[i]);
  }

  // walk 2: dproj_i, and each edge's dh to its sender-sorted row
  const Vec<VEC> acc =
      walk_grads<T, VEC>(stage, proj_j, ids, edge_pos + beg, cnt, chunk, f,
                         c, pi, a, b, lo, smin, hi, smax, dh, (unsigned)e);
  store_vec<VEC>(d_i + o, acc);
}

// ----------------------------------------------------- pass 2, both --
// dproj_j[col] = the float32 sum, in order, of the dh rows of col's range
// [col_ptr[col], col_ptr[col + 1]) of the column-sorted layout, 8 rows'
// loads issued before their adds
template <typename T, int VEC>
__global__ void dh_cols_kernel(const T* __restrict__ dh,
                               const int32_t* __restrict__ col_ptr, int n,
                               int f, T* __restrict__ d_j) {
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

// -------------------------------------------------------------- launches --
// pass 1 (Kernel on whole-warp rows, after the shared-memory opt-in),
// then pass 2 over dh on the column layout
template <typename T, int VEC, auto Kernel, typename... Args>
static int launch_passes(int n, int f, int rows, int chunk, size_t smem,
                         const T* dh, const int32_t* col_ptr, T* d_j,
                         cudaStream_t st, Args... args) {
  dim3 grid, block;
  cudaError_t err = chunk < 1 ? cudaErrorInvalidValue
                              : row_launch(n, f, VEC, rows, smem, &grid,
                                           &block);
  if (err == cudaSuccess) err = allow_dynamic_smem<Kernel>();
  if (err != cudaSuccess) return (int)err;
  Kernel<<<grid, block, smem, st>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dh_cols_kernel<T, VEC><<<row_blocks(n, f, VEC), kRowThreads, 0, st>>>(
      dh, col_ptr, n, f, d_j);
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
  return launch_passes<T, VEC, &nbr_bwd_rows_kernel<T, VEC>>(
      n, f, rows, chunk, smem, dh, col_ptr, d_j, st, proj_i, proj_j, nbr,
      mask, slot_pos, mn, mx, g_mean, g_min, g_max, g_std, n, k, f, chunk,
      eps, dh, d_i);
}

template <typename T, int VEC>
static int launch_edge_vec(const T* proj_i, const T* proj_j, const T* mn,
                           const T* mx, const T* g_s, const T* g_sq,
                           const T* g_min, const T* g_max,
                           const int32_t* row_ptr, const int32_t* send_sorted,
                           const int32_t* edge_pos, const int32_t* col_ptr,
                           int n, int e, int f, int rows, int chunk,
                           size_t smem, T* dh, T* d_i, T* d_j,
                           cudaStream_t st) {
  return launch_passes<T, VEC, &edge_bwd_rows_kernel<T, VEC>>(
      n, f, rows, chunk, smem, dh, col_ptr, d_j, st, proj_i, proj_j,
      send_sorted, row_ptr, edge_pos, mn, mx, g_s, g_sq, g_min, g_max, n, e,
      f, chunk, dh, d_i);
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
                       const int32_t* send_sorted, const int32_t* edge_pos,
                       const int32_t* col_ptr, int n, int e, int f, int vec,
                       int rows, int chunk, int smem, T* dh, T* d_i, T* d_j,
                       void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HG_EDGE_BWD_ARGS                                                     \
  proj_i, proj_j, mn, mx, g_s, g_sq, g_min, g_max, row_ptr, send_sorted,     \
      edge_pos, col_ptr, n, e, f, rows, chunk, (size_t)smem, dh, d_i, d_j, st
  if (vec == 4) return launch_edge_vec<T, 4>(HG_EDGE_BWD_ARGS);
  if (vec == 1) return launch_edge_vec<T, 1>(HG_EDGE_BWD_ARGS);
#undef HG_EDGE_BWD_ARGS
  return (int)cudaErrorInvalidValue;
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

#define HG_EDGE_BWD(SUFFIX, T)                                                \
  extern "C" int hg_pna_edge_aggregate_bwd_##SUFFIX(                          \
      const T* proj_i, const T* proj_j, const T* mn, const T* mx,             \
      const T* g_s, const T* g_sq, const T* g_min, const T* g_max,            \
      const int32_t* row_ptr, const int32_t* send_sorted,                     \
      const int32_t* edge_pos, const int32_t* col_ptr, int n, int e, int f,   \
      int vec, int rows, int chunk, int smem, T* dh, T* d_i, T* d_j,          \
      void* stream) {                                                         \
    return launch_edge<T>(proj_i, proj_j, mn, mx, g_s, g_sq, g_min, g_max,    \
                          row_ptr, send_sorted, edge_pos, col_ptr, n, e, f,   \
                          vec, rows, chunk, smem, dh, d_i, d_j, stream);      \
  }

HG_NBR_BWD(f32, float)
HG_NBR_BWD(bf16, bf16)
HG_EDGE_BWD(f32, float)
HG_EDGE_BWD(bf16, bf16)
