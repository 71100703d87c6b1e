// segment_sum: the Hopper kernel that replaces
// hydragnn_tpu/kernels/segment_pallas.py::segment_sum_pallas.
//
//   out[n, :] = sum of data[e, :] over the rows e whose segment id is n,
//               accumulated in float32.
//
// Layout. The kernel reads a CSR view of the rows sorted by segment id:
// row_ptr [N + 1] (segment n owns sorted positions [row_ptr[n],
// row_ptr[n + 1])) and `perm`, the data row of each sorted position, or
// none when the data rows are already in id order (the pooling ids are).
// The wrapper (hydragnn_tpu_torch/kernels/segment.py) takes the CSR view
// from its caller (the EF path reuses the filter layouts), or builds
// row_ptr from sorted ids with `row_ptr_kernel` below, after a stable
// argsort for unsorted ids. Ids outside [0, N) lie outside every range:
// they are never read.
//
// Bound. Device-memory bytes: every data row is read once and every output
// row written once, (E + N) * F * 4 bytes plus the ids or the layout; the
// adds (E * F) are far below the card's float32 rate.
//
// Design. The TPU kernel turned the scatter into one-hot matmuls on the MXU
// and carried the accumulator across sequential grid steps in VMEM. Here a
// thread owns 4 consecutive features (one 16-byte load when F % 4 == 0 and the
// rows are aligned, else 4 masked scalar loads: the same sums either way) of
// one of `lanes` row lanes (the wrapper picks min(32, the largest power of two
// with lanes * ceil(F / 4) <= 1024 threads), so for F <= 4 a warp spans 32
// rows and at F = 200 a block 16). Each segment is cut into chunks of C =
// kRows * lanes rows counted from the segment's own start, and one block sums
// one chunk: lane l adds rows l, l + lanes, ..., its kRows loads issued
// together, then the lanes combine by a fixed tree in shared memory. Blocks
// 0..N-1 take chunk 0 of segment blockIdx.x (and write zeros for an empty
// segment); block N + j takes the chunk k >= 1 whose first row lies in sorted
// positions [j C, (j + 1) C), if there is one: at most one segment can start
// such a chunk in that window, the one that holds position j C: the sorted id
// there when the wrapper has the sorted ids, else found by a 32-way search of
// row_ptr in one warp. So a long segment (the padding graph of a loader batch
// holds thousands of rows) spreads over many SMs, and the grid, N + ceil(E /
// C) blocks, is known on the host without reading anything back. A segment of
// one chunk is written directly. A segment of K > 1 chunks writes chunk 0's
// partial sum into its output row and chunk k's into workspace row j; the last
// of its K blocks to finish (a per-segment ticket, reset by that block for the
// next call; the wrapper keeps one ticket buffer per stream, so launches that
// may overlap never share one) adds the K partials in a fixed order and writes
// the row. There are no atomic float adds, and the order of every sum depends
// only on the segment's own rows and F: the result is the same on every run
// and wherever the segment sits in the batch.
#include "rows.cuh"

// rows each lane of a chunk block loads together: C = kRows * lanes. Of
// 2, 4 and 8, tried on the H100 (PERF.md), 2 was the fastest at the PNA
// pooling shape and met the loader shape's target; it has to depend on F
// alone (batched = single). It must equal ROWS_PER_LANE in
// kernels/segment.py, which sizes the workspace from C.
constexpr int kRows = 2;

// a key clamped into [-1, n]
template <typename K>
__device__ __forceinline__ int clamp_key(K k, int n) {
  return k < 0 ? -1 : (k >= (K)n ? n : (int)k);
}

// row_ptr[k] = the first sorted position whose key is >= k, k in [0, n]:
// position p writes every k in (key[p - 1], key[p]], with key[-1] = -1 and
// key[e] = n. Each k is written once; coalesced and fully parallel.
template <typename K>
__global__ void row_ptr_kernel(const K* __restrict__ keys, int e, int n,
                               int32_t* __restrict__ row_ptr) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p > e) return;
  const int prev = p == 0 ? -1 : clamp_key(keys[p - 1], n);
  const int cur = p == e ? n : clamp_key(keys[p], n);
  for (int k = prev + 1; k <= cur; ++k) row_ptr[k] = (int)p;
}

// The largest s in [0, n) with row_ptr[s] <= q, given row_ptr[0] <= q <
// row_ptr[n]: each round the warp's 32 lanes probe 32 evenly spaced
// entries, so N = 8192 takes 3 rounds of one load. All 32 lanes call it.
__device__ __forceinline__ int find_segment(
    const int32_t* __restrict__ row_ptr, int n, int q) {
  const int l = threadIdx.x & 31;
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int step = (hi - lo + 32) / 32;
    const int idx = lo + l * step;
    const bool ok = idx <= hi && __ldg(row_ptr + idx) <= q;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    lo += (31 - __clz(m)) * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

// 4 features [c, c + 4) of a row, 0 past F: one float4 load when V4.
template <bool V4>
__device__ __forceinline__ float4 load4(const float* p, int c, int f,
                                        bool coherent) {
  if constexpr (V4) {
    const float4* q = reinterpret_cast<const float4*>(p + c);
    return coherent ? __ldcg(q) : __ldg(q);
  } else {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = c + i < f ? (coherent ? __ldcg(p + c + i) : __ldg(p + c + i))
                       : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool V4>
__device__ __forceinline__ void store4(float* p, int c, int f, float4 x) {
  if constexpr (V4) {
    *reinterpret_cast<float4*>(p + c) = x;
  } else {
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < f) p[c + i] = v[i];
  }
}

__device__ __forceinline__ void add4(float4& a, float4 x) {
  a.x = __fadd_rn(a.x, x.x);
  a.y = __fadd_rn(a.y, x.y);
  a.z = __fadd_rn(a.z, x.z);
  a.w = __fadd_rn(a.w, x.w);
}

// Sum acc over the block's lanes by a fixed tree in shared memory (one
// float4 per thread); the result is valid in lane 0. Every thread of the
// block calls it.
__device__ __forceinline__ float4 lane_tree(float4 acc, float4* s_part,
                                            int lane, int lanes, int groups) {
  float4* mine = s_part + threadIdx.x;
  *mine = acc;
  __syncthreads();
  for (int stride = lanes >> 1; stride >= 1; stride >>= 1) {
    if (lane < stride) add4(*mine, mine[stride * groups]);
    __syncthreads();
  }
  return *mine;
}

template <bool V4, typename P, typename K>
__global__ void segment_sum_kernel(const float* __restrict__ data,
                                   const P* __restrict__ perm,
                                   const K* __restrict__ keys,
                                   const int32_t* __restrict__ row_ptr, int e,
                                   int n, int f, int lanes, int chunk_shift,
                                   float* out, float* ws,
                                   int32_t* __restrict__ tickets) {
  extern __shared__ float4 s_part[];  // [lanes, groups]
  __shared__ int s_info[3];           // segment, chunk, last block
  const int groups = (f + 3) >> 2;
  const int lane = threadIdx.x / groups;
  const int c = (threadIdx.x - lane * groups) * 4;
  const int C = 1 << chunk_shift;
  int seg = blockIdx.x, chunk = 0;
  if (blockIdx.x >= (unsigned)n) {
    if (threadIdx.x < 32) {
      const int q = (int)(blockIdx.x - n) << chunk_shift;
      int s = -1, k = 0;
      if (keys != nullptr) {  // the sorted ids name the segment at q
        s = q < e ? clamp_key(keys[q], n) : -1;
        if (s >= n) s = -1;
      } else if (__ldg(row_ptr) <= q && q < __ldg(row_ptr + n)) {
        s = find_segment(row_ptr, n, q);
      }
      if (s >= 0) {
        const int beg = __ldg(row_ptr + s);
        const int end = __ldg(row_ptr + s + 1);
        k = (q - beg + C - 1) >> chunk_shift;
        const int x = beg + (k << chunk_shift);  // first row of chunk k
        if (k == 0 || x >= end || x >= q + C) s = -1;
      }
      if (threadIdx.x == 0) {
        s_info[0] = s;
        s_info[1] = k;
      }
    }
    __syncthreads();
    seg = s_info[0];
    chunk = s_info[1];
    if (seg < 0) return;  // no chunk starts in this window
  }
  const int beg = min(max(__ldg(row_ptr + seg), 0), e);
  const int end = min(max(__ldg(row_ptr + seg + 1), beg), e);
  const int nchunks =
      end - beg <= C ? 1 : (end - beg + C - 1) >> chunk_shift;
  const int r0 = beg + (chunk << chunk_shift);
  const int r1 = min(r0 + C, end);
  // the kRows rows of this lane, loaded together before any add
  float4 x[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = r0 + lane + i * lanes;
    x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < r1) {
      const long long src =
          perm != nullptr ? (long long)perm[p] : (long long)p;
      x[i] = load4<V4>(data + src * f, c, f, false);
    }
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (r0 + lane + i * lanes < r1) add4(acc, x[i]);
  acc = lane_tree(acc, s_part, lane, lanes, groups);
  float* row = out + (long long)seg * f;
  if (nchunks == 1) {
    if (lane == 0) store4<V4>(row, c, f, acc);
    return;
  }
  // chunk k of the segment starts in window beg / C + k
  const long long first_window = beg >> chunk_shift;
  if (lane == 0) {
    store4<V4>(chunk == 0 ? row : ws + (first_window + chunk) * f, c, f,
               acc);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(tickets + seg, 1);
    s_info[2] = done == nchunks - 1;
    if (done == nchunks - 1) atomicExch(tickets + seg, 0);
  }
  __syncthreads();
  if (!s_info[2]) return;
  __threadfence();
  // the last block: lane l adds partials l, l + lanes, ... in chunk order,
  // then the lanes combine by the same tree
  acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = lane; k < nchunks; k += lanes)
    add4(acc, load4<V4>(k == 0 ? row : ws + (first_window + k) * f, c, f,
                        true));
  acc = lane_tree(acc, s_part, lane, lanes, groups);
  if (lane == 0) store4<V4>(row, c, f, acc);
}

extern "C" int hg_segment_row_ptr(const void* keys, int keys_are_64, int e,
                                  int n, int32_t* row_ptr, void* stream) {
  if (n < 0 || e < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((e + 1 + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys_are_64)
    row_ptr_kernel<int64_t><<<blocks, 256, 0, s>>>(
        static_cast<const int64_t*>(keys), e, n, row_ptr);
  else
    row_ptr_kernel<int32_t><<<blocks, 256, 0, s>>>(
        static_cast<const int32_t*>(keys), e, n, row_ptr);
  return (int)cudaGetLastError();
}

template <bool V4, typename P, typename K>
static void launch_typed(const float* data, const void* perm,
                         const void* keys, const int32_t* row_ptr, int e,
                         int n, int f, int lanes, float* out, float* ws,
                         int32_t* tickets, cudaStream_t s) {
  int shift = 0;
  while ((1 << shift) < kRows * lanes) ++shift;
  const unsigned blocks =
      (unsigned)n + (unsigned)((e + (1 << shift) - 1) >> shift);
  const int threads = lanes * ((f + 3) / 4);
  const size_t smem = (size_t)threads * sizeof(float4);
  segment_sum_kernel<V4, P, K><<<blocks, threads, smem, s>>>(
      data, static_cast<const P*>(perm), static_cast<const K*>(keys), row_ptr,
      e, n, f, lanes, shift, out, ws, tickets);
}

template <bool V4>
static void launch_v(const float* data, const void* perm, int perm_is_64,
                     const void* keys, int keys_are_64,
                     const int32_t* row_ptr, int e, int n, int f, int lanes,
                     float* out, float* ws, int32_t* tickets,
                     cudaStream_t s) {
  if (perm_is_64 && keys_are_64)
    launch_typed<V4, int64_t, int64_t>(data, perm, keys, row_ptr, e, n, f,
                                       lanes, out, ws, tickets, s);
  else if (perm_is_64)
    launch_typed<V4, int64_t, int32_t>(data, perm, keys, row_ptr, e, n, f,
                                       lanes, out, ws, tickets, s);
  else if (keys_are_64)
    launch_typed<V4, int32_t, int64_t>(data, perm, keys, row_ptr, e, n, f,
                                       lanes, out, ws, tickets, s);
  else
    launch_typed<V4, int32_t, int32_t>(data, perm, keys, row_ptr, e, n, f,
                                       lanes, out, ws, tickets, s);
}

// data [e, f] float32; perm [e] (int32 or int64) or null; keys [e] (int32
// or int64), the sorted ids in sorted order, or null (then the window
// blocks search row_ptr); row_ptr [n + 1] int32; out [n, f]; ws [ceil(e /
// C), f] float32 scratch, C = kRows * lanes; tickets [n] int32, all 0 on
// entry and left 0, used by no launch that may overlap this one. lanes is
// a power of two <= 32 with lanes * ceil(f / 4) <= 1024 (the wrapper's
// `lanes(F)`); vec 4 takes 16-byte loads (F % 4 == 0, aligned rows), vec 1
// scalar ones, with the same sums.
extern "C" int hg_segment_sum_f32(const float* data, const void* perm,
                                  int perm_is_64, const void* keys,
                                  int keys_are_64, const int32_t* row_ptr,
                                  int e, int n, int f, int vec, int lanes,
                                  float* out, float* ws, int32_t* tickets,
                                  void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      lanes * ((f + 3) / 4) > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    launch_v<true>(data, perm, perm_is_64, keys, keys_are_64, row_ptr, e, n,
                   f, lanes, out, ws, tickets, s);
  else
    launch_v<false>(data, perm, perm_is_64, keys, keys_are_64, row_ptr, e, n,
                    f, lanes, out, ws, tickets, s);
  return (int)cudaGetLastError();
}
