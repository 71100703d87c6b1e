// Shared pieces of the PNA kernels: the dense-layout forward
// (nbr_aggregate.cu), the edge-list forward (pna_edge_aggregate.cu) and
// both backwards' pass 1 (pna_backward.cu).
//
// Geometry. A row (a node of the [N, K] neighbour table, or a receiver of
// the edge list) owns whole warps: its threads are threadIdx.x in [0,
// tpr) with tpr = ceil(F / VEC) rounded up to 32, so no warp straddles two
// rows with different slot counts (blockDim = (tpr, rows per block)); in
// the dense kernels the lanes past F / VEC only help to compact the slot
// list. The wrappers (kernels/nbr.py::row_geometry) pick the rows per
// block, the backward's chunk and the dynamic shared memory: the
// backward's staging area [rows][chunk][F] of T (rounded up to 16 bytes),
// then, on the dense layout, the rows' slot lists [rows][K] of int (the
// backward's [rows][2 K]: neighbour ids, then the slots' layout
// positions). The edge list needs no list: a receiver's senders lie
// compact in the receiver-sorted layout already.
//
// Compaction (dense layout). The row's first warp reads the row's K
// (index, mask) pairs, 32 at a time, and writes the kept slots (mask set,
// index in [0, N)) to the list in slot order with a ballot and a
// popcount: the walks then loop over the kept slots only, without a
// branch per slot.
//
// bf16 arithmetic on pairs. At VEC 4 a bf16 thread keeps its features as
// two __nv_bfloat162 pairs and rounds with Hopper's packed bf16
// instructions: add.rn / mul.rn of two bf16 values is their exact sum or
// product rounded once to bf16, which is what rnd<T> of the float32 op
// gives (a float32 product of two bf16 values is exact; a float32 sum is
// exact unless the operands lie more than 2^16 apart, and then both round
// to the larger one), so the bits are those of the float path; one
// instruction does two features and issues no float -> bf16 conversion.
// The _rn forms are never contracted into a fused multiply-add.
#pragma once

#include <cuda_pipeline.h>

#include <atomic>

#include "rows.cuh"

// the most shared memory a block may ask for on sm_90 (227 KB); the
// wrapper keeps its requests 1 KB below it, room for the static arrays
constexpr int kMaxDynamicSmem = 232448;
constexpr int kMaxRowsPerBlock = 32;  // 1,024 threads / a warp per row
// gathers a forward kernel keeps in flight per thread
constexpr int kGather = 4;

// VEC values of T read back from shared memory
template <int VEC>
__device__ __forceinline__ Vec<VEC> lds_vec(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = p[i];
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> lds_vec(const bf16* p) {
  Vec<VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.v[i] = __bfloat162float(p[i]);
  return r;
}

// the bf16 instantiations at VEC 4 compute on pairs
template <typename T, int VEC>
constexpr bool kPacked = sizeof(T) == 2 && VEC == 4;

// 4 bf16 values as two pairs: 8 bytes, loaded and stored as one word
struct __align__(8) Pairs {
  __nv_bfloat162 v[2];
};

__device__ __forceinline__ Pairs ldg_pairs(const bf16* p) {
  Pairs r;
  *reinterpret_cast<uint2*>(&r) = __ldg(reinterpret_cast<const uint2*>(p));
  return r;
}

__device__ __forceinline__ Pairs lds_pairs(const bf16* p) {
  return *reinterpret_cast<const Pairs*>(p);
}

__device__ __forceinline__ void st_pairs(bf16* p, const Pairs& r) {
  *reinterpret_cast<Pairs*>(p) = r;
}

// pairs of floats that hold bf16 values already (exact), and back
__device__ __forceinline__ Pairs to_pairs(const Vec<4>& x) {
  Pairs r;
  r.v[0] = __floats2bfloat162_rn(x.v[0], x.v[1]);
  r.v[1] = __floats2bfloat162_rn(x.v[2], x.v[3]);
  return r;
}

__device__ __forceinline__ Vec<4> to_vec(const Pairs& x) {
  const float2 a = __bfloat1622float2(x.v[0]);
  const float2 b = __bfloat1622float2(x.v[1]);
  Vec<4> r;
  r.v[0] = a.x;
  r.v[1] = a.y;
  r.v[2] = b.x;
  r.v[3] = b.y;
  return r;
}

// the lanes of x where the 16-bit mask lanes are set, else those of y
__device__ __forceinline__ __nv_bfloat162 blend(unsigned mask,
                                                __nv_bfloat162 x,
                                                __nv_bfloat162 y) {
  const unsigned r = (mask & *reinterpret_cast<const unsigned*>(&x)) |
                     (~mask & *reinterpret_cast<const unsigned*>(&y));
  return *reinterpret_cast<const __nv_bfloat162*>(&r);
}

// One message of the forward kernels on bf16 pairs: h = pi + pj rounded
// once, added to the float32 sums s and sq (h^2 rounded once) in order,
// and folded into the packed minimum and maximum (exact)
__device__ __forceinline__ void add_message_pairs(const Pairs& pi,
                                                  const Pairs& pj, Vec<4>& s,
                                                  Vec<4>& sq, Pairs& lo,
                                                  Pairs& hi) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const __nv_bfloat162 h2 = __hadd2_rn(pi.v[q], pj.v[q]);
    const float2 h = __bfloat1622float2(h2);
    const float2 hh = __bfloat1622float2(__hmul2_rn(h2, h2));
    s.v[2 * q] = __fadd_rn(s.v[2 * q], h.x);
    s.v[2 * q + 1] = __fadd_rn(s.v[2 * q + 1], h.y);
    sq.v[2 * q] = __fadd_rn(sq.v[2 * q], hh.x);
    sq.v[2 * q + 1] = __fadd_rn(sq.v[2 * q + 1], hh.y);
    lo.v[q] = __hmin2(lo.v[q], h2);
    hi.v[q] = __hmax2(hi.v[q], h2);
  }
}

// pairs of +inf (the packed minimum's start) or -inf
__device__ __forceinline__ Pairs fill_pairs(float x) {
  Pairs r;
  r.v[0] = r.v[1] = __floats2bfloat162_rn(x, x);
  return r;
}

// The staging area's size in bytes, rounded up to 16 so that the slot
// lists after it are aligned
__host__ __device__ __forceinline__ size_t stage_bytes(int rows, int chunk,
                                                       int f, int elt) {
  return ((size_t)rows * chunk * f * elt + 15) / 16 * 16;
}

// Compacts row `row`'s kept slots into ids[0, cnt) (neighbour ids) and,
// when pos is given, at[0, cnt) (pos of each slot), in slot order; run by
// the 32 lanes of the row's first warp. Returns cnt.
__device__ __forceinline__ int compact_slots(
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ pos, int n, int k, int row, int lane,
    int* ids, int* at) {
  int cnt = 0;
  for (int base = 0; base < k; base += 32) {
    const int kk = base + lane;
    int j = -1;
    bool keep = false;
    if (row < n && kk < k) {
      const long long o = (long long)row * k + kk;
      j = nbr[o];
      keep = mask[o] && j >= 0 && j < n;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int slot = cnt + __popc(ballot & ((1u << lane) - 1u));
      ids[slot] = j;
      if (pos != nullptr) at[slot] = pos[(long long)row * k + kk];
    }
    cnt += __popc(ballot);
  }
  return cnt;
}

// VEC elements of T from device memory into shared memory, asynchronously
// where cp.async takes the size (4, 8 or 16 bytes)
template <typename T, int VEC>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    __pipeline_memcpy_async(dst, src, kBytes);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = src[i];
  }
}

// Stages this thread's features [c, c + VEC) of the proj_j rows ids[0,
// num) into stage[u * f + c] with cp.async, all in flight at once, and
// waits for them. A thread reads back only what it copied itself, so no
// barrier is needed after the wait.
template <typename T, int VEC>
__device__ __forceinline__ void stage_rows(T* stage,
                                           const T* __restrict__ proj_j,
                                           const int* ids, int num, int f,
                                           int c) {
  for (int u = 0; u < num; ++u)
    copy_async<T, VEC>(stage + (size_t)u * f + c,
                       proj_j + (long long)ids[u] * f + c);
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Lets Kernel ask for all the dynamic shared memory the current device
// allows a block beside the kernel's static arrays (a launch above 48 KB
// needs it). Done once per kernel and device, on the first call (the
// callers' first call runs outside any stream capture).
template <auto Kernel>
static cudaError_t allow_dynamic_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, Kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The launch shape of a kernel on whole-warp rows: (threads per row, rows
// per block) and the grid; cudaErrorInvalidValue when it cannot launch
static inline cudaError_t row_launch(int n, int f, int vec, int rows,
                                     size_t smem, dim3* grid, dim3* block) {
  const int tpr = (f / vec + 31) / 32 * 32;
  if (tpr > 1024 || rows < 1 || rows > kMaxRowsPerBlock ||
      tpr * rows > 1024 || smem > (size_t)kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  *block = dim3(tpr, rows);
  *grid = dim3((unsigned)((n + rows - 1) / rows));
  return cudaSuccess;
}
