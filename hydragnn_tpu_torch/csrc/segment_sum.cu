// segment_sum: the Hopper kernel that replaces
// hydragnn_tpu/kernels/segment_pallas.py::segment_sum_pallas.
//
//   out[n, :] = sum of data[e, :] over the rows e whose segment id is n,
//               accumulated in float32.
//
// Layout. The wrapper (hydragnn_tpu_torch/kernels/segment.py) hands in the
// segment ids in nondecreasing order: the ids themselves when they are
// already sorted (the pooling ids are), else the ids sorted by a stable
// argsort `perm` that maps each sorted position to its data row. Each
// block finds its segment's row range by binary search over the sorted
// ids, so ids outside [0, N) fall outside every range: they are never
// read and nothing is written out of bounds.
//
// Bound. Device-memory bytes: every data row is read once and every output
// row written once, (E + N) * F * 4 bytes plus the ids; the adds (E * F)
// are far below the card's float32 rate.
//
// Design. The TPU kernel turned the scatter into one-hot matmuls on the
// MXU and carried the accumulator across sequential grid steps in VMEM.
// Here one block owns one segment, with `lanes` row lanes of F / VEC
// threads each: lane r adds rows r, r + lanes, r + 2 lanes, ... of the
// segment in float32 registers (coalesced 16-byte loads along F), then
// lane 0 adds the lanes' partial sums in lane order from shared memory.
// A long segment (the padding graph of a batch padded for its largest
// graphs holds thousands of rows) is spread over all lanes; there are no
// one-hot FLOPs and no atomics, and the order of every sum depends only on
// the segment's own rows and F, so the result is the same on every run
// and wherever the segment sits in the batch. The whole call is one
// launch.
#include "rows.cuh"

template <int VEC>
__global__ void segment_sum_kernel(const float* __restrict__ data,
                                   const int64_t* __restrict__ perm,
                                   const int32_t* __restrict__ keys, int e,
                                   float* __restrict__ out, int f, int lanes) {
  __shared__ int s_range[2];
  extern __shared__ float s_part[];  // [lanes, f]
  if (threadIdx.x < 2) {
    // first sorted position whose id is >= segment + threadIdx.x
    const int target = blockIdx.x + threadIdx.x;
    int lo = 0, hi = e;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < target) lo = mid + 1; else hi = mid;
    }
    s_range[threadIdx.x] = lo;
  }
  __syncthreads();
  const int fv = f / VEC;
  const int lane = threadIdx.x / fv;
  const int c = (threadIdx.x % fv) * VEC;
  const int beg = s_range[0];
  const int end = s_range[1];
  Vec<VEC> acc = fill_vec<VEC>(0.f);
  // unrolled so that several row loads are in flight before their adds
#pragma unroll 4
  for (int p = beg + lane; p < end; p += lanes) {
    const long long src = perm != nullptr ? perm[p] : (long long)p;
    const Vec<VEC> x = load_vec<VEC>(data + src * f + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc.v[i] = __fadd_rn(acc.v[i], x.v[i]);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) s_part[lane * f + c + i] = acc.v[i];
  __syncthreads();
  if (lane != 0) return;
  for (int q = 1; q < lanes; ++q) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc.v[i] = __fadd_rn(acc.v[i], s_part[q * f + c + i]);
  }
  store_vec<VEC>(out + (long long)blockIdx.x * f + c, acc);
}

extern "C" int hg_segment_sum_f32(const float* data, const int64_t* perm,
                                  const int32_t* sorted_ids, int e,
                                  float* out, int n_rows, int f, int vec,
                                  void* stream) {
  if (n_rows == 0 || f == 0) return (int)cudaSuccess;
  const int fv = f / vec;
  if (fv > 1024) return (int)cudaErrorInvalidValue;
  int lanes = 1024 / fv;
  if (lanes > 32) lanes = 32;
  const size_t smem = (size_t)lanes * f * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    segment_sum_kernel<4><<<n_rows, lanes * fv, smem, s>>>(
        data, perm, sorted_ids, e, out, f, lanes);
  } else {
    segment_sum_kernel<1><<<n_rows, lanes * fv, smem, s>>>(
        data, perm, sorted_ids, e, out, f, lanes);
  }
  return (int)cudaGetLastError();
}
