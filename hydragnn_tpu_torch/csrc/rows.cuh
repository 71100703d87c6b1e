// Shared helpers of the port's row-walking kernels (segment_sum.cu,
// nbr_aggregate.cu, pna_edge_aggregate.cu, filter_scatter.cu).
//
// Every kernel gives one thread VEC consecutive features of an output row
// and loops, inside the thread, over input rows that reduce into it
// (segment_sum.cu, whose threads always hold 4 features, and
// filter_scatter.cu split a row's inputs over several threads and combine
// them in a fixed order). Neighbouring threads hold
// neighbouring features, so each gathered row is read with coalesced
// 16-byte loads when VEC == 4 (the wrapper picks VEC == 4 only when
// F % 4 == 0 and the row pointers are 16-byte aligned).
//
// Arithmetic uses the _rn intrinsics so that nvcc never contracts an
// add and a multiply into one FMA: each kernel then rounds exactly where
// its plain PyTorch version rounds, and differs from it only in the order
// of its sums.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* __restrict__ p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = __ldg(p + i);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = r.v[i];
  }
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> fill_vec(float x) {
  Vec<VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.v[i] = x;
  return r;
}

// Blocks of 256 threads over n_rows * (f / VEC) (row, feature group) pairs.
constexpr int kRowThreads = 256;

inline unsigned row_blocks(long long n_rows, int f, int vec) {
  const long long total = n_rows * (long long)(f / vec);
  return (unsigned)((total + kRowThreads - 1) / kRowThreads);
}
