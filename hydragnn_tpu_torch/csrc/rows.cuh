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
//
// bf16. Kernels 2-4 are templated on their element type T (float or
// __nv_bfloat16). Loads widen T to float and stores round float to T
// (round to nearest even), so arithmetic always runs in float registers;
// `rnd<T>(x)` rounds a float to T and widens it back, the point where a
// bf16 PyTorch op stores its result. For T = float every helper is the
// identity, so the float32 instantiations compile to what they were.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

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

// VEC bf16 values widened to float: 8-byte loads when VEC == 4 (the
// wrapper picks VEC == 4 only when the row pointers are 8-byte aligned)
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const bf16* __restrict__ p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&t);
    const float2 a = __bfloat1622float2(pair[0]);
    const float2 b = __bfloat1622float2(pair[1]);
    r.v[0] = a.x;
    r.v[1] = a.y;
    r.v[2] = b.x;
    r.v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = __bfloat162float(p[i]);
  }
  return r;
}

// VEC floats rounded to bf16 (nearest even) and stored
template <int VEC>
__device__ __forceinline__ void store_vec(bf16* __restrict__ p,
                                          const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(r.v[0], r.v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(r.v[2], r.v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&a);
    t.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(r.v[i]);
  }
}

// x rounded to T and widened back to float: where a PyTorch op on T
// tensors rounds its result
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// one value stored as T
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
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
