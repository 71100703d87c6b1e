// filter_scatter: the Hopper kernel that replaces
// hydragnn_tpu/kernels/fused_mp_pallas.py::fused_filter_scatter
// (SchNet's continuous-filter aggregation).
//
//   out[n, c] = sum over the kept edges e into node n of
//               h[send[e], c] * w[e, c]      (float32, in edge order)
//
// and 0 on a node with no kept edge.
//
// Layout. The wrapper (hydragnn_tpu_torch/kernels/fused_mp.py) drops
// masked and out-of-range edges and stable-sorts the rest by receiver:
// row_ptr [N + 1], the senders in that order, and `order`, the edge id of
// each sorted position, so that w, which stays in edge order, is read as
// w[order[j]]. The backward's dh is the same sum over the transposed
// edges (g gathered by receiver, summed into senders): the wrapper calls
// this kernel again with the sender-sorted layout, so neither direction
// needs atomics, and the sums are the same on every run and wherever a
// graph sits in the batch.
//
// Bound. Device-memory bytes: w once (E * F * 4), one h row per kept edge
// (h itself, N * F * 4, stays in the 50 MB L2), the layout (row_ptr, the
// sorted senders and the order) and out (N * F * 4). Two float32
// operations per kept edge and feature are far below the card's rate.
//
// Design. The TPU kernel gathered h and scattered the products with
// one-hot MXU matmuls over (node block x edge tile) grid steps, carrying
// an accumulator in VMEM and holding all of h there (a 4 MB bound). Here
// one thread owns VEC features of one receiver and walks its CSR range:
// one pass, the [E, F] products never exist, no bound on N. Products and
// sums round separately (__fmul_rn, __fadd_rn) as the plain version's
// h[send] * w and segment sum do: nvcc contracts no FMA.
#include "rows.cuh"

template <int VEC>
__global__ void filter_scatter_kernel(const float* __restrict__ h,
                                      const float* __restrict__ w,
                                      const int32_t* __restrict__ send_sorted,
                                      const int32_t* __restrict__ order,
                                      const int32_t* __restrict__ row_ptr,
                                      int n, int f, float* __restrict__ out) {
  const int fv = f / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * fv) return;
  const int row = (int)(t / fv);
  const int c = (int)(t % fv) * VEC;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  Vec<VEC> acc = fill_vec<VEC>(0.f);
  // unrolled so that several gathers are in flight before their adds
#pragma unroll 4
  for (int j = beg; j < end; ++j) {
    const Vec<VEC> hv =
        load_vec<VEC>(h + (long long)send_sorted[j] * f + c);
    const Vec<VEC> wv = load_vec<VEC>(w + (long long)order[j] * f + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc.v[i] = __fadd_rn(acc.v[i], __fmul_rn(hv.v[i], wv.v[i]));
  }
  store_vec<VEC>(out + (long long)row * f + c, acc);
}

extern "C" int hg_filter_scatter_f32(const float* h, const float* w,
                                     const int32_t* send_sorted,
                                     const int32_t* order,
                                     const int32_t* row_ptr, int n, int f,
                                     int vec, float* out, void* stream) {
  if (n == 0 || f == 0) return (int)cudaSuccess;
  const unsigned blocks = row_blocks(n, f, vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    filter_scatter_kernel<4><<<blocks, kRowThreads, 0, st>>>(
        h, w, send_sorted, order, row_ptr, n, f, out);
  } else {
    filter_scatter_kernel<1><<<blocks, kRowThreads, 0, st>>>(
        h, w, send_sorted, order, row_ptr, n, f, out);
  }
  return (int)cudaGetLastError();
}
