// All-pairs order energy E[i, j] = sum_d max(0, u[i, d] - v[j, d])^2 on
// NVIDIA Hopper (sm_90a), in f32.
//
// Replaces the Pallas kernel of the JAX package,
// learning_embeddings_tpu/geometry/pairwise.py::_pairwise_order_pallas
// (lines 60-87; body _order_kernel, lines 46-57).
//
// What bounds it on an H100: at the eval path's shapes (M labels x N eval
// images, D = 10) the (M, N) f32 output is the only large array: at
// 344 x 5286 it is 7.3 MB, 2.2 us at 3.35 TB/s, while the
// 4 * M * N * D flops (sub, max, fma) take about 1.1 us at the f32
// rate of 67 TFLOP/s. So it is bound by the bytes it writes, and at this
// size a launch costs more than either.
//
// Design, and how it differs from the TPU kernel:
// * The hinge max(0, .) is no dot product, so tensor cores do not apply;
//   the work runs on the CUDA cores in f32.
// * One block of 256 threads computes one 64 x 64 output tile, each thread
//   a 4 x 4 micro-tile kept in registers. A thread's rows are
//   ty + 16 r and its columns tx + 16 c, so the 16 threads of a half warp
//   store 16 neighbouring floats of one output row.
// * D streams through shared memory in chunks of 16, stored d-major
//   (tile[d][row]) so that each step reads 4 u values and 4 v values
//   and does 16 hinge-square accumulations with them.
// * D is not padded: the TPU kernel pads D to 128 (pairwise.py:64), which
//   at D = 10 is 12.8 times the arithmetic. Here the ragged edges of M, N
//   and D are masked: rows past M or N and columns past D load as 0, which
//   adds max(0, 0 - 0)^2 = 0, and only in-range outputs are stored.
// * Blocks are independent, so nothing carries over between them (the TPU
//   grid's order plays no part); each output is written once.
//
// Built by ops/pairwise_order.py with nvcc into a shared library with a
// plain C interface (loaded with ctypes). The launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile: kTile x kTile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMicro = 4;      // each thread: kMicro x kMicro outputs
constexpr int kDChunk = 16;    // D columns staged per shared-memory round

__global__ void __launch_bounds__(kThreads)
pairwise_order_kernel(const float* __restrict__ u,
                      const float* __restrict__ v,
                      float* __restrict__ out,
                      int M, int N, int D,
                      long long ldu, long long ldv, long long ldo) {
  __shared__ float us[kDChunk][kTile];
  __shared__ float vs[kDChunk][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    // stage u[row0 : row0+64, d0 : d0+16] and the same of v, d-major;
    // consecutive threads read consecutive d of one row
#pragma unroll
    for (int k = 0; k < kTile * kDChunk / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int rr = e / kDChunk;
      const int dd = e % kDChunk;
      const int d = d0 + dd;
      const int gu = row0 + rr;
      const int gv = col0 + rr;
      us[dd][rr] = (gu < M && d < D) ? u[gu * ldu + d] : 0.f;
      vs[dd][rr] = (gv < N && d < D) ? v[gv * ldv + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int dd = 0; dd < kDChunk; ++dd) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) a[r] = us[dd][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) b[c] = vs[dd][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const float t = fmaxf(a[r] - b[c], 0.f);
          acc[r][c] = fmaf(t, t, acc[r][c]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = row0 + ty + 16 * r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = col0 + tx + 16 * c;
      if (j < N) out[i * ldo + j] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int pairwise_order_f32(const float* u, const float* v, float* out,
                                  int M, int N, int D, long long ldu,
                                  long long ldv, long long ldo,
                                  void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  pairwise_order_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      u, v, out, M, N, D, ldu, ldv, ldo);
  return static_cast<int>(cudaGetLastError());
}
