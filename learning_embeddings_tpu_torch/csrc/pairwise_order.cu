// All-pairs order energy E[i, j] = sum_d max(0, u[i, d] - v[j, d])^2 on
// NVIDIA Hopper (sm_90a), in f32: two kernels, chosen by D alone.
//
// Replaces the Pallas kernel of the JAX package,
// learning_embeddings_tpu/geometry/pairwise.py::_pairwise_order_pallas
// (lines 60-87; body _order_kernel, lines 46-57).
//
// What bounds it on an H100: at the eval path's shapes (M labels x N eval
// images, D = 10) the (M, N) f32 output is the only large array: at
// 344 x 5286 it is 7.3 MB, 2.2 us at 3.35 TB/s. Right under the bytes lies
// the issue rate: each (i, j, d) costs three f32 instructions (FADD, FMNMX,
// FFMA), 54.5 M at 344 x 5286 x 10, about 1.6 us across 132 SMs x 128
// lanes at ~1.98 GHz. So the kernel may issue little beyond those three:
// any padded d-step, shared-memory load or index computation in the inner
// loop pushes the arithmetic past the byte time.
//
// Neither tensor cores nor TMA apply:
// * max(0, .) is no dot product, so there is no MMA form of the sum; it
//   runs on the CUDA cores.
// * TMA (and float4 stores) need 16-byte global strides; a contiguous
//   (M, N) f32 output has a row stride of 4 N bytes, 4-byte aligned at an
//   odd N such as 5049. A padded leading dimension would cost the caller
//   a contiguous copy (ranking and reconstruction copy E to the host). And
//   u and v are small (14 KB and 211 KB at D = 10): they are read once into
//   registers, with no shared-memory stage for a TMA to fill.
//
// Route "exact_d", 1 <= D <= kMaxExactD (the eval's D = 10), the design:
// * D is a template parameter: the d-loop is fully unrolled with no padded
//   step, and runs d = 0 .. D-1 in order, so integer inputs stay exact.
// * One warp computes one output tile of kTileRows x kTileCols = 16 x 128.
//   At the tile's start each lane loads, straight into registers (float4
//   or float2 loads where D allows), one row of u (lane l: row l % 16) and
//   the four rows of v of its columns j0 + l + 32 c, c < 4. Then it walks
//   the tile's rows two at a time: 2 D shuffles fetch the two u rows from
//   the lanes that hold them, then 2 x 4 x D hinge-square FMAs with eight
//   independent sums, then eight stores. Each store instruction writes 32
//   consecutive floats of one output row (whole 128-byte lines at an
//   aligned row start), and the four of a row cover its 128 columns.
//   No shared memory and no barrier anywhere.
// * The row loop stays rolled. Unrolled, a tile's 8 passes are straight
//   code eight times the body's size, which each warp fetches anew;
//   rolled, the body is fetched once and reused. On an H100 the rolled
//   loop was faster where a warp is alone on its SM (344 x 344) and within
//   a few percent at the large shapes.
// * 16-row tiles waste 2.3% of M = 344 (352 rows) and 1.8% of M = 723
//   (736), where the 64-row tiles of the generic route wasted 10% and 6%.
// * A persistent grid of one-warp blocks: min(tiles, k x SMs) blocks, k
//   the blocks an SM holds at this instance's register count
//   (pairwise_order_exact_blocks_per_sm); block b takes the tiles b,
//   b + grid, ... in row-major order. While a warp computes its next rows,
//   the stores of the last ones drain. The launch plan (grid, tiles, the
//   walk) is mirrored in ops/pairwise_order.py, where a CPU test checks it.
// * Ragged edges: rows past M and columns past N load the last valid row
//   (no branch in the loads) and are not stored; the row loop ends at M.
//
// Route "generic", any other D (0, and D > kMaxExactD): the runtime-D
// design of the first port. One 256-thread block per 64 x 64 output tile,
// each thread a 4 x 4 micro-tile in registers (rows ty + 16 r, columns
// tx + 16 c, so a half warp stores 16 neighbouring floats); D streams
// through shared memory in chunks of 16, d-major; ragged M, N and D are
// masked (padding loads as 0, which adds max(0, 0 - 0)^2 = 0).
//
// Both routes: blocks are independent (the TPU grid's order plays no part)
// and each output is written once. The TPU kernel pads D to 128
// (pairwise.py:64); neither route pads D.
//
// Built by ops/pairwise_order.py with nvcc into a shared library with a
// plain C interface (loaded with ctypes). Launches go on the caller's
// stream and each entry returns a cudaError_t as int.

#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

// ---- route "exact_d" -----------------------------------------------------

constexpr int kMaxExactD = 16;
constexpr int kTileRows = 16;             // rows of an output tile
constexpr int kTileCols = 128;            // columns of an output tile
constexpr int kLaneCols = kTileCols / 32;  // columns of a lane: 4
constexpr int kPassRows = 2;              // rows a pass computes at once
// registers: at most 65536 / (32 x 16) = 128 a thread
constexpr int kMinBlocksPerSm = 16;

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         float (&x)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row) + k);
      x[4 * k] = q.x;
      x[4 * k + 1] = q.y;
      x[4 * k + 2] = q.z;
      x[4 * k + 3] = q.w;
    }
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int k = 0; k < D / 2; ++k) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(row) + k);
      x[2 * k] = q.x;
      x[2 * k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = __ldg(row + d);
  }
}

template <int D>
__global__ void __launch_bounds__(32, kMinBlocksPerSm)
pairwise_order_exact_kernel(const float* __restrict__ u,
                            const float* __restrict__ v,
                            float* __restrict__ out, int M, int N,
                            int tiles_n, long long tiles) {
  static_assert(kTileRows <= 32 && kTileRows % kPassRows == 0, "tile rows");
  const int lane = threadIdx.x;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = static_cast<int>(t / tiles_n) * kTileRows;
    const int j0 = static_cast<int>(t % tiles_n) * kTileCols + lane;

    // lane l holds u row i0 + l % kTileRows; a pass takes its rows from
    // their lanes by shuffles
    float ur[D];
    load_row<D>(u + static_cast<long long>(min(i0 + lane % kTileRows, M - 1))
                        * D, ur);
    float b[kLaneCols][D];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int j = min(j0 + 32 * c, N - 1);
      load_row<D>(v + static_cast<long long>(j) * D, b[c]);
    }

    // rolled: the body stays in the instruction cache
    const int rows = min(kTileRows, M - i0);
#pragma unroll 1
    for (int r0 = 0; r0 < rows; r0 += kPassRows) {
      float a[kPassRows][D];
#pragma unroll
      for (int p = 0; p < kPassRows; ++p)
#pragma unroll
        for (int d = 0; d < D; ++d)
          a[p][d] = __shfl_sync(0xffffffffu, ur[d], r0 + p);
      float acc[kPassRows][kLaneCols];
#pragma unroll
      for (int p = 0; p < kPassRows; ++p)
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) acc[p][c] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d)
#pragma unroll
        for (int p = 0; p < kPassRows; ++p)
#pragma unroll
          for (int c = 0; c < kLaneCols; ++c) {
            const float h = fmaxf(a[p][d] - b[c][d], 0.f);
            acc[p][c] = fmaf(h, h, acc[p][c]);
          }
#pragma unroll
      for (int p = 0; p < kPassRows; ++p) {
        if (r0 + p >= rows) break;
        float* orow = out + static_cast<long long>(i0 + r0 + p) * N;
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          const int j = j0 + 32 * c;
          if (j < N) orow[j] = acc[p][c];
        }
      }
    }
  }
}

template <int D>
int launch_exact(const float* u, const float* v, float* out, int M, int N,
                 int tiles_n, long long tiles, int grid,
                 cudaStream_t stream) {
  pairwise_order_exact_kernel<D><<<grid, 32, 0, stream>>>(
      u, v, out, M, N, tiles_n, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, pairwise_order_exact_kernel<D>, 32, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

using LaunchFn = int (*)(const float*, const float*, float*, int, int, int,
                         long long, int, cudaStream_t);
using OccupancyFn = int (*)();

template <int... Ds>
constexpr std::array<LaunchFn, sizeof...(Ds)> launch_table(
    std::integer_sequence<int, Ds...>) {
  return {&launch_exact<Ds + 1>...};
}

template <int... Ds>
constexpr std::array<OccupancyFn, sizeof...(Ds)> occupancy_table(
    std::integer_sequence<int, Ds...>) {
  return {&blocks_per_sm<Ds + 1>...};
}

// entry d - 1 is the instance for D = d
constexpr auto kLaunch =
    launch_table(std::make_integer_sequence<int, kMaxExactD>{});
constexpr auto kOccupancy =
    occupancy_table(std::make_integer_sequence<int, kMaxExactD>{});

// ---- route "generic" -----------------------------------------------------

constexpr int kTile = 64;      // output tile: kTile x kTile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMicro = 4;      // each thread: kMicro x kMicro outputs
constexpr int kDChunk = 16;    // D columns staged per shared-memory round

__global__ void __launch_bounds__(kThreads)
pairwise_order_generic_kernel(const float* __restrict__ u,
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

// Route "exact_d": 1 <= D <= 16, u (M, D) and v (N, D) contiguous with
// 16-byte aligned starts, out (M, N) contiguous; tiles = ceil(M / 16) x
// tiles_n, tiles_n = ceil(N / 128); grid blocks of one warp. Returns
// cudaErrorInvalidValue (1) for a D outside the range.
extern "C" int pairwise_order_exact_f32(const float* u, const float* v,
                                        float* out, int M, int N, int D,
                                        int tiles_n, long long tiles,
                                        int grid, void* stream) {
  if (D < 1 || D > kMaxExactD) return static_cast<int>(cudaErrorInvalidValue);
  return kLaunch[D - 1](u, v, out, M, N, tiles_n, tiles, grid,
                        static_cast<cudaStream_t>(stream));
}

// Blocks of route "exact_d" at this D that one SM holds at once, or minus
// a CUDA error code.
extern "C" int pairwise_order_exact_blocks_per_sm(int D) {
  if (D < 1 || D > kMaxExactD) return -static_cast<int>(cudaErrorInvalidValue);
  return kOccupancy[D - 1]();
}

// Route "generic": any D; grid (ceil(N / 64), ceil(M / 64)).
extern "C" int pairwise_order_generic_f32(const float* u, const float* v,
                                          float* out, int M, int N, int D,
                                          long long ldu, long long ldv,
                                          long long ldo, void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  pairwise_order_generic_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      u, v, out, M, N, D, ldu, ldv, ldo);
  return static_cast<int>(cudaGetLastError());
}
