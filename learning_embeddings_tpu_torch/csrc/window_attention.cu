// Windowed multi-head attention with an additive bias, forward and backward,
// on NVIDIA Hopper (sm_90a) in bf16: softmax(q.k^T / sqrt(d) + bias).v for
// every image, window and head of a Swin block (models/swin.py), read in
// place from the packed qkv projection.
//
// Replaces no TPU kernel: the JAX package has no transformer. It replaces,
// in the port, the memory-efficient SDPA call of ops/attention.py's biased
// route and the three layout copies around it (q, k and v out of the packed
// projection, the output's transpose back, the stack of dq, dk and dv).
//
// Shapes. qkv is (B, nW, N, 3C) bf16, C = H d: the token n of window w of
// image b holds q at [.., 0:C], k at [.., C:2C], v at [.., 2C:3C], head h at
// columns h d .. h d + d of each. bias is (1, nW H, N, N) bf16, the (window,
// head) pair p = w H + h at [p]. out is (B, nW, N, C), the layout the output
// projection reads. N and d are compile-time (WA_N <= 144, WA_D in 16, 32,
// 64); ops/window_attention.py builds one library per pair it meets.
//
// What bounds it on an H100: bytes. A (window, head) of one image holds
// 4 N d bf16 of q, k, v and output (36.9 KB at N 144, d 32) for 4 N^2 d
// multiply-adds a pass; the card's 989 TFLOP/s against its 3.35 TB/s put
// the forward at ~2.6x less time in the tensor cores than in memory, and
// the backward (q, k, v, o, dO read; dq, dk, dv written) at ~2x. Two other
// streams would dominate a plain design: the bias (41.5 KB a (window, head)
// at N 144, more than the image's q, k, v and output), if read again for
// every image, and its gradient, if written for every image (PyTorch's
// memory-efficient kernel writes (B, nW H, N, N) and then sums it).
//
// The design:
// * One block owns one (window, head) pair and a chunk of consecutive
//   images (grid: pairs x chunks), and loops over them. The bias of its
//   pair is read once per block: into registers in the forward (each warp's
//   16 rows), into shared memory in the backward. The chunk is chosen by the
//   wrapper from B, the pairs and the blocks the card holds at once
//   (ops/window_attention.py::launch_plan), so that every stage of the model
//   fills the 132 SMs.
// * One warp per 16 query rows (N padded to 16 kNT rows; 9 warps at N 144).
//   mma.sync m16n8k16 (bf16 in, f32 sums) tiles 144 = 9 x 16 exactly, where
//   wgmma's 64-row tiles would pad it to 192. A warp's whole score row (144
//   keys) stays in its fragments, so the softmax needs no online rescaling:
//   the row max and sum are reduced over the 4 lanes of a quad by shuffles.
// * q, k, v (and dO) of the next image are loaded with 16-byte cp.async
//   into a second shared-memory stage while the current image computes
//   (the backward at d 64 has room for one stage alone); rows past N are
//   zero-filled. Tiles are padded by 8 elements a row, so
//   ldmatrix (plain and .trans) reads them without bank conflicts.
// * Scores, softmax and the row sums are f32; the scores are taken in log2
//   units (scale and bias times log2 e) for ex2. P is rounded to bf16 for
//   P.v; the output is divided by the f32 row sum and rounded once to bf16.
//   The forward saves one f32 log2-sum-exp a row for the backward.
// * Backward, per image: each warp recomputes its rows of P from the saved
//   log-sum-exp, dP = dO.v^T, dS = P (dP - rowsum(dO o O)), in chunks of 32
//   keys; adds dS (f32) to its rows of the bias gradient, which it keeps in
//   registers across the whole chunk of images; writes P and dS as bf16 to
//   shared memory and sums dq = dS.k itself. After a barrier each warp
//   takes 16 key rows: dv = P^T.dO and dk = dS^T.q, read with ldmatrix
//   .trans. dq, dk and dv go straight into one packed (B, nW, N, 3C)
//   gradient. Each block writes its f32 bias-gradient sum once, as a
//   partial; wa_dbias_reduce adds the partials over the chunks in order
//   and rounds once to bf16: deterministic, no atomics.
// * Bytes a block moves beyond q, k, v, o, dO, dq, dk, dv: the bias (read
//   once a block in each pass), one f32 a row of log-sum-exp (written in
//   the forward, read in the backward: 1/16 of a tensor at d 32) and the
//   partials (N^2 f32 a block, read once by the reduction).
//
// Built by ops/window_attention.py with nvcc into a shared library with a
// plain C interface (loaded with ctypes). Launches go on the caller's stream
// and each entry returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#ifndef WA_N
#error "build with -DWA_N=<tokens a window> -DWA_D=<head width>"
#endif
#ifndef WA_D
#error "build with -DWA_N=<tokens a window> -DWA_D=<head width>"
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int kN = WA_N;                 // tokens a window
constexpr int kD = WA_D;                 // head width
constexpr int kNT = (kN + 15) / 16;      // 16-row tiles, one warp each
constexpr int kNP = 16 * kNT;            // tokens padded to the tiles
constexpr int kThreads = 32 * kNT;
constexpr int kTS = kD + 8;              // row stride of a (kNP, d) tile
constexpr int kPS = kNP + 8;             // row stride of a (kNP, kNP) tile
constexpr int kTile = kNP * kTS;         // elements of a (kNP, d) tile
constexpr int kSq = kNP * kPS;           // elements of a (kNP, kNP) tile
constexpr int kMaxSmem = 232448;         // a block's shared memory, H100
// 16-key steps a backward chunk: on an H100, 2 halved the backward's
// spills against 3 and ran its three larger Swin-L stage shapes 2-5%
// faster
constexpr int kKeyChunk = 2;

static_assert(kD == 16 || kD == 32 || kD == 64, "head width 16, 32 or 64");
static_assert(kN >= 1 && kN <= 144, "1 to 144 tokens a window");

// a third stage ran no faster at Swin-L's stage shapes on an H100
constexpr int kFwdStages = 2;
constexpr int kFwdSmem = kFwdStages * 3 * kTile * 2;
constexpr int kBwdStageBytes = 4 * kTile * 2;
constexpr int kBwdSqBytes = 3 * kSq * 2;
// two stages where they fit beside the bias, P and dS (d 16 and 32 at
// N 144), one where they do not (d 64)
constexpr int kBwdStages =
    2 * kBwdStageBytes + kBwdSqBytes <= kMaxSmem ? 2 : 1;
constexpr int kBwdSmem = kBwdStages * kBwdStageBytes + kBwdSqBytes;
static_assert(kFwdSmem <= kMaxSmem && kBwdSmem <= kMaxSmem,
              "shared memory");

constexpr float kLog2e = 1.4426950408889634f;

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a.b, m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- fragments ------------------------------------------------------------
// A lane's share of an m16n8 f32 tile: c[0], c[1] at (row g, columns 2t,
// 2t + 1), c[2], c[3] at (row g + 8, the same columns), g = lane / 4,
// t = lane % 4. Tiles in shared memory are row-major with stride `ld`.

// A operand (16 x 16) from rows r0.., columns c0.. of a row-major tile
__device__ __forceinline__ void load_a(const bf16* s, int ld, int r0, int c0,
                                       int lane, uint32_t (&a)[4]) {
  ldsm_x4(smem_addr(s + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + c0 +
                    8 * (lane >> 4)),
          a);
}

// A operand (16 x 16) of the transpose: A[m][k] = s[k0 + k][m0 + m]
__device__ __forceinline__ void load_a_t(const bf16* s, int ld, int k0,
                                         int m0, int lane, uint32_t (&a)[4]) {
  ldsm_x4_t(smem_addr(s + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 +
                      8 * ((lane >> 3) & 1)),
            a);
}

// B operands of two n8 tiles, B[k][n] = s[n0 + n][k0 + k] (the rows of s are
// B's columns: k^T, v^T): b[0], b[1] for rows n0..n0+7, b[2], b[3] for
// n0+8..n0+15
__device__ __forceinline__ void load_b_rows(const bf16* s, int ld, int n0,
                                            int k0, int lane,
                                            uint32_t (&b)[4]) {
  ldsm_x4(smem_addr(s + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 +
                    8 * ((lane >> 3) & 1)),
          b);
}

// B operands of two n8 tiles, B[k][n] = s[k0 + k][n0 + n] (v, k, dO, q as
// they lie): b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15
__device__ __forceinline__ void load_b_cols(const bf16* s, int ld, int k0,
                                            int n0, int lane,
                                            uint32_t (&b)[4]) {
  ldsm_x4_t(smem_addr(s + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                      n0 + 8 * (lane >> 4)),
            b);
}

// the A operand of keys 16 kk.. from two f32 score tiles (the C layout of
// tiles 2 kk and 2 kk + 1 is the A layout of their 16 columns)
__device__ __forceinline__ void c_to_a(const float (&lo)[4],
                                       const float (&hi)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// one (kNP, d) tile of rows at `src` (row stride `ld`) into shared memory;
// rows past N zero-filled
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long ld) {
  constexpr int kChunks = kD / 8;  // 16-byte pieces a row
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < kN;
    cp_async16(smem_addr(dst + r * kTS + 8 * c),
               src + (ok ? r : 0) * ld + 8 * c, ok);
  }
}

// The images' tiles in a ring of kStages shared-memory stages: the first
// kStages - 1 images are issued up front, and each step issues the image
// kStages - 1 ahead into the stage the last step freed, then waits for its
// own image's tiles. Every thread commits one group a step (empty past the
// chunk's end), so the wait counts stay uniform.
template <int kStages, typename Issue>
__device__ __forceinline__ void ring_start(int b0, int b1, Issue issue) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (b0 + i < b1) issue(b0 + i, i);
    cp_async_commit();
  }
}

// the stage of image b (step `it`), once its tiles are in shared memory
template <int kStages, typename Issue>
__device__ __forceinline__ int ring_step(int b, int it, int b1, Issue issue) {
  if (b + kStages - 1 < b1)
    issue(b + kStages - 1, (it + kStages - 1) % kStages);
  cp_async_commit();
  cp_async_wait<kStages - 1>();
  __syncthreads();
  return it % kStages;
}

// ---- forward --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    wa_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                  bf16* __restrict__ out, float* __restrict__ lse, int B,
                  int nW, int H, int chunk, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [stage][q, k, v]
  const int pair = blockIdx.x, w = pair / H, h = pair - w * H;
  const int b0 = blockIdx.y * chunk, b1 = min(B, b0 + chunk);
  if (b0 >= b1) return;
  const int C = H * kD;
  const long ld = 3L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {16 * warp + g, 16 * warp + g + 8};

  auto issue = [&](int b, int stage) {
    const bf16* src = qkv + (long)(b * nW + w) * kN * ld + h * kD;
    bf16* dst = tiles + stage * 3 * kTile;
#pragma unroll
    for (int which = 0; which < 3; ++which)
      load_tile(dst + which * kTile, src + which * C, ld);
  };
  ring_start<kFwdStages>(b0, b1, issue);

  // this warp's rows of the pair's bias, bf16 pairs as the score tiles lie
  // (read while the first images' tiles load)
  uint32_t bias_r[2 * kNT][2];
  const bf16* bp = bias + (long)pair * kN * kN;
#pragma unroll
  for (int nt = 0; nt < 2 * kNT; ++nt) {
    const int col = 8 * nt + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rows[hr];
      if (kN % 2 == 0) {
        bias_r[nt][hr] = r < kN && col < kN
            ? __ldg(reinterpret_cast<const unsigned int*>(bp + r * kN + col))
            : 0u;
      } else {
        const float lo = r < kN && col < kN
                             ? __bfloat162float(bp[r * kN + col])
                             : 0.f;
        const float hi = r < kN && col + 1 < kN
                             ? __bfloat162float(bp[r * kN + col + 1])
                             : 0.f;
        bias_r[nt][hr] = pack(lo, hi);
      }
    }
  }
  for (int b = b0, it = 0; b < b1; ++b, ++it) {
    const int stage = ring_step<kFwdStages>(b, it, b1, issue);
    const bf16* Qs = tiles + stage * 3 * kTile;
    const bf16* Ks = Qs + kTile;
    const bf16* Vs = Ks + kTile;

    uint32_t qf[kD / 16][4];
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      load_a(Qs, kTS, 16 * warp, 16 * ks, lane, qf[ks]);

    // scores of this warp's 16 rows against every key
    float s[2 * kNT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kNT; ++jp)
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        uint32_t kb[4];
        load_b_rows(Ks, kTS, 16 * jp, 16 * ks, lane, kb);
        mma(s[2 * jp], qf[ks], kb[0], kb[1]);
        mma(s[2 * jp + 1], qf[ks], kb[2], kb[3]);
      }

    // softmax in log2 units; the whole row lies in the quad's fragments
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2 * kNT; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 bb = unpack(bias_r[nt][hr]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = fmaf(s[nt][2 * hr + k], scale_log2,
                         (k ? bb.y : bb.x) * kLog2e);
          if (kNP != kN && 8 * nt + 2 * t + k >= kN) v = -INFINITY;
          s[nt][2 * hr + k] = v;
          m[hr] = fmaxf(m[hr], v);
        }
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) m[hr] = quad_max(m[hr]);
#pragma unroll
    for (int nt = 0; nt < 2 * kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = quad_sum(l[hr]);

    // o = P.v with P rounded to bf16
    float o[kD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t pa[4];
      c_to_a(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        load_b_cols(Vs, kTS, 16 * kk, 16 * dp, lane, vb);
        mma(o[2 * dp], pa, vb[0], vb[1]);
        mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }

    bf16* ob = out + (long)(b * nW + w) * kN * C + h * kD;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rows[hr];
      if (r < kN) {
        const float inv = 1.f / l[hr];
#pragma unroll
        for (int dn = 0; dn < kD / 8; ++dn)
          *reinterpret_cast<uint32_t*>(ob + (long)r * C + 8 * dn + 2 * t) =
              pack(o[dn][2 * hr] * inv, o[dn][2 * hr + 1] * inv);
        if (lse != nullptr && t == 0)
          lse[((long)b * gridDim.x + pair) * kN + r] = m[hr] + log2f(l[hr]);
      }
    }
    __syncthreads();  // this stage is free for the ring's next issue
  }
}

// ---- backward -------------------------------------------------------------

// this thread's two rows of o (columns t d/4 .. (t+1) d/4) and their
// log2-sum-exp; rows past N read 0 and +inf (so P is 0 there)
struct RowState {
  uint32_t o[2][kD / 8];
  float lse[2];
};

__device__ __forceinline__ void load_rows(RowState& st, const bf16* out,
                                          const float* lse, long o_off,
                                          long lse_off, int C,
                                          const int (&rows)[2], int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = rows[hr];
    const bool ok = r < kN;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        out + o_off + (long)(ok ? r : 0) * C + t * (kD / 4));
#pragma unroll
    for (int e = 0; e < kD / 8; ++e) st.o[hr][e] = ok ? __ldg(src + e) : 0u;
    st.lse[hr] = ok ? __ldg(lse + lse_off + r) : INFINITY;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    wa_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                  const bf16* __restrict__ out, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, bf16* __restrict__ dqkv,
                  float* __restrict__ dbias_part, int B, int nW, int H,
                  int chunk, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bias_s = reinterpret_cast<bf16*>(smem);
  bf16* P_s = bias_s + kSq;
  bf16* dS_s = P_s + kSq;
  bf16* tiles = dS_s + kSq;  // [stage][q, k, v, dO]
  const int pair = blockIdx.x, w = pair / H, h = pair - w * H;
  const int b0 = blockIdx.y * chunk, b1 = min(B, b0 + chunk);
  if (b0 >= b1) return;
  const int C = H * kD;
  const long ld = 3L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {16 * warp + g, 16 * warp + g + 8};

  // the pair's bias, zeros past N: with 16-byte copies in the first
  // image's group where its rows allow them, else element by element
  const bf16* bp = bias + (long)pair * kN * kN;
  if (kN % 8 == 0) {
    for (int i = threadIdx.x; i < kNP * (kNP / 8); i += kThreads) {
      const int r = i / (kNP / 8), c = 8 * (i % (kNP / 8));
      const bool ok = r < kN && c < kN;
      cp_async16(smem_addr(bias_s + r * kPS + c),
                 bp + (ok ? r * kN + c : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < kNP * kNP; i += kThreads) {
      const int r = i / kNP, c = i % kNP;
      bias_s[r * kPS + c] =
          r < kN && c < kN ? bp[r * kN + c] : __float2bfloat16_rn(0.f);
    }
  }

  auto issue = [&](int b, int stage) {
    const long tok = (long)(b * nW + w) * kN;
    const bf16* src = qkv + tok * ld + h * kD;
    bf16* dst = tiles + stage * 4 * kTile;
#pragma unroll
    for (int which = 0; which < 3; ++which)
      load_tile(dst + which * kTile, src + which * C, ld);
    load_tile(dst + 3 * kTile, dout + tok * C + h * kD, C);
  };
  auto offsets = [&](int b, long& o_off, long& lse_off) {
    o_off = (long)(b * nW + w) * kN * C + h * kD;
    lse_off = ((long)b * gridDim.x + pair) * kN;
  };

  // the bias gradient of this warp's rows, summed over the chunk's images
  float dbias[2 * kNT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbias[nt][e] = 0.f;

  RowState cur, nxt;
  {
    long o_off, lse_off;
    offsets(b0, o_off, lse_off);
    load_rows(cur, out, lse, o_off, lse_off, C, rows, t);
  }
  ring_start<kBwdStages>(b0, b1, issue);
  for (int b = b0, it = 0; b < b1; ++b, ++it) {
    if (b + 1 < b1) {
      long o_off, lse_off;
      offsets(b + 1, o_off, lse_off);
      load_rows(nxt, out, lse, o_off, lse_off, C, rows, t);
    }
    const int stage = ring_step<kBwdStages>(b, it, b1, issue);
    const bf16* Qs = tiles + stage * 4 * kTile;
    const bf16* Ks = Qs + kTile;
    const bf16* Vs = Ks + kTile;
    const bf16* dOs = Vs + kTile;

    // rowsum(dO o O) of this thread's two rows
    float drow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const uint32_t* d = reinterpret_cast<const uint32_t*>(
          dOs + rows[hr] * kTS + t * (kD / 4));
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < kD / 8; ++e) {
        const float2 x = unpack(d[e]), y = unpack(cur.o[hr][e]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
      drow[hr] = quad_sum(acc);
    }

    uint32_t qf[kD / 16][4], df[kD / 16][4];
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      load_a(Qs, kTS, 16 * warp, 16 * ks, lane, qf[ks]);
      load_a(dOs, kTS, 16 * warp, 16 * ks, lane, df[ks]);
    }
    float dq[kD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[dn][e] = 0.f;

    // the keys in chunks of 16 kKeyChunk: P, dP, dS of this warp's rows
#pragma unroll
    for (int c0 = 0; c0 < kNT; c0 += kKeyChunk) {
      float s[2 * kKeyChunk][4], dp[2 * kKeyChunk][4];
#pragma unroll
      for (int n = 0; n < 2 * kKeyChunk; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeyChunk; ++kk) {
        if (c0 + kk >= kNT) break;
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks) {
          uint32_t kb[4], vb[4];
          load_b_rows(Ks, kTS, 16 * (c0 + kk), 16 * ks, lane, kb);
          mma(s[2 * kk], qf[ks], kb[0], kb[1]);
          mma(s[2 * kk + 1], qf[ks], kb[2], kb[3]);
          load_b_rows(Vs, kTS, 16 * (c0 + kk), 16 * ks, lane, vb);
          mma(dp[2 * kk], df[ks], vb[0], vb[1]);
          mma(dp[2 * kk + 1], df[ks], vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * kKeyChunk; ++n) {
        if (c0 + n / 2 >= kNT) break;
        const int col = 16 * c0 + 8 * n + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rows[hr];
          const float2 bb = unpack(
              *reinterpret_cast<const uint32_t*>(bias_s + r * kPS + col));
          float pr[2], dsr[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float v = fmaf(s[n][2 * hr + k], scale_log2,
                           fmaf(k ? bb.y : bb.x, kLog2e, -cur.lse[hr]));
            if (kNP != kN && col + k >= kN) v = -INFINITY;
            const float p = ex2(v);
            const float ds = p * (dp[n][2 * hr + k] - drow[hr]);
            dbias[2 * c0 + n][2 * hr + k] += ds;
            pr[k] = p;
            dsr[k] = ds;
            dp[n][2 * hr + k] = ds;
          }
          *reinterpret_cast<uint32_t*>(P_s + r * kPS + col) =
              pack(pr[0], pr[1]);
          *reinterpret_cast<uint32_t*>(dS_s + r * kPS + col) =
              pack(dsr[0], dsr[1]);
        }
      }
      // dq += dS.k over this chunk's keys
#pragma unroll
      for (int kk = 0; kk < kKeyChunk; ++kk) {
        if (c0 + kk >= kNT) break;
        uint32_t sa[4];
        c_to_a(dp[2 * kk], dp[2 * kk + 1], sa);
#pragma unroll
        for (int dn = 0; dn < kD / 16; ++dn) {
          uint32_t kb[4];
          load_b_cols(Ks, kTS, 16 * (c0 + kk), 16 * dn, lane, kb);
          mma(dq[2 * dn], sa, kb[0], kb[1]);
          mma(dq[2 * dn + 1], sa, kb[2], kb[3]);
        }
      }
    }

    const long tok = (long)(b * nW + w) * kN;
    bf16* gq = dqkv + tok * ld + h * kD;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rows[hr];
      if (r < kN)
#pragma unroll
        for (int dn = 0; dn < kD / 8; ++dn)
          *reinterpret_cast<uint32_t*>(gq + r * ld + 8 * dn + 2 * t) =
              pack(dq[dn][2 * hr] * scale, dq[dn][2 * hr + 1] * scale);
    }
    __syncthreads();  // P and dS of every row are in shared memory

    // this warp's 16 keys: dv = P^T.dO, dk = dS^T.q
    float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kNT; ++ks) {
      uint32_t pa[4], sa[4];
      load_a_t(P_s, kPS, 16 * ks, 16 * warp, lane, pa);
      load_a_t(dS_s, kPS, 16 * ks, 16 * warp, lane, sa);
#pragma unroll
      for (int dn = 0; dn < kD / 16; ++dn) {
        uint32_t ob[4], qb[4];
        load_b_cols(dOs, kTS, 16 * ks, 16 * dn, lane, ob);
        mma(dv[2 * dn], pa, ob[0], ob[1]);
        mma(dv[2 * dn + 1], pa, ob[2], ob[3]);
        load_b_cols(Qs, kTS, 16 * ks, 16 * dn, lane, qb);
        mma(dk[2 * dn], sa, qb[0], qb[1]);
        mma(dk[2 * dn + 1], sa, qb[2], qb[3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rows[hr];
      if (r < kN)
#pragma unroll
        for (int dn = 0; dn < kD / 8; ++dn) {
          bf16* dst = gq + r * ld + 8 * dn + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + C) =
              pack(dk[dn][2 * hr] * scale, dk[dn][2 * hr + 1] * scale);
          *reinterpret_cast<uint32_t*>(dst + 2 * C) =
              pack(dv[dn][2 * hr], dv[dn][2 * hr + 1]);
        }
    }
    if (b + 1 < b1) cur = nxt;
    __syncthreads();  // P, dS and this stage are free for the next image
  }

  if (dbias_part != nullptr) {
    float* dst = dbias_part + ((long)blockIdx.y * gridDim.x + pair) * kN * kN;
#pragma unroll
    for (int nt = 0; nt < 2 * kNT; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int r = rows[hr], col = 8 * nt + 2 * t + k;
          if (r < kN && col < kN) dst[r * kN + col] = dbias[nt][2 * hr + k];
        }
  }
}

// dbias[i] = bf16(sum over the chunks c, in order, of part[c][i])
__global__ void wa_dbias_reduce(const float* __restrict__ part,
                                bf16* __restrict__ dbias, long n,
                                int chunks) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[c * n + i];
  dbias[i] = __float2bfloat16_rn(acc);
}

}  // namespace

extern "C" {

// blocks of the forward (backward = 0) or the backward kernel one SM of the
// current device holds at once; a negative cudaError_t on failure
int wa_blocks_per_sm(int backward) {
  cudaError_t e;
  int n = 0;
  if (backward) {
    e = cudaFuncSetAttribute(wa_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBwdSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wa_bwd_kernel,
                                                        kThreads, kBwdSmem);
  } else {
    e = cudaFuncSetAttribute(wa_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFwdSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wa_fwd_kernel,
                                                        kThreads, kFwdSmem);
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// out (B, nW, N, C) and, where lse is not null, lse (B, nW H, N) f32 from
// qkv (B, nW, N, 3C) and bias (1, nW H, N, N); blocks of `chunk` images,
// `chunks` of them
int wa_forward(const void* qkv, const void* bias, void* out, float* lse,
               int B, int nW, int H, int chunk, int chunks, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      wa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (e != cudaSuccess) return e;
  const float scale_log2 = static_cast<float>(kLog2e / sqrt((double)kD));
  wa_fwd_kernel<<<dim3(nW * H, chunks), kThreads, kFwdSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), lse, B, nW, H, chunk, scale_log2);
  return cudaGetLastError();
}

// dqkv (B, nW, N, 3C) and, where dbias is not null, dbias (1, nW H, N, N),
// summed over the images through dbias_part (chunks, nW H, N, N) f32
int wa_backward(const void* qkv, const void* bias, const void* out,
                const void* dout, const float* lse, void* dqkv,
                float* dbias_part, void* dbias, int B, int nW, int H,
                int chunk, int chunks, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      wa_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (e != cudaSuccess) return e;
  const double scale = 1.0 / sqrt((double)kD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wa_bwd_kernel<<<dim3(nW * H, chunks), kThreads, kBwdSmem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dqkv), dbias != nullptr ? dbias_part : nullptr, B,
      nW, H, chunk, static_cast<float>(scale),
      static_cast<float>(scale * kLog2e));
  e = cudaGetLastError();
  if (e != cudaSuccess || dbias == nullptr) return e;
  const long n = (long)nW * H * kN * kN;
  wa_dbias_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      dbias_part, static_cast<bf16*>(dbias), n, chunks);
  return cudaGetLastError();
}

}  // extern "C"
