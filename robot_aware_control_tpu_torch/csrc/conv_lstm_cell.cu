// Fused ConvLSTM cell for Hopper (sm_90a): one launch computes
//   gates = conv_SAME_kxk(cat(x, h), w) + b      (gate order i, f, o, g)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g),  h' = sigmoid(o) * tanh(c')
// with the gates accumulated in float32 and h', c' written in x's type.
//
// Replaces: robot_aware_control_tpu/ops/pallas_kernels.py:_fused_cell_fwd
// (body _conv_lstm_kernel, wrapper fused_conv_lstm_cell).
//
// What bounds it on an H100: at the planner's shapes (B = 100 candidates,
// 6x8 feature maps, Cx = C = 256, bf16) cell0 (k = 5) is a
// 4800 x 12800 x 1024 product, 126 GFLOP dense or 85 GFLOP once the taps
// that fall on the zero border are left out, and moves 38 MB (26 MB of it
// weights): about 86 us at 989 TFLOP/s against 11 us at 3.35 TB/s, so it
// is bound by operations, as is cell1 (k = 3, 37 GFLOP without the border).
//
// Design: an implicit-GEMM convolution. Rows are the B*H*W output pixels,
// columns one tile of hidden channels taken in all four gates, so a block
// holds i, f, o and g of the same channels and applies the LSTM update in
// its epilogue: the (B, H, W, 4C) gate tensor never reaches device memory.
// The reduction runs over k*k taps times Cx + C input channels, reading x
// and h separately with the border masked, so the padded concatenation the
// TPU wrapper builds is never materialised. Two paths:
//   * bfloat16 (the planner's): 16x16x16 bf16 tensor-core products (WMMA,
//     mma.sync underneath) with float32 sums, over 128-pixel x 128-column
//     tiles whose operands are staged through two shared-memory buffers:
//     the next tile's 16-byte global loads are in flight while the warps
//     multiply the current one. The sums go through shared memory to the
//     fused LSTM update. Still far from the bound: no wgmma, no TMA, and
//     the zero-border taps are multiplied too.
//   * float32: plain FMA loops on the CUDA cores over shared-memory tiles,
//     so that float32 cells agree with float32 references to float32
//     rounding.
// Weights arrive in HWIO order, (k, k, Cx + C, 4C) contiguous, in x's type,
// packed once at load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA loops

namespace simt {

constexpr int BM = 64;  // output pixels per block
constexpr int BN = 32;  // hidden channels per block (x4 gates = 128 columns)
constexpr int BK = 16;  // input channels of one tap per reduction step
constexpr int TM = 4;   // pixels per thread
constexpr int TN = 2;   // hidden channels per thread
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int A_PER = BK * BM / kThreads;        // A elements loaded a thread
constexpr int B_PER = BK * 4 * BN / kThreads;    // B elements loaded a thread
constexpr int A_LD = BM + 4;  // padded row: fewer bank conflicts on store

__global__ void __launch_bounds__(kThreads)
    cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ c, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ h_out,
                float* __restrict__ c_out, int M, int H, int W, int Cx, int C,
                int k) {
  __shared__ __align__(16) float As[BK][A_LD];
  __shared__ __align__(16) float Bs[BK][4 * BN];

  const int Cin = Cx + C;
  const long long C4 = 4LL * C;
  const int pad = k / 2;
  const int HW = H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tm = tid / (BN / TN);
  const int tn = tid % (BN / TN);

  float acc[TM][TN][4];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tn * TN + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float bv = n < C ? bias[g * C + n] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j][g] = bv;
    }
  }

  // The pixels whose inputs this thread stages are fixed for the whole
  // reduction: neighbouring threads take neighbouring channels of one
  // pixel, so the global loads of a warp are contiguous runs.
  int a_kk[A_PER], a_mm[A_PER], a_b[A_PER], a_y[A_PER], a_x[A_PER];
  bool a_ok[A_PER];
#pragma unroll
  for (int r = 0; r < A_PER; ++r) {
    const int e = tid + r * kThreads;
    a_kk[r] = e % BK;
    a_mm[r] = e / BK;
    const int m = m0 + a_mm[r];
    a_ok[r] = m < M;
    const int mc = a_ok[r] ? m : 0;
    a_b[r] = mc / HW;
    a_y[r] = (mc % HW) / W;
    a_x[r] = mc % W;
  }

  for (int tap = 0; tap < k * k; ++tap) {
    const int dy = tap / k - pad;
    const int dx = tap % k - pad;
    const float* w_tap = w + static_cast<long long>(tap) * Cin * C4;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
#pragma unroll
      for (int r = 0; r < A_PER; ++r) {
        const int ci = c0 + a_kk[r];
        const int yy = a_y[r] + dy;
        const int xx = a_x[r] + dx;
        float v = 0.0f;
        if (a_ok[r] && ci < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W) {
          const long long pix = (static_cast<long long>(a_b[r]) * H + yy) * W + xx;
          v = ci < Cx ? x[pix * Cx + ci] : h[pix * C + (ci - Cx)];
        }
        As[a_kk[r]][a_mm[r]] = v;
      }
#pragma unroll
      for (int r = 0; r < B_PER; ++r) {
        const int e = tid + r * kThreads;
        const int kk = e / (4 * BN);
        const int col = e % (4 * BN);
        const int g = col / BN;
        const int n = n0 + col % BN;
        const int ci = c0 + kk;
        float v = 0.0f;
        if (ci < Cin && n < C) v = w_tap[ci * C4 + g * C + n];
        Bs[kk][col] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][tm * TM]);
        const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
        float b[4][TN];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 b2 =
              *reinterpret_cast<const float2*>(&Bs[kk][g * BN + tn * TN]);
          b[g][0] = b2.x;
          b[g][1] = b2.y;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[i][j][g] = fmaf(a[i], b[g][j], acc[i][j][g]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= C) continue;
      const float gi = sigmoid(acc[i][j][0]);
      const float gf = sigmoid(acc[i][j][1]);
      const float go = sigmoid(acc[i][j][2]);
      const float gg = tanhf(acc[i][j][3]);
      const long long o = static_cast<long long>(m) * C + n;
      const float c_new = gf * c[o] + gi * gg;
      h_out[o] = go * tanhf(c_new);
      c_out[o] = c_new;
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

namespace tc {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 32;   // hidden channels per block (x4 gates = 128 columns)
constexpr int BK = 32;   // input channels of one tap per reduction step
constexpr int kThreads = 256;  // 8 warps: 4 along pixels x 2 along columns
constexpr int WM = BM / 4;     // 32 pixels a warp
constexpr int WN = 4 * BN / 2; // 64 columns a warp
constexpr int A_LD = BK + 8;      // bf16 a staged A row (16-byte rows, skewed)
constexpr int B_LD = 4 * BN + 8;  // bf16 a staged B row
constexpr int C_LD = 4 * BN + 4;  // floats a staged row of gate sums
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int A_GROUPS = BM * BK / 8 / kThreads;      // 8-value loads a thread
constexpr int B_GROUPS = BK * 4 * BN / 8 / kThreads;  // 8-value loads a thread
constexpr int kPipeBytes = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int kEpiBytes = BM * C_LD * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
static_assert(A_GROUPS * kThreads * 8 == BM * BK, "A tile split");
static_assert(B_GROUPS * kThreads * 8 == BK * 4 * BN, "B tile split");

// Eight consecutive bf16 values from `p` (raw bits), those at index >= `n`
// read as zero. `vec`: p is 16-byte aligned and n >= 8.
__device__ __forceinline__ uint4 load8(const uint16_t* p, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t u[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n) u[i / 2] |= static_cast<uint32_t>(p[i]) << (16 * (i % 2));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// vec: Cx and C are multiples of 8 and x, h, w are 16-byte aligned, so no
// 8-channel group straddles x and h or the end of a row.
__global__ void __launch_bounds__(kThreads, 2)
    cell_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ h,
                const bf16* __restrict__ c, const uint16_t* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ h_out,
                bf16* __restrict__ c_out, int M, int H, int W, int Cx, int C,
                int k, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][A_LD]  pixels x channels
  bf16* Bs = As + 2 * A_STAGE;               // [2][BK][B_LD]  channels x columns
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][C_LD], after the loop

  const int Cin = Cx + C;
  const long long C4 = 4LL * C;
  const int pad = k / 2;
  const int HW = H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int wm = (tid / 32) / 2;
  const int wn = (tid / 32) % 2;

  // A: 8 channels of one pixel a load, 4 neighbouring threads on one pixel.
  int a_row[A_GROUPS], a_ch[A_GROUPS], a_b[A_GROUPS], a_y[A_GROUPS],
      a_x[A_GROUPS];
  bool a_ok[A_GROUPS];
#pragma unroll
  for (int r = 0; r < A_GROUPS; ++r) {
    const int q = tid + r * kThreads;
    a_row[r] = q / (BK / 8);
    a_ch[r] = q % (BK / 8) * 8;
    const int m = m0 + a_row[r];
    a_ok[r] = m < M;
    const int mc = a_ok[r] ? m : 0;
    a_b[r] = mc / HW;
    a_y[r] = mc % HW / W;
    a_x[r] = mc % W;
  }
  // B: 8 channels of one gate of one weight row a load.
  int b_kk[B_GROUPS], b_col[B_GROUPS], b_n[B_GROUPS], b_off[B_GROUPS];
#pragma unroll
  for (int r = 0; r < B_GROUPS; ++r) {
    const int q = tid + r * kThreads;
    b_kk[r] = q / (4 * BN / 8);
    const int g = q % (4 * BN / 8) / (BN / 8);
    const int j = q % (BN / 8) * 8;
    b_col[r] = g * BN + j;
    b_n[r] = n0 + j;
    b_off[r] = g * C + n0 + j;
  }

  const int chunks = (Cin + BK - 1) / BK;
  const int iters = k * k * chunks;
  uint4 ra[A_GROUPS], rb[B_GROUPS];

  auto load = [&](int it) {
    const int tap = it / chunks;
    const int c0 = (it - tap * chunks) * BK;
    const int dy = tap / k - pad;
    const int dx = tap % k - pad;
#pragma unroll
    for (int r = 0; r < A_GROUPS; ++r) {
      const int ci = c0 + a_ch[r];
      const int yy = a_y[r] + dy;
      const int xx = a_x[r] + dx;
      ra[r] = make_uint4(0, 0, 0, 0);
      if (!a_ok[r] || yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const long long pix = (static_cast<long long>(a_b[r]) * H + yy) * W + xx;
      if (vec) {
        if (ci < Cx) ra[r] = load8(x + pix * Cx + ci, 8, true);
        else if (ci < Cin) ra[r] = load8(h + pix * C + (ci - Cx), 8, true);
      } else {
        uint32_t u[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int cc = ci + i;
          const uint32_t v = cc < Cx    ? x[pix * Cx + cc]
                             : cc < Cin ? h[pix * C + (cc - Cx)]
                                        : 0u;
          u[i / 2] |= v << (16 * (i % 2));
        }
        ra[r] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < B_GROUPS; ++r) {
      const int ci = c0 + b_kk[r];
      rb[r] = ci < Cin && b_n[r] < C
                  ? load8(w + (static_cast<long long>(tap) * Cin + ci) * C4 +
                              b_off[r],
                          C - b_n[r], vec)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int r = 0; r < A_GROUPS; ++r)
      *reinterpret_cast<uint4*>(As + buf * A_STAGE + a_row[r] * A_LD +
                                a_ch[r]) = ra[r];
#pragma unroll
    for (int r = 0; r < B_GROUPS; ++r)
      *reinterpret_cast<uint4*>(Bs + buf * B_STAGE + b_kk[r] * B_LD +
                                b_col[r]) = rb[r];
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  stash(0);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const bool more = it + 1 < iters;
    if (more) load(it + 1);  // global loads in flight during the products
    const bf16* a_s = As + (it & 1) * A_STAGE + wm * WM * A_LD;
    const bf16* b_s = Bs + (it & 1) * B_STAGE + wn * WN;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], a_s + i * 16 * A_LD + ks, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_s + ks * B_LD + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    if (more) stash((it + 1) & 1);  // the buffer read in iteration it - 1
    __syncthreads();
  }

  // The staging buffers are free now: the gate sums go through them.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * C_LD + wn * WN + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int row = e / BN;
    const int j = e % BN;
    const int m = m0 + row;
    const int n = n0 + j;
    if (m >= M || n >= C) continue;
    const float* g = Cs + row * C_LD + j;
    const float gi = sigmoid(g[0] + bias[n]);
    const float gf = sigmoid(g[BN] + bias[C + n]);
    const float go = sigmoid(g[2 * BN] + bias[2 * C + n]);
    const float gg = tanhf(g[3 * BN] + bias[3 * C + n]);
    const long long o = static_cast<long long>(m) * C + n;
    const float c_new = gf * __bfloat162float(c[o]) + gi * gg;
    h_out[o] = __float2bfloat16_rn(go * tanhf(c_new));
    c_out[o] = __float2bfloat16_rn(c_new);
  }
}

}  // namespace tc

}  // namespace

// x (B, H, W, Cx), h and c (B, H, W, C), w (k, k, Cx + C, 4C) in one type
// (float32 or bfloat16), bias (4C,) float32, outputs (B, H, W, C) in the
// inputs' type; all contiguous on the device. Each returns the cudaError_t
// of its launch (0 on success).
extern "C" int conv_lstm_cell_f32(const void* x, const void* h, const void* c,
                                  const void* w, const void* b, void* h_out,
                                  void* c_out, int B, int H, int W, int Cx,
                                  int C, int k, void* stream) {
  const int M = B * H * W;
  if (M == 0) return 0;
  const dim3 grid((M + simt::BM - 1) / simt::BM, (C + simt::BN - 1) / simt::BN);
  simt::cell_kernel<<<grid, simt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(h_out),
      static_cast<float*>(c_out), M, H, W, Cx, C, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv_lstm_cell_bf16(const void* x, const void* h, const void* c,
                                   const void* w, const void* b, void* h_out,
                                   void* c_out, int B, int H, int W, int Cx,
                                   int C, int k, void* stream) {
  const int M = B * H * W;
  if (M == 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      tc::cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = Cx % 8 == 0 && C % 8 == 0 && aligned(x) && aligned(h) &&
                   aligned(w);
  const dim3 grid((M + tc::BM - 1) / tc::BM, (C + tc::BN - 1) / tc::BN);
  tc::cell_kernel<<<grid, tc::kThreads, tc::kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(h),
      static_cast<const __nv_bfloat16*>(c), static_cast<const uint16_t*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(h_out),
      static_cast<__nv_bfloat16*>(c_out), M, H, W, Cx, C, k, vec);
  return static_cast<int>(cudaGetLastError());
}
