// Fused ConvLSTM cell for Hopper (sm_90a), float32 throughout, on the CUDA
// cores:
//   gates = conv_SAME_kxk(cat(x, h), w) + b      (gate order i, f, o, g)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g),  h' = sigmoid(o) * tanh(c')
// The (B, H, W, 4C) gate tensor never reaches device memory.
//
// Replaces: robot_aware_control_tpu/ops/pallas_kernels.py:_fused_cell_fwd
// (body _conv_lstm_kernel, wrapper fused_conv_lstm_cell) for float32 cells
// (--compute_dtype float32), and the first float32 kernel of the port, the
// CUDA-core loop that conv_lstm_cell.cu held until this one.
//
// Numerics: full float32, no TF32. The float32 path exists to agree with
// float32 references (the GPU-vs-CPU checks to 1e-4, the JAX package's
// float32 planner); TF32 keeps about three decimal digits, and a 3xTF32
// split on wgmma would change the numeric contract. So this kernel runs on
// FFMA, and each output is ONE fmaf chain in the replaced kernel's order:
// bias, then taps in row-major (dy, dx) order, then input channels 0 ..
// Cx + C - 1 (x's, then h's). Its outputs are that kernel's bits on finite
// inputs, but for the sign of an exact zero: a skipped out-of-map tap is an
// exact fmaf(0, w, acc) left out. No split-K, no atomics, no second sum of
// an output, so a batch row's result depends on that row's inputs alone
// whatever the tile shape, the launch's B or the row's place in it.
//
// Bound on an H100 at the planner's shapes (B = 100, 6x8 maps, Cx = C =
// 256): cell0 (k = 5) needs 85.6 GFLOP once the taps on the zero border are
// left out, cell1 (k = 3) 36.9: 1.28 / 0.55 ms at 67 TFLOP/s float32,
// against about 0.02 ms for their 40-70 MB at 3.35 TB/s. Operations bound
// it. The kernel multiplies 100.7 / 40.3 GFLOP for 100 batch entries (row
// taps skipped, column taps on the border kept), 104.7 / 41.9 with its
// tiles' padding to 104 entries.
//
// Design, against the four faults of the kernel it replaces:
//   1. Synchronous staging (each operand a 4-byte load behind its own
//      border test, then a store, a barrier, the products, a barrier).
//      Here the operands go global -> shared by cp.async into a ring of
//      kStages stages in dynamic shared memory: while the warps multiply
//      one k-step of 32 channels (2048 FFMA a thread between barriers),
//      the next one's copies are in flight. Two stages of 32 channels
//      measured faster than 4 of 16 (6% at k = 5, even at k = 3;
//      cell_ablation.py --f32). A copy moves 16 bytes (4 channels) where Cx, C and the pixel
//      strides are multiples of 4 and x, h, w are 16-byte aligned, 8 bytes
//      where they are even (det without robot state: 258 channels), else
//      4; the launcher picks the width (a template parameter, VEC).
//      Out-of-map columns, batch and channel tails are copies with
//      src-size 0: zeros. The width changes the copies only, never the
//      products.
//   2. A small register tile (32 sums, 5 shared loads per 32 FFMA). Here a
//      thread holds 4 pixels x 4 hidden channels x 4 gates = 64 sums. A is
//      staged pixel-major (rows of A_LD = 36 floats), read 4 channels at a
//      time as one float4 a pixel; B k-major, one float4 of 4 channels a
//      gate: 20 LDS.128 per 256 FFMA, conflict-free (a warp's pixels are
//      4 consecutive rows, 36 floats apart: distinct banks). Registers are
//      capped at 128 (4 blocks of 128 threads an SM). With the copies and
//      barriers taken out the products alone reach about 53% of the FFMA
//      peak (cell_ablation.py --f32, no_sync), which is what holds the
//      kernel back: operand fragments prefetched a step ahead, or no
//      register cap, measured slower.
//   3. Zero taps multiplied. A tile is bb batch entries x wbox columns of
//      ONE output row, so it walks only that row's in-map row taps
//      (conv_lstm_cell_f32_geom.h): at 6x8, k = 5, 24 of 30 row taps,
//      at k = 3 16 of 18. Column taps on the border are multiplied as
//      zeros. A warp-uniform column skip was not tried: it would leave out
//      15% of the products at k = 5 but needs every warp's pixels on one
//      column, which only the 128-pixel tile's thread layout allows.
//   4. An uneven grid (600 blocks, 4 or 5 an SM). Here the rows carry
//      3, 4, 5, 5, 4, 3 row taps at k = 5, blocks are ordered heaviest row
//      first, and the tile shape is chosen per launch (choose_shape):
//      128 x 32 (pixels x hidden channels, 256 threads, 2 blocks an SM)
//      where the launch fills two waves, else 64 x 32 (128 threads, 4
//      blocks an SM): at B = 100 624 tiles of 64 x 32 in place of 336 of
//      128 x 32, a tail half as long, and 104 batch entries in place of
//      112. Narrower tiles (64 x 16) at B = 16 measured slower: a lone
//      block of 2 warps on an SM issues too little.

// Weights (k, k, Cx + C, 4C) HWIO contiguous, bias (4C,), both float32.
// x, h, c and the outputs are NHWC with contiguous channels at pixel
// strides ldx, ldh, ldc and ldo (elements): a (B, H, W, C) view of a buffer
// with more channels a pixel is read in place, its extra lanes never.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_lstm_cell_f32_geom.h"

namespace {

using namespace f32cell;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// one cp.async of VEC floats; src-size 0 writes zeros and reads nothing
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * VEC : 0;
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else if constexpr (VEC == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One block computes tile blockIdx.x of g (shape S: BM pixels x NH hidden
// channels); thread (tm, tn) the pixels tm + i BM/4 (i < 4) and the hidden
// channels tn * 4 + j (j < 4) of the tile, in all four gates.
template <int S, int VEC>
__global__ void __launch_bounds__(shape_threads(S), 65536 / (shape_threads(S) * 128))
    cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ c, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ h_out,
                float* __restrict__ c_out, const Geom g, int ldx, int ldh, int ldc, int ldo) {
  constexpr int BM = shape_bm(S), NH = shape_nh(S), T = shape_threads(S);
  constexpr int TN = NH / kTH;  // threads along hidden channels
  constexpr int TM = BM / kTP;  // threads along pixels
  constexpr int B_LD = 4 * NH;
  constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;
  constexpr int A_ROW = BK / VEC;      // copies of one staged pixel row
  constexpr int B_ROW = B_LD / VEC;    // copies of one staged weight row
  constexpr int A_PER = BM * A_ROW / T;
  constexpr int B_PER = BK * B_ROW / T;
  static_assert(A_PER * T == BM * A_ROW && B_PER * T == BK * B_ROW, "copy split");
  static_assert(T % A_ROW == 0, "A copy slots keep their column");

  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [kStages][BM][A_LD]
  float* Bs = smem + kStages * A_STAGE;  // [kStages][BK][B_LD]

  // All indices fit 32 bits: the wrapper refuses tensors of 2^31 elements.
  const Tile tl = g.tile(blockIdx.x);
  const int W = g.W, Cx = g.Cx, C = g.C, k = g.k, p = g.p;
  const int Cin = Cx + C;
  const int y = tl.y;
  const int tid = threadIdx.x;
  const int tn = tid % TN, tm = tid / TN;

  // A copies: slot r moves channels a_col .. a_col + VEC - 1 of the k-step's
  // 16 for staged pixel row tid / A_ROW + r T / A_ROW: tap (dy, dx) of it
  // is pixel a_pix[r] + dy W + dx, in the map where column a_x[r] + dx - p
  // is (a_x far negative for a row past B or W)
  const int a_col = tid % A_ROW * VEC;
  int a_pix[A_PER], a_x[A_PER];
#pragma unroll
  for (int r = 0; r < A_PER; ++r) {
    int b, xc;
    const bool ok = g.pixel(tl, tid / A_ROW + r * (T / A_ROW), &b, &xc);
    a_pix[r] = (b * g.H + y - p) * W + xc - p;
    a_x[r] = ok ? xc : -(1 << 20);
  }
  // B copies: slot r moves gate columns b_col(r) .. b_col(r) + VEC - 1 of
  // weight row b_kk(r) of the k-step (b_off -1: a hidden channel past C);
  // where T is a multiple of B_ROW every slot of a thread keeps its column
  const auto b_kk = [&](int r) { return (tid + r * T) / B_ROW; };
  const auto b_col = [&](int r) { return (tid % B_ROW + r * (T % B_ROW)) % B_ROW * VEC; };
  int b_off[B_PER];
#pragma unroll
  for (int r = 0; r < B_PER; ++r) {
    const int n = tl.nt * NH + b_col(r) % NH;
    b_off[r] = n < C ? b_col(r) / NH * C + n : -1;
  }

  const int steps = g.steps(y);
  Step ld = g.step(y, 0);  // the next k-step to load
  auto load = [&](int stage) {
    float* a_s = As + stage * A_STAGE;
    const int ci = ld.c0 + a_col;
    const int shift = ld.dy * W + ld.dx;
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const bool ok = ci < Cin && static_cast<unsigned>(a_x[r] + ld.dx - p) < static_cast<unsigned>(W);
      const int pix = a_pix[r] + shift;
      const float* src = !ok ? x : ci < Cx ? x + pix * ldx + ci : h + pix * ldh + (ci - Cx);
      copy_async<VEC>(a_s + (tid / A_ROW + r * (T / A_ROW)) * A_LD + a_col, src, ok);
    }
    const int w_row = (ld.dy * k + ld.dx) * Cin + ld.c0;
    float* b_s = Bs + stage * B_STAGE;
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const int kk = b_kk(r);
      const bool ok = b_off[r] >= 0 && ld.c0 + kk < Cin;
      copy_async<VEC>(b_s + kk * B_LD + b_col(r), ok ? w + (w_row + kk) * 4 * C + b_off[r] : w, ok);
    }
    g.next(ld);
  };

  float acc[kTP][kTH][4];
#pragma unroll
  for (int j = 0; j < kTH; ++j) {
    const int n = tl.nt * NH + tn * kTH + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float bv = n < C ? bias[q * C + n] : 0.0f;
#pragma unroll
      for (int i = 0; i < kTP; ++i) acc[i][j][q] = bv;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    commit_copies();
  }
  for (int it = 0; it < steps; ++it) {
    wait_copies<kStages - 2>();  // k-step it has landed
    __syncthreads();             // ... for every thread; stage it - 1 is free
    if (it + kStages - 1 < steps) load((it + kStages - 1) % kStages);
    commit_copies();
    const float* a_s = As + (it % kStages) * A_STAGE + tm * A_LD;
    const float* b_s = Bs + (it % kStages) * B_STAGE + tn * kTH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[kTP];
#pragma unroll
      for (int i = 0; i < kTP; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_s + i * TM * A_LD + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          const float4 b = *reinterpret_cast<const float4*>(b_s + (kk + q) * B_LD + gt * NH);
#pragma unroll
          for (int i = 0; i < kTP; ++i)
#pragma unroll
            for (int j = 0; j < kTH; ++j)
              acc[i][j][gt] = fmaf(lane(a[i], q), lane(b, j), acc[i][j][gt]);
        }
    }
  }
  wait_copies<0>();

  // The LSTM update on the thread's own sums, in the replaced kernel's
  // operations; c' = gf c + gi gg is written with explicit roundings in the
  // form nvcc's contraction gave that kernel (gi gg rounded, then one fma
  // of gf and c onto it: on the card this form gave its bits, the other
  // order did not), so the bits do not hang on a compiler choice.
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    int b, xc;
    if (!g.pixel(tl, tm + i * TM, &b, &xc)) continue;
    const int pix = (b * g.H + y) * W + xc;
#pragma unroll
    for (int j = 0; j < kTH; ++j) {
      const int n = tl.nt * NH + tn * kTH + j;
      if (n >= C) continue;
      const float gi = sigmoid(acc[i][j][0]);
      const float gf = sigmoid(acc[i][j][1]);
      const float go = sigmoid(acc[i][j][2]);
      const float gg = tanhf(acc[i][j][3]);
      const float c_new = fmaf(gf, c[pix * ldc + n], __fmul_rn(gi, gg));
      h_out[pix * ldo + n] = go * tanhf(c_new);
      c_out[pix * ldo + n] = c_new;
    }
  }
}

template <int S, int VEC>
int launch(const void* x, const void* h, const void* c, const void* w, const void* b,
           void* h_out, void* c_out, const Geom& g, int ldx, int ldh, int ldc, int ldo,
           void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      cell_kernel<S, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, shape_smem(S));
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_kernel<S, VEC><<<g.tiles, shape_threads(S), shape_smem(S),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(h_out), static_cast<float*>(c_out), g,
      ldx, ldh, ldc, ldo);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_shape(int shape, const void* x, const void* h, const void* c, const void* w,
                 const void* b, void* h_out, void* c_out, const Geom& g, int ldx, int ldh,
                 int ldc, int ldo, void* stream) {
  return shape == 0 ? launch<0, VEC>(x, h, c, w, b, h_out, c_out, g, ldx, ldh, ldc, ldo, stream)
                    : launch<1, VEC>(x, h, c, w, b, h_out, c_out, g, ldx, ldh, ldc, ldo, stream);
}

template <int S>
int resident_blocks(int* out) {
  if (cudaFuncSetAttribute(cell_kernel<S, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           shape_smem(S)) != cudaSuccess)
    return 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cell_kernel<S, 4>, shape_threads(S),
                                                       shape_smem(S)) == cudaSuccess;
}

}  // namespace

// The schedule of a launch on the current device: out[0] the tile shape
// (0 or 1), out[1] its pixels and out[2] its hidden channels a tile, out[3]
// threads a block, out[4] tiles (= blocks), out[5] blocks resident on an SM,
// out[6] SMs, out[7] the multiply-adds the blocks do. Returns a cudaError_t.
extern "C" int conv_lstm_cell_f32_schedule(int B, int H, int W, int Cx, int C, int k,
                                           long long* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks[kShapes] = {};
  if (!resident_blocks<0>(&blocks[0]) || !resident_blocks<1>(&blocks[1]))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  for (int s = 0; s < kShapes; ++s)
    if (blocks[s] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int s = choose_shape(B, H, W, Cx, C, k, sms, blocks);
  const Geom g = make_geom(B, H, W, Cx, C, k, s);
  out[0] = s;
  out[1] = g.bm;
  out[2] = g.nh;
  out[3] = shape_threads(s);
  out[4] = g.tiles;
  out[5] = blocks[s];
  out[6] = sms;
  out[7] = g.macs();
  return 0;
}

// x (B, H, W, Cx), h and c (B, H, W, C) float32 at pixel strides ldx, ldh,
// ldc (elements, channels contiguous), w (k, k, Cx + C, 4C) and bias (4C,)
// float32 contiguous, outputs (B, H, W, C) float32 at pixel stride ldo;
// `shape` the tile shape (0 or 1, conv_lstm_cell_f32_schedule's choice).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv_lstm_cell_f32(const void* x, const void* h, const void* c, const void* w,
                                  const void* b, void* h_out, void* c_out, int B, int H,
                                  int W, int Cx, int C, int k, int ldx, int ldh, int ldc,
                                  int ldo, int shape, void* stream) {
  if (shape < 0 || shape >= kShapes || k < 1 || k % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H * W == 0 || C == 0) return 0;
  const Geom g = make_geom(B, H, W, Cx, C, k, shape);
  const auto aligned = [](const void* ptr, int bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  const auto fits = [&](int v) {
    return Cx % v == 0 && C % v == 0 && ldx % v == 0 && ldh % v == 0 &&
           aligned(x, 4 * v) && aligned(h, 4 * v) && aligned(w, 4 * v);
  };
  if (fits(4))
    return launch_shape<4>(shape, x, h, c, w, b, h_out, c_out, g, ldx, ldh, ldc, ldo, stream);
  if (fits(2))
    return launch_shape<2>(shape, x, h, c, w, b, h_out, c_out, g, ldx, ldh, ldc, ldo, stream);
  return launch_shape<1>(shape, x, h, c, w, b, h_out, c_out, g, ldx, ldh, ldc, ldo, stream);
}
