// Fused ConvLSTM cell for Hopper (sm_90a), bfloat16, on wgmma and TMA:
//   gates = conv_SAME_kxk(cat(x, h), w) + b      (float32, gate order i, f, o, g)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g),  h' = sigmoid(o) * tanh(c')
// with h' and c' written in bfloat16. The (B, H, W, 4C) gate tensor never
// reaches device memory.
//
// Replaces: robot_aware_control_tpu/ops/pallas_kernels.py:_fused_cell_fwd
// (body _conv_lstm_kernel, wrapper fused_conv_lstm_cell) for every bf16
// call: any Cx and C, odd ones too. It takes x, h and c as NHWC with
// contiguous channels and a pixel stride that is a multiple of 8 elements
// (TMA's 16-byte strides), weights whose gate stride is a multiple of 8, on
// 16-byte aligned tensors; ops/kernels.py:stage_cell copies whatever a
// caller holds in another layout into that one first.
//
// Bound on an H100 at the planner's shapes (B = 100 candidates, 6x8 maps,
// Cx = C = 256): cell0 (k = 5) needs 85.6 GFLOP once the taps on the zero
// border are left out (125.8 dense) and moves 38 MB: 0.0865 ms at 989
// TFLOP/s against 0.011 ms at 3.35 TB/s. cell1 (k = 3): 36.9 GFLOP (45.3
// dense), 0.0373 ms. det's cells (Cx = C = 260): 88.3 / 38.1 GFLOP, 0.0892 /
// 0.0385 ms. All are bound by operations.
//
// Design, item by item:
//   * wgmma on shared-memory operands fed by TMA. One producer thread keeps
//     a ring of 4 stages (48 KB each: a 128 x 64 A tile and a 64 x 256 B
//     tile) full with cp.async.bulk.tensor loads that complete on an
//     mbarrier; two consumer warpgroups issue wgmma.mma_async m64n256k16
//     (bf16 in, float32 sums) on them and free a stage on a second
//     mbarrier once its products have retired (one stage stays in flight).
//     setmaxnreg gives the consumers 232 registers, the producer 40. No
//     barrier of the whole block in the main loop: the mbarriers hand the
//     stages over. Four stages of 64 channels measured faster than eight
//     of 32.
//   * The halo comes from TMA. x and h are viewed as 4-D maps (C, W, H, B)
//     whose pixel stride is the caller's (ldx, ldh: a (B, H, W, C) view of a
//     buffer with round_up(C, 8) channels a pixel is TMA-legal at any
//     C). An M tile is the pixels of one map row y for a run of batch
//     entries: 16 entries x 8 columns at W = 8 (columns are rounded up to a
//     power of two, wbox, and a row wider than 128 is cut into chunks). Tap
//     (dy, dx) of 64 channels is the box at (c0, x0 + dx - p, y + dy - p,
//     b0); TMA fills the coordinates outside the tensor with zeros, so the x
//     border, the batch tail and the channel tail need no code, and the
//     lanes between C and the pixel stride are never read (the map's
//     innermost extent is Cx or C, odd or not). x and h are read one after
//     the other along K: cat(x, h) is never built.
//   * Taps whose row y + dy - p falls outside the map are not multiplied:
//     24 of the 30 row-taps at k = 5 on 6 rows, 16 of 18 at k = 3. Column
//     taps on the border are (zeros from TMA: 6 of 40 at W = 8, k = 5), and
//     so is the batch run's padding from 100 to 112 entries. The kernel
//     multiplies 112.7 GFLOP at k = 5 and 45.1 at k = 3.
//   * Weights stay HWIO, viewed as a 2-D map (k*k*(Cx + C), 4 cw); each
//     stage takes one 64 x 64 box per gate at column g*cw + n0, an MN-major
//     B operand. Rows of a channel chunk that run past Cx (or past the end)
//     meet zeros in A (or are zero-filled), so they add nothing. TMA starts
//     a box only on a 16-byte boundary of its innermost dimension (a box at
//     column 260 of det's weights, byte 520, trapped the kernel), so the
//     gate stride cw is a multiple of 8: C itself where C is one (the
//     planner's 256 channels), else a copy of the weights whose gates are
//     padded with zero columns to round_up(C, 64), made once per weight
//     version by the wrapper (ops/kernels.py:sm90_weights, any C, odd ones
//     too); the parameters keep their shapes.
//   * det's tails (conv_lstm_cell_sm90_geom.h, the tail layout). At 260 =
//     4 x 64 + 4 channels, whole 64-channel tiles for the last 4 channels
//     of x, of h and of the hidden state would multiply 1.9x a 256-channel
//     cell. Instead a tap's last 4 channels of x and of h share one short
//     k-step: two 16-channel boxes under a 32-byte swizzle (TMA zero-fills
//     channels 260-271), two k16 products, in place of two 64-deep steps.
//     The last 4 hidden channels are one 8-channel column group of each
//     gate, 32 columns: an m64n32k16 product on the packed weights' tail
//     block (one 32-column box, swizzled by 64), run beside the m64n256k16
//     products by the first block of pairs 0 and 1, each for one 64-pixel
//     half of the M tile. Its 16 accumulators keep i, f, o and g of a
//     channel in one thread (registers +4, +8, +12). So a 260-channel cell
//     multiplies about 1.13x the 256-channel cell's products, not 1.9x.
//   * The LSTM update in registers: a block's 256 columns are [i | f | o | g]
//     of 64 hidden channels, and the wgmma accumulator repeats every 8
//     columns, so the thread holding gate i of a pixel and channel also
//     holds f, o and g at registers +32, +64, +96. c, h' and c' go straight
//     between those registers and device memory (at the caller's pixel
//     strides ldc and ldo), two channels a 4-byte access; where C is odd the
//     pair of its last channel is read and written as one value, so no
//     lane past C is read or written. The tile's bias is staged in shared
//     memory once, and sigmoid and tanh use the approximate exponential and
//     reciprocal (the precise ones cost 12-16 us a launch).
//   * A result that depends on the inputs alone. A pixel's gates are the
//     same bits whatever the launch's B, wherever its batch entry sits and
//     whichever block finishes its tile, so that a CEM plan does not depend
//     on the other requests planned with it (control/plan_server.py). The
//     K range of every tile is cut at fixed places, its in-map row taps:
//     a piece is one row tap dy, its k column taps times all channel chunks
//     of x and h (k * nch k-steps, 40 at k = 5 and 24 at k = 3 on 256 + 256
//     channels). Where a cut falls depends on k, Cx, C and the pixel's row
//     (which taps lie in the map), never on B or on the tile's index. Each
//     piece is summed from zero in float32, and a tile's pieces are added
//     in piece order, p0 + p1 + ... left to right, by whichever block comes
//     last, its own piece taken from its registers at its place in the
//     order. The narrow tail's columns of a pixel are always multiplied by
//     the same m64n32k16 products in the same order, whichever half of a
//     tile the pixel falls in. The cut is a row tap so that small launches
//     still fill the card: at B = 16 (k = 5) the launch has 48 pieces a
//     block rank, one wave on 66 clusters; at B = 100, 336 (5.1 a cluster);
//     at B = 400, 1200. Halves of a tile's taps instead would leave B = 16
//     with 24 pieces (about 4x slower); whole tiles (no cut) B = 100 with 84
//     units on 66 clusters, two waves. The price is workspace traffic: every
//     piece but the finisher's own leaves a 128 KB partial of each block,
//     also where one block computes a tile's pieces one after another. At
//     k = 5 that is 66 MB written and read back at B = 100, 236 MB at
//     B = 400.
//   * Filling the 132 SMs: clusters of two blocks, one block an SM. A
//     cluster's unit of work is one M tile in two neighbouring hidden-channel
//     tiles, one a block; the launch's pieces are dealt out evenly to the
//     persistent clusters, a contiguous run each. A tile cut between blocks
//     is finished by the block of its rank that arrives last: the others
//     leave float32 partials (128 KB) in a workspace slot of their own and
//     count themselves done on a per-tile counter, both allocated by the
//     caller.
//   * Traffic from L2: the two blocks of a cluster share their A tile, each
//     loading half of it and multicasting it to both (.multicast::cluster);
//     a stage is freed only when the consumers of both blocks are done with
//     it (each consumer warp arrives on its own and its peer's barrier).
//     So a block-step reads 40 KB (8 KB of A, 32 KB of B) for 4.19 MFLOP,
//     102 FLOP a byte (the retired WMMA kernel: 64): 1.10 GB per launch at k = 5,
//     0.44 GB at k = 3, against 1.32 / 0.53 GB unshared. Without the
//     sharing the operands streamed at about 7 TB/s and the products alone
//     ran a quarter faster than the kernel: it waited on L2. Sharing the
//     weights between two M tiles instead would pad the 7 batch runs to 8.
//   * No branch inside a run of asynchronous products: a piece's products
//     are one of two straight loops, with or without the narrow tail, each
//     ending in wgmma.wait_group 0, and a tap's short step follows its full
//     steps in line. (A branch around the products made the compiler
//     serialize them.)
//   * Tensor maps are encoded on the host per call with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//     link flag), and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_lstm_cell_sm90_geom.h"

namespace {

using namespace sm90;

constexpr int kStages = 4;
// an A row is BK bf16: 128 or 64 bytes, swizzled by as much
static_assert(BK == 64 || BK == 32, "A rows must fill a 128- or 64-byte swizzle");
constexpr int kARow = BK * 2;
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kABytes = BM * BK * 2;
constexpr int kBGateBytes = BK * BN * 2;
constexpr int kBBytes = 4 * kBGateBytes;
// the narrow tail's B: a 32-column box of the weights' tail block (8 columns
// of each gate), 64 rows of 64 bytes swizzled by 64
constexpr int kBtRow = 4 * kTailN * 2;
constexpr int kBtBytes = BK * kBtRow;
// a short step: x's and h's 16-channel boxes (128 rows of 32 bytes each),
// then 16 weight rows of each for every gate (2 KB a box, swizzled by 128)
// and, for the narrow tail, 16 rows of the tail block for each
constexpr int kShortABytes = BM * kTailK * 2;
constexpr int kShortBBytes = kTailK * BN * 2;
constexpr int kShortBtBytes = kTailK * kBtRow;
template <bool kTail>
__host__ __device__ constexpr int stage_bytes() {
  return kABytes + kBBytes + (kTail ? kBtBytes : 0);
}
template <bool kTail>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<kTail>() + 2 * kStages * 8 + 1024;
}
static_assert(kMaxPieces == kConsumers, "the finisher stages a piece's slot a thread");
static_assert(stage_bytes<true>() % 1024 == 0, "stages keep the 1024-byte swizzle alignment");

// ---------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// arrives on the barrier at shared address `bar` in the cluster's block
// `rank`. Release at the scope of the block, as for a local arrival: at the
// scope of the cluster the arrivals made the kernel much slower.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

// A wait that lasts this many clock cycles (seconds at the H100's clock)
// means a fault in the pipeline: the kernel traps rather than hang the card.
constexpr long long kWatchdogCycles = 20'000'000'000LL;

__device__ __forceinline__ void watchdog(long long start) {
  if (clock64() - start > kWatchdogCycles) __trap();
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    watchdog(start);
  }
}

// the box lands at `dst`, and completes on `bar`, in both blocks of the cluster
__device__ __forceinline__ void tma_load_4d_both(uint32_t dst, const CUtensorMap* map,
                                                 uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "h"(static_cast<uint16_t>(0x3)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor; offsets in bytes; swizzle 128, 64 or 32
// bytes, or 0 for none (then, MN-major, lbo steps along K by 8 rows and sbo
// along MN by 8 columns)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  const uint64_t mode = swizzle == 128 ? 1 : swizzle == 64 ? 2 : swizzle == 32 ? 3 : 0;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         mode << 62;
}

// d (64 x 256, float32) += A (64 x 16, K-major) * B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, float32) += A (64 x 16, K-major) * B (16 x 32, MN-major)
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int kN>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// sigmoid and tanh from the approximate exponential and reciprocal of the
// special function units, a few 1e-7 from the precise functions (far inside
// a bf16 rounding step) and without their branches (the precise ones cost
// 12-16 us a launch: `precise_math` in cell_ablation.py)
__device__ __forceinline__ float sigmoid(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * v));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return r;
}
__device__ __forceinline__ float tanh_fast(float v) { return 2.0f * sigmoid(2.0f * v) - 1.0f; }

// channels n and n + 1 of a pixel at p (n even, so p is 4-byte aligned);
// with !both (n + 1 == C, C odd) only channel n, the other as zero
__device__ __forceinline__ __nv_bfloat162 load_pair(const __nv_bfloat16* p, bool both) {
  return both ? *reinterpret_cast<const __nv_bfloat162*>(p)
              : __halves2bfloat162(*p, __float2bfloat16_rn(0.0f));
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b, bool both) {
  if (both)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else
    *p = __float2bfloat16_rn(a);
}

// ---------------------------------------------------------------------------
// the consumers' pieces

// The shared-memory ring as the consumers walk it.
struct Ring {
  uint32_t base, full_bar, empty_bar;
  int stage, prev;
  uint32_t phase;
};

// waits for the next stage; returns its shared address
__device__ __forceinline__ uint32_t ring_take(Ring& r, int stage_bytes) {
  mbar_wait(r.full_bar + 8 * r.stage, r.phase);
  return r.base + r.stage * stage_bytes;
}

// the previous stage's products have retired: free it in both blocks
__device__ __forceinline__ void ring_release(Ring& r, int lane, int rank) {
  if (r.prev >= 0 && lane == 0) {
    mbar_arrive(r.empty_bar + 8 * r.prev);
    mbar_arrive_remote(r.empty_bar + 8 * r.prev, rank ^ 1);
  }
  r.prev = r.stage;
  if (++r.stage == kStages) {
    r.stage = 0;
    r.phase ^= 1;
  }
}

// One piece's products into acc (and, kCarry, the narrow tail's into acct),
// summed from zero: k column taps of nch k-steps each, a tap's short step
// (kTail) after its full ones. Straight loops, all products retired at the
// end and the last stage freed.
template <bool kTail, bool kCarry>
__device__ __forceinline__ void piece_products(float* acc, float* acct, int k, int nch,
                                               Ring& r, int wg, int lane, int rank) {
  constexpr int kStage = stage_bytes<kTail>();
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  if (kCarry) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acct[i] = 0.0f;
  }
  r.prev = -1;
  const int full = nch - (kTail ? 1 : 0);
  for (int t = 0; t < k; ++t) {
    for (int ch = 0; ch < full; ++ch) {
      const uint32_t st = ring_take(r, kStage);
      const uint32_t a = st + wg * 64 * kARow;
      const uint32_t b = st + kABytes;
      fence_acc<128>(acc);
      if (kCarry) fence_acc<16>(acct);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = smem_desc(a + kk * 32, 16, 8 * kARow, kARow);
        wgmma_m64n256k16(acc, da, smem_desc(b + kk * 16 * 128, kBGateBytes, 1024, 128));
        if (kCarry)
          wgmma_m64n32k16(acct, da, smem_desc(b + kBBytes + kk * 16 * kBtRow, kBtBytes, 512, 64));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // this stage's products stay in flight; the previous stage's retire
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc<128>(acc);
      if (kCarry) fence_acc<16>(acct);
      ring_release(r, lane, rank);
    }
    if (kTail) {  // x's last 16 channels, then h's
      const uint32_t st = ring_take(r, kStage);
      const uint32_t b = st + kABytes;
      fence_acc<128>(acc);
      if (kCarry) fence_acc<16>(acct);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t da = smem_desc(st + kk * kShortABytes + wg * 64 * kTailK * 2, 16,
                                      8 * kTailK * 2, 32);
        wgmma_m64n256k16(acc, da,
                         smem_desc(b + kk * kShortBBytes, 2 * kShortBBytes, 1024, 128));
        if (kCarry)
          wgmma_m64n32k16(acct, da, smem_desc(b + kBBytes + kk * kShortBtBytes, kBtBytes, 512, 64));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc<128>(acc);
      if (kCarry) fence_acc<16>(acct);
      ring_release(r, lane, rank);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc<128>(acc);
  if (kCarry) fence_acc<16>(acct);
  if (r.prev >= 0 && lane == 0) {
    mbar_arrive(r.empty_bar + 8 * r.prev);
    mbar_arrive_remote(r.empty_bar + 8 * r.prev, rank ^ 1);
  }
}

// float4 groups [q0, q0 + kG) of registers `reg` (float4 q = reg[4q .. 4q+3])
// summed over a tile's pieces in piece order from their workspace slots, the
// piece `own` from the registers; a slot's group q sits at float4 q *
// kConsumers + ct past `off4`
template <int kG>
__device__ __forceinline__ void fold_group(float* reg, int q0, const float* ws,
                                           const long long* s_slot, int slot_floats, int n,
                                           int own, int off4, int ct) {
  float4 sum[kG];
  for (int jj = 0; jj < n; ++jj) {
    const float4* src =
        reinterpret_cast<const float4*>(ws + s_slot[jj] * slot_floats) + off4;
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int i = 4 * (q0 + q);
      const float4 v = jj == own ? make_float4(reg[i], reg[i + 1], reg[i + 2], reg[i + 3])
                                 : __ldcg(src + (q0 + q) * kConsumers + ct);
      if (jj == 0) {
        sum[q] = v;
      } else {
        sum[q].x += v.x;
        sum[q].y += v.y;
        sum[q].z += v.z;
        sum[q].w += v.w;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    const int i = 4 * (q0 + q);
    reg[i] = sum[q].x;
    reg[i + 1] = sum[q].y;
    reg[i + 2] = sum[q].z;
    reg[i + 3] = sum[q].w;
  }
}

// ---------------------------------------------------------------------------
// the kernel

template <bool kTail>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    cell_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_x16,
                const __grid_constant__ CUtensorMap tm_h16,
                const __grid_constant__ CUtensorMap tm_w16,
                const __grid_constant__ CUtensorMap tm_wt,
                const __grid_constant__ CUtensorMap tm_wt16,
                const __nv_bfloat16* __restrict__ c, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ c_out,
                float* __restrict__ ws, int* __restrict__ counters, const Geom g,
                const long long ldc, const long long ldo, const int cw, const int tcol) {
  constexpr int kStage = stage_bytes<kTail>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_arrival;
  __shared__ float s_bias[4 * BN];  // the bias of a tile's 256 columns
  __shared__ float s_bias_t[4 * kTailN];  // and of the narrow tail's 32
  __shared__ long long s_slot[kMaxPieces];  // the pieces' slots, in piece order
  // 128-byte swizzle atoms are 1024 bytes: align the stages to them
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full_bar = base + kStages * kStage;
  const uint32_t empty_bar = full_bar + kStages * 8;

  // warpgroup index through a shuffle, so that the compiler sees it is
  // uniform across the warp: wgmma in a branch it takes for divergent is
  // serialized
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      // one arrival per consumer warp of either block: a stage is free once
      // both blocks are done with it, since both write into it
      mbar_init(empty_bar + 8 * s, 2 * kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the peer's barriers are initialised before anything lands on them
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");

  int rank;  // 0 or 1 in the cluster
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int cluster = blockIdx.x / 2;
  const long long lo = g.cluster_lo(cluster);
  const long long hi = g.cluster_lo(cluster + 1);

  if (wg == kConsumers / 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long pos = lo; pos < hi; ++pos) {
        const Piece pc = g.piece(pos);
        const int xc = pc.u % g.n_xc, y = pc.u / g.n_xc % g.H;
        const int mb = pc.u / (g.n_xc * g.H) % g.n_mb;
        const int np = pc.u / (g.n_xc * g.H * g.n_mb);
        const int nt = 2 * np + rank;
        const bool carry = kTail && g.block_carries(np, rank);
        // the piece's row tap, its k column taps, nch k-steps each
        const int dy = g.dy_lo(y) + pc.j;
        const int ay = y + dy - g.p;
        const int ab = mb * g.bb + rank * g.half_db;
        for (int dx = 0; dx < g.k; ++dx) {
          const int ax = xc * g.wbox + dx - g.p + rank * g.half_dx;
          for (int ch = 0; ch < g.nch; ++ch) {
            const Step sp = g.step_at<kTail>(dy, dx, ch);
            mbar_wait(empty_bar + 8 * stage, phase ^ 1);
            const uint32_t fb = full_bar + 8 * stage;
            const uint32_t a = base + stage * kStage;
            if (sp.shrt) {
              // both A halves of both boxes and this block's B
              mbar_expect_tx(fb, 2 * kShortABytes + 8 * kShortBBytes +
                                     (carry ? 2 * kShortBtBytes : 0));
              tma_load_4d_both(a + rank * (kShortABytes / 2), &tm_x16, fb, sp.c0, ax, ay, ab);
              tma_load_4d_both(a + kShortABytes + rank * (kShortABytes / 2), &tm_h16, fb,
                               sp.c0h, ax, ay, ab);
              const int rows[2] = {sp.row, sp.row_h};
#pragma unroll
              for (int part = 0; part < 2; ++part) {
#pragma unroll
                for (int gate = 0; gate < 4; ++gate)
                  tma_load_2d(a + kABytes + gate * 2 * kShortBBytes + part * kShortBBytes,
                              &tm_w16, fb, gate * cw + nt * BN, rows[part]);
                if (carry)
                  tma_load_2d(a + kABytes + kBBytes + part * kShortBtBytes, &tm_wt16, fb, tcol,
                              rows[part]);
              }
            } else {
              mbar_expect_tx(fb, kABytes + kBBytes + (carry ? kBtBytes : 0));
              tma_load_4d_both(a + rank * (kABytes / 2), sp.part ? &tm_h : &tm_x, fb, sp.c0,
                               ax, ay, ab);
#pragma unroll
              for (int gate = 0; gate < 4; ++gate)
                tma_load_2d(a + kABytes + gate * kBGateBytes, &tm_w, fb, gate * cw + nt * BN,
                            sp.row);
              if (carry) tma_load_2d(a + kABytes + kBBytes, &tm_wt, fb, tcol, sp.row);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      // stay until both blocks' consumers have released every stage: the
      // peer's arrivals must not land on a block that has exited
      for (int i = 0; i < kStages; ++i) {
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = threadIdx.x;  // 0..255
    const int slot_floats = g.slot_floats();
    float acc[128];
    float acct[16];  // the narrow tail's [i | f | o | g] x 8 columns
    Ring ring{base, full_bar, empty_bar, 0, -1, 0};
    for (long long pos = lo; pos < hi; ++pos) {
      const Piece pc = g.piece(pos);
      const int xc = pc.u % g.n_xc, y = pc.u / g.n_xc % g.H;
      const int mb = pc.u / (g.n_xc * g.H) % g.n_mb;
      const int np = pc.u / (g.n_xc * g.H * g.n_mb);
      const int nt = 2 * np + rank;
      const int t = 2 * pc.u + rank;  // this block's tile
      // uniform in the warpgroup: whether it multiplies the narrow tail
      const bool carry = kTail && g.carries(np, rank, wg);

      // Both halves multiply even where one lies wholly past the last batch
      // entry (its A is zeros): a branch around the products would make the
      // compiler serialize them.
      if (carry)
        piece_products<kTail, kTail>(acc, acct, g.k, g.nch, ring, wg, lane, rank);
      else
        piece_products<kTail, false>(acc, acct, g.k, g.nch, ring, wg, lane, rank);

      // A tile of several pieces: the last block of its rank to arrive adds
      // them up, in piece order.
      if (pc.n > 1) {
        if (ct == 0) s_arrival = atomicAdd(&counters[2 * t], 1);
        consumer_sync();
        const bool last = s_arrival == pc.n - 1;
        consumer_sync();  // s_arrival is read before it is written again
        if (!last) {
          float4* dst = reinterpret_cast<float4*>(ws + g.slot(pc, pc.j, rank) * slot_floats);
#pragma unroll
          for (int q = 0; q < 32; ++q)
            __stcg(dst + q * kConsumers + ct,
                   make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
          if (carry) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              __stcg(dst + kSlotFloats / 4 + q * kConsumers + ct,
                     make_float4(acct[4 * q], acct[4 * q + 1], acct[4 * q + 2],
                                 acct[4 * q + 3]));
          }
          __threadfence();
          consumer_sync();
          if (ct == 0) atomicAdd(&counters[2 * t + 1], 1);
          continue;
        }
        if (ct < pc.n) s_slot[ct] = g.slot(pc, ct, rank);
        if (ct == 0) {
          const long long start = clock64();
          while (load_acquire(&counters[2 * t + 1]) < pc.n - 1) watchdog(start);
        }
        consumer_sync();
        __threadfence();
        // sum = ((p0 + p1) + p2) + ..., a group of 8 float4 registers at a
        // time so that their loads are in flight together (4 beside the
        // narrow tail's 16 accumulators)
        if (carry)
          fold_group<4>(acct, 0, ws, s_slot, slot_floats, pc.n, pc.j, kSlotFloats / 4, ct);
        constexpr int kG = kTail ? 4 : 8;
#pragma unroll
        for (int q0 = 0; q0 < 32; q0 += kG)
          fold_group<kG>(acc, q0, ws, s_slot, slot_floats, pc.n, pc.j, 0, ct);
      }
      {
        const int n = nt * BN + ct % BN;
        s_bias[ct] = n < g.C ? bias[ct / BN * g.C + n] : 0.0f;
        if (kTail && ct < 4 * kTailN) {
          const int nn = g.t0 + ct % kTailN;
          s_bias_t[ct] = nn < g.C ? bias[ct / kTailN * g.C + nn] : 0.0f;
        }
      }
      consumer_sync();
      // LSTM update. Accumulator register i of a thread holds row
      // 16 * warp + lane / 4 + 8 * (i / 2 % 2) and column
      // 8 * (i / 4) + 2 * (lane % 4) + i % 2 of its warpgroup's 64 x 256
      // (or 64 x 32) tile.
      long long pix[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * hr;
        const int b = mb * g.bb + m / g.wbox;
        const int xx = xc * g.wbox + m % g.wbox;
        pix[hr] = b < g.B && xx < g.W ? (static_cast<long long>(b) * g.H + y) * g.W + xx : -1;
      }
      if (carry) {  // the narrow tail first: gate q at registers 4 q + 2 hr + e
        const int j = 2 * (lane % 4);
        const int n = g.t0 + j;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (pix[hr] < 0 || n >= g.C) continue;
          const bool both = n + 1 < g.C;
          const float2 cf = __bfloat1622float2(load_pair(c + pix[hr] * ldc + n, both));
          float hn[2], cn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = hr * 2 + e;
            const float gi = sigmoid(acct[i] + s_bias_t[j + e]);
            const float gf = sigmoid(acct[i + 4] + s_bias_t[kTailN + j + e]);
            const float go = sigmoid(acct[i + 8] + s_bias_t[2 * kTailN + j + e]);
            const float gg = tanh_fast(acct[i + 12] + s_bias_t[3 * kTailN + j + e]);
            cn[e] = gf * (e ? cf.y : cf.x) + gi * gg;
            hn[e] = go * tanh_fast(cn[e]);
          }
          const long long o = pix[hr] * ldo + n;
          store_pair(h_out + o, hn[0], hn[1], both);
          store_pair(c_out + o, cn[0], cn[1], both);
        }
      }
      // All loads of c are issued before the arithmetic.
      __nv_bfloat162 cv[2][8];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int jg = 0; jg < 8; ++jg) {
          const int n = nt * BN + jg * 8 + 2 * (lane % 4);
          cv[hr][jg] = pix[hr] >= 0 && n < g.C ? load_pair(c + pix[hr] * ldc + n, n + 1 < g.C)
                                                : __floats2bfloat162_rn(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int jg = 0; jg < 8; ++jg) {
          const int j = jg * 8 + 2 * (lane % 4);
          const int n = nt * BN + j;
          if (pix[hr] < 0 || n >= g.C) continue;
          const float2 cf = __bfloat1622float2(cv[hr][jg]);
          float hn[2], cn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = jg * 4 + hr * 2 + e;
            const float gi = sigmoid(acc[i] + s_bias[j + e]);
            const float gf = sigmoid(acc[i + 32] + s_bias[BN + j + e]);
            const float go = sigmoid(acc[i + 64] + s_bias[2 * BN + j + e]);
            const float gg = tanh_fast(acc[i + 96] + s_bias[3 * BN + j + e]);
            cn[e] = gf * (e ? cf.y : cf.x) + gi * gg;
            hn[e] = go * tanh_fast(cn[e]);
          }
          const long long o = pix[hr] * ldo + n;
          store_pair(h_out + o, hn[0], hn[1], n + 1 < g.C);
          store_pair(c_out + o, cn[0], cn[1], n + 1 < g.C);
        }
      }
      consumer_sync();  // s_bias is read before the next tile writes it
    }
  }
}

// ---------------------------------------------------------------------------
// host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 map of `rank` dims (innermost first), zero fill; the swizzle spans
// the box's innermost extent (128, 64 or 32 bytes; none for 16)
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box[0] * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box[0] * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : box[0] * 2 == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                        : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Clusters of the kernel that fit on the current device at once (one block
// an SM), after raising its shared-memory limit there; 0 on an error.
template <bool kTail>
int max_clusters() {
  static int known[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (known[dev] == 0) {
    if (cudaFuncSetAttribute(cell_kernel<kTail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<kTail>()) != cudaSuccess)
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes<kTail>();
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, cell_kernel<kTail>, &cfg) != cudaSuccess) return 0;
    known[dev] = n;
  }
  return known[dev];
}

int max_clusters(bool tail) { return tail ? max_clusters<true>() : max_clusters<false>(); }

template <bool kTail>
void launch(const CUtensorMap& tm_x, const CUtensorMap& tm_h, const CUtensorMap& tm_w,
            const CUtensorMap& tm_x16, const CUtensorMap& tm_h16, const CUtensorMap& tm_w16,
            const CUtensorMap& tm_wt, const CUtensorMap& tm_wt16, const void* c, const void* b,
            void* h_out, void* c_out, void* ws, void* counters, const Geom& g, int ldc, int ldo,
            int cw, int tcol, void* stream) {
  cell_kernel<kTail><<<2 * g.clusters, kThreads, smem_bytes<kTail>(),
                       static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_h, tm_w, tm_x16, tm_h16, tm_w16, tm_wt, tm_wt16,
      static_cast<const __nv_bfloat16*>(c), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(h_out), static_cast<__nv_bfloat16*>(c_out),
      static_cast<float*>(ws), static_cast<int*>(counters), g, static_cast<long long>(ldc),
      static_cast<long long>(ldo), cw, tcol);
}

}  // namespace

// The launch's schedule on the current device: out = {tiles, blocks,
// k-steps summed over the blocks, workspace slots, floats a slot, the
// products' multiply-adds (tail products included), whether the cell takes
// the tail layout}. The caller gives the kernel 2 * tiles zeroed int32
// counters and slots * (floats a slot) float32 of workspace.
extern "C" int conv_lstm_cell_sm90_schedule(int B, int H, int W, int Cx, int C, int k,
                                            int tail_block, long long* out) {
  const bool tail = tail_block && takes_tail(Cx, C);
  const int clusters = max_clusters(tail);
  if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Geom g = make_geom(B, H, W, Cx, C, k, clusters, tail);
  long long row_taps = 0;
  for (int y = 0; y < H; ++y) row_taps += g.nv(y);
  // per M tile, row tap and column tap
  const long long per_tap = row_taps * g.n_xc * g.n_mb * k;
  const long long full = g.nch - g.tail, main = BM * 4LL * BN * BK;
  long long macs = 2 * g.n_np * per_tap * (full * main + g.tail * main / 2);
  if (g.tail)  // the narrow tail: 128 rows x 32 columns a tile
    macs += per_tap * BM * 4LL * kTailN * (full * BK + 2 * kTailK);
  out[0] = 2LL * g.units;
  out[1] = 2LL * g.clusters;
  out[2] = 2LL * row_taps * g.n_xc * g.n_np * g.n_mb * g.tap_steps();
  out[3] = g.slots();
  out[4] = g.slot_floats();
  out[5] = macs;
  out[6] = g.tail;
  return 0;
}

// x (B, H, W, Cx), h and c (B, H, W, C) at pixel strides ldx, ldh, ldc
// (elements, multiples of 8, channels contiguous), w (k, k, Cx + C, 4 cw)
// contiguous bf16 with gate q's columns at q cw .. q cw + C (cw a multiple
// of 8: TMA starts a box on a 16-byte boundary; cw = C where C is one, else
// the zero-padded copy of ops/kernels.py:pack_gate_weights), bias (4C,)
// float32, outputs (B, H, W, C) bf16 at pixel stride ldo (a multiple of 8);
// any Cx and C, and x, h, c, w 16-byte aligned. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int conv_lstm_cell_sm90(const void* x, const void* h, const void* c, const void* w,
                                   const void* b, void* h_out, void* c_out, void* ws,
                                   void* counters, int B, int H, int W, int Cx, int C, int k,
                                   int ldx, int ldh, int ldc, int ldo, int cw, int tcol,
                                   void* stream) {
  if (B * H * W == 0) return 0;
  if (k > kMaxPieces || ldx % 8 || ldh % 8 || ldc % 8 || ldo % 8 ||
      cw % 8 || ldx < Cx || ldh < C || ldc < C || ldo < C || cw < C ||
      (tcol >= 0 && tcol != 4 * cw))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tail = tcol >= 0 && takes_tail(Cx, C);
  const int clusters = max_clusters(tail);
  if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Geom g = make_geom(B, H, W, Cx, C, k, clusters, tail);
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t e = 2;  // bytes per element
  CUtensorMap tm_x, tm_h, tm_w, tm_x16, tm_h16, tm_w16, tm_wt, tm_wt16;
  const cuuint32_t hw = static_cast<cuuint32_t>(g.half_w), hb = static_cast<cuuint32_t>(g.half_b);
  const cuuint32_t box_a[4] = {BK, hw, 1, hb};
  const cuuint32_t box_a16[4] = {kTailK, hw, 1, hb};
  const cuuint64_t dx[4] = {static_cast<cuuint64_t>(Cx), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t sx[3] = {ldx * e, W * ldx * e, H * W * ldx * e};
  const cuuint64_t dh[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t sh[3] = {ldh * e, W * ldh * e, H * W * ldh * e};
  // the weights' columns: 4 gates of cw, then the tail block's 32
  const cuuint64_t wcols = 4ull * cw + (tcol >= 0 ? 4 * kTailN : 0);
  const cuuint64_t dw[2] = {wcols, static_cast<cuuint64_t>(k) * k * (Cx + C)};
  const cuuint64_t sw[1] = {wcols * e};
  const cuuint32_t box_w[2] = {BN, BK}, box_w16[2] = {BN, kTailK};
  const cuuint32_t box_wt[2] = {4 * kTailN, BK}, box_wt16[2] = {4 * kTailN, kTailK};
  if (!encode(fn, &tm_x, x, 4, dx, sx, box_a) || !encode(fn, &tm_h, h, 4, dh, sh, box_a) ||
      !encode(fn, &tm_w, w, 2, dw, sw, box_w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tail) {
    if (!encode(fn, &tm_x16, x, 4, dx, sx, box_a16) ||
        !encode(fn, &tm_h16, h, 4, dh, sh, box_a16) ||
        !encode(fn, &tm_w16, w, 2, dw, sw, box_w16) ||
        !encode(fn, &tm_wt, w, 2, dw, sw, box_wt) ||
        !encode(fn, &tm_wt16, w, 2, dw, sw, box_wt16))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {  // not read
    tm_x16 = tm_h16 = tm_w16 = tm_wt = tm_wt16 = tm_w;
  }
  if (tail)
    launch<true>(tm_x, tm_h, tm_w, tm_x16, tm_h16, tm_w16, tm_wt, tm_wt16, c, b, h_out, c_out, ws,
                 counters, g, ldc, ldo, cw, tcol, stream);
  else
    launch<false>(tm_x, tm_h, tm_w, tm_x16, tm_h16, tm_w16, tm_wt, tm_wt16, c, b, h_out, c_out,
                  ws, counters, g, ldc, ldo, cw, tcol, stream);
  return static_cast<int>(cudaGetLastError());
}
