// Fused ConvLSTM cell for Hopper (sm_90a), bfloat16, on wgmma and TMA:
//   gates = conv_SAME_kxk(cat(x, h), w) + b      (float32, gate order i, f, o, g)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g),  h' = sigmoid(o) * tanh(c')
// with h' and c' written in bfloat16. The (B, H, W, 4C) gate tensor never
// reaches device memory.
//
// Replaces: robot_aware_control_tpu/ops/pallas_kernels.py:_fused_cell_fwd
// (body _conv_lstm_kernel, wrapper fused_conv_lstm_cell) for every bf16 call
// whose Cx and C are multiples of 8 with 16-byte aligned tensors (TMA's
// stride and alignment rules). conv_lstm_cell.cu keeps the other shapes.
//
// Bound on an H100 at the planner's shapes (B = 100 candidates, 6x8 maps,
// Cx = C = 256): cell0 (k = 5) needs 85.6 GFLOP once the taps on the zero
// border are left out (125.8 dense) and moves 38 MB: 0.0865 ms at 989
// TFLOP/s against 0.011 ms at 3.35 TB/s. cell1 (k = 3): 36.9 GFLOP (45.3
// dense), 0.0373 ms. Both are bound by operations.
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
//   * The halo comes from TMA. x and h are viewed as 4-D maps (C, W, H, B).
//     An M tile is the pixels of one map row y for a run of batch entries:
//     16 entries x 8 columns at W = 8 (columns are rounded up to a power of
//     two, wbox, and a row wider than 128 is cut into chunks). Tap (dy, dx)
//     of 64 channels is the box at (c0, x0 + dx - p, y + dy - p, b0); TMA
//     fills the coordinates outside the tensor with zeros, so the x border,
//     the batch tail and the channel tail need no code. x and h are read one
//     after the other along K: cat(x, h) is never built.
//   * Taps whose row y + dy - p falls outside the map are not multiplied:
//     24 of the 30 row-taps at k = 5 on 6 rows, 16 of 18 at k = 3. Column
//     taps on the border are (zeros from TMA: 6 of 40 at W = 8, k = 5), and
//     so is the batch run's padding from 100 to 112 entries. The kernel
//     multiplies 112.7 GFLOP at k = 5 and 45.1 at k = 3.
//   * Weights stay HWIO, viewed as a 2-D map (k*k*(Cx + C), 4C); each stage
//     takes one 64 x 64 box per gate at column g*C + n0, an MN-major B
//     operand. Rows of a channel chunk that run past Cx (or past the end)
//     meet zeros in A (or are zero-filled), so they add nothing.
//   * The LSTM update in registers: a block's 256 columns are [i | f | o | g]
//     of 64 hidden channels, and the wgmma accumulator repeats every 8
//     columns, so the thread holding gate i of a pixel and channel also
//     holds f, o and g at registers +32, +64, +96. c, h' and c' go straight
//     between those registers and device memory; the tile's bias is staged
//     in shared memory once, and sigmoid and tanh use the approximate
//     exponential and reciprocal (the precise ones cost 12-16 us a launch).
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
//     order. The cut is a row tap so that small launches still fill the
//     card: at B = 16 (k = 5) the launch has 48 pieces a block rank, one
//     wave on 66 clusters; at B = 100, 336 (5.1 a cluster); at B = 400,
//     1200. Halves of a tile's taps instead would leave B = 16 with 24
//     pieces (about 4x slower); whole tiles (no cut) B = 100 with 84 units
//     on 66 clusters, two waves. The price is workspace traffic: every
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
//     102 FLOP a byte (the WMMA kernel: 64): 1.10 GB per launch at k = 5,
//     0.44 GB at k = 3, against 1.32 / 0.53 GB unshared. Without the
//     sharing the operands streamed at about 7 TB/s and the products alone
//     ran a quarter faster than the kernel: it waited on L2. Sharing the
//     weights between two M tiles instead would pad the 7 batch runs to 8.
//   * Tensor maps are encoded on the host per call with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//     link flag), and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;          // output pixels of a tile (two 64-row halves)
constexpr int BN = 64;           // hidden channels of a tile (x4 gates = 256 columns)
constexpr int BK = 64;           // input channels of one tap per k-step
constexpr int kStages = 4;
// an A row is BK bf16: 128 or 64 bytes, swizzled by as much
static_assert(BK == 64 || BK == 32, "A rows must fill a 128- or 64-byte swizzle");
constexpr int kARow = BK * 2;
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kABytes = BM * BK * 2;
constexpr int kBGateBytes = BK * BN * 2;
constexpr int kStageBytes = kABytes + 4 * kBGateBytes;  // 48 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kSlotFloats = BM * 4 * BN;  // one tile's float32 partial sums
// most pieces a tile may be cut into: the finisher keeps their workspace
// slots in shared memory (make_geom bounds the clusters by it, and the host
// refuses a k above it)
constexpr int kMaxPieces = kConsumers;

// ---------------------------------------------------------------------------
// geometry and schedule (host and device)

// k-steps [s0, s1) of unit u: the j-th of the unit's n pieces, in the order
// its partial sums are added
struct Piece {
  int u, j, n, s0, s1;
};

// A cluster of two blocks computes the two hidden-channel tiles nt = 2 np
// and 2 np + 1 of one M tile: its unit of work. Each block loads half of
// the shared A tile and multicasts it to both.
struct Geom {
  int B, H, W, Cx, C, k, p;
  int wbox, bb;          // an M tile: bb batch entries x wbox columns of one row
  int half_w, half_b;    // a block's half of it: half_b entries x half_w columns,
  int half_dx, half_db;  // the second half starting half_dx columns, half_db entries on
  int n_xc, n_mb, n_np;  // column chunks, batch chunks, pairs of hidden-channel tiles
  int ncx, nch;          // k-steps a tap takes over x, and over x and h
  int units, clusters;
  long long row_work;    // work of the H * n_xc units of one (np, mb), in dealt items
  long long total;       // work of the launch's units, in dealt items

  __host__ __device__ int dy_lo(int y) const { return y < p ? p - y : 0; }
  // row taps of output row y that land inside the map
  __host__ __device__ int nv(int y) const {
    const int hi = H - 1 - y + p < k - 1 ? H - 1 - y + p : k - 1;
    return hi - dy_lo(y) + 1;
  }
  __host__ __device__ int tap_steps() const { return k * nch; }
  // The items dealt are pieces: unit u of output row y is nv(y) of them.
  __host__ __device__ long long unit_work(int y) const { return nv(y); }
  // units run in the order u = ((np * n_mb + mb) * H + y) * n_xc + xc
  __host__ __device__ long long unit_start(int u) const {
    const int xc = u % n_xc, y = u / n_xc % H, g = u / (n_xc * H);
    long long s = g * row_work;
    for (int yy = 0; yy < y; ++yy) s += unit_work(yy) * n_xc;
    return s + xc * unit_work(y);
  }
  __host__ __device__ int unit_at(long long pos) const {
    const int g = static_cast<int>(pos / row_work);
    long long rem = pos - g * row_work;
    int y = 0;
    while (rem >= unit_work(y) * n_xc) {
      rem -= unit_work(y) * n_xc;
      ++y;
    }
    return (g * H + y) * n_xc + static_cast<int>(rem / unit_work(y));
  }
  // cluster c takes the pieces [cluster_lo(c), cluster_lo(c + 1))
  __host__ __device__ long long cluster_lo(int c) const { return c * total / clusters; }
  // piece `pos` of the launch: one row tap of its unit
  __host__ __device__ Piece piece(long long pos) const {
    Piece pc;
    pc.u = unit_at(pos);
    pc.j = static_cast<int>(pos - unit_start(pc.u));
    pc.n = nv(pc.u / n_xc % H);
    pc.s0 = pc.j * tap_steps();
    pc.s1 = pc.s0 + tap_steps();
    return pc;
  }
  // workspace slot of piece jj of pc's unit in the block of rank `rank`:
  // one a piece
  __host__ __device__ long long slot(const Piece& pc, int jj, int rank) const {
    return 2 * (unit_start(pc.u) + jj) + rank;
  }
  // workspace slots a launch needs
  __host__ __device__ long long slots() const { return 2 * total; }
};

Geom make_geom(int B, int H, int W, int Cx, int C, int k, int max_clusters) {
  Geom g{};
  g.B = B; g.H = H; g.W = W; g.Cx = Cx; g.C = C; g.k = k; g.p = k / 2;
  g.wbox = 1;
  while (g.wbox < W && g.wbox < BM) g.wbox *= 2;
  g.bb = BM / g.wbox;
  if (g.bb > 1) {  // halves along the batch run
    g.half_w = g.wbox; g.half_b = g.bb / 2; g.half_dx = 0; g.half_db = g.bb / 2;
  } else {         // a 128-column row: halves along it
    g.half_w = BM / 2; g.half_b = 1; g.half_dx = BM / 2; g.half_db = 0;
  }
  g.n_xc = (W + g.wbox - 1) / g.wbox;
  g.n_mb = (B + g.bb - 1) / g.bb;
  g.n_np = ((C + BN - 1) / BN + 1) / 2;
  g.ncx = (Cx + BK - 1) / BK;
  g.nch = g.ncx + (C + BK - 1) / BK;
  g.units = g.n_np * g.n_mb * H * g.n_xc;
  g.row_work = 0;
  for (int y = 0; y < H; ++y) g.row_work += g.unit_work(y) * g.n_xc;
  g.total = g.row_work * g.n_np * g.n_mb;
  const int most = max_clusters < kMaxPieces ? max_clusters : kMaxPieces;
  g.clusters = static_cast<int>(g.total < most ? g.total : most);
  return g;
}

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

// shared-memory matrix descriptor; offsets in bytes, swizzle 128 or 64 bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(swizzle == 128 ? 1 : 2) << 62;
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

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// ---------------------------------------------------------------------------
// the kernel

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    cell_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_w,
                const __nv_bfloat16* __restrict__ c, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ c_out,
                float* __restrict__ ws, int* __restrict__ counters, const Geom g) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_arrival;
  __shared__ float s_bias[4 * BN];  // the bias of a tile's 256 columns
  __shared__ long long s_slot[kMaxPieces];  // the pieces' slots, in piece order
  // 128-byte swizzle atoms are 1024 bytes: align the stages to them
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full_bar = base + kStages * kStageBytes;
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
  const int tap_steps = g.tap_steps();

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
        const int nt = 2 * (pc.u / (g.n_xc * g.H * g.n_mb)) + rank;
        for (int s = pc.s0; s < pc.s1; ++s) {
          const int dy = g.dy_lo(y) + s / tap_steps;
          const int dx = s % tap_steps / g.nch;
          const int ch = s % g.nch;
          const int wrow = (dy * g.k + dx) * (g.Cx + g.C) +
                           (ch < g.ncx ? ch * BK : g.Cx + (ch - g.ncx) * BK);
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t fb = full_bar + 8 * stage;
          const uint32_t a = base + stage * kStageBytes;
          mbar_expect_tx(fb, kStageBytes);  // both A halves and this block's B
          tma_load_4d_both(a + rank * (kABytes / 2), ch < g.ncx ? &tm_x : &tm_h, fb,
                           (ch < g.ncx ? ch : ch - g.ncx) * BK,
                           xc * g.wbox + dx - g.p + rank * g.half_dx, y + dy - g.p,
                           mb * g.bb + rank * g.half_db);
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            tma_load_2d(a + kABytes + gate * kBGateBytes, &tm_w, fb, gate * g.C + nt * BN,
                        wrow);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
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
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (long long pos = lo; pos < hi; ++pos) {
      const Piece pc = g.piece(pos);
      const int xc = pc.u % g.n_xc, y = pc.u / g.n_xc % g.H;
      const int mb = pc.u / (g.n_xc * g.H) % g.n_mb;
      const int nt = 2 * (pc.u / (g.n_xc * g.H * g.n_mb)) + rank;
      const int t = 2 * pc.u + rank;  // this block's tile

      // Both halves multiply even where one lies wholly past the last batch
      // entry (its A is zeros): a branch around the products would make the
      // compiler serialize them.
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int s = pc.s0; s < pc.s1; ++s) {
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t a = base + stage * kStageBytes + wg * 64 * kARow;
        const uint32_t b = base + stage * kStageBytes + kABytes;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16(acc, smem_desc(a + kk * 32, 16, 8 * kARow, kARow),
                           smem_desc(b + kk * 16 * 128, kBGateBytes, 1024, 128));
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // this stage's products stay in flight; the previous stage's retire
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(acc);
        if (prev >= 0 && lane == 0) {
          mbar_arrive(empty_bar + 8 * prev);
          mbar_arrive_remote(empty_bar + 8 * prev, rank ^ 1);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (prev >= 0 && lane == 0) {
        mbar_arrive(empty_bar + 8 * prev);
        mbar_arrive_remote(empty_bar + 8 * prev, rank ^ 1);
      }

      // A tile of several pieces: the last block of its rank to arrive adds
      // them up, in piece order.
      if (pc.n > 1) {
        if (ct == 0) s_arrival = atomicAdd(&counters[2 * t], 1);
        consumer_sync();
        const bool last = s_arrival == pc.n - 1;
        consumer_sync();  // s_arrival is read before it is written again
        if (!last) {
          float4* dst = reinterpret_cast<float4*>(ws + g.slot(pc, pc.j, rank) * kSlotFloats);
#pragma unroll
          for (int q = 0; q < 32; ++q)
            __stcg(dst + q * kConsumers + ct,
                   make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
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
        // time so that their loads are in flight together
#pragma unroll
        for (int q0 = 0; q0 < 32; q0 += 8) {
          float4 sum[8];
          for (int jj = 0; jj < pc.n; ++jj) {
            const float4* src = reinterpret_cast<const float4*>(ws + s_slot[jj] * kSlotFloats);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int r = 4 * (q0 + q);
              const float4 v = jj == pc.j
                                   ? make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3])
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
          for (int q = 0; q < 8; ++q) {
            const int r = 4 * (q0 + q);
            acc[r] = sum[q].x;
            acc[r + 1] = sum[q].y;
            acc[r + 2] = sum[q].z;
            acc[r + 3] = sum[q].w;
          }
        }
      }
      {
        const int n = nt * BN + ct % BN;
        s_bias[ct] = n < g.C ? bias[ct / BN * g.C + n] : 0.0f;
      }
      consumer_sync();
      // LSTM update. Accumulator register i of a thread holds row
      // 16 * warp + lane / 4 + 8 * (i / 2 % 2) and column
      // 8 * (i / 4) + 2 * (lane % 4) + i % 2 of its warpgroup's 64 x 256
      // tile. All loads of c are issued before the arithmetic.
      long long pix[2];
      __nv_bfloat162 cv[2][8];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * hr;
        const int b = mb * g.bb + m / g.wbox;
        const int xx = xc * g.wbox + m % g.wbox;
        pix[hr] = b < g.B && xx < g.W ? (static_cast<long long>(b) * g.H + y) * g.W + xx : -1;
#pragma unroll
        for (int jg = 0; jg < 8; ++jg) {
          const int n = nt * BN + jg * 8 + 2 * (lane % 4);
          // C % 8 == 0: n + 1 < C as well
          cv[hr][jg] = pix[hr] >= 0 && n < g.C
                           ? *reinterpret_cast<const __nv_bfloat162*>(c + pix[hr] * g.C + n)
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
          const long long o = pix[hr] * g.C + n;
          *reinterpret_cast<__nv_bfloat162*>(h_out + o) = __floats2bfloat162_rn(hn[0], hn[1]);
          *reinterpret_cast<__nv_bfloat162*>(c_out + o) = __floats2bfloat162_rn(cn[0], cn[1]);
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
// the box's innermost extent (128 or 64 bytes)
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Clusters of the kernel that fit on the current device at once (one block
// an SM), after raising its shared-memory limit there; 0 on an error.
int max_clusters() {
  static int known[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (known[dev] == 0) {
    if (cudaFuncSetAttribute(cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess)
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, cell_kernel, &cfg) != cudaSuccess) return 0;
    known[dev] = n;
  }
  return known[dev];
}

}  // namespace

// The launch's schedule on the current device: out = {tiles, blocks,
// k-steps summed over the blocks (each a 128 x 256 x BK product), workspace
// slots}. The caller gives the kernel 2 * tiles zeroed int32 counters and
// slots * 32768 float32 of workspace.
extern "C" int conv_lstm_cell_sm90_schedule(int B, int H, int W, int Cx, int C, int k,
                                            long long* out) {
  const int clusters = max_clusters();
  if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Geom g = make_geom(B, H, W, Cx, C, k, clusters);
  long long row_taps = 0;
  for (int y = 0; y < H; ++y) row_taps += g.nv(y);
  out[0] = 2LL * g.units;
  out[1] = 2LL * g.clusters;
  out[2] = 2LL * row_taps * g.n_xc * g.n_np * g.n_mb * g.tap_steps();
  out[3] = g.slots();
  return 0;
}

// x (B, H, W, Cx), h and c (B, H, W, C), w (k, k, Cx + C, 4C) bf16, bias (4C,)
// float32, outputs (B, H, W, C) bf16; Cx and C multiples of 8 and x, h, w
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
extern "C" int conv_lstm_cell_sm90(const void* x, const void* h, const void* c, const void* w,
                                   const void* b, void* h_out, void* c_out, void* ws,
                                   void* counters, int B, int H, int W, int Cx, int C, int k,
                                   void* stream) {
  if (B * H * W == 0) return 0;
  if (k > kMaxPieces) return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = max_clusters();
  if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Geom g = make_geom(B, H, W, Cx, C, k, clusters);
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t e = 2;  // bytes per element
  CUtensorMap tm_x, tm_h, tm_w;
  const cuuint32_t box_a[4] = {BK, static_cast<cuuint32_t>(g.half_w), 1,
                               static_cast<cuuint32_t>(g.half_b)};
  const cuuint64_t dx[4] = {static_cast<cuuint64_t>(Cx), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t sx[3] = {Cx * e, W * Cx * e, H * W * Cx * e};
  const cuuint64_t dh[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t sh[3] = {C * e, W * C * e, H * W * C * e};
  const cuuint64_t dw[2] = {4ull * C, static_cast<cuuint64_t>(k) * k * (Cx + C)};
  const cuuint64_t sw[1] = {4ull * C * e};
  const cuuint32_t box_w[2] = {BN, BK};
  if (!encode(fn, &tm_x, x, 4, dx, sx, box_a) || !encode(fn, &tm_h, h, 4, dh, sh, box_a) ||
      !encode(fn, &tm_w, w, 2, dw, sw, box_w))
    return static_cast<int>(cudaErrorInvalidValue);
  cell_kernel<<<2 * g.clusters, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_h, tm_w, static_cast<const __nv_bfloat16*>(c), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(h_out), static_cast<__nv_bfloat16*>(c_out),
      static_cast<float*>(ws), static_cast<int*>(counters), g);
  return static_cast<int>(cudaGetLastError());
}
