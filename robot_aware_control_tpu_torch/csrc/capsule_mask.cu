// Capsule robot-mask rasteriser for Hopper (sm_90a).
//
// Replaces: robot_aware_control_tpu/ops/pallas_kernels.py:capsule_mask_render
// (body _render_kernel). For each of M masks and each pixel centre
// (x + 0.5, y + 0.5) it tests the S projected capsules
// [au, av, bu, bv, ra, rb]: t = clip(((p - a) . d) / (|d|^2 + 1e-8), 0, 1),
// closest point a + t d, radius ra (1 - t) + rb t, hit when
// dist^2 <= rad^2; the mask is the union over capsules, 1.0 or 0.0.
//
// What bounds it on an H100: at the planner's shapes (M = 500 masks of
// 48x64, S = 8) it writes 6.1 MB and reads 96 KB, about 1.8 us at
// 3.35 TB/s; filling the same output with PyTorch's fill_ takes about
// 3.3 us there. Testing every pixel against every capsule is some 30
// instructions a test (the IEEE division is a sequence of them with a
// branch to its slow path) over 12.3 M tests; a capsule covers a few
// percent of the image, so the design skips tests rather than speeding
// them up. chip_smoke.py times the kernel on the planner's segments beside
// the same launch with every tile culled and with none culled.
//
// Design:
//  * One block per mask (masks on blockIdx.x). In a prologue, one thread a
//    capsule computes the capsule's constants into shared memory in the
//    plain version's operation order (dx, dy, seg_len2) and its box; one
//    __syncthreads, then nothing per capsule is recomputed per pixel.
//  * A warp renders a tile of MASK_TILE_ROWS x MASK_TILE_COLS pixels, each
//    lane 4 adjacent pixels of one row; the block's 12 warps stride over the
//    mask's tiles (2 each at 48x64; 4 blocks fit an SM, so all 500 masks
//    are resident at once). Lane i compares capsule i's box with the tile's
//    first and last pixel centres, and a ballot gives the capsules whose box
//    meets the tile; the warp does the arithmetic of those only. The loop
//    over them is uniform across the warp, so no lane diverges.
//  * A lane keeps its 4 pixels as the mask's float values and stores them
//    with one 16-byte store when w % 4 == 0 (every row then starts 16-byte
//    aligned: the wrapper allocates the output); other widths take 4-byte
//    stores in the same kernel.
//  * The file is built with -fmad=false and keeps the IEEE division, so
//    that every operation rounds as the plain PyTorch version's separate
//    kernels do: the two agree bit for bit.
//
// Why a skipped test is a miss. Let u = 2^-24 (float32's unit roundoff),
// r = max(|ra|, |rb|) and A = max(|au|, |bu|). Whatever t in [0, 1] the
// division gives (fmaxf/fminf clamp even a NaN into [0, 1]), the computed
// cx = au + t * dx lies within 5.1 u A of [min(au, bu), max(au, bu)], where
// the exact convex combination lies. Let a pixel centre px lie beyond that
// interval by more than r + 6 u r + 5.1 u A, so that |px - cx| > r (1 + 6 u)
// exactly. Rounding is monotone, so the computed ex = px - cx, ex * ex and
// dist2 = ex * ex + ey * ey >= ex * ex each lose at most one rounding:
// dist2 > r^2 (1 + 6 u)^2 (1 - u)^3 >= r^2 (1 + u)^7 (and dist2 > 0 when
// r = 0, since the margin keeps |px - cx| near a pixel). The computed
// rad = ra (1 - t) + rb t has |rad| <= r (1 + u)^3, so rad * rad <=
// r^2 (1 + u)^7 < dist2: the test fails, a miss. The same holds in v with
// ey and A = max(|av|, |bv|). The kernel grows each side of the capsule's
// box by r plus MASK_MARGIN_PX + MASK_MARGIN_REL * mag, where mag = |au| +
// |av| + |bu| + |bv| + |ra| + |rb| >= A + r. MASK_MARGIN_REL = 2^-16 =
// 256 u, so the relative term alone exceeds 6 u r + 5.1 u A plus the
// rounding of the box's own three operations (under 3 u (A + r + margin));
// the pixel of MASK_MARGIN_PX is spare. A tile is skipped only when a
// strict comparison proves every centre of it outside the box, so a centre
// on a box edge is tested. Where mag is not below MASK_MAX_MAGNITUDE =
// 2^60 (intermediates could overflow) or is not finite (a NaN or an
// infinity among the parameters), the box is the whole plane: the capsule
// is tested on every pixel, as the plain version does.
//
// The tile shape and the margin have their one home in ops/kernels.py
// (MASK_TILE, MASK_MARGIN_*), which passes them here as -D flags and
// applies the same rule in PyTorch (capsule_mask_tests_kept) for the tests.

#include <cuda_runtime.h>

#if !defined(MASK_TILE_ROWS) || !defined(MASK_TILE_COLS) ||  \
    !defined(MASK_MARGIN_PX) || !defined(MASK_MARGIN_REL) || \
    !defined(MASK_MAX_MAGNITUDE)
#error "build through robot_aware_control_tpu_torch/ops/kernels.py (-D flags)"
#endif

namespace {

constexpr int kThreads = 384;  // 12 warps: 2 tiles each at 48x64
constexpr int kPix = 4;  // adjacent pixels a lane
constexpr int kLanesPerRow = MASK_TILE_COLS / kPix;
static_assert(MASK_TILE_COLS % kPix == 0 &&
                  MASK_TILE_ROWS * kLanesPerRow == 32,
              "a tile is one warp's 32 lanes of 4 pixels");

// A capsule's constants in shared memory: 3 x 16 bytes.
struct __align__(16) Capsule {
  float4 a;    // au, av, dx, dy
  float4 r;    // seg_len2, ra, rb, unused
  float4 box;  // lo_u, hi_u, lo_v, hi_v
};

__device__ Capsule capsule_constants(const float* p) {
  const float au = p[0], av = p[1], bu = p[2], bv = p[3], ra = p[4],
              rb = p[5];
  const float dx = bu - au;
  const float dy = bv - av;
  const float seg_len2 = dx * dx + dy * dy + 1e-8f;
  const float mag = fabsf(au) + fabsf(av) + fabsf(bu) + fabsf(bv) +
                    fabsf(ra) + fabsf(rb);
  Capsule c;
  c.a = make_float4(au, av, dx, dy);
  c.r = make_float4(seg_len2, ra, rb, 0.0f);
  c.box = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  if (mag < MASK_MAX_MAGNITUDE) {  // false for NaN and infinity
    const float grow = fmaxf(fabsf(ra), fabsf(rb)) +
                       (MASK_MARGIN_PX + MASK_MARGIN_REL * mag);
    c.box = make_float4(fminf(au, bu) - grow, fmaxf(au, bu) + grow,
                        fminf(av, bv) - grow, fmaxf(av, bv) + grow);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
    capsule_mask_kernel(const float* __restrict__ segs,
                        float* __restrict__ out, int S, int H, int W) {
  extern __shared__ Capsule caps[];
  const int m = blockIdx.x;
  const float* seg_m = segs + static_cast<long long>(m) * S * 6;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    caps[s] = capsule_constants(seg_m + s * 6);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int tiles_x = (W + MASK_TILE_COLS - 1) / MASK_TILE_COLS;
  const int tiles = tiles_x * ((H + MASK_TILE_ROWS - 1) / MASK_TILE_ROWS);
  float* out_m = out + static_cast<long long>(m) * H * W;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += kThreads / 32) {
    const int y0 = tile / tiles_x * MASK_TILE_ROWS;
    const int x0 = tile % tiles_x * MASK_TILE_COLS;
    // first and last pixel centre of the tile in the image: warp-uniform
    const float x_lo = static_cast<float>(x0) + 0.5f;
    const float x_hi =
        static_cast<float>(min(x0 + MASK_TILE_COLS, W) - 1) + 0.5f;
    const float y_lo = static_cast<float>(y0) + 0.5f;
    const float y_hi =
        static_cast<float>(min(y0 + MASK_TILE_ROWS, H) - 1) + 0.5f;
    const int y = y0 + lane / kLanesPerRow;
    const int x = x0 + lane % kLanesPerRow * kPix;
    const float py = static_cast<float>(y) + 0.5f;
    float px[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) px[j] = static_cast<float>(x + j) + 0.5f;

    float acc[kPix] = {0.0f, 0.0f, 0.0f, 0.0f};  // the mask's values
    for (int s0 = 0; s0 < S; s0 += 32) {
      // lane i compares capsule s0 + i's box with the tile; the ballot
      // leaves the capsules the warp must test (a NaN edge proves nothing)
      bool meets = false;
      if (s0 + lane < S) {
        const float4 box = caps[s0 + lane].box;
        meets = !(x_hi < box.x || x_lo > box.y || y_hi < box.z ||
                  y_lo > box.w);
      }
      for (unsigned todo = __ballot_sync(0xffffffffu, meets); todo;
           todo &= todo - 1) {
        const Capsule& c = caps[s0 + __ffs(todo) - 1];
        const float4 a = c.a;
        const float4 r = c.r;
        const float qy = (py - a.y) * a.w;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          float t = ((px[j] - a.x) * a.z + qy) / r.x;
          t = fminf(fmaxf(t, 0.0f), 1.0f);
          const float ex = px[j] - (a.x + t * a.z);
          const float ey = py - (a.y + t * a.w);
          const float dist2 = ex * ex + ey * ey;
          const float rad = r.y * (1.0f - t) + r.z * t;
          if (dist2 <= rad * rad) acc[j] = 1.0f;
        }
      }
    }

    if (y < H && x < W) {
      float* row = out_m + y * W + x;
      if (W % kPix == 0) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          if (x + j < W) row[j] = acc[j];
      }
    }
  }
}

}  // namespace

// segs (M, S, 6) float32, out (M, H, W) float32, both contiguous on the
// device, out 16-byte aligned; S at most 4096 (192 KB of shared memory: past
// the default 48 KB the launch opts into more, up to Hopper's 227 KB).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int capsule_mask_render(const void* segs, void* out, int M, int S,
                                   int H, int W, void* stream) {
  if (M == 0) return 0;
  const int smem = S * static_cast<int>(sizeof(Capsule));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        capsule_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  capsule_mask_kernel<<<M, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs), static_cast<float*>(out), S, H, W);
  return static_cast<int>(cudaGetLastError());
}
