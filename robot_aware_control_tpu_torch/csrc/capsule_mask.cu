// Capsule robot-mask rasteriser for Hopper (sm_90a).
//
// Replaces: robot_aware_control_tpu/ops/pallas_kernels.py:capsule_mask_render
// (body _render_kernel). For each of M masks and each pixel centre
// (x + 0.5, y + 0.5) it tests the S projected capsules
// [au, av, bu, bv, ra, rb]: t = clip(((p - a) . d) / (|d|^2 + 1e-8), 0, 1),
// closest point a + t d, radius ra (1 - t) + rb t, hit when
// dist^2 <= rad^2; the mask is the union over segments, 1.0 or 0.0.
//
// What bounds it on an H100: at the planner's shapes (M = 500 masks of
// 48x64, S = 8) it writes 6.1 MB and reads 96 KB, about 1.9 us at
// 3.35 TB/s, and does about 0.3 G float32 operations (about 4.7 us at
// 67 TFLOP/s), so it is bound by operations, one division per
// pixel-segment among them.
//
// Design: one thread per pixel and one block row (blockIdx.x) per mask.
// The block stages its mask's S x 6 parameters in shared memory once;
// every thread then reads them as broadcasts, and the distance fields
// live only in registers: the mask is written once, coalesced. The file
// is built with -fmad=false so that no multiply-add is contracted: each
// operation rounds as the plain PyTorch version's separate kernels do, and
// the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void capsule_mask_kernel(const float* __restrict__ segs,
                                    float* __restrict__ out, int S, int H,
                                    int W) {
  extern __shared__ float seg_s[];  // S * 6 parameters of this mask
  const int m = blockIdx.x;
  const float* seg_m = segs + static_cast<long long>(m) * S * 6;
  for (int i = threadIdx.x; i < S * 6; i += blockDim.x) seg_s[i] = seg_m[i];
  __syncthreads();

  const int pix = blockIdx.y * blockDim.x + threadIdx.x;
  if (pix >= H * W) return;
  const float py = static_cast<float>(pix / W) + 0.5f;
  const float px = static_cast<float>(pix % W) + 0.5f;

  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float au = seg_s[s * 6 + 0];
    const float av = seg_s[s * 6 + 1];
    const float bu = seg_s[s * 6 + 2];
    const float bv = seg_s[s * 6 + 3];
    const float ra = seg_s[s * 6 + 4];
    const float rb = seg_s[s * 6 + 5];
    const float dx = bu - au;
    const float dy = bv - av;
    const float seg_len2 = dx * dx + dy * dy + 1e-8f;
    float t = ((px - au) * dx + (py - av) * dy) / seg_len2;
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const float cx = au + t * dx;
    const float cy = av + t * dy;
    const float ex = px - cx;
    const float ey = py - cy;
    const float dist2 = ex * ex + ey * ey;
    const float rad = ra * (1.0f - t) + rb * t;
    if (dist2 <= rad * rad) acc = 1.0f;
  }
  out[static_cast<long long>(m) * H * W + pix] = acc;
}

}  // namespace

// segs (M, S, 6) float32, out (M, H, W) float32, both contiguous on the
// device. Returns the cudaError_t of the launch (0 on success).
extern "C" int capsule_mask_render(const void* segs, void* out, int M, int S,
                                   int H, int W, void* stream) {
  if (M == 0) return 0;
  const dim3 grid(M, (H * W + kThreads - 1) / kThreads);
  capsule_mask_kernel<<<grid, kThreads, S * 6 * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs), static_cast<float*>(out), S, H, W);
  return static_cast<int>(cudaGetLastError());
}
