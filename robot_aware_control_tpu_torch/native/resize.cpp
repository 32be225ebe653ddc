// Bilinear image resize of the host data path (a copy of
// robot_aware_control_tpu/native/resize.cpp; reference:
// src/dataset/robonet/robonet_dataset.py:257-300 resizes every frame with
// torchvision's bilinear Resize). align_corners=False (half-pixel)
// sampling, the semantics of torchvision and cv2.
//
// Build: data/native.py compiles this with `c++ -O3 -shared -fPIC` on
// first use into robot_aware_control_tpu_torch/_build/.

#include <cstdint>
#include <algorithm>

extern "C" {

// src: (H, W, C) float32 contiguous -> dst: (h, w, C) float32
void bilinear_resize_f32(const float* src, int H, int W, int C,
                         float* dst, int h, int w) {
    const float sy = static_cast<float>(H) / h;
    const float sx = static_cast<float>(W) / w;
    for (int y = 0; y < h; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        if (fy < 0) fy = 0;
        int y0 = static_cast<int>(fy);
        int y1 = std::min(y0 + 1, H - 1);
        float wy = fy - y0;
        for (int x = 0; x < w; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            if (fx < 0) fx = 0;
            int x0 = static_cast<int>(fx);
            int x1 = std::min(x0 + 1, W - 1);
            float wx = fx - x0;
            const float* p00 = src + (y0 * W + x0) * C;
            const float* p01 = src + (y0 * W + x1) * C;
            const float* p10 = src + (y1 * W + x0) * C;
            const float* p11 = src + (y1 * W + x1) * C;
            float* out = dst + (y * w + x) * C;
            for (int c = 0; c < C; ++c) {
                float top = p00[c] * (1 - wx) + p01[c] * wx;
                float bot = p10[c] * (1 - wx) + p11[c] * wx;
                out[c] = top * (1 - wy) + bot * wy;
            }
        }
    }
}

// batched: (N, H, W, C) -> (N, h, w, C)
void bilinear_resize_batch_f32(const float* src, int N, int H, int W, int C,
                               float* dst, int h, int w) {
    const int64_t in_stride = static_cast<int64_t>(H) * W * C;
    const int64_t out_stride = static_cast<int64_t>(h) * w * C;
    for (int n = 0; n < N; ++n) {
        bilinear_resize_f32(src + n * in_stride, H, W, C,
                            dst + n * out_stride, h, w);
    }
}

}  // extern "C"
