// Walks the schedule of the float32 ConvLSTM cell on a CPU: the Geom of
// robot_aware_control_tpu_torch/csrc/conv_lstm_cell_f32_geom.h, compiled
// with g++ -D__host__= -D__device__= (tests/test_torch_port_f32_schedule.py).
//
//   f32_schedule_walk B H W Cx C k [emulate]
//
// For every tile shape, and for the shape choose_shape picks:
//   * the launch's tiles are distinct, in launch order rows with more
//     in-map row taps come first, and every (output pixel, hidden channel)
//     lies in exactly one tile;
//   * each tile's k-steps (step(), and next() as the kernel's loader walks
//     them) are exactly its row's in-map row taps, each with every column
//     tap and every BK-channel chunk of cat(x, h), in that order;
//   * emulate: a small convolution summed in the kernel's chain order
//     (float32 fmaf: bias, the tile's k-steps, zeros for out-of-map columns
//     and channels past Cx + C) equals the replaced kernel's order (bias,
//     every tap, out-of-map ones as zeros, 16-channel chunks) emulated the
//     same way, bit for bit but for the sign of a zero, and a naive float64
//     SAME convolution to 1e-5 of (1 + |value|).
// Prints one line "ok ..." and exits 0, or the first fault and exits 1.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <set>
#include <tuple>
#include <vector>

#include "conv_lstm_cell_f32_geom.h"

using namespace f32cell;

#define CHECK(cond, ...)                \
  do {                                  \
    if (!(cond)) {                      \
      std::printf("FAIL " __VA_ARGS__); \
      std::printf(" [%s]\n", #cond);    \
      std::exit(1);                     \
    }                                   \
  } while (0)

struct Case {
  int B, H, W, Cx, C, k;
  std::vector<float> x, h, w, bias;
  float in(int b, int yy, int xx, int ci) const {  // zero outside the map
    if (yy < 0 || yy >= H || xx < 0 || xx >= W || ci >= Cx + C) return 0.0f;
    const size_t pix = (static_cast<size_t>(b) * H + yy) * W + xx;
    return ci < Cx ? x[pix * Cx + ci] : h[pix * C + ci - Cx];
  }
  float wt(int dy, int dx, int ci, int col) const {  // zero past the last channel
    if (ci >= Cx + C) return 0.0f;
    return w[((static_cast<size_t>(dy) * k + dx) * (Cx + C) + ci) * 4 * C + col];
  }
};

// one shape's walk; returns the multiply-adds counted
static long long walk(const Geom& g, const Case* emu, double* max_err) {
  const int B = g.B, H = g.H, W = g.W, C = g.C, k = g.k, Cin = g.Cx + g.C;
  CHECK(g.tiles == g.per_row * H, "tiles %d", g.tiles);
  std::vector<unsigned char> cover(static_cast<size_t>(B) * H * W * C);
  std::set<std::tuple<int, int, int, int>> seen;
  int prev_nv = k + 1;
  long long macs = 0;
  for (int t = 0; t < g.tiles; ++t) {
    const Tile tl = g.tile(t);
    CHECK(tl.y >= 0 && tl.y < H && tl.mb < g.n_mb && tl.xc < g.n_xc && tl.nt < g.n_nt,
          "tile %d out of range", t);
    CHECK(seen.insert({tl.y, tl.mb, tl.xc, tl.nt}).second, "tile %d twice", t);
    CHECK(g.nv(tl.y) <= prev_nv, "tile %d: a lighter row before a heavier one", t);
    prev_nv = g.nv(tl.y);
    // its k-steps: the in-map row taps in order, every column tap, every chunk
    std::vector<int> taps;
    for (int dy = 0; dy < k; ++dy)
      if (tl.y + dy - g.p >= 0 && tl.y + dy - g.p < H) taps.push_back(dy);
    CHECK(static_cast<int>(taps.size()) == g.nv(tl.y), "row %d: nv", tl.y);
    CHECK(g.steps(tl.y) == g.nv(tl.y) * k * g.chunks, "row %d: steps", tl.y);
    Step walked = g.step(tl.y, 0);
    int s = 0;
    for (int dy : taps)
      for (int dx = 0; dx < k; ++dx)
        for (int c0 = 0; c0 < Cin; c0 += BK, ++s) {
          const Step st = g.step(tl.y, s);
          CHECK(st.dy == dy && st.dx == dx && st.c0 == c0, "row %d step %d", tl.y, s);
          CHECK(walked.dy == dy && walked.dx == dx && walked.c0 == c0,
                "row %d step %d: next() walks elsewhere", tl.y, s);
          g.next(walked);
        }
    CHECK(s == g.steps(tl.y), "row %d: %d steps walked", tl.y, s);
    macs += static_cast<long long>(s) * BK * g.bm * 4 * g.nh;
    for (int m = 0; m < g.bm; ++m) {
      int b, xx;
      if (!g.pixel(tl, m, &b, &xx)) continue;
      for (int n = tl.nt * g.nh; n < (tl.nt + 1) * g.nh && n < C; ++n) {
        unsigned char& v = cover[((static_cast<size_t>(b) * H + tl.y) * W + xx) * C + n];
        CHECK(v == 0, "pixel (%d, %d, %d) channel %d in two tiles", b, tl.y, xx, n);
        v = 1;
        if (!emu) continue;
        for (int q = 0; q < 4; ++q) {
          const int col = q * C + n;
          float got = emu->bias[col];  // the kernel's chain
          for (int st_i = 0; st_i < g.steps(tl.y); ++st_i) {
            const Step st = g.step(tl.y, st_i);
            for (int kk = 0; kk < BK; ++kk)
              got = std::fmaf(emu->in(b, tl.y + st.dy - g.p, xx + st.dx - g.p, st.c0 + kk),
                              emu->wt(st.dy, st.dx, st.c0 + kk, col), got);
          }
          float parent = emu->bias[col];  // every tap, 16-channel chunks from 0
          double want = emu->bias[col];
          for (int dy = 0; dy < k; ++dy)
            for (int dx = 0; dx < k; ++dx)
              for (int c0 = 0; c0 < Cin; c0 += 16)
                for (int kk = 0; kk < 16; ++kk) {
                  const float a = emu->in(b, tl.y + dy - g.p, xx + dx - g.p, c0 + kk);
                  const float wv = emu->wt(dy, dx, c0 + kk, col);
                  parent = std::fmaf(a, wv, parent);
                  want += static_cast<double>(a) * wv;
                }
          CHECK(got == parent, "(%d, %d, %d) column %d: %.9g, the replaced kernel's %.9g", b,
                tl.y, xx, col, got, parent);
          const double err = std::fabs(got - want);
          *max_err = err > *max_err ? err : *max_err;
          CHECK(err <= 1e-5 * (1.0 + std::fabs(want)), "(%d, %d, %d) column %d: %g vs %g", b,
                tl.y, xx, col, got, want);
        }
      }
    }
  }
  for (unsigned char v : cover) CHECK(v == 1, "an output in no tile");
  CHECK(macs == g.macs(), "macs %lld vs %lld", macs, g.macs());
  return macs;
}

int main(int argc, char** argv) {
  if (argc < 7) {
    std::printf("usage: %s B H W Cx C k [emulate]\n", argv[0]);
    return 2;
  }
  Case cs;
  cs.B = std::atoi(argv[1]); cs.H = std::atoi(argv[2]); cs.W = std::atoi(argv[3]);
  cs.Cx = std::atoi(argv[4]); cs.C = std::atoi(argv[5]); cs.k = std::atoi(argv[6]);
  const bool emulate = argc > 7;
  if (emulate) {
    unsigned state = 12345u;
    auto rnd = [&] {
      state = state * 1664525u + 1013904223u;
      return static_cast<float>(state >> 8) / (1 << 24) - 0.5f;
    };
    const size_t pixels = static_cast<size_t>(cs.B) * cs.H * cs.W;
    cs.x.resize(pixels * cs.Cx);
    cs.h.resize(pixels * cs.C);
    cs.w.resize(static_cast<size_t>(cs.k) * cs.k * (cs.Cx + cs.C) * 4 * cs.C);
    cs.bias.resize(4 * cs.C);
    for (auto* v : {&cs.x, &cs.h, &cs.w, &cs.bias})
      for (float& f : *v) f = rnd();
  }
  // an H100: 132 SMs holding 2 blocks of 128 x 32 tiles or 4 of 64 x 32
  const int blocks[kShapes] = {2, 4};
  const int chosen = choose_shape(cs.B, cs.H, cs.W, cs.Cx, cs.C, cs.k, 132, blocks);
  CHECK(chosen >= 0 && chosen < kShapes, "chose shape %d", chosen);
  double max_err = 0.0;
  long long macs[kShapes];
  for (int s = 0; s < kShapes; ++s)
    macs[s] = walk(make_geom(cs.B, cs.H, cs.W, cs.Cx, cs.C, cs.k, s), emulate ? &cs : nullptr,
                   &max_err);
  std::printf("ok chosen=%d tiles=%d macs=%lld emulated=%d max_err=%.3g\n", chosen,
              make_geom(cs.B, cs.H, cs.W, cs.Cx, cs.C, cs.k, chosen).tiles, macs[chosen],
              emulate ? 1 : 0, max_err);
  return 0;
}
