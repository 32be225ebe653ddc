// Walks the schedule of the wgmma/TMA ConvLSTM cell on a CPU: the Geom of
// robot_aware_control_tpu_torch/csrc/conv_lstm_cell_sm90_geom.h, compiled
// with g++ -D__host__= -D__device__= (tests/test_torch_port_sm90_schedule.py).
//
//   sm90_schedule_walk B H W Cx C k clusters [emulate]
//
// Checks, for the launch's pieces dealt to `clusters` persistent clusters:
//   * the clusters' runs of pieces tile [0, total) and each unit's pieces
//     are its in-map row taps, each once, in order;
//   * every k-step of every unit is taken once, and a tap's k-steps cover
//     x's channels [0, Cx) and h's [0, C) once each, with the weight rows
//     that belong to them;
//   * the hidden channels [0, C) of each 64-pixel half of an M tile are
//     computed once (by a 64-channel tile or by the narrow tail);
//   * the workspace slots of the pieces are distinct and below slots();
//   * emulate: a small convolution summed the way the kernel sums it (the
//     loads' pixels and channels, TMA's zero fill, each piece from zero,
//     pieces in order) equals a naive convolution, on a few hidden
//     channels of every tile.
// Prints one line "ok ..." and exits 0, or the first fault and exits 1.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <set>
#include <vector>

#include "conv_lstm_cell_sm90_geom.h"

using namespace sm90;

#define CHECK(cond, ...)                    \
  do {                                      \
    if (!(cond)) {                          \
      std::printf("FAIL " __VA_ARGS__);     \
      std::printf(" [%s]\n", #cond);        \
      std::exit(1);                         \
    }                                       \
  } while (0)

// k-step s of a piece of output row y (s counts from the unit's first
// piece: s / tap_steps() is the piece), as the producer's loops reach it
static Step step(const Geom& g, int s, int y) {
  const int dy = g.dy_lo(y) + s / g.tap_steps(), dx = s % g.tap_steps() / g.nch,
            ch = s % g.nch;
  return g.tail ? g.step_at<true>(dy, dx, ch) : g.step_at<false>(dy, dx, ch);
}

struct Unit {
  int xc, y, mb, np;
};

static Unit decode(const Geom& g, int u) {
  return {u % g.n_xc, u / g.n_xc % g.H, u / (g.n_xc * g.H) % g.n_mb,
          u / (g.n_xc * g.H * g.n_mb)};
}

// output pixel of row m of an M tile, as the epilogue finds it; -1 outside
static long long epilogue_pixel(const Geom& g, const Unit& t, int m) {
  const int b = t.mb * g.bb + m / g.wbox, xx = t.xc * g.wbox + m % g.wbox;
  return b < g.B && xx < g.W ? (static_cast<long long>(b) * g.H + t.y) * g.W + xx : -1;
}

// (b, column) of row m as the A loads place it: rank r's half box of
// half_b entries x half_w columns lands at rows 64 r ..
static void load_pixel(const Geom& g, const Unit& t, int m, int* b, int* xx) {
  const int r = m / 64, ml = m % 64;
  *b = t.mb * g.bb + r * g.half_db + ml / g.half_w;
  *xx = t.xc * g.wbox + r * g.half_dx + ml % g.half_w;
}

int main(int argc, char** argv) {
  if (argc < 8) {
    std::printf("usage: %s B H W Cx C k clusters [emulate]\n", argv[0]);
    return 2;
  }
  const int B = std::atoi(argv[1]), H = std::atoi(argv[2]), W = std::atoi(argv[3]);
  const int Cx = std::atoi(argv[4]), C = std::atoi(argv[5]), k = std::atoi(argv[6]);
  const int max_clusters = std::atoi(argv[7]);
  const bool emulate = argc > 8;
  const Geom g = make_geom(B, H, W, Cx, C, k, max_clusters, true);
  CHECK(g.clusters >= 1 && g.clusters <= max_clusters && g.clusters <= kMaxPieces,
        "clusters %d", g.clusters);
  CHECK(g.tail == (takes_tail(Cx, C) ? 1 : 0), "tail flag");

  // the deal: contiguous runs that tile [0, total)
  CHECK(g.cluster_lo(0) == 0 && g.cluster_lo(g.clusters) == g.total, "deal ends");
  std::vector<std::vector<int>> seen(g.units);  // piece indices in launch order
  std::set<long long> slots;
  long long steps = 0;
  for (int c = 0; c < g.clusters; ++c) {
    CHECK(g.cluster_lo(c) <= g.cluster_lo(c + 1), "cluster %d runs backwards", c);
    for (long long pos = g.cluster_lo(c); pos < g.cluster_lo(c + 1); ++pos) {
      const Piece pc = g.piece(pos);
      CHECK(pc.u >= 0 && pc.u < g.units, "piece %lld: unit %d", pos, pc.u);
      const Unit t = decode(g, pc.u);
      CHECK(pc.n == g.nv(t.y) && pc.n <= kMaxPieces && pc.j >= 0 && pc.j < pc.n,
            "piece %lld: j %d of %d", pos, pc.j, pc.n);
      CHECK(g.unit_start(pc.u) + pc.j == pos, "piece %lld: position", pos);
      CHECK(pc.s1 - pc.s0 == g.tap_steps(), "piece %lld: steps", pos);
      seen[pc.u].push_back(pc.j);
      for (int rank = 0; rank < 2; ++rank) {
        const long long s = g.slot(pc, pc.j, rank);
        CHECK(s >= 0 && s < g.slots() && slots.insert(s).second, "slot %lld", s);
      }
      // its k-steps: one in-map row tap, every column tap, every channel once
      std::vector<int> xcnt(static_cast<size_t>(k) * Cx), hcnt(static_cast<size_t>(k) * C);
      int dy0 = -1;
      for (int s = pc.s0; s < pc.s1; ++s, ++steps) {
        const Step sp = step(g, s, t.y);
        if (dy0 < 0) dy0 = sp.dy;
        CHECK(sp.dy == dy0, "piece %lld: two row taps", pos);
        CHECK(sp.dx >= 0 && sp.dx < k, "dx %d", sp.dx);
        const int tap_row = (sp.dy * k + sp.dx) * (Cx + C);
        const int parts = sp.shrt ? 2 : 1;
        for (int q = 0; q < parts; ++q) {
          const int part = sp.shrt ? q : sp.part;
          const int c0 = q ? sp.c0h : sp.c0, row = q ? sp.row_h : sp.row;
          const int n = sp.shrt ? kTailK : BK, lim = part ? C : Cx;
          CHECK(row == tap_row + (part ? Cx : 0) + c0, "weight row of step %d", s);
          for (int ch = c0; ch < c0 + n && ch < lim; ++ch)
            ++(part ? hcnt[sp.dx * C + ch] : xcnt[sp.dx * Cx + ch]);
        }
      }
      CHECK(dy0 == g.dy_lo(t.y) + pc.j, "piece %lld: row tap %d", pos, dy0);
      CHECK(t.y + dy0 - g.p >= 0 && t.y + dy0 - g.p < H, "row tap off the map");
      for (int v : xcnt) CHECK(v == 1, "an x channel taken %d times", v);
      for (int v : hcnt) CHECK(v == 1, "an h channel taken %d times", v);
    }
  }
  for (int u = 0; u < g.units; ++u) {
    const Unit t = decode(g, u);
    CHECK(static_cast<int>(seen[u].size()) == g.nv(t.y), "unit %d: %zu pieces", u,
          seen[u].size());
    std::set<int> js(seen[u].begin(), seen[u].end());
    CHECK(static_cast<int>(js.size()) == g.nv(t.y), "unit %d: a piece twice", u);
    // the in-map row taps are exactly dy_lo .. dy_lo + nv - 1
    int in_map = 0;
    for (int dy = 0; dy < k; ++dy) in_map += t.y + dy - g.p >= 0 && t.y + dy - g.p < H;
    CHECK(in_map == g.nv(t.y), "unit %d: %d in-map row taps", u, in_map);
  }
  // hidden channels of each half of an M tile: once each
  for (int wg = 0; wg < 2; ++wg) {
    std::vector<int> cnt(C);
    for (int np = 0; np < g.n_np; ++np)
      for (int rank = 0; rank < 2; ++rank) {
        for (int n = (2 * np + rank) * BN; n < (2 * np + rank + 1) * BN && n < C; ++n) ++cnt[n];
        CHECK(!g.carries(np, rank, wg) || g.block_carries(np, rank), "carry flags");
        if (g.carries(np, rank, wg))
          for (int n = g.t0; n < g.t0 + kTailN && n < C; ++n) ++cnt[n];
      }
    for (int n = 0; n < C; ++n) CHECK(cnt[n] == 1, "hidden channel %d of half %d: %d", n, wg, cnt[n]);
  }

  double max_err = 0.0;
  if (emulate) {
    // inputs, weights (rows of k*k*(Cx + C), 4C columns) in double
    std::vector<double> x(static_cast<size_t>(B) * H * W * Cx), h(static_cast<size_t>(B) * H * W * C);
    const size_t rows = static_cast<size_t>(k) * k * (Cx + C);
    std::vector<double> w(rows * 4 * C);
    unsigned state = 12345u;
    auto rnd = [&] {
      state = state * 1664525u + 1013904223u;
      return static_cast<double>(state >> 8) / (1 << 24) - 0.5;
    };
    for (auto& v : x) v = rnd();
    for (auto& v : h) v = rnd();
    for (auto& v : w) v = rnd();
    auto in = [&](int part, int b, int yy, int xx, int ch) -> double {  // TMA: zero outside
      const int lim = part ? C : Cx;
      if (b < 0 || b >= B || yy < 0 || yy >= H || xx < 0 || xx >= W || ch < 0 || ch >= lim)
        return 0.0;
      const size_t pix = (static_cast<size_t>(b) * H + yy) * W + xx;
      return part ? h[pix * C + ch] : x[pix * Cx + ch];
    };
    auto wt = [&](long long row, int col) -> double {  // zero past the last row
      return row < static_cast<long long>(rows) ? w[row * 4 * C + col] : 0.0;
    };
    // a few hidden channels of every 64-channel tile, and the tail's
    std::vector<int> cols;
    for (int n0 = 0; n0 < C; n0 += BN)
      for (int d : {0, 1, 37, 63})
        if (n0 + d < C) cols.push_back(n0 + d);
    for (int n = g.t0; n < C; ++n) cols.push_back(n);
    for (int u = 0; u < g.units; ++u) {
      const Unit t = decode(g, u);
      for (int rank = 0; rank < 2; ++rank) {
        const int nt = 2 * t.np + rank;
        for (int m = 0; m < BM; ++m) {
          const long long pix = epilogue_pixel(g, t, m);
          int b, xx;
          load_pixel(g, t, m, &b, &xx);
          if (pix < 0) continue;
          CHECK(pix == (static_cast<long long>(b) * H + t.y) * W + xx, "pixel of row %d", m);
          for (int n : cols) {
            const bool tile = n >= nt * BN && n < (nt + 1) * BN && n < g.t0;
            const bool tail = n >= g.t0 && g.carries(t.np, rank, m / 64);
            if (!tile && !tail) continue;
            for (int q = 0; q < 4; ++q) {
              const int col = q * C + n;
              double sum = 0.0;
              for (int j = 0; j < g.nv(t.y); ++j) {  // pieces in order, each from zero
                double part_sum = 0.0;
                for (int s = j * g.tap_steps(); s < (j + 1) * g.tap_steps(); ++s) {
                  const Step sp = step(g, s, t.y);
                  const int yy = t.y + sp.dy - g.p, xs = xx + sp.dx - g.p;
                  const int parts = sp.shrt ? 2 : 1;
                  for (int pq = 0; pq < parts; ++pq) {
                    const int part = sp.shrt ? pq : sp.part;
                    const int c0 = pq ? sp.c0h : sp.c0, row = pq ? sp.row_h : sp.row;
                    const int nk = sp.shrt ? kTailK : BK;
                    for (int i = 0; i < nk; ++i)
                      part_sum += in(part, b, yy, xs, c0 + i) * wt(row + i, col);
                  }
                }
                sum += part_sum;
              }
              double want = 0.0;  // naive SAME convolution of cat(x, h)
              for (int dy = 0; dy < k; ++dy)
                for (int dx = 0; dx < k; ++dx)
                  for (int ci = 0; ci < Cx + C; ++ci)
                    want += (ci < Cx ? in(0, b, t.y + dy - g.p, xx + dx - g.p, ci)
                                     : in(1, b, t.y + dy - g.p, xx + dx - g.p, ci - Cx)) *
                            w[((static_cast<size_t>(dy) * k + dx) * (Cx + C) + ci) * 4 * C + col];
              const double err = std::fabs(sum - want);
              max_err = err > max_err ? err : max_err;
              CHECK(err <= 1e-9 * (1.0 + std::fabs(want)), "unit %d row %d column %d: %g vs %g",
                    u, m, col, sum, want);
            }
          }
        }
      }
    }
  }
  std::printf("ok tail=%d units=%d pieces=%lld clusters=%d steps=%lld slots=%lld emulated=%d "
              "max_err=%.3g\n",
              g.tail, g.units, g.total, g.clusters, steps, static_cast<long long>(slots.size()),
              emulate ? 1 : 0, max_err);
  return 0;
}
