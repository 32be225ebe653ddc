// Geometry and schedule of the float32 ConvLSTM cell (conv_lstm_cell_f32.cu):
// its tile shapes, which output tiles a launch has and in what order the
// blocks take them, the k-steps (row tap, column tap, 32-channel chunk)
// each tile walks, and the choice of tile shape per launch. Host and device
// code; it includes no CUDA header, so g++ compiles it with -D__host__=
// -D__device__= and the schedule is walked on a CPU
// (tests/test_torch_port_f32_schedule.py).
//
// A tile is bm output pixels x nh hidden channels in all four gates
// (4 nh gate columns). Its pixels are bb batch entries x wbox columns of ONE
// output row y, so the tile takes only the row taps of y that land inside
// the map (nv(y) of k); column taps stay, multiplied by the zeros of the
// border. A block computes one whole tile: each output is one fmaf chain,
// bias first, then the in-map row taps in order, each tap's k columns in
// order, each column tap's Cx + C input channels in order (x's, then h's):
// the order of the CUDA-core kernel this one replaced, which took every tap
// and multiplied the out-of-map ones by zero (an exact fmaf(0, w, acc)).

#pragma once

namespace f32cell {

constexpr int BK = 32;      // input channels of one column tap per k-step
constexpr int kStages = 2;  // cp.async ring depth
constexpr int kTP = 4;      // pixels a thread
constexpr int kTH = 4;      // hidden channels a thread (x 4 gates: 16 columns)
constexpr int A_LD = BK + 4;  // floats a staged pixel row: 16-byte aligned, and
                              // 8 consecutive rows' float4 reads hit distinct banks

// tile shapes s = 0, 1: (shape_bm(s) pixels, shape_nh(s) hidden channels)
constexpr int kShapes = 2;
__host__ __device__ constexpr int shape_bm(int s) { return s == 0 ? 128 : 64; }
__host__ __device__ constexpr int shape_nh(int) { return 32; }
__host__ __device__ constexpr int shape_threads(int s) {
  return (shape_bm(s) / kTP) * (shape_nh(s) / kTH);
}
// dynamic shared memory of a block: kStages stages of A (bm x A_LD) and B
// (BK x 4 nh), in bytes
__host__ __device__ constexpr int shape_smem(int s) {
  return kStages * (shape_bm(s) * A_LD + BK * 4 * shape_nh(s)) * 4;
}

struct Tile {
  int y, mb, xc, nt;
};

// What k-step s of a tile of output row y multiplies: row tap dy, column
// tap dx, input channels [c0, c0 + BK) of cat(x, h).
struct Step {
  int dy, dx, c0;
};

struct Geom {
  int B, H, W, Cx, C, k, p;
  int shape, bm, nh;
  int wbox, bb;     // a tile's pixels: bb batch entries x wbox columns
  int n_xc, n_mb, n_nt;
  int chunks;       // k-steps a column tap takes: ceil((Cx + C) / BK)
  int per_row;      // tiles of one output row
  int tiles;

  __host__ __device__ int dy_lo(int y) const { return y < p ? p - y : 0; }
  // row taps of output row y that land inside the map
  __host__ __device__ int nv(int y) const {
    const int hi = H - 1 - y + p < k - 1 ? H - 1 - y + p : k - 1;
    return hi - dy_lo(y) + 1;
  }
  __host__ __device__ int steps(int y) const { return nv(y) * k * chunks; }
  // The r-th output row in launch order: rows with more in-map row taps
  // first (they carry the most work), ties in row order.
  __host__ __device__ int row_at(int r) const {
    for (int v = k; v >= 1; --v)
      for (int y = 0; y < H; ++y)
        if (nv(y) == v && r-- == 0) return y;
    return -1;
  }
  // tile t of the launch (block t): its row by row_at, then the hidden
  // tile, then batch chunk and column chunk
  __host__ __device__ Tile tile(int t) const {
    Tile tl;
    tl.y = row_at(t / per_row);
    const int q = t % per_row;
    tl.nt = q / (n_mb * n_xc);
    tl.mb = q / n_xc % n_mb;
    tl.xc = q % n_xc;
    return tl;
  }
  // the output pixel of row m (0 <= m < bm) of a tile: batch entry *b and
  // column *x; false where it lies past B or W (loads zero, no store)
  __host__ __device__ bool pixel(const Tile& tl, int m, int* b, int* x) const {
    *b = tl.mb * bb + m / wbox;
    *x = tl.xc * wbox + m % wbox;
    return *b < B && *x < W;
  }
  // k-step s (0 <= s < steps(y)) of a tile of row y
  __host__ __device__ Step step(int y, int s) const {
    Step st;
    st.dy = dy_lo(y) + s / (k * chunks);
    st.dx = s / chunks % k;
    st.c0 = s % chunks * BK;
    return st;
  }
  // the k-step after st, without a divide (the kernel's loader walks so)
  __host__ __device__ void next(Step& st) const {
    st.c0 += BK;
    if (st.c0 >= Cx + C) {
      st.c0 = 0;
      if (++st.dx == k) {
        st.dx = 0;
        ++st.dy;
      }
    }
  }
  // multiply-adds the launch's blocks do (zero taps and padding included)
  __host__ __device__ long long macs() const {
    long long rows = 0;
    for (int y = 0; y < H; ++y) rows += nv(y);
    return rows * n_mb * n_xc * n_nt * static_cast<long long>(k) * chunks * BK *
           bm * 4 * nh;
  }
};

inline __host__ __device__ Geom make_geom(int B, int H, int W, int Cx, int C, int k,
                                          int shape) {
  Geom g{};
  g.B = B; g.H = H; g.W = W; g.Cx = Cx; g.C = C; g.k = k; g.p = k / 2;
  g.shape = shape;
  g.bm = shape_bm(shape);
  g.nh = shape_nh(shape);
  g.wbox = 1;
  while (g.wbox < W && g.wbox < g.bm) g.wbox *= 2;
  g.bb = g.bm / g.wbox;
  g.n_xc = (W + g.wbox - 1) / g.wbox;
  g.n_mb = (B + g.bb - 1) / g.bb;
  g.n_nt = (C + g.nh - 1) / g.nh;
  g.chunks = (Cx + C + BK - 1) / BK;
  g.per_row = g.n_mb * g.n_xc * g.n_nt;
  g.tiles = g.per_row * H;
  return g;
}

// The tile shape of a launch on `sms` SMs that hold blocks_per_sm[s]
// blocks of shape s: 128 x 32 tiles where they fill at least two waves of
// resident blocks, else 64 x 32 ones. The rows' work is uneven (3, 4, 5,
// 5, 4, 3 row taps at 6x8, k = 5), so a launch of one to two waves of big
// tiles ends on a few SMs; half-size tiles halve that tail, and at B = 100
// pad 100 batch entries to 104 rather than 112.
inline __host__ __device__ int choose_shape(int B, int H, int W, int Cx, int C, int k, int sms,
                                            const int* blocks_per_sm) {
  const Geom g = make_geom(B, H, W, Cx, C, k, 0);
  return g.tiles >= 2 * sms * blocks_per_sm[0] ? 0 : 1;
}

}  // namespace f32cell
