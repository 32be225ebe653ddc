// Geometry and schedule of the wgmma/TMA ConvLSTM cell (conv_lstm_cell_sm90.cu):
// which output tiles a launch has, how each tile's K range is cut into
// pieces, how the pieces are dealt to the persistent clusters, and where
// each piece leaves its partial sums. Host and device code; it includes no
// CUDA header, so g++ compiles it with -D__host__= -D__device__= and the
// schedule can be walked on a CPU (tests/test_torch_port_sm90_schedule.py).
//
// Two layouts of the work:
//   * general (any Cx and C): a tap takes ceil(Cx / 64) + ceil(C / 64)
//     k-steps of 64 channels, and hidden channels go in 64-channel tiles,
//     two to a cluster; TMA's zero fill covers a partial last chunk or tile.
//   * tail (det's 260 or 258 channels: 64 nx + rx input channels of x with
//     rx <= 16, 128 nh + rh hidden channels with 1 <= rh <= 8, and weights
//     that carry the tail's columns in a block of their own, as
//     ops/kernels.py:pack_gate_weights lays them out): a tap takes
//     the full 64-channel chunks of x and h and one short step that holds x's
//     last 16 channels and h's last 16 (two k16 products); the hidden tiles
//     are the full ones, and the last rh hidden channels (an 8-channel
//     column group of each gate, 32 columns) ride on the first block of the
//     first two tile pairs: the block of pair np multiplies them for the
//     64-pixel half np of the M tile (pair 0 both halves if it is the only
//     pair). A 260-channel cell thus multiplies 1.0625x the columns and
//     1.0625x the depth of a 256-channel one instead of 1.5x and 1.25x.

#pragma once

namespace sm90 {

constexpr int BM = 128;  // output pixels of a tile (two 64-row halves)
constexpr int BN = 64;   // hidden channels of a tile (x4 gates = 256 columns)
constexpr int BK = 64;   // input channels of one tap per k-step
constexpr int kTailK = 16;  // channels of x and of h in a tap's short step
constexpr int kTailN = 8;   // hidden channels of the narrow tail (x4 gates = 32 columns)
// most pieces a tile may be cut into: the finisher keeps their workspace
// slots in shared memory (make_geom bounds the clusters by it, and the host
// refuses a k above it)
constexpr int kMaxPieces = 256;
// one tile's float32 partial sums: 128 x 256, and in the tail layout 128 x
// 32 more for the narrow tail's columns
constexpr int kSlotFloats = BM * 4 * BN;
constexpr int kTailSlotFloats = kSlotFloats + BM * 4 * kTailN;

// k-steps [s0, s1) of unit u: the j-th of the unit's n pieces, in the order
// its partial sums are added
struct Piece {
  int u, j, n, s0, s1;
};

// What k-step s of a piece of output row y multiplies: tap (dy, dx) and
// channel boxes of x (part 0) and h (part 1). A full step is one box of BK
// channels from c0 of part `part`, against BK weight rows from `row`; a
// short step (tail layout) is x's kTailK channels from c0 against weight
// rows from `row`, then h's from c0h against rows from `row_h`. Channels
// past Cx or C read as zeros (TMA's fill), and so do weight rows past the
// last one; weight rows of another part meet those zeros.
struct Step {
  int dy, dx, shrt, part, c0, row, c0h, row_h;
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
  int ncx, nch;          // 64-channel k-steps a tap takes over x, and k-steps in all
  int tail;              // 1 in the tail layout: a tap's last k-step is the short one
  int t0;                // tail layout: the first hidden channel of the narrow tail
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
  // full 64-channel k-steps of h a tap takes
  __host__ __device__ int nhc() const { return nch - ncx - tail; }
  // whether k-step ch of a tap (0 <= ch < nch) is the short one
  __host__ __device__ bool short_step(int ch) const { return tail && ch == nch - 1; }
  // whether warpgroup wg (0 or 1: M rows 64 wg ..) of the block of rank
  // `rank` in pair np multiplies the narrow tail
  __host__ __device__ bool carries(int np, int rank, int wg) const {
    return tail && rank == 0 && np == (n_np == 1 ? 0 : wg);
  }
  // whether either warpgroup of that block does
  __host__ __device__ bool block_carries(int np, int rank) const {
    return carries(np, rank, 0) || carries(np, rank, 1);
  }
  // k-step ch (0 <= ch < nch) of column tap dx of row tap dy, in the
  // layout kTail (== tail): integer work for the producer without a divide
  template <bool kTail>
  __host__ __device__ Step step_at(int dy, int dx, int ch) const {
    Step st;
    st.dy = dy;
    st.dx = dx;
    const int tap_row = (dy * k + dx) * (Cx + C);
    st.shrt = kTail && ch == nch - 1;
    if (st.shrt) {
      st.part = 0;
      st.c0 = ncx * BK;
      st.row = tap_row + st.c0;
      st.c0h = (nch - ncx - 1) * BK;
      st.row_h = tap_row + Cx + st.c0h;
    } else {
      st.part = ch < ncx ? 0 : 1;
      st.c0 = (st.part ? ch - ncx : ch) * BK;
      st.row = tap_row + (st.part ? Cx : 0) + st.c0;
      st.c0h = st.row_h = 0;
    }
    return st;
  }
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
  // workspace slots a launch needs, and the floats of one
  __host__ __device__ long long slots() const { return 2 * total; }
  __host__ __device__ int slot_floats() const { return tail ? kTailSlotFloats : kSlotFloats; }
};

// whether a cell of Cx input and C hidden channels takes the tail layout
inline __host__ __device__ bool takes_tail(int Cx, int C) {
  const int rx = Cx % BK, rh = C % BK;
  return rx <= kTailK && rh >= 1 && rh <= kTailN && C / BK >= 2 && (C / BK) % 2 == 0;
}

// `tail_block`: the weights carry the narrow tail's 32 columns apart
inline Geom make_geom(int B, int H, int W, int Cx, int C, int k, int max_clusters,
                      bool tail_block) {
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
  g.tail = tail_block && takes_tail(Cx, C) ? 1 : 0;
  if (g.tail) {
    g.n_np = C / BK / 2;
    g.ncx = Cx / BK;
    g.nch = g.ncx + C / BK + 1;
    g.t0 = C / BK * BK;
  } else {
    g.n_np = ((C + BN - 1) / BN + 1) / 2;
    g.ncx = (Cx + BK - 1) / BK;
    g.nch = g.ncx + (C + BK - 1) / BK;
    g.t0 = C;
  }
  g.units = g.n_np * g.n_mb * H * g.n_xc;
  g.row_work = 0;
  for (int y = 0; y < H; ++y) g.row_work += g.unit_work(y) * g.n_xc;
  g.total = g.row_work * g.n_np * g.n_mb;
  const int most = max_clusters < kMaxPieces ? max_clusters : kMaxPieces;
  g.clusters = static_cast<int>(g.total < most ? g.total : most);
  return g;
}

}  // namespace sm90
