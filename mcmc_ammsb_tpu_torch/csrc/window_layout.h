// The window kernel's shared-memory format (window_kernel.cu): the word
// offsets of one CTA's arrays in each of its six layouts, the limits they
// depend on, and the bytes a launch asks for. The kernel indexes its shared
// memory through these structs; window_layout.cpp builds the same code for
// the host, where the planner (ops/window.py::window_plan) reads a plan's
// bytes, the slice width and the grid layout's L2 exchange from it.

#pragma once

#include <cstddef>

// Host and device code under nvcc, host code under a C++ compiler.
#ifdef __CUDACC__
#define WINDOW_HD __host__ __device__
#else
#define WINDOW_HD
#endif

namespace {

constexpr int kThreads = 512;
// The contrib loop keeps a thread's column of the neighbor rows in
// registers; window_kernel_launch refuses n > kMaxNeighbors.
constexpr int kMaxNeighbors = 32;
// Longest window: the step sizes travel in the kernel's parameters.
constexpr int kMaxWindow = 64;
// Largest cluster (16 is non-portable: the launch allows it explicitly).
constexpr int kMaxCluster = 16;

// Shared row stride: a multiple of 4 floats (16-byte vector loads) whose
// quarter is odd, so the 8 lanes of a quarter-warp reading 16 bytes of 8
// different rows hit 8 different bank groups.
WINDOW_HD inline int row_stride(int w) {
  const int q4 = (w + 3) / 4;
  return 4 * (q4 + 1 + (q4 % 2));
}

// Columns per CTA: ceil(K / S), rounded up to a multiple of 4 when K is
// one (16-byte copies).
WINDOW_HD inline int slice_width(int K, int S) {
  int w = (K + S - 1) / S;
  if (K % 4 == 0) w = (w + 3) / 4 * 4;
  return w;
}

constexpr int kWarps = kThreads / 32;

// Offsets (in 4-byte words) of the shared arrays of one CTA in the
// resident mode. The row buffers and beta - eps come first (16-byte
// aligned), then the noise buffers and the coefficients, whose offsets are
// multiples of 16 bytes when kw is a multiple of 4 (the 16-byte copies and
// loads).
struct Layout {
  size_t rows0, rows1, bme, nz0, nz1, bz0, bz1, coef, staged, ssum, th0,
      th1, bet, gpart, phis0, phis1, ce, nval, scale, invphi, qin, rin, ein,
      smc, snodes, snbrs, slanes, ybits, mbits, yebits, embits, total;
};

WINDOW_HD inline size_t words_of_bits(size_t bits) {
  return (bits + 31) / 32;
}

WINDOW_HD inline Layout layout(int T, int B, int n, int E, int kw, int S) {
  const size_t R = (size_t)B + n, ld = row_stride(kw);
  const size_t TB = (size_t)T * B, TE = (size_t)T * E, Bn = (size_t)B * n;
  const size_t nl = (B + S - 1) / S;   // nodes a CTA owns, at most
  Layout L;
  size_t o = 0;
  L.rows0 = o;  o += R * ld;     // step rows, even steps [R, ld]
  L.rows1 = o;  o += R * ld;     // step rows, odd steps
  L.bme = o;    o += (kw + 3) / 4 * 4;  // beta - eps, zero-padded
  L.nz0 = o;    o += B * kw;     // phi noise slice, even steps [B, kw]
  L.nz1 = o;    o += B * kw;     // odd steps
  L.bz0 = o;    o += 2 * (size_t)kw;  // theta noise slice [kw, 2]
  L.bz1 = o;    o += 2 * (size_t)kw;
  L.coef = o;   o += Bn;         // s/p * mask [B, n], from the owners
  L.staged = o; o += TB * kw;    // staged rows of the window [T*B, kw]
  L.ssum = o;   o += TB;         // their sums
  L.th0 = o;    o += kw;
  L.th1 = o;    o += kw;
  L.bet = o;    o += kw;
  L.gpart = o;  o += (size_t)kWarps * kw * 2;  // fan-in partials per warp
  L.phis0 = o;  o += B;          // gathered phi sums, even steps
  L.phis1 = o;  o += B;          // odd steps
  L.ce = o;     o += B;          // sum_j e/p, from the owners
  L.nval = o;   o += B;          // valid neighbors
  L.scale = o;  o += B;          // N / n_valid
  L.invphi = o; o += B;          // 1 / phi
  L.qin = o;    o += S * nl * n;       // q partials of the owned nodes
  L.rin = o;    o += (size_t)S * B;    // row-sum partials [S, B]
  L.ein = o;    o += (size_t)S * 2 * E;  // (s_pp, s_pr) partials [S, E, 2]
  L.smc = o;    o += (size_t)T * R;   // the window's read codes
  L.snodes = o; o += TB;              // its node ids
  L.snbrs = o;  o += (size_t)T * n;   // its neighbor ids
  L.slanes = o; o += TE;              // its lane maps, u | v << 16
  L.ybits = o;  o += words_of_bits(TB * n);  // pair labels
  L.mbits = o;  o += words_of_bits(TB);      // node masks
  L.yebits = o; o += words_of_bits(TE);      // edge labels
  L.embits = o; o += words_of_bits(TE);      // edge masks
  L.total = o;
  return L;
}

// Offsets (in 4-byte words) of the shared arrays of one CTA in the wide
// mode, whose rows are taken in chunks of wc columns (a multiple of 8).
// Every array of float4 loads starts at a multiple of 16 bytes. Of the
// slice width kw only beta - eps, theta and beta grow with K.
struct WideLayout {
  size_t ch0, ch1, nz0, nz1, bme, coef, qacc, gpart, th0, th1, bet, ssum,
      phis, ce, nval, scale, invphi, racc, rsv, eacc, epr, qin, rin, ein, smc,
      snodes, snbrs, slanes, ybits, mbits, yebits, embits, total;
};

WINDOW_HD inline size_t up4(size_t words) {
  return (words + 3) / 4 * 4;
}

WINDOW_HD inline WideLayout layout_wide(int T, int B, int n, int E, int kw,
                                        int S, int wc) {
  const size_t R = (size_t)B + n, ldc = row_stride(wc);
  const size_t TB = (size_t)T * B, TE = (size_t)T * E, Bn = (size_t)B * n;
  const size_t nl = (B + S - 1) / S;
  WideLayout L;
  size_t o = 0;
  L.ch0 = o;    o += R * ldc;          // chunk of the step rows [R, ldc]
  L.ch1 = o;    o += R * ldc;          // the next chunk
  L.nz0 = o;    o += (size_t)B * wc;   // chunk of the phi noise [B, wc]
  L.nz1 = o;    o += (size_t)B * wc;
  L.bme = o;    o += up4(kw);          // beta - eps, zero-padded
  L.coef = o;   o += up4(Bn);          // s/p * mask [B, n], from the owners
  L.qacc = o;   o += up4(Bn);          // q partials over the chunks so far
  L.gpart = o;  o += (size_t)kWarps * wc * 2;  // fan-in partials of a chunk
  L.th0 = o;    o += up4(kw);
  L.th1 = o;    o += up4(kw);
  L.bet = o;    o += up4(kw);
  L.ssum = o;   o += TB;               // the staged rows' sums
  L.phis = o;   o += B;                // the step's phi sums
  L.ce = o;     o += B;
  L.nval = o;   o += B;
  L.scale = o;  o += B;
  L.invphi = o; o += B;
  L.racc = o;   o += 32 * (size_t)B;   // row partials of each lane [B, 32]
  L.rsv = o;    o += B;                // the step's row sums
  L.eacc = o;   o += 64 * (size_t)E;   // edge partials of each lane [E, 32, 2]
  L.epr = o;    o += E;                // per-edge prsum
  L.qin = o;    o += S * nl * n;
  L.rin = o;    o += (size_t)S * B;
  L.ein = o;    o += (size_t)S * 2 * E;
  L.smc = o;    o += (size_t)T * R;
  L.snodes = o; o += TB;
  L.snbrs = o;  o += (size_t)T * n;
  L.slanes = o; o += TE;
  L.ybits = o;  o += words_of_bits(TB * n);
  L.mbits = o;  o += words_of_bits(TB);
  L.yebits = o; o += words_of_bits(TE);
  L.embits = o; o += words_of_bits(TE);
  L.total = o;
  return L;
}

WINDOW_HD inline size_t larger(size_t a, size_t b) {
  return a > b ? a : b;
}

// The step layout's q tile: a warp takes up to this many nodes at once,
// so each neighbor-row load serves them all.
constexpr int kQNodes = 11;
// The step layout's contrib tile: a thread takes this many nodes for
// four columns.
constexpr int kCNodes = 5;

// The step layout's q splits: the warps that share a group of kQNodes
// nodes, each over its own run of columns.
WINDOW_HD inline int q_splits(int B) {
  const int groups = (B + kQNodes - 1) / kQNodes;
  return groups >= kWarps ? 1 : kWarps / groups;
}

// The step layout's fan-in groups: the threads that share a column, each
// over its own edges.
WINDOW_HD inline int fan_groups(int kw) {
  return kw <= kThreads ? kThreads / kw : 1;
}

// Offsets (in 4-byte words) of the shared arrays of one CTA in the step
// layout, which keeps the step's rows in shared memory for the whole
// step (two sets: step t's and step t+1's in flight). The mbarriers come
// first (8 bytes each), then the arrays of bulk copies and float4 loads,
// each at a multiple of 16 bytes.
struct StepLayout {
  size_t bars, rows0, rows1, nz, bz, bme, coef, part, th0,
      th1, bet, ssum, phis0, phis1, ce, nval, scale, invphi, rsv, epr, qin,
      rin, ein, smc, snodes, snbrs, slanes, ybits, mbits, yebits, embits,
      total;
};

WINDOW_HD inline StepLayout layout_step(int T, int B, int n, int E, int kw,
                                        int S) {
  const size_t R = (size_t)B + n, ld = row_stride(kw);
  const size_t TB = (size_t)T * B, TE = (size_t)T * E, Bn = (size_t)B * n;
  const size_t nl = (B + S - 1) / S;
  const size_t ks = q_splits(B), G = fan_groups(kw);
  StepLayout L;
  size_t o = 0;
  L.bars = o;   o += 8;               // 3 mbarriers: rows0, rows1, noise
  L.rows0 = o;  o += R * ld;          // step rows, even steps [R, ld]
  L.rows1 = o;  o += R * ld;          // step rows, odd steps
  L.nz = o;     o += (size_t)B * ld;   // the phi noise [B, kw]; before it
                                      // x * (beta - eps) [B, ld]
  L.bz = o;     o += up4(2 * (size_t)kw);  // theta noise [kw, 2]
  L.bme = o;    o += up4(kw);         // beta - eps, zero-padded
  L.coef = o;   o += up4(Bn);         // s/p * mask [B, n], from the owners
  // stage a's q partials of the splits [ks, B, n], later stage e's fan-in
  // partials [G, kw, 2]
  L.part = o;   o += up4(larger(ks * Bn, 2 * G * kw));
  L.th0 = o;    o += up4(kw);
  L.th1 = o;    o += up4(kw);
  L.bet = o;    o += up4(kw);
  L.ssum = o;   o += TB;              // the staged rows' sums
  L.phis0 = o;  o += B;               // the step's phi sums, even steps
  L.phis1 = o;  o += B;               // odd steps
  L.ce = o;     o += B;
  L.nval = o;   o += B;
  L.scale = o;  o += B;
  L.invphi = o; o += B;
  L.rsv = o;    o += B;               // the step's row sums
  L.epr = o;    o += E;               // per-edge prsum
  L.qin = o;    o += S * nl * n;
  L.rin = o;    o += (size_t)S * B;
  L.ein = o;    o += (size_t)S * 2 * E;
  L.smc = o;    o += (size_t)T * R;
  L.snodes = o; o += TB;
  L.snbrs = o;  o += (size_t)T * n;
  L.slanes = o; o += TE;
  L.ybits = o;  o += words_of_bits(TB * n);
  L.mbits = o;  o += words_of_bits(TB);
  L.yebits = o; o += words_of_bits(TE);
  L.embits = o; o += words_of_bits(TE);
  L.total = o;
  return L;
}

// Offsets (in 4-byte words) of the shared arrays of one CTA in the step
// layout with one set of rows (window_kernel_step1), which keeps a single
// set of a step's rows in shared memory: step t+1's rows are gathered into
// it as step t's regions free up, and the phi noise is read from global
// memory where it is used. The mbarriers come first (8 bytes each), then
// the arrays of bulk copies and float4 loads, each at a multiple of 16
// bytes.
struct Step1Layout {
  size_t bars, rows, bz, bme, coef, part, th0, th1, bet, ssum, phis, ce,
      nval, scale, invphi, rsv, epr, qin, rin, ein, smc, snodes, snbrs,
      slanes, ybits, mbits, yebits, embits, total;
};

WINDOW_HD inline Step1Layout layout_step1(int T, int B, int n, int E,
                                          int kw, int S) {
  const size_t R = (size_t)B + n, ld = row_stride(kw);
  const size_t TB = (size_t)T * B, TE = (size_t)T * E, Bn = (size_t)B * n;
  const size_t nl = (B + S - 1) / S;
  const size_t ks = q_splits(B), G = fan_groups(kw);
  Step1Layout L;
  size_t o = 0;
  L.bars = o;   o += 8;               // 3 mbarriers: node rows, neighbor
                                      // rows, theta noise
  L.rows = o;   o += R * ld;          // the step rows [R, ld], one set
  L.bz = o;     o += up4(2 * (size_t)kw);  // theta noise [kw, 2]
  L.bme = o;    o += up4(kw);         // beta - eps, zero-padded
  L.coef = o;   o += up4(Bn);         // s/p * mask [B, n], from the owners
  // stage a's q partials of the splits [ks, B, n], later stage e's fan-in
  // partials [G, kw, 2]
  L.part = o;   o += up4(larger(ks * Bn, 2 * G * kw));
  L.th0 = o;    o += up4(kw);
  L.th1 = o;    o += up4(kw);
  L.bet = o;    o += up4(kw);
  L.ssum = o;   o += TB;              // the staged rows' sums
  L.phis = o;   o += B;               // the step's phi sums
  L.ce = o;     o += B;
  L.nval = o;   o += B;
  L.scale = o;  o += B;
  L.invphi = o; o += B;
  L.rsv = o;    o += B;               // the step's row sums
  L.epr = o;    o += E;               // per-edge prsum
  L.qin = o;    o += S * nl * n;
  L.rin = o;    o += (size_t)S * B;
  L.ein = o;    o += (size_t)S * 2 * E;
  L.smc = o;    o += (size_t)T * R;
  L.snodes = o; o += TB;
  L.snbrs = o;  o += (size_t)T * n;
  L.slanes = o; o += TE;
  L.ybits = o;  o += words_of_bits(TB * n);
  L.mbits = o;  o += words_of_bits(TB);
  L.yebits = o; o += words_of_bits(TE);
  L.embits = o; o += words_of_bits(TE);
  L.total = o;
  return L;
}

// Offsets (in 4-byte words) of the shared arrays of one CTA in the
// node-resident layout (window_kernel_nodes), which keeps a step's node
// rows in shared memory for the whole step and streams its neighbor rows
// through two tiles of n rows x wc columns. Every array of float4 loads
// starts at a multiple of 16 bytes. No noise buffer: the kernel reads the
// phi and theta noise from global memory.
struct NodesLayout {
  size_t rows, tiles, bme, coef, gpart, th0, th1, bet, ssum, phis, ce, nval,
      scale, invphi, rsv, epr, qin, rin, ein, smc, snodes, snbrs, slanes,
      ybits, mbits, yebits, embits, total;
};

WINDOW_HD inline NodesLayout layout_nodes(int T, int B, int n, int E,
                                          int kw, int S, int wc) {
  const size_t R = (size_t)B + n, ld = row_stride(kw), ldt = row_stride(wc);
  const size_t TB = (size_t)T * B, TE = (size_t)T * E, Bn = (size_t)B * n;
  const size_t nl = (B + S - 1) / S;
  const size_t ks = q_splits(B), G = fan_groups(kw);
  NodesLayout L;
  size_t o = 0;
  L.rows = o;   o += B * ld;          // the step's node rows [B, ld]
  // two tiles of the neighbor rows [2, n, ldt]; at stage a's end the q
  // partials of the splits [ks, B, n]
  L.tiles = o;  o += up4(larger(2 * n * ldt, ks * Bn));
  L.bme = o;    o += up4(kw);         // beta - eps, zero-padded
  L.coef = o;   o += up4(Bn);         // s/p * mask [B, n], from the owners
  L.gpart = o;  o += up4(2 * G * kw);  // stage e's fan-in partials [G, kw, 2]
  L.th0 = o;    o += up4(kw);
  L.th1 = o;    o += up4(kw);
  L.bet = o;    o += up4(kw);
  L.ssum = o;   o += TB;              // the staged rows' sums
  L.phis = o;   o += B;               // the step's phi sums
  L.ce = o;     o += B;
  L.nval = o;   o += B;
  L.scale = o;  o += B;
  L.invphi = o; o += B;
  L.rsv = o;    o += B;               // the step's row sums
  L.epr = o;    o += E;               // per-edge prsum
  L.qin = o;    o += S * nl * n;
  L.rin = o;    o += (size_t)S * B;
  L.ein = o;    o += (size_t)S * 2 * E;
  L.smc = o;    o += (size_t)T * R;
  L.snodes = o; o += TB;
  L.snbrs = o;  o += (size_t)T * n;
  L.slanes = o; o += TE;
  L.ybits = o;  o += words_of_bits(TB * n);
  L.mbits = o;  o += words_of_bits(TB);
  L.yebits = o; o += words_of_bits(TE);
  L.embits = o; o += words_of_bits(TE);
  L.total = o;
  return L;
}

// Offsets (in 4-byte words) of the shared arrays of one CTA in the grid
// layout (window_kernel_grid), whose launch spreads a window's columns
// over G clusters of S CTAs: the step layout's arrays (two sets of a
// step's rows, the next step's in flight; the phi noise buffer, earlier
// in the step x * (beta - eps)), where the region of the q partials of
// the splits and of the fan-in partials also takes the G clusters' row
// and edge sums [G, B + 2E] read back from L2. Every array of 16-byte
// copies and float4 loads starts at a multiple of 16 bytes.
struct GridLayout {
  size_t rows0, rows1, nz, bz, bme, coef, part, th0, th1, bet, ssum, phis0,
      phis1, ce, nval, scale, invphi, rsv, epr, qin, rin, ein, smc, snodes,
      snbrs, slanes, ybits, mbits, yebits, embits, total;
};

WINDOW_HD inline GridLayout layout_grid(int T, int B, int n, int E, int kw,
                                        int S, int G) {
  const size_t R = (size_t)B + n, ld = row_stride(kw);
  const size_t TB = (size_t)T * B, TE = (size_t)T * E, Bn = (size_t)B * n;
  const size_t nl = (B + S - 1) / S;
  const size_t ks = q_splits(B), Gf = fan_groups(kw), V = (size_t)B + 2 * E;
  GridLayout L;
  size_t o = 0;
  L.rows0 = o;  o += R * ld;          // step rows, even steps [R, ld]
  L.rows1 = o;  o += R * ld;          // step rows, odd steps
  L.nz = o;     o += (size_t)B * ld;   // the phi noise [B, kw]; before it
                                      // x * (beta - eps) [B, ld]
  L.bz = o;     o += up4(2 * (size_t)kw);  // theta noise [kw, 2]
  L.bme = o;    o += up4(kw);         // beta - eps, zero-padded
  L.coef = o;   o += up4(Bn);         // s/p * mask [B, n], from the owners
  // stage a's q partials of the splits [ks, B, n], stage d's row and edge
  // sums of the clusters [G, V], stage e's fan-in partials [Gf, kw, 2]
  L.part = o;   o += up4(larger(larger(ks * Bn, 2 * Gf * kw), G * V));
  L.th0 = o;    o += up4(kw);
  L.th1 = o;    o += up4(kw);
  L.bet = o;    o += up4(kw);
  L.ssum = o;   o += TB;              // the staged rows' sums
  L.phis0 = o;  o += B;               // the step's phi sums, even steps
  L.phis1 = o;  o += B;               // odd steps
  L.ce = o;     o += B;
  L.nval = o;   o += B;
  L.scale = o;  o += B;
  L.invphi = o; o += B;
  L.rsv = o;    o += B;               // the step's row sums
  L.epr = o;    o += E;               // per-edge prsum
  L.qin = o;    o += S * nl * n;
  L.rin = o;    o += (size_t)S * B;
  L.ein = o;    o += (size_t)S * 2 * E;
  L.smc = o;    o += (size_t)T * R;
  L.snodes = o; o += TB;
  L.snbrs = o;  o += (size_t)T * n;
  L.slanes = o; o += TE;
  L.ybits = o;  o += words_of_bits(TB * n);
  L.mbits = o;  o += words_of_bits(TB);
  L.yebits = o; o += words_of_bits(TE);
  L.embits = o; o += words_of_bits(TE);
  L.total = o;
  return L;
}

// Most clusters of a grid launch: a sum over the clusters holds their
// partials in registers (grid_sum).
constexpr int kMaxGrid = 32;

// The kernel's layouts, as the launch names them (ops/window.py::LAYOUTS):
// the resident mode, and the wide mode's step layout, its step layout with
// one set of rows, its chunked layout, its node-resident layout and its
// grid layout.
enum Mode : int {
  kResident = 0, kStep = 1, kStep1 = 2, kChunked = 3, kNodes = 4, kGrid = 5
};

// The grid layout's CTAs: ceil(K / wc), slices of wc columns.
WINDOW_HD inline int grid_ctas(int K, int wc) { return (K + wc - 1) / wc; }

// Bytes of shared memory per CTA with a cluster of S CTAs (either storage
// type) in the layout `mode` (Mode): the resident mode's, or the wide
// mode's step layout, its step layout with one set of rows, its chunked
// layout with chunks of wc columns, its node-resident layout with tiles
// of wc columns, or its grid layout with slices of wc columns.
WINDOW_HD inline size_t layout_bytes(int T, int B, int n, int E, int K, int S,
                                     int wc, int mode) {
  const int kw = slice_width(K, S);
  size_t words;
  if (mode == kGrid)
    return wc > 0 ? layout_grid(T, B, n, E, wc, S, grid_ctas(K, wc) / S).total
                        * sizeof(float)
                  : 0;
  switch (mode) {
    case kResident: words = layout(T, B, n, E, kw, S).total; break;
    case kStep: words = layout_step(T, B, n, E, kw, S).total; break;
    case kStep1: words = layout_step1(T, B, n, E, kw, S).total; break;
    case kNodes: words = layout_nodes(T, B, n, E, kw, S, wc).total; break;
    default: words = layout_wide(T, B, n, E, kw, S, wc).total;
  }
  return words * sizeof(float);
}

// Floats of the grid layout's L2 exchange, which follows the staged rows
// [T*B, K] in the launch's scratch: each of the ceil(K / wc) / S clusters'
// q [B, n] and its row and edge sums [B + 2E].
WINDOW_HD inline size_t grid_exchange_words(int B, int n, int E, int K,
                                            int wc, int S) {
  return (size_t)(grid_ctas(K, wc) / S) * ((size_t)B * n + B + 2 * E);
}

// The launch's layout and chunk width agree: the resident mode takes wc =
// 0; the step layouts a chunk that covers the slice (wc >= kw), the
// chunked one a narrower chunk (0 < wc < kw), the node-resident one any
// tile (wc > 0), the grid layout any slice (wc > 0), a multiple of 8.
WINDOW_HD inline bool mode_fits(int mode, int wc, int kw) {
  if (mode < kResident || mode > kGrid || wc < 0 || wc % 8 != 0)
    return false;
  if (mode == kResident) return wc == 0;
  if (mode == kNodes || mode == kGrid) return wc > 0;
  return mode == kChunked ? wc > 0 && wc < kw : wc >= kw;
}

}  // namespace
