// One whole a-MMSB window per chain in ONE launch: the rows are read from
// pi by index, the T sequential SGRLD steps run on a thread-block
// cluster that splits K, and the surviving rows are written back into pi
// and phi_sum in place.
//
// Replaces, for one window with window_correction="always", what
// mcmc_ammsb_tpu/ops/window.py::windowed_scan does around the Pallas TPU
// kernel _window_kernel (reached through window_kernel_call ->
// pl.pallas_call): _window_gather, then the kernel, then _window_scatter.
// Both of the kernel's modes go through window_kernel_launch: one chain
// (C = 1, the main path; mcmc_ammsb_tpu_torch/ops/window.py::
// window_apply_cuda, plain version window_apply_torch) and C independent
// chains on the flat layout pi [C*N, K] (the flat chain engine;
// window_chain_apply_cuda, plain version window_chain_apply_torch).
//
// Layout of the launch: chain c gets a cluster of S CTAs (grid C*S).
// CTA r owns the column slice [r*kw, min(K, (r+1)*kw)) of every row,
// theta, beta and noise, kw = slice_width(K, S); the last slice may be
// ragged (K = 100). S and the mode come from the per-chain shape and the
// card's shared memory (ops/window.py::window_plan: the resident mode at
// S = 4 at K = 256, the wide mode at S = 16 from K = 1536 at T = 12),
// never from C, so one C-chain launch gives the same bits as C
// single-chain launches.
//
// Two modes, one function. The resident mode (window_kernel) keeps a
// CTA's whole slice of the step rows and of the window's staged rows in
// shared memory; it is chosen wherever that fits. The wide mode
// (window_kernel_wide, described above it) stages the rows in a global
// scratch and takes the slice in column chunks, so its shared memory
// hardly grows with K; it runs T = 12 up to K = 4096 and K = 16384 at T =
// 12 on an H100. What follows describes the resident mode.
//
// Per step t, exactly the JAX kernel's math:
//   1. read rows: lane r reads staged row mcode-1 when mcode > 0 (a row
//      an earlier step of the window wrote), else pi[node or nbr] as it
//      was before the window. The TPU kernel redirects with a 0/1
//      one-hot matrix product; an indexed load gives the same bits.
//   2. phi: q = (pi_n * (beta - eps)) . pi_nb, p = s q + e, the masked
//      1/p coefficients, contrib = a . pi_nb, the SGRLD step with noise,
//      the 1e-24 floor and the row normalization; the rows are staged.
//   3. beta: edge endpoint e reads staged row lanes_u[e] / lanes_v[e]
//      (masked node lanes replaced by 1/K), the per-edge sums, the
//      gradient fan-in over edges, then the theta SGRLD step (abs,
//      floor) and beta = theta1 / (theta0 + theta1).
// After the last step the rows that _last_write_wins keeps are written
// to pi (each CTA its columns), their sums to phi_sum (CTA 0), theta and
// beta to the outputs (each CTA its slice).
//
// What bounds it on an H100: the bytes a window must move (its read
// rows, noise and written rows, ~1.6 MB at T=12, B=33, n=32, E=32,
// K=256 with distinct rows: ~0.5 us at 3.35 TB/s) and its ~16 MFLOP
// (0.24 us at 67 TFLOP/s fp32) are both far below the time of T
// sequential steps, each a chain of dependent reductions and barriers:
// the kernel is latency-bound (PERF.md: ~17 us per step, ~10 stages of
// 1-7 thousand cycles each, scripts/window_phases.py).
//
// What this design does about it:
//   - The K split spreads a step over S SMs. Three sums need every
//     column: q[b, j] (B*n), the row sums of phi' (B) and the per-edge
//     s_pp, s_pr (2E). Each is exchanged through distributed shared
//     memory by remote STORES, so no stage waits on a remote load: every
//     CTA pushes its row-sum and edge partials into slot [rank] of every
//     CTA, and its q partials into slot [rank] of the CTA that owns the
//     node (b mod S); after one cluster barrier (barrier.cluster,
//     release/acquire) each reader sums the S slots in the fixed order
//     r = 0..S-1, so every CTA holds identical bits whatever the
//     scheduling. A node's owner then computes its coefficients, e/p sum,
//     mask count, 1/phi and N/n_valid and pushes them to every CTA before
//     a second barrier. Four cluster barriers per step; each exchange
//     buffer is written again only after the readers have passed another
//     cluster barrier, so none needs a second copy. Everything else
//     (contrib and the phi step, normalization and staging, the fan-in
//     and the theta step) is local to a CTA's columns.
//   - The window's staged rows ([T*B, kw] per CTA, 101 KB at T=12, B=33,
//     kw=64) and their sums live in shared memory: redirected reads and
//     edge-endpoint reads are shared-memory loads. There is no global
//     staging buffer; the wrapper picks S so that the slice fits, and the
//     wide mode where none does.
//   - The gather is in the kernel: step t+1's pre-window rows (lanes with
//     mcode 0), their phi sums and the step's noise slices are copied with
//     cp.async (16-byte chunks where K and kw are multiples of 4) into a
//     second set of buffers while step t computes; lanes with mcode > 0
//     are copied from the staged slice before the step's barrier. TMA has
//     no row gather, so per-row copies are the tool. pi is only written
//     after the last step, so every read sees the pre-window values, as
//     the JAX gather does. The window's ids and codes, and its labels and
//     masks as bits, are loaded once at the start.
//   - Sentinel lanes: a padded node lane carries N; JAX clamps its read
//     to the last row (N-1 on one chain, C*N-1 — the last chain's last
//     row — on the flat layout). Here the clamp stays inside the chain's
//     own block (chain*N + N-1): a cluster never reads a row that another
//     cluster writes. Masked lanes never reach the state (the scatter
//     drops them and the beta stage reads 1/K for them), so no compared
//     result changes.
//   - Arithmetic is float32 FMAs on the SIMT units; division and sqrt are
//     IEEE (no fast math): 1/p and 1/phi amplify error. No wgmma and no
//     TF32: the products are 33x32 outputs over a 64-deep slice, far
//     below a 64-row warpgroup tile, and TF32's ~3 digits would feed 1/p.
//
// Storage type of pi (--pi-dtype): the kernel is a template on it. With
// float32 (window_kernel<float>) the rows are copied by cp.async as above.
// With bfloat16 storage (window_kernel<__nv_bfloat16>; JAX's bf16 window,
// ops/window.py:241,252, which gathers the rows upcast and quantizes them
// only at the scatter) the gather loads 8 bf16 values per 16-byte load
// (one at a time on a ragged slice) and widens them to float32 in the
// same step row buffers; everything after the gather is the float32 code,
// the staged rows stay float32 (a redirected read sees the earlier step's
// float32 value), and the scatter rounds each kept value to nearest-even
// (__float2bfloat16_rn, torch's .to(torch.bfloat16)). No staging buffer:
// the shared-memory layout is the float32 one. The bf16 loads are
// synchronous, so unlike the float32 copies they do not overlap the
// previous step's compute.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// The contrib loop keeps a thread's column of the neighbor rows in
// registers; window_kernel_launch refuses n > kMaxNeighbors.
constexpr int kMaxNeighbors = 32;
// q is computed for up to this many nodes per warp in one pass, so each
// neighbor-row load serves several nodes.
constexpr int kNodesPerWarp = 3;
// Longest window: the step sizes travel in the kernel's parameters.
constexpr int kMaxWindow = 64;
// Largest cluster (16 is non-portable: the launch allows it explicitly).
constexpr int kMaxCluster = 16;

// Shared row stride: a multiple of 4 floats (16-byte vector loads) whose
// quarter is odd, so the 8 lanes of a quarter-warp reading 16 bytes of 8
// different rows hit 8 different bank groups.
__host__ __device__ inline int row_stride(int w) {
  const int q4 = (w + 3) / 4;
  return 4 * (q4 + 1 + (q4 % 2));
}

// Columns per CTA: ceil(K / S), rounded up to a multiple of 4 when K is
// one (16-byte copies); mirrored by ops/window.py::window_slice_width.
__host__ __device__ inline int slice_width(int K, int S) {
  int w = (K + S - 1) / S;
  if (K % 4 == 0) w = (w + 3) / 4 * 4;
  return w;
}

constexpr int kWarps = kThreads / 32;

// Offsets (in 4-byte words) of the shared arrays of one CTA; mirrored by
// ops/window.py::window_smem_bytes. The row buffers and beta - eps come
// first (16-byte aligned), then the noise buffers and the coefficients,
// whose offsets are multiples of 16 bytes when kw is a multiple of 4 (the
// 16-byte copies and loads).
struct Layout {
  size_t rows0, rows1, bme, nz0, nz1, bz0, bz1, coef, staged, ssum, th0,
      th1, bet, gpart, phis0, phis1, ce, nval, scale, invphi, qin, rin, ein,
      smc, snodes, snbrs, slanes, ybits, mbits, yebits, embits, total;
};

__host__ __device__ inline size_t words_of_bits(size_t bits) {
  return (bits + 31) / 32;
}

__host__ __device__ inline Layout layout(int T, int B, int n, int E, int kw,
                                         int S) {
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
// mode, whose rows are taken in chunks of wc columns (a multiple of 8);
// mirrored by ops/window.py::window_wide_smem_bytes. Every array of
// float4 loads starts at a multiple of 16 bytes. Of the slice width kw
// only beta - eps, theta and beta grow with K.
struct WideLayout {
  size_t ch0, ch1, nz0, nz1, bme, coef, qacc, gpart, th0, th1, bet, ssum,
      phis, ce, nval, scale, invphi, racc, rsv, eacc, epr, qin, rin, ein, smc,
      snodes, snbrs, slanes, ybits, mbits, yebits, embits, total;
};

__host__ __device__ inline size_t up4(size_t words) {
  return (words + 3) / 4 * 4;
}

__host__ __device__ inline WideLayout layout_wide(int T, int B, int n, int E,
                                                  int kw, int S, int wc) {
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most the newest group is in flight.
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename PiT>
struct Params {
  // state, per chain block of the flat layout; updated in place
  PiT* pi;                 // [C*N, K], float32 or bfloat16 storage
  float* phi_sum;          // [C*N]
  // operands, chain-major ([C, T, ...]); R = B + n; bools one byte each
  const bool* y;           // [T, B, n] neighbor edge labels
  const int* nodes;        // [T, B]    chain-local node ids (padded: N)
  const int* nbrs;         // [T, n]    the step's shared neighbor ids
  const bool* node_mask;   // [T, B]
  const bool* keep;        // [T, B]    last write of its row
  const float* noise;      // [T, B, K] phi noise
  const float* bnoise;     // [T, K, 2] theta noise
  const bool* y_edges;     // [T, E]    minibatch edge labels
  const bool* edge_mask;   // [T, E]
  const int* lanes_u;      // [T, E]    endpoint node lanes
  const int* lanes_v;      // [T, E]
  const int* mcode;        // [T, R]    1 + staged slot, or 0
  const float* wts;        // [T]       minibatch weight
  const float* theta_in;   // [K, 2]
  const float* beta_in;    // [K]
  float* theta_out;        // [K, 2]
  float* beta_out;         // [K]
  float* staged;           // [T*B, K] wide mode's staged rows; else unused
  int T, B, n, E, K, N, kw;
  int wc;                  // wide mode's chunk width; 0 in the resident mode
  float eps, one_minus_eps, alpha, n_nodes, eta0, eta1, inv_k;
  float eps_phi[kMaxWindow];    // phi step sizes of the T steps
  float eps_theta[kMaxWindow];  // theta step sizes
};

#ifdef WINDOW_PHASES
// Opt-in phase profile (scripts/window_phases.py builds with
// -DWINDOW_PHASES): thread 0 of the first CTA adds the clock cycles from
// one barrier to the next into a slot per stage, over all steps.
constexpr int kPhases = 16;
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE(i)                                               \
  do {                                                         \
    if (tid == 0) {                                            \
      const long long now = clock64();                         \
      s_phase[i] += (unsigned long long)(now - t_last);        \
      t_last = now;                                            \
    }                                                          \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

// The shared arrays' word offsets, kept in shared memory so that they
// cost no registers across the step loop: SM(name) is a float*,
// SU(name) an unsigned*.
constexpr int kLayoutFields = sizeof(Layout) / sizeof(size_t);
#define SM(name) (smem + s_off[offsetof(Layout, name) / sizeof(size_t)])
#define SU(name) reinterpret_cast<unsigned*>(SM(name))
#define SI(name) reinterpret_cast<int*>(SM(name))

__device__ __forceinline__ bool bit(const unsigned* bits, size_t i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// bits[i] = src[i] != 0 for i < count, one warp-wide ballot per 32.
__device__ __forceinline__ void pack_bits(unsigned* bits, const bool* src,
                                          int count, int warp, int lane) {
  for (int base = warp * 32; base < count; base += kThreads) {
    const int i = base + lane;
    const unsigned word = __ballot_sync(0xffffffffu, i < count && src[i]);
    if (lane == 0) bits[base >> 5] = word;
  }
}

// A kept value as pi stores it: itself, or rounded to nearest-even.
__device__ __forceinline__ float to_store(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_store(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// Both modes, once per window: the window's indices, labels, masks and
// lane maps into shared memory (ids and codes as ints, the bool arrays as
// bits, the two lane maps packed u | v << 16), and this CTA's slice
// [k0, k0 + kw) of theta and beta.
template <typename PiT>
__device__ __forceinline__ void stage_window(
    const Params<PiT>& P, size_t chain, int k0, int kw, int* smc,
    int* snodes, int* snbrs, unsigned* slanes, unsigned* ybits,
    unsigned* mbits, unsigned* yebits, unsigned* embits, float* th0,
    float* th1, float* bet, int tid, int warp, int lane) {
  const int T = P.T, B = P.B, n = P.n, E = P.E, K = P.K, R = P.B + P.n;
  const size_t TB = (size_t)T * B, TE = (size_t)T * E;
  for (int i = tid; i < T * R; i += kThreads) smc[i] = P.mcode[chain * T * R + i];
  for (int i = tid; i < T * B; i += kThreads) snodes[i] = P.nodes[chain * TB + i];
  for (int i = tid; i < T * n; i += kThreads) snbrs[i] = P.nbrs[chain * T * n + i];
  for (int i = tid; i < T * E; i += kThreads)
    slanes[i] = (unsigned)P.lanes_u[chain * TE + i]
                | ((unsigned)P.lanes_v[chain * TE + i] << 16);
  pack_bits(ybits, P.y + chain * TB * n, T * B * n, warp, lane);
  pack_bits(mbits, P.node_mask + chain * TB, T * B, warp, lane);
  pack_bits(yebits, P.y_edges + chain * TE, T * E, warp, lane);
  pack_bits(embits, P.edge_mask + chain * TE, T * E, warp, lane);
  for (int kk = tid; kk < kw; kk += kThreads) {
    th0[kk] = P.theta_in[chain * K * 2 + 2 * (k0 + kk)];
    th1[kk] = P.theta_in[chain * K * 2 + 2 * (k0 + kk) + 1];
    bet[kk] = P.beta_in[chain * K + k0 + kk];
  }
}

// The wide mode's sum over the ranks, of x[0], x[stride], ...,
// x[(S-1)*stride]: pairwise in a fixed order, so every CTA gets the same
// bits and the rounding grows with log2(S), not with S.
__device__ __forceinline__ float rank_sum(const float* x, int stride,
                                          int S) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < S ? x[r * stride] : 0.f;
#pragma unroll
  for (int w = 1; w < kMaxCluster; w *= 2)
#pragma unroll
    for (int r = 0; r + w < kMaxCluster; r += 2 * w) v[r] += v[r + w];
  return v[0];
}

// Both modes, stage 2b of step t: each CTA finishes its own nodes (b mod
// S == rank, one warp per node): q summed over the ranks from qin [S,
// ceil(B/S), n] (in order; pairwise with kPairwise, the wide mode), the
// pair coefficients, the e/p sum, the mask count, 1/phi and N/n_valid,
// pushed to every CTA of the cluster (the arrays are this CTA's; the
// peers' copies sit at the same offsets).
template <bool kPairwise>
__device__ __forceinline__ void node_coefficients(
    cg::cluster_group& cluster, const float* qin, const unsigned* ybits,
    const int* nd, const int* nb, const float* phis, float* coef, float* ce,
    float* nval, float* scale, float* invphi, int t, int B, int n, int S,
    int rank, int warp, int lane, float eps, float one_minus_eps,
    float n_nodes) {
  const size_t ybase = (size_t)t * B * n;
  const int nl = (B + S - 1) / S;
  for (int lb = warp; lb * S + rank < B; lb += kWarps) {
    const int b = lb * S + rank;
    float s_ce = 0.f, s_n = 0.f;
    for (int j = lane; j < n; j += 32) {
      float q = 0.f;
      if (kPairwise)
        q = rank_sum(qin + lb * n + j, nl * n, S);
      else
        for (int r = 0; r < S; ++r) q += qin[(r * nl + lb) * n + j];
      const int pair = b * n + j;
      const float y = bit(ybits, ybase + pair) ? 1.f : 0.f;
      // a shared neighbor that is the node itself is excluded
      const float m = nb[j] != nd[b] ? 1.f : 0.f;
      const float sgn = 2.f * y - 1.f;
      const float e = y > 0.5f ? eps : one_minus_eps;
      float p = sgn * q + e;
      if (!(m > 0.5f)) p = 1.f;   // masked lanes must not turn into NaN
      const float inv_p = 1.f / p;
      const float a = sgn * inv_p * m;
      for (int x = 0; x < S; ++x) cluster.map_shared_rank(coef, x)[pair] = a;
      s_ce += e * inv_p * m;
      s_n += m;
    }
    s_ce = warp_sum(s_ce);
    s_n = warp_sum(s_n);
    if (lane < S) {   // lane x writes CTA x's copy
      cluster.map_shared_rank(ce, lane)[b] = s_ce;
      cluster.map_shared_rank(nval, lane)[b] = s_n;
      cluster.map_shared_rank(scale, lane)[b] = n_nodes / s_n;
      cluster.map_shared_rank(invphi, lane)[b] = 1.f / phis[b];
    }
  }
}

// Both modes: the theta SGRLD step of one column (abs, floor) from its
// gradient fan-in (g0, g1) and theta noise (z0, z1), then beta and beta -
// eps, in place.
__device__ __forceinline__ void theta_column(float g0, float g1, float z0,
                                             float z1, float eps_b, float wt,
                                             float eta0, float eta1,
                                             float eps, float& th0,
                                             float& th1, float& bet,
                                             float& bme) {
  const float t0 = th0, t1 = th1;
  float n0 = fabsf(t0 + eps_b / 2.f * (eta0 - t0 + wt * g0)
                   + sqrtf(eps_b * t0) * z0);
  float n1 = fabsf(t1 + eps_b / 2.f * (eta1 - t1 + wt * g1)
                   + sqrtf(eps_b * t1) * z1);
  n0 = fmaxf(n0, 1e-24f);
  n1 = fmaxf(n1, 1e-24f);
  th0 = n0;
  th1 = n1;
  bet = n1 / (n0 + n1);
  bme = bet - eps;
}

// Both modes: 8 bf16 values (one 16-byte load) widened to float32 into
// dst (16-byte aligned).
__device__ __forceinline__ void widen8(float* dst, const __nv_bfloat16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  const float2 e = __bfloat1622float2(h[2]);
  const float2 f = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(e.x, e.y, f.x, f.y);
}

// Both modes, the contrib of one column: acc = coef[b, :] . col and acc2 =
// coef[b2, :] . col over the n neighbors, the two chains of FMAs
// interleaved; 16-byte coefficient loads with coef4.
__device__ __forceinline__ void contrib_pair(const float* coef_a,
                                             const float* col, int b, int b2,
                                             int n, bool coef4, float& acc,
                                             float& acc2) {
  if (coef4) {
    const float4* cb = reinterpret_cast<const float4*>(coef_a + b * n);
    const float4* cb2 = reinterpret_cast<const float4*>(coef_a + b2 * n);
#pragma unroll
    for (int j4 = 0; j4 < kMaxNeighbors / 4; ++j4) {
      if (4 * j4 < n) {
        const float4 c = cb[j4], c2 = cb2[j4];
        acc += c.x * col[4 * j4];
        acc2 += c2.x * col[4 * j4];
        acc += c.y * col[4 * j4 + 1];
        acc2 += c2.y * col[4 * j4 + 1];
        acc += c.z * col[4 * j4 + 2];
        acc2 += c2.z * col[4 * j4 + 2];
        acc += c.w * col[4 * j4 + 3];
        acc2 += c2.w * col[4 * j4 + 3];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxNeighbors; ++j) {
      if (j < n) {
        acc += coef_a[b * n + j] * col[j];
        acc2 += coef_a[b2 * n + j] * col[j];
      }
    }
  }
}

template <typename PiT>
__global__ void __launch_bounds__(kThreads) window_kernel(Params<PiT> P) {
  constexpr bool kF32 = std::is_same<PiT, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_off[kLayoutFields];
#ifdef WINDOW_PHASES
  __shared__ unsigned long long s_phase[kPhases];
  long long t_last = clock64();
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int B = P.B, n = P.n, E = P.E, K = P.K, T = P.T, R = P.B + P.n;
  const int KW = P.kw;                      // slice width of the layout
  const int k0 = rank * KW;
  const int kw = min(K, k0 + KW) - k0;      // this CTA's columns
  const int ld = row_stride(KW);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float eps = P.eps;
  if (tid == 0) {
    const Layout L = layout(T, B, n, E, KW, S);
    const size_t* f = reinterpret_cast<const size_t*>(&L);
    for (int i = 0; i < kLayoutFields; ++i) s_off[i] = (unsigned)f[i];
#ifdef WINDOW_PHASES
    for (int i = 0; i < kPhases; ++i) s_phase[i] = 0;
#endif
  }

  // this cluster's chain: its block of pi and its slice of every operand
  // ([C, T, ...] chain-major; the offsets are taken where they are used)
  const size_t chain = blockIdx.x / S;
  const size_t TB = (size_t)T * B;
  PiT* const pi_c = P.pi + chain * P.N * K;
  float* const sum_c = P.phi_sum + chain * P.N;
  __syncthreads();

  // The window's indices, labels, masks and lane maps, once: ids and
  // codes as ints, the bool arrays as bits, the two lane maps packed.
  {
    stage_window(P, chain, k0, kw, SI(smc), SI(snodes), SI(snbrs),
                 SU(slanes), SU(ybits), SU(mbits), SU(yebits), SU(embits),
                 SM(th0), SM(th1), SM(bet), tid, warp, lane);
    // zero the columns past the slice once (both row buffers, and beta -
    // eps): the 16-byte loads of step 2 read them
    float* rows_a = SM(rows0);
    for (int i = tid; i < 2 * R * (ld - kw); i += kThreads)
      rows_a[(i / (ld - kw)) * ld + kw + i % (ld - kw)] = 0.f;
    for (int kk = tid; kk < (KW + 3) / 4 * 4; kk += kThreads)
      SM(bme)[kk] = kk < kw ? P.beta_in[chain * K + k0 + kk] - eps : 0.f;
  }
  __syncthreads();

  // The gather of step t into the buffers of parity p, asynchronously
  // (one group): this CTA's columns of the lanes whose row holds its
  // pre-window value, their phi sums, and the step's noise slices. A
  // warp copies rpp rows per pass, lane `sub` of them, chunks c0, c0 +
  // cstep, ... of it.
  const bool vec = (K % 4 == 0) && (KW % 4 == 0);
  const int width = vec ? 4 : 1;
  const int nchunk = (kw + width - 1) / width;
  const int rpp = nchunk < 32 ? 32 / nchunk : 1;
  const int sub = nchunk < 32 ? lane / nchunk : 0;
  const int c0 = nchunk < 32 ? lane - sub * nchunk : lane;
  const int cstep = nchunk < 32 ? nchunk : 32;
  auto copy = [&](float* dst, const float* src) {
    if (vec)
      cp_async16(dst, src);
    else
      cp_async4(dst, src);
  };
  // bf16 rows: 16-byte loads of 8 values where K and KW are multiples of
  // 8, else one value at a time, with the same warp-to-row mapping
  const bool vec8 = (K % 8 == 0) && (KW % 8 == 0);
  const int width8 = vec8 ? 8 : 1;
  const int nchunk8 = (kw + width8 - 1) / width8;
  const int rpp8 = nchunk8 < 32 ? 32 / nchunk8 : 1;
  const int sub8 = nchunk8 < 32 ? lane / nchunk8 : 0;
  const int c08 = nchunk8 < 32 ? lane - sub8 * nchunk8 : lane;
  const int cstep8 = nchunk8 < 32 ? nchunk8 : 32;
  auto gather = [&](int t, int p) {
    const int* mct = SI(smc) + t * R;
    const int* nd = SI(snodes) + t * B;
    const int* nb = SI(snbrs) + t * n;
    if constexpr (!kF32) {
      float* rbuf = p ? SM(rows1) : SM(rows0);
      if (sub8 < rpp8) {
        for (int r = warp * rpp8 + sub8; r < R; r += kWarps * rpp8) {
          if (mct[r] > 0) continue;
          const int id = r < B ? min(nd[r], P.N - 1) : nb[r - B];
          const PiT* src = pi_c + (size_t)id * K + k0;
          for (int c = c08; c < nchunk8; c += cstep8) {
            float* dst = rbuf + r * ld + c * width8;
            if (vec8) {
              widen8(dst, src + c * 8);
            } else {
              dst[0] = __bfloat162float(src[c]);
            }
          }
        }
      }
    }
    if (sub < rpp) {
      if constexpr (kF32) {
        float* rbuf = p ? SM(rows1) : SM(rows0);
        for (int r = warp * rpp + sub; r < R; r += kWarps * rpp) {
          if (mct[r] > 0) continue;   // staged in-window: read after the barrier
          // the sentinel N reads the chain's own last row (see the note)
          const int id = r < B ? min(nd[r], P.N - 1) : nb[r - B];
          const float* src = pi_c + (size_t)id * K + k0;
          for (int c = c0; c < nchunk; c += cstep)
            copy(rbuf + r * ld + c * width, src + c * width);
        }
      }
      float* nbuf = p ? SM(nz1) : SM(nz0);
      const float* noise_t = P.noise + (chain * T + t) * B * K + k0;
      for (int b = warp * rpp + sub; b < B; b += kWarps * rpp)
        for (int c = c0; c < nchunk; c += cstep)
          copy(nbuf + b * KW + c * width, noise_t + (size_t)b * K + c * width);
    }
    float* sbuf = p ? SM(phis1) : SM(phis0);
    for (int b = tid; b < B; b += kThreads)
      if (mct[b] == 0) cp_async4(sbuf + b, sum_c + min(nd[b], P.N - 1));
    float* bbuf = p ? SM(bz1) : SM(bz0);
    const float* bnoise_t = P.bnoise + (chain * T + t) * K * 2 + 2 * k0;
    for (int i = tid; i < (2 * kw) / width; i += kThreads)
      copy(bbuf + i * width, bnoise_t + i * width);
    cp_async_commit();
  };
  gather(0, 0);
  PHASE(0);

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
#ifdef WINDOW_PHASES
    // calibration: a bare block barrier and a bare cluster barrier
    __syncthreads();
    PHASE(11);
    cluster.sync();
    PHASE(12);
#endif
    // ---- 0. start step t+1's gather into the other buffers (free since
    //         the end of step t-1); redirect this step's reads of rows an
    //         earlier step wrote to the staged slice, one warp per row;
    //         then wait for this step's gather --------------------------
    if (t + 1 < T)
      gather(t + 1, par ^ 1);
    else
      cp_async_commit();   // an empty group keeps the wait below uniform
    float* const rows = par ? SM(rows1) : SM(rows0);
    float* const phis = par ? SM(phis1) : SM(phis0);
    {
      const int* mc = SI(smc) + t * R;
      const float* staged = SM(staged);
      for (int r = warp; r < R; r += kWarps) {
        const int c = mc[r];
        if (c == 0) continue;
        for (int kk = lane; kk < kw; kk += 32)
          rows[r * ld + kk] = staged[(size_t)(c - 1) * KW + kk];
      }
      const float* ssum = SM(ssum);
      for (int b = tid; b < B; b += kThreads)
        if (mc[b] > 0) phis[b] = ssum[mc[b] - 1];
    }
    cp_async_wait_older();
    __syncthreads();
    PHASE(1);

    // ---- 2. partial q = (pi_n * (beta - eps)) . pi_nb over the slice:
    //         lane j of a warp owns neighbor j, for up to kNodesPerWarp
    //         nodes at once (16-byte loads; the padding is zero). Node b's
    //         partials go to the CTA that owns it (b mod S), slot [rank,
    //         b / S, j] ------------------------------------------------------
    {
      const float4* bm4 = reinterpret_cast<const float4*>(SM(bme));
      float* const qin = SM(qin);
      const int nl = (B + S - 1) / S;
      for (int base = warp; base < B; base += kNodesPerWarp * kWarps) {
        for (int j = lane; j < n; j += 32) {
          const float4* pb = reinterpret_cast<const float4*>(rows + (B + j) * ld);
          float acc[kNodesPerWarp] = {};
          for (int k4 = 0; k4 < (kw + 3) / 4; ++k4) {
            const float4 v = pb[k4];
            const float4 bm = bm4[k4];
#pragma unroll
            for (int q = 0; q < kNodesPerWarp; ++q) {
              const int b = base + q * kWarps;
              if (b < B) {
                const float4 x = reinterpret_cast<const float4*>(rows + b * ld)[k4];
                acc[q] += (x.x * bm.x) * v.x;
                acc[q] += (x.y * bm.y) * v.y;
                acc[q] += (x.z * bm.z) * v.z;
                acc[q] += (x.w * bm.w) * v.w;
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kNodesPerWarp; ++q) {
            const int b = base + q * kWarps;
            if (b < B)
              cluster.map_shared_rank(qin, b % S)[(rank * nl + b / S) * n + j] = acc[q];
          }
        }
      }
    }
    cluster.sync();
    PHASE(2);

    // ---- 2b. each CTA finishes its own nodes (b mod S == rank, one warp
    //          per node): q summed over the ranks in order, the pair
    //          coefficients, the e/p sum, the mask count, 1/phi and
    //          N/n_valid, pushed to every CTA of the cluster -------------
    node_coefficients<false>(cluster, SM(qin), SU(ybits), SI(snodes) + t * B,
                      SI(snbrs) + t * n, phis, SM(coef), SM(ce), SM(nval),
                      SM(scale), SM(invphi), t, B, n, S, rank, warp, lane,
                      eps, P.one_minus_eps, P.n_nodes);
    cluster.sync();
    PHASE(3);

    // ---- 3. contrib and the phi SGRLD step on the slice: a thread owns
    //         column kk of a group of nodes and keeps that column of the
    //         neighbor rows in registers; two nodes at a time, so that two
    //         chains of FMAs interleave; phi' overwrites the node row -----
    {
      const float eps_t = P.eps_phi[t];
      const float* nz = par ? SM(nz1) : SM(nz0);
      const float* coef_a = SM(coef);
      const float* ce = SM(ce);
      const float* nval = SM(nval);
      const float* scale = SM(scale);
      const float* invphi = SM(invphi);
      const float* bme = SM(bme);
      const bool coef4 = (KW % 4 == 0) && (n % 4 == 0);
      const int groups = kThreads >= kw ? kThreads / kw : 1;
      const int grp0 = tid / kw;
      auto finish = [&](int b, int kk, float acc, float bk) {
        const float s_contrib = bk * acc + ce[b];
        const float grads = (s_contrib - nval[b]) * invphi[b];
        const float phi_k = rows[b * ld + kk] * phis[b];
        const float v = fabsf(phi_k
                              + eps_t / 2.f * (P.alpha - phi_k + scale[b] * grads)
                              + sqrtf(eps_t * phi_k) * nz[b * KW + kk]);
        rows[b * ld + kk] = fmaxf(v, 1e-24f);
      };
      for (int item = tid; item < kw * groups; item += kThreads) {
        const int grp = item == tid ? grp0 : item / kw;
        const int kk = item - grp * kw;
        float col[kMaxNeighbors];
#pragma unroll
        for (int j = 0; j < kMaxNeighbors; ++j)
          col[j] = j < n ? rows[(B + j) * ld + kk] : 0.f;
        const float bk = bme[kk];
        for (int b = grp; b < B; b += 2 * groups) {
          const int b2 = b + groups < B ? b + groups : b;   // b again: discarded
          float acc = 0.f, acc2 = 0.f;
          contrib_pair(coef_a, col, b, b2, n, coef4, acc, acc2);
          finish(b, kk, acc, bk);
          if (b2 != b) finish(b2, kk, acc2, bk);
        }
      }
    }
    __syncthreads();
    PHASE(4);

    // ---- 4. row sums of phi': the partial of each row (one warp per row)
    //         goes to every CTA, slot [rank, b] ----------------------------
    for (int b = warp; b < B; b += kWarps) {
      float acc = 0.f;
      for (int kk = lane; kk < kw; kk += 32) acc += rows[b * ld + kk];
      acc = warp_sum(acc);
      if (lane < S) cluster.map_shared_rank(SM(rin), lane)[rank * B + b] = acc;
    }
    cluster.sync();
    PHASE(5);

    // ---- 5. the row sums (ranks in order), normalize and stage, one warp
    //         per row; masked lanes read 1/K in the beta stage -------------
    {
      const float* rin = SM(rin);
      const unsigned* mbits = SU(mbits);
      float* staged = SM(staged) + (size_t)t * B * KW;
      float* ssum = SM(ssum) + (size_t)t * B;
      for (int b = warp; b < B; b += kWarps) {
        float rs = 0.f;
        for (int r = 0; r < S; ++r) rs += rin[r * B + b];
        const bool valid = bit(mbits, (size_t)t * B + b);
        for (int kk = lane; kk < kw; kk += 32) {
          const float v = rows[b * ld + kk] / rs;
          staged[b * KW + kk] = v;
          rows[b * ld + kk] = valid ? v : P.inv_k;
        }
        if (lane == 0) ssum[b] = rs;
      }
    }
    __syncthreads();
    PHASE(6);

    // ---- 6. per-edge sums: the partials of each edge (one warp per edge)
    //         go to every CTA, slot [rank, e] -----------------------------
    const unsigned* const slanes = SU(slanes) + t * E;
    const unsigned* const yebits = SU(yebits);
    {
      const float* bet = SM(bet);
      for (int e = warp; e < E; e += kWarps) {
        const unsigned pk = slanes[e];
        const float* pu = rows + (pk & 0xffffu) * ld;
        const float* pv = rows + (pk >> 16) * ld;
        const bool link = bit(yebits, (size_t)t * E + e);
        float s_pp = 0.f, s_pr = 0.f;
        for (int kk = lane; kk < kw; kk += 32) {
          const float pp = pu[kk] * pv[kk];
          s_pp += pp;
          s_pr += (link ? bet[kk] : 1.f - bet[kk]) * pp;
        }
        s_pp = warp_sum(s_pp);
        s_pr = warp_sum(s_pr);
        if (lane < S) {
          float* peer = cluster.map_shared_rank(SM(ein), lane);
          peer[(rank * E + e) * 2] = s_pp;
          peer[(rank * E + e) * 2 + 1] = s_pr;
        }
      }
    }
    cluster.sync();
    PHASE(7);

    // ---- 7. gradient fan-in: warp w takes the edges e = w mod kWarps
    // (their sums over the ranks in order) for lane-strided columns; then
    // one thread per column adds the kWarps partials in warp order and
    // takes the theta SGRLD step. Labels are exactly 0 or 1, so
    // (1-y)/theta0 and y/theta1 are exactly 0 or 1/theta: one division per
    // edge instead of three.
    {
      const unsigned* embits = SU(embits);
      const float* ein = SM(ein);
      const float* th0 = SM(th0);
      const float* th1 = SM(th1);
      const float* bet = SM(bet);
      float* gpart = SM(gpart);
      for (int kk = lane; kk < kw; kk += 32) {
        const float t0 = th0[kk], t1 = th1[kk], bk = bet[kk];
        const float inv_ts = 1.f / (t0 + t1);
        const float inv_t0 = 1.f / t0, inv_t1 = 1.f / t1;
        float g0 = 0.f, g1 = 0.f;
        for (int e = warp; e < E; e += kWarps) {
          const bool link = bit(yebits, (size_t)t * E + e);
          float s_pp = 0.f, s_pr = 0.f;
          for (int r = 0; r < S; ++r) {
            s_pp += ein[(r * E + e) * 2];
            s_pr += ein[(r * E + e) * 2 + 1];
          }
          const float prsum = s_pr + (link ? eps : P.one_minus_eps) * (1.f - s_pp);
          const float m = bit(embits, (size_t)t * E + e) ? 1.f : 0.f;
          const unsigned pk = slanes[e];
          const float pp = rows[(pk & 0xffffu) * ld + kk] * rows[(pk >> 16) * ld + kk];
          const float f = ((link ? bk : 1.f - bk) * pp) / prsum;
          g0 += (f * ((link ? 0.f : inv_t0) - inv_ts)) * m;
          g1 += (f * ((link ? inv_t1 : 0.f) - inv_ts)) * m;
        }
        gpart[(warp * KW + kk) * 2] = g0;
        gpart[(warp * KW + kk) * 2 + 1] = g1;
      }
    }
    __syncthreads();
    PHASE(8);
    {
      const float eps_b = P.eps_theta[t];
      const float wt = P.wts[chain * T + t];
      const float* bz = par ? SM(bz1) : SM(bz0);
      const float* gpart = SM(gpart);
      float* th0 = SM(th0);
      float* th1 = SM(th1);
      float* bet = SM(bet);
      float* bme = SM(bme);
      for (int kk = tid; kk < kw; kk += kThreads) {
        float g0 = 0.f, g1 = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          g0 += gpart[(w * KW + kk) * 2];
          g1 += gpart[(w * KW + kk) * 2 + 1];
        }
        theta_column(g0, g1, bz[2 * kk], bz[2 * kk + 1], eps_b, wt, P.eta0,
                     P.eta1, eps, th0[kk], th1[kk], bet[kk], bme[kk]);
      }
    }
    __syncthreads();
    PHASE(9);
  }

  // ---- 8. the scatter: the rows _last_write_wins keeps (unique rows; the
  //         CTAs own disjoint columns, so no address is written twice),
  //         their sums by CTA 0, theta and beta by slice. Every read of pi
  //         and phi_sum in this cluster came before the barriers above. --
  {
    const bool* keep = P.keep + chain * TB;
    const int* snodes = SI(snodes);
    const float* staged = SM(staged);
    for (int tb = warp; tb < T * B; tb += kWarps) {
      if (!keep[tb]) continue;
      PiT* dst = pi_c + (size_t)snodes[tb] * K + k0;
      for (int kk = lane; kk < kw; kk += 32)
        dst[kk] = to_store(staged[(size_t)tb * KW + kk], dst);
    }
    if (rank == 0) {
      const float* ssum = SM(ssum);
      for (int tb = tid; tb < T * B; tb += kThreads)
        if (keep[tb]) sum_c[snodes[tb]] = ssum[tb];
    }
    for (int kk = tid; kk < kw; kk += kThreads) {
      P.theta_out[chain * K * 2 + 2 * (k0 + kk)] = SM(th0)[kk];
      P.theta_out[chain * K * 2 + 2 * (k0 + kk) + 1] = SM(th1)[kk];
      P.beta_out[chain * K + k0 + kk] = SM(bet)[kk];
    }
  }
  // the peers may still be reading this CTA's last partials
  cluster.sync();
  PHASE(10);
#ifdef WINDOW_PHASES
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += s_phase[i];
#endif
}

#undef SM
#undef SU
#undef SI

// The wide mode's shared arrays, as SM / SU / SI above.
constexpr int kWideFields = sizeof(WideLayout) / sizeof(size_t);
#define WM(name) (smem + s_off[offsetof(WideLayout, name) / sizeof(size_t)])
#define WU(name) reinterpret_cast<unsigned*>(WM(name))
#define WI(name) reinterpret_cast<int*>(WM(name))

// The same window as window_kernel, for the shapes whose resident layout
// fits no cluster (the step rows [B+n, kw] and the staged slice [T*B, kw]
// grow with K): the staged rows go to a global scratch P.staged [C, T*B,
// K] that the wrapper allocates (6.5 MB at T=12, B=33, K=4096: it stays in
// the 50 MB L2), and each CTA takes its slice in chunks of wc columns.
// A CTA reads back only the columns it wrote itself, so the scratch needs
// no ordering across CTAs. Per step t:
//   a. per chunk: the step rows' chunk (pre-window rows from pi, rows an
//      earlier step wrote from the scratch) by cp.async, the next chunk
//      in flight while this one computes; the q partials accumulate over
//      the chunks in column order (the resident mode's order at the same
//      slice), then go to the nodes' owners;
//   b. the coefficients (node_coefficients, as in the resident mode);
//   c. per chunk: the rows and the phi noise again; contrib and the phi
//      step; phi' is written to the scratch and its row partials
//      accumulate; then the row-sum exchange;
//   d. per chunk: the staged rows normalized in place in the scratch and
//      copied (masked lanes as 1/K) to shared memory, the edge partials
//      accumulated; then the edge-sum exchange;
//   e. per chunk: the normalized rows again, the gradient fan-in over the
//      edges and the theta step of the chunk's columns.
// Sums over columns (q, the row sums, the edge sums) are taken in another
// order than the resident mode's, so the two modes agree to float32
// rounding, not bit for bit; the result does not depend on C. Their
// rounding is kept near a pairwise sum's, the plain version's: q in four
// sums per node (one per column mod 4) joined per chunk, the row and edge
// sums per lane over the chunks and then over the warp, and the ranks'
// partials pairwise (rank_sum) — at K = 4096 the row sums (phi_sum ~
// 2000) would otherwise round several ulps farther from float64.
template <typename PiT>
__global__ void __launch_bounds__(kThreads) window_kernel_wide(Params<PiT> P) {
  constexpr bool kF32 = std::is_same<PiT, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_off[kWideFields];
#ifdef WINDOW_PHASES
  __shared__ unsigned long long s_phase[kPhases];
  long long t_last = clock64();
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int B = P.B, n = P.n, E = P.E, K = P.K, T = P.T, R = P.B + P.n;
  const int KW = P.kw;
  const int k0 = rank * KW;
  const int kw = min(K, k0 + KW) - k0;
  const int WC = P.wc;
  const int ldc = row_stride(WC);
  const int nck = (kw + WC - 1) / WC;       // chunks of this CTA's slice
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float eps = P.eps;
  if (tid == 0) {
    const WideLayout L = layout_wide(T, B, n, E, KW, S, WC);
    const size_t* f = reinterpret_cast<const size_t*>(&L);
    for (int i = 0; i < kWideFields; ++i) s_off[i] = (unsigned)f[i];
#ifdef WINDOW_PHASES
    for (int i = 0; i < kPhases; ++i) s_phase[i] = 0;
#endif
  }
  const size_t chain = blockIdx.x / S;
  const size_t TB = (size_t)T * B;
  PiT* const pi_c = P.pi + chain * P.N * K;
  float* const sum_c = P.phi_sum + chain * P.N;
  // this CTA's columns of the chain's staged rows [T*B, K]
  float* const stg = P.staged + chain * TB * K + k0;
  __syncthreads();
  stage_window(P, chain, k0, kw, WI(smc), WI(snodes), WI(snbrs), WU(slanes),
               WU(ybits), WU(mbits), WU(yebits), WU(embits), WM(th0),
               WM(th1), WM(bet), tid, warp, lane);
  for (int kk = tid; kk < (KW + 3) / 4 * 4; kk += kThreads)
    WM(bme)[kk] = kk < kw ? P.beta_in[chain * K + k0 + kk] - eps : 0.f;
  __syncthreads();

  // The chunk c of step t (columns [c*WC, c*WC + cw) of the slice) into
  // the buffers of parity p, asynchronously (one group): every lane's
  // row, from pi when it holds its pre-window value, else from the
  // scratch; with `noise` the step's phi noise too. 16-byte copies where
  // K and kw are multiples of 4; else 4-byte copies, and the columns up
  // to the next multiple of 4 are zeroed (the q loop reads them).
  const bool vec = (K % 4 == 0) && (KW % 4 == 0);
  const bool vec8 = (K % 8 == 0) && (KW % 8 == 0);
  auto load_chunk = [&](int t, int c, int p, bool noise) {
    const int* mct = WI(smc) + t * R;
    const int* nd = WI(snodes) + t * B;
    const int* nb = WI(snbrs) + t * n;
    float* rbuf = p ? WM(ch1) : WM(ch0);
    const int c0 = c * WC;
    const int cw = min(WC, kw - c0);
    auto src_id = [&](int r) { return r < B ? min(nd[r], P.N - 1) : nb[r - B]; };
    if constexpr (!kF32) {
      // bf16 pre-window rows: synchronous loads widened to float32
      if (vec8) {
        const int nq = cw / 8;
        for (int i = tid; i < R * nq; i += kThreads) {
          const int r = i / nq, q = i - r * nq;
          if (mct[r] > 0) continue;
          widen8(rbuf + r * ldc + 8 * q,
                 pi_c + (size_t)src_id(r) * K + k0 + c0 + 8 * q);
        }
      } else {
        for (int i = tid; i < R * cw; i += kThreads) {
          const int r = i / cw, x = i - r * cw;
          if (mct[r] > 0) continue;
          rbuf[r * ldc + x] =
              __bfloat162float(pi_c[(size_t)src_id(r) * K + k0 + c0 + x]);
        }
      }
    }
    if (vec) {
      const int nq = cw / 4;
      for (int i = tid; i < R * nq; i += kThreads) {
        const int r = i / nq, q = i - r * nq;
        const int m = mct[r];
        float* dst = rbuf + r * ldc + 4 * q;
        if (m > 0)
          cp_async16(dst, stg + (size_t)(m - 1) * K + c0 + 4 * q);
        else if constexpr (kF32)
          cp_async16(dst, pi_c + (size_t)src_id(r) * K + k0 + c0 + 4 * q);
      }
    } else {
      const int cw4 = (cw + 3) / 4 * 4;
      for (int i = tid; i < R * cw4; i += kThreads) {
        const int r = i / cw4, x = i - r * cw4;
        const int m = mct[r];
        float* dst = rbuf + r * ldc + x;
        if (x >= cw)
          *dst = 0.f;
        else if (m > 0)
          cp_async4(dst, stg + (size_t)(m - 1) * K + c0 + x);
        else if constexpr (kF32)
          cp_async4(dst, pi_c + (size_t)src_id(r) * K + k0 + c0 + x);
      }
    }
    if (noise) {
      float* nbuf = p ? WM(nz1) : WM(nz0);
      const float* noise_t = P.noise + (chain * T + t) * B * K + k0 + c0;
      if (vec) {
        const int nq = cw / 4;
        for (int i = tid; i < B * nq; i += kThreads) {
          const int b = i / nq, q = i - b * nq;
          cp_async16(nbuf + b * WC + 4 * q, noise_t + (size_t)b * K + 4 * q);
        }
      } else {
        for (int i = tid; i < B * cw; i += kThreads) {
          const int b = i / cw, x = i - b * cw;
          cp_async4(nbuf + b * WC + x, noise_t + (size_t)b * K + x);
        }
      }
    }
    cp_async_commit();
  };
  // start chunk c + 1's copies (or an empty group), then wait for chunk c
  auto next_chunk = [&](int t, int c, bool noise) {
    if (c + 1 < nck)
      load_chunk(t, c + 1, (c + 1) & 1, noise);
    else
      cp_async_commit();
    cp_async_wait_older();
    __syncthreads();
  };
  PHASE(0);

  for (int t = 0; t < T; ++t) {
    const int* mct = WI(smc) + t * R;
    const int* nd = WI(snodes) + t * B;
    const unsigned* mbits = WU(mbits);
    float* const phis = WM(phis);
    // ---- a. q partials, chunk by chunk; the step's phi sums --------------
    load_chunk(t, 0, 0, false);
    for (int b = tid; b < B; b += kThreads)
      phis[b] = mct[b] > 0 ? WM(ssum)[mct[b] - 1] : sum_c[min(nd[b], P.N - 1)];
    {
      const float* bme = WM(bme);
      float* const qacc = WM(qacc);
      float* const qin = WM(qin);
      const int nl = (B + S - 1) / S;
      for (int c = 0; c < nck; ++c) {
        next_chunk(t, c, false);
        const float* rows = (c & 1) ? WM(ch1) : WM(ch0);
        const int c0 = c * WC;
        const int cw = min(WC, kw - c0);
        const float4* bm4 = reinterpret_cast<const float4*>(bme + c0);
        for (int base = warp; base < B; base += kNodesPerWarp * kWarps) {
          for (int j = lane; j < n; j += 32) {
            const float4* pb = reinterpret_cast<const float4*>(rows + (B + j) * ldc);
            // four sums per node, one per column mod 4, joined per chunk
            float4 acc[kNodesPerWarp] = {};
            for (int k4 = 0; k4 < (cw + 3) / 4; ++k4) {
              const float4 v = pb[k4];
              const float4 bm = bm4[k4];
#pragma unroll
              for (int q = 0; q < kNodesPerWarp; ++q) {
                const int b = base + q * kWarps;
                if (b < B) {
                  const float4 x = reinterpret_cast<const float4*>(rows + b * ldc)[k4];
                  acc[q].x += (x.x * bm.x) * v.x;
                  acc[q].y += (x.y * bm.y) * v.y;
                  acc[q].z += (x.z * bm.z) * v.z;
                  acc[q].w += (x.w * bm.w) * v.w;
                }
              }
            }
#pragma unroll
            for (int q = 0; q < kNodesPerWarp; ++q) {
              const int b = base + q * kWarps;
              if (b >= B) continue;
              const float part = (acc[q].x + acc[q].y) + (acc[q].z + acc[q].w);
              const float sum = c > 0 ? qacc[b * n + j] + part : part;
              if (c + 1 < nck)
                qacc[b * n + j] = sum;
              else
                cluster.map_shared_rank(qin, b % S)[(rank * nl + b / S) * n + j] = sum;
            }
          }
        }
        __syncthreads();
      }
    }
    cluster.sync();
    PHASE(2);

    // ---- b. the coefficients of this CTA's nodes, to every CTA -----------
    node_coefficients<true>(cluster, WM(qin), WU(ybits), nd, WI(snbrs) + t * n,
                      phis, WM(coef), WM(ce), WM(nval), WM(scale),
                      WM(invphi), t, B, n, S, rank, warp, lane, eps,
                      P.one_minus_eps, P.n_nodes);
    cluster.sync();
    PHASE(3);

    // ---- c. contrib and the phi step, chunk by chunk: phi' to the scratch
    //         and to the chunk's node rows, whose partial sums (one warp per
    //         row) accumulate; then pushed to every CTA -------------------
    float* const stg_t = stg + (size_t)t * B * K;
    {
      const float eps_t = P.eps_phi[t];
      const float* coef_a = WM(coef);
      const float* ce = WM(ce);
      const float* nval = WM(nval);
      const float* scale = WM(scale);
      const float* invphi = WM(invphi);
      float* const racc = WM(racc);
      const bool coef4 = (n % 4 == 0);
      load_chunk(t, 0, 0, true);
      for (int c = 0; c < nck; ++c) {
        next_chunk(t, c, true);
        float* const rows = (c & 1) ? WM(ch1) : WM(ch0);
        const float* nz = (c & 1) ? WM(nz1) : WM(nz0);
        const int c0 = c * WC;
        const int cw = min(WC, kw - c0);
        const float* bme = WM(bme) + c0;
        const int groups = kThreads >= cw ? kThreads / cw : 1;
        auto finish = [&](int b, int kk, float acc, float bk) {
          const float s_contrib = bk * acc + ce[b];
          const float grads = (s_contrib - nval[b]) * invphi[b];
          const float phi_k = rows[b * ldc + kk] * phis[b];
          const float v = fabsf(phi_k
                                + eps_t / 2.f * (P.alpha - phi_k + scale[b] * grads)
                                + sqrtf(eps_t * phi_k) * nz[b * WC + kk]);
          const float vf = fmaxf(v, 1e-24f);
          rows[b * ldc + kk] = vf;
          stg_t[(size_t)b * K + c0 + kk] = vf;
        };
        for (int item = tid; item < cw * groups; item += kThreads) {
          const int grp = item / cw;
          const int kk = item - grp * cw;
          float col[kMaxNeighbors];
#pragma unroll
          for (int j = 0; j < kMaxNeighbors; ++j)
            col[j] = j < n ? rows[(B + j) * ldc + kk] : 0.f;
          const float bk = bme[kk];
          for (int b = grp; b < B; b += 2 * groups) {
            const int b2 = b + groups < B ? b + groups : b;   // b again: discarded
            float acc = 0.f, acc2 = 0.f;
            contrib_pair(coef_a, col, b, b2, n, coef4, acc, acc2);
            finish(b, kk, acc, bk);
            if (b2 != b) finish(b2, kk, acc2, bk);
          }
        }
        __syncthreads();
        // each lane's columns of a row (one warp per row) accumulate over
        // the chunks
        for (int b = warp; b < B; b += kWarps) {
          float acc = c > 0 ? racc[b * 32 + lane] : 0.f;
          for (int kk = lane; kk < cw; kk += 32) acc += rows[b * ldc + kk];
          racc[b * 32 + lane] = acc;
        }
        __syncthreads();
      }
      for (int b = warp; b < B; b += kWarps) {
        const float rs = warp_sum(racc[b * 32 + lane]);
        if (lane < S) cluster.map_shared_rank(WM(rin), lane)[rank * B + b] = rs;
      }
    }
    cluster.sync();
    PHASE(5);

    // ---- d. the row sums (ranks in order); per chunk the staged rows
    //         normalized in place and copied to shared memory (masked lanes
    //         as 1/K), the edge partials (one warp per edge) accumulated;
    //         then pushed to every CTA ----------------------------------------
    const unsigned* const slanes = WU(slanes) + t * E;
    const unsigned* const yebits = WU(yebits);
    {
      const float* rin = WM(rin);
      float* const rsv = WM(rsv);
      float* const eacc = WM(eacc);
      for (int b = tid; b < B; b += kThreads) {
        const float rs = rank_sum(rin + b, B, S);
        rsv[b] = rs;
        WM(ssum)[t * B + b] = rs;
      }
      __syncthreads();
      float* const rows = WM(ch0);
      for (int c = 0; c < nck; ++c) {
        const int c0 = c * WC;
        const int cw = min(WC, kw - c0);
        for (int i = tid; i < B * cw; i += kThreads) {
          const int b = i / cw, x = i - b * cw;
          float* g = stg_t + (size_t)b * K + c0 + x;
          const float v = *g / rsv[b];
          *g = v;
          rows[b * ldc + x] = bit(mbits, (size_t)t * B + b) ? v : P.inv_k;
        }
        __syncthreads();
        const float* bet = WM(bet) + c0;
        for (int e = warp; e < E; e += kWarps) {
          const unsigned pk = slanes[e];
          const float* pu = rows + (pk & 0xffffu) * ldc;
          const float* pv = rows + (pk >> 16) * ldc;
          const bool link = bit(yebits, (size_t)t * E + e);
          float* acc = eacc + (e * 32 + lane) * 2;   // this lane's, over the chunks
          float s_pp = c > 0 ? acc[0] : 0.f, s_pr = c > 0 ? acc[1] : 0.f;
          for (int kk = lane; kk < cw; kk += 32) {
            const float pp = pu[kk] * pv[kk];
            s_pp += pp;
            s_pr += (link ? bet[kk] : 1.f - bet[kk]) * pp;
          }
          acc[0] = s_pp;
          acc[1] = s_pr;
        }
        __syncthreads();
      }
      for (int e = warp; e < E; e += kWarps) {
        const float s_pp = warp_sum(eacc[(e * 32 + lane) * 2]);
        const float s_pr = warp_sum(eacc[(e * 32 + lane) * 2 + 1]);
        if (lane < S) {
          float* peer = cluster.map_shared_rank(WM(ein), lane);
          peer[(rank * E + e) * 2] = s_pp;
          peer[(rank * E + e) * 2 + 1] = s_pr;
        }
      }
    }
    cluster.sync();
    PHASE(7);

    // ---- e. per edge the sums over the ranks in order; per chunk the
    //         normalized rows again, the gradient fan-in (warp w takes the
    //         edges e = w mod kWarps for lane-strided columns, then one
    //         thread per column adds the kWarps partials in warp order) and
    //         the theta step ---------------------------------------------------
    {
      const unsigned* embits = WU(embits);
      const float* ein = WM(ein);
      float* const epr = WM(epr);
      for (int e = tid; e < E; e += kThreads) {
        const float s_pp = rank_sum(ein + 2 * e, 2 * E, S);
        const float s_pr = rank_sum(ein + 2 * e + 1, 2 * E, S);
        const bool link = bit(yebits, (size_t)t * E + e);
        epr[e] = s_pr + (link ? eps : P.one_minus_eps) * (1.f - s_pp);
      }
      const float eps_b = P.eps_theta[t];
      const float wt = P.wts[chain * T + t];
      const float* bnoise_t = P.bnoise + (chain * T + t) * K * 2 + 2 * k0;
      float* const rows = WM(ch0);
      float* const gpart = WM(gpart);
      for (int c = 0; c < nck; ++c) {
        const int c0 = c * WC;
        const int cw = min(WC, kw - c0);
        for (int i = tid; i < B * cw; i += kThreads) {
          const int b = i / cw, x = i - b * cw;
          rows[b * ldc + x] = bit(mbits, (size_t)t * B + b)
                                  ? stg_t[(size_t)b * K + c0 + x] : P.inv_k;
        }
        __syncthreads();
        float* const th0 = WM(th0) + c0;
        float* const th1 = WM(th1) + c0;
        float* const bet = WM(bet) + c0;
        for (int kk = lane; kk < cw; kk += 32) {
          const float t0 = th0[kk], t1 = th1[kk], bk = bet[kk];
          const float inv_ts = 1.f / (t0 + t1);
          const float inv_t0 = 1.f / t0, inv_t1 = 1.f / t1;
          float g0 = 0.f, g1 = 0.f;
          for (int e = warp; e < E; e += kWarps) {
            const bool link = bit(yebits, (size_t)t * E + e);
            const float prsum = epr[e];
            const float m = bit(embits, (size_t)t * E + e) ? 1.f : 0.f;
            const unsigned pk = slanes[e];
            const float pp = rows[(pk & 0xffffu) * ldc + kk] * rows[(pk >> 16) * ldc + kk];
            const float f = ((link ? bk : 1.f - bk) * pp) / prsum;
            g0 += (f * ((link ? 0.f : inv_t0) - inv_ts)) * m;
            g1 += (f * ((link ? inv_t1 : 0.f) - inv_ts)) * m;
          }
          gpart[(warp * WC + kk) * 2] = g0;
          gpart[(warp * WC + kk) * 2 + 1] = g1;
        }
        __syncthreads();
        float* const bme = WM(bme) + c0;
        for (int kk = tid; kk < cw; kk += kThreads) {
          float g0 = 0.f, g1 = 0.f;
          for (int w = 0; w < kWarps; ++w) {
            g0 += gpart[(w * WC + kk) * 2];
            g1 += gpart[(w * WC + kk) * 2 + 1];
          }
          theta_column(g0, g1, bnoise_t[2 * (c0 + kk)],
                       bnoise_t[2 * (c0 + kk) + 1], eps_b, wt, P.eta0,
                       P.eta1, eps, th0[kk], th1[kk], bet[kk], bme[kk]);
        }
        __syncthreads();
      }
    }
    PHASE(9);
  }

  // ---- the scatter: the kept rows from the scratch (each CTA its own
  //      columns), their sums by CTA 0, theta and beta by slice -------------
  {
    const bool* keep = P.keep + chain * TB;
    const int* snodes = WI(snodes);
    for (int tb = warp; tb < T * B; tb += kWarps) {
      if (!keep[tb]) continue;
      PiT* dst = pi_c + (size_t)snodes[tb] * K + k0;
      const float* src = stg + (size_t)tb * K;
      for (int kk = lane; kk < kw; kk += 32) dst[kk] = to_store(src[kk], dst);
    }
    if (rank == 0) {
      const float* ssum = WM(ssum);
      for (int tb = tid; tb < T * B; tb += kThreads)
        if (keep[tb]) sum_c[snodes[tb]] = ssum[tb];
    }
    for (int kk = tid; kk < kw; kk += kThreads) {
      P.theta_out[chain * K * 2 + 2 * (k0 + kk)] = WM(th0)[kk];
      P.theta_out[chain * K * 2 + 2 * (k0 + kk) + 1] = WM(th1)[kk];
      P.beta_out[chain * K + k0 + kk] = WM(bet)[kk];
    }
  }
  // the peers may still be reading this CTA's last partials
  cluster.sync();
  PHASE(10);
#ifdef WINDOW_PHASES
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += s_phase[i];
#endif
}

#undef WM
#undef WU
#undef WI

// The kernel of a mode: the resident one, or with a chunk width the wide.
template <typename PiT>
using KernelFn = void (*)(Params<PiT>);

template <typename PiT>
KernelFn<PiT> kernel_of(int wc) {
  return wc > 0 ? window_kernel_wide<PiT> : window_kernel<PiT>;
}

// Sets a kernel's shared memory (and, past 8, the non-portable cluster
// size) attributes.
template <typename PiT>
cudaError_t set_attributes(KernelFn<PiT> fn, int S, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && S > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Launches C clusters of S CTAs of the mode's kernel.
template <typename PiT>
cudaError_t launch(const Params<PiT>& P, int C, int S, size_t smem,
                   cudaStream_t stream) {
  const KernelFn<PiT> fn = kernel_of<PiT>(P.wc);
  cudaError_t err = set_attributes<PiT>(fn, S, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename PiT>
Params<PiT> make_params(void* pi, float* phi_sum, const bool* y,
                        const int* nodes, const int* nbrs,
                        const bool* node_mask, const bool* keep,
                        const float* noise, const float* bnoise,
                        const bool* y_edges, const bool* edge_mask,
                        const int* lanes_u, const int* lanes_v,
                        const int* mcode, const float* wts,
                        const float* theta_in, const float* beta_in,
                        float* theta_out, float* beta_out, float* staged,
                        int T, int B, int n, int E, int K, int N, int kw,
                        int wc, float eps, float one_minus_eps, float alpha,
                        float n_nodes, float eta0, float eta1, float inv_k,
                        const float* eps_phi, const float* eps_theta) {
  Params<PiT> P{static_cast<PiT*>(pi), phi_sum, y, nodes, nbrs, node_mask,
                keep, noise, bnoise, y_edges, edge_mask, lanes_u, lanes_v,
                mcode, wts, theta_in, beta_in, theta_out, beta_out, staged,
                T, B, n, E, K, N, kw, wc, eps, one_minus_eps, alpha, n_nodes,
                eta0, eta1, inv_k, {}, {}};
  for (int t = 0; t < T; ++t) {
    P.eps_phi[t] = eps_phi[t];
    P.eps_theta[t] = eps_theta[t];
  }
  return P;
}

}  // namespace

// Bytes of shared memory per CTA with a cluster of S CTAs (either storage
// type): the resident mode's (wc = 0) or the wide mode's with chunks of wc
// columns.
extern "C" size_t window_kernel_smem_bytes(int T, int B, int n, int E, int K,
                                           int S, int wc) {
  const int kw = slice_width(K, S);
  return (wc > 0 ? layout_wide(T, B, n, E, kw, S, wc).total
                 : layout(T, B, n, E, kw, S).total) * sizeof(float);
}

// Launches C clusters of S CTAs (one cluster per chain) on `stream`;
// returns the launch's CUDA error (0 on success). pi [C*N, K] (float32,
// or bfloat16 when pi_bf16 is 1) and phi_sum [C*N] (float32) are updated
// in place; every operand holds the C chains' slices one after another
// (chain-major); `eps_phi` and `eps_theta` are host arrays of T floats,
// shared by the chains. wc = 0 runs the resident mode; wc > 0 (a
// multiple of 8) the wide mode, whose staged rows go to `staged`, a
// float32 scratch [C, T*B, K] (unused and may be null when wc = 0).
extern "C" int window_kernel_launch(
    void* pi, float* phi_sum, const bool* y, const int* nodes,
    const int* nbrs, const bool* node_mask, const bool* keep,
    const float* noise, const float* bnoise, const bool* y_edges,
    const bool* edge_mask, const int* lanes_u, const int* lanes_v,
    const int* mcode, const float* wts, const float* theta_in,
    const float* beta_in, float* theta_out, float* beta_out, float* staged,
    int C, int T, int B, int n, int E, int K, int N, int S, int wc,
    int pi_bf16, float eps, float one_minus_eps, float alpha, float n_nodes,
    float eta0, float eta1, float inv_k, const float* eps_phi,
    const float* eps_theta, void* stream) {
  // lanes are packed in 16 bits each
  if (C < 1 || T < 1 || T > kMaxWindow || n > kMaxNeighbors || S < 1
      || S > kMaxCluster || B > 0xffff || (pi_bf16 != 0 && pi_bf16 != 1)
      || wc < 0 || wc % 8 != 0 || (wc > 0 && staged == nullptr))
    return (int)cudaErrorInvalidValue;
  const int kw = slice_width(K, S);
  if ((S - 1) * kw >= K) return (int)cudaErrorInvalidValue;  // empty slice
  const size_t smem = window_kernel_smem_bytes(T, B, n, E, K, S, wc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WINDOW_PARAMS(PiT)                                                  \
  make_params<PiT>(pi, phi_sum, y, nodes, nbrs, node_mask, keep, noise,    \
                   bnoise, y_edges, edge_mask, lanes_u, lanes_v, mcode, wts, \
                   theta_in, beta_in, theta_out, beta_out, staged, T, B, n, \
                   E, K, N, kw, wc, eps, one_minus_eps, alpha, n_nodes,     \
                   eta0, eta1, inv_k, eps_phi, eps_theta)
  const cudaError_t err =
      pi_bf16 ? launch(WINDOW_PARAMS(__nv_bfloat16), C, S, smem, st)
              : launch(WINDOW_PARAMS(float), C, S, smem, st);
#undef WINDOW_PARAMS
  return (int)err;
}

// The most clusters of S CTAs (with their shared memory) that the card
// runs at once in the mode of `wc`, or a negative CUDA error (the float32
// instantiation).
extern "C" int window_kernel_max_clusters(int T, int B, int n, int E, int K,
                                          int S, int wc) {
  const size_t smem = window_kernel_smem_bytes(T, B, n, E, K, S, wc);
  const KernelFn<float> fn = kernel_of<float>(wc);
  cudaError_t err = set_attributes<float>(fn, S, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

#ifdef WINDOW_PHASES
// Copies the phase cycles out (kPhases values) and zeroes them.
extern "C" int window_kernel_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
