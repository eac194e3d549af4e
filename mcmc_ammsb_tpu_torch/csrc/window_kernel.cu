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
// single-chain launches. The one exception is the grid layout, which only
// the single-chain entry takes: one chain's columns over as many clusters
// as the card holds at once (window_kernel_grid).
//
// Two modes, one function. The resident mode (window_kernel) keeps a
// CTA's whole slice of the step rows and of the window's staged rows in
// shared memory; it is chosen wherever that fits. The wide mode stages
// the rows in a global scratch, in one of five layouts, each described
// above its kernel: the step layout (window_kernel_step) keeps a step's
// rows in shared memory through all its stages, with the next step's rows
// in flight by bulk copies in a second set of buffers, wherever that fits
// (T = 12 up to K = 4096 on an H100); the step layout with one set of
// rows (window_kernel_step1) gathers the next step's rows into the one
// set as its regions free up (T = 12 at K = 6144-8192); the node-resident
// layout (window_kernel_nodes) keeps a step's node rows and streams its
// neighbor rows in tiles (K = 10240-16384 at T = 12 in the flat chain
// engine, and where the card holds too few CTAs at once for the grid
// layout); the grid layout (window_kernel_grid) spreads one chain's
// window over the whole card, its sums exchanged across clusters through
// L2 (one chain at T = 12, K = 10240-16384); the chunked layout
// (window_kernel_wide) takes the slice in column chunks, so its shared
// memory hardly grows with K (where none of the others fits: T >= 23 at
// K = 16384). window_layout.h lays out the shared memory of each. What
// follows describes the resident mode.
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

#include "window_layout.h"

namespace cg = cooperative_groups;

namespace {

// q is computed for up to this many nodes per warp in one pass, so each
// neighbor-row load serves several nodes.
constexpr int kNodesPerWarp = 3;

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The step layout's bulk copies (Hopper's 1-D TMA): completion is counted
// in bytes on an mbarrier of the CTA.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// The one arrival of a phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to this CTA's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar)) : "memory");
}

// Orders this thread's earlier generic accesses to shared memory before
// its later bulk copies (the async proxy) into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Asks for the 128-byte line of global memory at p to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];\n" :: "l"(p));
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
  float* staged;           // [T*B, K] wide mode's staged rows (the grid
                           // layout's L2 exchange after them); else unused
  int T, B, n, E, K, N, kw;
  int wc;                  // wide mode's chunk or tile width (the grid
                           // layout's slice width); 0 in the resident mode
  int mode;                // the layout (Mode)
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

// A kept value as pi stores it, four at a time (16 or 8 bytes, aligned).
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(dst) = u;
}

// The wide mode's scatter: the rows _last_write_wins keeps, from the
// scratch (this CTA's columns, stg) into pi (pi_k0 = the CTA's first
// column of the chain's block). With 16-byte rows a warp takes eight
// rows at a time, every lane a float4 of each, so that eight loads from
// L2 are in flight; else one warp per row, one value at a time.
template <typename PiT>
__device__ __forceinline__ void scatter_kept(PiT* pi_k0, const float* stg,
                                             const bool* keep,
                                             const int* snodes, int TB,
                                             int K, int kw, bool vec,
                                             int warp, int lane) {
  if (vec) {
    constexpr int kRows = 8;
    const int nq = kw / 4;
    for (int tb0 = warp * kRows; tb0 < TB; tb0 += kRows * kWarps) {
      for (int q = lane; q < nq; q += 32) {
        float4 v[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          v[u] = *reinterpret_cast<const float4*>(
              stg + (size_t)min(tb0 + u, TB - 1) * K + 4 * q);
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (tb0 + u < TB && keep[tb0 + u])
            store4(pi_k0 + (size_t)snodes[tb0 + u] * K + 4 * q, v[u]);
      }
    }
  } else {
    for (int tb = warp; tb < TB; tb += kWarps) {
      if (!keep[tb]) continue;
      PiT* dst = pi_k0 + (size_t)snodes[tb] * K;
      const float* src = stg + (size_t)tb * K;
      for (int kk = lane; kk < kw; kk += 32) dst[kk] = to_store(src[kk], dst);
    }
  }
}

// Every mode, stage 2b of step t: each CTA finishes its own nodes (b mod
// S == rank, one warp per node): q of its lb-th node and neighbor j from
// qsum(lb, j), the pair coefficients, the e/p sum, the mask count, 1/phi
// and N/n_valid, pushed to every CTA of the cluster (the arrays are this
// CTA's; the peers' copies sit at the same offsets).
template <typename QSum>
__device__ __forceinline__ void node_coefficients_of(
    cg::cluster_group& cluster, QSum qsum, const unsigned* ybits,
    const int* nd, const int* nb, const float* phis, float* coef, float* ce,
    float* nval, float* scale, float* invphi, int t, int B, int n, int S,
    int rank, int warp, int lane, float eps, float one_minus_eps,
    float n_nodes) {
  const size_t ybase = (size_t)t * B * n;
  for (int lb = warp; lb * S + rank < B; lb += kWarps) {
    const int b = lb * S + rank;
    float s_ce = 0.f, s_n = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float q = qsum(lb, j);
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

// The cluster modes' stage 2b: node_coefficients_of with q summed over
// the ranks from qin [S, ceil(B/S), n] (in order; pairwise with
// kPairwise, the wide mode).
template <bool kPairwise>
__device__ __forceinline__ void node_coefficients(
    cg::cluster_group& cluster, const float* qin, const unsigned* ybits,
    const int* nd, const int* nb, const float* phis, float* coef, float* ce,
    float* nval, float* scale, float* invphi, int t, int B, int n, int S,
    int rank, int warp, int lane, float eps, float one_minus_eps,
    float n_nodes) {
  const int nl = (B + S - 1) / S;
  node_coefficients_of(
      cluster,
      [&](int lb, int j) {
        float q = 0.f;
        if (kPairwise)
          q = rank_sum(qin + lb * n + j, nl * n, S);
        else
          for (int r = 0; r < S; ++r) q += qin[(r * nl + lb) * n + j];
        return q;
      },
      ybits, nd, nb, phis, coef, ce, nval, scale, invphi, t, B, n, S, rank,
      warp, lane, eps, one_minus_eps, n_nodes);
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
//      step; phi' is written to the scratch, and its row partials and the
//      edge partials accumulate: s_pp and s_pr are bilinear in the two
//      endpoint rows, so they are taken on phi' as it is (a masked
//      endpoint as 1/K) and divided by the endpoints' row sums after the
//      exchange; then one exchange of both;
//   e. per chunk: phi' from the scratch again (the next chunk in flight),
//      normalized in shared memory and written back (masked lanes as 1/K
//      in shared memory), the gradient fan-in over the edges and the theta
//      step of the chunk's columns.
// Three cluster barriers a step: after a, b and c. Sums over columns (q,
// the row sums, the edge sums) are taken in another order than the
// resident mode's, so the two modes agree to float32 rounding, not bit for
// bit; the result does not depend on C. Their rounding is kept near a
// pairwise sum's, the plain version's: q in four sums per node (one per
// column mod 4) joined per chunk, the row and edge sums per lane over the
// chunks and then over the warp, and the ranks' partials pairwise
// (rank_sum) — at K = 4096 the row sums (phi_sum ~ 2000) would otherwise
// round several ulps farther from float64.
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
    //         and to the chunk's node rows, whose row partials (one warp
    //         per row) and edge partials (one warp per edge) accumulate;
    //         then both pushed to every CTA ---------------------------------
    float* const stg_t = stg + (size_t)t * B * K;
    const unsigned* const slanes = WU(slanes) + t * E;
    const unsigned* const yebits = WU(yebits);
    float* const eacc = WM(eacc);
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
        // and each lane's edge partials (one warp per edge) over phi' as
        // it is, masked endpoints as 1/K: the sums are bilinear in the
        // two rows, so stage e scales them by the row sums
        const float* bet = WM(bet) + c0;
        for (int e = warp; e < E; e += kWarps) {
          const unsigned pk = slanes[e];
          const int u = pk & 0xffffu, v = pk >> 16;
          const bool vu = bit(mbits, (size_t)t * B + u);
          const bool vv = bit(mbits, (size_t)t * B + v);
          const float* pu = rows + u * ldc;
          const float* pv = rows + v * ldc;
          const bool link = bit(yebits, (size_t)t * E + e);
          float* acc = eacc + (e * 32 + lane) * 2;   // this lane's, over the chunks
          float s_pp = c > 0 ? acc[0] : 0.f, s_pr = c > 0 ? acc[1] : 0.f;
          for (int kk = lane; kk < cw; kk += 32) {
            const float pp = (vu ? pu[kk] : P.inv_k) * (vv ? pv[kk] : P.inv_k);
            s_pp += pp;
            s_pr += (link ? bet[kk] : 1.f - bet[kk]) * pp;
          }
          acc[0] = s_pp;
          acc[1] = s_pr;
        }
        __syncthreads();
      }
      // the row and the edge partials to every CTA: one exchange
      for (int b = warp; b < B; b += kWarps) {
        const float rs = warp_sum(racc[b * 32 + lane]);
        if (lane < S) cluster.map_shared_rank(WM(rin), lane)[rank * B + b] = rs;
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
    PHASE(5);

    // ---- e. the row sums (ranks pairwise); per edge the sums over the
    //         ranks (pairwise), divided by the endpoints' row sums (a masked
    //         endpoint's by 1), and prsum; per chunk the staged rows from
    //         the scratch (the next chunk in flight), normalized in shared
    //         memory and written back (masked lanes as 1/K in shared
    //         memory), the gradient fan-in (warp w takes the edges e = w
    //         mod kWarps for lane-strided columns, then one thread per
    //         column adds the kWarps partials in warp order) and the theta
    //         step ----------------------------------------------------------
    {
      const unsigned* embits = WU(embits);
      const float* ein = WM(ein);
      float* const rsv = WM(rsv);
      float* const epr = WM(epr);
      for (int b = tid; b < B; b += kThreads) {
        const float rs = rank_sum(WM(rin) + b, B, S);
        rsv[b] = rs;
        WM(ssum)[t * B + b] = rs;
      }
      __syncthreads();
      for (int e = tid; e < E; e += kThreads) {
        const unsigned pk = slanes[e];
        const int u = pk & 0xffffu, v = pk >> 16;
        const float du = bit(mbits, (size_t)t * B + u) ? rsv[u] : 1.f;
        const float dv = bit(mbits, (size_t)t * B + v) ? rsv[v] : 1.f;
        const float s_pp = rank_sum(ein + 2 * e, 2 * E, S) / (du * dv);
        const float s_pr = rank_sum(ein + 2 * e + 1, 2 * E, S) / (du * dv);
        const bool link = bit(yebits, (size_t)t * E + e);
        epr[e] = s_pr + (link ? eps : P.one_minus_eps) * (1.f - s_pp);
      }
      const float eps_b = P.eps_theta[t];
      const float wt = P.wts[chain * T + t];
      const float* bnoise_t = P.bnoise + (chain * T + t) * K * 2 + 2 * k0;
      float* const gpart = WM(gpart);
      // chunk c of the step's staged rows into the buffers of parity p
      // (one cp.async group)
      auto load_staged = [&](int c, int p) {
        float* rbuf = p ? WM(ch1) : WM(ch0);
        const int c0 = c * WC;
        const int cw = min(WC, kw - c0);
        if (vec) {
          const int nq = cw / 4;
          for (int i = tid; i < B * nq; i += kThreads) {
            const int b = i / nq, q = i - b * nq;
            cp_async16(rbuf + b * ldc + 4 * q, stg_t + (size_t)b * K + c0 + 4 * q);
          }
        } else {
          for (int i = tid; i < B * cw; i += kThreads) {
            const int b = i / cw, x = i - b * cw;
            cp_async4(rbuf + b * ldc + x, stg_t + (size_t)b * K + c0 + x);
          }
        }
        cp_async_commit();
      };
      load_staged(0, 0);
      for (int c = 0; c < nck; ++c) {
        if (c + 1 < nck)
          load_staged(c + 1, (c + 1) & 1);
        else
          cp_async_commit();
        cp_async_wait_older();
        __syncthreads();
        float* const rows = (c & 1) ? WM(ch1) : WM(ch0);
        const int c0 = c * WC;
        const int cw = min(WC, kw - c0);
        for (int i = tid; i < B * cw; i += kThreads) {
          const int b = i / cw, x = i - b * cw;
          const float v = rows[b * ldc + x] / rsv[b];
          stg_t[(size_t)b * K + c0 + x] = v;
          rows[b * ldc + x] = bit(mbits, (size_t)t * B + b) ? v : P.inv_k;
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

  // ---- the scatter, theta and beta (finish_wide) ------------------------
  finish_wide(P, chain, pi_c, sum_c, stg, WI(snodes), WM(ssum), WM(th0),
              WM(th1), WM(bet), k0, kw, vec, rank, tid, warp, lane);
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

// ---------------------------------------------------------------------------
// Stages that the two step layouts share (window_kernel_step and
// window_kernel_step1): the same arithmetic in the same order, on a CTA's
// slice of a step's rows in shared memory (rows [R, ld], the node rows
// first).
// ---------------------------------------------------------------------------

// Stage c: contrib and the phi step on the columns [c0, c0 + cw) of the
// slice, register-tiled: a thread takes kCNodes nodes for four columns (a
// float4 of each neighbor row, one coefficient load per node and four
// neighbors), the sums over the neighbors in order; phi' overwrites the
// node rows (rows [B, ld]). The neighbor rows are nbr [n, ldn], at the
// same columns (the step layouts: the rows after the node rows, c0 = 0,
// cw = kw; the node-resident layout: a tile). noise(b, q4) is node b's
// phi noise at the slice's float4 column q4. With kJ = 2 two lanes share
// an item, each over half the neighbors (a multiple of 4 first), their
// sums joined by one shuffle (a + b and b + a are the same bits), and
// each finishes every other node: twice the threads on a narrow tile.
template <int kJ, typename Noise>
__device__ __forceinline__ void step_contrib(
    float* rows, int ld, const float* nbr, int ldn, int c0, int cw, int kw,
    int B, int n, const float* coef_a, const float* ce, const float* nval,
    const float* scale, const float* invphi, const float* phis,
    const float* bme, float eps_t, float alpha, int tid, Noise noise) {
  static_assert(kJ == 1 || kJ == 2, "one or two lanes per item");
  const int q0 = c0 / 4;
  const float4* bm4 = reinterpret_cast<const float4*>(bme) + q0;
  const float4* nb4 = reinterpret_cast<const float4*>(nbr);
  const int nq4 = (cw + 3) / 4, ld4 = ld / 4, ldn4 = ldn / 4;
  const int groups = (B + kCNodes - 1) / kCNodes;
  float4* const rows4 = reinterpret_cast<float4*>(rows);
  const int half = kJ == 1 ? 0 : tid & 1;
  const int jh = kJ == 1 ? n : ((n + 1) / 2 + 3) / 4 * 4;
  const int j_lo = half ? jh : 0, j_hi = half ? n : min(jh, n);
  // item (g, q4): nodes g * kCNodes ... of float4 column q4 (a dead lane
  // of kJ = 2's last pass takes the last item and stores nothing)
  auto item_of = [&](int item, bool live) {
    const int it = live ? item : groups * nq4 - 1;
    const int g = it / nq4, q4 = it - g * nq4;
    const int b0 = g * kCNodes, nb = min(kCNodes, B - b0);
    // kJ = 2: this lane's nodes' noise, loaded before the sums so that
    // its latency hides behind them
    float4 zs[(kCNodes + 1) / 2];
    if constexpr (kJ == 2) {
#pragma unroll
      for (int m = 0; m < (kCNodes + 1) / 2; ++m)
        zs[m] = noise(b0 + min(2 * m + half, nb - 1), q0 + q4);
    }
    float4 acc[kCNodes];
#pragma unroll
    for (int i = 0; i < kCNodes; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j4 = j_lo; j4 < j_hi; j4 += 4) {
      float4 v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[jj] = nb4[min(j4 + jj, n - 1) * ldn4 + q4];
#pragma unroll
      for (int i = 0; i < kCNodes; ++i) {
        // a short group repeats its last node, which is not stored
        const float* cb = coef_a + (b0 + min(i, nb - 1)) * n + j4;
        float c[4];
        if (n % 4 == 0) {
          const float4 c4 = *reinterpret_cast<const float4*>(cb);
          c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) c[jj] = j4 + jj < n ? cb[jj] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i].x += c[jj] * v[jj].x;
          acc[i].y += c[jj] * v[jj].y;
          acc[i].z += c[jj] * v[jj].z;
          acc[i].w += c[jj] * v[jj].w;
        }
      }
    }
    if constexpr (kJ == 2) {
#pragma unroll
      for (int i = 0; i < kCNodes; ++i) {
        acc[i].x += __shfl_xor_sync(0xffffffffu, acc[i].x, 1);
        acc[i].y += __shfl_xor_sync(0xffffffffu, acc[i].y, 1);
        acc[i].z += __shfl_xor_sync(0xffffffffu, acc[i].z, 1);
        acc[i].w += __shfl_xor_sync(0xffffffffu, acc[i].w, 1);
      }
    }
    if (!live) return;
    const int qc = q0 + q4;   // the float4 column in the slice
    const float4 bk = bm4[q4];
#pragma unroll
    for (int i = 0; i < kCNodes; ++i) {
      if (i >= nb) break;
      if (kJ == 2 && (i & 1) != half) continue;
      const int b = b0 + i;
      const float n_ce = ce[b], n_val = nval[b], n_inv = invphi[b];
      const float n_scale = scale[b], n_phis = phis[b];
      const float4 x = rows4[b * ld4 + qc];
      const float4 z = kJ == 2 ? zs[i >> 1] : noise(b, qc);
      auto step = [&](float a, float bkk, float xk, float zk) {
        const float s_contrib = bkk * a + n_ce;
        const float grads = (s_contrib - n_val) * n_inv;
        const float phi_k = xk * n_phis;
        const float vv = fabsf(phi_k
                               + eps_t / 2.f * (alpha - phi_k + n_scale * grads)
                               + sqrtf(eps_t * phi_k) * zk);
        return fmaxf(vv, 1e-24f);
      };
      const float4 out = make_float4(step(acc[i].x, bk.x, x.x, z.x),
                                     step(acc[i].y, bk.y, x.y, z.y),
                                     step(acc[i].z, bk.z, x.z, z.z),
                                     step(acc[i].w, bk.w, x.w, z.w));
      if (4 * qc + 4 <= kw) {
        rows4[b * ld4 + qc] = out;
      } else {   // the ragged end of the slice: its pad stays zero
        float* r = rows + b * ld + 4 * qc;
        if (4 * qc + 0 < kw) r[0] = out.x;
        if (4 * qc + 1 < kw) r[1] = out.y;
        if (4 * qc + 2 < kw) r[2] = out.z;
      }
    }
  };
  if constexpr (kJ == 1) {
    for (int item = tid; item < groups * nq4; item += kThreads)
      item_of(item, true);
  } else {
    // every lane of a warp stays in the loop for the shuffles; a lane
    // pair shares one item
    for (int base = tid & ~31; base < 2 * groups * nq4; base += kThreads) {
      const int item = (base + (tid & 31)) >> 1;
      item_of(item, item < groups * nq4);
    }
  }
}

// The row partials of phi' (one warp per row) and the edge partials (one
// warp per edge) over phi' as it is, masked endpoints as 1/K (s_pp and
// s_pr are bilinear in the two rows: stage d divides them by the row
// sums), pushed to slot [rank] of every CTA's rin [S, B] and ein [S, E,
// 2] (this CTA's arrays; the peers' copies sit at the same offsets).
__device__ __forceinline__ void step_partials(
    cg::cluster_group& cluster, const float* rows, int ld, int kw, int B,
    int E, int t, const unsigned* slanes, const unsigned* mbits,
    const unsigned* yebits, const float* bet, float inv_k, float* rin,
    float* ein, int S, int rank, int warp, int lane) {
  // float4 columns (the pad is zero); each lane's in order
  const int nq4 = (kw + 3) / 4, ld4 = ld / 4;
  for (int b = warp; b < B; b += kWarps) {
    const float4* r4 = reinterpret_cast<const float4*>(rows) + b * ld4;
    float acc = 0.f;
    for (int q = lane; q < nq4; q += 32) {
      const float4 x = r4[q];
      acc += (x.x + x.y) + (x.z + x.w);
    }
    acc = warp_sum(acc);
    if (lane < S) cluster.map_shared_rank(rin, lane)[rank * B + b] = acc;
  }
  const float4* bet4 = reinterpret_cast<const float4*>(bet);
  const float4 ik4 = make_float4(inv_k, inv_k, inv_k, inv_k);
  for (int e = warp; e < E; e += kWarps) {
    const unsigned pk = slanes[e];
    const int u = pk & 0xffffu, v = pk >> 16;
    const bool vu = bit(mbits, (size_t)t * B + u);
    const bool vv = bit(mbits, (size_t)t * B + v);
    const float4* pu = reinterpret_cast<const float4*>(rows) + u * ld4;
    const float4* pv = reinterpret_cast<const float4*>(rows) + v * ld4;
    const bool link = bit(yebits, (size_t)t * E + e);
    float s_pp = 0.f, s_pr = 0.f;
    for (int q = lane; q < nq4; q += 32) {
      // a masked endpoint counts as 1/K, on the slice's columns only
      const float4 a = vu ? pu[q] : ik4, c = vv ? pv[q] : ik4;
      const float4 bt = bet4[q];
      const float pp[4] = {a.x * c.x, a.y * c.y, a.z * c.z, a.w * c.w};
      const float w[4] = {bt.x, bt.y, bt.z, bt.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * q + i < kw) {
          s_pp += pp[i];
          s_pr += (link ? w[i] : 1.f - w[i]) * pp[i];
        }
      }
    }
    s_pp = warp_sum(s_pp);
    s_pr = warp_sum(s_pr);
    if (lane < S) {
      float* peer = cluster.map_shared_rank(ein, lane);
      peer[(rank * E + e) * 2] = s_pp;
      peer[(rank * E + e) * 2 + 1] = s_pr;
    }
  }
}

// The cluster layouts' sum over the S ranks' slots (rank_sum), as
// step_normalize takes it.
struct RankSum {
  int S;
  __device__ __forceinline__ float operator()(const float* x,
                                              int stride) const {
    return rank_sum(x, stride, S);
  }
};

// Stage d: the row sums (sum over the slots rin[b], rin[b + rstride],
// ...) into rsv and ssum_t; per edge the sums of its slots (ein[2e] and
// ein[2e + 1], estride apart) divided by the endpoints' row sums (a
// masked endpoint's by 1), and prsum into epr; the rows normalized in
// shared memory and written to the scratch stg_t (this CTA's columns of
// the step's staged rows; plain coalesced stores), masked lanes as 1/K
// in shared memory. The cluster layouts sum the S ranks' slots pairwise
// (RankSum; rin [S, B], ein [S, E, 2]). Ends without a barrier.
template <typename Sum>
__device__ __forceinline__ void step_normalize(
    float* rows, int ld, int kw, int B, int E, int K, int t, bool vec,
    const float* rin, int rstride, const float* ein, int estride, Sum sum,
    const unsigned* slanes, const unsigned* mbits, const unsigned* yebits,
    float* rsv, float* ssum_t, float* epr, float* stg_t, float eps,
    float one_minus_eps, float inv_k, int tid) {
  for (int b = tid; b < B; b += kThreads) {
    const float rs = sum(rin + b, rstride);
    rsv[b] = rs;
    ssum_t[b] = rs;
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const unsigned pk = slanes[e];
    const int u = pk & 0xffffu, v = pk >> 16;
    const float du = bit(mbits, (size_t)t * B + u) ? rsv[u] : 1.f;
    const float dv = bit(mbits, (size_t)t * B + v) ? rsv[v] : 1.f;
    const float s_pp = sum(ein + 2 * e, estride) / (du * dv);
    const float s_pr = sum(ein + 2 * e + 1, estride) / (du * dv);
    const bool link = bit(yebits, (size_t)t * E + e);
    epr[e] = s_pr + (link ? eps : one_minus_eps) * (1.f - s_pp);
  }
  if (vec) {
    const int nq = kw / 4;
    for (int i = tid; i < B * nq; i += kThreads) {
      const int b = i / nq, q = i - b * nq;
      float4* row = reinterpret_cast<float4*>(rows + b * ld) + q;
      const float rs = rsv[b];
      const float4 x = *row;
      const float4 v = make_float4(x.x / rs, x.y / rs, x.z / rs, x.w / rs);
      *reinterpret_cast<float4*>(stg_t + (size_t)b * K + 4 * q) = v;
      *row = bit(mbits, (size_t)t * B + b)
                 ? v : make_float4(inv_k, inv_k, inv_k, inv_k);
    }
  } else {
    for (int i = tid; i < B * kw; i += kThreads) {
      const int b = i / kw, kk = i - b * kw;
      const float v = rows[b * ld + kk] / rsv[b];
      stg_t[(size_t)b * K + kk] = v;
      rows[b * ld + kk] = bit(mbits, (size_t)t * B + b) ? v : inv_k;
    }
  }
}

// Stage e's gradient fan-in: G = fan_groups(KW) threads per column,
// thread g over the edges e = g mod G, into gpart [G, KW, 2].
__device__ __forceinline__ void step_fan_in(
    const float* rows, int ld, int kw, int KW, int E, int t,
    const unsigned* slanes, const unsigned* yebits, const unsigned* embits,
    const float* epr, const float* th0, const float* th1, const float* bet,
    float* gpart, int tid) {
  const int G = fan_groups(KW);
  for (int item = tid; item < G * KW; item += kThreads) {
    const int g = item / KW, kk = item - g * KW;
    if (kk >= kw) continue;
    const float t0 = th0[kk], t1 = th1[kk], bk = bet[kk];
    const float inv_ts = 1.f / (t0 + t1);
    const float inv_t0 = 1.f / t0, inv_t1 = 1.f / t1;
    float g0 = 0.f, g1 = 0.f;
#pragma unroll 4
    for (int e = g; e < E; e += G) {
      const bool link = bit(yebits, (size_t)t * E + e);
      const float m = bit(embits, (size_t)t * E + e) ? 1.f : 0.f;
      const unsigned pk = slanes[e];
      const float pp = rows[(pk & 0xffffu) * ld + kk] * rows[(pk >> 16) * ld + kk];
      const float f = ((link ? bk : 1.f - bk) * pp) / epr[e];
      g0 += (f * ((link ? 0.f : inv_t0) - inv_ts)) * m;
      g1 += (f * ((link ? inv_t1 : 0.f) - inv_ts)) * m;
    }
    gpart[(g * KW + kk) * 2] = g0;
    gpart[(g * KW + kk) * 2 + 1] = g1;
  }
}

// Stage e's theta step: the G fan-in partials of each column added in
// order, then theta_column with the theta noise bz [kw, 2].
__device__ __forceinline__ void step_theta(
    const float* gpart, const float* bz, int kw, int KW, float eps_b,
    float wt, float eta0, float eta1, float eps, float* th0, float* th1,
    float* bet, float* bme, int tid) {
  const int G = fan_groups(KW);
  for (int kk = tid; kk < kw; kk += kThreads) {
    float g0 = 0.f, g1 = 0.f;
    for (int g = 0; g < G; ++g) {
      g0 += gpart[(g * KW + kk) * 2];
      g1 += gpart[(g * KW + kk) * 2 + 1];
    }
    theta_column(g0, g1, bz[2 * kk], bz[2 * kk + 1], eps_b, wt, eta0, eta1,
                 eps, th0[kk], th1[kk], bet[kk], bme[kk]);
  }
}

// The wide layouts' end of a window: the kept rows from the scratch (each
// CTA its own columns), their sums by CTA 0, theta and beta by slice.
template <typename PiT>
__device__ __forceinline__ void finish_wide(
    const Params<PiT>& P, size_t chain, PiT* pi_c, float* sum_c,
    const float* stg, const int* snodes, const float* ssum, const float* th0,
    const float* th1, const float* bet, int k0, int kw, bool vec, int rank,
    int tid, int warp, int lane) {
  const int K = P.K, TB = P.T * P.B;
  const bool* keep = P.keep + chain * TB;
  scatter_kept(pi_c + k0, stg, keep, snodes, TB, K, kw, vec, warp, lane);
  if (rank == 0)
    for (int tb = tid; tb < TB; tb += kThreads)
      if (keep[tb]) sum_c[snodes[tb]] = ssum[tb];
  for (int kk = tid; kk < kw; kk += kThreads) {
    P.theta_out[chain * K * 2 + 2 * (k0 + kk)] = th0[kk];
    P.theta_out[chain * K * 2 + 2 * (k0 + kk) + 1] = th1[kk];
    P.beta_out[chain * K + k0 + kk] = bet[kk];
  }
}

// The step layout's shared arrays, as SM / SU / SI above.
constexpr int kStepFields = sizeof(StepLayout) / sizeof(size_t);
#define TM(name) (smem + s_off[offsetof(StepLayout, name) / sizeof(size_t)])
#define TU(name) reinterpret_cast<unsigned*>(TM(name))
#define TI(name) reinterpret_cast<int*>(TM(name))

// The wide mode where a CTA's whole slice of one step's rows fits in
// shared memory (the step layout: the launch's chunk covers the slice;
// K = 1536-4096 at T = 12 on an H100). The staged rows go to the global
// scratch P.staged [C, T*B, K] as in the chunked layout, but a step's
// rows stay in shared memory through all its stages, so each row is read
// from L2 once per step and written to the scratch once:
//   0. step t's rows were gathered during step t-1 into the buffers of
//      parity t & 1: the pre-window rows by bulk copies (one
//      cp.async.bulk of kw floats per row, issued by one lane of each
//      warp, counted in bytes on the buffer's mbarrier), the rows steps
//      <= t-2 wrote from the scratch by cp.async; the rows step t-1 wrote
//      are copied from the other buffer's node rows, which still hold
//      them. Step t+1's gather into the other buffers is issued in stage
//      b (its buffers are free since step t's start);
//   a. q = (pi_n * (beta - eps)) . pi_nb over the slice, register-tiled:
//      pi_n * (beta - eps) is formed once into the noise buffer; a warp
//      takes kQNodes nodes over one of q_splits(B) runs of columns, lane
//      l neighbors l % 16 and l % 16 + 16 over the run's float4 columns
//      of parity l / 16, so each neighbor-row load serves kQNodes nodes
//      and each node-row load 32 neighbors; the splits are summed in
//      order and pushed to the nodes' owners;
//   b. the coefficients (node_coefficients, as in the other layouts);
//   c. contrib and the phi step in place on the node rows, register-tiled
//      (a thread takes kCNodes nodes for four columns: each neighbor-row
//      float4 serves kCNodes nodes, each coefficient float4 four columns
//      and four neighbors), the phi noise from its bulk copies, started
//      after stage a into the buffer that held pi_n * (beta - eps); the
//      row partials and the edge partials,
//      taken on phi' as it is (s_pp and s_pr are bilinear in the two rows,
//      a masked endpoint counts as 1/K), pushed to every CTA in one
//      exchange;
//   d. the row sums; the edge sums divided by the endpoints' row sums;
//      the rows normalized in shared memory and written to the scratch
//      (plain coalesced stores, never read back before a later step's
//      gather or the scatter), masked lanes as 1/K in shared memory;
//   e. the gradient fan-in (fan_groups(kw) threads per column, each over
//      its own edges) and the theta step.
// Three cluster barriers a step, after a, b and c. No inner loop branches
// between its loads (a short group of nodes repeats its last node), so
// the loads of a tile are in flight together.
// Sums over columns are taken in another order than the resident mode's
// (its bits are not these): q per lane over its columns, the two column
// parities, then the splits in order; the row and edge sums per lane then
// over the warp; the ranks pairwise. On an H100 a K = 4096 window takes
// about half the chunked layout's time (PERF.md).
// Ragged slices (K % 4 != 0) copy 4 bytes at a time, bf16 rows are loaded
// and widened synchronously, as in the other layouts.
template <typename PiT>
__global__ void __launch_bounds__(kThreads) window_kernel_step(Params<PiT> P) {
  constexpr bool kF32 = std::is_same<PiT, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_off[kStepFields];
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
  const int ld = row_stride(KW);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float eps = P.eps;
  if (tid == 0) {
    const StepLayout L = layout_step(T, B, n, E, KW, S);
    const size_t* f = reinterpret_cast<const size_t*>(&L);
    for (int i = 0; i < kStepFields; ++i) s_off[i] = (unsigned)f[i];
#ifdef WINDOW_PHASES
    for (int i = 0; i < kPhases; ++i) s_phase[i] = 0;
#endif
  }
  const size_t chain = blockIdx.x / S;
  const size_t TB = (size_t)T * B;
  PiT* const pi_c = P.pi + chain * P.N * K;
  float* const sum_c = P.phi_sum + chain * P.N;
  float* const stg = P.staged + chain * TB * K + k0;
  __syncthreads();
  unsigned long long* const bars =
      reinterpret_cast<unsigned long long*>(TM(bars));
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_window(P, chain, k0, kw, TI(smc), TI(snodes), TI(snbrs), TU(slanes),
               TU(ybits), TU(mbits), TU(yebits), TU(embits), TM(th0),
               TM(th1), TM(bet), tid, warp, lane);
  for (int kk = tid; kk < (KW + 3) / 4 * 4; kk += kThreads)
    TM(bme)[kk] = kk < kw ? P.beta_in[chain * K + k0 + kk] - eps : 0.f;
  // the columns past the slice, zeroed once in both row buffers: the
  // float4 loads of stage a read them
  for (int i = tid; i < 2 * R * (ld - kw); i += kThreads)
    TM(rows0)[(i / (ld - kw)) * ld + kw + i % (ld - kw)] = 0.f;
  __syncthreads();

  // 16-byte copies where K and KW are multiples of 4; float32 rows and
  // the noise then go by bulk copies
  const bool vec = (K % 4 == 0) && (KW % 4 == 0);
  const bool vec8 = (K % 8 == 0) && (KW % 8 == 0);
  const unsigned row_bytes = 4u * kw;
  // The gather of step u into the buffers of parity p (all threads; one
  // cp.async group): its pre-window rows (bulk copies by warp 0 when
  // float32 and vec, counted on the buffer's mbarrier, else 4-byte
  // copies or the bf16 loads), the rows steps <= u-2 wrote from the
  // scratch, the pre-window phi sums. Called after a block barrier, so
  // nothing reads the buffers any more.
  auto gather = [&](int u, int p) {
    const int* mct = TI(smc) + u * R;
    const int* nd = TI(snodes) + u * B;
    const int* nb = TI(snbrs) + u * n;
    float* rbuf = p ? TM(rows1) : TM(rows0);
    auto src_id = [&](int r) { return r < B ? min(nd[r], P.N - 1) : nb[r - B]; };
    if (warp == 0) {
      unsigned pre = 0;
      if (kF32 && vec)
        for (int r0 = 0; r0 < R; r0 += 32)
          pre += __popc(__ballot_sync(0xffffffffu,
                                      r0 + lane < R && mct[r0 + lane] == 0));
      if (lane == 0) mbar_expect(bars + p, pre * row_bytes);
    }
    // one lane of each warp issues its rows' copies: the copy engine
    // takes them one at a time, and a warp that issued them all would
    // hold its block back (the transaction count may run ahead of the
    // expectation: the phase cannot complete before warp 0 arrives)
    if constexpr (kF32)
      if (vec && lane == 0) {
        fence_proxy_async();
        for (int r = warp; r < R; r += kWarps)
          if (mct[r] == 0)
            bulk_copy(rbuf + r * ld, pi_c + (size_t)src_id(r) * K + k0,
                      row_bytes, bars + p);
      }
    for (int r = warp; r < R; r += kWarps) {
      const int m = mct[r];
      float* dst = rbuf + r * ld;
      if (m > 0) {
        if ((m - 1) / B > u - 2) continue;   // step u-1's: at step u's start
        const float* src = stg + (size_t)(m - 1) * K;
        if (vec)
          for (int q = lane; q < kw / 4; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
        else
          for (int x = lane; x < kw; x += 32) cp_async4(dst + x, src + x);
      } else if constexpr (kF32) {
        if (!vec) {
          const float* src = pi_c + (size_t)src_id(r) * K + k0;
          for (int x = lane; x < kw; x += 32) cp_async4(dst + x, src + x);
        }
      } else {
        const PiT* src = pi_c + (size_t)src_id(r) * K + k0;
        if (vec8)
          for (int q = lane; q < kw / 8; q += 32) widen8(dst + 8 * q, src + 8 * q);
        else
          for (int x = lane; x < kw; x += 32) dst[x] = __bfloat162float(src[x]);
      }
    }
    float* sbuf = p ? TM(phis1) : TM(phis0);
    for (int b = tid; b < B; b += kThreads)
      if (mct[b] == 0) cp_async4(sbuf + b, sum_c + min(nd[b], P.N - 1));
    cp_async_commit();
  };
  // The phi noise of step u into nz and its theta noise into bz: bulk
  // copies by one lane of each warp (counted on the noise mbarrier) when
  // vec, else 4-byte copies (one cp.async group).
  auto load_noise = [&](int u) {
    float* const nz = TM(nz);
    float* const bzb = TM(bz);
    const float* noise_u = P.noise + (chain * T + u) * B * K + k0;
    const float* bnoise_u = P.bnoise + (chain * T + u) * K * 2 + 2 * k0;
    if (tid == 0) mbar_expect(bars + 2, vec ? (B + 2) * row_bytes : 0u);
    if (vec && lane == 0) {
      fence_proxy_async();
      for (int b = warp; b < B; b += kWarps)
        bulk_copy(nz + b * ld, noise_u + (size_t)b * K, row_bytes, bars + 2);
      if (warp == kWarps - 1) bulk_copy(bzb, bnoise_u, 2 * row_bytes, bars + 2);
    }
    if (!vec) {
      for (int b = warp; b < B; b += kWarps)
        for (int x = lane; x < kw; x += 32)
          cp_async4(nz + b * ld + x, noise_u + (size_t)b * K + x);
      for (int i = tid; i < 2 * kw; i += kThreads) cp_async4(bzb + i, bnoise_u + i);
      cp_async_commit();
    }
  };
  gather(0, 0);
  PHASE(0);

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    const int* mct = TI(smc) + t * R;
    const unsigned* mbits = TU(mbits);
    float* const rows = par ? TM(rows1) : TM(rows0);
    float* const phis = par ? TM(phis1) : TM(phis0);
#ifdef WINDOW_PHASES
    __syncthreads();
    PHASE(11);
    cluster.sync();
    PHASE(12);
#endif
    // ---- 0. wait for step t's gather; the rows step t-1 wrote from the
    //         other buffer's node rows, the redirected phi sums ---------
    mbar_wait(bars + par, (t >> 1) & 1);
    cp_async_wait_all();
    PHASE(13);
    {
      const float* prev = par ? TM(rows0) : TM(rows1);
      for (int r = warp; r < R; r += kWarps) {
        const int m = mct[r];
        if (m == 0 || (m - 1) / B != t - 1) continue;
        const float* src = prev + ((m - 1) - (t - 1) * B) * ld;
        for (int kk = lane; kk < kw; kk += 32) rows[r * ld + kk] = src[kk];
      }
      for (int b = tid; b < B; b += kThreads)
        if (mct[b] > 0) phis[b] = TM(ssum)[mct[b] - 1];
    }
    __syncthreads();
    PHASE(1);

    // ---- a. q partials: x * (beta - eps) once into nz; each split's
    //         partials; the step's noise started into nz; the splits
    //         summed in order and pushed to the nodes' owners ------------
    {
      const int nk4 = (kw + 3) / 4;
      const int ld4 = ld / 4;
      const float4* bm4 = reinterpret_cast<const float4*>(TM(bme));
      float4* const xb4 = reinterpret_cast<float4*>(TM(nz));
      for (int i = tid; i < B * nk4; i += kThreads) {
        const int b = i / nk4, k4 = i - b * nk4;
        const float4 x = reinterpret_cast<const float4*>(rows)[b * ld4 + k4];
        const float4 bm = bm4[k4];
        xb4[b * ld4 + k4] = make_float4(x.x * bm.x, x.y * bm.y, x.z * bm.z,
                                        x.w * bm.w);
      }
      __syncthreads();
      // a warp takes kQNodes nodes over a split's columns; lane l holds
      // neighbors l % 16 and l % 16 + 16 over the split's float4 columns
      // of parity l / 16, one sum per (node, neighbor)
      float* const qpart = TM(part);
      const int ks = q_splits(B);
      const int groups = (B + kQNodes - 1) / kQNodes;
      const int jn = lane & 15, kp = lane >> 4;
      const float4* pv0 =
          reinterpret_cast<const float4*>(rows + (B + min(jn, n - 1)) * ld);
      const float4* pv1 =
          reinterpret_cast<const float4*>(rows + (B + min(jn + 16, n - 1)) * ld);
      for (int task = warp; task < groups * ks; task += kWarps) {
        const int g = task / ks, sp = task - g * ks;
        const int b0 = g * kQNodes;
        const int nb = min(kQNodes, B - b0);
        const float4* px = xb4 + b0 * ld4;
        float acc0[kQNodes] = {}, acc1[kQNodes] = {};
        for (int k4 = sp * nk4 / ks + kp; k4 < (sp + 1) * nk4 / ks; k4 += 2) {
          const float4 v0 = pv0[k4];
          const float4 v1 = pv1[k4];
          // no branch between the loads: a short group repeats its last
          // node, whose sums are not stored
#pragma unroll
          for (int q = 0; q < kQNodes; ++q) {
            const float4 x = px[min(q, nb - 1) * ld4 + k4];
            acc0[q] += x.x * v0.x;
            acc1[q] += x.x * v1.x;
            acc0[q] += x.y * v0.y;
            acc1[q] += x.y * v1.y;
            acc0[q] += x.z * v0.z;
            acc1[q] += x.z * v1.z;
            acc0[q] += x.w * v0.w;
            acc1[q] += x.w * v1.w;
          }
        }
#pragma unroll
        for (int q = 0; q < kQNodes; ++q) {
          // the even columns' sums, then the odd ones'
          acc0[q] += __shfl_down_sync(0xffffffffu, acc0[q], 16);
          acc1[q] += __shfl_down_sync(0xffffffffu, acc1[q], 16);
          if (kp == 0 && q < nb) {
            float* out = qpart + (sp * B + b0 + q) * n;
            if (jn < n) out[jn] = acc0[q];
            if (jn + 16 < n) out[jn + 16] = acc1[q];
          }
        }
      }

      __syncthreads();
      PHASE(14);
      float* const qin = TM(qin);
      const int nl = (B + S - 1) / S;
      for (int i = tid; i < B * n; i += kThreads) {
        const int b = i / n, jj = i - b * n;
        float q = 0.f;
        for (int sp = 0; sp < ks; ++sp) q += qpart[sp * B * n + i];
        cluster.map_shared_rank(qin, b % S)[(rank * nl + b / S) * n + jj] = q;
      }
    }
    // the step's noise into the buffer x * (beta - eps) held, its issue
    // in the shadow of the cluster barrier
    load_noise(t);
    cluster.sync();
    PHASE(2);

    // ---- b. the coefficients of this CTA's nodes, to every CTA -----------
    node_coefficients<true>(cluster, TM(qin), TU(ybits), TI(snodes) + t * B,
                            TI(snbrs) + t * n, phis, TM(coef), TM(ce),
                            TM(nval), TM(scale), TM(invphi), t, B, n, S,
                            rank, warp, lane, eps, P.one_minus_eps,
                            P.n_nodes);
    // step t+1's gather into the other buffers (free since this step's
    // start); the noise's 4-byte copies (ragged slices) land before it,
    // the gather's group may not
    if (t + 1 < T)
      gather(t + 1, par ^ 1);
    else
      cp_async_commit();
    cp_async_wait_older();
    cluster.sync();
    PHASE(3);

    // ---- c. contrib and the phi step (step_contrib), the noise from the
    //         noise buffer -------------------------------------------------
    mbar_wait(bars + 2, par);
    PHASE(15);
    {
      const float4* nz4 = reinterpret_cast<const float4*>(TM(nz));
      const int ld4 = ld / 4;
      step_contrib<1>(rows, ld, rows + B * ld, ld, 0, kw, kw, B, n, TM(coef),
                      TM(ce), TM(nval), TM(scale), TM(invphi), phis, TM(bme),
                      P.eps_phi[t], P.alpha, tid,
                      [&](int b, int q4) { return nz4[b * ld4 + q4]; });
    }
    __syncthreads();
    PHASE(4);

    // ---- the row and edge partials of phi' to every CTA in one exchange
    //         (step_partials) ----------------------------------------------
    const unsigned* const slanes = TU(slanes) + t * E;
    const unsigned* const yebits = TU(yebits);
    step_partials(cluster, rows, ld, kw, B, E, t, slanes, mbits, yebits,
                  TM(bet), P.inv_k, TM(rin), TM(ein), S, rank, warp, lane);
    cluster.sync();
    PHASE(5);

    // ---- d. the row sums, prsum, the rows normalized and written to the
    //         scratch (step_normalize) -------------------------------------
    float* const stg_t = stg + (size_t)t * B * K;
    step_normalize(rows, ld, kw, B, E, K, t, vec, TM(rin), B, TM(ein),
                   2 * E, RankSum{S}, slanes, mbits, yebits, TM(rsv),
                   TM(ssum) + t * B, TM(epr), stg_t, eps, P.one_minus_eps,
                   P.inv_k, tid);
    __syncthreads();
    PHASE(6);

    // ---- e. the gradient fan-in and the theta step (step_fan_in,
    //         step_theta) --------------------------------------------------
    step_fan_in(rows, ld, kw, KW, E, t, slanes, yebits, TU(embits), TM(epr),
                TM(th0), TM(th1), TM(bet), TM(part), tid);
    __syncthreads();
    PHASE(8);
    step_theta(TM(part), TM(bz), kw, KW, P.eps_theta[t], P.wts[chain * T + t],
               P.eta0, P.eta1, eps, TM(th0), TM(th1), TM(bet), TM(bme), tid);
    __syncthreads();
    PHASE(9);
  }

  // ---- the scatter, theta and beta (finish_wide) ------------------------
  finish_wide(P, chain, pi_c, sum_c, stg, TI(snodes), TM(ssum), TM(th0),
              TM(th1), TM(bet), k0, kw, vec, rank, tid, warp, lane);
  // the peers may still be reading this CTA's last partials
  cluster.sync();
  PHASE(10);
#ifdef WINDOW_PHASES
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += s_phase[i];
#endif
}

#undef TM
#undef TU
#undef TI

// The step layout with one set of rows' shared arrays, as SM / SU / SI.
constexpr int kStep1Fields = sizeof(Step1Layout) / sizeof(size_t);
#define OM(name) (smem + s_off[offsetof(Step1Layout, name) / sizeof(size_t)])
#define OU(name) reinterpret_cast<unsigned*>(OM(name))
#define OI(name) reinterpret_cast<int*>(OM(name))

// The wide mode where one set of a CTA's slice of a step's rows fits in
// shared memory but the step layout's two sets and its noise buffer do
// not (K = 6144-8192 at T = 12 on an H100, where the chunked layout read
// the rows from L2 twice a step). As in the step layout, a step's rows
// stay in shared memory through all its stages, so each row is read from
// L2 once a step, and phi' goes to the scratch once and is not read back
// in the step; the stages and their arithmetic are the step layout's
// (three cluster barriers a step, after a, b and c), but for:
//   - one set of rows. Step t+1's rows land in the regions step t has
//     done with: its neighbor rows and pre-window phi sums after stage c
//     (the neighbor rows are last read by contrib), its node rows after
//     stage e's fan-in (the node rows' last reader), while the theta step
//     runs. Pre-window float32 rows come by bulk copies counted on an
//     mbarrier per region (node rows, neighbor rows); rows steps <= t-1
//     wrote from the scratch by cp.async, a neighbor row that step t
//     wrote with the node rows (its scratch row is stored in stage d); a
//     node row that step t wrote in the same lane is in place already.
//     bf16 rows are loaded and widened synchronously, ragged slices
//     copied 4 bytes at a time, as in the other layouts;
//   - no phi noise buffer: its rows are prefetched into L2 in stage a and
//     each contrib thread reads its nodes' four columns in stage c;
//   - no x * (beta - eps) buffer: q takes pi_nb * (beta - eps) of the
//     tile's two neighbor float4s in registers, times pi_n (the step
//     layout rounds x * (beta - eps) first; both are float32 products of
//     the same three factors).
template <typename PiT>
__global__ void __launch_bounds__(kThreads) window_kernel_step1(Params<PiT> P) {
  constexpr bool kF32 = std::is_same<PiT, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_off[kStep1Fields];
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
  const int ld = row_stride(KW);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float eps = P.eps;
  if (tid == 0) {
    const Step1Layout L = layout_step1(T, B, n, E, KW, S);
    const size_t* f = reinterpret_cast<const size_t*>(&L);
    for (int i = 0; i < kStep1Fields; ++i) s_off[i] = (unsigned)f[i];
#ifdef WINDOW_PHASES
    for (int i = 0; i < kPhases; ++i) s_phase[i] = 0;
#endif
  }
  const size_t chain = blockIdx.x / S;
  const size_t TB = (size_t)T * B;
  PiT* const pi_c = P.pi + chain * P.N * K;
  float* const sum_c = P.phi_sum + chain * P.N;
  float* const stg = P.staged + chain * TB * K + k0;
  __syncthreads();
  // mbarriers: node rows, neighbor rows, theta noise
  unsigned long long* const bars =
      reinterpret_cast<unsigned long long*>(OM(bars));
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_window(P, chain, k0, kw, OI(smc), OI(snodes), OI(snbrs), OU(slanes),
               OU(ybits), OU(mbits), OU(yebits), OU(embits), OM(th0),
               OM(th1), OM(bet), tid, warp, lane);
  for (int kk = tid; kk < (KW + 3) / 4 * 4; kk += kThreads)
    OM(bme)[kk] = kk < kw ? P.beta_in[chain * K + k0 + kk] - eps : 0.f;
  float* const rows = OM(rows);
  float* const phis = OM(phis);
  // the columns past the slice, zeroed once: the float4 loads read them
  for (int i = tid; i < R * (ld - kw); i += kThreads)
    rows[(i / (ld - kw)) * ld + kw + i % (ld - kw)] = 0.f;
  __syncthreads();

  // 16-byte copies where K and KW are multiples of 4; float32 rows and
  // the theta noise then go by bulk copies
  const bool vec = (K % 4 == 0) && (KW % 4 == 0);
  const bool vec8 = (K % 8 == 0) && (KW % 8 == 0);
  const unsigned row_bytes = 4u * kw;
  // The gather of step u's neighbor rows and pre-window phi sums (nodes
  // false; called once stage c of step u-1 is done) or of its node rows
  // (nodes true; once stage e's fan-in of step u-1 is done), all threads,
  // one cp.async group: pre-window rows from pi (bulk copies by lane 0 of
  // each warp, counted on the region's mbarrier, when float32 and vec;
  // else 4-byte copies or the bf16 loads), rows an earlier step wrote from
  // the scratch. A neighbor row step u-1 wrote waits for the node rows'
  // gather: its scratch row is stored in stage d; a node row step u-1
  // wrote in the same lane is in place.
  auto gather = [&](int u, bool nodes) {
    const int* mct = OI(smc) + u * R;
    const int* nd = OI(snodes) + u * B;
    const int* nb = OI(snbrs) + u * n;
    const int lo = nodes ? 0 : B, hi = nodes ? B : R;
    unsigned long long* const bar = bars + (nodes ? 0 : 1);
    auto src_id = [&](int r) { return r < B ? min(nd[r], P.N - 1) : nb[r - B]; };
    if (warp == 0) {
      unsigned pre = 0;
      if (kF32 && vec)
        for (int r0 = lo; r0 < hi; r0 += 32)
          pre += __popc(__ballot_sync(0xffffffffu,
                                      r0 + lane < hi && mct[r0 + lane] == 0));
      if (lane == 0) mbar_expect(bar, pre * row_bytes);
    }
    // (the transaction count may run ahead of the expectation: the phase
    // cannot complete before warp 0 arrives)
    if constexpr (kF32)
      if (vec && lane == 0) {
        fence_proxy_async();
        for (int r = lo + warp; r < hi; r += kWarps)
          if (mct[r] == 0)
            bulk_copy(rows + r * ld, pi_c + (size_t)src_id(r) * K + k0,
                      row_bytes, bar);
      }
    for (int r = warp; r < R; r += kWarps) {
      const int m = mct[r];
      float* dst = rows + r * ld;
      if (m > 0) {
        const int slot = m - 1;
        const bool last = slot / B == u - 1;   // step u-1's write
        if (nodes ? (r >= B && !last) || slot - (u - 1) * B == r
                  : r < B || last)
          continue;
        const float* src = stg + (size_t)slot * K;
        if (vec)
          for (int q = lane; q < kw / 4; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
        else
          for (int x = lane; x < kw; x += 32) cp_async4(dst + x, src + x);
      } else if (r >= lo && r < hi) {
        if constexpr (kF32) {
          if (!vec) {
            const float* src = pi_c + (size_t)src_id(r) * K + k0;
            for (int x = lane; x < kw; x += 32) cp_async4(dst + x, src + x);
          }
        } else {
          const PiT* src = pi_c + (size_t)src_id(r) * K + k0;
          if (vec8)
            for (int q = lane; q < kw / 8; q += 32) widen8(dst + 8 * q, src + 8 * q);
          else
            for (int x = lane; x < kw; x += 32) dst[x] = __bfloat162float(src[x]);
        }
      }
    }
    if (!nodes)
      for (int b = tid; b < B; b += kThreads)
        if (mct[b] == 0) cp_async4(phis + b, sum_c + min(nd[b], P.N - 1));
    cp_async_commit();
  };
  gather(0, false);
  gather(0, true);
  PHASE(0);

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    const int* mct = OI(smc) + t * R;
    const unsigned* mbits = OU(mbits);
    const float* const noise_t = P.noise + (chain * T + t) * B * K + k0;
#ifdef WINDOW_PHASES
    __syncthreads();
    PHASE(11);
    cluster.sync();
    PHASE(12);
#endif
    // ---- 0. wait for step t's rows; the redirected phi sums ------------
    mbar_wait(bars, par);
    mbar_wait(bars + 1, par);
    cp_async_wait_all();
    PHASE(13);
    for (int b = tid; b < B; b += kThreads)
      if (mct[b] > 0) phis[b] = OM(ssum)[mct[b] - 1];
    __syncthreads();
    PHASE(1);

    // ---- a. the step's theta noise into bz (a bulk copy by thread 0 when
    //         vec, else plain loads); its phi noise into L2; q partials,
    //         the splits summed in order and pushed to the nodes' owners --
    {
      float* const bzb = OM(bz);
      const float* bnoise_t = P.bnoise + (chain * T + t) * K * 2 + 2 * k0;
      if (vec) {
        if (tid == 0) {
          mbar_expect(bars + 2, 2 * row_bytes);
          fence_proxy_async();
          bulk_copy(bzb, bnoise_t, 2 * row_bytes, bars + 2);
        }
      } else {
        if (tid == 0) mbar_expect(bars + 2, 0u);
        for (int i = tid; i < 2 * kw; i += kThreads) bzb[i] = bnoise_t[i];
      }
      // 128-byte lines of a row's slice, one more for a slice that
      // starts inside a line
      const int lines = (4 * kw + 127) / 128 + 1;
      for (int i = tid; i < B * lines; i += kThreads) {
        const int b = i / lines, l = i - b * lines;
        prefetch_l2(noise_t + (size_t)b * K + min(32 * l, kw - 1));
      }
    }
    {
      const int nk4 = (kw + 3) / 4;
      const int ld4 = ld / 4;
      const float4* bm4 = reinterpret_cast<const float4*>(OM(bme));
      const float4* rows4 = reinterpret_cast<const float4*>(rows);
      // a warp takes kQNodes nodes over a split's columns; lane l holds
      // neighbors l % 16 and l % 16 + 16 over the split's float4 columns
      // of parity l / 16, one sum per (node, neighbor)
      float* const qpart = OM(part);
      const int ks = q_splits(B);
      const int groups = (B + kQNodes - 1) / kQNodes;
      const int jn = lane & 15, kp = lane >> 4;
      const float4* pv0 = rows4 + (B + min(jn, n - 1)) * ld4;
      const float4* pv1 = rows4 + (B + min(jn + 16, n - 1)) * ld4;
      for (int task = warp; task < groups * ks; task += kWarps) {
        const int g = task / ks, sp = task - g * ks;
        const int b0 = g * kQNodes;
        const int nb = min(kQNodes, B - b0);
        const float4* px = rows4 + b0 * ld4;
        float acc0[kQNodes] = {}, acc1[kQNodes] = {};
        for (int k4 = sp * nk4 / ks + kp; k4 < (sp + 1) * nk4 / ks; k4 += 2) {
          const float4 bm = bm4[k4];
          const float4 a0 = pv0[k4];
          const float4 a1 = pv1[k4];
          const float4 v0 = make_float4(a0.x * bm.x, a0.y * bm.y, a0.z * bm.z,
                                        a0.w * bm.w);
          const float4 v1 = make_float4(a1.x * bm.x, a1.y * bm.y, a1.z * bm.z,
                                        a1.w * bm.w);
          // no branch between the loads: a short group repeats its last
          // node, whose sums are not stored
#pragma unroll
          for (int q = 0; q < kQNodes; ++q) {
            const float4 x = px[min(q, nb - 1) * ld4 + k4];
            acc0[q] += x.x * v0.x;
            acc1[q] += x.x * v1.x;
            acc0[q] += x.y * v0.y;
            acc1[q] += x.y * v1.y;
            acc0[q] += x.z * v0.z;
            acc1[q] += x.z * v1.z;
            acc0[q] += x.w * v0.w;
            acc1[q] += x.w * v1.w;
          }
        }
#pragma unroll
        for (int q = 0; q < kQNodes; ++q) {
          // the even columns' sums, then the odd ones'
          acc0[q] += __shfl_down_sync(0xffffffffu, acc0[q], 16);
          acc1[q] += __shfl_down_sync(0xffffffffu, acc1[q], 16);
          if (kp == 0 && q < nb) {
            float* out = qpart + (sp * B + b0 + q) * n;
            if (jn < n) out[jn] = acc0[q];
            if (jn + 16 < n) out[jn + 16] = acc1[q];
          }
        }
      }
      __syncthreads();
      PHASE(14);
      float* const qin = OM(qin);
      const int nl = (B + S - 1) / S;
      for (int i = tid; i < B * n; i += kThreads) {
        const int b = i / n, jj = i - b * n;
        float q = 0.f;
        for (int sp = 0; sp < ks; ++sp) q += qpart[sp * B * n + i];
        cluster.map_shared_rank(qin, b % S)[(rank * nl + b / S) * n + jj] = q;
      }
    }
    cluster.sync();
    PHASE(2);

    // ---- b. the coefficients of this CTA's nodes, to every CTA -----------
    node_coefficients<true>(cluster, OM(qin), OU(ybits), OI(snodes) + t * B,
                            OI(snbrs) + t * n, phis, OM(coef), OM(ce),
                            OM(nval), OM(scale), OM(invphi), t, B, n, S,
                            rank, warp, lane, eps, P.one_minus_eps,
                            P.n_nodes);
    cluster.sync();
    PHASE(3);

    // ---- c. contrib and the phi step (step_contrib), each node's four
    //         noise values read from global memory after its sums --------
    {
      // the node's noise, from L2 (prefetched in stage a): loaded one
      // node at a time, which keeps the thread's registers within 128
      // (all kCNodes of a thread's at once spilled, and took 14% longer
      // on an H100); the ragged end of the slice reads no column past it
      auto noise = [&](int b, int q4) {
        const float* zr = noise_t + (size_t)b * K + 4 * q4;
        return vec ? __ldg(reinterpret_cast<const float4*>(zr))
                   : make_float4(zr[0], 4 * q4 + 1 < kw ? zr[1] : 0.f,
                                 4 * q4 + 2 < kw ? zr[2] : 0.f,
                                 4 * q4 + 3 < kw ? zr[3] : 0.f);
      };
      step_contrib<1>(rows, ld, rows + B * ld, ld, 0, kw, kw, B, n, OM(coef),
                      OM(ce), OM(nval), OM(scale), OM(invphi), phis, OM(bme),
                      P.eps_phi[t], P.alpha, tid, noise);
    }
    __syncthreads();
    PHASE(4);

    // ---- the row and edge partials of phi' to every CTA in one exchange
    //         (step_partials); step t+1's neighbor rows and phi sums
    //         started into the regions contrib freed ------------------------
    const unsigned* const slanes = OU(slanes) + t * E;
    const unsigned* const yebits = OU(yebits);
    step_partials(cluster, rows, ld, kw, B, E, t, slanes, mbits, yebits,
                  OM(bet), P.inv_k, OM(rin), OM(ein), S, rank, warp, lane);
    if (t + 1 < T) gather(t + 1, false);
    cluster.sync();
    PHASE(5);

    // ---- d. the row sums, prsum, the rows normalized and written to the
    //         scratch (step_normalize) -------------------------------------
    float* const stg_t = stg + (size_t)t * B * K;
    step_normalize(rows, ld, kw, B, E, K, t, vec, OM(rin), B, OM(ein),
                   2 * E, RankSum{S}, slanes, mbits, yebits, OM(rsv),
                   OM(ssum) + t * B, OM(epr), stg_t, eps, P.one_minus_eps,
                   P.inv_k, tid);
    __syncthreads();
    PHASE(6);

    // ---- e. the gradient fan-in (step_fan_in); step t+1's node rows
    //         started into the node rows; the theta step (step_theta) -----
    step_fan_in(rows, ld, kw, KW, E, t, slanes, yebits, OU(embits), OM(epr),
                OM(th0), OM(th1), OM(bet), OM(part), tid);
    __syncthreads();
    PHASE(8);
    if (t + 1 < T) gather(t + 1, true);
    PHASE(7);
    mbar_wait(bars + 2, par);
    PHASE(15);
    step_theta(OM(part), OM(bz), kw, KW, P.eps_theta[t], P.wts[chain * T + t],
               P.eta0, P.eta1, eps, OM(th0), OM(th1), OM(bet), OM(bme), tid);
    __syncthreads();
    PHASE(9);
  }

  // ---- the scatter, theta and beta (finish_wide) ------------------------
  finish_wide(P, chain, pi_c, sum_c, stg, OI(snodes), OM(ssum), OM(th0),
              OM(th1), OM(bet), k0, kw, vec, rank, tid, warp, lane);
  // the peers may still be reading this CTA's last partials
  cluster.sync();
  PHASE(10);
#ifdef WINDOW_PHASES
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += s_phase[i];
#endif
}

#undef OM
#undef OU
#undef OI

// The node-resident layout's shared arrays, as SM / SU / SI.
constexpr int kNodesFields = sizeof(NodesLayout) / sizeof(size_t);
#define NM(name) (smem + s_off[offsetof(NodesLayout, name) / sizeof(size_t)])
#define NU(name) reinterpret_cast<unsigned*>(NM(name))
#define NI(name) reinterpret_cast<int*>(NM(name))

// The wide mode where not even one set of a CTA's slice of a step's rows
// fits in shared memory (one set of 65 rows at w = 1024 is 266 KB: K =
// 10240-16384 at T = 12 on an H100, where the chunked layout read every
// row from L2 twice a step and the node rows twice more through the
// scratch). The node rows stay in shared memory through the whole step,
// as in window_kernel_step1; the neighbor rows, the only rows a step
// reads and never writes, stream through two tiles of n rows x wc
// columns, twice a step: once for q, once for contrib. The stages and
// their arithmetic are step1's but for:
//   - the tiles. Tile i holds columns [i*wc, (i+1)*wc) of the slice of
//     every neighbor row, copied by 16-byte cp.async from pi or, for a row
//     an earlier step wrote, from the scratch (one group a tile; bf16 rows
//     of pi loaded and widened, ragged slices 4 bytes at a time). Not bulk
//     copies: the copy engine takes those one row at a time, and 32 rows
//     a tile cost more to issue than the tile's compute (on an H100). The
//     window's tiles alternate between the two buffers; tile i+2 is issued
//     by every warp once the block is done with tile i, so that one tile's
//     copies are in flight while the other is computed (a ring of three,
//     one barrier a tile, or the issue left to the warps without compute,
//     were no faster). Step t+1's first two tiles are issued once stage d
//     of step t has stored its scratch rows, contrib's first two once q's
//     partials are pushed (they alias the tiles). Both passes read the
//     same values: pi is written only at the end, and step t writes only
//     its own scratch slots, which its neighbors never read. Step t+1's
//     pre-window rows are prefetched into L2 at step t's start;
//   - q keeps each warp's (nodes, split) sums in registers across the
//     tiles, the split taking its run of each tile's float4 columns; the
//     order of q's sums over the columns is not step1's;
//   - contrib is step_contrib on a tile with two lanes per item (kJ = 2),
//     its neighbor sums joined by a shuffle;
//   - the node rows and phi sums of step t+1 are gathered by cp.async
//     after stage e's fan-in (a row step t wrote in the same lane is in
//     place), waited for at step t+1's start; the theta noise is read
//     from global memory (prefetched into L2 at the step's start) in the
//     theta step.
// Three cluster barriers a step, after a, b and c, as in the step layouts.
template <typename PiT>
__global__ void __launch_bounds__(kThreads) window_kernel_nodes(Params<PiT> P) {
  constexpr bool kF32 = std::is_same<PiT, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_off[kNodesFields];
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
  const int ld = row_stride(KW);
  const int TC = P.wc;                    // the tiles' width
  const int ldt = row_stride(TC);
  const int NT = (kw + TC - 1) / TC;      // tiles a pass
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float eps = P.eps;
  if (tid == 0) {
    const NodesLayout L = layout_nodes(T, B, n, E, KW, S, TC);
    const size_t* f = reinterpret_cast<const size_t*>(&L);
    for (int i = 0; i < kNodesFields; ++i) s_off[i] = (unsigned)f[i];
#ifdef WINDOW_PHASES
    for (int i = 0; i < kPhases; ++i) s_phase[i] = 0;
#endif
  }
  const size_t chain = blockIdx.x / S;
  const size_t TB = (size_t)T * B;
  PiT* const pi_c = P.pi + chain * P.N * K;
  float* const sum_c = P.phi_sum + chain * P.N;
  float* const stg = P.staged + chain * TB * K + k0;
  __syncthreads();
  stage_window(P, chain, k0, kw, NI(smc), NI(snodes), NI(snbrs), NU(slanes),
               NU(ybits), NU(mbits), NU(yebits), NU(embits), NM(th0),
               NM(th1), NM(bet), tid, warp, lane);
  for (int kk = tid; kk < (KW + 3) / 4 * 4; kk += kThreads)
    NM(bme)[kk] = kk < kw ? P.beta_in[chain * K + k0 + kk] - eps : 0.f;
  float* const rows = NM(rows);
  float* const phis = NM(phis);
  float* const tiles = NM(tiles);
  // the node rows' columns past the slice, zeroed once (the float4 loads
  // read them), and the tiles (a ragged tile's last float4 reads up to
  // three columns past it, times the zero columns of the node rows)
  for (int i = tid; i < B * (ld - kw); i += kThreads)
    rows[(i / (ld - kw)) * ld + kw + i % (ld - kw)] = 0.f;
  for (int i = tid; i < 2 * n * ldt; i += kThreads) tiles[i] = 0.f;
  __syncthreads();

  // 16-byte copies where K and KW are multiples of 4, 4-byte ones else;
  // bf16 rows of pi: 16-byte loads of 8 values where K and KW are
  // multiples of 8
  const bool vec = (K % 4 == 0) && (KW % 4 == 0);
  const bool vec8 = (K % 8 == 0) && (KW % 8 == 0);
  // The gather of step u's node rows and pre-window phi sums (all
  // threads, once stage e's fan-in of step u-1 is done; one cp.async
  // group): pre-window rows from pi (cp.async, or the bf16 loads), rows
  // an earlier step wrote from the scratch; a row step u-1 wrote in the
  // same lane is in place.
  auto gather_nodes = [&](int u) {
    const int* mct = NI(smc) + u * R;
    const int* nd = NI(snodes) + u * B;
    for (int r = warp; r < B; r += kWarps) {
      const int m = mct[r];
      float* dst = rows + r * ld;
      if (m > 0) {
        if (m - 1 == (u - 1) * B + r) continue;   // in place
        const float* src = stg + (size_t)(m - 1) * K;
        if (vec)
          for (int q = lane; q < kw / 4; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
        else
          for (int x = lane; x < kw; x += 32) cp_async4(dst + x, src + x);
      } else if constexpr (kF32) {
        const float* src = pi_c + (size_t)min(nd[r], P.N - 1) * K + k0;
        if (vec)
          for (int q = lane; q < kw / 4; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
        else
          for (int x = lane; x < kw; x += 32) cp_async4(dst + x, src + x);
      } else {
        const PiT* src = pi_c + (size_t)min(nd[r], P.N - 1) * K + k0;
        if (vec8)
          for (int q = lane; q < kw / 8; q += 32) widen8(dst + 8 * q, src + 8 * q);
        else
          for (int x = lane; x < kw; x += 32) dst[x] = __bfloat162float(src[x]);
      }
    }
    for (int b = tid; b < B; b += kThreads)
      if (mct[b] == 0) cp_async4(phis + b, sum_c + min(nd[b], P.N - 1));
    cp_async_commit();
  };
  // Tile i of step u's neighbor rows (the slice's columns [i*TC, i*TC +
  // tw)) into buffer g & 1, g its place in the window's sequence of tiles
  // (all threads, after a block barrier that follows the last reads of
  // the buffer; one cp.async group, an empty one for i >= NT, so that a
  // tile's group is the second newest when it is waited for): every row
  // from pi or, for a row an earlier step wrote, from the scratch.
  auto issue_tile = [&](int u, int i, int g) {
    if (i < NT) {
      const int c0 = i * TC, tw = min(TC, kw - c0);
      const int* mct = NI(smc) + u * R + B;
      const int* nb = NI(snbrs) + u * n;
      float* const buf = tiles + (g & 1) * n * ldt;
      for (int j = warp; j < n; j += kWarps) {
        const int m = mct[j];
        float* dst = buf + j * ldt;
        if (m > 0) {
          const float* src = stg + (size_t)(m - 1) * K + c0;
          if (vec)
            for (int q = lane; q < tw / 4; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
          else
            for (int x = lane; x < tw; x += 32) cp_async4(dst + x, src + x);
        } else if constexpr (kF32) {
          const float* src = pi_c + (size_t)nb[j] * K + k0 + c0;
          if (vec)
            for (int q = lane; q < tw / 4; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
          else
            for (int x = lane; x < tw; x += 32) cp_async4(dst + x, src + x);
        } else {
          const PiT* src = pi_c + (size_t)nb[j] * K + k0 + c0;
          if (vec8)
            for (int q = lane; q < tw / 8; q += 32) widen8(dst + 8 * q, src + 8 * q);
          else
            for (int x = lane; x < tw; x += 32) dst[x] = __bfloat162float(src[x]);
        }
      }
    }
    cp_async_commit();
  };
  // Waits for a tile: its group (the newest but one), then a block
  // barrier.
  auto wait_tile = [&]() {
    cp_async_wait_older();
    __syncthreads();
  };
  issue_tile(0, 0, 0);
  issue_tile(0, 1, 1);
  gather_nodes(0);
  PHASE(0);

  for (int t = 0; t < T; ++t) {
    const int* mct = NI(smc) + t * R;
    const unsigned* mbits = NU(mbits);
    const float* const noise_t = P.noise + (chain * T + t) * B * K + k0;
    const float* const bnoise_t = P.bnoise + (chain * T + t) * K * 2 + 2 * k0;
    const int gq = 2 * NT * t, gc = gq + NT;   // the passes' first tiles
#ifdef WINDOW_PHASES
    __syncthreads();
    PHASE(11);
    cluster.sync();
    PHASE(12);
#endif
    // ---- 0. wait for step t's node rows; the redirected phi sums; the
    //         step's phi and theta noise and step t+1's pre-window rows
    //         into L2 ----------------------------------------------------
    cp_async_wait_all();
    PHASE(13);
    for (int b = tid; b < B; b += kThreads)
      if (mct[b] > 0) phis[b] = NM(ssum)[mct[b] - 1];
    {
      // 128-byte lines of a row's slice, one more for a slice that
      // starts inside a line
      const int lines = (4 * kw + 127) / 128 + 1;
      const int nrows = B + 2 + (t + 1 < T ? R : 0);
      const int* mcn = mct + R;
      const int* ndn = NI(snodes) + (t + 1) * B;
      const int* nbn = NI(snbrs) + (t + 1) * n;
      for (int i = tid; i < nrows * lines; i += kThreads) {
        const int b = i / lines, l = i - b * lines;
        const int col = min(32 * l, kw - 1);
        if (b < B) {
          prefetch_l2(noise_t + (size_t)b * K + col);
        } else if (b < B + 2) {
          prefetch_l2(bnoise_t + (b - B) * kw + col);
        } else {
          const int r = b - B - 2;
          if (mcn[r] == 0)
            prefetch_l2(pi_c + (size_t)(r < B ? min(ndn[r], P.N - 1)
                                               : nbn[r - B]) * K + k0 + col);
        }
      }
    }
    __syncthreads();
    PHASE(1);

    // ---- a. q partials over the tiles: a warp takes kQNodes nodes over
    //         its split's run of each tile's float4 columns, its sums in
    //         registers across the tiles (lane l: neighbors l % 16 and
    //         l % 16 + 16, columns of parity l / 16); then the splits
    //         summed in order and pushed to the nodes' owners; contrib's
    //         first two tiles issued --------------------------------------
    {
      const int ld4 = ld / 4, ldt4 = ldt / 4;
      const float4* bm4 = reinterpret_cast<const float4*>(NM(bme));
      const float4* rows4 = reinterpret_cast<const float4*>(rows);
      const int ks = q_splits(B);
      const int groups = (B + kQNodes - 1) / kQNodes;
      const bool busy = warp < groups * ks;   // warp-uniform
      const int g = warp / ks, sp = warp - g * ks;
      const int b0 = g * kQNodes;
      const int nb = busy ? min(kQNodes, B - b0) : 1;
      const int jn = lane & 15, kp = lane >> 4;
      float acc0[kQNodes] = {}, acc1[kQNodes] = {};
      for (int i = 0; i < NT; ++i) {
        wait_tile();
        PHASE(15);
        if (busy) {
          const int nt4 = (min(TC, kw - i * TC) + 3) / 4, q0 = i * TC / 4;
          const float4* tile4 = reinterpret_cast<const float4*>(
              tiles + ((gq + i) & 1) * n * ldt);
          const float4* pv0 = tile4 + min(jn, n - 1) * ldt4;
          const float4* pv1 = tile4 + min(jn + 16, n - 1) * ldt4;
          const float4* px = rows4 + b0 * ld4 + q0;
          const float4* bm = bm4 + q0;
          for (int k4 = sp * nt4 / ks + kp; k4 < (sp + 1) * nt4 / ks;
               k4 += 2) {
            const float4 bmk = bm[k4];
            const float4 a0 = pv0[k4];
            const float4 a1 = pv1[k4];
            const float4 v0 = make_float4(a0.x * bmk.x, a0.y * bmk.y,
                                          a0.z * bmk.z, a0.w * bmk.w);
            const float4 v1 = make_float4(a1.x * bmk.x, a1.y * bmk.y,
                                          a1.z * bmk.z, a1.w * bmk.w);
            // no branch between the loads: a short group repeats its
            // last node, whose sums are not stored
#pragma unroll
            for (int q = 0; q < kQNodes; ++q) {
              const float4 x = px[min(q, nb - 1) * ld4 + k4];
              acc0[q] += x.x * v0.x;
              acc1[q] += x.x * v1.x;
              acc0[q] += x.y * v0.y;
              acc1[q] += x.y * v1.y;
              acc0[q] += x.z * v0.z;
              acc1[q] += x.z * v1.z;
              acc0[q] += x.w * v0.w;
              acc1[q] += x.w * v1.w;
            }
          }
        }
        __syncthreads();
        issue_tile(t, i + 2, gq + i + 2);
        PHASE(14);
      }
      // the q partials of the splits into the tiles' region (no copy is
      // in flight into it: the pass's last two issues were empty)
      float* const qpart = tiles;
      if (busy) {
#pragma unroll
        for (int q = 0; q < kQNodes; ++q) {
          // the even columns' sums, then the odd ones'
          acc0[q] += __shfl_down_sync(0xffffffffu, acc0[q], 16);
          acc1[q] += __shfl_down_sync(0xffffffffu, acc1[q], 16);
          if (kp == 0 && q < nb) {
            float* out = qpart + (sp * B + b0 + q) * n;
            if (jn < n) out[jn] = acc0[q];
            if (jn + 16 < n) out[jn + 16] = acc1[q];
          }
        }
      }
      __syncthreads();
      float* const qin = NM(qin);
      const int nl = (B + S - 1) / S;
      for (int i = tid; i < B * n; i += kThreads) {
        const int b = i / n, jj = i - b * n;
        float q = 0.f;
        for (int s2 = 0; s2 < ks; ++s2) q += qpart[s2 * B * n + i];
        cluster.map_shared_rank(qin, b % S)[(rank * nl + b / S) * n + jj] = q;
      }
      __syncthreads();
      issue_tile(t, 0, gc);
      issue_tile(t, 1, gc + 1);
    }
    cluster.sync();
    PHASE(2);

    // ---- b. the coefficients of this CTA's nodes, to every CTA -----------
    node_coefficients<true>(cluster, NM(qin), NU(ybits), NI(snodes) + t * B,
                            NI(snbrs) + t * n, phis, NM(coef), NM(ce),
                            NM(nval), NM(scale), NM(invphi), t, B, n, S,
                            rank, warp, lane, eps, P.one_minus_eps,
                            P.n_nodes);
    cluster.sync();
    PHASE(3);

    // ---- c. contrib and the phi step over the tiles (step_contrib, two
    //         lanes per item), the noise read from global memory --------
    {
      // one node's noise at a time, from L2 (prefetched above); the
      // ragged end of the slice reads no column past it
      auto noise = [&](int b, int q4) {
        const float* zr = noise_t + (size_t)b * K + 4 * q4;
        return vec ? __ldg(reinterpret_cast<const float4*>(zr))
                   : make_float4(zr[0], 4 * q4 + 1 < kw ? zr[1] : 0.f,
                                 4 * q4 + 2 < kw ? zr[2] : 0.f,
                                 4 * q4 + 3 < kw ? zr[3] : 0.f);
      };
      for (int i = 0; i < NT; ++i) {
        wait_tile();
        PHASE(15);
        step_contrib<2>(rows, ld, tiles + ((gc + i) & 1) * n * ldt, ldt,
                        i * TC, min(TC, kw - i * TC), kw, B, n, NM(coef),
                        NM(ce), NM(nval), NM(scale), NM(invphi), phis,
                        NM(bme), P.eps_phi[t], P.alpha, tid, noise);
        __syncthreads();
        issue_tile(t, i + 2, gc + i + 2);
        PHASE(4);
      }
    }

    // ---- the row and edge partials of phi' to every CTA in one exchange
    //         (step_partials) ----------------------------------------------
    const unsigned* const slanes = NU(slanes) + t * E;
    const unsigned* const yebits = NU(yebits);
    step_partials(cluster, rows, ld, kw, B, E, t, slanes, mbits, yebits,
                  NM(bet), P.inv_k, NM(rin), NM(ein), S, rank, warp, lane);
    cluster.sync();
    PHASE(5);

    // ---- d. the row sums, prsum, the rows normalized and written to the
    //         scratch (step_normalize); step t+1's first two tiles, which
    //         may read those scratch rows ---------------------------------
    float* const stg_t = stg + (size_t)t * B * K;
    step_normalize(rows, ld, kw, B, E, K, t, vec, NM(rin), B, NM(ein),
                   2 * E, RankSum{S}, slanes, mbits, yebits, NM(rsv),
                   NM(ssum) + t * B, NM(epr), stg_t, eps, P.one_minus_eps,
                   P.inv_k, tid);
    __syncthreads();
    PHASE(6);
    if (t + 1 < T) {
      issue_tile(t + 1, 0, gq + 2 * NT);
      issue_tile(t + 1, 1, gq + 2 * NT + 1);
    }
    PHASE(7);

    // ---- e. the gradient fan-in (step_fan_in); step t+1's node rows
    //         started into the node rows; the theta step (step_theta) with
    //         the theta noise from global memory ---------------------------
    step_fan_in(rows, ld, kw, KW, E, t, slanes, yebits, NU(embits), NM(epr),
                NM(th0), NM(th1), NM(bet), NM(gpart), tid);
    __syncthreads();
    PHASE(8);
    if (t + 1 < T) gather_nodes(t + 1);
    step_theta(NM(gpart), bnoise_t, kw, KW, P.eps_theta[t],
               P.wts[chain * T + t], P.eta0, P.eta1, eps, NM(th0), NM(th1),
               NM(bet), NM(bme), tid);
    __syncthreads();
    PHASE(9);
  }

  // ---- the scatter, theta and beta (finish_wide) ------------------------
  finish_wide(P, chain, pi_c, sum_c, stg, NI(snodes), NM(ssum), NM(th0),
              NM(th1), NM(bet), k0, kw, vec, rank, tid, warp, lane);
  // the peers may still be reading this CTA's last partials
  cluster.sync();
  PHASE(10);
#ifdef WINDOW_PHASES
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += s_phase[i];
#endif
}

#undef NM
#undef NU
#undef NI

// ---------------------------------------------------------------------------
// The grid layout (window_kernel_grid)
// ---------------------------------------------------------------------------

// The grid layout's barrier word: device memory that lives as long as the
// module, zero when it loads and never reset. At each barrier every CTA
// but CTA 0 adds 1 and CTA 0 adds 2^31 - (nblocks - 1), so the top bit
// flips exactly when the last CTA arrives and the low bits come back to
// zero: every launch finds it in the same state, whatever its grid, with
// no memset. One grid launch at a time on a device (the port issues its
// windows on one stream).
__device__ unsigned g_grid_bar;

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The barrier over every CTA of the launch, in two halves so that work
// that needs no other CTA runs between them: grid_arrive (a block
// barrier, thread 0's release fence and arrival; returns the word it
// found) and grid_wait (thread 0's acquire loads until the top bit flips,
// a block barrier). The writes of every CTA before its arrival are
// visible to the loads of every CTA after its wait. The launch is
// cooperative, so the CTAs are co-resident.
__device__ __forceinline__ unsigned grid_arrive() {
  __syncthreads();
  unsigned old = 0;
  if (threadIdx.x == 0) {
    const unsigned nb = gridDim.x;
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (nb - 1) : 1u;
    __threadfence();
    old = atomicAdd(&g_grid_bar, add);
  }
  return old;
}

__device__ __forceinline__ void grid_wait(unsigned old) {
  if (threadIdx.x == 0)
    while (((old ^ ld_acquire_gpu(&g_grid_bar)) & 0x80000000u) == 0) {
    }
  __syncthreads();
}

// The cluster barrier (cluster.sync) in two halves: the arrival releases
// this CTA's earlier writes, the wait acquires the peers'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The sum over the G clusters of x[0], x[stride], ..., x[(G-1)*stride]:
// pairwise in a fixed order, as rank_sum, so every CTA gets the same bits;
// with kL2 the values are read from L2 (ld.global.cg: another SM wrote
// them), else from shared memory.
template <bool kL2>
__device__ __forceinline__ float grid_sum(const float* x, size_t stride,
                                          int G) {
  float v[kMaxGrid];
#pragma unroll
  for (int r = 0; r < kMaxGrid; ++r)
    v[r] = r < G ? (kL2 ? __ldcg(x + r * stride) : x[r * stride]) : 0.f;
#pragma unroll
  for (int w = 1; w < kMaxGrid; w *= 2)
#pragma unroll
    for (int r = 0; r + w < kMaxGrid; r += 2 * w) v[r] += v[r + w];
  return v[0];
}

// The grid layout's sum over the clusters' slots, as step_normalize takes
// it (the slots in shared memory).
struct GridSum {
  int G;
  __device__ __forceinline__ float operator()(const float* x,
                                              int stride) const {
    return grid_sum<false>(x, stride, G);
  }
};

// The grid layout's shared arrays, as SM / SU / SI.
constexpr int kGridFields = sizeof(GridLayout) / sizeof(size_t);
#define GM(name) (smem + s_off[offsetof(GridLayout, name) / sizeof(size_t)])
#define GU(name) reinterpret_cast<unsigned*>(GM(name))
#define GI(name) reinterpret_cast<int*>(GM(name))

// The wide mode of one chain spread over the whole card (K = 10240-16384
// at T = 12 on an H100, where the node-resident layout ran a window on
// the 16 SMs of one cluster, every stage growing with its 1024-column
// slices). Like every layout it replaces _window_gather, the Pallas
// kernel _window_kernel and _window_scatter of the JAX package's
// windowed_scan. Its bound at (T, B, n, E, K) = (12, 33, 32, 32, 16384)
// is the bytes a window moves, ~12 us at 3.35 TB/s (PERF.md's kernel
// table); like the others it is latency-bound, T steps of dependent
// stages, and what the grid does about that is spread every stage over
// six to seven times the SMs. The launch is cooperative: G clusters of S
// CTAs, as many as the card holds at once (ops/window.py::window_plan: 27
// clusters of 4 at K = 16384 on an H100, slices of 152 columns), CTA i
// owning the columns [i*kw, min(K, (i+1)*kw)). A slice that narrow keeps
// a step's rows in shared memory, two sets as in the step layout, so its
// stages are the step layout's (step_contrib, step_partials,
// node_coefficients_of, the fan-in, the theta step, finish_wide) on a
// slice a sixth as wide. The
// staged rows stay in the global scratch, each CTA reading and writing
// its own columns. What changes is the exchange of the three sums that
// need every column, q [B, n], the row sums and the edge sums [E, 2]:
//   - inside a cluster, as in the other layouts, by remote stores into
//     distributed shared memory and a cluster barrier (q to the node's
//     owner, b mod S; the row and edge partials to every CTA);
//   - across clusters through L2: each cluster's sums, the ranks added
//     pairwise (the owner of node b its q, rank r the row and edge values
//     v = r mod S), are stored with st.global.cg into the cluster's slot
//     of the exchange after the scratch ([G, B, n] and [G, B + 2E]); after
//     a barrier over the grid (grid_arrive, grid_wait) the owner of node
//     b adds the G slots of its q pairwise in cluster order (grid_sum),
//     computes its coefficients and pushes them to its cluster (every CTA
//     adding all B x n of q itself took 26% longer on an H100), and every
//     CTA adds the G slots of each row and edge sum the same way, so
//     every CTA holds the same bits whatever the scheduling.
// Per step: three cluster barriers and two grid barriers; the noise and
// the next step's gather are issued between the halves of the first two,
// so that their issue waits there and not on a stage. Each exchange
// slot is written again only after a grid barrier that follows its last
// read: q's after the next grid barrier of stage c, the row and edge sums'
// after that of the next stage a. The gather is the step layout's with
// 16-byte cp.async copies for every row (the copy engine takes bulk copies
// one row at a time) and the noise by cp.async too. Sums over columns are
// taken in another order than the other layouts' (their bits are not
// these): per lane, over the warp, the splits in order, the ranks
// pairwise, then the clusters pairwise. Ragged slices copy 4 bytes at a
// time; bf16 rows are loaded and widened synchronously, as elsewhere.
template <typename PiT>
__global__ void __launch_bounds__(kThreads) window_kernel_grid(Params<PiT> P) {
  constexpr bool kF32 = std::is_same<PiT, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_off[kGridFields];
#ifdef WINDOW_PHASES
  __shared__ unsigned long long s_phase[kPhases];
  long long t_last = clock64();
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = static_cast<int>(gridDim.x) / S;     // the clusters
  const int gi = static_cast<int>(blockIdx.x) / S;   // this CTA's
  const int B = P.B, n = P.n, E = P.E, K = P.K, T = P.T, R = P.B + P.n;
  const int V = B + 2 * E;    // the row and edge sums a step exchanges
  const int KW = P.kw;
  const int k0 = blockIdx.x * KW;
  const int kw = min(K, k0 + KW) - k0;
  const int ld = row_stride(KW);
  const int nl = (B + S - 1) / S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float eps = P.eps;
  if (tid == 0) {
    const GridLayout L = layout_grid(T, B, n, E, KW, S, G);
    const size_t* f = reinterpret_cast<const size_t*>(&L);
    for (int i = 0; i < kGridFields; ++i) s_off[i] = (unsigned)f[i];
#ifdef WINDOW_PHASES
    for (int i = 0; i < kPhases; ++i) s_phase[i] = 0;
#endif
  }
  const size_t TB = (size_t)T * B;
  PiT* const pi_c = P.pi;
  float* const sum_c = P.phi_sum;
  float* const stg = P.staged + k0;
  // the L2 exchange after the scratch: the clusters' q [G, B, n], their
  // row and edge sums [G, V]
  float* const gq = P.staged + TB * K;
  float* const gre = gq + (size_t)G * B * n;
  __syncthreads();
  stage_window(P, 0, k0, kw, GI(smc), GI(snodes), GI(snbrs), GU(slanes),
               GU(ybits), GU(mbits), GU(yebits), GU(embits), GM(th0),
               GM(th1), GM(bet), tid, warp, lane);
  for (int kk = tid; kk < (KW + 3) / 4 * 4; kk += kThreads)
    GM(bme)[kk] = kk < kw ? P.beta_in[k0 + kk] - eps : 0.f;
  // the columns past the slice, zeroed once in both row buffers: the
  // float4 loads of stage a read them
  for (int i = tid; i < 2 * R * (ld - kw); i += kThreads)
    GM(rows0)[(i / (ld - kw)) * ld + kw + i % (ld - kw)] = 0.f;
  __syncthreads();

  // 16-byte copies where K and KW are multiples of 4, 4-byte ones else;
  // bf16 rows of pi: 16-byte loads of 8 values where K and KW are
  // multiples of 8
  const bool vec = (K % 4 == 0) && (KW % 4 == 0);
  const bool vec8 = (K % 8 == 0) && (KW % 8 == 0);
  const int nq = kw / 4, nq8 = kw / 8;
  // The gather of step u into the buffers of parity p (all threads; one
  // cp.async group): its pre-window rows from pi (the bf16 rows loaded
  // and widened), the rows steps <= u-2 wrote from the scratch (the rows
  // step u-1 wrote are copied at step u's start), the pre-window phi
  // sums. Called after a block barrier, so nothing reads the buffers any
  // more.
  auto gather = [&](int u, int p) {
    const int* mct = GI(smc) + u * R;
    const int* nd = GI(snodes) + u * B;
    const int* nb = GI(snbrs) + u * n;
    float* rbuf = p ? GM(rows1) : GM(rows0);
    // the row's source: the scratch, pi (-1 for a bf16 row of pi), or
    // none (step u-1's row)
    auto src_of = [&](int r, const float*& src) {
      const int m = mct[r];
      if (m > 0) {
        if ((m - 1) / B > u - 2) return false;
        src = stg + (size_t)(m - 1) * K;
        return true;
      }
      src = nullptr;
      return true;
    };
    auto row_id = [&](int r) { return r < B ? min(nd[r], P.N - 1) : nb[r - B]; };
    if (vec) {
      for (int i = tid; i < R * nq; i += kThreads) {
        const int r = i / nq, q = i - r * nq;
        const float* src;
        if (!src_of(r, src)) continue;
        float* dst = rbuf + r * ld + 4 * q;
        if (src) {
          cp_async16(dst, src + 4 * q);
        } else if constexpr (kF32) {
          cp_async16(dst, pi_c + (size_t)row_id(r) * K + k0 + 4 * q);
        } else if (!vec8) {
          const PiT* b16 = pi_c + (size_t)row_id(r) * K + k0 + 4 * q;
          for (int x = 0; x < 4; ++x) dst[x] = __bfloat162float(b16[x]);
        }
      }
      if constexpr (!kF32) {
        if (vec8)
          for (int i = tid; i < R * nq8; i += kThreads) {
            const int r = i / nq8, q = i - r * nq8;
            if (mct[r] == 0)
              widen8(rbuf + r * ld + 8 * q,
                     pi_c + (size_t)row_id(r) * K + k0 + 8 * q);
          }
      }
    } else {
      for (int r = warp; r < R; r += kWarps) {
        const float* src;
        if (!src_of(r, src)) continue;
        float* dst = rbuf + r * ld;
        if (src) {
          for (int x = lane; x < kw; x += 32) cp_async4(dst + x, src + x);
        } else if constexpr (kF32) {
          const float* s32 = pi_c + (size_t)row_id(r) * K + k0;
          for (int x = lane; x < kw; x += 32) cp_async4(dst + x, s32 + x);
        } else {
          const PiT* b16 = pi_c + (size_t)row_id(r) * K + k0;
          for (int x = lane; x < kw; x += 32) dst[x] = __bfloat162float(b16[x]);
        }
      }
    }
    float* sbuf = p ? GM(phis1) : GM(phis0);
    for (int b = tid; b < B; b += kThreads)
      if (mct[b] == 0) cp_async4(sbuf + b, sum_c + min(nd[b], P.N - 1));
    cp_async_commit();
  };
  // The phi noise of step u into nz and its theta noise into bz (one
  // cp.async group).
  auto load_noise = [&](int u) {
    float* const nz = GM(nz);
    float* const bzb = GM(bz);
    const float* noise_u = P.noise + (size_t)u * B * K + k0;
    const float* bnoise_u = P.bnoise + (size_t)u * K * 2 + 2 * k0;
    if (vec) {
      for (int i = tid; i < B * nq; i += kThreads) {
        const int b = i / nq, q = i - b * nq;
        cp_async16(nz + b * ld + 4 * q, noise_u + (size_t)b * K + 4 * q);
      }
      for (int i = tid; i < kw / 2; i += kThreads)
        cp_async16(bzb + 4 * i, bnoise_u + 4 * i);
    } else {
      for (int b = warp; b < B; b += kWarps)
        for (int x = lane; x < kw; x += 32)
          cp_async4(nz + b * ld + x, noise_u + (size_t)b * K + x);
      for (int i = tid; i < 2 * kw; i += kThreads) cp_async4(bzb + i, bnoise_u + i);
    }
    cp_async_commit();
  };
  gather(0, 0);
  PHASE(0);

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    const int* mct = GI(smc) + t * R;
    const unsigned* mbits = GU(mbits);
    float* const rows = par ? GM(rows1) : GM(rows0);
    float* const phis = par ? GM(phis1) : GM(phis0);
    // ---- 0. wait for step t's gather; the rows step t-1 wrote from the
    //         other buffer's node rows, the redirected phi sums ---------
    cp_async_wait_all();
    {
      const float* prev = par ? GM(rows0) : GM(rows1);
      for (int r = warp; r < R; r += kWarps) {
        const int m = mct[r];
        if (m == 0 || (m - 1) / B != t - 1) continue;
        const float* src = prev + ((m - 1) - (t - 1) * B) * ld;
        for (int kk = lane; kk < kw; kk += 32) rows[r * ld + kk] = src[kk];
      }
      for (int b = tid; b < B; b += kThreads)
        if (mct[b] > 0) phis[b] = GM(ssum)[mct[b] - 1];
    }
    __syncthreads();
    PHASE(1);

    // ---- a. q partials: x * (beta - eps) once into nz; each split's
    //         partials; the splits summed in order and pushed to the
    //         nodes' owners; the step's noise started into nz ------------
    {
      const int nk4 = (kw + 3) / 4;
      const int ld4 = ld / 4;
      const float4* bm4 = reinterpret_cast<const float4*>(GM(bme));
      float4* const xb4 = reinterpret_cast<float4*>(GM(nz));
      for (int i = tid; i < B * nk4; i += kThreads) {
        const int b = i / nk4, k4 = i - b * nk4;
        const float4 x = reinterpret_cast<const float4*>(rows)[b * ld4 + k4];
        const float4 bm = bm4[k4];
        xb4[b * ld4 + k4] = make_float4(x.x * bm.x, x.y * bm.y, x.z * bm.z,
                                        x.w * bm.w);
      }
      __syncthreads();
      // a warp takes kQNodes nodes over a split's columns; lane l holds
      // neighbors l % 16 and l % 16 + 16 over the split's float4 columns
      // of parity l / 16, one sum per (node, neighbor)
      float* const qpart = GM(part);
      const int ks = q_splits(B);
      const int groups = (B + kQNodes - 1) / kQNodes;
      const int jn = lane & 15, kp = lane >> 4;
      const float4* pv0 =
          reinterpret_cast<const float4*>(rows + (B + min(jn, n - 1)) * ld);
      const float4* pv1 =
          reinterpret_cast<const float4*>(rows + (B + min(jn + 16, n - 1)) * ld);
      for (int task = warp; task < groups * ks; task += kWarps) {
        const int g = task / ks, sp = task - g * ks;
        const int b0 = g * kQNodes;
        const int nb = min(kQNodes, B - b0);
        const float4* px = xb4 + b0 * ld4;
        float acc0[kQNodes] = {}, acc1[kQNodes] = {};
        for (int k4 = sp * nk4 / ks + kp; k4 < (sp + 1) * nk4 / ks; k4 += 2) {
          const float4 v0 = pv0[k4];
          const float4 v1 = pv1[k4];
          // no branch between the loads: a short group repeats its last
          // node, whose sums are not stored
#pragma unroll
          for (int q = 0; q < kQNodes; ++q) {
            const float4 x = px[min(q, nb - 1) * ld4 + k4];
            acc0[q] += x.x * v0.x;
            acc1[q] += x.x * v1.x;
            acc0[q] += x.y * v0.y;
            acc1[q] += x.y * v1.y;
            acc0[q] += x.z * v0.z;
            acc1[q] += x.z * v1.z;
            acc0[q] += x.w * v0.w;
            acc1[q] += x.w * v1.w;
          }
        }
#pragma unroll
        for (int q = 0; q < kQNodes; ++q) {
          // the even columns' sums, then the odd ones'
          acc0[q] += __shfl_down_sync(0xffffffffu, acc0[q], 16);
          acc1[q] += __shfl_down_sync(0xffffffffu, acc1[q], 16);
          if (kp == 0 && q < nb) {
            float* out = qpart + (sp * B + b0 + q) * n;
            if (jn < n) out[jn] = acc0[q];
            if (jn + 16 < n) out[jn + 16] = acc1[q];
          }
        }
      }
      __syncthreads();
      PHASE(2);
      float* const qin = GM(qin);
      for (int i = tid; i < B * n; i += kThreads) {
        const int b = i / n, jj = i - b * n;
        float q = 0.f;
        for (int sp = 0; sp < ks; ++sp) q += qpart[sp * B * n + i];
        cluster.map_shared_rank(qin, b % S)[(rank * nl + b / S) * n + jj] = q;
      }
    }
    // the step's noise into the buffer x * (beta - eps) held, issued
    // between the halves of the cluster barrier
    cluster_arrive();
    load_noise(t);
    cluster_wait();
    PHASE(3);
    // the cluster's q of this CTA's nodes (the ranks pairwise) into its
    // slot of the exchange
    for (int i = tid; i < nl * n; i += kThreads) {
      const int lb = i / n, j = i - lb * n, b = lb * S + rank;
      if (b < B)
        __stcg(gq + ((size_t)gi * B + b) * n + j,
               rank_sum(GM(qin) + lb * n + j, nl * n, S));
    }
    PHASE(4);
    {
      // step t+1's gather into the other buffers (free since this step's
      // start), issued between the halves of the grid barrier
      const unsigned old = grid_arrive();
      if (t + 1 < T)
        gather(t + 1, par ^ 1);
      else
        cp_async_commit();
      grid_wait(old);
    }
    PHASE(5);

    // ---- b. the coefficients of this CTA's nodes, q summed over the
    //         clusters from L2, to every CTA of the cluster ---------------
    node_coefficients_of(
        cluster,
        [&](int lb, int j) {
          return grid_sum<true>(gq + (size_t)(lb * S + rank) * n + j,
                                (size_t)B * n, G);
        },
        GU(ybits), GI(snodes) + t * B, GI(snbrs) + t * n, phis, GM(coef),
        GM(ce), GM(nval), GM(scale), GM(invphi), t, B, n, S, rank, warp, lane,
        eps, P.one_minus_eps, P.n_nodes);
    // the noise's group lands before the gather's, which may not
    cp_async_wait_older();
    cluster.sync();
    PHASE(6);

    // ---- c. contrib and the phi step (step_contrib; two lanes an item
    //         where that takes one pass), the noise from the noise buffer -
    {
      const float4* nz4 = reinterpret_cast<const float4*>(GM(nz));
      const int ld4 = ld / 4;
      auto noise = [&](int b, int q4) { return nz4[b * ld4 + q4]; };
      const int items = (B + kCNodes - 1) / kCNodes * ((KW + 3) / 4);
      if (2 * items <= kThreads)
        step_contrib<2>(rows, ld, rows + B * ld, ld, 0, kw, kw, B, n,
                        GM(coef), GM(ce), GM(nval), GM(scale), GM(invphi),
                        phis, GM(bme), P.eps_phi[t], P.alpha, tid, noise);
      else
        step_contrib<1>(rows, ld, rows + B * ld, ld, 0, kw, kw, B, n,
                        GM(coef), GM(ce), GM(nval), GM(scale), GM(invphi),
                        phis, GM(bme), P.eps_phi[t], P.alpha, tid, noise);
    }
    __syncthreads();
    PHASE(7);

    // ---- the row and edge partials of phi' to every CTA of the cluster
    //         (step_partials); the cluster's sums into its slot ----------
    const unsigned* const slanes = GU(slanes) + t * E;
    const unsigned* const yebits = GU(yebits);
    step_partials(cluster, rows, ld, kw, B, E, t, slanes, mbits, yebits,
                  GM(bet), P.inv_k, GM(rin), GM(ein), S, rank, warp, lane);
    cluster.sync();
    PHASE(8);
    for (int v = rank + S * tid; v < V; v += S * kThreads)
      __stcg(gre + (size_t)gi * V + v,
             v < B ? rank_sum(GM(rin) + v, B, S)
                   : rank_sum(GM(ein) + (v - B), 2 * E, S));
    PHASE(9);
    grid_wait(grid_arrive());
    PHASE(10);

    // ---- d. the clusters' row and edge sums from L2; the row sums, prsum,
    //         the rows normalized and written to the scratch
    //         (step_normalize, the clusters pairwise) ---------------------
    float* const sums = GM(part);
    for (int i = tid; i < G * V; i += kThreads) sums[i] = __ldcg(gre + i);
    __syncthreads();
    PHASE(11);
    float* const stg_t = stg + (size_t)t * B * K;
    step_normalize(rows, ld, kw, B, E, K, t, vec, sums, V, sums + B, V,
                   GridSum{G}, slanes, mbits, yebits, GM(rsv),
                   GM(ssum) + t * B, GM(epr), stg_t, eps, P.one_minus_eps,
                   P.inv_k, tid);
    __syncthreads();
    PHASE(12);

    // ---- e. the gradient fan-in and the theta step (step_fan_in,
    //         step_theta) --------------------------------------------------
    step_fan_in(rows, ld, kw, KW, E, t, slanes, yebits, GU(embits), GM(epr),
                GM(th0), GM(th1), GM(bet), GM(part), tid);
    __syncthreads();
    PHASE(13);
    step_theta(GM(part), GM(bz), kw, KW, P.eps_theta[t], P.wts[t], P.eta0,
               P.eta1, eps, GM(th0), GM(th1), GM(bet), GM(bme), tid);
    __syncthreads();
    PHASE(14);
  }

  // ---- the scatter, theta and beta (finish_wide; phi_sum by CTA 0). No
  //      CTA touches a peer's shared memory after the last cluster
  //      barrier, so none waits for its peers before it exits -------------
  finish_wide(P, 0, pi_c, sum_c, stg, GI(snodes), GM(ssum), GM(th0),
              GM(th1), GM(bet), k0, kw, vec, blockIdx.x, tid, warp, lane);
  PHASE(15);
#ifdef WINDOW_PHASES
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += s_phase[i];
#endif
}

#undef GM
#undef GU
#undef GI

// The kernel of a layout (Mode).
template <typename PiT>
using KernelFn = void (*)(Params<PiT>);

template <typename PiT>
KernelFn<PiT> kernel_of(int mode) {
  switch (mode) {
    case kResident: return window_kernel<PiT>;
    case kStep: return window_kernel_step<PiT>;
    case kStep1: return window_kernel_step1<PiT>;
    case kNodes: return window_kernel_nodes<PiT>;
    case kGrid: return window_kernel_grid<PiT>;
    default: return window_kernel_wide<PiT>;
  }
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

// Launches C clusters of S CTAs of the mode's kernel; the grid layout's
// ceil(K / kw) CTAs in clusters of S, cooperatively: a grid the card
// cannot hold at once is refused, never started.
template <typename PiT>
cudaError_t launch(const Params<PiT>& P, int C, int S, size_t smem,
                   cudaStream_t stream) {
  const KernelFn<PiT> fn = kernel_of<PiT>(P.mode);
  cudaError_t err = set_attributes<PiT>(fn, S, smem);
  if (err != cudaSuccess) return err;
  const bool grid = P.mode == kGrid;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid ? (P.K + P.kw - 1) / P.kw : C * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid ? 2 : 1;
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
                        int wc, int mode, float eps, float one_minus_eps,
                        float alpha, float n_nodes, float eta0, float eta1,
                        float inv_k, const float* eps_phi,
                        const float* eps_theta) {
  Params<PiT> P{static_cast<PiT*>(pi), phi_sum, y, nodes, nbrs, node_mask,
                keep, noise, bnoise, y_edges, edge_mask, lanes_u, lanes_v,
                mcode, wts, theta_in, beta_in, theta_out, beta_out, staged,
                T, B, n, E, K, N, kw, wc, mode, eps, one_minus_eps, alpha,
                n_nodes, eta0, eta1, inv_k, {}, {}};
  for (int t = 0; t < T; ++t) {
    P.eps_phi[t] = eps_phi[t];
    P.eps_theta[t] = eps_theta[t];
  }
  return P;
}

}  // namespace

// Bytes of shared memory per CTA of a launch (window_layout.h).
extern "C" size_t window_kernel_smem_bytes(int T, int B, int n, int E, int K,
                                           int S, int wc, int mode) {
  return layout_bytes(T, B, n, E, K, S, wc, mode);
}

// Launches C clusters of S CTAs (one cluster per chain) on `stream`, or in
// the grid layout (one chain, C = 1) ceil(K / wc) CTAs in clusters of S,
// cooperatively; returns the launch's CUDA error (0 on success). pi [C*N, K] (float32,
// or bfloat16 when pi_bf16 is 1) and phi_sum [C*N] (float32) are updated
// in place; every operand holds the C chains' slices one after another
// (chain-major); `eps_phi` and `eps_theta` are host arrays of T floats,
// shared by the chains. `mode` (Mode) names the layout and wc its chunk
// width (mode_fits): the resident mode, or the wide mode in its step
// layout, its step layout with one set of rows, its chunked layout or its
// node-resident layout (wc its tiles' width) or its grid layout (wc the
// slice width: ceil(K / wc) CTAs, a whole number of clusters of S, at
// most kMaxGrid clusters); the wide mode's staged rows go to `staged`, a
// float32 scratch [C, T*B, K] (unused and may be null in the resident
// mode), which in the grid layout holds the exchange after them
// (grid_exchange_words floats more).
extern "C" int window_kernel_launch(
    void* pi, float* phi_sum, const bool* y, const int* nodes,
    const int* nbrs, const bool* node_mask, const bool* keep,
    const float* noise, const float* bnoise, const bool* y_edges,
    const bool* edge_mask, const int* lanes_u, const int* lanes_v,
    const int* mcode, const float* wts, const float* theta_in,
    const float* beta_in, float* theta_out, float* beta_out, float* staged,
    int C, int T, int B, int n, int E, int K, int N, int S, int wc, int mode,
    int pi_bf16, float eps, float one_minus_eps, float alpha, float n_nodes,
    float eta0, float eta1, float inv_k, const float* eps_phi,
    const float* eps_theta, void* stream) {
  // lanes are packed in 16 bits each
  if (C < 1 || T < 1 || T > kMaxWindow || n > kMaxNeighbors || S < 1
      || S > kMaxCluster || B > 0xffff || (pi_bf16 != 0 && pi_bf16 != 1)
      || (mode != kResident && staged == nullptr))
    return (int)cudaErrorInvalidValue;
  const int kw = mode == kGrid ? wc : slice_width(K, S);
  if (!mode_fits(mode, wc, kw)) return (int)cudaErrorInvalidValue;
  if (mode == kGrid) {
    if (C != 1 || S > 8 || grid_ctas(K, wc) % S != 0
        || grid_ctas(K, wc) / S > kMaxGrid)
      return (int)cudaErrorInvalidValue;
  } else if ((S - 1) * kw >= K) {
    return (int)cudaErrorInvalidValue;  // empty slice
  }
  // the node-resident layout's q keeps one (nodes, split) task a warp
  if (mode == kNodes && (B + kQNodes - 1) / kQNodes > kWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = window_kernel_smem_bytes(T, B, n, E, K, S, wc, mode);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WINDOW_PARAMS(PiT)                                                  \
  make_params<PiT>(pi, phi_sum, y, nodes, nbrs, node_mask, keep, noise,    \
                   bnoise, y_edges, edge_mask, lanes_u, lanes_v, mcode, wts, \
                   theta_in, beta_in, theta_out, beta_out, staged, T, B, n, \
                   E, K, N, kw, wc, mode, eps, one_minus_eps, alpha,        \
                   n_nodes, eta0, eta1, inv_k, eps_phi, eps_theta)
  const cudaError_t err =
      pi_bf16 ? launch(WINDOW_PARAMS(__nv_bfloat16), C, S, smem, st)
              : launch(WINDOW_PARAMS(float), C, S, smem, st);
#undef WINDOW_PARAMS
  return (int)err;
}

// The most clusters of S CTAs (with their shared memory) that the card
// runs at once in the layout `mode` (the grid layout's with slices of wc
// columns), or a negative CUDA error (the float32 instantiation).
extern "C" int window_kernel_max_clusters(int T, int B, int n, int E, int K,
                                          int S, int wc, int mode) {
  if (!mode_fits(mode, wc, slice_width(K, S)))
    return -(int)cudaErrorInvalidValue;
  const size_t smem = window_kernel_smem_bytes(T, B, n, E, K, S, wc, mode);
  const KernelFn<float> fn = kernel_of<float>(mode);
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
