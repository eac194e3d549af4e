// One whole full-MMSB window in ONE launch: the rows are read from pi by
// index, the T sequential SGRLD steps run on a thread-block cluster whose
// CTAs own slices of the rows of B and theta, and the surviving rows are
// written back into pi and phi_sum in place.
//
// Replaces, for one window, what mcmc_ammsb_tpu/ops/window_mmsb.py::
// mmsb_windowed_scan does around the Pallas TPU kernel _mmsb_window_kernel
// (reached through mmsb_window_kernel_call -> pl.pallas_call):
// _window_gather, the kernel, _window_scatter. Called through
// mcmc_ammsb_tpu_torch/ops/window_mmsb.py::mmsb_window_apply_cuda; the
// plain PyTorch version beside it is mmsb_window_apply_torch.
//
// Per step t, the JAX kernel's math (window_mmsb.py:131-235):
//   1. read rows: lane r reads staged row mcode-1 when mcode > 0 (a row an
//      earlier step of the window wrote), else pi[node or nbr] as it was
//      before the window; the TPU's one-hot products become indexed loads;
//   2. phi, the factorized shared-draw contraction with B = theta1 /
//      (theta0 + theta1): g_link = pi_nb B^T, g_non = rowsum(pi_nb) -
//      g_link, p = y ? pi_n . g_link : pi_n . g_non (1 on masked pairs),
//      w = mask / p, sc = sum_j w (y ? g_link : g_non), the SGRLD step with
//      noise, the 1e-24 floor and the row normalization;
//   3. theta, on the new rows with masked node lanes set to 1/K: p_e =
//      sum_kl pi_u[e,k] F_e[k,l] pi_v[e,l] (F = y ? B : 1 - B) and the
//      symmetrized gradient 0.5 sum_e (pi_u[e,k] pi_v[e,l] + pi_v[e,k]
//      pi_u[e,l]) F_e[k,l] c_e[k,l] / p_e, then the SGRLD step per (k, l)
//      cell with abs and the floor.
// The [E*K, K] responsibility tensors of the TPU kernel are never formed:
// c_e depends on the edge only through its label, so the owner of cell
// (k, l) sums S_link / S_non = sum_e w_e (u_k v_l + v_k u_l) over the
// linked / unlinked edges, and the gradient is 0.5 (B S_link c_link +
// (1 - B) S_non c_non).
//
// Layout of the launch: one cluster of S CTAs. CTA r owns the rows
// K_r = [r*kw, min(K, (r+1)*kw)) of B and theta (the last slice may be
// ragged), and the same columns of the node rows; kw = slice_width(K, S),
// S from ops/window_mmsb.py::mmsb_window_cluster_size. B and theta never
// cross CTAs: g_link[j, k in K_r] needs only the owned rows of B and the
// full neighbor rows (every CTA reads them), and the theta fan-in and step
// of the cells (k in K_r, all l) need only full node rows. Four sums
// cross CTAs per step, each by remote STORES into distributed shared
// memory, summed in rank order after one cluster barrier so that every
// CTA holds identical bits:
//   - the pair sums p [B, n]: each CTA's partial over K_r goes to the
//     node's owner (b mod S), which adds them and pushes w back to all;
//   - the new rows: each CTA pushes its columns of phi' and their row-sum
//     partials to every CTA, which then normalizes full rows itself;
//   - the edge sums p_e [E]: partials pushed to every CTA.
// Four cluster barriers per step; each exchange buffer is written again
// only after its readers have passed another cluster barrier.
//
// Theta must stay exactly symmetric: cell (k, l) is computed by the owner
// of k and (l, k) by the owner of l. Both form the pair sum u_k v_l +
// v_k u_l in float with each product and the sum rounded once and no
// contraction (multiplication and addition commute, so both get the same
// bits), add it over the edges in the same order with the same weights,
// and take the same step from symmetric theta, noise and prior.
//
// The gather is in the kernel: step t+1's pre-window rows (full neighbor
// rows, this CTA's columns of the node rows), the phi sums and the phi
// noise slice are copied with cp.async (16-byte chunks when K is a
// multiple of 4) as soon as step t has read its own (after its phi step);
// the owned rows of the theta noise are copied at the start of the step
// that uses them. Lanes with mcode > 0 are copied from the staged rows:
// this CTA's slice for a node lane, all S CTAs' slices (distributed
// shared memory) for a neighbor lane, which needs its full row. The
// staged rows never leave shared memory; after the last step each CTA
// writes its columns of the rows _last_write_wins keeps, CTA 0 their
// sums, each CTA its rows of theta. The sentinel N reads row N-1, as
// _window_gather clamps it; masked lanes never reach the state.
//
// Precision: the full MMSB's trajectories are ill-conditioned (1/theta
// and the SGRLD steps' abs() of near-cancellations amplify rounding;
// docs/design.md "Windowed MMSB tolerances"). The kernel keeps every
// float32 operand and result but accumulates every sum in double (the
// four products of a float4 of g_link and p_e, and the fan-in's pair
// sums, are formed in float before they are added) and takes the phi and
// theta steps in double, so a window lands closer to a float64 evaluation
// than the float32 plain version. Division and sqrt are IEEE (no fast
// math).
//
// What bounds it on an H100: the bytes a window must move (~0.5 MB at
// T=12, B=33, n=32, E=32, K=64: ~0.15 us at 3.35 TB/s) and its ~0.8 M
// multiply-adds per step are far below the time of T dependent steps:
// the kernel is latency-bound, each barrier-separated stage costs a few
// thousand cycles of dependent shared-memory loads and double arithmetic
// whatever its work (PERF.md). The cluster spreads each step's work over
// S SMs (16 from K = 64); the stages are kept few (4 cluster and 7 block
// barriers per step, scripts/window_phases.py --kernels mmsb times each);
// the hot loops keep two or more independent sums and no branch, so their
// loads overlap.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Longest window: the step sizes travel in the kernel's parameters.
constexpr int kMaxWindow = 64;
// Largest cluster (16 is non-portable: the launch allows it explicitly).
constexpr int kMaxCluster = 16;

// Shared row stride of full rows: a multiple of 4 floats (16-byte vector
// loads) whose quarter is odd; mirrored by ops/window_mmsb.py::
// mmsb_window_smem_bytes.
__host__ __device__ inline int row_stride(int w) {
  const int q4 = (w + 3) / 4;
  return 4 * (q4 + 1 + (q4 % 2));
}

// Rows of B and theta per CTA: ceil(K / S), rounded up to a multiple of 4
// when K is one (16-byte copies); ops/window.py::window_slice_width.
__host__ __device__ inline int slice_width(int K, int S) {
  int w = (K + S - 1) / S;
  if (K % 4 == 0) w = (w + 3) / 4 * 4;
  return w;
}

__host__ __device__ inline size_t words_of_bits(size_t bits) {
  return (bits + 31) / 32;
}

// Offsets (in 4-byte words) of the shared arrays of one CTA; mirrored by
// ops/window_mmsb.py::mmsb_window_smem_bytes. The double arrays come
// first, then the float arrays (16-byte aligned), then the window's ids.
struct Layout {
  size_t glink, w, pin, rsnb, rin, ein, we, nb, nrow, bm, nd, nz, tz, th,
      staged, ssum, phis, nval, smc, snodes, snbrs, slanes, ybits, mbits,
      yebits, embits, total;
};

__host__ __device__ inline Layout layout(int T, int B, int n, int E, int K,
                                         int kw, int S) {
  const size_t R = (size_t)B + n, ldk = row_stride(K);
  const size_t TB = (size_t)T * B, TE = (size_t)T * E, Bn = (size_t)B * n;
  const size_t nl = (B + S - 1) / S;   // nodes a CTA owns, at most
  const size_t scratch = (size_t)(n > E ? n : E) * kw;
  Layout L;
  size_t o = 0;
  // doubles, two words each
  L.glink = o; o += 2 * scratch;       // g_link [kw, n]; p_e terms [E, kw]
  L.w = o;     o += 2 * Bn;            // w [n, B], from the owners
  L.pin = o;   o += 2 * S * nl * n;    // p partials of the owned nodes
  L.rsnb = o;  o += 2 * (size_t)n;     // neighbor row sums
  L.rin = o;   o += 2 * (size_t)S * B;  // row-sum partials [S, B]
  L.ein = o;   o += 2 * (size_t)S * E;  // p_e partials [S, E]
  L.we = o;    o += 4 * (size_t)E;     // mask / p_e by label [2, E]
  o = (o + 3) / 4 * 4;
  // floats
  L.nb = o;     o += (size_t)n * ldk;  // full neighbor rows [n, ldk]
  L.nrow = o;   o += (size_t)B * ldk;  // full new rows [B, ldk]
  L.bm = o;     o += (size_t)kw * ldk;  // owned rows of B [kw, ldk]
  L.nd = o;     o += (size_t)B * kw;   // node rows, owned columns [B, kw]
  L.nz = o;     o += (size_t)B * kw;   // phi noise, owned columns
  L.tz = o;     o += 2 * (size_t)kw * K;  // theta noise, owned rows
  L.th = o;     o += 2 * (size_t)kw * K;  // theta, owned rows [kw, K, 2]
  L.staged = o; o += TB * kw;          // staged rows, owned columns
  L.ssum = o;   o += TB;               // their sums
  L.phis = o;   o += B;                // the step's phi sums
  L.nval = o;   o += TB;               // valid neighbors per node and step
  // the window's ids, codes and lane maps; labels and masks as bits
  L.smc = o;    o += (size_t)T * R;
  L.snodes = o; o += TB;
  L.snbrs = o;  o += (size_t)T * n;
  L.slanes = o; o += TE;               // u | v << 16
  L.ybits = o;  o += words_of_bits(TB * n);
  L.mbits = o;  o += words_of_bits(TB);
  L.yebits = o; o += words_of_bits(TE);
  L.embits = o; o += words_of_bits(TE);
  L.total = o;
  return L;
}

__device__ __forceinline__ double warp_sum(double v) {
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

struct Params {
  // state, updated in place
  float* pi;               // [N, K]
  float* phi_sum;          // [N]
  // the window's operands, R = B + n; bools one byte each
  const bool* y;           // [T, B, n] neighbor edge labels
  const int* nodes;        // [T, B]    node ids (padded lanes: N)
  const int* nbrs;         // [T, n]    the step's shared neighbor ids
  const bool* node_mask;   // [T, B]
  const bool* keep;        // [T, B]    last write of its row
  const float* noise;      // [T, B, K] phi noise
  const float* tnoise;     // [T, K, K, 2] symmetrized theta noise
  const bool* y_edges;     // [T, E]
  const bool* edge_mask;   // [T, E]
  const int* lanes_u;      // [T, E]    endpoint node lanes
  const int* lanes_v;      // [T, E]
  const int* mcode;        // [T, R]    1 + staged slot, or 0
  const float* wts;        // [T]       minibatch weight
  const float* theta_in;   // [K, K, 2]
  float* theta_out;        // [K, K, 2]
  int T, B, n, E, K, N, kw;
  float alpha, n_nodes, inv_k, eta0, eta1, eta_diag0, eta_diag1;
  float eps_phi[kMaxWindow];    // phi step sizes of the T steps
  float eps_theta[kMaxWindow];  // theta step sizes
};

#ifdef MMSB_PHASES
// Opt-in phase profile (scripts/window_phases.py --mmsb builds with
// -DMMSB_PHASES): thread 0 of the first CTA adds the clock cycles from one
// barrier to the next into a slot per stage, over all steps.
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
// cost no registers across the step loop.
constexpr int kLayoutFields = sizeof(Layout) / sizeof(size_t);
#define SW(name) (smem + s_off[offsetof(Layout, name) / sizeof(size_t)])
#define SF(name) reinterpret_cast<float*>(SW(name))
#define SD(name) reinterpret_cast<double*>(SW(name))
#define SU(name) reinterpret_cast<unsigned*>(SW(name))
#define SI(name) reinterpret_cast<int*>(SW(name))

__global__ void __launch_bounds__(kThreads, 1) mmsb_window_kernel(Params P) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ unsigned s_off[kLayoutFields];
#ifdef MMSB_PHASES
  __shared__ unsigned long long s_phase[kPhases];
  long long t_last = clock64();
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int B = P.B, n = P.n, E = P.E, K = P.K, T = P.T, R = P.B + P.n;
  const int KW = P.kw;                      // slice width of the layout
  const int k0 = rank * KW;
  const int kw = min(K, k0 + KW) - k0;      // this CTA's rows of B, theta
  const int ld = row_stride(K);
  const int nl = (B + S - 1) / S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    const Layout L = layout(T, B, n, E, K, KW, S);
    const size_t* f = reinterpret_cast<const size_t*>(&L);
    for (int i = 0; i < kLayoutFields; ++i) s_off[i] = (unsigned)f[i];
#ifdef MMSB_PHASES
    for (int i = 0; i < kPhases; ++i) s_phase[i] = 0;
#endif
  }
  __syncthreads();

  // ---- the window's ids, codes and lane maps, its labels and masks as
  //      bits; theta's owned rows and B's; the padding columns zeroed ----
  {
    const size_t TB = (size_t)T * B;
    for (int i = tid; i < T * R; i += kThreads) SI(smc)[i] = P.mcode[i];
    for (int i = tid; i < T * B; i += kThreads) SI(snodes)[i] = P.nodes[i];
    for (int i = tid; i < T * n; i += kThreads) SI(snbrs)[i] = P.nbrs[i];
    for (int i = tid; i < T * E; i += kThreads)
      SU(slanes)[i] = (unsigned)P.lanes_u[i] | ((unsigned)P.lanes_v[i] << 16);
    pack_bits(SU(ybits), P.y, T * B * n, warp, lane);
    pack_bits(SU(mbits), P.node_mask, (int)TB, warp, lane);
    pack_bits(SU(yebits), P.y_edges, T * E, warp, lane);
    pack_bits(SU(embits), P.edge_mask, T * E, warp, lane);
    float* th = SF(th);
    float* bm = SF(bm);
    for (int i = tid; i < kw * K; i += kThreads) {
      const size_t c = (size_t)(k0 + i / K) * K + i % K;
      const float t0 = P.theta_in[2 * c], t1 = P.theta_in[2 * c + 1];
      th[2 * i] = t0;
      th[2 * i + 1] = t1;
      bm[(i / K) * ld + i % K] = t1 / (t0 + t1);
    }
    const int pad = ld - K;
    for (int i = tid; i < kw * pad; i += kThreads)
      bm[(i / pad) * ld + K + i % pad] = 0.f;
    for (int i = tid; i < (n + B) * pad; i += kThreads) {
      const int r = i / pad;
      float* row = r < n ? SF(nb) + r * ld : SF(nrow) + (r - n) * ld;
      row[K + i % pad] = 0.f;
    }
  }
  __syncthreads();
  // the valid-neighbor count of every node lane of the window (a shared
  // neighbor that is the node itself is excluded)
  for (int i = tid; i < T * B; i += kThreads) {
    const int* nb_ids = SI(snbrs) + (i / B) * n;
    const int node = SI(snodes)[i];
    float cnt = 0.f;
    for (int j = 0; j < n; ++j) cnt += nb_ids[j] != node ? 1.f : 0.f;
    SF(nval)[i] = cnt;
  }

  // The gather of step t (one cp.async group): the full neighbor rows and
  // this CTA's columns of the node rows whose value is the pre-window one,
  // the node lanes' phi sums, and the phi noise slice; one chunk of a row
  // per thread.
  const bool vec = K % 4 == 0;
  const int width = vec ? 4 : 1;
  auto copy = [&](float* dst, const float* src) {
    if (vec)
      cp_async16(dst, src);
    else
      cp_async4(dst, src);
  };
  auto gather = [&](int t) {
    const int* mct = SI(smc) + t * R;
    const int* nd_ids = SI(snodes) + t * B;
    const int* nb_ids = SI(snbrs) + t * n;
    const int nchunk_k = (K + width - 1) / width;
    const int nchunk_w = (kw + width - 1) / width;
    // neighbor rows: chunk i of row j, all of the block's threads
    for (int i = tid; i < n * nchunk_k; i += kThreads) {
      const int j = i / nchunk_k, c = i - j * nchunk_k;
      if (mct[B + j] > 0) continue;   // staged in-window: redirected
      copy(SF(nb) + j * ld + c * width,
           P.pi + (size_t)nb_ids[j] * K + c * width);
    }
    // node rows (owned columns) and the phi noise slice
    const float* noise_t = P.noise + (size_t)t * B * K + k0;
    for (int i = tid; i < B * nchunk_w; i += kThreads) {
      const int b = i / nchunk_w, c = i - b * nchunk_w;
      copy(SF(nz) + b * KW + c * width, noise_t + (size_t)b * K + c * width);
      if (mct[b] > 0) continue;
      const int id = min(nd_ids[b], P.N - 1);
      copy(SF(nd) + b * KW + c * width, P.pi + (size_t)id * K + k0 + c * width);
    }
    for (int b = tid; b < B; b += kThreads)
      if (mct[b] == 0) cp_async4(SF(phis) + b, P.phi_sum + min(nd_ids[b], P.N - 1));
    cp_async_commit();
  };
  // the owned rows of step t's theta noise (one group)
  auto gather_tnoise = [&](int t) {
    const float* src = P.tnoise + ((size_t)t * K + k0) * K * 2;
    for (int i = tid; i < (2 * kw * K) / width; i += kThreads)
      copy(SF(tz) + i * width, src + i * width);
    cp_async_commit();
  };
  gather(0);
  PHASE(0);

  for (int t = 0; t < T; ++t) {
#ifdef MMSB_PHASES
    // calibration: a bare block barrier and a bare cluster barrier
    __syncthreads();
    PHASE(13);
    cluster.sync();
    PHASE(14);
#endif
    const int* const nd_ids = SI(snodes) + t * B;
    const int* const nb_ids = SI(snbrs) + t * n;
    const unsigned* const ybits = SU(ybits);
    const size_t ybase = (size_t)t * B * n;
    // ---- 0. this step's theta noise; the reads of rows an earlier step
    //         wrote, from the staged rows; then wait for this step's
    //         gather ------------------------------------------------------
    gather_tnoise(t);
    {
      const int* mc = SI(smc) + t * R;
      float* staged = SF(staged);
      float* nd = SF(nd);
      float* nb = SF(nb);
      for (int b = warp; b < B; b += kWarps) {
        const int c = mc[b];
        if (c == 0) continue;
        for (int kk = lane; kk < kw; kk += 32)
          nd[b * KW + kk] = staged[(size_t)(c - 1) * KW + kk];
        if (lane == 0) SF(phis)[b] = SF(ssum)[c - 1];
      }
      // a neighbor lane needs the full row: each CTA's columns from its
      // own staged slice, through distributed shared memory
      for (int j = warp; j < n; j += kWarps) {
        const int c = mc[B + j];
        if (c == 0) continue;
        for (int k = lane; k < K; k += 32) {
          const int x = k / KW;
          const float* src = x == rank ? staged
                                       : cluster.map_shared_rank(staged, x);
          nb[j * ld + k] = src[(size_t)(c - 1) * KW + (k - x * KW)];
        }
      }
    }
    cp_async_wait_older();
    __syncthreads();
    PHASE(1);

    // ---- 1. neighbor row sums (one warp per row), and g_link[j, k] =
    //         sum_l pi_nb[j, l] B[k, l] for the owned k, one per thread
    //         (stored [kw, n]) ---------------------------------------------
    {
      const float* nb = SF(nb);
      for (int j = warp; j < n; j += kWarps) {
        double acc = 0.0;
        for (int k = lane; k < K; k += 32) acc += nb[j * ld + k];
        acc = warp_sum(acc);
        if (lane == 0) SD(rsnb)[j] = acc;
      }
      const float* bm = SF(bm);
      double* glink = SD(glink);
      const int k4 = (K + 3) / 4;   // the padding columns are zero
      for (int item = tid; item < kw * n; item += kThreads) {
        const int kk = item / n, j = item - kk * n;
        const float4* pb = reinterpret_cast<const float4*>(nb + j * ld);
        const float4* br = reinterpret_cast<const float4*>(bm + kk * ld);
        // each quad's four products summed in float, the quads in double
        // (two sums, even and odd quads: half the dependent chain)
        double g0 = 0.0, g1 = 0.0;
#pragma unroll 4
        for (int q = 0; q < k4; ++q) {
          const float4 a = pb[q], c = br[q];
          const double v = (a.x * c.x + a.y * c.y) + (a.z * c.z + a.w * c.w);
          if (q & 1)
            g1 += v;
          else
            g0 += v;
        }
        glink[item] = g0 + g1;
      }
    }
    __syncthreads();
    PHASE(2);

    // ---- 2. partial p[b, j] over the owned columns, y ? g_link : g_non,
    //         pushed to the node's owner (b mod S), slot [rank, b / S, j] -
    {
      const double* glink = SD(glink);
      const double* rsnb = SD(rsnb);
      const float* nd = SF(nd);
      double* pin = SD(pin);
      for (int item = tid; item < B * n; item += kThreads) {
        const int b = item / n, j = item - b * n;
        const bool link = bit(ybits, ybase + item);
        const double rs = rsnb[j];
        double p = 0.0;
#pragma unroll 4
        for (int kk = 0; kk < kw; ++kk) {
          const double g = glink[kk * n + j];
          p += nd[b * KW + kk] * (link ? g : rs - g);
        }
        cluster.map_shared_rank(pin, b % S)[((size_t)rank * nl + b / S) * n + j] = p;
      }
    }
    cluster.sync();
    PHASE(3);

    // ---- 3. the owners: p summed over the ranks in order, w = mask / p
    //         (masked pairs must not turn into NaN), pushed to every CTA --
    {
      const double* pin = SD(pin);
      double* w = SD(w);
      for (int lb = warp; lb * S + rank < B; lb += kWarps) {
        const int b = lb * S + rank;
        for (int j = lane; j < n; j += 32) {
          double p = 0.0;
          for (int r = 0; r < S; ++r) p += pin[((size_t)r * nl + lb) * n + j];
          const bool valid = nb_ids[j] != nd_ids[b];
          if (!valid) p = 1.0;
          const double v = valid ? 1.0 / p : 0.0;
          for (int x = 0; x < S; ++x) cluster.map_shared_rank(w, x)[j * B + b] = v;
        }
      }
    }
    cluster.sync();
    PHASE(4);

    // ---- 4. sc and the phi SGRLD step on the owned columns, one (k, b)
    //         per thread; phi' goes to this CTA's columns of the new rows -
    {
      const double eps_t = P.eps_phi[t];
      const double* glink = SD(glink);
      const double* rsnb = SD(rsnb);
      const double* w = SD(w);
      const float* nd = SF(nd);
      const float* nz = SF(nz);
      const float* phis = SF(phis);
      const float* nval = SF(nval) + t * B;
      float* nrow = SF(nrow);
      for (int item = tid; item < kw * B; item += kThreads) {
        const int kk = item / B, b = item - kk * B;
        const double* gl = glink + kk * n;
        double s0 = 0.0, s1 = 0.0;   // even and odd neighbors
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const double g = gl[j];
          const double v = w[j * B + b] * (bit(ybits, ybase + b * n + j) ? g : rsnb[j] - g);
          if (j & 1)
            s1 += v;
          else
            s0 += v;
        }
        const double s = s0 + s1;
        const double phis_b = phis[b];
        const double grads = (s - nval[b]) * (1.0 / phis_b);
        const double phi_k = nd[b * KW + kk] * phis_b;
        const double v = fabs(phi_k
                              + eps_t / 2.0 * (P.alpha - phi_k + ((double)P.n_nodes / nval[b]) * grads)
                              + sqrt(eps_t * phi_k) * nz[b * KW + kk]);
        nrow[b * ld + k0 + kk] = (float)fmax(v, 1e-24);
      }
    }
    __syncthreads();
    PHASE(5);
    // the step's rows, sums and phi noise are read: step t+1's gather
    if (t + 1 < T)
      gather(t + 1);
    else
      cp_async_commit();   // an empty group keeps the waits uniform

    // ---- 5. this CTA's columns of phi' to every CTA, with its row-sum
    //         partials (slot [rank, b]), one warp per row ------------------
    {
      float* nrow = SF(nrow);
      double* rin = SD(rin);
      for (int b = warp; b < B; b += kWarps) {
        double acc = 0.0;
        for (int kk = lane; kk < kw; kk += 32) {
          const int at = b * ld + k0 + kk;
          const float v = nrow[at];
          acc += v;
          for (int x = 0; x < S; ++x)
            if (x != rank) cluster.map_shared_rank(nrow, x)[at] = v;
        }
        acc = warp_sum(acc);
        if (lane < S) cluster.map_shared_rank(rin, lane)[rank * B + b] = acc;
      }
    }
    cluster.sync();
    PHASE(6);

    // ---- 6. the row sums (ranks in order), full rows normalized, the
    //         owned columns staged; masked node lanes read 1/K from here
    //         on (the theta stage) -----------------------------------------
    {
      const double* rin = SD(rin);
      const unsigned* mbits = SU(mbits);
      float* nrow = SF(nrow);
      float* staged = SF(staged) + (size_t)t * B * KW;
      for (int b = warp; b < B; b += kWarps) {
        double rs = 0.0;
        for (int r = 0; r < S; ++r) rs += rin[r * B + b];
        const double inv_rs = 1.0 / rs;
        const bool valid = bit(mbits, (size_t)t * B + b);
        for (int k = lane; k < K; k += 32) {
          const float v = (float)(nrow[b * ld + k] * inv_rs);
          const int kk = k - k0;
          if (kk >= 0 && kk < kw) staged[b * KW + kk] = v;
          nrow[b * ld + k] = valid ? v : P.inv_k;
        }
        if (lane == 0) SF(ssum)[t * B + b] = (float)rs;
      }
    }
    __syncthreads();
    PHASE(7);

    // ---- 7. p_e = sum_k pi_u[e,k] sum_l F[k,l] pi_v[e,l]: the terms of
    //         the owned k, one (e, k) per thread; their sum per edge (one
    //         warp each) pushed to every CTA, slot [rank, e] ----------------
    const unsigned* const slanes = SU(slanes) + t * E;
    const unsigned* const yebits = SU(yebits);
    {
      const float* nrow = SF(nrow);
      const float* bm = SF(bm);
      double* pet = SD(glink);
      const int k4 = (K + 3) / 4;
      for (int item = tid; item < E * kw; item += kThreads) {
        const int e = item / kw, kk = item - e * kw;
        const unsigned pk = slanes[e];
        const float4* pv = reinterpret_cast<const float4*>(nrow + (pk >> 16) * ld);
        const float4* br = reinterpret_cast<const float4*>(bm + kk * ld);
        const bool link = bit(yebits, (size_t)t * E + e);
        // F = y ? B : 1 - B as f = s0 + s1 B; the quads summed as g_link's
        const float s0 = link ? 0.f : 1.f, s1 = link ? 1.f : -1.f;
        double h0 = 0.0, h1 = 0.0;
#pragma unroll 4
        for (int q = 0; q < k4; ++q) {
          const float4 a = pv[q], c = br[q];
          const double v = ((s0 + s1 * c.x) * a.x + (s0 + s1 * c.y) * a.y)
                           + ((s0 + s1 * c.z) * a.z + (s0 + s1 * c.w) * a.w);
          if (q & 1)
            h1 += v;
          else
            h0 += v;
        }
        pet[item] = nrow[(pk & 0xffffu) * ld + k0 + kk] * (h0 + h1);
      }
    }
    __syncthreads();
    {
      const double* pet = SD(glink);
      double* ein = SD(ein);
      for (int e = warp; e < E; e += kWarps) {
        double acc = 0.0;
        for (int kk = lane; kk < kw; kk += 32) acc += pet[e * kw + kk];
        acc = warp_sum(acc);
        if (lane < S) cluster.map_shared_rank(ein, lane)[rank * E + e] = acc;
      }
    }
    cp_async_wait_older();   // this step's theta noise
    cluster.sync();
    PHASE(8);

    // ---- 8. the edge weights mask / p_e (ranks in order), by label:
    //         [0, e] for the linked sum, [1, e] for the unlinked one -------
    {
      const double* ein = SD(ein);
      const unsigned* embits = SU(embits);
      double* we = SD(we);
      for (int e = tid; e < E; e += kThreads) {
        double pe = 0.0;
        for (int r = 0; r < S; ++r) pe += ein[r * E + e];
        const double w = bit(embits, (size_t)t * E + e) ? 1.0 / pe : 0.0;
        const bool link = bit(yebits, (size_t)t * E + e);
        we[e] = link ? w : 0.0;
        we[E + e] = link ? 0.0 : w;
      }
    }
    __syncthreads();
    PHASE(9);

    // ---- 9. the symmetrized gradient fan-in and the theta SGRLD step of
    //         the owned cells, one (k, l) per thread ----------------------
    {
      const double eps_b = P.eps_theta[t];
      const double wt = P.wts[t];
      const float* nrow = SF(nrow);
      const double* we = SD(we);
      const float* tz = SF(tz);
      float* th = SF(th);
      float* bm = SF(bm);
      for (int item = tid; item < kw * K; item += kThreads) {
        const int kk = item / K, l = item - kk * K;
        const int k = k0 + kk;
        double sl = 0.0, sn = 0.0;
        // no branch in the edge loop, so it unrolls and its loads overlap:
        // a masked edge has weight 0 and adds an exact 0 to both sums
#pragma unroll 4
        for (int e = 0; e < E; ++e) {
          const unsigned pk = slanes[e];
          const float* pu = nrow + (pk & 0xffffu) * ld;
          const float* pv = nrow + (pk >> 16) * ld;
          // u_k v_l + v_k u_l in float, each product and the sum rounded
          // once (no contraction): the same bits for (k, l) and (l, k)
          const double pair = __fadd_rn(__fmul_rn(pu[k], pv[l]),
                                        __fmul_rn(pv[k], pu[l]));
          sl += we[e] * pair;
          sn += we[E + e] * pair;
        }
        {
          const int c = kk * K + l;
          const double t0 = th[2 * c], t1 = th[2 * c + 1];
          const double bkl = bm[kk * ld + l];
          // one division: d = 1 / (t0 t1 (t0 + t1)) gives 1/(t0 + t1) and,
          // without their cancellation, 1/t0 - 1/(t0 + t1) = t1^2 d and
          // 1/t1 - 1/(t0 + t1) = t0^2 d (labels are exactly 0 or 1)
          const double d = 1.0 / (t0 * t1 * (t0 + t1));
          const double inv_ts = t0 * t1 * d;
          const double g0 = 0.5 * (bkl * sl * -inv_ts
                                   + (1.0 - bkl) * sn * (t1 * t1 * d));
          const double g1 = 0.5 * (bkl * sl * (t0 * t0 * d)
                                   + (1.0 - bkl) * sn * -inv_ts);
          const double e0 = k == l ? P.eta_diag0 : P.eta0;
          const double e1 = k == l ? P.eta_diag1 : P.eta1;
          const float n0 = (float)fmax(
              fabs(t0 + eps_b / 2.0 * (e0 - t0 + wt * g0)
                   + sqrt(eps_b * t0) * tz[2 * c]), 1e-24);
          const float n1 = (float)fmax(
              fabs(t1 + eps_b / 2.0 * (e1 - t1 + wt * g1)
                   + sqrt(eps_b * t1) * tz[2 * c + 1]), 1e-24);
          th[2 * c] = n0;
          th[2 * c + 1] = n1;
          bm[kk * ld + l] = n1 / (n0 + n1);   // the next step's B
        }
      }
    }
    __syncthreads();
    PHASE(10);
  }

  // ---- the scatter: each CTA its columns of the rows _last_write_wins
  //      keeps (unique rows), CTA 0 their sums, each CTA its rows of
  //      theta. Every read of pi and phi_sum came before the barriers
  //      above. ------------------------------------------------------------
  {
    const int* snodes = SI(snodes);
    const float* staged = SF(staged);
    for (int tb = warp; tb < T * B; tb += kWarps) {
      if (!P.keep[tb]) continue;
      float* dst = P.pi + (size_t)snodes[tb] * K + k0;
      for (int kk = lane; kk < kw; kk += 32) dst[kk] = staged[(size_t)tb * KW + kk];
    }
    if (rank == 0)
      for (int tb = tid; tb < T * B; tb += kThreads)
        if (P.keep[tb]) P.phi_sum[snodes[tb]] = SF(ssum)[tb];
    const float* th = SF(th);
    float* out = P.theta_out + (size_t)k0 * K * 2;
    for (int i = tid; i < 2 * kw * K; i += kThreads) out[i] = th[i];
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster.sync();
  PHASE(11);
#ifdef MMSB_PHASES
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_phase_cycles[i] += s_phase[i];
#endif
}

#undef SW
#undef SF
#undef SD
#undef SU
#undef SI

cudaError_t set_attributes(size_t smem, int S) {
  cudaError_t err = cudaFuncSetAttribute(
      mmsb_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess && S > 8)
    err = cudaFuncSetAttribute(
        mmsb_window_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace

// Bytes of shared memory per CTA with a cluster of S CTAs.
extern "C" size_t mmsb_window_smem_bytes(int T, int B, int n, int E, int K,
                                         int S) {
  return layout(T, B, n, E, K, slice_width(K, S), S).total * sizeof(unsigned);
}

// Launches one cluster of S CTAs on `stream`; returns the launch's CUDA
// error (0 on success). pi [N, K] and phi_sum [N] are updated in place;
// `eps_phi` and `eps_theta` are host arrays of T floats.
extern "C" int mmsb_window_launch(
    float* pi, float* phi_sum, const bool* y, const int* nodes,
    const int* nbrs, const bool* node_mask, const bool* keep,
    const float* noise, const float* tnoise, const bool* y_edges,
    const bool* edge_mask, const int* lanes_u, const int* lanes_v,
    const int* mcode, const float* wts, const float* theta_in,
    float* theta_out, int T, int B, int n, int E, int K, int N, int S,
    float alpha, float n_nodes, float inv_k, float eta0, float eta1,
    float eta_diag0, float eta_diag1, const float* eps_phi,
    const float* eps_theta, void* stream) {
  // lanes are packed in 16 bits each
  if (T < 1 || T > kMaxWindow || S < 1 || S > kMaxCluster || B > 0xffff)
    return (int)cudaErrorInvalidValue;
  const int kw = slice_width(K, S);
  if ((S - 1) * kw >= K) return (int)cudaErrorInvalidValue;  // empty slice
  Params P{pi, phi_sum, y, nodes, nbrs, node_mask, keep, noise, tnoise,
           y_edges, edge_mask, lanes_u, lanes_v, mcode, wts, theta_in,
           theta_out, T, B, n, E, K, N, kw, alpha, n_nodes, inv_k, eta0,
           eta1, eta_diag0, eta_diag1, {}, {}};
  for (int t = 0; t < T; ++t) {
    P.eps_phi[t] = eps_phi[t];
    P.eps_theta[t] = eps_theta[t];
  }
  const size_t smem = mmsb_window_smem_bytes(T, B, n, E, K, S);
  cudaError_t err = set_attributes(smem, S);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mmsb_window_kernel, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef MMSB_PHASES
// Copies the phase cycles out (kPhases values) and zeroes them.
extern "C" int mmsb_window_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif
