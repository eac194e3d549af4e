// T sequential a-MMSB SGRLD steps of one window, one thread block per
// chain.
//
// Replaces the Pallas TPU kernel mcmc_ammsb_tpu/ops/window.py::
// _window_kernel (reached through window_kernel_call -> pl.pallas_call)
// with the collision correction on, in both of its modes: one chain
// (n_chains = 1, the main path; called through
// mcmc_ammsb_tpu_torch/ops/window.py::window_core_cuda, plain version
// window_core_torch) and C independent chains (n_chains = C > 1, the flat
// chain engine; window_chain_core_cuda, plain version
// window_chain_core_torch). Both go through window_kernel_launch, with
// C = 1 for the first.
//
// Chains: the TPU kernel stacks the C chains' rows into block-diagonal
// [C*B, C*n] pair tensors and [C*E, C*B] edge one-hots so that one
// matrix-unit product serves every chain. Chains never interact inside
// a window, so here block c of a C-block grid runs chain c's T steps on
// its own contiguous slice of every operand (all operands chain-major,
// [C, T, ...]), with its own theta, beta and weights; the step sizes are
// shared (the chains run in lockstep). The staged rows come out
// chain-major [C, T*B, K] and the read codes are chain-local, so block c
// redirects reads into its own [T*B, K] slice. No block-diagonal tensor
// is formed, and the shared memory per block is that of one chain,
// independent of C and T.
//
// Per step t, exactly the JAX kernel's math:
//   1. read rows: lane r reads staged row mcode-1 when mcode > 0 (a row
//      an earlier step of the window wrote), else the gathered g[t, r].
//      The TPU kernel does this with a 0/1 one-hot matrix product to
//      feed its matrix unit; an indexed load gives the same bits.
//   2. phi: q = (pi_n * (beta - eps)) . pi_nb, p = s q + e, the masked
//      1/p coefficients, contrib = a . pi_nb, the SGRLD step with noise,
//      the 1e-24 floor and the row normalization; rows are staged in
//      rows_out, which is also the buffer step 1 redirects reads to.
//   3. beta: edge endpoint e reads staged row lanes_u[e] / lanes_v[e]
//      (masked node lanes replaced by 1/K), the per-edge sums, the
//      gradient fan-in over edges, then the theta SGRLD step (abs,
//      floor) and beta = theta1 / (theta0 + theta1).
//
// What bounds it on an H100: the two contractions are ~2 B n K FMAs per
// step (0.54 M at B=33, n=32, K=256) and a chain's window runs on ONE
// SM, whose ~128 FP32 FMA/clock make that at least ~2.5 us per step
// before the reductions and barriers. It is latency- and one-SM-bound,
// not bandwidth-bound: the operands are ~0.1 MB per step and chain. C
// chains fill C of the card's 132 SMs for about the time of one.
//
// What the design does about it, kept simple for a first kernel: one
// block of 512 threads per chain; the corrected read rows of the step
// ([B+n, K], 67 KB at the bench shape), the nodes' pi * (beta - eps)
// rows, theta, beta and the step's small operands live in shared
// memory; rows are
// copied one warp per row so every lane has independent loads in
// flight. Both contractions were bound by shared-memory load
// throughput, so each load serves several FMAs: q gives lane j of a
// warp neighbor j's 16-byte row chunks for up to 3 nodes at once (rows
// padded to a stride that keeps those loads free of bank conflicts);
// contrib keeps a thread's column of the n neighbor rows in registers
// for all the nodes of its group. Row sums, per-node and per-edge sums
// are warp reductions; the gradient fan-in is one thread per k. The
// staged rows (T B K floats, 405 KB at the bench shape) exceed shared
// memory and stay in the global output buffer, which L2 holds.
// Splitting K across a thread block cluster is the next step for this
// kernel.
//
// Division and sqrt are IEEE (no fast math): 1/p and 1/phi amplify
// error.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// The contrib loop keeps a thread's column of the neighbor rows in
// registers; the window_kernel_launch entry refuses n > kMaxNeighbors.
constexpr int kMaxNeighbors = 32;
// q is computed for up to this many nodes per warp in one pass, so each
// neighbor-row load serves several nodes.
constexpr int kNodesPerWarp = 3;

// Longest window: the step sizes travel in the kernel's parameters.
constexpr int kMaxWindow = 64;

// Shared row stride: a multiple of 4 floats (16-byte vector loads) whose
// quarter is odd, so the 8 lanes of a quarter-warp reading 16 bytes of 8
// different rows hit 8 different bank groups.
__host__ __device__ inline int row_stride(int K) {
  const int q4 = (K + 3) / 4;
  return 4 * (q4 + 1 + (q4 % 2));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  // inputs, per chain (each array is [C, ...] of these, chain-major);
  // T = window steps, R = B + n; bool arrays are one byte each
  const float* g;          // [T, R, K] gathered rows (nodes, then nbrs)
  const float* sums;       // [T, B]    gathered phi sums
  const bool* y;           // [T, B, n] neighbor edge labels
  const int* nodes;        // [T, B]    node ids (padded lanes: N)
  const int* nbrs;         // [T, n]    the step's shared neighbor ids
  const bool* node_mask;   // [T, B]
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
  // outputs
  float* rows_out;         // [T*B, K] staged rows (read back in-window)
  float* sums_out;         // [T*B]
  float* theta_out;        // [K, 2]
  float* beta_out;         // [K]
  int T, B, n, E, K;
  float eps, one_minus_eps, alpha, n_nodes, eta0, eta1, inv_k;
  float eps_phi[kMaxWindow];    // phi step sizes of the T steps
  float eps_theta[kMaxWindow];  // theta step sizes
};

// Shared-memory words (4 bytes each): the step's rows [R, ld] and the
// nodes' pi * (beta - eps) rows [B, ld]; theta0, theta1, beta [K] each;
// the pair labels, pair mask and coefficients a [B, n] each;
// five [B] vectors; the edge labels, mask, sums and both lane maps [E]
// each; the read codes [R].
__host__ __device__ inline size_t smem_words(int B, int n, int E, int K) {
  return (size_t)(2 * B + n) * row_stride(K) + 3 * (size_t)K
         + 3 * (size_t)B * n + 5 * (size_t)B + 5 * (size_t)E
         + (size_t)(B + n);
}

__global__ void __launch_bounds__(kThreads) window_kernel(Params P) {
  extern __shared__ float smem[];
  const int B = P.B, n = P.n, E = P.E, K = P.K, R = P.B + P.n;
  const int ld = row_stride(K);    // shared row stride
  float* rows = smem;              // [R, ld]
  float* wrow = rows + (size_t)R * ld;  // [B, ld] pi_n * (beta - eps)
  float* th0 = wrow + (size_t)B * ld;
  float* th1 = th0 + K;
  float* bet = th1 + K;
  float* yf = bet + K;             // [B, n]  this step's pair labels
  float* mf = yf + B * n;          // [B, n]  pair mask
  float* coef_a = mf + B * n;      // [B, n]  s/p * mask
  float* phis = coef_a + B * n;    // [B]
  float* ce = phis + B;            // [B]
  float* nval = ce + B;            // [B]
  float* rsum = nval + B;          // [B]
  float* nmask = rsum + B;         // [B]
  float* yef = nmask + B;          // [E] edge labels
  float* emf = yef + E;            // [E] edge mask
  float* prsum = emf + E;          // [E] sum_k probs + prob_0
  int* lu = reinterpret_cast<int*>(prsum + E);  // [E] endpoint lanes
  int* lv = lu + E;                              // [E]
  int* mc = lv + E;                              // [R] read codes

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float eps = P.eps;

  // this block's chain: its slice of every operand
  const size_t chain = blockIdx.x;
  const size_t TB = (size_t)P.T * B, TE = (size_t)P.T * E;
  const float* g_in = P.g + chain * P.T * R * K;
  const float* sums_in = P.sums + chain * TB;
  const bool* y_in = P.y + chain * TB * n;
  const int* nodes_in = P.nodes + chain * TB;
  const int* nbrs_in = P.nbrs + chain * P.T * n;
  const bool* node_mask_in = P.node_mask + chain * TB;
  const float* noise_in = P.noise + chain * TB * K;
  const float* bnoise_in = P.bnoise + chain * P.T * K * 2;
  const bool* y_edges_in = P.y_edges + chain * TE;
  const bool* edge_mask_in = P.edge_mask + chain * TE;
  const int* lanes_u_in = P.lanes_u + chain * TE;
  const int* lanes_v_in = P.lanes_v + chain * TE;
  const int* mcode_in = P.mcode + chain * P.T * R;
  const float* wts_in = P.wts + chain * P.T;
  float* rows_out = P.rows_out + chain * TB * K;
  float* sums_out = P.sums_out + chain * TB;

  for (int k = tid; k < K; k += blockDim.x) {
    th0[k] = P.theta_in[chain * K * 2 + 2 * k];
    th1[k] = P.theta_in[chain * K * 2 + 2 * k + 1];
    bet[k] = P.beta_in[chain * K + k];
  }
  // zero the row padding once: the vector loads of step 2 read it
  for (int i = tid; i < (R + B) * (ld - K); i += blockDim.x)
    rows[(i / (ld - K)) * ld + K + i % (ld - K)] = 0.f;

  for (int t = 0; t < P.T; ++t) {
    // ---- 0. the step's small operands, staged once -------------------
    for (int r = tid; r < R; r += blockDim.x) mc[r] = mcode_in[(size_t)t * R + r];
    for (int b = tid; b < B; b += blockDim.x) {
      const int c = mcode_in[(size_t)t * R + b];
      phis[b] = c > 0 ? sums_out[c - 1] : sums_in[(size_t)t * B + b];
      nmask[b] = node_mask_in[(size_t)t * B + b] ? 1.f : 0.f;
    }
    for (int i = tid; i < B * n; i += blockDim.x) {
      const int b = i / n, j = i - b * n;
      yf[i] = y_in[(size_t)t * B * n + i] ? 1.f : 0.f;
      // a shared neighbor that is the node itself is excluded
      mf[i] = nbrs_in[(size_t)t * n + j] != nodes_in[(size_t)t * B + b] ? 1.f : 0.f;
    }
    for (int e = tid; e < E; e += blockDim.x) {
      yef[e] = y_edges_in[(size_t)t * E + e] ? 1.f : 0.f;
      emf[e] = edge_mask_in[(size_t)t * E + e] ? 1.f : 0.f;
      lu[e] = lanes_u_in[(size_t)t * E + e];
      lv[e] = lanes_v_in[(size_t)t * E + e];
    }
    __syncthreads();

    // ---- 1. corrected reads, one warp per row: a row an earlier step
    //         of the window wrote comes from the staging buffer; node
    //         rows also give w = pi_n * (beta - eps) ---------------------
    const float* gt = g_in + (size_t)t * R * K;
    for (int r = warp; r < R; r += nwarps) {
      const int c = mc[r];
      const float* src = c > 0 ? rows_out + (size_t)(c - 1) * K
                               : gt + (size_t)r * K;
#pragma unroll 4
      for (int k = lane; k < K; k += 32) {
        const float v = src[k];
        rows[r * ld + k] = v;
        if (r < B) wrow[r * ld + k] = v * (bet[k] - eps);
      }
    }
    __syncthreads();

    // ---- 2. q = w . pi_nb and the pair coefficients: lane j of a warp
    //         owns neighbor j, for up to kNodesPerWarp nodes at once
    //         (16-byte loads; the row padding is zero); the warp's sums
    //         over its lanes give the per-node e/p sum and mask count ---
    for (int base = warp; base < B; base += kNodesPerWarp * nwarps) {
      float s_ce[kNodesPerWarp] = {}, s_n[kNodesPerWarp] = {};
      for (int j = lane; j < n; j += 32) {
        const float4* pb = reinterpret_cast<const float4*>(rows + (B + j) * ld);
        float acc[kNodesPerWarp] = {};
        for (int k4 = 0; k4 < (K + 3) / 4; ++k4) {
          const float4 v = pb[k4];
#pragma unroll
          for (int q = 0; q < kNodesPerWarp; ++q) {
            const int b = base + q * nwarps;
            if (b < B) {
              const float4 w = reinterpret_cast<const float4*>(wrow + b * ld)[k4];
              acc[q] += w.x * v.x;
              acc[q] += w.y * v.y;
              acc[q] += w.z * v.z;
              acc[q] += w.w * v.w;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kNodesPerWarp; ++q) {
          const int b = base + q * nwarps;
          if (b >= B) continue;
          const int pair = b * n + j;
          const float y = yf[pair], m = mf[pair];
          const float sgn = 2.f * y - 1.f;
          const float e = y > 0.5f ? eps : P.one_minus_eps;
          float p = sgn * acc[q] + e;
          if (!(m > 0.5f)) p = 1.f;   // masked lanes must not turn into NaN
          const float inv_p = 1.f / p;
          coef_a[pair] = sgn * inv_p * m;
          s_ce[q] += e * inv_p * m;
          s_n[q] += m;
        }
      }
#pragma unroll
      for (int q = 0; q < kNodesPerWarp; ++q) {
        const float a = warp_sum(s_ce[q]), c = warp_sum(s_n[q]);
        const int b = base + q * nwarps;
        if (lane == 0 && b < B) {
          ce[b] = a;
          nval[b] = c;
        }
      }
    }
    __syncthreads();

    // ---- 3. contrib and the phi SGRLD step: a thread owns column k of
    //         a group of nodes and keeps that column of the neighbor
    //         rows in registers; phi' overwrites the node's own row ------
    const float eps_t = P.eps_phi[t];
    const float* noise_t = noise_in + (size_t)t * B * K;
    const int groups = blockDim.x >= K ? blockDim.x / K : 1;
    for (int item = tid; item < K * groups; item += blockDim.x) {
      const int k = item % K, grp = item / K;
      float col[kMaxNeighbors];
#pragma unroll
      for (int j = 0; j < kMaxNeighbors; ++j)
        col[j] = j < n ? rows[(B + j) * ld + k] : 0.f;
      const float bk = bet[k] - eps;
      for (int b = grp; b < B; b += groups) {
        const float xi = noise_t[b * K + k];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxNeighbors; ++j)
          if (j < n) acc += coef_a[b * n + j] * col[j];
        const float s_contrib = bk * acc + ce[b];
        const float grads = (s_contrib - nval[b]) * (1.f / phis[b]);
        const float phi_k = rows[b * ld + k] * phis[b];
        const float v = fabsf(phi_k
                              + eps_t / 2.f * (P.alpha - phi_k + (P.n_nodes / nval[b]) * grads)
                              + sqrtf(eps_t * phi_k) * xi);
        rows[b * ld + k] = fmaxf(v, 1e-24f);
      }
    }
    __syncthreads();

    // ---- 4. row sums of phi', one warp per row -------------------------
    for (int b = warp; b < B; b += nwarps) {
      float acc = 0.f;
      for (int k = lane; k < K; k += 32) acc += rows[b * ld + k];
      acc = warp_sum(acc);
      if (lane == 0) rsum[b] = acc;
    }
    __syncthreads();

    // ---- 5. normalize, stage, sanitize masked lanes for the beta stage
    for (int i = tid; i < B * K; i += blockDim.x) {
      const int b = i / K, k = i - b * K;
      const float r = rows[b * ld + k] / rsum[b];
      rows_out[(size_t)t * B * K + i] = r;
      rows[b * ld + k] = nmask[b] > 0.5f ? r : P.inv_k;
    }
    for (int b = tid; b < B; b += blockDim.x)
      sums_out[(size_t)t * B + b] = rsum[b];
    __syncthreads();

    // ---- 6. per-edge sums, one warp per edge ---------------------------
    for (int e = warp; e < E; e += nwarps) {
      const float* pu = rows + lu[e] * ld;
      const float* pv = rows + lv[e] * ld;
      const bool link = yef[e] > 0.5f;
      float s_pp = 0.f, s_pr = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float pp = pu[k] * pv[k];
        s_pp += pp;
        s_pr += (link ? bet[k] : 1.f - bet[k]) * pp;
      }
      s_pp = warp_sum(s_pp);
      s_pr = warp_sum(s_pr);
      if (lane == 0)
        prsum[e] = s_pr + (link ? eps : P.one_minus_eps) * (1.f - s_pp);
    }
    __syncthreads();

    // ---- 7. gradient fan-in and the theta SGRLD step, one thread per k
    // Labels are exactly 0 or 1, so (1-y)/theta0 and y/theta1 are exactly
    // 0 or 1/theta: one division per edge instead of three.
    const float eps_b = P.eps_theta[t];
    const float wt = wts_in[t];
    const float* bnoise_t = bnoise_in + (size_t)t * K * 2;
    for (int k = tid; k < K; k += blockDim.x) {
      const float t0 = th0[k], t1 = th1[k], bk = bet[k];
      const float inv_ts = 1.f / (t0 + t1);
      const float inv_t0 = 1.f / t0, inv_t1 = 1.f / t1;
      float g0 = 0.f, g1 = 0.f;
      for (int e = 0; e < E; ++e) {
        const bool link = yef[e] > 0.5f;
        const float m = emf[e];
        const float pp = rows[lu[e] * ld + k] * rows[lv[e] * ld + k];
        const float f = ((link ? bk : 1.f - bk) * pp) / prsum[e];
        g0 += (f * ((link ? 0.f : inv_t0) - inv_ts)) * m;
        g1 += (f * ((link ? inv_t1 : 0.f) - inv_ts)) * m;
      }
      float n0 = fabsf(t0 + eps_b / 2.f * (P.eta0 - t0 + wt * g0)
                       + sqrtf(eps_b * t0) * bnoise_t[2 * k]);
      float n1 = fabsf(t1 + eps_b / 2.f * (P.eta1 - t1 + wt * g1)
                       + sqrtf(eps_b * t1) * bnoise_t[2 * k + 1]);
      n0 = fmaxf(n0, 1e-24f);
      n1 = fmaxf(n1, 1e-24f);
      th0[k] = n0;
      th1[k] = n1;
      bet[k] = n1 / (n0 + n1);
    }
    __syncthreads();
  }

  for (int k = tid; k < K; k += blockDim.x) {
    P.theta_out[chain * K * 2 + 2 * k] = th0[k];
    P.theta_out[chain * K * 2 + 2 * k + 1] = th1[k];
    P.beta_out[chain * K + k] = bet[k];
  }
}

}  // namespace

extern "C" size_t window_kernel_smem_bytes(int B, int n, int E, int K) {
  return smem_words(B, n, E, K) * sizeof(float);
}

// Launches C blocks (one per chain) on `stream`; returns
// cudaGetLastError() (0 on success). Every array holds the C chains'
// slices one after another (chain-major); `eps_phi` and `eps_theta` are
// host arrays of T floats, shared by the chains.
extern "C" int window_kernel_launch(
    const float* g, const float* sums, const bool* y, const int* nodes,
    const int* nbrs, const bool* node_mask, const float* noise,
    const float* bnoise, const bool* y_edges, const bool* edge_mask,
    const int* lanes_u, const int* lanes_v, const int* mcode,
    const float* wts, const float* theta_in, const float* beta_in,
    float* rows_out, float* sums_out, float* theta_out, float* beta_out,
    int C, int T, int B, int n, int E, int K, float eps, float one_minus_eps,
    float alpha, float n_nodes, float eta0, float eta1, float inv_k,
    const float* eps_phi, const float* eps_theta, void* stream) {
  if (C < 1 || n > kMaxNeighbors || T > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  Params P{g, sums, y, nodes, nbrs, node_mask, noise, bnoise, y_edges,
           edge_mask, lanes_u, lanes_v, mcode, wts, theta_in, beta_in,
           rows_out, sums_out, theta_out, beta_out, T, B, n, E, K,
           eps, one_minus_eps, alpha, n_nodes, eta0, eta1, inv_k, {}, {}};
  for (int t = 0; t < T; ++t) {
    P.eps_phi[t] = eps_phi[t];
    P.eps_theta[t] = eps_theta[t];
  }
  const size_t smem = window_kernel_smem_bytes(B, n, E, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
