// T sequential full-MMSB SGRLD steps of one window, in one thread block.
//
// Replaces the Pallas TPU kernel mcmc_ammsb_tpu/ops/window_mmsb.py::
// _mmsb_window_kernel (reached through mmsb_window_kernel_call ->
// pl.pallas_call). Called through mcmc_ammsb_tpu_torch/ops/
// window_mmsb.py::mmsb_window_core_cuda; the plain PyTorch version beside
// it is mmsb_window_core_torch.
//
// Per step t, the JAX kernel's math (window_mmsb.py:131-235):
//   1. read rows: lane r reads staged row mcode-1 when mcode > 0 (a row an
//      earlier step of the window wrote), else the gathered g[t, r]; the
//      TPU's one-hot matrix products become indexed loads (same bits);
//   2. B = theta1 / (theta0 + theta1) of the carried theta;
//   3. phi, the factorized shared-draw contraction: g_link = pi_nb B^T,
//      g_non = rowsum(pi_nb) - g_link, p = y ? pi_n . g_link : pi_n . g_non
//      (1 on masked pairs), the weights w_link / w_non, sc = w_link g_link
//      + w_non g_non, the SGRLD step with noise, the 1e-24 floor, the row
//      normalization; rows and sums are staged in the output buffers;
//   4. theta, on the staged rows with masked node lanes set to 1/K:
//      p_e = sum_kl pi_u[e,k] pi_v[e,l] F_e[k,l] (F = y ? B : 1 - B), and
//      the gradient 0.5 sum_e (pi_u[e,k] pi_v[e,l] + pi_v[e,k] pi_u[e,l])
//      F_e[k,l] c_e[k,l] / p_e (the JAX kernel's swapped-endpoint pass),
//      then the SGRLD step per (k, l) cell with abs and the floor.
//
// The [E*K, K] responsibility tensors of the TPU kernel are never formed.
// c_e depends on the edge only through its label, so a thread that owns
// the (k, l) cells of a row k accumulates two sums over the edges,
//   S_link[k,l] = sum_{e linked}   (pi_u[e,k] pi_v[e,l] + pi_v[e,k] pi_u[e,l]) / p_e
//   S_non[k,l]  = sum_{e unlinked} (the same),
// and the gradient is 0.5 (B S_link c_link + (1 - B) S_non c_non). Both
// products of the pair sum are exact in double, so S, and with the
// symmetrized noise the whole of theta, stay exactly symmetric.
//
// Precision: the full MMSB's trajectories are ill-conditioned (1/theta and
// the SGRLD steps' abs() of near-cancellations amplify rounding; docs/
// design.md "Windowed MMSB tolerances"), so the kernel keeps every float32
// operand and result but accumulates every sum in double (the g_link and
// p_e products are rounded to float once before they are added) and takes
// the phi and theta steps in double. Each step rounds where it stores a
// row, a sum or a theta cell, and a window lands closer to a float64
// evaluation than the float32 plain version (PERF.md). Hopper's FP64 rate
// is half its FP32 rate, and neither binds this kernel.
//
// What bounds it on an H100: ~0.8 M multiply-adds per step at K=64 (the
// [n,K]x[K,K] g_link product, the two [B,n] dot products per pair, sc, the
// p_e contractions and the theta fan-in), each fed by shared-memory loads,
// all on ONE SM, with one block's 16 warps to hide the latency of their
// dependent chains: ~99k cycles per step at K=64, a third of it the theta
// fan-in and step (PERF.md). So the fan-in shares each column's loads
// between two rows of theta, the theta step takes one division per cell,
// and products are converted to double once. Theta (2 K^2 floats) lives
// in the global output buffer, which L2 holds; B, the step's rows and the
// phi-stage products live in shared memory with an odd row stride, so
// column walks are free of bank conflicts: at B=33, n=32, E=32, K=64 takes
// 94 KB, K=128 192 KB of the 232 KB a block may use.
//
// Division and sqrt are IEEE (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// Longest window: the step sizes travel in the kernel's parameters.
constexpr int kMaxWindow = 64;
// l columns a lane accumulates per pass of the theta fan-in.
constexpr int kLPerLane = 2;
// rows k of theta a warp accumulates per pass, sharing the l-column loads.
constexpr int kRowsPerPass = 2;

__host__ __device__ inline int odd_stride(int K) { return K | 1; }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  // inputs, T = window steps, R = B + n; bool arrays are one byte each
  const float* g;          // [T, R, K] gathered rows (nodes, then nbrs)
  const float* sums;       // [T, B]    gathered phi sums
  const bool* y;           // [T, B, n] neighbor edge labels
  const int* nodes;        // [T, B]    node ids (padded lanes: N)
  const int* nbrs;         // [T, n]    the step's shared neighbor ids
  const bool* node_mask;   // [T, B]
  const float* noise;      // [T, B, K] phi noise
  const float* tnoise;     // [T, K, K, 2] symmetrized theta noise
  const bool* y_edges;     // [T, E]
  const bool* edge_mask;   // [T, E]
  const int* lanes_u;      // [T, E]    endpoint node lanes
  const int* lanes_v;      // [T, E]
  const int* mcode;        // [T, R]    1 + staged slot, or 0
  const float* wts;        // [T]       minibatch weight
  const float* theta_in;   // [K, K, 2]
  // outputs
  float* rows_out;         // [T*B, K] staged rows (read back in-window)
  float* sums_out;         // [T*B]
  float* theta_out;        // [K, K, 2], also theta's working copy
  int T, B, n, E, K;
  float alpha, n_nodes, inv_k, eta0, eta1, eta_diag0, eta_diag1;
  float eps_phi[kMaxWindow];    // phi step sizes of the T steps
  float eps_theta[kMaxWindow];  // theta step sizes
};

// Shared memory, in 4-byte words. First the double-precision arrays (so
// they are 8-byte aligned): the phi stage's g_link, g_non [n, ld] and
// w_link, w_non [B, n], the row sums of phi' [B] and of the neighbor
// rows [n], the edge weights mask / p_e [E]; then B [K, ld] and the
// step's rows [R, ld]; the phis, node mask
// and valid-neighbor count [B] each; the pair labels and pair mask
// [B, n] each; the edge labels and mask [E] each; both lane maps [E]
// (int).
__host__ __device__ inline size_t smem_words(int B, int n, int E, int K) {
  const size_t ld = odd_stride(K);
  return 2 * (2 * (size_t)n * ld + 2 * (size_t)B * n + (size_t)B
              + (size_t)n + (size_t)E)
         + (size_t)K * ld + (size_t)(B + n) * ld + 3 * (size_t)B
         + 2 * (size_t)B * n + 4 * (size_t)E;
}

__global__ void __launch_bounds__(kThreads, 1) mmsb_window_kernel(Params P) {
  extern __shared__ double smem_d[];
  const int B = P.B, n = P.n, E = P.E, K = P.K, R = P.B + P.n;
  const int ld = odd_stride(K);
  double* glink = smem_d;                    // [n, ld]
  double* gnon = glink + (size_t)n * ld;     // [n, ld]
  double* wl = gnon + (size_t)n * ld;        // [B, n]
  double* wn = wl + B * n;                   // [B, n]
  double* rsum = wn + B * n;                 // [B] row sums of phi'
  double* rsnb = rsum + B;                   // [n] neighbor row sums
  double* we = rsnb + n;                     // [E] edge mask / p_e
  float* bm = reinterpret_cast<float*>(we + E);  // [K, ld]  B
  float* rows = bm + (size_t)K * ld;         // [R, ld]  the step's rows
  float* phis = rows + (size_t)R * ld;       // [B]
  float* nmask = phis + B;                   // [B]
  float* nval = nmask + B;                   // [B]
  float* yf = nval + B;                      // [B, n]
  float* mf = yf + B * n;                    // [B, n]
  float* yef = mf + B * n;                   // [E]
  float* emf = yef + E;                      // [E]
  int* lu = reinterpret_cast<int*>(emf + E);  // [E]
  int* lv = lu + E;                          // [E]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int KK = K * K;

  // theta's working copy, and B of the first step
  for (int i = tid; i < KK; i += blockDim.x) {
    const float t0 = P.theta_in[2 * i], t1 = P.theta_in[2 * i + 1];
    P.theta_out[2 * i] = t0;
    P.theta_out[2 * i + 1] = t1;
    bm[(i / K) * ld + i % K] = t1 / (t0 + t1);
  }

  for (int t = 0; t < P.T; ++t) {
    // ---- 0. the step's small operands, staged once -------------------
    for (int b = tid; b < B; b += blockDim.x) {
      const int c = P.mcode[(size_t)t * R + b];
      phis[b] = c > 0 ? P.sums_out[c - 1] : P.sums[(size_t)t * B + b];
      nmask[b] = P.node_mask[(size_t)t * B + b] ? 1.f : 0.f;
      const int node = P.nodes[(size_t)t * B + b];
      float cnt = 0.f;
      for (int j = 0; j < n; ++j) cnt += P.nbrs[(size_t)t * n + j] != node ? 1.f : 0.f;
      nval[b] = cnt;
    }
    for (int i = tid; i < B * n; i += blockDim.x) {
      const int b = i / n, j = i - b * n;
      yf[i] = P.y[(size_t)t * B * n + i] ? 1.f : 0.f;
      // a shared neighbor that is the node itself is excluded
      mf[i] = P.nbrs[(size_t)t * n + j] != P.nodes[(size_t)t * B + b] ? 1.f : 0.f;
    }
    for (int e = tid; e < E; e += blockDim.x) {
      yef[e] = P.y_edges[(size_t)t * E + e] ? 1.f : 0.f;
      emf[e] = P.edge_mask[(size_t)t * E + e] ? 1.f : 0.f;
      lu[e] = P.lanes_u[(size_t)t * E + e];
      lv[e] = P.lanes_v[(size_t)t * E + e];
    }
    // ---- 1. corrected reads, one warp per row; the neighbor rows' sums
    const float* gt = P.g + (size_t)t * R * K;
    for (int r = warp; r < R; r += nwarps) {
      const int c = P.mcode[(size_t)t * R + r];
      const float* src = c > 0 ? P.rows_out + (size_t)(c - 1) * K
                               : gt + (size_t)r * K;
      double acc = 0.0;
      for (int k = lane; k < K; k += 32) {
        const float v = src[k];
        rows[r * ld + k] = v;
        acc += v;
      }
      if (r >= B) {
        acc = warp_sum(acc);
        if (lane == 0) rsnb[r - B] = acc;
      }
    }
    __syncthreads();

    // ---- 2. g_link[j,k] = sum_l pi_nb[j,l] B[k,l], g_non = rowsum - g_link
    for (int item = tid; item < n * K; item += blockDim.x) {
      const int j = item / K, k = item - j * K;
      const float* pb = rows + (B + j) * ld;
      const float* brow = bm + k * ld;
      double gsum = 0.0;
      for (int l = 0; l < K; ++l) gsum += (double)(pb[l] * brow[l]);
      glink[j * ld + k] = gsum;
      gnon[j * ld + k] = rsnb[j] - gsum;
    }
    __syncthreads();

    // ---- 3. p per (node, neighbor) pair and the weights ---------------
    for (int i = tid; i < B * n; i += blockDim.x) {
      const int b = i / n, j = i - b * n;
      const float* pn = rows + b * ld;
      const double* gl = glink + j * ld;
      const double* gn = gnon + j * ld;
      double pl = 0.0, pnl = 0.0;
      for (int k = 0; k < K; ++k) {
        pl += pn[k] * gl[k];
        pnl += pn[k] * gn[k];
      }
      const bool link = yf[i] > 0.5f, valid = mf[i] > 0.5f;
      double p = link ? pl : pnl;
      if (!valid) p = 1.0;   // masked pairs must not turn into NaN
      const double inv_p = 1.0 / p;
      wl[i] = link && valid ? inv_p : 0.0;
      wn[i] = !link && valid ? inv_p : 0.0;
    }
    __syncthreads();

    // ---- 4. sc and the phi SGRLD step; phi' overwrites the node row ---
    const double eps_t = P.eps_phi[t];
    const float* noise_t = P.noise + (size_t)t * B * K;
    for (int i = tid; i < B * K; i += blockDim.x) {
      const int b = i / K, k = i - b * K;
      double s1 = 0.0, s2 = 0.0;
      for (int j = 0; j < n; ++j) {
        s1 += wl[b * n + j] * glink[j * ld + k];
        s2 += wn[b * n + j] * gnon[j * ld + k];
      }
      const double phis_b = phis[b];
      const double grads = (s1 + s2 - nval[b]) * (1.0 / phis_b);
      const double phi_k = rows[b * ld + k] * phis_b;
      const double v = fabs(phi_k
                            + eps_t / 2.0 * (P.alpha - phi_k + ((double)P.n_nodes / nval[b]) * grads)
                            + sqrt(eps_t * phi_k) * noise_t[i]);
      rows[b * ld + k] = (float)fmax(v, 1e-24);
    }
    __syncthreads();

    // ---- 5. row sums of phi', one warp per row -------------------------
    for (int b = warp; b < B; b += nwarps) {
      double acc = 0.0;
      for (int k = lane; k < K; k += 32) acc += rows[b * ld + k];
      acc = warp_sum(acc);
      if (lane == 0) rsum[b] = acc;
    }
    __syncthreads();

    // ---- 6. normalize, stage, sanitize masked lanes for the theta stage
    for (int i = tid; i < B * K; i += blockDim.x) {
      const int b = i / K, k = i - b * K;
      const float r = (float)(rows[b * ld + k] / rsum[b]);
      P.rows_out[(size_t)t * B * K + i] = r;
      rows[b * ld + k] = nmask[b] > 0.5f ? r : P.inv_k;
    }
    for (int b = tid; b < B; b += blockDim.x)
      P.sums_out[(size_t)t * B + b] = (float)rsum[b];
    __syncthreads();

    // ---- 7. p_e = sum_k pi_u[e,k] sum_l F[k,l] pi_v[e,l], one warp per
    //         edge; the edge's weight is mask / p_e -----------------------
    for (int e = warp; e < E; e += nwarps) {
      const float* pu = rows + lu[e] * ld;
      const float* pv = rows + lv[e] * ld;
      const bool link = yef[e] > 0.5f;
      double acc = 0.0;
      for (int k = lane; k < K; k += 32) {
        const float* brow = bm + k * ld;
        double h = 0.0;
        for (int l = 0; l < K; ++l) {
          const float f = link ? brow[l] : 1.f - brow[l];
          h += (double)(f * pv[l]);
        }
        acc += pu[k] * h;
      }
      acc = warp_sum(acc);
      if (lane == 0) we[e] = emf[e] > 0.5f ? 1.0 / acc : 0.0;
    }
    __syncthreads();

    // ---- 8. the symmetrized gradient fan-in and the theta SGRLD step: a
    //         warp owns kRowsPerPass rows k of theta at a time, a lane the
    //         columns l = l0 + lane + 32 q, so each column load serves
    //         both rows
    const double eps_b = P.eps_theta[t];
    const double wt = P.wts[t];
    const float* tn = P.tnoise + (size_t)t * KK * 2;
    for (int k0 = warp * kRowsPerPass; k0 < K; k0 += nwarps * kRowsPerPass) {
      for (int l0 = 0; l0 < K; l0 += 32 * kLPerLane) {
        double sl[kRowsPerPass][kLPerLane] = {}, sn[kRowsPerPass][kLPerLane] = {};
        for (int e = 0; e < E; ++e) {
          const double w = we[e];
          if (w == 0.0) continue;   // masked edge: contributes nothing
          const float* pu = rows + lu[e] * ld;
          const float* pv = rows + lv[e] * ld;
          double uk[kRowsPerPass], vk[kRowsPerPass];
#pragma unroll
          for (int r = 0; r < kRowsPerPass; ++r) {
            const int k = k0 + r < K ? k0 + r : K - 1;
            uk[r] = pu[k];
            vk[r] = pv[k];
          }
          const bool link = yef[e] > 0.5f;
#pragma unroll
          for (int q = 0; q < kLPerLane; ++q) {
            const int l = l0 + lane + 32 * q;
            if (l < K) {
              const double pvl = pv[l], pul = pu[l];
#pragma unroll
              for (int r = 0; r < kRowsPerPass; ++r) {
                // both products are exact in double: the pair sum is
                // the same for (k, l) and (l, k)
                const double pair = uk[r] * pvl + vk[r] * pul;
                if (link) sl[r][q] += w * pair;
                else sn[r][q] += w * pair;
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r) {
          const int k = k0 + r;
#pragma unroll
          for (int q = 0; q < kLPerLane; ++q) {
            const int l = l0 + lane + 32 * q;
            if (k >= K || l >= K) continue;
            const size_t c = (size_t)k * K + l;
            const double t0 = P.theta_out[2 * c], t1 = P.theta_out[2 * c + 1];
            const double bkl = bm[k * ld + l];
            // one division: d = 1 / (t0 t1 (t0 + t1)) gives 1/(t0 + t1)
            // and, without their cancellation, 1/t0 - 1/(t0 + t1) =
            // t1^2 d and 1/t1 - 1/(t0 + t1) = t0^2 d (labels are exactly
            // 0 or 1, so (1-y)/t0 and y/t1 are 0 or 1/t)
            const double d = 1.0 / (t0 * t1 * (t0 + t1));
            const double inv_ts = t0 * t1 * d;
            const double g0 = 0.5 * (bkl * sl[r][q] * -inv_ts
                                     + (1.0 - bkl) * sn[r][q] * (t1 * t1 * d));
            const double g1 = 0.5 * (bkl * sl[r][q] * (t0 * t0 * d)
                                     + (1.0 - bkl) * sn[r][q] * -inv_ts);
            const double e0 = k == l ? P.eta_diag0 : P.eta0;
            const double e1 = k == l ? P.eta_diag1 : P.eta1;
            const float n0 = (float)fmax(
                fabs(t0 + eps_b / 2.0 * (e0 - t0 + wt * g0)
                     + sqrt(eps_b * t0) * tn[2 * c]), 1e-24);
            const float n1 = (float)fmax(
                fabs(t1 + eps_b / 2.0 * (e1 - t1 + wt * g1)
                     + sqrt(eps_b * t1) * tn[2 * c + 1]), 1e-24);
            P.theta_out[2 * c] = n0;
            P.theta_out[2 * c + 1] = n1;
            bm[k * ld + l] = n1 / (n0 + n1);   // the next step's B
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t mmsb_window_smem_bytes(int B, int n, int E, int K) {
  return smem_words(B, n, E, K) * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `eps_phi` and `eps_theta` are host arrays of T floats.
extern "C" int mmsb_window_launch(
    const float* g, const float* sums, const bool* y, const int* nodes,
    const int* nbrs, const bool* node_mask, const float* noise,
    const float* tnoise, const bool* y_edges, const bool* edge_mask,
    const int* lanes_u, const int* lanes_v, const int* mcode,
    const float* wts, const float* theta_in, float* rows_out,
    float* sums_out, float* theta_out, int T, int B, int n, int E, int K,
    float alpha, float n_nodes, float inv_k, float eta0, float eta1,
    float eta_diag0, float eta_diag1, const float* eps_phi,
    const float* eps_theta, void* stream) {
  if (T > kMaxWindow) return (int)cudaErrorInvalidValue;
  Params P{g, sums, y, nodes, nbrs, node_mask, noise, tnoise, y_edges,
           edge_mask, lanes_u, lanes_v, mcode, wts, theta_in, rows_out,
           sums_out, theta_out, T, B, n, E, K, alpha, n_nodes, inv_k,
           eta0, eta1, eta_diag0, eta_diag1, {}, {}};
  for (int t = 0; t < T; ++t) {
    P.eps_phi[t] = eps_phi[t];
    P.eps_theta[t] = eps_theta[t];
  }
  const size_t smem = mmsb_window_smem_bytes(B, n, E, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mmsb_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mmsb_window_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
