// The a-MMSB phi SGRLD step with private neighbor draws: one thread block
// per minibatch node.
//
// Replaces the Pallas TPU kernels of mcmc_ammsb_tpu/ops/phi_pallas.py:
//   * _phi_kernel (reached through phi_update_core_pallas ->
//     pl.pallas_call), which takes pre-gathered rows: the entry
//     phi_kernel_launch;
//   * _phi_gather_kernel (reached through phi_update_rows_pallas_gather
//     -> pl.pallas_call), which fetches the rows from pi by index inside
//     the kernel: the entry phi_gather_launch. On the TPU that variant
//     lost to XLA's gather; here it is the mode the --phi-impl pallas
//     step runs, because it needs no [B, n, K] buffer and no separate
//     gather launch (the reference's own update_phi reads pi from global
//     memory too).
// Called through mcmc_ammsb_tpu_torch/ops/phi_pallas.py
// (phi_update_core_cuda, phi_update_rows_cuda); the plain PyTorch
// versions beside them are phi_update_core_torch and
// phi_update_rows_torch.
//
// Per node b with phi sum phi and neighbors j = 0..n-1, exactly the
// Pallas kernel's math (phi_pallas.py:57-81):
//   f_k    = y_j ? beta_k - eps : eps - beta_k,   e = y_j ? eps : 1 - eps
//   probs  = pi_bk (nbr_jk f_k + e),               acc_k += probs_k / sum_k probs
//   grads  = acc / (pi_b phi) - n / phi
//   phi'   = max(1e-24, |phi_k + eps_t/2 (alpha - phi_k + N/n grads)
//                        + sqrt(eps_t phi_k) xi|),  phi_k = pi_bk phi
// then the row normalization the JAX package does outside its kernel.
//
// What bounds it on an H100: it reads the B (n + 1) rows once from L2 or
// device memory (B=33, n=32, K=256: 1.1 MB per step) and does ~4 B n K
// flops (1.1 M), so it is bound by memory latency and by the n block-wide
// sums per node, not by arithmetic.
//
// What the design does about it, kept simple for a first kernel: a
// block of up to 256 threads owns one node, thread k owns columns
// k, k + 256, ...; pass 1 computes the n per-neighbor sums with one warp
// reduction each and one barrier for all of them, pass 2 re-reads the
// neighbor rows (now in L1/L2) and accumulates probs / sum in the
// neighbor order of the Pallas kernel. Rows are read coalesced, one warp
// per 32 columns. Division and sqrt are IEEE (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  // pre-gathered mode
  const float* pi_n;     // [B, K]
  const float* phis;     // [B]
  const float* pi_nb;    // [B, n, K]
  // by-index mode
  const float* pi;       // [N, K]
  const float* phi_sum;  // [N]
  const int* nodes;      // [B]     (padded lanes: N, clamped to N-1)
  const int* nbrs;       // [B, n]
  // both
  const bool* y;         // [B, n]  neighbor edge labels
  const float* beta;     // [K]
  const float* noise;    // [B, K]
  float* rows_out;       // [B, K]  row-normalized phi'
  float* sums_out;       // [B]     row sums of phi'
  int B, n, K, N;
  float eps, eps_t, alpha, scale_n, n_f;
};

__host__ __device__ inline int block_threads(int K) {
  const int t = (K + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Shared words: the neighbor row offsets [n] (two words each, first so
// they are 8-byte aligned), the node row [K], phi' [K], the per-warp
// partial sums [warps, n], the per-neighbor sums [n] and 32 words for
// the row-sum reduction.
__host__ __device__ inline size_t smem_words(int n, int K) {
  const int warps = block_threads(K) / 32;
  return 2 * (size_t)K + (size_t)warps * n + (size_t)n + 2 * (size_t)n + 32;
}

__device__ __forceinline__ int clamp_id(int id, int N) {
  return id < 0 ? 0 : (id >= N ? N - 1 : id);
}

template <bool kGather>
__global__ void __launch_bounds__(kMaxThreads) phi_kernel(Params P) {
  extern __shared__ long long smem_ll[];
  const int n = P.n, K = P.K, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  long long* nb_off = smem_ll;             // [n] neighbor row offsets
  float* pin = reinterpret_cast<float*>(nb_off + n);  // [K] node pi row
  float* vnew = pin + K;                   // [K] phi'
  float* part = vnew + K;                  // [warps, n]
  float* tot = part + warps * n;           // [n]
  float* red = tot + n;                    // [32]

  const float* node_row;
  float phi;
  if (kGather) {
    const int id = clamp_id(P.nodes[b], P.N);
    node_row = P.pi + (size_t)id * K;
    phi = P.phi_sum[id];
  } else {
    node_row = P.pi_n + (size_t)b * K;
    phi = P.phis[b];
  }
  for (int j = tid; j < n; j += blockDim.x)
    nb_off[j] = kGather ? (long long)clamp_id(P.nbrs[(size_t)b * n + j], P.N) * K
                        : ((long long)b * n + j) * K;
  for (int k = tid; k < K; k += blockDim.x) pin[k] = node_row[k];
  __syncthreads();
  const float* rows = kGather ? P.pi : P.pi_nb;
  const bool* yb = P.y + (size_t)b * n;
  const float eps = P.eps;

  // ---- pass 1: sum_k probs for every neighbor, one warp sum each -------
  for (int j = 0; j < n; ++j) {
    const float* nb = rows + nb_off[j];
    const bool link = yb[j];
    const float e = link ? eps : 1.f - eps;
    float s = 0.f;
    for (int k = tid; k < K; k += blockDim.x) {
      const float bk = P.beta[k];
      const float f = link ? bk - eps : eps - bk;
      s += pin[k] * (nb[k] * f + e);
    }
    s = warp_sum(s);
    if (lane == 0) part[warp * n + j] = s;
  }
  __syncthreads();
  for (int j = tid; j < n; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += part[w * n + j];
    tot[j] = s;
  }
  __syncthreads();

  // ---- pass 2: acc_k = sum_j probs_jk / sum_j, the SGRLD step ------------
  float rs = 0.f;
  for (int k = tid; k < K; k += blockDim.x) {
    const float pk = pin[k], bk = P.beta[k];
    float acc = 0.f;
    for (int j = 0; j < n; ++j) {
      const bool link = yb[j];
      const float f = link ? bk - eps : eps - bk;
      const float e = link ? eps : 1.f - eps;
      acc += pk * (rows[nb_off[j] + k] * f + e) / tot[j];
    }
    const float grads = acc / (pk * phi) - P.n_f / phi;
    const float phi_k = pk * phi;
    const float v = fabsf(phi_k
                          + P.eps_t * 0.5f * (P.alpha - phi_k + P.scale_n * grads)
                          + sqrtf(P.eps_t * phi_k) * P.noise[(size_t)b * K + k]);
    vnew[k] = fmaxf(v, 1e-24f);
    rs += vnew[k];
  }

  // ---- row sum and normalization ----------------------------------------
  rs = warp_sum(rs);
  if (lane == 0) red[warp] = rs;
  __syncthreads();
  if (warp == 0) {
    float s = lane < warps ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) red[0] = s;
  }
  __syncthreads();
  const float sum = red[0];
  for (int k = tid; k < K; k += blockDim.x)
    P.rows_out[(size_t)b * K + k] = vnew[k] / sum;
  if (tid == 0) P.sums_out[b] = sum;
}

template <bool kGather>
int launch(const Params& P, void* stream) {
  const size_t smem = smem_words(P.n, P.K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phi_kernel<kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  phi_kernel<kGather><<<P.B, block_threads(P.K), smem,
                        static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t phi_kernel_smem_bytes(int n, int K) {
  return smem_words(n, K) * sizeof(float);
}

// Pre-gathered rows (the counterpart of phi_update_core_pallas). Launches
// on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int phi_kernel_launch(
    const float* pi_n, const float* phis, const float* pi_nb, const bool* y,
    const float* beta, const float* noise, float* rows_out, float* sums_out,
    int B, int n, int K, float eps, float eps_t, float alpha, float scale_n,
    float n_f, void* stream) {
  Params P{pi_n, phis, pi_nb, nullptr, nullptr, nullptr, nullptr, y, beta,
           noise, rows_out, sums_out, B, n, K, 0, eps, eps_t, alpha,
           scale_n, n_f};
  return launch<false>(P, stream);
}

// Rows read from pi [N, K] by index (the counterpart of
// phi_update_rows_pallas_gather).
extern "C" int phi_gather_launch(
    const float* pi, const float* phi_sum, const int* nodes, const int* nbrs,
    const bool* y, const float* beta, const float* noise, float* rows_out,
    float* sums_out, int B, int n, int K, int N, float eps, float eps_t,
    float alpha, float scale_n, float n_f, void* stream) {
  Params P{nullptr, nullptr, nullptr, pi, phi_sum, nodes, nbrs, y, beta,
           noise, rows_out, sums_out, B, n, K, N, eps, eps_t, alpha,
           scale_n, n_f};
  return launch<true>(P, stream);
}
