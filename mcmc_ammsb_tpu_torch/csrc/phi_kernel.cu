// The a-MMSB phi SGRLD step with private neighbor draws: one thread block
// (or a cluster of G blocks) per minibatch node, all of its rows in
// flight at once.
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
// device memory (B=33, n=32, K=256: 1.1 MB per step, ~0.3 us at 3.35
// TB/s) and does ~4 B n K flops (1.1 M), so the bytes bound it; a node's
// work is a chain of dependent memory round trips and block-wide sums,
// so latency sets its time.
//
// What the design does about it:
//   - The node row and the node's neighbor rows are copied into shared
//     memory with cp.async, all issued together (16-byte chunks when K is
//     a multiple of 4): one memory latency for all of them. The labels,
//     beta - eps and the row offsets are read once.
//   - Pass 1 takes the n per-neighbor sums one warp per neighbor (warp
//     shuffles, no barrier between neighbors), one block barrier for all.
//     Pass 2 reads the rows from shared memory and accumulates probs /
//     sum in the Pallas kernel's neighbor order.
//   - Where the rows do not fit a block's shared memory (n K large), the
//     neighbors are taken in chunks of nc, each chunk's rows in flight at
//     once (ops/phi_pallas.py::phi_neighbor_chunk, the same rule).
//   - G > 1 runs a cluster of G blocks per node, block g taking neighbors
//     [g ceil(n/G), (g+1) ceil(n/G)); the partial acc rows go to block 0
//     by remote stores into distributed shared memory and are summed in
//     rank order, so more SMs work on a node and each block's chain of
//     pass-2 divisions is G times shorter. ops/phi_pallas.py::
//     phi_cluster_size takes the largest G whose B*G blocks fit the SMs:
//     G = 4 at B = 33 (PERF.md has the sweep).
// Division and sqrt are IEEE (no fast math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 8;

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
  int B, n, K, N, nc, G;
  float eps, eps_t, alpha, scale_n, n_f;
};

__host__ __device__ inline int block_threads(int K) {
  const int t = (K + 31) / 32 * 32;
  return t < 64 ? 64 : (t < kMaxThreads ? t : kMaxThreads);
}

// Row stride of the staged rows: K rounded up to 4 (16-byte copies).
__host__ __device__ inline int row_words(int K) { return (K + 3) / 4 * 4; }

// Shared words: the staged rows of a chunk [nc, ldr] first (16-byte
// aligned), the node row, beta - eps and acc [ldr] each, with G > 1 the
// cluster's partial acc rows [G, ldr]; then the row offsets of the
// block's neighbors [ceil(n/G)] (two words each), their labels and sums,
// and 32 words for the row-sum reduction.
__host__ __device__ inline size_t smem_words(int n, int K, int nc, int G) {
  const size_t ldr = row_words(K), ng = (n + G - 1) / G;
  return (size_t)nc * ldr + 3 * ldr + (G > 1 ? (size_t)G * ldr : 0)
         + 4 * ng + 32;
}

__device__ __forceinline__ int clamp_id(int id, int N) {
  return id < 0 ? 0 : (id >= N ? N - 1 : id);
}

template <bool kGather>
__global__ void __launch_bounds__(kMaxThreads) phi_kernel(Params P) {
  extern __shared__ __align__(16) float smem[];
  const int n = P.n, K = P.K, G = P.G, nc = P.nc;
  const int b = blockIdx.x / G, g = blockIdx.x - b * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  const int ldr = row_words(K);
  const int ng = (n + G - 1) / G;
  const int j_begin = min(n, g * ng), j_end = min(n, j_begin + ng);
  float* rows = smem;                       // [nc, ldr]
  float* pin = rows + (size_t)nc * ldr;     // [ldr] node row
  float* bme = pin + ldr;                   // [ldr] beta - eps
  float* acc = bme + ldr;                   // [ldr] sum_j probs / sum
  float* part = acc + ldr;                  // [G, ldr] with G > 1
  long long* off = reinterpret_cast<long long*>(part + (G > 1 ? G * ldr : 0));
  float* yb = reinterpret_cast<float*>(off + ng);   // [ng] labels
  float* tot = yb + ng;                     // [ng] per-neighbor sums
  float* red = tot + ng;                    // [32]

  const bool vec = K % 4 == 0;
  const int width = vec ? 4 : 1;
  const int nchunk = (K + width - 1) / width;
  auto copy_row = [&](float* dst, const float* src, int i) {
    if (vec)
      cp_async16(dst + 4 * i, src + 4 * i);
    else
      cp_async4(dst + i, src + i);
  };

  // ---- the node row, the labels, beta - eps and the row offsets, once --
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
  for (int i = tid; i < nchunk; i += nthreads) copy_row(pin, node_row, i);
  for (int jj = tid; jj < j_end - j_begin; jj += nthreads) {
    const int j = j_begin + jj;
    off[jj] = kGather ? (long long)clamp_id(P.nbrs[(size_t)b * n + j], P.N) * K
                      : ((long long)b * n + j) * K;
    yb[jj] = P.y[(size_t)b * n + j] ? 1.f : 0.f;
  }
  for (int k = tid; k < K; k += nthreads) {
    bme[k] = P.beta[k] - P.eps;
    acc[k] = 0.f;
  }
  __syncthreads();
  const float* src_rows = kGather ? P.pi : P.pi_nb;
  const float eps = P.eps;

  // ---- the block's neighbors in chunks of nc, each chunk's rows in
  //      flight at once -----------------------------------------------------
  for (int c0 = j_begin; c0 < j_end; c0 += nc) {
    const int cn = min(nc, j_end - c0);
    const int base = c0 - j_begin;
    for (int i = tid; i < cn * nchunk; i += nthreads) {
      const int jj = i / nchunk;
      copy_row(rows + (size_t)jj * ldr, src_rows + off[base + jj], i - jj * nchunk);
    }
    cp_async_wait_all();
    __syncthreads();

    // pass 1: sum_k probs of each neighbor, one warp per neighbor
    for (int jj = warp; jj < cn; jj += warps) {
      const float* nb = rows + (size_t)jj * ldr;
      const bool link = yb[base + jj] > 0.5f;
      const float e = link ? eps : 1.f - eps;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float f = link ? bme[k] : -bme[k];
        s += pin[k] * (nb[k] * f + e);
      }
      s = warp_sum(s);
      if (lane == 0) tot[base + jj] = s;
    }
    __syncthreads();

    // pass 2: acc_k += probs_jk / sum_j, in neighbor order
    for (int k = tid; k < K; k += nthreads) {
      const float pk = pin[k], bk = bme[k];
      float a = acc[k];
      for (int jj = 0; jj < cn; ++jj) {
        const bool link = yb[base + jj] > 0.5f;
        const float f = link ? bk : -bk;
        const float e = link ? eps : 1.f - eps;
        a += pk * (rows[(size_t)jj * ldr + k] * f + e) / tot[base + jj];
      }
      acc[k] = a;
    }
    __syncthreads();   // the next chunk overwrites the rows
  }

  // ---- a cluster: block g's partial row to block 0, summed in rank order
  if (G > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cp_async_wait_all();   // a block with no neighbors still has its node row in flight
    float* dst = cluster.map_shared_rank(part, 0) + (size_t)g * ldr;
    for (int k = tid; k < K; k += nthreads) dst[k] = acc[k];
    cluster.sync();
    if (g != 0) return;   // no peer touches this block's memory after it
    for (int k = tid; k < K; k += nthreads) {
      float a = 0.f;
      for (int r = 0; r < G; ++r) a += part[(size_t)r * ldr + k];
      acc[k] = a;
    }
    __syncthreads();
  }

  // ---- the SGRLD step, the row sum and the normalization ----------------
  float rs = 0.f;
  for (int k = tid; k < K; k += nthreads) {
    const float pk = pin[k];
    const float grads = acc[k] / (pk * phi) - P.n_f / phi;
    const float phi_k = pk * phi;
    const float v = fabsf(phi_k
                          + P.eps_t * 0.5f * (P.alpha - phi_k + P.scale_n * grads)
                          + sqrtf(P.eps_t * phi_k) * P.noise[(size_t)b * K + k]);
    acc[k] = fmaxf(v, 1e-24f);
    rs += acc[k];
  }
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
  for (int k = tid; k < K; k += nthreads)
    P.rows_out[(size_t)b * K + k] = acc[k] / sum;
  if (tid == 0) P.sums_out[b] = sum;
}

template <bool kGather>
int launch(const Params& P, void* stream) {
  if (P.G < 1 || P.G > kMaxCluster || P.nc < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_words(P.n, P.K, P.nc, P.G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      phi_kernel<kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.B * P.G);
  cfg.blockDim = dim3(block_threads(P.K));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, phi_kernel<kGather>, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory per block with chunks of nc neighbors and G
// blocks per node.
extern "C" size_t phi_kernel_smem_bytes(int n, int K, int nc, int G) {
  return smem_words(n, K, nc, G) * sizeof(float);
}

// Pre-gathered rows (the counterpart of phi_update_core_pallas). Launches
// on `stream`; returns the launch's CUDA error (0 on success).
extern "C" int phi_kernel_launch(
    const float* pi_n, const float* phis, const float* pi_nb, const bool* y,
    const float* beta, const float* noise, float* rows_out, float* sums_out,
    int B, int n, int K, int nc, int G, float eps, float eps_t, float alpha,
    float scale_n, float n_f, void* stream) {
  Params P{pi_n, phis, pi_nb, nullptr, nullptr, nullptr, nullptr, y, beta,
           noise, rows_out, sums_out, B, n, K, 0, nc, G, eps, eps_t, alpha,
           scale_n, n_f};
  return launch<false>(P, stream);
}

// Rows read from pi [N, K] by index (the counterpart of
// phi_update_rows_pallas_gather).
extern "C" int phi_gather_launch(
    const float* pi, const float* phi_sum, const int* nodes, const int* nbrs,
    const bool* y, const float* beta, const float* noise, float* rows_out,
    float* sums_out, int B, int n, int K, int N, int nc, int G, float eps,
    float eps_t, float alpha, float scale_n, float n_f, void* stream) {
  Params P{nullptr, nullptr, nullptr, pi, phi_sum, nodes, nbrs, y, beta,
           noise, rows_out, sums_out, B, n, K, N, nc, G, eps, eps_t, alpha,
           scale_n, n_f};
  return launch<true>(P, stream);
}
