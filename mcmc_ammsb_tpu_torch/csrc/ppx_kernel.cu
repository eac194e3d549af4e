// The held-out perplexity evaluation in one pass over each pair's two pi
// rows: the per-pair likelihood, its fold into the running average and
// the link / non-link sums of the log averages.
//
// Replaces no TPU kernel. The JAX package's evaluation
// (mcmc_ammsb_tpu/ops/perplexity.py, perplexity_step / perplexity_core)
// is plain jnp that XLA fuses into a few loops; eager PyTorch ran it as
// ~15 unfused ops per 256 MB block of gathered rows (a gather of both
// endpoint rows, their upcast to float32, three passes over a
// [rows, K] float32 product) and ~15 more for the fold, at 5-11% of the
// card's HBM rate. This kernel is the measured reason for a hand kernel
// there. Called through mcmc_ammsb_tpu_torch/ops/perplexity.py
// (likelihood_cuda); the plain PyTorch versions beside it are
// edge_likelihood, blocked_likelihood and fold_likelihood.
//
// Per pair p (rows ru = u[p] + c N and rv = v[p] + c N of chain c):
//   pp_k    = pi_ru,k pi_rv,k                    (float32, rounded)
//   s_link  = sum_k pp_k beta_k
//   s_non   = sum_k pp_k (1 - beta_k) + (1 - sum_k pp_k)(1 - eps)
//   lik     = max(y_p ? s_link : s_non, 1e-30)
//   new_p   = (old_p (c - 1) + lik) / c           (c: the call count)
//   lg_p    = log(max(new_p, 1e-30)) on unmasked lanes; masked lanes keep
//             old_p and add nothing
// then link_lik = sum of lg_p over links, non_link_lik over non-links,
// the two counts, and neg_avg_log = -(link_lik + non_link_lik) / count.
//
// What bounds it on an H100: the rows. Each pair reads 2 K stored values
// (float32 or bf16) once and does ~6 K float32 operations, far below the
// card's 67 TFLOP/s per byte, so the least time is the 2 H K values over
// 3.35 TB/s (dblp, H = 10,226, K = 16384 float32: 1.34 GB, 0.40 ms;
// youtube, H = 29,610, bf16: 1.94 GB, 0.58 ms).
//
// What the design does about it:
//   - A group of tpp threads (32-256, a whole number of warps; the
//     wrapper's ppx_plan picks it from K and the element size) takes one
//     pair, so one 256-thread CTA holds 256 / tpp pairs: one pair a CTA
//     at K = 16384, 8 at K = 1024.
//   - Rows stream with 16-byte loads (4 float32 or 8 bf16 a load) where
//     K x element bytes is a multiple of 16 and the bases are aligned,
//     4-byte or 2-byte loads otherwise (ragged K); U loads of each row in
//     flight per thread. The loads are marked streaming (evict first), so
//     the rows pass through L1 without pushing out beta, which is read
//     through the read-only path and stays in L1 (64 KB at K = 16384; the
//     kernel asks for the largest L1 carveout). bf16 is upcast in
//     registers: nothing is written back to memory before the sums.
//   - The three float32 sums of edge_likelihood are kept per thread, then
//     reduced in a fixed order: warp shuffles, then the group's warps in
//     order through shared memory.
//   - The group's first thread applies the formula and the fold and
//     writes the new average; the CTA's link and non-link sums of the log
//     averages (in float64) and its counts go to a partials buffer in the
//     order of its pairs.
//   - A second launch, one CTA per chain, adds the partials in a fixed
//     order and writes the five scalars. No float atomics: the same
//     inputs give the same bits on every launch.
// Division and log are IEEE (no fast math); the fold's products and sums
// are rounded one at a time (__fmul_rn, __fadd_rn), as the plain
// version's separate ops round them.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;       // a CTA of the pair kernel, at most
constexpr int kReduceThreads = 256;    // the partials' CTA

struct Params {
  const void* rows_u;     // the u rows' base ([R, K], float32 or bf16)
  const void* rows_v;     // the v rows' base (pi again on the main path)
  const int* u;           // [H] row ids, or nullptr: pair p reads row p
  const int* v;
  const float* beta;      // [lead, K]
  const bool* y;          // [lead or 1, H]
  const bool* mask;       // [H], or nullptr: every lane counts
  const float* ppx;       // [lead, H], the running averages
  const float* count;     // the call count on the device, or nullptr
  float* ppx_new;         // [lead, H]
  double* part_lik;       // [lead, blocks, 2]: link, non-link
  long long* part_cnt;    // [lead, blocks, 2]
  long long y_stride;     // H, or 0 where one row of labels serves all
  long long lead_rows;    // rows between two chains' blocks of pi (N)
  int H, K, tpp;
  float count_value;      // the call count where count is nullptr
  float one_m_eps;        // 1 - epsilon
};

struct Sums {
  float pp, link, non;
};

__device__ __forceinline__ void add(Sums& s, float x, float y, float b) {
  const float pp = __fmul_rn(x, y);
  s.pp += pp;
  s.link = fmaf(pp, b, s.link);
  s.non = fmaf(pp, 1.f - b, s.non);
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// A row's loads: V the loaded type, W the elements it holds, U the loads
// of each row a thread keeps in flight.
struct F32Vec {
  using V = float4;
  static constexpr int W = 4, U = 4, kElt = 4;
  __device__ static V load(const void* row, int i) {
    return __ldcs(static_cast<const float4*>(row) + i);
  }
  __device__ static void add_to(Sums& s, V x, V y, const float* beta) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(beta));
    add(s, x.x, y.x, b.x);
    add(s, x.y, y.y, b.y);
    add(s, x.z, y.z, b.z);
    add(s, x.w, y.w, b.w);
  }
};

struct Bf16Vec {
  using V = uint4;
  static constexpr int W = 8, U = 4, kElt = 2;
  __device__ static V load(const void* row, int i) {
    return __ldcs(static_cast<const uint4*>(row) + i);
  }
  __device__ static void pair(Sums& s, unsigned x, unsigned y, float b0,
                              float b1) {
    add(s, bf16_lo(x), bf16_lo(y), b0);
    add(s, bf16_hi(x), bf16_hi(y), b1);
  }
  __device__ static void add_to(Sums& s, V x, V y, const float* beta) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(beta));
    const float4 c = __ldg(reinterpret_cast<const float4*>(beta) + 1);
    pair(s, x.x, y.x, b.x, b.y);
    pair(s, x.y, y.y, b.z, b.w);
    pair(s, x.z, y.z, c.x, c.y);
    pair(s, x.w, y.w, c.z, c.w);
  }
};

struct F32Scalar {
  using V = float;
  static constexpr int W = 1, U = 8, kElt = 4;
  __device__ static V load(const void* row, int i) {
    return __ldcs(static_cast<const float*>(row) + i);
  }
  __device__ static void add_to(Sums& s, V x, V y, const float* beta) {
    add(s, x, y, __ldg(beta));
  }
};

struct Bf16Scalar {
  using V = unsigned short;
  static constexpr int W = 1, U = 8, kElt = 2;
  __device__ static V load(const void* row, int i) {
    return __ldcs(static_cast<const unsigned short*>(row) + i);
  }
  __device__ static void add_to(Sums& s, V x, V y, const float* beta) {
    add(s, __uint_as_float(unsigned(x) << 16),
        __uint_as_float(unsigned(y) << 16), __ldg(beta));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Grid (blocks, lead), blockDim.x = groups x tpp threads; group g of CTA
// b takes pair b x groups + g of chain blockIdx.y.
template <class L>
__global__ void __launch_bounds__(kMaxThreads)
    ppx_pairs(const Params P) {
  __shared__ float warp_part[kMaxThreads / 32][3];
  __shared__ double group_lik[kMaxThreads / 32][2];
  __shared__ int group_cnt[kMaxThreads / 32][2];
  const int chain = blockIdx.y;
  const int groups = blockDim.x / P.tpp;
  const int g = threadIdx.x / P.tpp, t = threadIdx.x % P.tpp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * groups + g;
  const int nvec = P.K / L::W;
  Sums s{0.f, 0.f, 0.f};
  if (p < P.H) {
    const long long off = (long long)chain * P.lead_rows;
    const long long ru = (P.u ? P.u[p] : p) + off;
    const long long rv = (P.v ? P.v[p] : p) + off;
    const char* xu =
        static_cast<const char*>(P.rows_u) + ru * P.K * L::kElt;
    const char* xv =
        static_cast<const char*>(P.rows_v) + rv * P.K * L::kElt;
    const float* beta = P.beta + (long long)chain * P.K;
    for (int i0 = t; i0 < nvec; i0 += P.tpp * L::U) {
      typename L::V a[L::U], b[L::U];
#pragma unroll
      for (int j = 0; j < L::U; ++j) {
        const int i = i0 + j * P.tpp;
        if (i < nvec) {
          a[j] = L::load(xu, i);
          b[j] = L::load(xv, i);
        }
      }
#pragma unroll
      for (int j = 0; j < L::U; ++j) {
        const int i = i0 + j * P.tpp;
        if (i < nvec) L::add_to(s, a[j], b[j], beta + (long long)i * L::W);
      }
    }
  }
  s.pp = warp_sum(s.pp);
  s.link = warp_sum(s.link);
  s.non = warp_sum(s.non);
  if (lane == 0) {
    warp_part[warp][0] = s.pp;
    warp_part[warp][1] = s.link;
    warp_part[warp][2] = s.non;
  }
  __syncthreads();
  if (t == 0) {
    double lik_link = 0.0, lik_non = 0.0;
    int n_link = 0, n_non = 0;
    if (p < P.H) {
      const int w0 = g * (P.tpp / 32);
      float pp = 0.f, link = 0.f, non = 0.f;
      for (int w = w0; w < w0 + P.tpp / 32; ++w) {
        pp += warp_part[w][0];
        link += warp_part[w][1];
        non += warp_part[w][2];
      }
      const bool y = P.y[chain * P.y_stride + p];
      const float s_non =
          __fadd_rn(non, __fmul_rn(__fsub_rn(1.f, pp), P.one_m_eps));
      const float lik = fmaxf(y ? link : s_non, 1e-30f);
      const float c = P.count ? *P.count : P.count_value;
      const long long at = (long long)chain * P.H + p;
      const float old = P.ppx[at];
      const bool m = P.mask ? P.mask[p] : true;
      const float fresh =
          __fdiv_rn(__fadd_rn(__fmul_rn(old, __fsub_rn(c, 1.f)), lik), c);
      P.ppx_new[at] = m ? fresh : old;
      if (m) {
        const double lg = logf(fmaxf(fresh, 1e-30f));
        if (y) {
          lik_link = lg;
          n_link = 1;
        } else {
          lik_non = lg;
          n_non = 1;
        }
      }
    }
    group_lik[g][0] = lik_link;
    group_lik[g][1] = lik_non;
    group_cnt[g][0] = n_link;
    group_cnt[g][1] = n_non;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double link = 0.0, non = 0.0;
    long long n_link = 0, n_non = 0;
    for (int i = 0; i < groups; ++i) {
      link += group_lik[i][0];
      non += group_lik[i][1];
      n_link += group_cnt[i][0];
      n_non += group_cnt[i][1];
    }
    const long long at = ((long long)chain * gridDim.x + blockIdx.x) * 2;
    P.part_lik[at] = link;
    P.part_lik[at + 1] = non;
    P.part_cnt[at] = n_link;
    P.part_cnt[at + 1] = n_non;
  }
}

// One CTA per chain: the partials of its `blocks` CTAs in a fixed order.
// out_f [3, lead]: link_lik, non_link_lik, neg_avg_log; out_i [2, lead]:
// link_count, non_link_count.
__global__ void __launch_bounds__(kReduceThreads)
    ppx_reduce(const double* part_lik, const long long* part_cnt, int blocks,
               float* out_f, long long* out_i) {
  __shared__ double lik[kReduceThreads / 32][2];
  __shared__ long long cnt[kReduceThreads / 32][2];
  const int chain = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = (long long)chain * blocks * 2;
  double link = 0.0, non = 0.0;
  long long n_link = 0, n_non = 0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    link += part_lik[base + 2 * b];
    non += part_lik[base + 2 * b + 1];
    n_link += part_cnt[base + 2 * b];
    n_non += part_cnt[base + 2 * b + 1];
  }
  link = warp_sum(link);
  non = warp_sum(non);
  n_link = warp_sum(n_link);
  n_non = warp_sum(n_non);
  if (lane == 0) {
    lik[warp][0] = link;
    lik[warp][1] = non;
    cnt[warp][0] = n_link;
    cnt[warp][1] = n_non;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    link = non = 0.0;
    n_link = n_non = 0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) {
      link += lik[w][0];
      non += lik[w][1];
      n_link += cnt[w][0];
      n_non += cnt[w][1];
    }
    const int lead = gridDim.x;
    out_f[chain] = (float)link;
    out_f[lead + chain] = (float)non;
    out_f[2 * lead + chain] =
        (float)(-(link + non) / (double)(n_link + n_non));
    out_i[chain] = n_link;
    out_i[lead + chain] = n_non;
  }
}

template <class L>
cudaError_t launch_pairs(const Params& P, int threads, int blocks, int lead,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ppx_pairs<L>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return err;
  ppx_pairs<L><<<dim3(blocks, lead), threads, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// One evaluation: the pair kernel, then the partials' reduction, both on
// `stream`. `threads` is the pair kernel's CTA (a multiple of tpp, at
// most 256), `blocks` = ceil(H / (threads / tpp)); `vec` 1 for 16-byte
// loads (K x element bytes a multiple of 16, bases aligned), 0 for one
// element a load; `bf16` 1 for bf16 rows, 0 for float32. part_lik and
// part_cnt hold [lead, blocks, 2]. Returns the first CUDA error (0 on
// success).
extern "C" int ppx_launch(
    const void* rows_u, const void* rows_v, const int* u, const int* v,
    const float* beta, const bool* y, const bool* mask, const float* ppx,
    const float* count, float* ppx_new, double* part_lik,
    long long* part_cnt, float* out_f, long long* out_i, long long y_stride,
    long long lead_rows, int H, int K, int lead, int tpp, int threads,
    int blocks, int vec, int bf16, float count_value, float one_m_eps,
    void* stream) {
  if (tpp < 32 || tpp % 32 != 0 || threads < tpp || threads % tpp != 0 ||
      threads > kMaxThreads || H < 1 || K < 1 || lead < 1 || blocks < 1 ||
      (long long)blocks * (threads / tpp) < H ||
      (vec && K % (bf16 ? 8 : 4) != 0))
    return (int)cudaErrorInvalidValue;
  Params P{rows_u, rows_v, u, v, beta, y, mask, ppx, count, ppx_new,
           part_lik, part_cnt, y_stride, lead_rows, H, K, tpp, count_value,
           one_m_eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = vec ? launch_pairs<Bf16Vec>(P, threads, blocks, lead, s)
              : launch_pairs<Bf16Scalar>(P, threads, blocks, lead, s);
  else
    err = vec ? launch_pairs<F32Vec>(P, threads, blocks, lead, s)
              : launch_pairs<F32Scalar>(P, threads, blocks, lead, s);
  if (err != cudaSuccess) return (int)err;
  ppx_reduce<<<lead, kReduceThreads, 0, s>>>(part_lik, part_cnt, blocks,
                                             out_f, out_i);
  return (int)cudaGetLastError();
}
