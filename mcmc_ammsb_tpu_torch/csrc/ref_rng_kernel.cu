// The bit-exact reference RNG on the card: one thread owns one
// xorshift128+ stream and runs the reference's sequential algorithm on it,
// as the original GPU code does (phi.cc:114-121 for the K noise draws of a
// node lane, sample.cc:13-78 for the neighbor sampler).
//
// Replaces the TPU block decoder mcmc_ammsb_tpu/rng/refblock.py (no
// pl.pallas_call there: XLA ops): randn_block (:144), whose pointer-
// doubling decode of a block of raw words stands in for the per-draw
// rejection loops a TPU cannot run per lane, and sample_neighbors_block
// (:291); plus the reference init's Gamma draws (rand_gamma through
// mcmc_ammsb_tpu/learner.py:_init_gamma_reference). The contract is the
// decoder's: the same bits as the faithful per-lane loops of
// rng/reference.py, whose torch copy (mcmc_ammsb_tpu_torch/rng/
// reference.py) is the plain version that the wrapper
// (mcmc_ammsb_tpu_torch/rng/refblock.py) takes on the CPU.
//
// Three entries, each over a [S, L] lane mask so one launch draws a whole
// chunk's S steps for a stream family; a masked-off lane consumes nothing
// and writes zeros (the sentinel N for neighbors):
//   randn_lanes     out [S, L, k]   k sequential N(0,1) per drawing lane
//   neighbors_lanes out [S, L, num] num distinct ids != node, slot order
//   gamma_lanes     out [S, L]      one Gamma(a, b) per drawing lane
//
// Seeds: [L, 4] int64, the words (x_hi, x_lo, y_hi, y_lo) of the
// reference's ulong2, advanced in place.
//
// Bits: every float operation is one IEEE operation with round to nearest
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract a
// product and a sum into an FMA: the plain version runs them as separate
// torch operations. The u32 -> f32 conversions are __uint2float_rn. logf
// and expf are CUDA's full-precision functions, which torch's log and exp
// call on the card. The ziggurat tables come from the plain version's
// float64 construction, passed in, never recomputed here.
//
// What bounds it on an H100: the outputs' bytes (randn at S=200, L=64,
// K=256: 13.1 MB, 3.9 us at 3.35 TB/s) against a chain of ~20 dependent
// instructions per draw in each thread; with one thread per stream and 64
// or 256 streams per chunk, a few warps run and the chain's latency sets
// the time. The design does not split a stream (its words are strictly
// sequential); it draws a chunk in one launch instead of one call per
// step, and keeps the tables in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kR = 3.44428647676f;      // PARAM_R, rounded to float
constexpr uint32_t kH1Xor = 553105253u;   // the neighbor hash's h1 salt
constexpr int kMaxNum = 32;               // neighbors per lane (cap 64)
constexpr int kThreads = 128;

struct Stream {
  uint64_t x, y;
};

__device__ __forceinline__ Stream load_stream(const long long* seeds,
                                              long long l) {
  const long long* s = seeds + 4 * l;
  Stream st;
  st.x = (static_cast<uint64_t>(s[0]) << 32) |
         static_cast<uint32_t>(s[1]);
  st.y = (static_cast<uint64_t>(s[2]) << 32) |
         static_cast<uint32_t>(s[3]);
  return st;
}

__device__ __forceinline__ void store_stream(long long* seeds, long long l,
                                             const Stream& st) {
  long long* s = seeds + 4 * l;
  s[0] = static_cast<long long>(st.x >> 32);
  s[1] = static_cast<long long>(st.x & 0xFFFFFFFFull);
  s[2] = static_cast<long long>(st.y >> 32);
  s[3] = static_cast<long long>(st.y & 0xFFFFFFFFull);
}

// xorshift128+ (random.cl.inc:13-25)
__device__ __forceinline__ uint64_t next_word(Stream& st) {
  uint64_t s1 = st.x;
  const uint64_t s0 = st.y;
  st.x = s0;
  s1 ^= s1 << 23;
  st.y = s1 ^ s0 ^ (s1 >> 17) ^ (s0 >> 26);
  return st.y + s0;
}

// (float)rand() / 2^64 (random.cl.inc:34-35)
__device__ __forceinline__ float uniform(Stream& st) {
  const uint64_t w = next_word(st);
  const float hi = __uint2float_rn(static_cast<uint32_t>(w >> 32));
  const float lo = __uint2float_rn(static_cast<uint32_t>(w));
  return __fmul_rn(__fadd_rn(__fmul_rn(hi, 0x1p32f), lo), 0x1p-64f);
}

__device__ __forceinline__ float uniform_pos(Stream& st) {
  float u;
  do {
    u = uniform(st);
  } while (u == 0.0f);
  return u;
}

struct Tables {
  float y[128];
  long long k[128];
  float w[128];
};

__device__ __forceinline__ void load_tables(Tables& t, const float* ytab,
                                            const long long* ktab,
                                            const float* wtab) {
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    t.y[i] = ytab[i];
    t.k[i] = ktab[i];
    t.w[i] = wtab[i];
  }
  __syncthreads();
}

// gsl_ran_gaussian_ziggurat (random.cl.inc:221-274): one word for the
// layer, sign and j; one uniform for the wedge or the tail, one more for
// the tail.
__device__ float randn(Stream& st, const Tables& t) {
  for (;;) {
    const uint32_t kl = static_cast<uint32_t>(next_word(st));
    const uint32_t i_raw = kl & 0xFFu;
    const float sign = (i_raw & 0x80u) ? 1.0f : -1.0f;
    const int i = static_cast<int>(i_raw & 0x7Fu);
    const uint32_t j = (kl >> 8) & 0xFFFFFFu;
    float x = __fmul_rn(__uint2float_rn(j), t.w[i]);
    if (static_cast<long long>(j) < t.k[i]) return sign * x;
    const float u1 = uniform(st);
    float y;
    if (i == 127) {
      const float u2 = uniform(st);
      x = __fsub_rn(kR, __fdiv_rn(logf(__fsub_rn(1.0f, u1)), kR));
      y = __fmul_rn(expf(__fmul_rn(-kR, __fsub_rn(x, 0.5f * kR))), u2);
    } else {
      y = __fadd_rn(t.y[i + 1], __fmul_rn(__fsub_rn(t.y[i], t.y[i + 1]), u1));
    }
    if (y < expf(__fmul_rn(__fmul_rn(-0.5f, x), x))) return sign * x;
  }
}

// Marsaglia-Tsang (random.cl.inc:353-391); boost = 1 runs the a < 1
// pre-pass (f_boost = u^(1/a), then a + 1).
__device__ float rand_gamma(Stream& st, const Tables& t, float d, float c,
                            float b, int boost, float inv_a) {
  float f_boost = 1.0f;
  if (boost) f_boost = __fmul_rn(f_boost, powf(uniform_pos(st), inv_a));
  for (;;) {
    const float x = randn(st, t);
    const float v = __fadd_rn(1.0f, __fmul_rn(c, x));
    if (!(v > 0.0f)) continue;
    const float v3 = __fmul_rn(__fmul_rn(v, v), v);
    const float u = uniform_pos(st);
    const float sq = __fmul_rn(x, x);
    const bool squeeze =
        u < __fsub_rn(1.0f, __fmul_rn(__fmul_rn(0.0331f, sq), sq));
    const bool full =
        logf(u) < __fadd_rn(__fmul_rn(0.5f, sq),
                            __fmul_rn(d, __fadd_rn(__fsub_rn(1.0f, v3),
                                                   logf(v3))));
    if (squeeze || full)
      return __fmul_rn(__fmul_rn(f_boost, b), __fmul_rn(d, v3));
  }
}

__global__ void randn_lanes_kernel(long long* seeds, const bool* mask,
                                   float* out, int S, int L, int k,
                                   const float* ytab, const long long* ktab,
                                   const float* wtab) {
  __shared__ Tables t;
  load_tables(t, ytab, ktab, wtab);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  Stream st = load_stream(seeds, l);
  for (int s = 0; s < S; ++s) {
    float* o = out + (static_cast<size_t>(s) * L + l) * k;
    if (mask[static_cast<size_t>(s) * L + l]) {
      for (int i = 0; i < k; ++i) o[i] = randn(st, t);
    } else {
      for (int i = 0; i < k; ++i) o[i] = 0.0f;
    }
  }
  store_stream(seeds, l, st);
}

// sample.cc:13-78: each word is one randint in [0, N); a draw equal to the
// node, or already in the lane's open-addressing table (capacity 2 num,
// h1 = (r ^ 553105253) % capacity, stride 1 + 2 capacity, which is 1
// modulo the capacity), is redrawn; the output is the table in slot
// order.
__global__ void neighbors_lanes_kernel(long long* seeds, const int* nodes,
                                       const bool* mask, long long* out,
                                       int S, int L, int N, int num) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int cap = 2 * num;
  const uint32_t stride = static_cast<uint32_t>(1 + (cap << 1));
  int table[2 * kMaxNum];
  Stream st = load_stream(seeds, l);
  for (int s = 0; s < S; ++s) {
    const size_t lane = static_cast<size_t>(s) * L + l;
    long long* o = out + lane * num;
    if (!mask[lane]) {
      for (int i = 0; i < num; ++i) o[i] = N;
      continue;
    }
    const int node = nodes[lane];
    for (int i = 0; i < cap; ++i) table[i] = N;
    int count = 0;
    while (count < num) {
      const int r = static_cast<int>(next_word(st) %
                                     static_cast<uint64_t>(N));
      if (r == node) continue;
      uint32_t h = (static_cast<uint32_t>(r) ^ kH1Xor) %
                   static_cast<uint32_t>(cap);
      for (;;) {
        const int v = table[h];
        if (v == r) break;                  // duplicate: redraw
        if (v == N) {                       // empty slot: insert
          table[h] = r;
          ++count;
          break;
        }
        h = (h + stride) % static_cast<uint32_t>(cap);
      }
    }
    int j = 0;
    for (int i = 0; i < cap; ++i)
      if (table[i] != N) o[j++] = table[i];
  }
  store_stream(seeds, l, st);
}

__global__ void gamma_lanes_kernel(long long* seeds, const bool* mask,
                                   float* out, int S, long long L, float d,
                                   float c, float b, int boost, float inv_a,
                                   const float* ytab, const long long* ktab,
                                   const float* wtab) {
  __shared__ Tables t;
  load_tables(t, ytab, ktab, wtab);
  const long long l =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= L) return;
  Stream st = load_stream(seeds, l);
  for (int s = 0; s < S; ++s) {
    const size_t at = static_cast<size_t>(s) * L + l;
    out[at] = mask[at] ? rand_gamma(st, t, d, c, b, boost, inv_a) : 0.0f;
  }
  store_stream(seeds, l, st);
}

unsigned blocks_for(long long lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

}  // namespace

// Each launcher runs on `stream` and returns the launch's CUDA error (0
// on success). Nothing is allocated here: the wrapper passes the outputs.
extern "C" int randn_lanes_launch(long long* seeds, const bool* mask,
                                  float* out, int S, int L, int k,
                                  const float* ytab, const long long* ktab,
                                  const float* wtab, void* stream) {
  if (L <= 0 || S <= 0) return 0;
  randn_lanes_kernel<<<blocks_for(L), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      seeds, mask, out, S, L, k, ytab, ktab, wtab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int neighbors_lanes_launch(long long* seeds, const int* nodes,
                                      const bool* mask, long long* out,
                                      int S, int L, int N, int num,
                                      void* stream) {
  if (num > kMaxNum) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0 || S <= 0) return 0;
  neighbors_lanes_kernel<<<blocks_for(L), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      seeds, nodes, mask, out, S, L, N, num);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gamma_lanes_launch(long long* seeds, const bool* mask,
                                  float* out, int S, long long L, float d,
                                  float c, float b, int boost, float inv_a,
                                  const float* ytab, const long long* ktab,
                                  const float* wtab, void* stream) {
  if (L <= 0 || S <= 0) return 0;
  gamma_lanes_kernel<<<blocks_for(L), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      seeds, mask, out, S, L, d, c, b, boost, inv_a, ytab, ktab, wtab);
  return static_cast<int>(cudaGetLastError());
}
