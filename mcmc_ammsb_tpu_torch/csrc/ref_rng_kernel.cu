// The bit-exact reference RNG on the card, with each xorshift128+ stream
// split across the threads of a warp or a block by exact jump-ahead (the
// original GPU code gives a stream one thread: phi.cc:114-121 for the K
// noise draws of a node lane, sample.cc:13-78 for the neighbor sampler).
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
// reference's ulong2; each entry reads `seeds` and writes every live
// stream's new state to `seeds_out` (which may be `seeds`).
//
// Bits: every float operation is one IEEE operation with round to nearest
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract a
// product and a sum into an FMA: the plain version runs them as separate
// torch operations. The u32 -> f32 conversions are __uint2float_rn. logf
// and expf are CUDA's full-precision functions, which torch's log and exp
// call on the card. The ziggurat tables come from the plain version's
// float64 construction, passed in, never recomputed here.
//
// The split. xorshift128+'s state transition is linear over GF(2)^128, so
// the state d words ahead is M^d s; the wrapper builds the matrices in
// numpy and passes each as 32 tables of the 16 XORs of four of its
// columns (jump: 32 lookups). A group of T threads owns a stream; in each
// round thread t takes the G words at t*G of the round: its start is the
// product of the jumps G*2^b of its index's bits (log2 T jumps, one after
// another), and each round it jumps T*G - G from the end of its segment.
// A block stages the tables in shared memory by one bulk copy. Two
// layouts (refblock.py randn_layout): a block of T = 256, G = 32 per
// stream where few streams draw many values (the phi noise: 64 streams x
// up to 51,200 draws, 64 blocks of 8 warps, ~7 rounds of 8192 words; one
// long stream), else a warp of T = 32, G = 16 per stream, four per block
// (the theta noise: 256 streams x 400 draws, 64 blocks of 4 warps, one
// round of 512 words). neighbors_lanes takes a warp per stream, a block
// each (64 blocks for the --rng reference path's 64 node lanes).
//
// randn_lanes decodes every position of a round at once: the ziggurat
// round that would start there (accept, value, 1-3 words), first the
// ktab tests of all G positions without a branch, then the wedge and tail
// tests of the ~1% that fail them. A segment's rounds from each of the
// three entry offsets a straddling round can leave follow from the masks
// of the 2- and 3-word rounds (round_starts visits only those), which
// gives a map entry -> (exit offset, accepted draws); an exclusive scan
// of the maps over the group gives each thread its entry and its first
// draw index. The group stages the round's draws in draw order over the
// round's words and writes them out together: draw d is column d % k of
// the (d / k)-th drawing step. The round's total map carries the entry
// offset and the draw count to the next round; the thread with the last
// draw steps to that round's end and writes the new seeds. This is the
// JAX decoder's idea (_decode_randn_rounds) with a scan of maps in place
// of pointer doubling.
//
// neighbors_lanes takes 32 candidates at a time, one word % N per lane
// (an exact Barrett reduction, word_mod): a candidate is taken iff it is
// not the node and no earlier candidate of its step had its value
// (__match_any_sync, then a look at the taken list), since the
// reference's table only ever holds taken values and a redraw equals the
// node or one of them. Steps go in batches of 32: the warp selects each
// step's ids in turn, then lane j inserts step j's ids in order into its
// 2*num-slot table, whose probe is linear (stride 1 + 2 cap is 1 modulo
// cap): each goes to the first free slot at or after its hash, found on a
// 64-bit occupancy mask, and the lane writes the table in slot order.
//
// What bounds it on an H100: the outputs' bytes (randn at S=200, L=64,
// K=256: 13.1 MB, 3.9 us at 3.35 TB/s) against each group's chain of
// dependent work, since few groups run (64 or 256 streams): a round's
// words, decode, maps, scan and write (~20k cycles a phi-noise round of a
// block), and before it the start's log2 T jumps. The theta noise's one
// round is shorter than its start. A neighbor step is bound by the
// warp's selection round (~600 cycles) and a batch by its lanes' chains of
// 32 inserts. gamma_lanes keeps one thread per stream: it runs at the
// init only, over N x 32 streams that fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kR = 3.44428647676f;      // PARAM_R, rounded to float
constexpr uint32_t kH1Xor = 553105253u;   // the neighbor hash's h1 salt
constexpr int kMaxNum = 32;               // neighbors per lane (cap 64)
constexpr int kThreads = 128;             // gamma_lanes' block
constexpr unsigned kFull = 0xFFFFFFFFu;

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
__device__ __forceinline__ float word_uniform(uint64_t w) {
  const float hi = __uint2float_rn(static_cast<uint32_t>(w >> 32));
  const float lo = __uint2float_rn(static_cast<uint32_t>(w));
  return __fmul_rn(__fadd_rn(__fmul_rn(hi, 0x1p32f), lo), 0x1p-64f);
}

__device__ __forceinline__ float uniform(Stream& st) {
  return word_uniform(next_word(st));
}

__device__ __forceinline__ float uniform_pos(Stream& st) {
  float u;
  do {
    u = uniform(st);
  } while (u == 0.0f);
  return u;
}

// w % n for n < 2^31, with inv = floor((2^64 - 1) / n): the quotient
// estimate mulhi(w, inv) falls short of w / n by at most 2, so at most two
// corrections follow (exact, and no 64-bit division in the loop).
__device__ __forceinline__ uint32_t word_mod(uint64_t w, int n,
                                             uint64_t inv) {
  const uint64_t n64 = static_cast<uint64_t>(n);
  uint64_t r = w - __umul64hi(w, inv) * n64;
  if (r >= n64) r -= n64;
  if (r >= n64) r -= n64;
  return static_cast<uint32_t>(r);
}

// The jump by one distance: entry [n][v] holds the XOR of the matrix's
// columns 4n + i for the bits i of v (columns 0-63: state.x's bits,
// 64-127: state.y's), as (x, y).
struct JumpTable {
  ulonglong2 e[32][16];
};

__device__ __forceinline__ Stream jump(const JumpTable* jt,
                                       const Stream& s) {
  uint64_t ox[4] = {0, 0, 0, 0}, oy[4] = {0, 0, 0, 0};  // 4 XOR chains
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const ulonglong2 e = jt->e[n][(s.x >> (4 * n)) & 15u];
    ox[n & 3] ^= e.x;
    oy[n & 3] ^= e.y;
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const ulonglong2 e = jt->e[16 + n][(s.y >> (4 * n)) & 15u];
    ox[n & 3] ^= e.x;
    oy[n & 3] ^= e.y;
  }
  return Stream{(ox[0] ^ ox[1]) ^ (ox[2] ^ ox[3]),
                (oy[0] ^ oy[1]) ^ (oy[2] ^ oy[3])};
}

// A layout's tables (refblock.py jump_distances): the jumps G * 2^b for
// the bits b of a thread's index, then the round's jump.
template <int kT>
__host__ __device__ constexpr int start_tables() {
  return kT == 32 ? 5 : (kT == 64 ? 6 : (kT == 128 ? 7 : 8));
}

// Thread t's start in a group of T: the jumps of the bits of t, one after
// another (measured faster than 3 jumps of base-4 digits from 7 tables,
// whose lanes read more tables at a time).
template <int kT>
__device__ __forceinline__ Stream segment_start(const JumpTable* jt,
                                                Stream st, int t) {
#pragma unroll
  for (int b = 0; (1 << b) < kT; ++b)
    if ((t >> b) & 1) st = jump(jt + b, st);
  return st;
}

// A bulk copy (Hopper's 1-D TMA) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global to shared memory, counted on an mbarrier.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%2], [%3], %1, [%0];\n"
               :: "r"(smem_u32(bar)), "r"(bytes), "r"(smem_u32(dst)),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)) : "memory");
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

// One round of gsl_ran_gaussian_ziggurat (random.cl.inc:221-274) on the
// layer word kl: the layer, sign and j; a uniform for the wedge or the
// tail (u1()), one more for the tail (u2()). Returns whether the round
// accepts, with its value and the words it consumed (1, 2 or 3).
template <class U1, class U2>
__device__ __forceinline__ bool zig_round(uint32_t kl, const Tables& t,
                                          U1 u1f, U2 u2f, float& value,
                                          int& cons) {
  const uint32_t i_raw = kl & 0xFFu;
  const float sign = (i_raw & 0x80u) ? 1.0f : -1.0f;
  const int i = static_cast<int>(i_raw & 0x7Fu);
  const uint32_t j = (kl >> 8) & 0xFFFFFFu;
  float x = __fmul_rn(__uint2float_rn(j), t.w[i]);
  bool accept = static_cast<long long>(j) < t.k[i];
  cons = 1;
  if (!accept) {
    const float u1 = u1f();
    float y;
    if (i == 127) {
      const float u2 = u2f();
      cons = 3;
      x = __fsub_rn(kR, __fdiv_rn(logf(__fsub_rn(1.0f, u1)), kR));
      y = __fmul_rn(expf(__fmul_rn(-kR, __fsub_rn(x, 0.5f * kR))), u2);
    } else {
      cons = 2;
      y = __fadd_rn(t.y[i + 1], __fmul_rn(__fsub_rn(t.y[i], t.y[i + 1]), u1));
    }
    accept = y < expf(__fmul_rn(__fmul_rn(-0.5f, x), x));
  }
  value = sign * x;
  return accept;
}

// N(0,1) from one stream, round after round (the per-lane loop).
__device__ float randn(Stream& st, const Tables& t) {
  for (;;) {
    float v;
    int cons;
    const auto u = [&] { return uniform(st); };
    if (zig_round(static_cast<uint32_t>(next_word(st)), t, u, u, v, cons))
      return v;
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

// ---------------------------------------------------------------------------
// randn_lanes: the split decode
// ---------------------------------------------------------------------------

// A segment's map: entry offset e in {0, 1, 2} -> (exit offset << 16) |
// accepted draws. Counts stay below 2^16 (a round holds T*G <= 8192
// words).
struct Map {
  uint32_t m[3];
};

__device__ __forceinline__ uint32_t at(const Map& a, uint32_t e) {
  return e == 0 ? a.m[0] : (e == 1 ? a.m[1] : a.m[2]);
}

__device__ __forceinline__ Map identity_map() {
  return Map{{0u, 1u << 16, 2u << 16}};
}

// a, then b
__device__ __forceinline__ Map compose(const Map& a, const Map& b) {
  Map c;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const uint32_t y = at(b, a.m[e] >> 16);
    c.m[e] = (y & 0xFFFF0000u) | ((a.m[e] + y) & 0xFFFFu);
  }
  return c;
}

__device__ __forceinline__ Map shfl_up(const Map& a, int off) {
  Map o;
#pragma unroll
  for (int e = 0; e < 3; ++e) o.m[e] = __shfl_up_sync(kFull, a.m[e], off);
  return o;
}

__device__ __forceinline__ int round_words(uint32_t c2, uint32_t c3,
                                           int p) {
  return 1 + ((c2 >> p) & 1) + ((c3 >> p) & 1);
}

// The rounds of a segment of G words entered at offset f (0-2): their
// start positions as a bit mask, and the offset at which the next segment
// is entered. c2 marks the positions whose round takes 2 or 3 words, c3
// those that take 3; every other position starts a 1-word round, so the
// walk only visits the ~1% that do not.
template <int kG>
__device__ __forceinline__ uint32_t round_starts(uint32_t c2, uint32_t c3,
                                                 int f, int& exit) {
  const uint32_t all = kG == 32 ? kFull : (1u << kG) - 1;
  uint32_t skip = 0, multi = f < kG ? c2 & (all << f) : 0u;
  int p = f;
  while (multi) {
    const int q = __ffs(multi) - 1;
    const int c = round_words(c2, c3, q);
    if (q + 1 < kG) skip |= ((1u << (c - 1)) - 1) << (q + 1);  // its words
    p = q + c;
    multi = p < kG ? multi & (kFull << p) : 0u;
  }
  exit = p > kG ? p - kG : 0;
  return f < kG ? all & (kFull << f) & ~skip : 0u;
}

template <int kT>
__device__ __forceinline__ void group_sync() {
  if constexpr (kT == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Per-warp totals for a block-wide scan: maps double-buffered by round,
// the step counts (drawing | others << 16).
template <int kT>
struct Scratch {
  Map maps[2][kT / 32];
  uint32_t counts[kT / 32];
};

// Shared memory of randn_lanes_kernel: the layout's jump tables, then per
// group a round's words [kG + 2][kT] (thread t's column; after the decode,
// the round's values in draw order), its decoded values [kG][kT], the
// steps [S] (the drawing steps from the front, the others from the back)
// and the mask column [S].
__host__ __device__ constexpr size_t randn_group_bytes(int kT, int kG,
                                                       int S) {
  return (kG + 2) * kT * 8ull + kG * kT * 4ull + S * 4ull +
         (S + 7ull) / 8 * 8;
}

// One stream per group of kT threads (kT = 32: blockDim.x / 32 streams a
// block; kT = 256: one).
template <int kT, int kG>
__global__ void __launch_bounds__(kT == 32 ? 128 : kT)
    randn_lanes_kernel(const long long* seeds, long long* seeds_out,
                       const bool* __restrict__ mask,
                       float* __restrict__ out, int S, int L, int k,
                       const float* ytab, const long long* ktab,
                       const float* wtab, const JumpTable* jt) {
  static_assert(kG <= 32 && kT * kG < 65536, "map counts are 16 bits");
  constexpr int kTables = start_tables<kT>() + 1;
  constexpr int kPre = 256 / kT;  // mask loads issued at once per thread
  constexpr uint32_t kAll = kG == 32 ? kFull : (1u << kG) - 1;
  __shared__ Tables tab;
  __shared__ Scratch<kT> sc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / kT;
  const int g = threadIdx.x / kT, t = threadIdx.x % kT;
  const int lane = threadIdx.x & 31, warp = t >> 5;
  const int l = blockIdx.x * groups + g;
  const bool live = l < L;
  __shared__ __align__(8) unsigned long long bar;
  // the jump tables, staged by one bulk copy that runs beside the rest of
  // the prologue
  JumpTable* sjt = reinterpret_cast<JumpTable*>(smem);
  if (threadIdx.x == 0)
    bulk_load(sjt, jt, kTables * sizeof(JumpTable), &bar);
  uint64_t* words = reinterpret_cast<uint64_t*>(
      smem + kTables * sizeof(JumpTable) +
      g * randn_group_bytes(kT, kG, S));
  float* stage = reinterpret_cast<float*>(words);
  float* vals = reinterpret_cast<float*>(words + (kG + 2) * kT);
  int* steps = reinterpret_cast<int*>(vals + kG * kT);
  bool* flags = reinterpret_cast<bool*>(steps + S);

  // every load of the prologue at once: the mask column's first steps,
  // the seeds and the ziggurat tables (blockDim.x >= 128)
  bool f[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int s = u * kT + t;
    f[u] = live && s < S && mask[static_cast<size_t>(s) * L + l];
  }
  const Stream seed = live ? load_stream(seeds, l) : Stream{0, 0};
  if (threadIdx.x < 128) {
    tab.y[threadIdx.x] = ytab[threadIdx.x];
    tab.k[threadIdx.x] = ktab[threadIdx.x];
    tab.w[threadIdx.x] = wtab[threadIdx.x];
  }
#pragma unroll
  for (int u = 0; u < kPre; ++u)
    if (u * kT + t < S) flags[u * kT + t] = f[u];
  for (int s = kPre * kT + t; s < S; s += kT)
    flags[s] = live && mask[static_cast<size_t>(s) * L + l];
  __syncthreads();
  if (!live) return;             // a whole group (kT = 256: the block)

  // the drawing steps in order, and zeros at the others; a column whose
  // every step draws (the theta noise's) needs no list
  bool mine_on = S <= kPre * kT;
#pragma unroll
  for (int u = 0; u < kPre; ++u) mine_on &= u * kT + t >= S || f[u];
  bool all_on;
  if constexpr (kT > 32) {
    all_on = __syncthreads_and(mine_on);
  } else {
    all_on = __all_sync(kFull, mine_on);
  }
  int n_on = all_on ? S : 0, n_off = 0;
  for (int base = 0; base < S && !all_on; base += kT) {
    const int s = base + t;
    const bool on = s < S && flags[s];
    const bool off = s < S && !on;
    const uint32_t b_on = __ballot_sync(kFull, on);
    const uint32_t b_off = __ballot_sync(kFull, off);
    const uint32_t below = (1u << lane) - 1;
    int r_on = __popc(b_on & below), r_off = __popc(b_off & below);
    int t_on = __popc(b_on), t_off = __popc(b_off);
    if constexpr (kT > 32) {
      if (lane == 0) sc.counts[warp] = t_on | (t_off << 16);
      __syncthreads();
      t_on = t_off = 0;
#pragma unroll
      for (int v = 0; v < kT / 32; ++v) {
        const uint32_t c = sc.counts[v];
        if (v < warp) {
          r_on += c & 0xFFFFu;
          r_off += c >> 16;
        }
        t_on += c & 0xFFFFu;
        t_off += c >> 16;
      }
      __syncthreads();
    }
    if (on) steps[n_on + r_on] = s;
    if (off) steps[S - 1 - (n_off + r_off)] = s;
    n_on += t_on;
    n_off += t_off;
  }
  group_sync<kT>();
  for (int i = t; i < n_off * k; i += kT) {
    const int o = i / k;
    out[(static_cast<size_t>(steps[S - 1 - o]) * L + l) * k + (i - o * k)] =
        0.0f;
  }
  const uint32_t total = static_cast<uint32_t>(n_on) * k;
  if (total == 0) {              // uniform over the group
    if (t == 0) store_stream(seeds_out, l, seed);
    return;
  }

  bulk_wait(&bar);
  Stream st = segment_start<kT>(sjt, seed, t);
  uint32_t drawn = 0, entry = 0;
  int parity = 0;
  // the write of a round's draws: thread t takes draws drawn + t, + kT,
  // ...; draw d is column d % k of the (d / k)-th drawing step
  const uint32_t dj = kT / k, dc = kT % k;
  while (drawn < total) {
    // this round's words t*G .. t*G + G + 1 (a round at one of the last G
    // positions may read two past them)
    uint64_t w[kG + 2];
    Stream cur = st, post;
#pragma unroll
    for (int i = 0; i < kG + 2; ++i) {
      w[i] = next_word(cur);
      words[i * kT + t] = w[i];
      if (i == kG - 1) post = cur;
    }
    // the round starting at each position: first every ktab test, without
    // branches; then the wedge and tail tests of the ~1% that fail it
    uint32_t acc = 0;
    float v[kG];
#pragma unroll
    for (int p = 0; p < kG; ++p) {
      const uint32_t kl = static_cast<uint32_t>(w[p]);
      const int i = static_cast<int>(kl & 0x7Fu);
      const uint32_t j = (kl >> 8) & 0xFFFFFFu;
      const float sign = (kl & 0x80u) ? 1.0f : -1.0f;
      acc |= static_cast<uint32_t>(static_cast<long long>(j) < tab.k[i])
             << p;
      v[p] = sign * __fmul_rn(__uint2float_rn(j), tab.w[i]);
    }
    const uint32_t c2 = ~acc & kAll;
    uint32_t c3 = 0;
    for (uint32_t rest = c2; rest; rest &= rest - 1) {
      const int p = __ffs(rest) - 1;
      float x;
      int cons;
      const bool a = zig_round(
          static_cast<uint32_t>(words[p * kT + t]), tab,
          [&] { return word_uniform(words[(p + 1) * kT + t]); },
          [&] { return word_uniform(words[(p + 2) * kT + t]); }, x, cons);
      acc |= static_cast<uint32_t>(a) << p;
      c3 |= static_cast<uint32_t>(cons == 3) << p;
      vals[p * kT + t] = x;
    }

    // the segment's map
    Map m;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      int exit;
      const uint32_t starts = round_starts<kG>(c2, c3, e, exit);
      m.m[e] = (static_cast<uint32_t>(exit) << 16) | __popc(starts & acc);
    }

    // exclusive scan of the maps over the group, and the round's total
    Map incl = m;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Map o = shfl_up(incl, off);
      if (lane >= off) incl = compose(o, incl);
    }
    Map excl = shfl_up(incl, 1);
    if (lane == 0) excl = identity_map();
    Map round;
    if constexpr (kT > 32) {
      if (lane == 31) sc.maps[parity][warp] = incl;
      __syncthreads();
      Map pre = identity_map();
      for (int u = 0; u < warp; ++u) pre = compose(pre, sc.maps[parity][u]);
      excl = compose(pre, excl);
      round = pre;
      for (int u = warp; u < kT / 32; ++u)
        round = compose(round, sc.maps[parity][u]);
      parity ^= 1;
    } else {
#pragma unroll
      for (int e = 0; e < 3; ++e)
        round.m[e] = __shfl_sync(kFull, incl.m[e], 31);
    }

    // this thread's draws, staged in draw order over the round's words
    const uint32_t mine = at(excl, entry), r = at(round, entry);
    const uint32_t first = drawn + (mine & 0xFFFFu);
    int exit;
    const uint32_t taken =
        round_starts<kG>(c2, c3, static_cast<int>(mine >> 16), exit) & acc;
#pragma unroll
    for (int p = 0; p < kG; ++p)
      if ((taken >> p) & 1u)
        stage[first - drawn + __popc(taken & ((1u << p) - 1))] =
            ((c2 >> p) & 1u) ? vals[p * kT + t] : v[p];
    if (first < total && total - first <= static_cast<uint32_t>(__popc(taken))) {
      uint32_t last = taken;     // the stream's last draw: new seeds
      for (uint32_t i = first; i < total - 1; ++i) last &= last - 1;
      const int p = __ffs(last) - 1, end = p + round_words(c2, c3, p);
      Stream e = end >= kG ? post : st;  // the state after that round's
      for (int q = end >= kG ? kG : 0; q < end; ++q) next_word(e);  // last
      store_stream(seeds_out, l, e);                                // word
    }
    group_sync<kT>();
    // ... and written by the group in draw order
    const uint32_t n = min(r & 0xFFFFu, total - drawn);
    uint32_t j = (drawn + t) / k, c = drawn + t - j * k;
    for (uint32_t i = t; i < n; i += kT) {
      const size_t step = all_on ? j : steps[j];
      out[(step * L + l) * k + c] = stage[i];
      j += dj;
      c += dc;
      if (c >= static_cast<uint32_t>(k)) {
        c -= k;
        ++j;
      }
    }
    entry = r >> 16;
    drawn += r & 0xFFFFu;
    if (drawn < total) st = jump(sjt + start_tables<kT>(), post);
    group_sync<kT>();
  }
}

// ---------------------------------------------------------------------------
// neighbors_lanes: a warp per stream
// ---------------------------------------------------------------------------

// sample.cc:13-78: each word is one randint in [0, N); a draw equal to the
// node, or already in the lane's open-addressing table (capacity 2 num,
// h1 = (r ^ 553105253) % capacity, stride 1 + 2 capacity, which is 1
// modulo the capacity), is redrawn; the output is the table in slot
// order. A warp's buffer holds the ids of kW = 32 kG words (lane t's
// segment: word i at buf[i * 32 + t]). Steps go in batches of 32: the
// warp takes each step's ids in turn into row j of `ids` (their hashes in
// `homes`), then lane j inserts step j's ids into its table and writes
// them in slot order, the 32 steps' inserts side by side.
template <int kG>
__global__ void __launch_bounds__(128)
    neighbors_lanes_kernel(const long long* seeds, long long* seeds_out,
                           const int* __restrict__ nodes,
                           const bool* __restrict__ mask,
                           long long* __restrict__ out, int S, int L, int N,
                           int num, const JumpTable* jt) {
  constexpr int kW = 32 * kG, kRow = kMaxNum + 1;  // rows padded: no bank
  extern __shared__ uint32_t nsmem[];               // conflicts in the
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;  // inserts
  const int l = blockIdx.x * (blockDim.x >> 5) + warp;
  if (l >= L) return;
  uint32_t* buf = nsmem + warp * (kW + 2 * 32 * kRow);
  uint32_t* ids = buf + kW;
  uint32_t* homes = ids + 32 * kRow;
  const uint64_t inv = ~0ull / static_cast<uint64_t>(N);
  const uint32_t cap = 2 * num;
  const uint64_t cap_mask = cap == 64 ? ~0ull : (1ull << cap) - 1;
  const uint32_t below = (1u << t) - 1;

  Stream st = segment_start<32>(jt, load_stream(seeds, l), t);
  Stream post;
  const auto fill = [&] {
    Stream cur = st;
#pragma unroll
    for (int i = 0; i < kG; ++i)
      buf[i * 32 + t] = word_mod(next_word(cur), N, inv);
    post = cur;
    __syncwarp();
  };
  fill();
  long long q = 0, p = 0;        // stream positions: buffer, next word
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int batch = min(32, S - s0);
    const size_t mine = static_cast<size_t>(s0 + t) * L + l;
    const bool my_on = t < batch && mask[mine];
    const uint32_t my_node = t < batch ? static_cast<uint32_t>(nodes[mine])
                                       : 0u;
    const uint32_t on_steps = __ballot_sync(kFull, my_on);
    for (int j = 0; j < batch; ++j) {
      const uint32_t node = __shfl_sync(kFull, my_node, j);
      if (!((on_steps >> j) & 1u)) continue;
      uint32_t* row = ids + j * kRow;
      int n_taken = 0;
      while (n_taken < num) {
        if (p == q + kW) {
          st = jump(jt + start_tables<32>(), post);
          fill();
          q += kW;
        }
        const int avail = static_cast<int>(min(32ll, q + kW - p));
        const int rel = static_cast<int>(p - q) + t;
        const bool has = t < avail;
        const uint32_t r = has ? buf[(rel % kG) * 32 + rel / kG] : kFull;
        const uint32_t same = __match_any_sync(kFull, r);
        bool fresh = has && __ffs(same) - 1 == t && r != node;
        for (int c = 0; fresh && c < n_taken; ++c) fresh = row[c] != r;
        const uint32_t bal = __ballot_sync(kFull, fresh);
        const int rank = __popc(bal & below), need = num - n_taken;
        const uint32_t last = __ballot_sync(kFull, fresh && rank == need - 1);
        if (fresh && rank < need) {
          row[n_taken + rank] = r;
          homes[j * kRow + n_taken + rank] = (r ^ kH1Xor) % cap;
        }
        n_taken += min(__popc(bal), need);
        p += last ? __ffs(last) : avail;
        __syncwarp();
      }
    }
    if (t < batch) {
      long long* o = out + mine * num;
      if (!my_on) {
        for (int c = 0; c < num; ++c) o[c] = N;
      } else {
        // the inserts in order: the first free slot at or after the hash
        const uint32_t* row = ids + t * kRow;
        uint32_t* slots = homes + t * kRow;
        uint64_t occ = 0;
        for (int c = 0; c < num; ++c) {
          const uint64_t free = ~occ & cap_mask;
          const uint64_t ahead = free & (~0ull << slots[c]);
          const uint32_t slot =
              __ffsll(static_cast<long long>(ahead ? ahead : free)) - 1;
          occ |= 1ull << slot;
          slots[c] = slot;
        }
        for (int c = 0; c < num; ++c)
          o[__popcll(occ & ((1ull << slots[c]) - 1))] = row[c];
      }
    }
    __syncwarp();
  }
  // the new seeds: the state at stream position p
  const int rel = static_cast<int>(p - q);
  const int owner = min(rel / kG, 31);
  if (t == owner) {
    Stream e = st;
    for (int i = owner * kG; i < rel; ++i) next_word(e);
    store_stream(seeds_out, l, e);
  }
}

// ---------------------------------------------------------------------------
// gamma_lanes: one thread per stream
// ---------------------------------------------------------------------------

__global__ void gamma_lanes_kernel(const long long* seeds,
                                   long long* seeds_out, const bool* mask,
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
  store_stream(seeds_out, l, st);
}

constexpr int kWarpG = 16;                 // refblock.WARP_LAYOUT
constexpr int kBlockT = 256, kBlockG = 32;  // refblock.BLOCK_LAYOUT
constexpr int kWarpsPerBlock = 4;        // randn_lanes' warp layout
constexpr int kNeighborWarps = 1;        // neighbors_lanes
// shared memory: the launch without opting in; a bound on the kernel's
// static arrays (the ziggurat tables, the scan's scratch)
constexpr size_t kDefaultSmem = 48 * 1024 - 4096;
constexpr size_t kStaticSmem = 4096;

int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

}  // namespace

// Each launcher runs on `stream` and returns the launch's CUDA error (0
// on success). Nothing is allocated here: the wrapper passes the outputs.
// `threads` picks the layout of randn_lanes (32: a warp per stream, 256:
// a block), `jump_tables` its tables (refblock.py jump_tables).
extern "C" int randn_lanes_launch(const long long* seeds,
                                  long long* seeds_out, const bool* mask,
                                  float* out, int S, int L, int k,
                                  const float* ytab, const long long* ktab,
                                  const float* wtab,
                                  const void* jump_tables, int threads,
                                  void* stream) {
  if (L <= 0 || S <= 0) return 0;
  const JumpTable* jt = static_cast<const JumpTable*>(jump_tables);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int limit = max_smem();
  if (threads == kBlockT) {
    const size_t smem = (start_tables<kBlockT>() + 1) * sizeof(JumpTable) +
                        randn_group_bytes(kBlockT, kBlockG, S);
    if (smem + kStaticSmem > static_cast<size_t>(limit))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = randn_lanes_kernel<kBlockT, kBlockG>;
    if (smem > kDefaultSmem)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    kernel<<<L, kBlockT, smem, cs>>>(seeds, seeds_out, mask, out, S, L, k, ytab, ktab,
                                     wtab, jt);
  } else if (threads == 32) {
    const size_t smem = (start_tables<32>() + 1) * sizeof(JumpTable) +
                        kWarpsPerBlock * randn_group_bytes(32, kWarpG, S);
    if (smem + kStaticSmem > static_cast<size_t>(limit))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = randn_lanes_kernel<32, kWarpG>;
    if (smem > kDefaultSmem)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    kernel<<<(L + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock,
             smem, cs>>>(seeds, seeds_out, mask, out, S, L, k, ytab, ktab,
                         wtab, jt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int neighbors_lanes_launch(const long long* seeds,
                                      long long* seeds_out, const int* nodes,
                                      const bool* mask, long long* out,
                                      int S, int L, int N, int num,
                                      const void* jump_tables,
                                      void* stream) {
  if (num > kMaxNum || num < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0 || S <= 0) return 0;
  const size_t smem =
      kNeighborWarps * (32 * kWarpG + 2 * 32 * (kMaxNum + 1)) * 4ull;
  neighbors_lanes_kernel<kWarpG>
      <<<(L + kNeighborWarps - 1) / kNeighborWarps, 32 * kNeighborWarps,
         smem, static_cast<cudaStream_t>(stream)>>>(
          seeds, seeds_out, nodes, mask, out, S, L, N, num,
          static_cast<const JumpTable*>(jump_tables));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gamma_lanes_launch(const long long* seeds,
                                  long long* seeds_out, const bool* mask,
                                  float* out, int S, long long L, float d,
                                  float c, float b, int boost, float inv_a,
                                  const float* ytab, const long long* ktab,
                                  const float* wtab, void* stream) {
  if (L <= 0 || S <= 0) return 0;
  gamma_lanes_kernel<<<static_cast<unsigned>((L + kThreads - 1) / kThreads),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seeds, seeds_out, mask, out, S, L, d, c, b, boost, inv_a, ytab, ktab,
      wtab);
  return static_cast<int>(cudaGetLastError());
}
