// Native host-side graph sampler for mcmc_ammsb_tpu.
//
// Role: the high-throughput host half of the training pipeline — SNAP
// edge-list parsing and minibatch sampling over CSR adjacency — the
// equivalent of the reference's C++ host samplers
// (/root/reference/mcmc/sample.cc:177-302) and graph ETL
// (/root/reference/mcmc/data.cc:36-78), built as a small C library
// bound via ctypes (no pybind11 in this image). Strategy semantics
// mirror mcmc_ammsb_tpu/sampling.py exactly; tests cross-check the two.
//
// Thread-free, allocation-light: one call fills a whole stack of padded
// minibatches so Python overhead amortizes across steps.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Csr {
  const int64_t* off;   // [N+1]
  const int32_t* cols;  // [2E], sorted per row
  int64_t n;
};

inline bool has_edge(const Csr& g, int32_t a, int32_t b) {
  const int32_t* lo = g.cols + g.off[a];
  const int32_t* hi = g.cols + g.off[a + 1];
  const int32_t* it = std::lower_bound(lo, hi, b);
  return it != hi && *it == b;
}

inline uint64_t pack(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

inline bool in_sorted(const uint64_t* arr, int64_t n, uint64_t key) {
  const uint64_t* end = arr + n;
  const uint64_t* it = std::lower_bound(arr, end, key);
  return it != end && *it == key;
}

struct Raw {
  std::vector<int32_t> eu, ev;
  double weight;
  bool ok = true;   // false: retry budget exhausted (caller returns -4)
};

using Rng = std::mt19937_64;

inline int64_t randn_below(Rng& rng, int64_t n) {
  return static_cast<int64_t>(rng() % static_cast<uint64_t>(n));
}

// NodeLink: all edges of one random non-isolated node; weight N
// (semantics of mcmc/sample.cc:253-268).
Raw sample_node_link(const Csr& g, Rng& rng, double n_f) {
  Raw r;
  for (int64_t attempts = 0;; ++attempts) {
    if (attempts > 100 * g.n + 1000) { r.ok = false; return r; }
    int32_t u = static_cast<int32_t>(randn_below(rng, g.n));
    int64_t deg = g.off[u + 1] - g.off[u];
    if (deg == 0) continue;
    r.eu.reserve(deg);
    r.ev.reserve(deg);
    for (int64_t t = g.off[u]; t < g.off[u + 1]; ++t) {
      int32_t v = g.cols[t];
      r.eu.push_back(std::min(u, v));
      r.ev.push_back(std::max(u, v));
    }
    r.weight = n_f;
    return r;
  }
}

// NodeNonLink: m distinct non-links sharing one endpoint; weight 2E/m
// (mcmc/sample.cc:275-293; excludes training AND held-out edges).
Raw sample_node_non_link(const Csr& g, Rng& rng, const uint64_t* heldout,
                         int64_t n_heldout, int64_t m, double e_f) {
  Raw r;
  int32_t u = static_cast<int32_t>(randn_below(rng, g.n));
  std::vector<int32_t> seen;
  int64_t attempts = 0;
  while (static_cast<int64_t>(r.eu.size()) < m) {
    if (++attempts > 100 * (m + g.n) + 1000) { r.ok = false; return r; }
    int32_t v = static_cast<int32_t>(randn_below(rng, g.n));
    if (v == u) continue;
    if (std::find(seen.begin(), seen.end(), v) != seen.end()) continue;
    int32_t a = std::min(u, v), b = std::max(u, v);
    if (has_edge(g, a, b)) continue;
    if (in_sorted(heldout, n_heldout, pack(a, b))) continue;
    seen.push_back(v);
    r.eu.push_back(a);
    r.ev.push_back(b);
  }
  r.weight = 2.0 * e_f / static_cast<double>(m);
  return r;
}

// Breadth-first link/non-link (mcmc/sample.cc:177-239 semantics).
Raw sample_bf(const Csr& g, Rng& rng, const bool link, int64_t m,
              double n_f, double e_f) {
  Raw r;
  std::vector<char> seen_u(g.n, 0);
  std::vector<int32_t> queue;
  std::vector<uint64_t> edges;
  size_t qhead = 0;
  int64_t attempts = 0;
  while (static_cast<int64_t>(edges.size()) < m) {
    if (++attempts > 100 * (m + g.n) + 1000) { r.ok = false; return r; }
    if (qhead >= queue.size()) {
      bool found = false;
      for (int64_t t = 0; t < 100 * g.n + 1000; ++t) {
        int32_t u = static_cast<int32_t>(randn_below(rng, g.n));
        if (!seen_u[u]) {
          queue.push_back(u);
          found = true;
          break;
        }
      }
      if (!found) { r.ok = false; return r; }
    }
    int32_t u = queue[qhead++];
    if (seen_u[u]) continue;
    seen_u[u] = 1;
    if (link) {
      for (int64_t t = g.off[u];
           t < g.off[u + 1] && static_cast<int64_t>(edges.size()) < m; ++t) {
        int32_t v = g.cols[t];
        queue.push_back(v);
        uint64_t key = pack(std::min(u, v), std::max(u, v));
        if (std::find(edges.begin(), edges.end(), key) == edges.end())
          edges.push_back(key);
      }
    } else {
      for (int i = 0; i < 32 && static_cast<int64_t>(edges.size()) < m; ++i) {
        int32_t v = -1;
        for (int64_t t = 0;; ++t) {
          if (t > 100 * g.n + 1000) { r.ok = false; return r; }
          v = static_cast<int32_t>(randn_below(rng, g.n));
          if (v != u && !has_edge(g, std::min(u, v), std::max(u, v))) break;
        }
        queue.push_back(v);
        uint64_t key = pack(std::min(u, v), std::max(u, v));
        if (std::find(edges.begin(), edges.end(), key) == edges.end())
          edges.push_back(key);
      }
    }
  }
  for (uint64_t key : edges) {
    r.eu.push_back(static_cast<int32_t>(key >> 32));
    r.ev.push_back(static_cast<int32_t>(key & 0xFFFFFFFFu));
  }
  r.weight = link ? e_f / static_cast<double>(m)
                  : (n_f * (n_f - 1.0) / 2.0 - e_f) / static_cast<double>(m);
  return r;
}

}  // namespace

extern "C" {

// Strategy codes shared with sampling.py: 0 NodeLink, 1 NodeNonLink,
// 2 Node, 3 BFLink, 4 BFNonLink, 5 BF.
int sample_batches(
    const int64_t* offsets, const int32_t* cols, int64_t n_nodes,
    const uint64_t* heldout_sorted, int64_t n_heldout,
    int strategy, int64_t mini_batch, double n_f, double e_f,
    int64_t n_batches, int64_t e_cap, int64_t b_cap, uint64_t seed,
    int32_t* edges_u, int32_t* edges_v, uint8_t* edge_mask,
    int32_t* nodes, uint8_t* node_mask, float* weights) {
  Csr g{offsets, cols, n_nodes};
  Rng rng(seed);
  for (int64_t s = 0; s < n_batches; ++s) {
    int strat = strategy;
    if (strat == 2) strat = (rng() & 1) ? 0 : 1;   // Node coin flip
    if (strat == 5) strat = (rng() & 1) ? 3 : 4;   // BF coin flip
    Raw r;
    switch (strat) {
      case 0: r = sample_node_link(g, rng, n_f); break;
      case 1:
        r = sample_node_non_link(g, rng, heldout_sorted, n_heldout,
                                 mini_batch, e_f);
        break;
      case 3: r = sample_bf(g, rng, true, mini_batch, n_f, e_f); break;
      case 4: r = sample_bf(g, rng, false, mini_batch, n_f, e_f); break;
      default: return -1;
    }
    if (!r.ok) return -4;
    int64_t ne = static_cast<int64_t>(r.eu.size());
    if (ne > e_cap) return -2;
    int32_t* bu = edges_u + s * e_cap;
    int32_t* bv = edges_v + s * e_cap;
    uint8_t* bm = edge_mask + s * e_cap;
    std::memset(bu, 0, e_cap * sizeof(int32_t));
    std::memset(bv, 0, e_cap * sizeof(int32_t));
    std::memset(bm, 0, e_cap);
    std::copy(r.eu.begin(), r.eu.end(), bu);
    std::copy(r.ev.begin(), r.ev.end(), bv);
    std::fill(bm, bm + ne, 1);

    // deduped endpoint set (ExtractNodesFromMiniBatch, learner.cc:162-173)
    std::vector<int32_t> uniq;
    uniq.reserve(2 * ne);
    uniq.insert(uniq.end(), r.eu.begin(), r.eu.end());
    uniq.insert(uniq.end(), r.ev.begin(), r.ev.end());
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    int64_t nn = static_cast<int64_t>(uniq.size());
    if (nn > b_cap) return -3;
    int32_t* bn = nodes + s * b_cap;
    uint8_t* bnm = node_mask + s * b_cap;
    std::memset(bn, 0, b_cap * sizeof(int32_t));
    std::memset(bnm, 0, b_cap);
    std::copy(uniq.begin(), uniq.end(), bn);
    std::fill(bnm, bnm + nn, 1);
    weights[s] = static_cast<float>(r.weight);
  }
  return 0;
}

// SNAP edge-list parsing: skips '#'-comment lines, reads int pairs,
// canonicalizes (min, max), drops self loops. Errors: -1 on I/O error,
// -3 on a malformed line (a non-comment line must be exactly two
// non-negative ints — numpy's loadtxt raises on those; so do we).

namespace {

struct ParsedEdges {
  std::vector<int64_t> u, v;
};

// Parse the whole file ONCE into growable buffers (single I/O + parse
// pass; the old two-call count/fill protocol read and parsed twice,
// which matters at multi-GB edge lists).
int64_t parse_snap_file(const char* path, ParsedEdges* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return -1; }
  long size = std::ftell(f);
  if (size < 0) { std::fclose(f); return -1; }  // unseekable (FIFO etc.)
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  buf[size] = '\0';

  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= end) break;
    if (*p == '#') {  // comment line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    int64_t vals[2];
    int got = 0;
    while (got < 2 && p < end) {
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      if (p >= end || *p < '0' || *p > '9') break;
      int64_t x = 0;
      while (p < end && *p >= '0' && *p <= '9') x = x * 10 + (*p++ - '0');
      vals[got++] = x;
    }
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (got != 2 || (p < end && *p != '\n')) {
      return -3;
    }
    if (vals[0] == vals[1]) continue;
    out->u.push_back(std::min(vals[0], vals[1]));
    out->v.push_back(std::max(vals[0], vals[1]));
  }
  return static_cast<int64_t>(out->u.size());
}

}  // namespace

// Single-pass protocol: snap_parse_open parses once and returns the
// pair count (negative = error) with *handle owning the parsed pairs;
// snap_parse_take copies them into caller arrays (each of the returned
// length) and frees the handle; snap_parse_drop frees without copying.
int64_t snap_parse_open(const char* path, void** handle) {
  auto* parsed = new ParsedEdges();
  int64_t rc = parse_snap_file(path, parsed);
  if (rc < 0) {
    delete parsed;
    *handle = nullptr;
    return rc;
  }
  *handle = parsed;
  return rc;
}

void snap_parse_take(void* handle, int64_t* out_u, int64_t* out_v) {
  auto* parsed = static_cast<ParsedEdges*>(handle);
  std::memcpy(out_u, parsed->u.data(), parsed->u.size() * sizeof(int64_t));
  std::memcpy(out_v, parsed->v.data(), parsed->v.size() * sizeof(int64_t));
  delete parsed;
}

void snap_parse_drop(void* handle) {
  delete static_cast<ParsedEdges*>(handle);
}

// Legacy two-call protocol (cap == 0 -> count only; else fill and
// return the number written, -2 if the file holds more than cap).
// Kept for binding compatibility; prefer snap_parse_open/take.
int64_t snap_parse(const char* path, int64_t cap, int64_t* out_u,
                   int64_t* out_v) {
  ParsedEdges parsed;
  int64_t rc = parse_snap_file(path, &parsed);
  if (rc < 0) return rc;
  if (cap == 0) return rc;
  if (rc > cap) return -2;
  std::memcpy(out_u, parsed.u.data(), parsed.u.size() * sizeof(int64_t));
  std::memcpy(out_v, parsed.v.data(), parsed.v.size() * sizeof(int64_t));
  return rc;
}

// ---------------------------------------------------------------------------
// CHD perfect-hash construction (the native fast path behind
// mcmc_ammsb_tpu/ops/edgeset.py::_build_perfect_host; hash functions and
// greedy order match the numpy implementation bit for bit so both paths
// build identical tables).
// ---------------------------------------------------------------------------

static inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Build displacements for one seed. Returns 0 on success, -5 when this
// seed cannot place every bucket (caller retries with the next seed).
// m_slots and n_buckets must be powers of two.
int64_t chd_build(int64_t n_edges, const int32_t* u, const int32_t* v,
                  int64_t m_slots, int64_t n_buckets, uint32_t seed,
                  int32_t* out_d, int64_t* out_slot_of) {
  const uint32_t kC1 = 0x9E3779B1u, kC2 = 0x85EBCA77u, kC3 = 0x2545F491u;
  const uint32_t kC4 = 0xC2B2AE35u, kC5 = 0x27D4EB2Fu;
  const uint32_t bmask = static_cast<uint32_t>(n_buckets - 1);
  const uint32_t smask = static_cast<uint32_t>(m_slots - 1);

  std::vector<int64_t> bucket(n_edges);
  std::vector<uint32_t> h2(n_edges);
  std::vector<int64_t> counts(n_buckets + 1, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    uint32_t cu = static_cast<uint32_t>(u[i]);
    uint32_t cv = static_cast<uint32_t>(v[i]);
    bucket[i] = fmix32(cu * kC1 + cv * kC2 + seed) & bmask;
    h2[i] = fmix32(cu * kC4 + cv * kC5 + (seed ^ kC3)) & smask;
    ++counts[bucket[i] + 1];
  }
  for (int64_t b = 0; b < n_buckets; ++b) counts[b + 1] += counts[b];
  // stable counting sort of edge indices by bucket (== numpy stable
  // argsort), so within-bucket order matches the numpy path
  std::vector<int64_t> by_bucket(n_edges);
  {
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < n_edges; ++i)
      by_bucket[cursor[bucket[i]]++] = i;
  }
  // buckets ordered by size descending, stable (== np.argsort(-sizes))
  std::vector<int64_t> border(n_buckets);
  for (int64_t b = 0; b < n_buckets; ++b) border[b] = b;
  std::stable_sort(border.begin(), border.end(),
                   [&](int64_t a, int64_t b) {
                     return (counts[a + 1] - counts[a]) >
                            (counts[b + 1] - counts[b]);
                   });

  std::vector<bool> taken(m_slots, false);
  std::vector<uint32_t> hs;
  for (int64_t bi_i = 0; bi_i < n_buckets; ++bi_i) {
    const int64_t b = border[bi_i];
    const int64_t lo = counts[b], hi = counts[b + 1];
    const int64_t k = hi - lo;
    if (k == 0) continue;
    hs.assign(k, 0);
    for (int64_t i = 0; i < k; ++i) hs[i] = h2[by_bucket[lo + i]];
    // duplicate slot hashes inside one bucket can never be displaced
    // apart; fail this seed
    for (int64_t i = 0; i < k; ++i)
      for (int64_t j = i + 1; j < k; ++j)
        if (hs[i] == hs[j]) return -5;
    int64_t found = -1;
    for (int64_t d = 0; d < (1 << 16); ++d) {
      bool free_row = true;
      for (int64_t i = 0; i < k; ++i) {
        if (taken[(hs[i] + static_cast<uint32_t>(d)) & smask]) {
          free_row = false;
          break;
        }
      }
      if (free_row) { found = d; break; }
    }
    if (found < 0) return -5;
    out_d[b] = static_cast<int32_t>(found);
    for (int64_t i = 0; i < k; ++i) {
      uint32_t slot = (hs[i] + static_cast<uint32_t>(found)) & smask;
      taken[slot] = true;
      out_slot_of[by_bucket[lo + i]] = slot;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Cuckoo edge-set construction: ONE placement attempt at a given table
// size (the native fast path behind ops/edgeset.py::_build_cuckoo_host;
// 2 buckets x num_bins x 4 slots, random-walk displacement —
// mcmc/cuckoo.cc:98-189 semantics, same hash functions as the device
// lookup). The python per-key loop is O(E) interpreter iterations —
// minutes at 1M+ edges; the walk itself is inherently sequential, so
// it runs here. Any placement where each key occupies one of its two
// hash buckets is a valid table for the lookup; the growth-on-failure
// retry loop stays in python (matching the numpy fallback).
// Returns 0 on success (slots [2*num_bins*4] filled; empty slots are
// all-ones), -5 when the walk fails at this size (caller grows).
// ---------------------------------------------------------------------------

int cuckoo_try(int64_t n_edges, const uint64_t* keys, int64_t num_bins,
               uint64_t seed, uint64_t* slots) {
  const uint64_t kEmpty = ~0ULL;
  const uint64_t p1 = 15485807ULL, p2 = 920429591ULL;
  const uint64_t nb = static_cast<uint64_t>(num_bins);
  std::fill(slots, slots + 2 * num_bins * 4, kEmpty);
  Rng rng(seed);
  const int64_t max_disp = std::max<int64_t>(64, n_edges / 2 + 1);
  for (int64_t i = 0; i < n_edges; ++i) {
    uint64_t k = keys[i];
    bool placed = false;
    int bucket = 0;
    for (int64_t d = 0; d < max_disp; ++d) {
      const uint64_t h = (bucket == 0) ? (p1 * k) % nb : (k ^ p2) % nb;
      uint64_t* row =
          slots + (static_cast<int64_t>(bucket) * num_bins +
                   static_cast<int64_t>(h)) * 4;
      int e = -1;
      for (int s = 0; s < 4; ++s)
        if (row[s] == kEmpty) { e = s; break; }
      if (e >= 0) { row[e] = k; placed = true; break; }
      // evict a random occupant, retry it in the other bucket
      int j = static_cast<int>(rng() % 4);
      std::swap(k, row[j]);
      bucket = 1 - bucket;
    }
    if (!placed) return -5;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Exact theta-init bit stream (/root/reference/mcmc/learner.cc:149-153
// + random.h:71-79): std::mt19937 seeded with the literal 6342455113
// (implicitly truncated to the engine's 32-bit result_type, exactly as
// the reference's constructor call does) driving libstdc++'s
// std::gamma_distribution<float>(eta0, eta1), 'count' sequential draws
// filling the interleaved theta buffer ((k,0),(k,1) pairs). Compiled
// with g++/libstdc++ — the same library family the reference builds
// against — so the bit stream is the reference's own, closing the
// documented theta-init deviation when this library is loadable.
// ---------------------------------------------------------------------------

int ref_theta_init(double eta0, double eta1, uint64_t seed,
                   int64_t count, float* out) {
  std::mt19937 gen(static_cast<std::mt19937::result_type>(seed));
  std::gamma_distribution<float> dist(static_cast<float>(eta0),
                                      static_cast<float>(eta1));
  for (int64_t i = 0; i < count; ++i) out[i] = dist(gen);
  return 0;
}

}  // extern "C"
