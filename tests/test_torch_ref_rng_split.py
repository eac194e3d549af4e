"""The split design of csrc/ref_rng_kernel.cu, held on the CPU against the
plain per-lane loops of mcmc_ammsb_tpu_torch/rng/reference.py.

* ``refblock.jump(seeds, d)`` equals ``d`` sequential xorshift128+ steps,
  and the kernel's jump tables apply the same matrices;
* ``split_randn`` is the kernel's ``randn_lanes`` written out in plain
  torch: threads own segments of ``words`` words of a stream, each thread
  starting at an exact jump; every position is decoded as the start of a
  ziggurat round; each thread walks its segment from each of the three
  entry offsets (a 2- or 3-word round may straddle a segment or a round),
  visiting only the rounds of more than one word; an exclusive scan of
  those maps gives each thread its entry and its first draw index; the
  last round's exit gives the new seeds. It is
  bit-equal to ``reference.randn_lanes`` at tiny layouts (rounds of 4
  words, segments of 2), at the kernel's two layouts, with off steps and
  off lanes, and with a tail round (layer 127, three words) on a segment
  and on a round boundary;
* ``split_neighbors`` is the kernel's ``neighbors_lanes``: a warp takes
  32 candidates at a time; a candidate is taken iff it is not the node
  and no earlier candidate of its step had its value; the taken values
  are inserted in order into the 2*num-slot table (the first free slot
  at or after the hash, cyclically) and written in slot order. It is
  bit-equal to ``reference.neighbors_lanes`` at N = num + 1, 40 and
  317,080 and num = 1 and 32.

A test marked ``cuda`` holds the kernel itself against the plain version
on the card at the same stress shapes.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mcmc_ammsb_tpu_torch.rng import reference as ref
from mcmc_ammsb_tpu_torch.rng import refblock

M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# Jump-ahead
# ---------------------------------------------------------------------------

def _seed_words(x: int, y: int) -> torch.Tensor:
    return torch.tensor([[x >> 32, x & 0xFFFFFFFF, y >> 32, y & 0xFFFFFFFF]])


def _steps(x: int, y: int, d: int):
    """``d`` xorshift128+ steps on Python integers (random.cl.inc:13-25)."""
    for _ in range(d):
        s1, s0 = x, y
        x = s0
        s1 ^= (s1 << 23) & M64
        y = s1 ^ s0 ^ (s1 >> 17) ^ (s0 >> 26)
    return x, y


STATE = st.integers(0, M64)


@pytest.mark.parametrize("d", [0, 1, 2, 63, 64, 4097])
@settings(max_examples=20, deadline=None)
@given(x=STATE, y=STATE)
def test_jump_equals_sequential_steps(d, x, y):
    assert torch.equal(refblock.jump(_seed_words(x, y), d),
                       _seed_words(*_steps(x, y, d)))


@settings(max_examples=3, deadline=None)
@given(x=STATE, y=STATE)
def test_jump_a_million_words(x, y):
    assert torch.equal(refblock.jump(_seed_words(x, y), 10 ** 6),
                       _seed_words(*_steps(x, y, 10 ** 6)))


def _apply_table(tab: np.ndarray, x: int, y: int):
    """The kernel's jump: 32 lookups of the nibbles of (x, y)."""
    ox = oy = 0
    for n in range(16):
        e = tab[n, (x >> 4 * n) & 15]
        ox, oy = ox ^ int(e[0]), oy ^ int(e[1])
    for n in range(16):
        e = tab[16 + n, (y >> 4 * n) & 15]
        ox, oy = ox ^ int(e[0]), oy ^ int(e[1])
    return ox, oy


@pytest.mark.parametrize("layout", [refblock.WARP_LAYOUT,
                                    refblock.BLOCK_LAYOUT])
def test_jump_tables_apply_the_jumps(layout):
    tabs = refblock.jump_tables(layout, "cpu").numpy().view(np.uint64)
    dists = refblock.jump_distances(layout)
    assert tabs.shape == (len(dists), 32, 16, 2)
    r = np.random.default_rng(0)
    for tab, d in zip(tabs, dists):
        for _ in range(4):
            x, y = (int(v) for v in r.integers(0, 2 ** 63, 2, np.int64))
            x, y = x * 2 + 1, y * 2          # every bit position in play
            want = refblock.jump(_seed_words(x, y), d)
            assert torch.equal(_seed_words(*_apply_table(tab, x, y)), want)


@pytest.mark.parametrize("layout", [refblock.WARP_LAYOUT,
                                    refblock.BLOCK_LAYOUT])
def test_jump_distances_make_every_start(layout):
    """Every thread's start, t * words, is the sum of the distances of
    the bits of t (as the kernel's segment_start takes them), and the last
    distance leads from a segment's end to its next round's."""
    threads, words = layout
    dists = refblock.jump_distances(layout)
    assert len(dists) == threads.bit_length()
    for t in range(threads):
        assert sum(d for b, d in enumerate(dists[:-1]) if t >> b & 1) == \
            t * words
    assert dists[-1] == threads * words - words


def test_randn_layout_per_shape():
    """The phi noise (64 streams x 200 steps x 256) and one long stream
    take a block per stream, the theta noise (256 x 200 x 2) a warp."""
    assert refblock.randn_layout(200, 64, 256) == refblock.BLOCK_LAYOUT
    assert refblock.randn_layout(2000, 1, 256) == refblock.BLOCK_LAYOUT
    assert refblock.randn_layout(200, 256, 2) == refblock.WARP_LAYOUT
    assert refblock.randn_layout(200, 1024, 256) == refblock.WARP_LAYOUT


# ---------------------------------------------------------------------------
# The split ziggurat decode
# ---------------------------------------------------------------------------

def _gen(states: torch.Tensor, count: int, keep: int):
    """``count`` words of each stream of ``states``: (hi, lo) [T, count]
    and the states after ``keep`` words."""
    hi, lo, cur, kept = [], [], states, None
    for i in range(count):
        h, l_, cur = ref.rand_u64(cur)
        hi.append(h)
        lo.append(l_)
        if i == keep - 1:
            kept = cur
    return torch.stack(hi, 1), torch.stack(lo, 1), kept


def _starts(seed, threads: int, words: int):
    """Each thread's start: the stream ``words`` * t words on."""
    out = [seed]
    for _ in range(threads - 1):
        out.append(refblock.jump(out[-1], words))
    return torch.cat(out)


def _decode(hi, lo, words: int):
    """The ziggurat round that starts at each of a segment's ``words``
    positions, with reference.randn's float operations: (accept,
    value, words consumed) [T, words]."""
    ytab, ktab, wtab = ref.ziggurat_tables("cpu")
    u = (hi.float() * 4294967296.0 + lo.float()) * (2.0 ** -64)
    kl = lo[:, :words]
    u1, u2 = u[:, 1:words + 1], u[:, 2:words + 2]
    i_raw = kl & 0xFF
    sign = torch.where((i_raw & 0x80) > 0, 1.0, -1.0)
    i = i_raw & 0x7F
    j = (kl >> 8) & 0xFFFFFF
    x = j.float() * wtab[i]
    acc1 = j < ktab[i]
    tail = ~acc1 & (i == 127)
    r = torch.tensor(ref.PARAM_R, dtype=torch.float32)
    ip1 = torch.clamp(i + 1, max=127)
    y_wedge = ytab[ip1] + (ytab[i] - ytab[ip1]) * u1
    x_tail = r - torch.log(1.0 - u1) / r
    y_tail = torch.exp(-r * (x_tail - 0.5 * r)) * u2
    x = torch.where(tail, x_tail, x)
    y = torch.where(tail, y_tail, y_wedge)
    acc = acc1 | (y < torch.exp(-0.5 * x * x))
    cons = torch.where(acc1, 1, torch.where(tail, 3, 2))
    return acc, sign * x, cons


def _round_starts(cons, words: int, f: int):
    """The rounds of a segment entered at offset f, the kernel's way (only
    the rounds of 2 or 3 words are visited; every other position starts a
    1-word round): (their start positions, the next segment's entry)."""
    skip, p = set(), f
    for q in range(f, words):
        if q >= p and cons[q] > 1:
            skip.update(range(q + 1, q + cons[q]))
            p = q + cons[q]
    return [x for x in range(f, words) if x not in skip], max(p - words, 0)


def _segment_map(acc, cons, words: int):
    """A thread's map: entry offset f in {0, 1, 2} -> (exit offset,
    accepted rounds)."""
    out = []
    for f in range(3):
        starts, exit_ = _round_starts(cons, words, f)
        out.append((exit_, sum(acc[x] for x in starts)))
    return out


def _compose(a, b):
    """Map ``a`` then map ``b``."""
    return [(b[e][0], c + b[e][1]) for e, c in a]


def split_randn(seeds, k: int, mask, threads: int, words: int):
    """csrc/ref_rng_kernel.cu's randn_lanes in plain torch, one stream
    at a time: (f32 [S, L, k], seeds')."""
    s_len, lanes = mask.shape
    out = torch.zeros(s_len, lanes, k)
    new = seeds.clone()
    width = threads * words
    for lane in range(lanes):
        steps = torch.nonzero(mask[:, lane]).flatten().tolist()
        total = len(steps) * k
        state = _starts(seeds[lane:lane + 1], threads, words)
        drawn, entry = 0, 0
        while drawn < total:
            hi, lo, post = _gen(state, words + 2, words)
            acc, val, cons = (a.tolist() for a in _decode(hi, lo, words))
            maps = [_segment_map(acc[t], cons[t], words)
                    for t in range(threads)]
            prefix = [(e, 0) for e in range(3)]              # identity
            for t in range(threads):
                d = drawn + prefix[entry][1]
                starts, _ = _round_starts(cons[t], words, prefix[entry][0])
                for p in (x for x in starts if acc[t][x]):
                    if d < total:
                        step, col = divmod(d, k)
                        out[steps[step], lane, col] = val[t][p]
                    if d == total - 1:
                        new[lane] = refblock.jump(state[t:t + 1],
                                                  p + cons[t][p])[0]
                    d += 1
                prefix = _compose(prefix, maps[t])
            entry, drawn = prefix[entry][0], drawn + prefix[entry][1]
            if drawn < total:
                state = refblock.jump(post, width - words)
    return out, new


def _lane_mask(s_len, lanes, seed, off_lanes=()):
    mask = torch.as_tensor(np.random.default_rng(seed).random(
        (s_len, lanes)) < 0.7)
    mask[:, list(off_lanes)] = False
    return mask


@pytest.mark.parametrize("layout", [(2, 2), (4, 4), (2, 5), (8, 3)])
@pytest.mark.parametrize("k", [1, 2, 7, 256])
def test_split_randn_tiny_layouts(layout, k):
    """Rounds of 4-24 words: 2- and 3-word rounds straddle segments and
    rounds; off steps and an off lane."""
    s_len = max(2, 600 // k)
    mask = _lane_mask(s_len, 3, k, off_lanes=[1])
    seeds = ref.make_seeds((k, 77), 3)
    got = split_randn(seeds, k, mask, *layout)
    want = ref.randn_lanes(seeds, k, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("layout", [refblock.WARP_LAYOUT,
                                    refblock.BLOCK_LAYOUT])
def test_split_randn_kernel_layouts(layout):
    """The kernel's two layouts: the theta noise's k = 2 and the phi
    noise's k = 256, a stream that ends inside its first round and one
    that takes several rounds of the warp layout."""
    for k, s_len in [(2, 40), (256, 24)]:
        mask = _lane_mask(s_len, 2, s_len)
        seeds = ref.make_seeds((5, k), 2)
        got = split_randn(seeds, k, mask, *layout)
        want = ref.randn_lanes(seeds, k, mask)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _chains(seeds, words_ahead: int):
    """The positions at which each stream's chained rounds start, and
    whether each of them is a tail round (layer 127 past its ktab test):
    consumption depends on integers alone."""
    _, ktab, _ = ref.ziggurat_tables("cpu")
    _, lo, _ = _gen(seeds, words_ahead, words_ahead)
    i = lo & 0x7F
    j = (lo >> 8) & 0xFFFFFF
    acc1 = j < ktab[i]
    cons = torch.where(acc1, 1, torch.where(i == 127, 3, 2)).tolist()
    tail = (~acc1 & (i == 127)).tolist()
    out = []
    for c, t in zip(cons, tail):
        p, starts = 0, []
        while p < words_ahead - 2:
            starts.append((p, t[p]))
            p += c[p]
        out.append(starts)
    return out


@pytest.mark.parametrize("residue,what", [(3, "round"), (1, "segment")])
def test_split_randn_tail_round_on_a_boundary(residue, what):
    """A seed search for a stream whose tail round (three words) starts
    on the last word of a 4-word round (it straddles the round and the
    segment) or of its first 2-word segment (it straddles the segment
    only), within the draws of the test; the split model at (2, 2)
    against the plain loop on that stream."""
    k, s_len, ahead = 64, 4, 300
    seeds = ref.make_seeds((2024, 7), 2048)
    found = None
    for lane, starts in enumerate(_chains(seeds, ahead)):
        hits = [p for p, t in starts[:k * s_len] if t and p % 4 == residue]
        if hits:
            found = lane
            break
    assert found is not None, f"no tail round on a {what} boundary"
    one = seeds[found:found + 1]
    mask = torch.ones(s_len, 1, dtype=torch.bool)
    got = split_randn(one, k, mask, 2, 2)
    want = ref.randn_lanes(one, k, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The neighbor draws as a first-occurrence test
# ---------------------------------------------------------------------------

def split_neighbors(seeds, nodes, mask, num_nodes: int, num: int,
                    words: int = refblock.WARP_LAYOUT[1]):
    """csrc/ref_rng_kernel.cu's neighbors_lanes in plain torch, one
    stream at a time: (int64 [S, L, num], seeds')."""
    s_len, lanes = mask.shape
    out = torch.full((s_len, lanes, num), num_nodes, dtype=torch.int64)
    new = seeds.clone()
    width = 32 * words
    cap = 2 * num
    m = num_nodes
    for lane in range(lanes):
        state = _starts(seeds[lane:lane + 1], 32, words)

        def fill(state):
            hi, lo, post = _gen(state, words, words)
            r = ((hi % m) * (2 ** 32 % m) + lo % m) % m         # [32, words]
            return r.flatten().tolist(), post

        buf, post = fill(state)
        p = q = 0
        for s in range(s_len):
            if not mask[s, lane]:
                continue
            node = int(nodes[s, lane])
            taken = []
            while len(taken) < num:
                if p == q + width:
                    state = refblock.jump(post, width - words)
                    buf, post = fill(state)
                    q += width
                avail = min(32, q + width - p)
                cand = buf[p - q:p - q + avail]
                used = avail
                for i, r in enumerate(cand):
                    if r != node and r not in cand[:i] and r not in taken:
                        taken.append(r)
                        if len(taken) == num:
                            used = i + 1
                            break
                p += used
            occ = [False] * cap
            slots = []
            for r in taken:
                h = (r ^ ref.NBR_H1_XOR) % cap
                while occ[h]:
                    h = (h + 1) % cap
                occ[h] = True
                slots.append(h)
            order = sorted(range(num), key=slots.__getitem__)
            out[s, lane] = torch.tensor([taken[c] for c in order])
        owner = min((p - q) // words, 31)
        new[lane] = refblock.jump(state[owner:owner + 1],
                                  p - q - owner * words)[0]
    return out, new


@pytest.mark.parametrize("num", [1, 32])
@pytest.mark.parametrize("num_nodes", ["num+1", 40, 317_080])
def test_split_neighbors_first_occurrence(num, num_nodes):
    n = num + 1 if num_nodes == "num+1" else num_nodes
    s_len, lanes = 12, 3
    r = np.random.default_rng(n + num)
    nodes = torch.as_tensor(r.integers(0, n, (s_len, lanes), dtype=np.int32))
    mask = _lane_mask(s_len, lanes, n, off_lanes=[2])
    seeds = ref.make_seeds((n, num), lanes)
    got = split_neighbors(seeds, nodes, mask, n, num)
    want = ref.neighbors_lanes(seeds, nodes, mask, n, num)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# On the card: the kernel at the stress shapes
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_stress_shapes_on_gpu():
    """On a GPU: randn_lanes in both layouts with whole lanes off, on one
    long stream, over more steps than one launch takes, and
    neighbors_lanes at N = 40 and N = 33 (num = 32),
    against the plain version on the same CUDA seeds, values and seeds
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = "cuda"
    seeds = ref.make_seeds((3, 9), 64, dev)
    for s_len, lanes, k in [(12, 64, 256), (200, 256, 2), (40, 1, 256),
                            (refblock.MAX_LAUNCH_STEPS + 4, 1, 2)]:
        mask = _lane_mask(s_len, lanes, k, off_lanes=[0, lanes // 2]
                          if lanes > 1 else []).to(dev)
        s = ref.make_seeds((s_len, k), lanes, dev)
        got = refblock.randn_lanes(s, k, mask)
        want = ref.randn_lanes(s, k, mask)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for n in (40, 33):
        nodes = torch.as_tensor(np.random.default_rng(n).integers(
            0, n, (20, 64), dtype=np.int32)).to(dev)
        mask = _lane_mask(20, 64, n, off_lanes=[5]).to(dev)
        got = refblock.neighbors_lanes(seeds, nodes, mask, n, 32)
        want = ref.neighbors_lanes(seeds, nodes, mask, n, 32)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
