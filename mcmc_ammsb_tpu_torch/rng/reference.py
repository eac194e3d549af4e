"""The bit-exact reference RNG, plain PyTorch version (counterpart of
``mcmc_ammsb_tpu/rng/reference.py``).

The reference's device RNG family: a xorshift128+ stream per logical
GPU thread, seeded seed_i = base + i; uniform and randint with the
reference's conversions; N(0,1) by the 128-layer ziggurat with the
exponential-wedge tail (PARAM_R = 3.44428647676; the layer tables are
built by the JAX package's float64 numpy construction); Gamma by
Marsaglia-Tsang; and the neighbor sampler's per-lane open-addressing
hash (output in hash-slot order). Every sampler advances only the lanes
in ``mask``: rejection lanes keep drawing, accepted lanes freeze, so each
stream is consumed in the reference kernel's order.

Seeds keep the JAX package's [L, 4] layout (x_hi, x_lo, y_hi, y_lo) of
uint32 words, held in int64 tensors: torch has no uint32 arithmetic, so
every word stays in [0, 2^32) by a mask after each shift and add (no
product of two words is ever formed). The float expressions follow the
JAX package's term for term, one rounding per operation; only ``log``
and ``exp`` of the tail and of the gamma test may differ from XLA's by
one ulp.

This module is the plain version of ``rng/refblock.py``'s kernel: the
CPU runs it, and so does ``--no-ref-rng-block`` on any device. The
``*_lanes`` functions draw a whole chunk: ``mask`` [S, L] says which
lanes draw at each of the S steps, in step order.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

PARAM_R = 3.44428647676  # right-most ziggurat step (random.cl.inc PARAM_R)
_M32 = 0xFFFFFFFF
#: h1 = (r ^ 553105253) % capacity of the neighbor sampler's hash
NBR_H1_XOR = 553105253


def build_ziggurat_tables():
    """The 128-layer ziggurat for N(0,1) with the exponential-wedge tail:
    (ytab f32 [128], ktab uint32 [128], wtab f32 [128]) as numpy arrays,
    the JAX package's float64 construction (x_127 = R; common box area
    v = R f(R) + f(R)/R; x_{i-1} = finv(f(x_i) + v / x_i))."""
    f = lambda xx: np.exp(-0.5 * xx * xx)                     # noqa: E731
    finv = lambda yy: np.sqrt(-2.0 * np.log(yy))              # noqa: E731
    r = PARAM_R
    v = r * f(r) + f(r) / r
    x = np.zeros(128, np.float64)
    x[127] = r
    for i in range(127, 0, -1):
        y_next = f(x[i]) + v / x[i]
        x[i - 1] = 0.0 if y_next >= 1.0 else finv(y_next)
    top = f(x[1]) + v / x[1]
    if abs(top - 1.0) >= 5e-3:
        raise AssertionError(f"ziggurat construction does not close: {top}")
    ytab = f(x)
    ktab = np.zeros(128, np.uint32)
    wtab = np.zeros(128, np.float64)
    two24 = float(1 << 24)
    for i in range(127):
        ktab[i] = np.uint32(two24 * x[i] / x[i + 1])
        wtab[i] = x[i + 1] / two24
    wtab[127] = v / f(r) / two24
    ktab[127] = np.uint32(two24 * r * f(r) / v)
    return ytab.astype(np.float32), ktab, wtab.astype(np.float32)


@functools.cache
def _tables_np():
    return build_ziggurat_tables()


@functools.lru_cache(maxsize=8)
def ziggurat_tables(device) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(ytab f32, ktab int64, wtab f32) [128] tensors on ``device``."""
    y, k, w = _tables_np()
    dev = torch.device(device)
    return (torch.from_numpy(y).to(dev),
            torch.from_numpy(k.astype(np.int64)).to(dev),
            torch.from_numpy(w).to(dev))


# ---------------------------------------------------------------------------
# The 64-bit core on pairs of 32-bit words
# ---------------------------------------------------------------------------

def make_seeds(seed_pair, size: int, device="cpu") -> torch.Tensor:
    """[size, 4] int64 seeds: stream i starts at (x + i, y + i) modulo
    2^64 (mcmc/random.cc:31-44)."""
    x, y = (np.uint64(int(seed_pair[0]) & 0xFFFFFFFFFFFFFFFF),
            np.uint64(int(seed_pair[1]) & 0xFFFFFFFFFFFFFFFF))
    i = np.arange(size, dtype=np.uint64)
    sx, sy = x + i, y + i
    words = np.stack([sx >> np.uint64(32), sx & np.uint64(_M32),
                      sy >> np.uint64(32), sy & np.uint64(_M32)], axis=-1)
    return torch.from_numpy(words.astype(np.int64)).to(device)


def _shl(h, lo, k: int):
    return ((h << k) | (lo >> (32 - k))) & _M32, (lo << k) & _M32


def _shr(h, lo, k: int):
    return h >> k, ((lo >> k) | (h << (32 - k))) & _M32


def _xorshift128p(seeds: torch.Tensor):
    """One xorshift128+ step per lane (random.cl.inc:13-25): (res_hi,
    res_lo, new seeds)."""
    s1h, s1l, s0h, s0l = seeds.unbind(-1)       # state.x, state.y
    th, tl = _shl(s1h, s1l, 23)
    s1h, s1l = s1h ^ th, s1l ^ tl               # s1 ^= s1 << 23
    r17h, r17l = _shr(s1h, s1l, 17)
    r26h, r26l = _shr(s0h, s0l, 26)
    nyh = s1h ^ s0h ^ r17h ^ r26h
    nyl = s1l ^ s0l ^ r17l ^ r26l               # state.y
    lo = nyl + s0l                              # return state.y + s0
    hi = (nyh + s0h + (lo >> 32)) & _M32
    return hi, lo & _M32, torch.stack([s0h, s0l, nyh, nyl], dim=-1)


def rand_u64(seeds: torch.Tensor, mask=None):
    """One 64-bit word per lane as (hi, lo) int64 words; masked-off lanes
    do not advance. Returns (hi, lo, seeds')."""
    hi, lo, new = _xorshift128p(seeds)
    if mask is not None:
        new = torch.where(mask[..., None], new, seeds)
    return hi, lo, new


def uniform(seeds: torch.Tensor, mask=None):
    """(float)rand() / 2^64 in float32 (random.cl.inc:34-35): the two
    words converted to float32 and combined with three separately
    rounded float32 operations."""
    hi, lo, seeds = rand_u64(seeds, mask)
    u = (hi.float() * 4294967296.0 + lo.float()) * (2.0 ** -64)
    return u, seeds


def uniform_pos(seeds: torch.Tensor, mask=None):
    """Nonzero uniform: redraw while exactly 0 (random.cl.inc:310-317)."""
    if mask is None:
        mask = torch.ones(seeds.shape[:-1], dtype=torch.bool,
                          device=seeds.device)
    u, seeds = uniform(seeds, mask)
    while True:
        redraw = mask & (u == 0.0)
        if not bool(redraw.any()):
            return u, seeds
        u2, seeds = uniform(seeds, redraw)
        u = torch.where(redraw, u2, u)


def randint(seeds: torch.Tensor, lo: int, hi: int, mask=None):
    """rand() % (hi + 1 - lo) + lo (random.cl.inc:37-49): the u64
    remainder as ((hi % m) * (2^32 % m) + lo % m) % m, which fits int64
    for m < 2^31. Returns (int64 values, seeds')."""
    m = hi + 1 - lo
    if not 0 < m < 2 ** 31:
        raise ValueError(f"randint range {m} outside (0, 2^31)")
    wh, wl, seeds = rand_u64(seeds, mask)
    r = ((wh % m) * (2 ** 32 % m) + wl % m) % m
    return r + lo, seeds


# ---------------------------------------------------------------------------
# Gaussian (ziggurat) and Gamma (Marsaglia-Tsang), masked rejection loops
# ---------------------------------------------------------------------------

def randn(seeds: torch.Tensor, mask=None):
    """N(0,1) per masked lane (gsl_ran_gaussian_ziggurat,
    random.cl.inc:221-274): one u64 for the layer, sign and j; one
    uniform for the wedge or the tail, and one more for the tail.
    Masked-off lanes give 0 and do not advance. Returns (f32, seeds')."""
    ytab, ktab, wtab = ziggurat_tables(seeds.device)
    shape = seeds.shape[:-1]
    if mask is None:
        mask = torch.ones(shape, dtype=torch.bool, device=seeds.device)
    done = ~mask
    res = torch.zeros(shape, dtype=torch.float32, device=seeds.device)
    # a tensor on the lanes' device: CUDA divides by a CPU scalar as a
    # product with its reciprocal, which is not the reference's division
    r = torch.tensor(PARAM_R, dtype=torch.float32, device=seeds.device)
    while bool((~done).any()):
        active = ~done
        _, kl, seeds = rand_u64(seeds, active)
        i_raw = kl & 0xFF
        sign = torch.where((i_raw & 0x80) > 0, 1.0, -1.0)
        i = i_raw & 0x7F
        j = (kl >> 8) & 0xFFFFFF
        x = j.float() * wtab[i]
        acc1 = j < ktab[i]
        need = active & ~acc1
        tail = need & (i == 127)
        u1, seeds = uniform(seeds, need)
        u2, seeds = uniform(seeds, tail)
        ip1 = torch.clamp(i + 1, max=127)
        y_wedge = ytab[ip1] + (ytab[i] - ytab[ip1]) * u1
        x_tail = r - torch.log(1.0 - u1) / r
        y_tail = torch.exp(-r * (x_tail - 0.5 * r)) * u2
        x = torch.where(tail, x_tail, x)
        y = torch.where(tail, y_tail, y_wedge)
        acc2 = need & (y < torch.exp(-0.5 * x * x))
        newly = (active & acc1) | acc2
        res = torch.where(newly, sign * x, res)
        done = done | newly
    return res, seeds


def rand_gamma(seeds: torch.Tensor, a: float, b: float, mask=None):
    """Gamma(shape=a, scale=b) per masked lane by Marsaglia-Tsang
    (random.cl.inc:353-391), with the a < 1 boosting pre-pass. Returns
    (f32, seeds')."""
    shape = seeds.shape[:-1]
    if mask is None:
        mask = torch.ones(shape, dtype=torch.bool, device=seeds.device)
    f_boost = torch.ones(shape, dtype=torch.float32, device=seeds.device)
    aa = float(a)
    while aa < 1.0:
        u, seeds = uniform_pos(seeds, mask)
        # a tensor exponent: torch turns some scalar exponents (2, 0.5,
        # ...) into products or square roots, which powf does not do
        f_boost = f_boost * torch.pow(
            u, torch.full_like(u, np.float32(1.0 / aa).item()))
        aa += 1.0
    d = np.float32(aa - 1.0 / 3.0).item()
    c = np.float32((1.0 / 3.0) / np.sqrt(aa - 1.0 / 3.0)).item()
    done = ~mask
    res = torch.zeros(shape, dtype=torch.float32, device=seeds.device)
    while bool((~done).any()):
        active = ~done
        x, seeds = randn(seeds, active)
        v = 1.0 + c * x
        ok_v = active & (v > 0)          # v <= 0: redraw x next round
        v3 = v * v * v
        u, seeds = uniform_pos(seeds, ok_v)
        sq = x * x
        accept = ok_v & ((u < 1.0 - 0.0331 * sq * sq)
                         | (torch.log(u)
                            < 0.5 * sq + d * (1.0 - v3 + torch.log(v3))))
        res = torch.where(accept, d * v3, res)
        done = done | accept
    return f_boost * np.float32(b).item() * res, seeds


# ---------------------------------------------------------------------------
# The reference neighbor sampler (mcmc/sample.cc:13-78)
# ---------------------------------------------------------------------------

def sample_neighbors_reference(seeds: torch.Tensor, nodes: torch.Tensor,
                               num_nodes: int, num: int, mask=None):
    """``num`` distinct neighbors != node per masked lane, with the
    reference kernel's draw discipline: each word is one randint; a draw
    equal to the node, or found by the open-addressing probe (capacity
    2*num, h1 = (r ^ 553105253) % capacity, stride 1 + 2*capacity) is
    redrawn, any other is inserted, until ``num`` are in. The output is
    the table's entries in slot order; masked-off lanes give ``num_nodes``
    (the sentinel) and do not advance. Returns (int64 [L, num], seeds')."""
    if num >= num_nodes:
        raise ValueError(
            f"cannot draw {num} distinct neighbors != node from a "
            f"{num_nodes}-node graph (the reference kernel would spin "
            "forever here too)")
    lanes = nodes.shape[0]
    dev = seeds.device
    cap = 2 * num
    stride = 1 + (cap << 1)
    if mask is None:
        mask = torch.ones(lanes, dtype=torch.bool, device=dev)
    table = torch.full((lanes, cap), num_nodes, dtype=torch.int64, device=dev)
    count = torch.where(mask, 0, num)
    probes = torch.arange(cap, device=dev) * stride
    nodes = nodes.long()
    while bool((count < num).any()):
        active = count < num
        r, seeds = randint(seeds, 0, num_nodes - 1, active)
        offs = ((r ^ NBR_H1_XOR) % cap)[:, None] + probes[None, :]
        offs = offs % cap                                   # [L, cap]
        vals = torch.gather(table, 1, offs)
        stop = (vals == r[:, None]) | (vals == num_nodes)
        first = torch.argmax(stop.to(torch.int8), dim=1, keepdim=True)
        slot = torch.gather(offs, 1, first)[:, 0]
        insert = (active & (r != nodes)
                  & (torch.gather(vals, 1, first)[:, 0] == num_nodes))
        row = torch.arange(lanes, device=dev)
        table[row[insert], slot[insert]] = r[insert]
        count = count + insert.long()
    order = torch.argsort((table == num_nodes).to(torch.int8), dim=1,
                          stable=True)
    return torch.gather(table, 1, order)[:, :num], seeds


# ---------------------------------------------------------------------------
# A chunk of S steps per stream family: the plain version of the kernel
# ---------------------------------------------------------------------------

def randn_lanes(seeds: torch.Tensor, k: int, mask: torch.Tensor):
    """For each step s of ``mask`` [S, L]: ``k`` sequential N(0,1) draws
    per masked lane, in order (phi.cc:114-121: a node lane's K draws; a
    community's r0, r1). Returns (f32 [S, L, k], zeros where masked off;
    seeds')."""
    out = []
    for s in range(mask.shape[0]):
        cols = []
        for _ in range(k):
            x, seeds = randn(seeds, mask[s])
            cols.append(x)
        out.append(torch.stack(cols, dim=-1))
    return torch.stack(out), seeds


def neighbors_lanes(seeds: torch.Tensor, nodes: torch.Tensor,
                    mask: torch.Tensor, num_nodes: int, num: int):
    """``sample_neighbors_reference`` for each step of ``nodes`` and
    ``mask`` [S, L] in turn: (int64 [S, L, num], seeds')."""
    out = []
    for s in range(mask.shape[0]):
        nb, seeds = sample_neighbors_reference(seeds, nodes[s], num_nodes,
                                               num, mask[s])
        out.append(nb)
    return torch.stack(out), seeds


def gamma_lanes(seeds: torch.Tensor, a: float, b: float,
                mask: torch.Tensor):
    """One Gamma(a, b) draw per masked lane at each step of ``mask``
    [S, L]: (f32 [S, L], zeros where masked off; seeds')."""
    out = []
    for s in range(mask.shape[0]):
        g, seeds = rand_gamma(seeds, a, b, mask[s])
        out.append(g)
    return torch.stack(out), seeds
