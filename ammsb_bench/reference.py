"""The plain reference of a cell, in PyTorch and numpy. It imports
nothing of the program and takes nothing that the program made but the
state it judges.

* ``split`` works out the held-out split from the benchmark's edge list:
  the held-out edges, the training edges and the evaluation population
  (as many uniform non-edges as held-out edges), by the rule the program
  states (``generate_sets``: the first ceil-rounded share of the edges is
  held out; non-edges by rejection rounds of a seeded ``RandomState``).
* ``EdgeKeys`` answers edge membership from a sorted key list.
* ``follow`` runs S SGRLD steps of the a-MMSB on the rows they touch,
  from a given state and given random draws (the minibatches, the shared
  neighbor draws and the noise): the phi/pi update of every minibatch
  node, then the theta/beta update from the minibatch edges, one step
  after another. Rows written inside a window of T steps stay float32
  until the window ends and are then stored at the configuration's
  precision; the steps after the last whole window store theirs at once.
* ``likelihood`` and ``fold`` give the held-out perplexity.

``precision`` selects the arithmetic: ``"config"`` is float32 with pi
stored as the configuration states. The checks' controls take the
precision below the configuration's, joined by ``+``: ``"tf32"`` rounds
the inputs of the two matrix products to TF32, as TF32 tensor cores do;
``"bf16"`` stores pi rows in bfloat16; ``"fp8"`` stores them in float8
(e4m3) with a scale per row. ``"f64"`` computes in float64, the witness
that shows how far float32 rounding alone carries over many steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def _pack(u, v) -> np.ndarray:
    return (np.asarray(u, np.uint64) << np.uint64(32)) | np.asarray(
        v, np.uint64)


@dataclass
class Split:
    num_nodes: int
    total_edges: int
    train_u: np.ndarray
    train_v: np.ndarray
    held_u: np.ndarray          # the held-out edges
    held_v: np.ndarray
    pop_u: np.ndarray           # held-out edges, then as many non-edges
    pop_v: np.ndarray


def split(n: int, u: np.ndarray, v: np.ndarray, heldout_ratio: float,
          seed: int) -> Split:
    """The held-out split of the edge list (u, v), unique canonical
    edges in the run's order."""
    e = len(u)
    held_len = e - int(np.ceil((1.0 - heldout_ratio / 2.0) * e))
    existing = np.sort(_pack(u, v))
    taken = np.empty(0, np.uint64)
    rng = np.random.RandomState(seed)
    fakes = []
    count = 0
    rounds = 0
    while count < held_len:
        rounds += 1
        if rounds > 200:
            raise ValueError("too few non-edges found for the split")
        need = held_len - count
        ra = rng.randint(0, n, size=2 * need + 16)
        rb = rng.randint(0, n, size=2 * need + 16)
        keep = ra != rb
        keys = _pack(np.minimum(ra[keep], rb[keep]),
                     np.maximum(ra[keep], rb[keep]))
        first = np.zeros(len(keys), bool)
        first[np.unique(keys, return_index=True)[1]] = True
        pos = np.searchsorted(existing, keys)
        hit = existing[np.minimum(pos, len(existing) - 1)] == keys
        ok = first & ~hit & ~np.isin(keys, taken)
        got = keys[ok][:need]
        fakes.append(got)
        taken = np.concatenate([taken, got])
        count += len(got)
    fk = np.concatenate(fakes) if fakes else np.empty(0, np.uint64)
    fu = (fk >> np.uint64(32)).astype(np.int32)
    fv = (fk & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return Split(n, e, u[held_len:], v[held_len:], u[:held_len],
                 v[:held_len], np.concatenate([u[:held_len], fu]),
                 np.concatenate([v[:held_len], fv]))


class EdgeKeys:
    """Membership of undirected pairs in an edge list, on ``device``."""

    def __init__(self, n: int, u: np.ndarray, v: np.ndarray, device):
        self.n = n
        lo = np.minimum(u, v).astype(np.int64)
        hi = np.maximum(u, v).astype(np.int64)
        self.keys = torch.sort(torch.as_tensor(lo * n + hi,
                                               device=device)).values

    def has(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.long(), b.long()
        inside = (a >= 0) & (b >= 0) & (a < self.n) & (b < self.n)
        key = torch.minimum(a, b) * self.n + torch.maximum(a, b)
        if self.keys.numel() == 0:
            return torch.zeros_like(inside)
        pos = torch.searchsorted(self.keys, key).clamp(
            max=self.keys.numel() - 1)
        return inside & (self.keys[pos] == key)


@dataclass
class Model:
    """The configuration's numbers that the steps use."""

    N: int
    K: int
    T: int              # window length
    epsilon: float
    alpha: float
    a: float
    b: float
    c: float
    eta0: float
    eta1: float
    storage: str        # float32 | bfloat16


def model_of(config: dict, n_nodes: int) -> Model:
    m = config["model"]
    k = int(m["K"])
    return Model(N=n_nodes, K=k, T=int(m["window"]),
                 epsilon=float(m["epsilon"]),
                 alpha=float(m["alpha"]) or 1.0 / k, a=float(m["a"]),
                 b=float(m["b"]), c=float(m["c"]), eta0=float(m["eta0"]),
                 eta1=float(m["eta1"]), storage=m["pi_dtype"])


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest-even at TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0x0FFF)) & -0x2000
    return i.view(torch.float32)


def _store(x: torch.Tensor, storage: str) -> torch.Tensor:
    """Rows as they read back after a store in ``storage``."""
    if storage == "fp8":
        s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    if storage in ("bfloat16", "bf16"):
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def eps_t(md: Model, steps: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    """a (1 + t/b)^(-c) in ``dtype``."""
    t = steps.to(dtype)
    return md.a * (1.0 + t / md.b) ** (-md.c)


@dataclass
class Draws:
    """The random draws of S steps, [S, ...] each."""

    nodes: torch.Tensor       # [S, B] int
    node_mask: torch.Tensor   # [S, B] bool
    edges_u: torch.Tensor     # [S, E]
    edges_v: torch.Tensor
    edge_mask: torch.Tensor   # [S, E] bool
    weight: torch.Tensor      # [S] float32
    nbrs: torch.Tensor        # [S, n] shared neighbor draws
    phi_noise: torch.Tensor   # [S, B, K]
    beta_noise: torch.Tensor  # [S, K, 2]


@dataclass
class Rows:
    """A state restricted to the rows ``ids`` (sorted global ids)."""

    ids: torch.Tensor         # [M] int64
    pi: torch.Tensor          # [M, K] float32
    sums: torch.Tensor        # [M] float32
    theta: torch.Tensor       # [K, 2]
    beta: torch.Tensor        # [K]


def touched_rows(d: Draws, n_nodes: int) -> torch.Tensor:
    """Sorted ids of every row the steps read or write."""
    ids = torch.cat([torch.where(d.node_mask, d.nodes.long(), -1).ravel(),
                     d.nbrs.long().ravel()])
    ids = torch.unique(ids)
    return ids[(ids >= 0) & (ids < n_nodes)]


def local_rows(ids: torch.Tensor, x: torch.Tensor, mask=None) -> torch.Tensor:
    """Positions of the global ids ``x`` in ``ids``; lanes off ``mask``
    or missing from ``ids`` go to the spare row ``len(ids)``."""
    x = x.long()
    pos = torch.searchsorted(ids, x).clamp(max=ids.numel() - 1)
    found = ids[pos] == x
    if mask is not None:
        found &= mask
    return torch.where(found, pos, ids.numel())


def restrict(rows: Rows, ids: torch.Tensor) -> Rows:
    """``rows`` restricted to ``ids`` (sorted, each among ``rows.ids``)."""
    pos = torch.searchsorted(rows.ids, ids)
    return Rows(ids, rows.pi[pos], rows.sums[pos], rows.theta, rows.beta)


def follow(md: Model, start: Rows, d: Draws, step0: int, beta_step0: int,
           train: EdgeKeys, precision: str = "config",
           theta_grad_steps: int = None) -> Rows:
    """The state after the S steps of ``d`` from ``start`` (whose ids
    must hold every row the steps touch), steps numbered from ``step0``
    and the theta updates from ``beta_step0 + 1``. ``theta_grad_steps``
    plants a fault for the checks' controls: the theta updates of the
    steps after the first ``theta_grad_steps`` take no gradient."""
    dev = start.pi.device
    k = md.K
    s_len = d.nodes.shape[0]
    m = start.ids.numel()
    parts = precision.split("+")
    dt = torch.float64 if "f64" in parts else torch.float32
    # one spare row for the lanes off the masks, uniform and finite
    tab = torch.cat([start.pi.to(dt),
                     torch.full((1, k), 1.0 / k, device=dev, dtype=dt)])
    sums = torch.cat([start.sums.to(dt),
                      torch.ones(1, device=dev, dtype=dt)])
    theta, beta = start.theta.to(dt), start.beta.to(dt)
    node_l = local_rows(start.ids, d.nodes, d.node_mask)          # [S, B]
    nbr_l = local_rows(start.ids, d.nbrs)                         # [S, n]
    y_phi = train.has(d.nodes[:, :, None], d.nbrs[:, None, :])
    y_edge = train.has(d.edges_u, d.edges_v)
    lanes_u = torch.argmax((d.edges_u[:, :, None] == d.nodes[:, None, :])
                           .to(torch.int32), dim=-1)
    lanes_v = torch.argmax((d.edges_v[:, :, None] == d.nodes[:, None, :])
                           .to(torch.int32), dim=-1)
    self_nbr = d.nbrs[:, None, :] != d.nodes[:, :, None]      # [S, B, n]
    steps = torch.arange(s_len, device=dev)
    eps_phi = eps_t(md, step0 + steps, dt)
    eps_beta = eps_t(md, beta_step0 + 1 + steps, dt)
    eta = torch.tensor([md.eta0, md.eta1], device=dev, dtype=dt)
    eps = md.epsilon
    grad_steps = s_len if theta_grad_steps is None else theta_grad_steps
    mm = ((lambda x, y: to_tf32(x) @ to_tf32(y)) if "tf32" in parts
          else (lambda x, y: x @ y))
    storage = next((p for p in parts if p in ("bf16", "fp8")), md.storage)
    rounds = storage != "float32"
    windowed = (s_len // md.T) * md.T if md.T > 1 else 0
    written = []
    for t in range(s_len):
        nl, bl = node_l[t], nbr_l[t]
        pi_n, phis, pi_nb = tab[nl], sums[nl], tab[bl]
        y = y_phi[t]
        mf = self_nbr[t].to(dt)
        sgn = torch.where(y, 1.0, -1.0).to(dt)
        e = torch.where(y, eps, 1.0 - eps).to(dt)
        w = pi_n * (beta - eps)
        q = mm(w, pi_nb.T)
        inv_p = 1.0 / (sgn * q + e)
        a = sgn * inv_p * mf
        ce = torch.sum(e * inv_p * mf, dim=-1, keepdim=True)
        n_valid = torch.sum(mf, dim=-1, keepdim=True)
        contrib = mm(a, pi_nb)
        grads = ((beta - eps) * contrib + ce - n_valid) * (1.0 / phis[:, None])
        et = eps_phi[t]
        phi_k = pi_n * phis[:, None]
        noise = d.phi_noise[t].to(dt)
        phi_new = torch.abs(phi_k + et / 2.0 * (md.alpha - phi_k
                                                 + md.N / n_valid * grads)
                            + torch.sqrt(et * phi_k) * noise)
        phi_new = torch.clamp(phi_new, min=1e-24)
        row_sum = torch.sum(phi_new, dim=-1)
        rows = phi_new / row_sum[:, None]
        keep = d.node_mask[t]
        tab.index_copy_(0, nl, torch.where(keep[:, None], rows, tab[m]))
        sums.index_copy_(0, nl, torch.where(keep, row_sum, sums[m]))
        safe = torch.where(keep[:, None], rows, 1.0 / k)
        pu, pv = safe[lanes_u[t]], safe[lanes_v[t]]
        ye = y_edge[t]
        yf = ye.to(dt)
        theta_sum = theta[:, 0] + theta[:, 1]
        pp = pu * pv
        probs = torch.where(ye[:, None], beta, 1.0 - beta) * pp
        probs_sum = (torch.sum(probs, dim=-1)
                     + torch.where(ye, eps, 1.0 - eps).to(dt)
                     * (1.0 - torch.sum(pp, dim=-1)))
        f = probs / probs_sum[:, None]
        inv_ts = 1.0 / theta_sum
        em = d.edge_mask[t].to(dt)[:, None]
        g0 = torch.sum(f * ((1.0 - yf)[:, None] / theta[:, 0] - inv_ts) * em,
                       dim=0)
        g1 = torch.sum(f * (yf[:, None] / theta[:, 1] - inv_ts) * em, dim=0)
        eb = eps_beta[t]
        grad = torch.stack([g0, g1], -1) * float(t < grad_steps)
        theta = torch.abs(theta + eb / 2.0 * (eta - theta
                                              + d.weight[t].to(dt) * grad)
                          + torch.sqrt(eb * theta) * d.beta_noise[t].to(dt))
        theta = torch.clamp(theta, min=1e-24)
        beta = theta[:, 1] / (theta[:, 0] + theta[:, 1])
        if rounds:
            written.append(nl)
            if t + 1 >= windowed or (t + 1) % md.T == 0:
                idx = torch.cat(written)
                tab[idx] = _store(tab[idx], storage)
                written = []
    return Rows(start.ids, tab[:m], sums[:m], theta, beta)


def likelihood(md: Model, rows_u: torch.Tensor, rows_v: torch.Tensor,
               beta: torch.Tensor, y: torch.Tensor,
               block_bytes: int = 256 << 20) -> torch.Tensor:
    """Each pair's likelihood from its ends' pi rows [H, K] under
    ``beta``, floored at 1e-30, in blocks of ``block_bytes``."""
    block = max(1, block_bytes // (4 * md.K))
    out = []
    for a in range(0, rows_u.shape[0], block):
        pp = rows_u[a:a + block].float() * rows_v[a:a + block].float()
        link = torch.sum(pp * beta, dim=-1)
        non = (torch.sum(pp * (1.0 - beta), dim=-1)
               + (1.0 - torch.sum(pp, dim=-1)) * (1.0 - md.epsilon))
        out.append(torch.clamp(torch.where(y[a:a + block], link, non),
                               min=1e-30))
    return torch.cat(out)


def fold(avg: torch.Tensor, lik: torch.Tensor, count: int):
    """(the running per-pair averages after evaluation number ``count``,
    the perplexity they give)."""
    new = (avg.float() * (count - 1.0) + lik) / float(count)
    neg = -torch.mean(torch.log(torch.clamp(new, min=1e-30)).double())
    return new, float(math.exp(float(neg)))
