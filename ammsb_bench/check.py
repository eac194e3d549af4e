"""How ``correct`` is decided: the reference follows the timed call.

After the window has closed, the run makes the timed call once more on
the same learner, with ``Capture`` on. ``Capture`` wraps the program's
``learner.run_hoisted``, through which every chunk of steps runs, and
the window engine's launch (``ops.window.window_apply_cuda``, on the
CPU ``window_apply_torch``), through which every window of T steps
runs. On a chunk's entry it keeps the chunk's random draws (minibatches,
shared neighbor draws, noise) and the state of the rows they touch, on
its exit the same rows again; around each window, and around the steps
after the last window, the state of the rows those steps touch. The
membership labels and lane maps that the program hoisted beside the
draws are not taken: the reference works them out itself.

``Judge`` then follows every chunk from the program's state at its start
and every window from the program's state at the window's start
(``reference.follow``), and compares the rows, theta and the call's last
held-out evaluation with the program's. The chunk's numbers carry the
steps' rounding through a whole chunk; the window's numbers hold each
window, the last as well as the first, to its own rounding. It also
checks the draws themselves, which the reference takes as given
(``draw_faults``): the sampler's rules per step, and the streams'
statistics over the call (noise standard normal and independent from
step to step, window to window and chunk to chunk; the neighbor draws
uniform over the nodes).

Each number has a limit in ``limits/<workload>.json``; ``readings``
gives the numbers, ``verdict`` holds them against the limits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ammsb_bench import reference as ref
from ammsb_bench.counts import edge_lanes

#: the numbers compared, in the order they are printed
NAMES = ("early_pi_gap", "early_sum_gap", "pi_gap", "theta_gap",
         "window_pi_gap", "window_theta_gap", "ppx_gap", "ppx_edge_gap",
         "draw_faults", "steps_missing")

#: the window engine's launches that ``Capture`` taps
WINDOW_ENTRIES = ("window_apply_cuda", "window_apply_torch")


@dataclasses.dataclass
class Span:
    """Steps that the program ran in one piece, with the state of the
    rows they touch before and after."""

    draws: ref.Draws
    start: ref.Rows
    end: ref.Rows
    step0: int
    beta_step0: int
    offset: int               # its first step within its chunk


@dataclasses.dataclass
class Chunk(Span):
    """One chunk of the timed call as the program ran it, and its
    windows and the steps after its last window (``spans``)."""

    ppx_avg: torch.Tensor     # the running averages at the chunk's start
    ppx_count: int
    spans: List[Span]


def _rows(s, ids: torch.Tensor) -> ref.Rows:
    """The state ``s`` restricted to the rows ``ids``, copied."""
    return ref.Rows(ids, s.pi[ids].float(), s.phi_sum[ids].float(),
                    s.theta.float().clone(), s.beta.float().clone())


def _steps(d: ref.Draws, a: int, b: int) -> ref.Draws:
    return ref.Draws(*(getattr(d, f.name)[a:b]
                       for f in dataclasses.fields(d)))


class Capture:
    """While entered, records every chunk that the program's
    ``learner.run_hoisted`` runs, and its windows (see the module
    docstring)."""

    def __init__(self, learner_module, window_module, n_nodes: int):
        self.mod, self.win_mod = learner_module, window_module
        self.n_nodes = n_nodes
        self.chunks: List[Chunk] = []
        self._open = None

    def __enter__(self):
        self.real = self.mod.run_hoisted
        self.real_windows = {name: getattr(self.win_mod, name)
                             for name in WINDOW_ENTRIES}
        n_nodes = self.n_nodes

        def run_hoisted(cfg, state, xs):
            batch, nbrs, _y_phi, phi_noise, beta_noise = xs[:5]
            draws = ref.Draws(
                batch.nodes.clone(), batch.node_mask.clone(),
                batch.edges_u.clone(), batch.edges_v.clone(),
                batch.edge_mask.clone(), batch.weight.float().clone(),
                nbrs[:, 0, :].clone(), phi_noise.float().clone(),
                beta_noise.float().clone())
            ids = ref.touched_rows(draws, n_nodes)
            s_len = draws.nodes.shape[0]
            t_win = cfg.window if cfg.window > 1 else s_len + 1
            tail0 = s_len - s_len % t_win
            tail = _steps(draws, tail0, s_len)
            chunk = Chunk(draws, _rows(state, ids), None,
                          int(state.step_count), int(state.beta_count), 0,
                          state.ppx_per_edge.float().clone(),
                          int(state.ppx_count), [])
            self._open = {"chunk": chunk, "t_win": t_win, "tail0": tail0,
                          "tail_ids": ref.touched_rows(tail, n_nodes),
                          "tail_start": None}
            if tail0 == 0:
                self._open["tail_start"] = (_rows(state, self._open[
                    "tail_ids"]), chunk.step0, chunk.beta_step0)
            try:
                out = self.real(cfg, state, xs)
            finally:
                opened, self._open = self._open, None
            chunk.end = _rows(out, ids)
            # a tail whose start no window handed over is left out, and
            # counts as steps missing
            if tail0 < s_len and opened["tail_start"] is not None:
                start, step0, beta0 = opened["tail_start"]
                chunk.spans.append(Span(
                    tail, start, ref.restrict(chunk.end, start.ids), step0,
                    beta0, tail0))
            self.chunks.append(chunk)
            return out

        def tapped(real):
            def apply(cfg, s, xs_t, *args, **kw):
                o = self._open
                if o is None:
                    return real(cfg, s, xs_t, *args, **kw)
                c = o["chunk"]
                offset = len(c.spans) * o["t_win"]
                d = _steps(c.draws, offset, offset + o["t_win"])
                ids = ref.touched_rows(d, n_nodes)
                step0, beta0 = int(s.step_count), int(s.beta_count)
                start = _rows(s, ids)
                out = real(cfg, s, xs_t, *args, **kw)
                c.spans.append(Span(d, start, _rows(out, ids), step0, beta0,
                                    offset))
                if offset + o["t_win"] == o["tail0"]:
                    o["tail_start"] = (_rows(out, o["tail_ids"]),
                                       int(out.step_count),
                                       int(out.beta_count))
                return out
            # the launch counters that the program keeps on the function
            apply.__dict__ = real.__dict__
            return apply

        self.mod.run_hoisted = run_hoisted
        for name, real in self.real_windows.items():
            setattr(self.win_mod, name, tapped(real))
        return self

    def __exit__(self, *exc):
        self.mod.run_hoisted = self.real
        for name, real in self.real_windows.items():
            setattr(self.win_mod, name, real)
        return False


@dataclasses.dataclass
class Evaluation:
    """The call's last held-out evaluation as the program reported it,
    and the rows of the population pairs in the state it read."""

    ppx: float
    avg: torch.Tensor         # the running averages after it
    count: int                # its number
    rows_u: torch.Tensor      # [H, K] pi rows of the pairs' ends
    rows_v: torch.Tensor
    beta: torch.Tensor


class Judge:
    """The reference's side of a cell: its split, its membership sets,
    and the model's numbers, worked out from the benchmark's own inputs
    (the graph and the run's edge order, the configuration)."""

    def __init__(self, config: dict, n: int, u: np.ndarray, v: np.ndarray,
                 split_seed: int, device):
        self.md = ref.model_of(config, n)
        m = config["model"]
        # the reference's products are float32: never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        self.split = ref.split(n, u, v, float(m["heldout_ratio"]), split_seed)
        sp = self.split
        self.train = ref.EdgeKeys(n, sp.train_u, sp.train_v, device)
        self.held = ref.EdgeKeys(n, sp.held_u, sp.held_v, device)
        degree = np.bincount(np.concatenate([sp.train_u, sp.train_v])
                             .astype(np.int64), minlength=n)
        self.degree = torch.as_tensor(degree, device=device)
        self.link_cap = int(m["ds_link_cap"])
        self.e_cap = edge_lanes(int(m["mini_batch_size"]), int(degree.max()),
                                self.link_cap)
        self.pop_u = torch.as_tensor(sp.pop_u, device=device)
        self.pop_v = torch.as_tensor(sp.pop_v, device=device)
        self.pop_y = torch.arange(len(sp.pop_u), device=device) < len(
            sp.held_u)

    # -- the draws, which the reference takes as given ----------------------

    def draw_faults(self, d: ref.Draws) -> int:
        """Steps whose draws break the sampler's stated rules, plus noise
        blocks that are not standard normal. A step: valid ids in range;
        distinct valid nodes; every valid edge's endpoints among them;
        the valid edges all links of the training graph (a NodeLink
        draw) or all pairs outside the training and held-out edges (a
        NodeNonLink draw), sharing one pivot; the weight N for a whole
        NodeLink row, N / (1 - (1 - 1/d)^m) for a subsampled hub row,
        2E / m_eff for a NodeNonLink draw."""
        n = self.md.N
        nm, em = d.node_mask, d.edge_mask
        bad = (nm & ((d.nodes < 0) | (d.nodes >= n))).any(-1)
        bad |= (em & ((d.edges_u < 0) | (d.edges_v >= n)
                      | (d.edges_u >= d.edges_v))).any(-1)
        bad |= ((d.nbrs < 0) | (d.nbrs >= n)).any(-1)
        same = ((d.nodes[:, :, None] == d.nodes[:, None, :])
                & nm[:, :, None] & nm[:, None, :])
        bad |= (same.sum((-1, -2)) != nm.sum(-1))
        for ends in (d.edges_u, d.edges_v):
            hit = ((ends[:, :, None] == d.nodes[:, None, :])
                   & nm[:, None, :]).any(-1)
            bad |= (em & ~hit).any(-1)
        link = self.train.has(d.edges_u, d.edges_v)
        held = self.held.has(d.edges_u, d.edges_v)
        m_eff = em.sum(-1)
        n_link = (link & em).sum(-1)
        is_link = n_link == m_eff
        non_ok = ~((link | held) & em).any(-1)
        bad |= (m_eff > 0) & ~is_link & ~non_ok
        first = torch.argmax(em.to(torch.int32), dim=-1, keepdim=True)
        cand = torch.cat([d.edges_u.gather(1, first),
                          d.edges_v.gather(1, first)], dim=-1)   # [S, 2]
        inc = (((d.edges_u[:, None, :] == cand[:, :, None])
                | (d.edges_v[:, None, :] == cand[:, :, None]))
               | ~em[:, None, :]).all(-1)                        # [S, 2]
        bad |= (m_eff > 0) & ~inc.any(-1)
        # a NodeLink draw: its pivot's whole row, weight N, or a hub
        # row's subsample, weight N / p; either end of a lone edge may
        # be the pivot
        deg = self.degree[cand.long().clamp(0, n - 1)].double()   # [S, 2]
        w = d.weight.double()[:, None]
        whole = deg <= self.e_cap
        p_inc = 1.0 - (1.0 - 1.0 / deg.clamp(min=1.0)) ** self.e_cap
        want_link = torch.where(whole | (self.link_cap == 0), float(n),
                                n / p_inc.clamp(min=1e-30))
        link_ok = (inc & ((w - want_link).abs() <= 1e-4 * want_link)
                   & (~whole | (m_eff[:, None] == deg))).any(-1)
        want_non = 2.0 * self.split.total_edges / m_eff.clamp(min=1).double()
        non_w_ok = (w[:, 0] - want_non).abs() <= 1e-4 * want_non
        bad |= (m_eff > 0) & is_link & ~link_ok
        bad |= (m_eff > 0) & ~is_link & ~non_w_ok
        faults = int(bad.sum())
        for x in (d.phi_noise, d.beta_noise):
            count = x.numel()
            var, mean = (float(y) for y in torch.var_mean(x))
            finite = bool(torch.isfinite(x).all())
            if (not finite or abs(mean) > 6.0 / math.sqrt(count)
                    or abs(var - 1.0) > 6.0 * math.sqrt(2.0 / count)):
                faults += 1
        return faults

    def stream_faults(self, chunks: List[Chunk]) -> int:
        """Tests of the call's random streams that need none of the
        program's generators, each failing at about six standard
        deviations: every pair of phi noise blocks and of theta noise
        blocks one step apart, a window apart and a chunk apart
        uncorrelated (the mean product of two independent standard
        normal blocks of c values has the deviation 1 / sqrt(c)); the
        neighbor draws of the whole call uniform over the nodes (a
        chi-square over 64 equal ranges of ids, its 1e-9 quantile by
        Wilson and Hilferty)."""
        faults = 0
        t_win = self.md.T if self.md.T > 1 else 1
        for name in ("phi_noise", "beta_noise"):
            blocks = [getattr(c.draws, name) for c in chunks]
            pairs = [(x[:-lag], x[lag:]) for x in blocks
                     for lag in {1, t_win} if x.shape[0] > lag]
            pairs += [(a[:1], b[:1]) for a, b in zip(blocks, blocks[1:])]
            for a, b in pairs:
                if a.shape[0] == 0:
                    continue
                count = a[0].numel()
                prod = (a.flatten(1) * b.flatten(1)).mean(1, dtype=torch.float64)
                faults += int((prod.abs() > 6.0 / math.sqrt(count)).sum())
        ids = torch.cat([c.draws.nbrs.reshape(-1).long() for c in chunks])
        buckets = 64
        hist = torch.bincount(ids * buckets // self.md.N,
                              minlength=buckets)[:buckets].double()
        want = ids.numel() / buckets
        chi2 = float(((hist - want) ** 2).sum() / want)
        df = buckets - 1
        z = 6.0
        bound = df * (1.0 - 2.0 / (9 * df)
                      + z * math.sqrt(2.0 / (9 * df))) ** 3
        return faults + int(chi2 > bound)

    # -- the numbers --------------------------------------------------------

    def follow(self, c: Span, precision: str = "config",
               theta_grad_steps: int = None) -> ref.Rows:
        return ref.follow(self.md, c.start, c.draws, c.step0, c.beta_step0,
                          self.train, precision, theta_grad_steps)

    def evaluation(self, ppx: float, state) -> Evaluation:
        """The program's last evaluation, with the population's rows read
        from its state (the rest of the state may then be freed)."""
        return Evaluation(ppx, state.ppx_per_edge.float().clone(),
                          int(state.ppx_count),
                          state.pi[self.pop_u.long()],
                          state.pi[self.pop_v.long()],
                          state.beta.float().clone())

    def evaluate(self, rows_u, rows_v, beta, avg, count):
        lik = ref.likelihood(self.md, rows_u, rows_v, beta.float(),
                             self.pop_y)
        return ref.fold(avg, lik, count)


def early_rows(c: Chunk, t_win: int) -> torch.Tensor:
    """[M] bool over the chunk's touched rows: those that no step writes
    after the chunk's first window (read-only rows included)."""
    d, ids = c.draws, c.start.ids
    m = ids.numel()
    loc = ref.local_rows(ids, d.nodes, d.node_mask)
    steps = torch.arange(loc.shape[0], device=loc.device)[:, None].expand(
        loc.shape)
    last = torch.full((m + 1,), -1, dtype=torch.long, device=loc.device)
    last = last.scatter_reduce(0, loc.reshape(-1), steps.reshape(-1),
                               "amax")
    return last[:m] < t_win


def gaps(want: ref.Rows, got: ref.Rows, early: torch.Tensor
         ) -> Dict[str, float]:
    """early_pi_gap and pi_gap: the largest L1 distance of a row (rows
    sum to 1) among the rows left as the first window wrote them, and
    among all touched rows; early_sum_gap: the largest relative gap of
    such a row's sum; theta_gap: the normwise relative gap of theta."""
    def worst(x, rows):
        return float(x[rows].max()) if bool(rows.any()) else 0.0

    l1 = (got.pi - want.pi).abs().sum(-1)
    rel = (got.sums - want.sums).abs() / want.sums.abs().clamp(min=1e-30)
    every = torch.ones_like(early)
    theta = float(torch.linalg.vector_norm(got.theta - want.theta)
                  / torch.linalg.vector_norm(want.theta))
    return {"early_pi_gap": worst(l1, early), "pi_gap": worst(l1, every),
            "early_sum_gap": worst(rel, early), "theta_gap": theta}


def span_gaps(want: ref.Rows, got: ref.Rows, start: ref.Rows
              ) -> Dict[str, float]:
    """window_pi_gap: the largest L1 distance of a row after one window
    (or the steps after the last window) followed from the program's
    state at its start; window_theta_gap: the norm of theta's gap over
    the norm of theta's change in those steps."""
    l1 = (got.pi - want.pi).abs().sum(-1)
    moved = torch.linalg.vector_norm(want.theta - start.theta.to(
        want.theta.dtype))
    theta = float(torch.linalg.vector_norm(got.theta - want.theta)
                  / moved.clamp(min=1e-30))
    return {"window_pi_gap": float(l1.max()) if l1.numel() else 0.0,
            "window_theta_gap": theta}


def _worst(acc: Dict[str, float], new: Dict[str, float]) -> None:
    for name, x in new.items():
        acc[name] = max(acc.get(name, 0.0), x) if not math.isnan(x) \
            else math.inf


def readings(judge: Judge, chunks: List[Chunk], ev: Optional[Evaluation],
             steps_called: int,
             stand_in: Optional[Callable[[Chunk], ref.Rows]] = None
             ) -> Dict[str, float]:
    """The numbers compared for one timed call. ``stand_in``, when
    given, gives the rows that take the program's place in each chunk
    (a control: the reference at a lower precision; a planted fault);
    the evaluation is then computed over its rows by the reference's
    arithmetic."""
    out: Dict[str, float] = {}
    followed = 0
    faults = judge.stream_faults(chunks) if chunks else 0
    last_rows = None
    for c in chunks:
        want = judge.follow(c)
        got = c.end if stand_in is None else stand_in(c)
        _worst(out, gaps(want, got, early_rows(c, judge.md.T)))
        spanned = 0
        for sp in c.spans:
            _worst(out, span_gaps(judge.follow(sp), sp.end if stand_in is None
                                  else stand_in(sp), sp.start))
            spanned += sp.draws.nodes.shape[0]
        # steps that no window nor the steps after them covered
        followed += min(spanned, c.draws.nodes.shape[0])
        faults += judge.draw_faults(c.draws)
        last_rows = (c, got)
    for name in NAMES[:6]:
        out.setdefault(name, math.inf)
    out["ppx_gap"] = out["ppx_edge_gap"] = math.inf
    if ev is not None and last_rows is not None:
        c, got = last_rows
        rows_u, rows_v, beta = ev.rows_u, ev.rows_v, ev.beta
        ppx_got, avg_got = ev.ppx, ev.avg
        if stand_in is not None:
            rows_u = _replaced(rows_u, judge.pop_u, got)
            rows_v = _replaced(rows_v, judge.pop_v, got)
            beta = got.beta
            avg_got, ppx_got = judge.evaluate(rows_u, rows_v, beta,
                                              c.ppx_avg, ev.count)
        avg_want, ppx_want = judge.evaluate(rows_u, rows_v, beta, c.ppx_avg,
                                            ev.count)
        out["ppx_gap"] = abs(ppx_got - ppx_want) / ppx_want
        out["ppx_edge_gap"] = float(((avg_got - avg_want).abs()
                                     / avg_want.clamp(min=1e-30)).max())
        if ev.count != c.ppx_count + 1:
            out["ppx_gap"] = math.inf
    out["draw_faults"] = float(faults)
    out["steps_missing"] = float(steps_called - followed)
    return {name: out[name] for name in NAMES}


def _replaced(rows: torch.Tensor, ids: torch.Tensor, new: ref.Rows):
    """``rows`` (pi's rows of ``ids``) with those that ``new`` holds
    replaced by its values."""
    pos = torch.searchsorted(new.ids, ids.long()).clamp(
        max=new.ids.numel() - 1)
    hit = new.ids[pos] == ids.long()
    return torch.where(hit[:, None], new.pi[pos], rows.float())


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit (NaN never is). Every
    number needs an entry; ``null`` marks one that the cell does not
    compare (PERF.md says why)."""
    return all(name in limits and (limits[name] is None
                                   or values[name] <= limits[name])
               for name in NAMES)
