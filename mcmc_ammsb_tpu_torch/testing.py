"""Seeded operands for checking the port's kernels.

``window_case`` draws, with numpy, the state and the hoisted operands
of one T-step window at a chosen shape, with rows that collide across
the window's steps on purpose (nodes and neighbors come from a small
node pool), masked node and edge lanes, and padded lanes that carry the
sentinel N; ``chain_window_case`` one such window for each of C chains (the flat
chain engine), ``mmsb_window_case`` the same window for the full MMSB,
``phi_case`` one step of the per-node phi update, ``host_case`` a small
graph with a chunk of host-sampled minibatches (padded lanes hold id 0
and a false mask). The same arrays drive
the port's plain versions and its CUDA kernels (``chip_smoke.py``) and
the JAX package's functions (the CPU parity tests).
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import data
from mcmc_ammsb_tpu_torch.chains_flat import ChainState
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.learner import DeviceBatch, TrainState
from mcmc_ammsb_tpu_torch.models.mmsb import MMSBState
from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler


def window_case(seed: int, t_win: int, b_cap: int, n_smpl: int,
                e_cap: int, k: int) -> dict:
    """numpy arrays of one window: the state fields (pi, phi_sum, theta,
    beta, step_count, beta_count) and the operand tuple's fields."""
    r = np.random.default_rng(seed)
    n_nodes = 2 * b_cap + n_smpl          # small pool: many collisions
    f32 = np.float32
    pi = r.gamma(1.0, size=(n_nodes, k)).astype(f32)
    pi /= pi.sum(-1, keepdims=True)
    nodes = np.full((t_win, b_cap), n_nodes, np.int32)
    node_mask = np.zeros((t_win, b_cap), bool)
    lanes_u = np.zeros((t_win, e_cap), np.int32)
    lanes_v = np.zeros((t_win, e_cap), np.int32)
    edge_mask = np.zeros((t_win, e_cap), bool)
    nbrs = np.zeros((t_win, 1, n_smpl), np.int32)
    for t in range(t_win):
        n_valid = b_cap if t == 0 else int(r.integers(2, b_cap + 1))
        nodes[t, :n_valid] = r.choice(n_nodes, n_valid, replace=False)
        node_mask[t, :n_valid] = True
        n_edges = int(r.integers(1, e_cap + 1))
        lanes_u[t, :n_edges] = r.integers(0, n_valid, n_edges)
        lanes_v[t, :n_edges] = r.integers(0, n_valid, n_edges)
        edge_mask[t, :n_edges] = True
        nbrs[t, 0] = r.choice(n_nodes, n_smpl, replace=False)
    pick = np.arange(t_win)[:, None]
    theta = (r.gamma(1.0, size=(k, 2)) + 0.1).astype(f32)
    return dict(
        n_nodes=n_nodes,
        pi=pi,
        phi_sum=(1.0 + k * r.random(n_nodes)).astype(f32),
        theta=theta,
        beta=theta[:, 1] / (theta[:, 0] + theta[:, 1]),
        step_count=int(r.integers(1, 500)),
        beta_count=int(r.integers(0, 500)),
        edges_u=nodes[pick, lanes_u], edges_v=nodes[pick, lanes_v],
        edge_mask=edge_mask, nodes=nodes, node_mask=node_mask,
        weight=r.choice([float(n_nodes), 7.5], t_win).astype(f32),
        neighbors=nbrs,
        y_phi=r.random((t_win, b_cap, n_smpl)) < 0.3,
        phi_noise=r.standard_normal((t_win, b_cap, k)).astype(f32),
        beta_noise=r.standard_normal((t_win, k, 2)).astype(f32),
        y_edges=r.random((t_win, e_cap)) < 0.5,
        lanes_u=lanes_u, lanes_v=lanes_v)


def digest(arrays: dict) -> dict:
    """A float64 digest of each named array (numpy or torch): its sum,
    2-norm, largest magnitude and size. The sidecars of the JAX-written
    checkpoint fixtures (tests/jax_fixtures.py) hold JAX's continuation
    as one."""
    out = {}
    for name, x in arrays.items():
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().double().numpy()
        x = np.asarray(x, np.float64)
        out[name] = {"sum": float(x.sum()), "norm": float(np.linalg.norm(x)),
                     "max_abs": float(np.abs(x).max()), "size": int(x.size)}
    return out


def digest_misses(got: dict, want: dict, rtol: float, atol: float) -> list:
    """Where the digest ``got`` breaks what the normwise contract
    max |got - want| <= atol + rtol * max |want| implies for the digest of
    arrays of ``want``'s sizes: |d max_abs| <= b, |d norm| <= sqrt(n) b,
    |d sum| <= n b, with b that bound. [] when it holds."""
    misses = []
    for name, w in want.items():
        g, n = got[name], w["size"]
        b = atol + rtol * w["max_abs"]
        for key, limit in (("max_abs", b), ("norm", np.sqrt(n) * b),
                           ("sum", n * b)):
            if not abs(g[key] - w[key]) <= limit:
                misses.append(f"{name}.{key}: {g[key]!r} vs {w[key]!r} "
                              f"(limit {limit:.3e})")
    return misses


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bfloat16 ulps of two bf16 tensors (0 where
    the bits are equal): each value's bits as a signed 16-bit integer
    mapped onto a line that is monotone in the value (-0.0 and +0.0 are
    the same point)."""
    def line(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return (line(a) - line(b)).abs()


def bf16_gaps(got: torch.Tensor, want: torch.Tensor, got32: torch.Tensor,
              want32: torch.Tensor) -> dict:
    """How two versions' bf16 stored values ``got`` and ``want`` differ,
    given the float32 values each version computed before rounding
    (``got32``, ``want32``: the same version run on the same operands
    with the bf16 table upcast to float32). Rounding to nearest moves a
    value by at most half an ulp, so |got - want| <= |got32 - want32| +
    one ulp: ``unexplained`` counts the values past that bound (a fault
    of the bf16 mode, never of the float32 arithmetic); ``one_ulp`` and
    ``more_ulps`` count the values 1 and more than 1 ulp apart (the
    latter only where the float32 values themselves differ by more than
    an ulp, as the few elements that come out of a cancellation do)."""
    ulps = bf16_ulps(got, want)

    def ulp(x):
        up = (x.contiguous().view(torch.int16) + 1).view(torch.bfloat16)
        return (up.float() - x.float()).abs()

    slack = (got32.float() - want32.float()).abs() + torch.maximum(
        ulp(got), ulp(want))
    gap = (got.float() - want.float()).abs()
    return {"one_ulp": int((ulps == 1).sum()),
            "more_ulps": int((ulps > 1).sum()),
            "max_ulps": int(ulps.max()) if ulps.numel() else 0,
            "unexplained": int((gap > slack).sum())}


def window_case_config(case: dict) -> Config:
    t_win, b_cap, n_smpl = case["y_phi"].shape
    return Config(K=case["pi"].shape[1], window=t_win,
                  mini_batch_size=b_cap - 1, num_node_sample=n_smpl,
                  device_sampling=True, shared_neighbors=True).finalize(
        case["n_nodes"], 1000, b_cap - 1)


def window_case_torch(case: dict, device):
    """The case as the port's (TrainState, operand tuple) on ``device``."""
    def t(name):
        return torch.as_tensor(case[name], device=device)

    state = TrainState(pi=t("pi").clone(), phi_sum=t("phi_sum").clone(),
                       theta=t("theta"), beta=t("beta"),
                       step_count=case["step_count"],
                       beta_count=case["beta_count"],
                       ppx_per_edge=torch.zeros(1, device=device),
                       ppx_count=0)
    batch = DeviceBatch(*(t(f) for f in DeviceBatch._fields))
    xs = (batch, t("neighbors"), t("y_phi"), t("phi_noise"),
          t("beta_noise"), t("y_edges"), t("lanes_u"), t("lanes_v"))
    return state, xs


#: The fields of a chain_window_case that make the window's hoisted
#: operand tuple, in the order of the chain engine's (chains_flat).
CHAIN_FIELDS = ("nodes", "node_mask", "edges_u", "edges_v", "edge_mask",
                "weight", "neighbors", "y_phi", "phi_noise", "beta_noise",
                "y_edges", "nbr_mask", "lanes_u", "lanes_v")


def chain_window_case(seed: int, n_chains: int, t_win: int, b_cap: int,
                      n_smpl: int, e_cap: int, k: int) -> dict:
    """One window of ``n_chains`` chains: chain c is ``window_case``'s
    recipe at its own seed (its own pi block, theta, weights and noise;
    the same node pool, so the same N), with step 1 forced to read a row
    step 0 wrote, so that every chain corrects. The state is flat
    (pi [C*N, K], theta [C, K, 2]) and the operands are in the chain
    engine's layout ([T, C, ...]; phi_noise [T, C*B, K], chain-local
    ids, lanes without chain offsets); the step counters are shared."""
    cases = [window_case(seed * 7919 + c, t_win, b_cap, n_smpl, e_cap, k)
             for c in range(n_chains)]
    for cs in cases:
        if t_win > 1 and cs["nodes"][0, 0] not in cs["neighbors"][1, 0]:
            cs["neighbors"][1, 0, 0] = cs["nodes"][0, 0]

    def stack(name, axis=1):
        return np.stack([cs[name] for cs in cases], axis=axis)

    nodes = stack("nodes")
    neighbors = stack("neighbors")[:, :, 0]                  # [T, C, n]
    return dict(
        n_nodes=cases[0]["n_nodes"], n_chains=n_chains,
        pi=np.concatenate([cs["pi"] for cs in cases]),
        phi_sum=np.concatenate([cs["phi_sum"] for cs in cases]),
        theta=stack("theta", 0), beta=stack("beta", 0),
        step_count=cases[0]["step_count"],
        beta_count=cases[0]["beta_count"],
        nodes=nodes, node_mask=stack("node_mask"),
        edges_u=stack("edges_u"), edges_v=stack("edges_v"),
        edge_mask=stack("edge_mask"), weight=stack("weight"),
        neighbors=neighbors, y_phi=stack("y_phi"),
        phi_noise=stack("phi_noise").reshape(t_win, n_chains * b_cap, k),
        beta_noise=stack("beta_noise"), y_edges=stack("y_edges"),
        nbr_mask=neighbors[:, :, None, :] != nodes[..., None],
        lanes_u=stack("lanes_u"), lanes_v=stack("lanes_v"))


def chain_window_case_config(case: dict) -> Config:
    t_win, _, b_cap, n_smpl = case["y_phi"].shape
    return Config(K=case["pi"].shape[1], window=t_win,
                  mini_batch_size=b_cap - 1, num_node_sample=n_smpl,
                  device_sampling=True, shared_neighbors=True).finalize(
        case["n_nodes"], 1000, b_cap - 1)


def chain_window_case_torch(case: dict, device):
    """The case as the port's (ChainState, hoisted chain operand tuple)
    on ``device``."""
    def t(name):
        return torch.as_tensor(case[name], device=device)

    state = ChainState(pi=t("pi").clone(), phi_sum=t("phi_sum").clone(),
                       theta=t("theta"), beta=t("beta"),
                       step_count=case["step_count"],
                       beta_count=case["beta_count"],
                       ppx_per_edge=torch.zeros(case["n_chains"], 1,
                                                device=device),
                       ppx_count=0)
    return state, tuple(t(f) for f in CHAIN_FIELDS)


def mmsb_window_case(seed: int, t_win: int, b_cap: int, n_smpl: int,
                     e_cap: int, k: int) -> dict:
    """``window_case`` for the full MMSB: a symmetric theta_b [K, K, 2]
    and its B, symmetrized theta noise [T, K, K, 2], neighbors [T, n] and
    a theta_count in place of the a-MMSB's theta, beta and beta noise."""
    case = window_case(seed, t_win, b_cap, n_smpl, e_cap, k)
    r = np.random.default_rng(seed + 1000)
    f32 = np.float32
    theta_b = (r.gamma(1.0, size=(k, k, 2)) + 0.1).astype(f32)
    theta_b = f32(0.5) * (theta_b + theta_b.transpose(1, 0, 2))
    xi = r.standard_normal((t_win, k, k, 2)).astype(f32)
    sym = (xi + xi.transpose(0, 2, 1, 3)) / f32(np.sqrt(2.0))
    eye = np.eye(k, dtype=bool)[None, :, :, None]
    for name in ("theta", "beta", "beta_noise", "beta_count"):
        del case[name]
    case.update(theta_b=theta_b,
                b=theta_b[..., 1] / theta_b.sum(-1),
                t_noise=np.where(eye, xi, sym),
                theta_count=int(r.integers(0, 500)),
                neighbors=case["neighbors"][:, 0])
    return case


def mmsb_window_case_torch(case: dict, device):
    """An ``mmsb_window_case`` as the port's (MMSBState, operand tuple)."""
    def t(name):
        return torch.as_tensor(case[name], device=device)

    state = MMSBState(pi=t("pi").clone(), phi_sum=t("phi_sum").clone(),
                      theta_b=t("theta_b"), b=t("b"),
                      step_count=case["step_count"],
                      theta_count=case["theta_count"],
                      ppx_per_edge=torch.zeros(1, device=device),
                      ppx_count=0)
    batch = DeviceBatch(*(t(f) for f in DeviceBatch._fields))
    xs = (batch, t("neighbors"), t("y_phi"), t("phi_noise"),
          t("t_noise"), t("y_edges"), t("lanes_u"), t("lanes_v"))
    return state, xs


def phi_case(seed: int, b_cap: int, n_smpl: int, k: int) -> dict:
    """One step of the per-node phi update: pi [N, K] (rows normalized),
    phi_sum [N], nodes [B] with the last lane padded with the sentinel N,
    private neighbors [B, n], labels, beta, noise and a step count."""
    r = np.random.default_rng(seed)
    n_nodes = 4 * (b_cap + n_smpl)
    f32 = np.float32
    pi = r.gamma(1.0, size=(n_nodes, k)).astype(f32)
    phi_sum = pi.sum(-1)
    nodes = r.choice(n_nodes, b_cap, replace=False).astype(np.int32)
    nodes[-1] = n_nodes
    return dict(
        n_nodes=n_nodes, pi=pi / phi_sum[:, None], phi_sum=phi_sum,
        nodes=nodes,
        nbrs=r.integers(0, n_nodes, (b_cap, n_smpl)).astype(np.int32),
        y=r.random((b_cap, n_smpl)) < 0.3,
        beta=(0.5 * r.random(k)).astype(f32),
        noise=r.standard_normal((b_cap, k)).astype(f32),
        step_count=int(r.integers(1, 500)))


def phi_case_config(case: dict) -> Config:
    b_cap, n_smpl = case["nbrs"].shape
    return Config(K=case["pi"].shape[1], mini_batch_size=b_cap,
                  num_node_sample=n_smpl, device_sampling=True).finalize(
        case["n_nodes"], 1000, b_cap)


def host_case(seed: int, steps: int, num_nodes: int = 300, avg_degree: int = 8,
              **config) -> dict:
    """A host-sampled case: a uniform random graph made from ``seed``, its
    split and training CSR, a finalized ``Config`` (host sampling, the
    numpy sampler, m = n = 8, K = 16 unless ``config`` says otherwise) and
    ``steps`` minibatches from the numpy host sampler, stacked. Keys:
    n, split, graph, cfg, stacked."""
    n, u, v = data.synthetic_edges(num_nodes, avg_degree, seed=seed)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    kw = dict(K=16, mini_batch_size=8, num_node_sample=8,
              device_sampling=False, shared_neighbors=False,
              host_sampler="numpy")
    kw.update(config)
    cfg = Config(**kw).finalize(n, split.total_edges, graph.max_fan_out)
    stacked = MiniBatchSampler(cfg, graph, split, seed=seed).sample_many(
        steps)
    return dict(n=n, split=split, graph=graph, cfg=cfg, stacked=stacked)
