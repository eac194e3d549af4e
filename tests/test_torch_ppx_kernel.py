"""The held-out evaluation's kernel (``csrc/ppx_kernel.cu``, through
``ops/perplexity.likelihood_cuda``). On the CPU: the plan of threads per
pair, the plain path for CPU tensors (no library loads), and the
wrapper's argument checks, which raise before any library loads. On a
card (``-m cuda``): the kernel against the plain version at the
benchmark cells' shapes, ragged K, the chain layout, the sharded entry
with masked lanes, H = 1 and one chain; two launches bit-equal; one
launch pair per evaluation of a ``Learner`` call. This file imports no JAX, so its
``cuda`` tests run on the card with ``python -m pytest --noconftest -m
cuda tests/test_torch_ppx_kernel.py``."""

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu_torch import chains_flat, config, kernels, learner
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.ops import perplexity
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set


def _cfg(n, k, eps=1e-7):
    return config.Config(K=k, epsilon=eps, mini_batch_size=2,
                         num_node_sample=2).finalize(n, 10 * n, 8)


def _case(seed, h, k, n, dtype=torch.float32, lead=1, device="cpu"):
    """Rows pi [lead N, K] normalized in float32 and stored in ``dtype``,
    beta [lead, K], labels [lead, H] (about half links), ids and running
    averages [lead, H] of a second call: the kernel's layout."""
    g = torch.Generator().manual_seed(seed)
    pi = torch.rand(lead * n, k, generator=g) + 0.05
    pi = (pi / pi.sum(-1, keepdim=True)).to(dtype)
    beta = torch.rand(lead, k, generator=g) * 0.9 + 0.05
    y = torch.rand(lead, h, generator=g) < 0.5
    u = torch.randint(0, n, (h,), generator=g, dtype=torch.int32)
    v = torch.randint(0, n, (h,), generator=g, dtype=torch.int32)
    ppx = torch.rand(lead, h, generator=g) * 1e-3
    return tuple(t.to(device) for t in (pi, beta, y, u, v, ppx))


def _no_library(monkeypatch):
    """Any kernel build or load fails the test."""
    def refuse(name):
        raise AssertionError(f"loaded the library {name}")
    monkeypatch.setattr(kernels, "load", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    perplexity._ppx_lib.cache_clear()


@pytest.mark.parametrize("k,elt,aligned,want", [
    (16384, 4, True, (4, 256)),    # dblp-k16384: one pair a CTA
    (16384, 2, True, (8, 256)),    # youtube-k16384-bf16
    (1024, 4, True, (4, 32)),      # youtube-k1024: eight pairs a CTA
    (2048, 4, True, (4, 64)),
    (2048, 2, True, (8, 32)),
    (10242, 4, True, (1, 256)),    # ragged: one value a load
    (1025, 4, True, (1, 256)),
    (1024, 4, False, (1, 128)),    # unaligned bases
    (16, 4, True, (4, 32)),
])
def test_plan(k, elt, aligned, want):
    assert perplexity.ppx_plan(k, elt, aligned) == want


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """perplexity_step, perplexity_core and chain_perplexity on CPU
    tensors load no library and give the plain functions' numbers."""
    _no_library(monkeypatch)
    before = perplexity.likelihood_cuda.launches
    n, k, h = 50, 16, 40
    cfg = _cfg(n, k)
    pi, beta, y, u, v, ppx = (t[0] if t.dim() == 2 and t.shape[0] == 1
                              else t for t in _case(1, h, k, n))
    hset = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                          u[y].numpy(), v[y].numpy(), "cpu")
    yy = hset.has_edges(u, v)
    res = perplexity.perplexity_step(cfg, pi, beta, hset, u, v, ppx, 2)
    lik = perplexity.blocked_likelihood(cfg, pi, beta, u, v, yy)
    want = perplexity.fold_likelihood(lik, yy, torch.ones_like(yy), ppx, 2)
    for a, b in zip(res, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    mask = torch.arange(h) % 3 != 0
    got = perplexity.perplexity_core(cfg, pi[u.long()], pi[v.long()], y,
                                     mask, beta, ppx, 3)
    assert torch.equal(got.ppx_per_edge[~mask], ppx[~mask])
    assert int(got.link_count + got.non_link_count) == int(mask.sum())
    gn, gu, gv = synthetic_edges(num_nodes=300, avg_degree=8, seed=2)
    split = generate_sets(gn, gu, gv, heldout_ratio=0.2, seed=3)
    graph = Graph.from_edges(gn, split.training_u, split.training_v)
    ccfg = config.Config(K=k, mini_batch_size=8, num_node_sample=8
                         ).finalize(gn, split.total_edges, graph.max_fan_out)
    for chains in (2, 1):
        lrn = chains_flat.FlatChainLearner(ccfg, graph, split, chains, "cpu")
        st, neg = chains_flat.chain_perplexity(ccfg, chains, lrn.heldout_set,
                                               lrn.heldout_u, lrn.heldout_v,
                                               lrn.state)
        assert neg.shape == (chains,) and st.ppx_per_edge.shape == (
            chains, lrn.heldout_u.shape[0])
    assert perplexity.likelihood_cuda.launches == before


def _args(n=50, k=16, h=40, lead=1):
    cfg = _cfg(n, k)
    pi, beta, y, u, v, ppx = _case(2, h, k, n, lead=lead)
    return dict(cfg=cfg, rows_u=pi, rows_v=pi, beta=beta, u=u, v=v, y=y,
                ppx_per_edge=ppx, avg_count=2)


BAD = {
    "cpu tensors": {},
    "float64 rows": dict(rows_u=torch.zeros(50, 16, dtype=torch.float64),
                         rows_v=torch.zeros(50, 16, dtype=torch.float64)),
    "rows of another K": dict(rows_u=torch.zeros(50, 8),
                              rows_v=torch.zeros(50, 8)),
    "too few rows": dict(rows_u=torch.zeros(49, 16),
                         rows_v=torch.zeros(49, 16)),
    "non-contiguous rows": dict(rows_u=torch.zeros(16, 50).T,
                                rows_v=torch.zeros(16, 50).T),
    "float64 beta": dict(beta=torch.zeros(1, 16, dtype=torch.float64)),
    "beta of another K": dict(beta=torch.zeros(1, 17)),
    "beta without its chain axis": dict(beta=torch.zeros(16)),
    "int64 ids": dict(u=torch.zeros(40, dtype=torch.int64),
                      v=torch.zeros(40, dtype=torch.int64)),
    "ids of another H": dict(u=torch.zeros(39, dtype=torch.int32)),
    "one id tensor": dict(v=None),
    "float labels": dict(y=torch.zeros(1, 40)),
    "labels of another H": dict(y=torch.zeros(1, 41, dtype=torch.bool)),
    "labels without their chain axis": dict(y=torch.zeros(40,
                                                          dtype=torch.bool)),
    "bf16 averages": dict(ppx_per_edge=torch.zeros(1, 40,
                                                   dtype=torch.bfloat16)),
    "non-contiguous averages": dict(ppx_per_edge=torch.zeros(1, 80)[:, ::2]),
    "averages without their chain axis": dict(ppx_per_edge=torch.zeros(40)),
    "float mask": dict(mask=torch.ones(40)),
    "int count": dict(avg_count=torch.tensor(2)),
    "chains without their beta rows": dict(ppx_per_edge=torch.zeros(2, 40)),
    "gathered rows of two chains": dict(
        u=None, v=None, rows_u=torch.zeros(40, 16), rows_v=torch.zeros(40, 16),
        beta=torch.zeros(2, 16), ppx_per_edge=torch.zeros(2, 40)),
}


@pytest.mark.parametrize("what", list(BAD))
def test_checks_raise_before_the_library_loads(monkeypatch, what):
    """Each operand the kernel does not take raises ValueError, and
    nothing builds or loads the kernel's library first."""
    _no_library(monkeypatch)
    args = {**_args(), **BAD[what]}
    with pytest.raises(ValueError, match="evaluation kernel operand"):
        perplexity.likelihood_cuda(**args)


def test_chain_checks_raise_before_the_library_loads(monkeypatch):
    """The chain layout: a label row per chain or one for all; [lead, H]
    averages; here on the CPU each raises for its device alone."""
    _no_library(monkeypatch)
    for y_rows in (1, 2):
        args = _args(lead=2)
        args["y"] = args["y"][:y_rows]
        with pytest.raises(ValueError, match="one CUDA device"):
            perplexity.likelihood_cuda(**args)
    args = _args(lead=2)
    args["ppx_per_edge"] = args["ppx_per_edge"][0]
    with pytest.raises(ValueError, match="running averages"):
        perplexity.likelihood_cuda(**args)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _plain(cfg, pi, beta, u, v, y, ppx, count, lead=1):
    """The plain version on the same operands, in the kernel's layout:
    the chain engine's fold for ``lead`` > 1 (its scalars per chain),
    else fold_likelihood on the one chain's [H] operands."""
    if lead == 1:
        lik = perplexity.blocked_likelihood(cfg, pi, beta[0], u, v, y[0])
        res = perplexity.fold_likelihood(lik, y[0], torch.ones_like(y[0]),
                                         ppx[0], count)
        return perplexity.PpxResult(*(t[None] for t in res))
    lik = perplexity.blocked_likelihood(cfg, pi, beta[:, None, :], u, v, y,
                                        lead=lead)
    new = (ppx * (count - 1.0) + lik) / count
    lg = torch.log(new)
    yf = y.float().expand_as(lg)
    return perplexity.PpxResult(new, -lg.mean(-1), (lg * yf).sum(-1),
                                (lg * (1 - yf)).sum(-1),
                                y.expand_as(lg).sum(-1),
                                (~y).expand_as(lg).sum(-1))


def _agree(got, want, what):
    """Each pair's running average at rtol 2e-5 (two float32 sums over K
    in other orders, PERF.md section 2), neg_avg_log and the log sums
    within 1e-6 relative, the counts exact. A sum over no pairs (the
    non-links where H = 1 holds a link) is 0 in both, exactly."""
    torch.testing.assert_close(got.ppx_per_edge, want.ppx_per_edge,
                               rtol=2e-5, atol=0, msg=what)
    for a, b in zip(got[1:4], want[1:4]):
        a, b = a.double(), b.double()
        empty = b == 0
        assert torch.equal(a[empty], b[empty]), (what, a, b)
        gap = max([0.0] + ((a - b).abs() / b.abs())[~empty].tolist())
        assert gap <= 1e-6, (what, gap)
    assert torch.equal(got.link_count, want.link_count), what
    assert torch.equal(got.non_link_count, want.non_link_count), what


# (H, K, pi dtype, chains, rows of pi a chain)
SHAPES = [
    (10226, 16384, torch.float32, 1, 4096),   # dblp-k16384
    (29610, 16384, torch.bfloat16, 1, 4096),  # youtube-k16384-bf16
    (29610, 1024, torch.float32, 1, 65536),   # youtube-k1024
    (3001, 10242, torch.float32, 1, 2048),    # ragged, 4-byte loads
    (3001, 1025, torch.bfloat16, 1, 2048),    # ragged, 2-byte loads
    (3001, 1025, torch.float32, 1, 2048),
    (2000, 2048, torch.float32, 2, 4096),     # the chain layout
    (2000, 16384, torch.bfloat16, 2, 1024),
    (1, 16384, torch.float32, 1, 8),          # H = 1
    (1, 1024, torch.bfloat16, 1, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,k,dtype,lead,n", SHAPES)
def test_kernel_matches_plain_on_gpu(cuda_device, h, k, dtype, lead, n):
    """Two successive evaluations (counts 1 and 2, the second from the
    first's averages) through the kernel and the plain version; a second
    launch on the same operands gives the same bits."""
    cfg = _cfg(n, k)
    pi, beta, y, u, v, ppx = _case(h + k, h, k, n, dtype, lead, cuda_device)
    ppx = torch.zeros_like(ppx)
    got_avg = want_avg = ppx
    for count in (1, 2):
        before = perplexity.likelihood_cuda.launches
        got = perplexity.likelihood_cuda(cfg, pi, pi, beta, u, v, y,
                                         got_avg, count)
        again = perplexity.likelihood_cuda(cfg, pi, pi, beta, u, v, y,
                                           got_avg, count)
        assert perplexity.likelihood_cuda.launches == before + 2
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        want = _plain(cfg, pi, beta, u, v, y, want_avg, count, lead)
        _agree(got, want, f"H={h} K={k} {dtype} lead={lead} count={count}")
        got_avg, want_avg = got.ppx_per_edge, want.ppx_per_edge


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16384, 1024])
def test_sharded_entry_on_gpu(cuda_device, k):
    """perplexity_core on gathered float32 rows (one buffer, u rows then
    v rows, as the sharded engine fetches them) with masked lanes: the
    kernel against edge_likelihood and fold_likelihood; masked lanes keep
    their average and count nowhere."""
    h, n = 3001, 2048
    cfg = _cfg(n, k)
    pi, beta, y, u, v, ppx = (t[0] if t.dim() == 2 and t.shape[0] == 1
                              else t for t in _case(7, h, k, n,
                                                    device=cuda_device))
    rows = torch.cat([pi[u.long()], pi[v.long()]])
    mask = torch.arange(h, device=cuda_device) % 5 != 0
    y = y & mask
    before = perplexity.likelihood_cuda.launches
    got = perplexity.perplexity_core(cfg, rows[:h], rows[h:], y, mask, beta,
                                     ppx, 3)
    assert perplexity.likelihood_cuda.launches == before + 1
    want = perplexity.fold_likelihood(
        perplexity.edge_likelihood(cfg, rows[:h], rows[h:], y, beta), y, mask,
        ppx, 3)
    _agree(got, want, f"sharded K={k}")
    assert torch.equal(got.ppx_per_edge[~mask], ppx[~mask])
    assert int(got.link_count + got.non_link_count) == int(mask.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [3, 1])
def test_chain_engine_on_gpu(cuda_device, chains):
    """chains_flat.chain_perplexity on the card: one launch pair for the
    C chains, each with its beta row, against the plain chain fold on a
    CPU copy of the state; C = 1 is the sharded chain engine's case of
    one chain a rank."""
    n, u, v = synthetic_edges(num_nodes=600, avg_degree=8, seed=2)
    split = generate_sets(n, u, v, heldout_ratio=0.2, seed=3)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(K=2048, mini_batch_size=8, num_node_sample=8
                        ).finalize(n, split.total_edges, graph.max_fan_out)
    lrn = chains_flat.FlatChainLearner(cfg, graph, split, chains,
                                       cuda_device)
    st = lrn.state
    cpu = st._replace(pi=st.pi.cpu(), beta=st.beta.cpu(),
                      ppx_per_edge=st.ppx_per_edge.cpu())
    hset = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                          split.heldout_u, split.heldout_v, "cpu")
    for _ in range(2):
        before = perplexity.likelihood_cuda.launches
        st, got = chains_flat.chain_perplexity(cfg, chains, lrn.heldout_set,
                                               lrn.heldout_u, lrn.heldout_v,
                                               st)
        assert perplexity.likelihood_cuda.launches == before + 1
        assert got.shape == (chains,)
        cpu, want = chains_flat.chain_perplexity(
            cfg, chains, hset, lrn.heldout_u.cpu(), lrn.heldout_v.cpu(), cpu)
        torch.testing.assert_close(st.ppx_per_edge.cpu(), cpu.ppx_per_edge,
                                   rtol=2e-5, atol=0)
        gap = float(((got.cpu().double() - want.double()).abs()
                     / want.double().abs()).max())
        assert gap <= 1e-6, gap


@pytest.mark.cuda
@pytest.mark.parametrize("pi_dtype", ["float32", "bfloat16"])
def test_learner_counts_one_launch_pair_per_evaluation(cuda_device,
                                                       pi_dtype):
    """A Learner on the card: each heldout_perplexity() is one launch
    pair of the kernel, with numbers equal to the plain version's on a
    CPU copy of the state; with the training perplexity on,
    run_with_ppx(300, 100) makes three held-out and three training
    evaluations, six launch pairs."""
    n, u, v = synthetic_edges(2000, 8, seed=1)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=2)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(K=1024, mini_batch_size=32, num_node_sample=32,
                        steps_per_call=100, device_sampling=True,
                        shared_neighbors=True, window=12, ds_link_cap=32,
                        pi_dtype=pi_dtype).finalize(n, split.total_edges,
                                                    graph.max_fan_out)
    lrn = learner.Learner(cfg, graph, split, cuda_device)
    lrn.run(100)
    st = lrn.state
    hset = build_edge_set(cfg.edgeset_backend, n, split.heldout_u,
                          split.heldout_v, "cpu")
    want = perplexity.perplexity_step(cfg, st.pi.cpu(), st.beta.cpu(), hset,
                                      lrn.heldout_u.cpu(),
                                      lrn.heldout_v.cpu(),
                                      st.ppx_per_edge.cpu(),
                                      st.ppx_count + 1)
    before = perplexity.likelihood_cuda.launches
    got = lrn.heldout_perplexity()
    assert perplexity.likelihood_cuda.launches == before + 1
    assert abs(got - float(torch.exp(want.neg_avg_log))) <= 1e-6 * got
    torch.testing.assert_close(lrn.state.ppx_per_edge.cpu(),
                               want.ppx_per_edge, rtol=2e-5, atol=0)
    tl = learner.Learner(cfg.replace(calc_train_ppx=True,
                                     training_ppx_ratio=0.01),
                         graph, split, cuda_device)
    before = perplexity.likelihood_cuda.launches
    series = tl.run_with_ppx(300, 100)
    assert perplexity.likelihood_cuda.launches == before + 6
    assert len(series) == 3
    assert all(np.isfinite([e["ppx"], e["train_ppx"]]).all()
               for e in series)


@pytest.mark.cuda
def test_one_chain_learner_on_gpu(cuda_device):
    """FlatChainLearner(num_chains=1) on the card: training chunks and
    three evaluations, each one launch pair, each a [1] perplexity."""
    n, u, v = synthetic_edges(num_nodes=600, avg_degree=8, seed=4)
    split = generate_sets(n, u, v, heldout_ratio=0.2, seed=5)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(K=1024, mini_batch_size=8, num_node_sample=8,
                        steps_per_call=20).finalize(n, split.total_edges,
                                                    graph.max_fan_out)
    lrn = chains_flat.FlatChainLearner(cfg, graph, split, 1, cuda_device)
    before = perplexity.likelihood_cuda.launches
    series = lrn.run_with_ppx(60, 20)
    assert perplexity.likelihood_cuda.launches == before + 3
    assert len(series) == 3
    for e in series:
        assert np.shape(e["ppx"]) == (1,) and np.isfinite(e["ppx"]).all()
