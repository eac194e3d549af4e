"""The ``--phi-impl pallas`` path of the port (mcmc_ammsb_tpu_torch/ops/
phi_pallas.py, the private-draw hoisted loop) against the JAX package's
Pallas phi kernels in interpret mode, the way tests/test_phi_pallas.py
runs them on the CPU. The CUDA kernel itself is checked against these
plain versions on the card by chip_smoke.py."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.config import EdgeSetBackend as JaxEdgeSetBackend
from mcmc_ammsb_tpu.ops import phi_pallas as jax_phi_pallas
from mcmc_ammsb_tpu.ops.device_sampling import sample_minibatches_device
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu_torch import config, learner, testing
from mcmc_ammsb_tpu_torch.config import PhiImpl
from mcmc_ammsb_tpu_torch.interop import state_from_numpy
from mcmc_ammsb_tpu_torch.ops import phi_pallas
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set

from torch_parity import assert_close, jax_config, jax_hoist, to_torch


def _gathered(case):
    """The case's node and neighbor rows, the sentinel lane clamped to
    N-1 as JAX's gather does."""
    nodes = np.minimum(case["nodes"], case["n_nodes"] - 1)
    return (case["pi"][nodes], case["phi_sum"][nodes],
            case["pi"][case["nbrs"]])


@pytest.mark.parametrize("k", [128, 256])
def test_phi_core_matches_jax_pallas(k):
    """phi_update_core_torch == phi_update_core_pallas(interpret=True)
    on the same gathered rows, a padded lane included (B=8, n=8).

    rtol 2e-5, atol 1e-7: the bound of JAX's own Pallas-versus-jnp check
    (tests/test_phi_pallas.py:68-71). The two evaluate the same gradient
    in different forms (per-neighbor normalized probs in the kernel, the
    factorized p = s q + e here). Measured max elementwise relative
    error: rows 2.3e-6 / 3.3e-6, sums 1.2e-7 / 1.2e-7 at K=128 / 256."""
    case = testing.phi_case(5, 8, 8, k)
    cfg = testing.phi_case_config(case)
    pi_n, phis, pi_nb = _gathered(case)
    args = [pi_n, phis, pi_nb, case["y"], case["beta"]]
    got = phi_pallas.phi_update_core_torch(
        cfg, *map(torch.from_numpy, args), case["step_count"],
        torch.from_numpy(case["noise"]))
    want = jax_phi_pallas.phi_update_core_pallas(
        jax_config(cfg), *map(jnp.asarray, args),
        jnp.asarray(case["step_count"], jnp.int32),
        jnp.asarray(case["noise"]), interpret=True)
    assert_close(got[0], want[0], 2e-5, 1e-7, "rows")
    assert_close(got[1], want[1], 2e-5, 0.0, "sums")


def test_phi_rows_by_index_matches_jax_gather_kernel():
    """phi_update_rows_torch (rows read by index) ==
    phi_update_rows_pallas_gather(interpret=True) at K=1024, B=8, n=4,
    the bound of tests/test_phi_pallas.py:121-122 (rtol 2e-5, atol
    1e-8; measured max elementwise relative error: rows 1.63e-5, sums
    1.8e-7)."""
    case = testing.phi_case(7, 8, 4, 1024)
    case["nodes"][-1] = 3        # the DMA kernel takes in-range ids only
    cfg = testing.phi_case_config(case)
    jcfg = jax_config(cfg).replace(node_tile=4)
    rng = np.random.default_rng(8)
    eu = rng.integers(0, case["n_nodes"], 400).astype(np.int32)
    ev = rng.integers(0, case["n_nodes"], 400).astype(np.int32)
    es = jax_build_edge_set(JaxEdgeSetBackend.CSR, case["n_nodes"], eu, ev)
    y = np.array(es.has_edges(jnp.asarray(case["nodes"])[:, None],
                              jnp.asarray(case["nbrs"])))
    assert y.any(), "the case should hold links"
    got = phi_pallas.phi_update_rows_torch(
        cfg, *(torch.from_numpy(case[f]) for f in
               ("pi", "phi_sum", "beta", "nodes", "nbrs")),
        torch.from_numpy(y), case["step_count"],
        torch.from_numpy(case["noise"]))
    want = jax_phi_pallas.phi_update_rows_pallas_gather(
        jcfg, *(jnp.asarray(case[f]) for f in ("pi", "phi_sum", "beta")),
        es, *(jnp.asarray(case[f]) for f in ("nodes", "nbrs")),
        jnp.asarray(case["step_count"], jnp.int32),
        jnp.asarray(case["noise"]), interpret=True)
    assert_close(got[0], want[0], 2e-5, 1e-8, "rows")
    assert_close(got[1], want[1], 2e-5, 0.0, "sums")


def test_phi_entries_reject_masks_and_cpu_tensors():
    """A shared-neighbor mask is refused, as in JAX; the CUDA entries
    never run on CPU tensors (phi_update_rows picks the plain version by
    device)."""
    case = testing.phi_case(1, 4, 3, 16)
    cfg = testing.phi_case_config(case)
    pi_n, phis, pi_nb = (torch.from_numpy(a) for a in _gathered(case))
    rest = (torch.from_numpy(case["y"]), torch.from_numpy(case["beta"]),
            1, torch.from_numpy(case["noise"]))
    mask = torch.ones(4, 3, dtype=torch.bool)
    for core in (phi_pallas.phi_update_core_torch,
                 phi_pallas.phi_update_core_cuda):
        with pytest.raises(ValueError, match="mask"):
            core(cfg, pi_n, phis, pi_nb, *rest, mask)
    with pytest.raises(ValueError, match="CUDA"):
        phi_pallas.phi_update_core_cuda(cfg, pi_n, phis, pi_nb, *rest)
    by_index = [torch.from_numpy(case[f]) for f in
                ("pi", "phi_sum", "beta", "nodes", "nbrs")]
    rest_rows = (rest[0], 1, rest[3])         # y, step count, noise
    with pytest.raises(ValueError, match="CUDA"):
        phi_pallas.phi_update_rows_cuda(cfg, *by_index, *rest_rows)
    got = phi_pallas.phi_update_rows(cfg, *by_index, *rest_rows)
    want = phi_pallas.phi_update_core_torch(cfg, pi_n, phis, pi_nb, *rest)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n_smpl, k, g, chunk", [
    (32, 256, 1, 32), (32, 100, 1, 32), (7, 12, 1, 7), (32, 2048, 1, 25),
    (32, 4096, 1, 11), (32, 256, 2, 16), (32, 2048, 2, 16),
    (32, 4096, 8, 3)])
def test_phi_shared_memory_and_chunk_rule(n_smpl, k, g, chunk):
    """The kernel's shared-memory rule: a block stages all of its
    ceil(n/G) neighbor rows at once where they fit an H100's 232,448 B
    per block (the main path's (32, 256), the ragged K = 100, the small
    (7, 12)), else chunks of as many as fit (K = 2048: 25 + 7, K = 4096:
    11 + 11 + 10; with 8 blocks per node, 3 + 1 of each block's 4); the
    chunks tile the neighbors and each chunk's block fits."""
    nc = phi_pallas.phi_neighbor_chunk(n_smpl, k, g)
    assert nc == chunk
    ng = -(-n_smpl // g)
    starts = list(range(0, ng, nc))
    assert sum(min(nc, ng - c) for c in starts) == ng
    assert phi_pallas.phi_smem_bytes(n_smpl, k, nc, g) <= 232448
    if nc < ng:
        assert phi_pallas.phi_smem_bytes(n_smpl, k, nc + 1, g) > 232448


def test_phi_chunk_rule_raises_naming_the_shape():
    """A row too long for one block's shared memory raises, naming the
    shape."""
    with pytest.raises(ValueError, match=r"\(32, 20000\)"):
        phi_pallas.phi_neighbor_chunk(32, 20000)


@pytest.mark.parametrize("b_cap, n_smpl, k, g", [
    (33, 32, 256, 4), (5, 7, 12, 4), (8, 32, 2048, 8), (66, 32, 256, 2),
    (200, 32, 256, 1), (33, 1, 256, 1), (8, 32, 8192, 2)])
def test_phi_cluster_rule(b_cap, n_smpl, k, g):
    """Blocks per node: the largest power of two up to the kernel's
    cluster limit and to n whose B*G blocks fit an H100's 132 SMs and
    whose blocks keep room for a neighbor row beside the G partial rows
    (the --phi-impl pallas shape, B = 33, gets 4 and fills the SMs; at
    K = 8192 the partial rows hold G to 2)."""
    got = phi_pallas.phi_cluster_size(b_cap, n_smpl, k)
    assert got == g
    assert got == 1 or got * b_cap <= 132
    assert phi_pallas.phi_neighbor_chunk(n_smpl, k, got) >= 1


INTERVAL, EVALS = 5, 2


def test_path_a_interval_matches_jax(small_dataset):
    """The hoisted loop with private draws and --phi-impl pallas against
    JAX's _hoisted_step_body with phi_update_core_pallas (interpret
    mode), on the JAX-built operand tuple: two 5-step intervals, each
    followed by the held-out perplexity (K=128, m=n=8).

    State rtol 5e-5, atol 1e-8 and ppx rtol 1e-5, the bounds of
    tests/test_torch_slice.py (torch's and XLA's float32 sums differ in
    order, and the chain feeds the differences back). Measured max
    elementwise relative error after interval 0 / 1: theta 7.9e-6 /
    1.19e-5, beta 3.6e-7 / 8.0e-7, phi_sum 2.0e-7 / 2.3e-7, ppx 1.4e-7 /
    2.1e-7; pi differs by at most 1.2e-7 of its largest entry (its
    tiniest entries, held by atol). Longer runs drift further, as any
    reordering of float32 sums does: theta 3.05e-4 after two 6-step
    intervals."""
    n, split, graph = small_dataset
    cfg = config.Config(
        K=128, mini_batch_size=8, num_node_sample=8, device_sampling=True,
        shared_neighbors=False, phi_impl=PhiImpl.PALLAS,
        steps_per_call=INTERVAL, ppx_interval=INTERVAL).finalize(
        n, split.total_edges, graph.max_fan_out)
    jcfg = jax_config(cfg)
    jtr = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n, graph.edges_u,
                             graph.edges_v)
    jho = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n,
                             split.heldout_u, split.heldout_v)
    adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                 jnp.asarray(graph.cols, jnp.int32))
    hu, hv = split.heldout_edges_u, split.heldout_edges_v
    body = partial(jax_learner._hoisted_step_body, jcfg,
                   jax_phi_pallas.phi_update_core_pallas)

    @jax.jit
    def jax_interval(state, key):
        ds = sample_minibatches_device(jcfg, jtr, jho, key, INTERVAL,
                                       adjacency)
        xs = jax_hoist(jcfg, jtr, state, jax_learner.DeviceBatch(*ds))
        state, _ = jax.lax.scan(body, state, xs)
        state, res = jax_learner.heldout_perplexity_step(
            jcfg, jho, jnp.asarray(hu), jnp.asarray(hv), state)
        return state, xs, res

    jstate = jax_learner.init_state(jcfg, len(hu))
    tstate = state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()
         if v is not None}, cfg, "cpu")
    tho = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                         split.heldout_u, split.heldout_v, "cpu")
    for i in range(EVALS):
        jstate, xs, jres = jax_interval(jstate,
                                        jax.random.PRNGKey(200 + i))
        assert xs[1].shape[1:] == (cfg.max_batch_nodes, 8)   # private
        tstate = learner.run_hoisted(cfg, tstate,
                                     to_torch(xs, learner.DeviceBatch))
        tstate, tres = learner.heldout_perplexity_step(
            cfg, tho, torch.from_numpy(hu), torch.from_numpy(hv), tstate)
        assert tstate.step_count == int(jstate.step_count)
        for f in ("pi", "phi_sum", "theta", "beta"):
            assert_close(getattr(tstate, f), getattr(jstate, f), 5e-5,
                         1e-8, f"interval {i}: {f}")
        assert_close(torch.exp(tres.neg_avg_log),
                     np.exp(np.asarray(jres.neg_avg_log)), 1e-5, 0.0,
                     f"interval {i}: ppx")


@pytest.mark.cuda
def test_phi_kernel_matches_plain_on_gpu():
    """On a GPU: both entries against the plain versions at the main
    path's shape (rtol 1e-5, atol 1e-8 normwise, as chip_smoke.py
    checks them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    case = testing.phi_case(0, 33, 32, 256)
    cfg = testing.phi_case_config(case)
    t = {f: torch.as_tensor(case[f], device="cuda") for f in
         ("pi", "phi_sum", "beta", "nodes", "nbrs", "y", "noise")}
    args = (t["pi"], t["phi_sum"], t["beta"], t["nodes"], t["nbrs"], t["y"],
            case["step_count"], t["noise"])
    got = phi_pallas.phi_update_rows_cuda(cfg, *args)
    want = phi_pallas.phi_update_rows_torch(cfg, *args)
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-8 + 1e-5 * float(b.abs().max())
