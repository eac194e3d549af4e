"""Model / runtime configuration.

A copy of ``mcmc_ammsb_tpu/config.py`` with the same fields and
defaults (tests/test_torch_ops.py asserts that the two dataclasses
agree). It is copied rather than imported because importing anything
from ``mcmc_ammsb_tpu`` runs its ``__init__``, which imports the JAX
learner, and the GPU machine has no JAX.

Mirrors the hyperparameter surface of the reference ``Config`` struct
(reference mcmc/config.h:25-102) and its CLI flags
(reference main.cc:43-81), with GPU-specific knobs (workgroup sizes,
vector widths, shared-memory placement) replaced by their TPU analogs
(tile sizes, implementation selection, scan fusion depth).

Where the reference freezes hyperparameters into kernels as ``-D`` compile
flags (reference mcmc/config.cc:66-83), we close over a frozen
``Config`` at ``jit`` trace time — the XLA equivalent of compile-time
constants.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class SampleStrategy(enum.Enum):
    """Minibatch sampling strategies (reference mcmc/sample.h:94-123)."""

    NODE_LINK = "NodeLink"
    NODE_NON_LINK = "NodeNonLink"
    NODE = "Node"
    BF_LINK = "BFLink"
    BF_NON_LINK = "BFNonLink"
    BF = "BF"

    @classmethod
    def parse(cls, token: str) -> "SampleStrategy":
        for s in cls:
            if s.value.lower() == token.lower():
                return s
        raise ValueError(f"Invalid SampleStrategy: {token!r}")


class PhiImpl(enum.Enum):
    """Implementation of the phi updater.

    The TPU analog of the reference's four codegen modes
    (PHI_NODE_PER_THREAD / WG_NAIVE / WG_SHARED / WG_GEN,
    reference mcmc/config.h:14-19): same math, different schedules,
    cross-checked by golden equivalence tests.
    """

    JNP = "jnp"          # pure XLA (gathers + fused elementwise)
    PALLAS = "pallas"    # hand-written Pallas kernel, streams neighbors


class EdgeSetBackend(enum.Enum):
    """Device edge-membership structure."""

    CSR = "csr"          # binary search inside the node's sorted CSR row
    SORTED = "sorted"    # lexicographic binary search over all sorted edges
    CUCKOO = "cuckoo"    # reference cuckoo layout (2 buckets x 4 slots)
    PERFECT = "perfect"  # CHD perfect hash: 2 dependent gathers per query
    ADJACENCY = "adjacency"  # padded [N, max_deg] row matrix: one row
    #                          gather + VPU compare per query GROUP —
    #                          fastest when max_deg is moderate
    AUTO = "auto"        # adjacency when its matrix fits the budget,
    #                      else perfect (resolved at build time)


class RngBackend(enum.Enum):
    NATIVE = "native"        # jax.random (threefry); default
    REFERENCE = "reference"  # bit-exact xorshift128+/Ziggurat/Marsaglia-Tsang


@dataclasses.dataclass(frozen=True)
class Config:
    """All hyperparameters. Frozen: hashable, usable as a jit static arg.

    Defaults follow reference mcmc/config.h:70-101 and
    reference main.cc:50-76.
    """

    # --- model hyperparameters -------------------------------------------
    K: int = 32                      # number of latent communities
    alpha: float = 0.0               # Dirichlet prior on pi; 0 -> 1/K (main.cc:153)
    epsilon: float = 1e-7            # background edge probability
    eta0: float = 1.0                # Gamma prior shape on theta
    eta1: float = 1.0                # Gamma prior scale on theta
    # SGRLD step size schedule eps_t = a * (1 + t/b)^(-c)
    # (reference mcmc/learner.cc:41-43)
    a: float = 0.0315
    b: float = 1024.0
    c: float = 0.5

    # --- sampling --------------------------------------------------------
    mini_batch_size: int = 32        # m
    num_node_sample: int = 32        # n: neighbors drawn per minibatch node
    strategy: SampleStrategy = SampleStrategy.NODE
    heldout_ratio: float = 0.01

    # --- dataset geometry (filled in by `finalize`) ----------------------
    N: int = 0                       # number of nodes
    E: int = 0                       # number of unique undirected edges
    max_fan_out: int = 0             # max degree in the training graph

    # --- evaluation ------------------------------------------------------
    ppx_interval: int = 100
    # training-perplexity estimator (MCMC_CALC_TRAIN_PPX parity,
    # reference mcmc/learner.cc:47-75): ratio of training edges
    # plus a proportional count of sampled non-links
    calc_train_ppx: bool = False
    training_ppx_ratio: float = 0.01

    # --- seeds (reference: main.cc:68-70) --------------------------------
    phi_seed: Tuple[int, int] = (42, 43)
    beta_seed: Tuple[int, int] = (44, 45)
    neighbor_seed: Tuple[int, int] = (56, 57)
    sample_seed: int = 0             # host minibatch sampler seed
    init_seed: int = 6342455113      # theta/pi init (learner.cc:150)
    # theta init bit stream: "native" draws from this repo's counter
    # RNG (distribution + stream discipline parity); "libstdc++" runs
    # the reference's EXACT host stream — std::mt19937(init_seed,
    # 32-bit-truncated exactly like the reference's constructor call)
    # driving std::gamma_distribution<float> via the native C library
    # (csrc ref_theta_init; raises if the library is unavailable).
    # Closes the documented theta-init deviation (PARITY.md) for
    # cross-implementation trajectory comparison from step 0.
    theta_init: str = "native"       # native | libstdc++

    # --- numerics / testing ----------------------------------------------
    phi_disable_noise: bool = False  # golden-test mode (config.h:57)

    # --- TPU runtime knobs (replace GPU wg/vector knobs) -----------------
    phi_impl: PhiImpl = PhiImpl.JNP
    edgeset_backend: EdgeSetBackend = EdgeSetBackend.AUTO
    rng_backend: RngBackend = RngBackend.NATIVE
    ref_rng_block: bool = True
    # With rng_backend=reference, decode the bit-exact streams through
    # the block decoder (rng/refblock.py: one xorshift word buffer per
    # stage, rejection chains resolved by pointer doubling) instead of
    # the faithful per-draw lax.while_loop regions. Values, order and
    # stream positions are BIT-identical (tests/test_refblock.py pins
    # exact equality incl. forced refills); the loop form survives only
    # as the cross-check oracle. False = faithful loops.
    steps_per_call: int = 1          # lax.scan fusion depth of the run loop
    scan_unroll: int = 4             # lax.scan unroll factor (per-step
                                     # control overhead vs binary size)
    device_sampling: bool = False    # sample minibatches on-device inside scan
    shared_neighbors: bool = False
    # ONE shared n-neighbor draw per step instead of a draw per
    # minibatch node. Cuts the dominant per-step cost (pi row gathers
    # are row-COUNT-bound, docs/design.md) from B*n to n rows.
    # Statistical validity: the shared set is drawn independently of
    # every node, so each node's phi gradient stays an unbiased
    # n-sample estimate of its true gradient (exactly as with private
    # draws); sharing only correlates DIFFERENT nodes' same-step
    # estimates, the same kind of within-step correlation the edge
    # minibatch itself already induces (one pivot's edges drive the
    # whole beta gradient, sample.cc:253-268). Self-collisions
    # (neighbor == node, prob ~n/N) are masked with the per-node
    # count-aware scale. Requires rng_backend=native, phi_impl=jnp.
    node_coin: str = "random"        # random | alternate
    # How the Node (and device-sampled BF) strategy picks link vs
    # non-link each step
    # (sample.cc:295-302 flips an RNG coin). 'random' reproduces the
    # reference exactly — but the static-shape device sampler must
    # then compute BOTH candidate draws for every step and select
    # (ops/device_sampling.py), so sampling costs 2x. 'alternate'
    # strictly alternates link/non-link per step: each sampler runs at
    # HALF volume, the link/non-link marginal is exactly 1/2 (a
    # stratified — strictly lower-variance — version of the coin),
    # and the gradient estimator stays unbiased because each step's
    # draw is still independent of the state. Device sampling only.
    ds_link_rounds: int = 2          # device NodeLink pivot redraw rounds
    ds_nonlink_rounds: int = 1       # device NodeNonLink lane redraw rounds
    # The host/reference samplers retry until the draw is clean
    # (sample.cc:253-293, unbounded); the static-shape device samplers
    # replace that with a fixed number of masked redraw rounds and an
    # unbiased count-aware reweight of any residual bad lanes
    # (ops/device_sampling.py). Each NodeNonLink round re-runs the
    # full candidate check (2 edge-set membership passes + the [m,m]
    # dup test) — at reference shapes that check IS most of the
    # device-sampling cost (DS_NONLINK, docs/design.md round 3), while
    # the per-lane bad probability is ~(deg_avg + m/2)/N ~ 1e-4, so
    # one round already drives the residual mask rate below 1e-8.
    # Defaults (2 link / 1 non-link) are statistically indistinguishable
    # from the reference's exhaustive retry; raise them to reproduce
    # earlier-round trajectories (6/4) or for pathologically dense
    # graphs (the masked-lane reweight keeps the estimator unbiased at
    # ANY residual rate either way: weight * m_eff == 2E exactly).
    ds_link_cap: int = 0             # device NodeLink degree cap (0 = off)
    # Degree-capped NodeLink draws for HEAVY-TAILED graphs (device
    # sampling only). The reference's NodeLink returns EVERY edge of
    # the pivot (sample.cc:253-268), so static device buffers must be
    # sized by the graph's max degree — on LiveJournal-shaped data
    # (max degree ~14.8k) every step would gather/scatter ~14.8k rows
    # to process an average-degree (~17) pivot. With ds_link_cap=c:
    # pivots whose full edge list fits the buffer keep the exact
    # reference batch (weight N); hubs instead contribute
    # max_batch_edges uniform with-replacement draws from their row,
    # deduped keep-first, with the Horvitz-Thompson reweight
    # N / (1 - (1 - 1/d)^draws) so the beta gradient estimator stays
    # exactly unbiased (each distinct edge is included with
    # probability p = 1-(1-1/d)^draws and contributes f(e) * N/p).
    # Statistical deviation: hub-neighbor phi updates happen at rate
    # p < 1 per pivot draw (same class as the masked non-link
    # residuals); beta is unbiased at any cap. Buffers shrink from
    # max(m, max_fan_out) to max(m, min(max_fan_out, c)) edges.
    ds_bf_rounds: int = 4            # device BF expansion rounds
    ds_bf_pops: int = 8              # device BF queue pops per round
    # Device-sampled breadth-first family (ops/device_sampling.py
    # _sample_bf_*): the host's FIFO queue expansion (sample.cc:177-248
    # / sampling.py _bf_link/_bf_non_link) becomes ds_bf_rounds rounds
    # that each pop (up to) ds_bf_pops queue entries and expand them in
    # parallel. Pops always advance head to at most the round-start
    # tail, so the edge stream order is EXACTLY the host's FIFO order;
    # the only deviation is the bounded total expansion budget
    # 1 + (rounds-1)*pops (the host expands until it holds m edges) —
    # steps whose stream runs dry keep m_eff < m edges, masked and
    # reweighted by weight*m_eff == (the strategy's numerator) exactly
    # like the NodeNonLink residuals. Defaults cover m=32 on
    # mean-degree >= 2 graphs with ~1e-3 shortfall rates; raise rounds
    # for sparser graphs.
    node_tile: int = 8               # Pallas: minibatch nodes per block
    # T-step WINDOWED fused loop (ops/window.py): the scan advances T
    # steps per iteration — ONE bulk pi-row gather, ONE Pallas
    # mega-kernel running the T sequential phi/beta updates entirely
    # in VMEM (collapsing the ~13 XLA per-op dispatch overheads that
    # bound the 15 us step, docs/design.md "the step is bound by ~13
    # per-op overheads"), ONE last-write-wins scatter. Intra-window
    # read-after-write collisions are redirected to the staged rows
    # INSIDE the kernel via exact one-hot (0/1-coefficient) selects —
    # see window_correction below; with the default "always" there is
    # no cond in the program and every window runs the corrected
    # kernel, so trajectories match the sequential scan up to float
    # reduction order. 0 disables. Requires shared_neighbors + device
    # native RNG + jnp phi + fp32 pi.
    window: int = 0
    window_impl: str = "pallas"      # pallas | jnp (golden reference)
    window_correction: str = "always"
    # always (default): every window runs the corrected kernel — no
    #       cond in the program (the correction is an exact 0/1
    #       select; measured FASTER than the cond at every T: the
    #       two-branch conditional costs more in scheduling than the
    #       correction matmuls save, docs/design.md round 3);
    # auto: lax.cond picks the corrected kernel only for windows with
    #       intra-window collisions (the predicate is a hoisted
    #       integer compare; kept as the measured-slower variant).
    #       The port accepts it and runs "always" (the same bits).
    # pi STORAGE precision. Compute stays fp32 everywhere (gathered
    # rows are upcast before the SGRLD math; staged rows are written
    # back at storage precision). "bfloat16" halves the pi HBM
    # footprint — the CAPACITY lever for large K (5.2 -> 2.6 GB at
    # K=4096; headroom for K=8192 on one chip). Speed: measured a
    # uniform 1.06x at K=1024/2048/4096 — the large-K wall is the
    # scatter LOWERING (same cost both precisions) and noise
    # generation, not row bytes (docs/design.md "post-factorization K
    # ladder"). At K<=512 gathers are row-COUNT-bound and bf16 buys
    # nothing. Opt-in: ~0.4% relative quantization on stored
    # memberships is a semantic deviation from the reference's fp32
    # state (convergence contract: test_bf16_pi.py).
    pi_dtype: str = "float32"        # float32 | bfloat16
    host_sampler: str = "auto"       # auto | native (C++) | numpy
    # --- full-MMSB (models/mmsb.py) identifiability knobs ----------------
    # The full [K,K] block matrix lacks the a-MMSB's epsilon background
    # that hardwires assortativity, so weakly-identified data admits a
    # label-symmetric plateau (module docstring). Standard escape levers:
    mmsb_prior_diag: Optional[Tuple[float, float]] = None
    # per-cell prior: (eta0, eta1) for DIAGONAL theta_B cells (off-
    # diagonal cells keep eta0/eta1) — an informative assortative prior
    mmsb_noise_scale: float = 1.0
    # SGRLD noise temperature multiplier (<1 tempers the chain toward
    # optimization; 1 = exact posterior sampling). Longer step-size
    # decay is already expressible through a/b/c.
    # Explicit batch-capacity overrides (0 = derive from m / max_fan_out).
    # The sharded learner rounds capacities up to mesh multiples.
    batch_edges_cap: int = 0
    batch_nodes_cap: int = 0

    # --- derived static batch shapes -------------------------------------
    @property
    def alpha_value(self) -> float:
        return self.alpha if self.alpha != 0.0 else 1.0 / self.K

    @property
    def effective_fan_out(self) -> int:
        """Max edges a device NodeLink batch can hold: the graph's max
        degree, or ``ds_link_cap`` when the degree-capped sampler is on
        (hub rows are subsampled + HT-reweighted instead of stored)."""
        if self.ds_link_cap and self.device_sampling:
            return min(max(self.max_fan_out, 1), self.ds_link_cap)
        return self.max_fan_out

    @property
    def max_batch_edges(self) -> int:
        """Device edge-buffer capacity.

        NodeLink returns every edge of one node, so the buffer must hold
        max(m, max_fan_out) edges (reference mcmc/sample.cc:129) —
        max(m, ds_link_cap) under the degree-capped device sampler.
        """
        if self.batch_edges_cap:
            return self.batch_edges_cap
        return max(self.mini_batch_size, max(self.effective_fan_out, 1))

    @property
    def max_batch_nodes(self) -> int:
        """Node-buffer capacity: max(2m, max_fan_out + 1)
        (reference mcmc/sample.cc:130-131).

        Device-sampled Node-family batches are tighter: every edge of
        a NodeLink draw shares its pivot (nodes <= max_fan_out + 1)
        and a NodeNonLink draw is one pivot + m partners (nodes <=
        m + 1), so the dedup prefix never exceeds
        max(m, max_fan_out) + 1. The general 2m bound would spend
        ~half the per-step scatter/gather rows on sentinel padding at
        the reference shape (m=32, fan_out~24: 64 lanes for <=33
        valid) — and scatter cost is per-ROW-marginal (~88 ns/row on
        multi-GB arrays, docs/design.md), so padded lanes cost full
        price."""
        if self.batch_nodes_cap:
            return self.batch_nodes_cap
        if self.device_sampling and self.strategy in (
                SampleStrategy.NODE, SampleStrategy.NODE_LINK,
                SampleStrategy.NODE_NON_LINK):
            return max(self.mini_batch_size, self.effective_fan_out) + 1
        return max(2 * self.mini_batch_size, self.max_fan_out + 1)

    def finalize(self, N: int, E: int, max_fan_out: int) -> "Config":
        """Bind dataset geometry; resolve alpha=0 -> 1/K."""
        if self.num_node_sample >= N:
            raise ValueError(
                f"num_node_sample={self.num_node_sample} must be < N={N} "
                "(cannot draw that many distinct neighbors)")
        if self.ds_link_rounds < 0 or self.ds_nonlink_rounds < 0:
            raise ValueError("ds_link_rounds/ds_nonlink_rounds must be "
                             ">= 0 (0 = single draw, residuals masked)")
        if self.ds_bf_rounds < 1 or self.ds_bf_pops < 1:
            raise ValueError("ds_bf_rounds and ds_bf_pops must be >= 1")
        if self.node_coin not in ("random", "alternate"):
            raise ValueError(f"unknown node_coin {self.node_coin!r} "
                             "(random | alternate)")
        if self.theta_init not in ("native", "libstdc++"):
            raise ValueError(f"unknown theta_init {self.theta_init!r} "
                             "(native | libstdc++)")
        if self.node_coin == "alternate" and not self.device_sampling:
            raise ValueError(
                "node_coin='alternate' is a device-sampling lever (the "
                "host samplers draw the reference's RNG coin); enable "
                "device_sampling or use node_coin='random'")
        if self.ds_link_cap < 0:
            raise ValueError("ds_link_cap must be >= 0 (0 = off)")
        if self.ds_link_cap and not self.device_sampling:
            raise ValueError(
                "ds_link_cap is a device-sampling lever (the host "
                "samplers return full CSR rows); enable device_sampling "
                "or drop the cap")
        if self.device_sampling and self.strategy in (
                SampleStrategy.NODE, SampleStrategy.NODE_LINK,
                SampleStrategy.NODE_NON_LINK):
            eff = int(max_fan_out)
            if self.ds_link_cap:
                eff = min(max(eff, 1), self.ds_link_cap)
            derived_nodes = max(self.mini_batch_size, eff) + 1
        else:
            derived_nodes = max(2 * self.mini_batch_size,
                                int(max_fan_out) + 1)
        if self.batch_nodes_cap and self.batch_nodes_cap < derived_nodes:
            # The fused loop's edge-lane maps assume every unmasked
            # edge endpoint appears in the deduped node list; a cap
            # below the derived minimum could truncate the unique
            # prefix, silently mapping missing endpoints to lane 0 and
            # corrupting beta gradients (learner.py edge_lanes).
            raise ValueError(
                f"batch_nodes_cap={self.batch_nodes_cap} is below the "
                f"derived minimum max(2m, max_fan_out+1)={derived_nodes}; "
                "a NodeLink minibatch's endpoints would not fit the "
                "deduped node buffer")
        return dataclasses.replace(
            self,
            N=int(N),
            E=int(E),
            max_fan_out=int(max_fan_out),
            alpha=self.alpha if self.alpha != 0.0 else 1.0 / self.K,
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def eps_t(self, step_count) -> float:
        """Step-size schedule a*(1 + t/b)^(-c) (learner.cc:41-43).

        Works for Python ints and traced arrays alike.
        """
        return self.a * (1.0 + step_count / self.b) ** (-self.c)
