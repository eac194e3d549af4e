"""Reference-format checkpoints (counterpart of ``mcmc_ammsb_tpu/refckpt.py``):
read, and write, the reference implementation's length-prefixed protobuf
checkpoints, byte for byte as the JAX package does.

Each message rides as a native-endian uint64 byte count followed by the
protobuf payload (the reference's serialize.h), in the stream order of
its Learner::Serialize:

    VectorStorage beta [2K] f32      (beta-of-k lives at [2k+1])
    VectorStorage theta [2K] f32     (interleaved (k,0),(k,1) pairs)
    RpmProperties + one VectorStorage per pi row block
    VectorStorage phi [N] f32
    phiUpdater:  VectorStorage rng seeds (ulong2 LE) + PhiProperties
    betaUpdater: VectorStorage rng seeds + VectorStorage theta_sum [K]
                 + BetaProperties
    [trainingPerplexity, only with MCMC_CALC_TRAIN_PPX]
    heldoutPerplexity: PerplexityProperties + VectorStorage
                 ppx_per_edge [H]
    LearnerProperties
    samples[0] (+ samples[1] with MCMC_SAMPLE_PARALLEL):
                 SampleStorage + dev_edges + dev_nodes +
                 neighbor sampler rng + hash data

The protobuf messages are simple enough that this module carries its own
minimal wire-format codec (pure numpy): no protoc, no generated code.
``read_reference_checkpoint`` and ``write_reference_checkpoint`` work on
numpy arrays; ``to_train_state`` and ``export_reference_checkpoint`` map
the port's ``TrainState`` (torch tensors on any device) to and from
them. The files are the JAX package's: each package reads the other's,
and for the same state, config, graph and split the two exports are the
same bytes.

Mapping into TrainState (learner.py):
    theta[k, c]   = theta_ref[2k + c]
    beta[k]       = beta_ref[2k + 1]
    pi            = concatenated RPM blocks, reshaped [N, K] (cast to the
                    storage dtype; a bf16 state is written upcast, which
                    is lossless)
    phi_sum       = phi_ref [N]
    ppx_per_edge / ppx_count, step_count, beta_count as counted.
RNG seed buffers are returned both raw (ulong2 little-endian bytes) and
split into the uint32 [S, 4] = (x_hi, x_lo, y_hi, y_lo) layout of the
JAX package (the port's ``rng/reference.py`` holds the same words in
int64 lanes).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Minimal protobuf wire codec (proto2; the messages use only varint,
# 64-bit, and length-delimited fields)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _write_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def parse_fields(buf: bytes) -> Dict[int, List]:
    """Decode a message into {field_number: [values]}; bytes for
    length-delimited, int for varint, float for 64-bit (double)."""
    fields: Dict[int, List] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _field(tag: int, wire: int) -> bytes:
    return _write_varint(tag << 3 | wire)


def encode_bytes(tag: int, payload: bytes) -> bytes:
    return _field(tag, 2) + _write_varint(len(payload)) + payload


def encode_varint(tag: int, x: int) -> bytes:
    return _field(tag, 0) + _write_varint(int(x))


def encode_double(tag: int, x: float) -> bytes:
    return _field(tag, 1) + struct.pack("<d", float(x))


# ---------------------------------------------------------------------------
# Length-prefixed stream (SerializeMessage / ParseMessage)
# ---------------------------------------------------------------------------


def read_message(f) -> bytes:
    hdr = f.read(8)
    if len(hdr) < 8:
        raise EOFError("truncated checkpoint (message header)")
    (n,) = struct.unpack("<Q", hdr)
    buf = f.read(n)
    if len(buf) < n:
        raise EOFError("truncated checkpoint (message body)")
    return buf


def write_message(f, payload: bytes) -> None:
    f.write(struct.pack("<Q", len(payload)))
    f.write(payload)


def _read_vector(f, dtype) -> np.ndarray:
    fields = parse_fields(read_message(f))
    return np.frombuffer(fields[1][0], dtype=dtype).copy()


def _write_vector(f, arr: np.ndarray) -> None:
    write_message(f, encode_bytes(1, np.ascontiguousarray(arr).tobytes()))


def _seeds_to_u32(raw: np.ndarray) -> np.ndarray:
    """ulong2 LE buffer -> this repo's uint32 [S, 4]
    (x_hi, x_lo, y_hi, y_lo) layout (rng/reference.py)."""
    u64 = raw.view(np.uint64).reshape(-1, 2)
    out = np.empty((u64.shape[0], 4), np.uint32)
    out[:, 0] = (u64[:, 0] >> np.uint64(32)).astype(np.uint32)
    out[:, 1] = (u64[:, 0] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 2] = (u64[:, 1] >> np.uint64(32)).astype(np.uint32)
    out[:, 3] = (u64[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def read_reference_checkpoint(path: str,
                              with_train_ppx: bool = False) -> dict:
    """Parse a reference-format checkpoint into numpy arrays +
    counters. Reads through LearnerProperties; the trailing Sample
    sections (in-flight minibatch buffers) are returned as raw message
    payloads without interpretation."""
    out: dict = {}
    with open(path, "rb") as f:
        beta2k = _read_vector(f, np.float32)
        theta2k = _read_vector(f, np.float32)

        rpm = parse_fields(read_message(f))
        rows, cols = rpm[1][0], rpm[2][0]
        rows_in_block = rpm[3][0]
        n_blocks = -(-rows // rows_in_block)
        blocks = [_read_vector(f, np.float32) for _ in range(n_blocks)]
        pi = np.concatenate(blocks).reshape(rows, cols)

        phi = _read_vector(f, np.float32)

        phi_seeds_raw = _read_vector(f, np.uint8)
        phi_props = parse_fields(read_message(f))

        beta_seeds_raw = _read_vector(f, np.uint8)
        theta_sum = _read_vector(f, np.float32)
        beta_props = parse_fields(read_message(f))

        if with_train_ppx:
            tprops = parse_fields(read_message(f))
            out["train_ppx_count"] = tprops[1][0]
            out["train_ppx_per_edge"] = _read_vector(f, np.float32)

        hprops = parse_fields(read_message(f))
        ppx_per_edge = _read_vector(f, np.float32)

        lprops = parse_fields(read_message(f))

        trailing = []
        while True:
            try:
                trailing.append(read_message(f))
            except EOFError:
                break

    k = len(beta2k) // 2
    out.update(
        beta=beta2k[1::2].copy(),              # beta-of-k = [2k+1]
        beta_interleaved=beta2k,
        theta=theta2k.reshape(k, 2).copy(),    # (k,0),(k,1) pairs
        pi=pi, phi_sum=phi,
        theta_sum=theta_sum,
        phi_seeds=_seeds_to_u32(phi_seeds_raw),
        beta_seeds=_seeds_to_u32(beta_seeds_raw),
        phi_count=phi_props[1][0],
        beta_count=beta_props[1][0],
        ppx_count=hprops[1][0],
        ppx_per_edge=ppx_per_edge,
        step_count=lprops[1][0],
        phase=lprops.get(4, [0])[0],
        weight=lprops.get(5, [0.0])[0],
        trailing_messages=trailing,
    )
    return out


def to_train_state(cfg, raw: dict, heldout_size: Optional[int] = None,
                   device="cuda", state=None):
    """Map a parsed reference checkpoint onto a TrainState on ``device``:
    the file's fields replace those of ``state``, by default a fresh
    ``learner.init_state`` (pass a learner's state to spare the init
    draws). The port's random streams stay where they are: the
    reference's xorshift states are importable through raw['phi_seeds']
    for runs on the reference backend whose lane count matches."""
    import torch

    from mcmc_ammsb_tpu_torch.learner import init_state, pi_storage_dtype

    h = (heldout_size if heldout_size is not None
         else len(raw["ppx_per_edge"]))
    if state is None:
        state = init_state(cfg, h, device)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, np.float32)).to(
            device=device, dtype=dtype)

    return state._replace(
        pi=t(raw["pi"], pi_storage_dtype(cfg)),
        phi_sum=t(raw["phi_sum"], torch.float32),
        theta=t(raw["theta"], torch.float32),
        beta=t(raw["beta"], torch.float32),
        step_count=int(raw["step_count"]),
        beta_count=int(raw["beta_count"]),
        ppx_per_edge=t(raw["ppx_per_edge"][:h], torch.float32),
        ppx_count=int(raw["ppx_count"]),
    )


# ---------------------------------------------------------------------------
# Target buffer geometry (what Learner::Parse byte-size-checks against)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReferenceLayout:
    """Exact buffer element counts the reference binary allocates —
    every ``::mcmc::Parse(in, buf)`` REQUIRES byte-size equality with
    the target buffer (serialize.h:62-69), so an export that doesn't
    reproduce these counts is rejected at load.

    Size laws (audited against the reference source):
      - batch_slots B = max(2*mini_batch_size, 1 + MaxFanOut)
        (sample.cc:86-99, phi.cc:616-629, learner.cc Sample ctor)
      - dev_edges  = max(mini_batch_size, MaxFanOut) Edges (u64)
        (sample.cc:129-131 Sample ctor)
      - dev_nodes  = B Vertices (u32)
      - phi rng    = B * (1 if PHI_NODE_PER_THREAD else phi_wg_size)
        seeds of 16 bytes (ulong2)          (phi.cc:624-629)
      - beta rng   = K seeds                 (beta.cc:250-252)
      - neighbor-sampler rng = B * 2*num_node_sample seeds
        (sample.cc:95-99: CreateRandom(B * capacity_), capacity_=2n)
      - neighbor-sampler data = B * num_node_sample Vertices (u32)
        (sample.cc:86-94)
      - ppx_per_edge = heldout edge count floats (perplexity.cc:194)
      - pi RPM rows_in_block must equal the TARGET device's
        RowsPerBlock (serialize.h:100-104); the CUDA build computes
        512 MiB / (K * 4) (partitioned-alloc.h:125-131), OpenCL uses
        the device MaxAllocSize — override via ``rows_in_block`` when
        targeting an OpenCL device.

    Build-flag layout switches (CMakeLists.txt:41-42):
      - train_ppx: MCMC_CALC_TRAIN_PPX (default OFF) inserts a
        trainingPerplexity section before heldout (learner.cc:311-313)
      - sample_parallel: MCMC_SAMPLE_PARALLEL (default ON) appends
        samples_[1] after samples_[0] (learner.cc:326-329)
    """

    N: int
    K: int
    mini_batch_size: int
    num_node_sample: int
    max_fan_out: int
    heldout_size: int
    phi_wg_size: int = 32           # config.h:88 default
    phi_node_per_thread: bool = False  # default mode is WG (config.h:95)
    rows_in_block: int = 0          # 0 -> the CUDA 512 MiB law
    train_ppx: bool = False         # MCMC_CALC_TRAIN_PPX, default OFF
    sample_parallel: bool = True    # MCMC_SAMPLE_PARALLEL, default ON
    train_ppx_size: int = 0         # training-ppx population edges

    @property
    def batch_slots(self) -> int:
        return max(2 * self.mini_batch_size, 1 + self.max_fan_out)

    @property
    def dev_edges_len(self) -> int:
        return max(self.mini_batch_size, self.max_fan_out)

    @property
    def phi_seed_count(self) -> int:
        per_slot = 1 if self.phi_node_per_thread else self.phi_wg_size
        return self.batch_slots * per_slot

    @property
    def beta_seed_count(self) -> int:
        return self.K

    @property
    def ns_seed_count(self) -> int:
        return self.batch_slots * 2 * self.num_node_sample

    @property
    def ns_data_len(self) -> int:
        return self.batch_slots * self.num_node_sample

    @property
    def effective_rows_in_block(self) -> int:
        if self.rows_in_block:
            return self.rows_in_block
        return max(1, (512 * 1024 * 1024) // (self.K * 4))

    @property
    def num_samples(self) -> int:
        return 2 if self.sample_parallel else 1

    @classmethod
    def from_config(cls, cfg, heldout_size: int, *,
                    rows_in_block: int = 0,
                    train_ppx: Optional[bool] = None,
                    train_ppx_size: int = 0,
                    sample_parallel: bool = True,
                    phi_wg_size: int = 32,
                    phi_node_per_thread: bool = False
                    ) -> "ReferenceLayout":
        if train_ppx is None:
            train_ppx = bool(getattr(cfg, "calc_train_ppx", False))
        return cls(N=cfg.N, K=cfg.K,
                   mini_batch_size=cfg.mini_batch_size,
                   num_node_sample=cfg.num_node_sample,
                   max_fan_out=cfg.max_fan_out,
                   heldout_size=heldout_size,
                   phi_wg_size=phi_wg_size,
                   phi_node_per_thread=phi_node_per_thread,
                   rows_in_block=rows_in_block,
                   train_ppx=train_ppx,
                   train_ppx_size=train_ppx_size,
                   sample_parallel=sample_parallel)


def _law_fill_seeds(base_pair: Tuple[int, int], count: int,
                    live: Optional[np.ndarray] = None) -> np.ndarray:
    """Seed buffer sized to the reference's allocation: live stream
    positions occupy the leading lanes they correspond to; the rest
    carry the construction law seed_i = base + i (random.cc:30-41) —
    exactly the state the reference would hold for lanes its kernels
    haven't advanced."""
    from mcmc_ammsb_tpu_torch.rng import reference as ref

    out = ref.make_seeds(base_pair, count).numpy().astype(np.uint32)
    if live is not None:
        k = min(len(live), count)
        out = out.copy()
        out[:k] = np.asarray(live)[:k]
    return out


def _draw_neighbor_data(layout: ReferenceLayout, nodes: np.ndarray,
                        rng: np.random.RandomState) -> np.ndarray:
    """Fill the neighbor-sampler data buffer [B, n] the way the
    reference kernel leaves it (sample.cc:55-77): for each ACTIVE node
    slot, num_node_sample distinct uniform vertices != the node."""
    b, n = layout.batch_slots, layout.num_node_sample
    data = np.zeros((b, n), np.uint32)
    for i, node in enumerate(np.asarray(nodes, np.int64)):
        picked: set = set()
        while len(picked) < n:
            r = int(rng.randint(0, layout.N))
            if r != node:
                picked.add(r)
        data[i, :] = np.fromiter(picked, np.uint32, count=n)
    return data


def make_sample_section(layout: ReferenceLayout, *,
                        edges_u: np.ndarray, edges_v: np.ndarray,
                        nodes: np.ndarray, seed: int,
                        ns_seeds: np.ndarray,
                        rng: Optional[np.random.RandomState] = None
                        ) -> List[bytes]:
    """One Sample section as its ordered message payloads
    (sample.h:63-76 Serialize): SampleStorage, dev_edges, dev_nodes,
    neighbor-sampler rng seeds, neighbor-sampler data.

    The host-vector fields (SampleStorage) carry the ACTUAL in-flight
    minibatch — on resume the reference consumes samples_[phase_]
    directly (learner.cc:216-244: phiUpdater over nodes_vec.size()
    nodes, betaUpdater over edges.size() edges), so these must be a
    genuine minibatch, not placeholders. The device buffers carry the
    same edges/nodes in their leading slots (DoSample writes only the
    active prefix; trailing bytes are allocation garbage the updaters
    never index)."""
    rng = rng or np.random.RandomState(seed & 0x7FFFFFFF)
    eu = np.asarray(edges_u, np.uint64)
    ev = np.asarray(edges_v, np.uint64)
    lo, hi = np.minimum(eu, ev), np.maximum(eu, ev)
    # Edge = (u64 min(u,v) << 32 | max(u,v)) (types.h MakeEdge)
    packed = (lo << np.uint64(32)) | hi
    if len(packed) > layout.dev_edges_len:
        raise ValueError(
            f"in-flight minibatch has {len(packed)} edges; the "
            f"reference dev_edges buffer holds {layout.dev_edges_len} "
            "(learner.cc:185-187 would abort)")
    nodes = np.asarray(nodes, np.uint32)
    if len(nodes) > layout.batch_slots:
        raise ValueError(
            f"{len(nodes)} nodes exceed the reference dev_nodes "
            f"capacity {layout.batch_slots}")
    storage = (encode_bytes(1, packed.tobytes())
               + encode_bytes(2, nodes.tobytes())
               + encode_varint(3, int(seed) & 0xFFFFFFFF))
    dev_edges = np.zeros(layout.dev_edges_len, np.uint64)
    dev_edges[: len(packed)] = packed
    dev_nodes = np.zeros(layout.batch_slots, np.uint32)
    dev_nodes[: len(nodes)] = nodes
    ns_data = _draw_neighbor_data(layout, nodes, rng)
    return [
        storage,
        encode_bytes(1, dev_edges.tobytes()),
        encode_bytes(1, dev_nodes.tobytes()),
        encode_bytes(1, _u32_to_seeds(ns_seeds)),
        encode_bytes(1, ns_data.tobytes()),
    ]


# ---------------------------------------------------------------------------
# Writer (the --checkpoint-ref exporter: Learner::Serialize's twin)
# ---------------------------------------------------------------------------


def export_reference_checkpoint(path: str, cfg, state,
                                graph=None, split=None, *,
                                rows_in_block: int = 0,
                                sample_parallel: bool = True,
                                train_ppx: Optional[bool] = None,
                                phi_wg_size: int = 32,
                                phi_node_per_thread: bool = False,
                                heldout_size: Optional[int] = None,
                                train_ppx_size: Optional[int] = None
                                ) -> None:
    """Write the port's TrainState (torch tensors on any device) in the
    reference's OWN byte layout (the inverse of ``to_train_state``): a
    run trained here resumes under the reference binary (learner.cc:332-361
    Parse). For the same state, config, graph and split the bytes are the
    JAX package's export's. A sharded state is exported through
    ``export_learner``, which gathers it first.

    Every buffer is sized to the reference's allocation laws
    (``ReferenceLayout``) — Parse requires exact byte-size equality.
    With ``graph``/``split`` the in-flight Sample sections carry a
    genuine minibatch drawn by the host sampler (the reference
    consumes samples_[phase_] on its first resumed iteration); without
    them a uniform-random stand-in batch with the Node-strategy weight
    is written (tooling/tests only — structurally valid, one
    off-distribution step on resume).

    RNG seed buffers: beta streams export live when the REFERENCE
    backend is active (the K-lane layout matches beta.cc:250-252
    exactly). The default reference build runs phi in a WORKGROUP mode
    whose B*wg_size stream layout has no analog here, so phi seeds are
    written at the construction law (random.cc:30-41); with
    ``phi_node_per_thread=True`` (a -DMCMC_PHI_MODE override) the live
    per-node-lane streams export into the leading lanes. See
    PARITY.md's wg-mode caveat.
    """
    # sharded engines pad eval buffers to the data axis; the reference
    # allocates exactly its population sizes — slice to the true counts
    ppx_per_edge = _host(state.ppx_per_edge)
    heldout = (int(heldout_size) if heldout_size is not None
               else len(ppx_per_edge))
    ppx_per_edge = ppx_per_edge[:heldout]
    tp_size = 0
    if train_ppx is None:
        train_ppx = bool(getattr(cfg, "calc_train_ppx", False))
    train_ppx_per_edge = None
    if train_ppx:
        tpe = getattr(state, "train_ppx_per_edge", None)
        if tpe is None:
            raise ValueError("train_ppx layout requested but the state "
                             "has no train_ppx_per_edge buffer")
        train_ppx_per_edge = _host(tpe)
        if train_ppx_size is not None:
            train_ppx_per_edge = train_ppx_per_edge[:int(train_ppx_size)]
        tp_size = len(train_ppx_per_edge)
    layout = ReferenceLayout.from_config(
        cfg, heldout, rows_in_block=rows_in_block, train_ppx=train_ppx,
        train_ppx_size=tp_size, sample_parallel=sample_parallel,
        phi_wg_size=phi_wg_size,
        phi_node_per_thread=phi_node_per_thread)

    live = getattr(state, "ref_seeds", None)
    phi_seeds = _law_fill_seeds(
        cfg.phi_seed, layout.phi_seed_count,
        live=_seeds(live.phi) if (live is not None
                                  and phi_node_per_thread) else None)
    beta_seeds = _law_fill_seeds(
        cfg.beta_seed, layout.beta_seed_count,
        live=_seeds(live.beta) if live is not None else None)
    ns_seeds = _law_fill_seeds(cfg.neighbor_seed, layout.ns_seed_count)

    # in-flight minibatches: one consumed at resume (phase_) + one
    # overwritten by the restarted sampler pipeline (1-phase_)
    rng = np.random.RandomState((int(state.step_count) * 2654435761
                                 + cfg.sample_seed) & 0x7FFFFFFF)
    samples = []
    weight = 0.0
    for s in range(layout.num_samples):
        eu, ev, w = _draw_inflight_batch(cfg, graph, split, rng)
        nodes = _dedup_nodes(eu, ev)
        if s == 0:
            weight = float(w)   # LearnerProperties.weight feeds the
            # restored future for samples_[phase_] (learner.cc:306-315)
        samples.append(make_sample_section(
            layout, edges_u=eu, edges_v=ev, nodes=nodes,
            seed=int(rng.randint(0, 2**31)), ns_seeds=ns_seeds,
            rng=rng))

    write_reference_checkpoint(
        path,
        theta=_host(state.theta),
        beta=_host(state.beta),
        # sharded pi rows are padded to the mesh width; the reference
        # file stores exactly N (bf16 storage upcasts losslessly)
        pi=_host(state.pi[: cfg.N]),
        phi_sum=_host(state.phi_sum[: cfg.N]),
        ppx_per_edge=ppx_per_edge,
        train_ppx_per_edge=train_ppx_per_edge,
        train_ppx_count=int(getattr(state, "train_ppx_count", 0) or 0),
        phi_seeds=phi_seeds, beta_seeds=beta_seeds,
        rows_in_block=layout.effective_rows_in_block,
        step_count=int(state.step_count),
        beta_count=int(state.beta_count),
        phi_count=max(0, int(state.step_count) - 1),
        ppx_count=int(state.ppx_count),
        weight=weight,
        samples=samples,
    )


def _draw_inflight_batch(cfg, graph, split, rng):
    """A minibatch for the in-flight Sample sections: the real host
    sampler when graph/split are available, else a uniform stand-in."""
    if graph is not None and split is not None:
        from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler

        # _sample_raw draws with numpy alone: no native build is needed
        sampler = MiniBatchSampler(cfg.replace(host_sampler="numpy"), graph,
                                   split, seed=int(rng.randint(0, 2**31)))
        eu, ev, w = sampler._sample_raw()
        return np.asarray(eu), np.asarray(ev), float(w)
    m = cfg.mini_batch_size
    eu = rng.randint(0, cfg.N, size=m).astype(np.int64)
    ev = (eu + 1 + rng.randint(0, cfg.N - 1, size=m)) % cfg.N
    return eu, ev, float(cfg.N) * (cfg.N - 1) / 2.0 / m


def _host(x) -> np.ndarray:
    """A state tensor as a float32 host array (bf16 upcast, losslessly)."""
    return x.detach().float().cpu().numpy()


def _seeds(x) -> np.ndarray:
    """The port's int64 [S, 4] seed words as the uint32 [S, 4] layout."""
    return x.detach().cpu().numpy().astype(np.uint32)


def export_learner(path: str, learner, graph, split, *,
                   rows_in_block: int = 0) -> None:
    """``export_reference_checkpoint`` of a learner's state at the true
    population sizes (the CLI's --checkpoint-ref). A sharded learner's
    export is collective: every rank of its mesh calls it, the split
    fields are gathered into the global state (``checkpoint._gather_field``)
    and rank 0 writes the file; a barrier follows."""
    import torch
    import torch.distributed as dist

    state, train_size = learner.state, None
    sharded = hasattr(learner, "shard_layout")
    if sharded:
        from mcmc_ammsb_tpu_torch.checkpoint import _gather_field

        state = state._replace(**{
            name: _gather_field(getattr(state, name), group)
            for name, (group, _) in learner.shard_layout().items()})
        mask = getattr(learner, "train_ppx_mask", None)
        if mask is not None:
            train_size = int(_gather_field(
                mask.to(torch.float32), learner.mesh.data_group).sum())
    if not sharded or dist.get_rank() == 0:
        export_reference_checkpoint(
            path, learner.cfg, state, graph, split,
            rows_in_block=rows_in_block,
            heldout_size=len(split.heldout_edges_u),
            train_ppx_size=train_size)
    if sharded:
        dist.barrier()


def _dedup_nodes(eu: np.ndarray, ev: np.ndarray) -> np.ndarray:
    """ExtractNodesFromMiniBatch (learner.cc:162-173): unique
    endpoints, order irrelevant to the reference (hash-set order)."""
    return np.unique(np.concatenate([np.asarray(eu), np.asarray(ev)]))


def _u32_to_seeds(seeds: np.ndarray) -> bytes:
    u64 = np.empty((len(seeds), 2), np.uint64)
    s = seeds.astype(np.uint64)
    u64[:, 0] = (s[:, 0] << np.uint64(32)) | s[:, 1]
    u64[:, 1] = (s[:, 2] << np.uint64(32)) | s[:, 3]
    return u64.tobytes()


def write_reference_checkpoint(
        path: str, *, theta: np.ndarray, beta: np.ndarray,
        pi: np.ndarray, phi_sum: np.ndarray,
        ppx_per_edge: np.ndarray,
        phi_seeds: np.ndarray, beta_seeds: np.ndarray,
        theta_sum: Optional[np.ndarray] = None,
        rows_in_block: Optional[int] = None,
        train_ppx_per_edge: Optional[np.ndarray] = None,
        train_ppx_count: int = 0,
        step_count: int = 1, beta_count: int = 0, phi_count: int = 0,
        ppx_count: int = 0, weight: float = 0.0,
        samples: Sequence[Sequence[bytes]] = ()) -> None:
    """Emit the reference's exact byte layout from this repo's state
    arrays (theta [K,2], beta [K], pi [N,K], phi_sum [N], seeds
    uint32 [S,4]). ``rows_in_block`` defaults to all rows in one
    block — callers targeting the actual binary must pass the target
    device's RowsPerBlock (Parse REJECTS any mismatch,
    serialize.h:100-104; ``ReferenceLayout.effective_rows_in_block``
    computes the CUDA-build default). ``samples`` holds the ordered
    message payloads of each Sample section (``make_sample_section``);
    ``train_ppx_per_edge`` switches on the MCMC_CALC_TRAIN_PPX
    section."""
    n, k = pi.shape
    theta2k = np.asarray(theta, np.float32).reshape(2 * k)
    beta2k = np.zeros(2 * k, np.float32)
    beta2k[1::2] = np.asarray(beta, np.float32)
    beta2k[0::2] = 1.0 - np.asarray(beta, np.float32)  # normalize pair
    rib = rows_in_block or n
    if theta_sum is None:
        theta_sum = np.asarray(theta, np.float32).sum(-1)
    with open(path, "wb") as f:
        _write_vector(f, beta2k)
        _write_vector(f, theta2k)
        write_message(f, encode_varint(1, n) + encode_varint(2, k)
                      + encode_varint(3, rib))
        for lo in range(0, n, rib):
            _write_vector(f, np.ascontiguousarray(
                pi[lo: lo + rib], np.float32))
        _write_vector(f, np.asarray(phi_sum, np.float32))
        # phi updater: rng seeds + props
        write_message(f, encode_bytes(1, _u32_to_seeds(phi_seeds)))
        write_message(f, encode_varint(1, phi_count)
                      + encode_double(2, 0.0) + encode_double(3, 0.0))
        # beta updater: rng seeds + theta_sum + props
        write_message(f, encode_bytes(1, _u32_to_seeds(beta_seeds)))
        _write_vector(f, np.asarray(theta_sum, np.float32))
        write_message(f, encode_varint(1, beta_count)
                      + b"".join(encode_double(t, 0.0)
                                 for t in (2, 3, 4, 5, 6)))
        if train_ppx_per_edge is not None:
            # trainingPerplexity_ (MCMC_CALC_TRAIN_PPX builds only,
            # learner.cc:311-313): props + per-edge running averages
            write_message(f, encode_varint(1, train_ppx_count)
                          + encode_double(2, 0.0) + encode_double(3, 0.0))
            _write_vector(f, np.asarray(train_ppx_per_edge, np.float32))
        # heldout perplexity: props + running averages
        write_message(f, encode_varint(1, ppx_count)
                      + encode_double(2, 0.0) + encode_double(3, 0.0))
        _write_vector(f, np.asarray(ppx_per_edge, np.float32))
        # learner properties
        write_message(f, encode_varint(1, step_count)
                      + encode_varint(2, 0) + encode_varint(3, 0)
                      + encode_varint(4, 0) + encode_double(5, weight))
        for section in samples:
            for msg in section:
                write_message(f, msg)


# ---------------------------------------------------------------------------
# Strict parse simulator (the reference binary's acceptance check)
# ---------------------------------------------------------------------------


class ReferenceParseError(ValueError):
    """The reference's Learner::Parse would reject this checkpoint."""


def simulate_reference_parse(path: str, layout: ReferenceLayout) -> dict:
    """Replay Learner::Parse (learner.cc:332-361) byte-for-byte against
    a target built with ``layout``'s geometry, enforcing every check
    the reference performs:

      - VectorStorage byte size MUST equal the target buffer's
        (serialize.h:62-69) for every buffer in the stream;
      - RpmProperties rows/cols/rows_in_block MUST equal the target
        RPM's (serialize.h:100-104), then one block message per
        rows_in_block stride with exact per-block sizes;
      - the full message sequence through LearnerProperties, the
        trainingPerplexity section iff MCMC_CALC_TRAIN_PPX, then
        samples_[0] (+ samples_[1] iff MCMC_SAMPLE_PARALLEL), each =
        SampleStorage + dev_edges + dev_nodes + neighbor-sampler rng
        + neighbor-sampler data (sample.h:78-92);
      - required proto2 fields present in every properties message;
      - clean EOF (a trailing message means a layout mismatch).

    Returns the parsed properties; raises ReferenceParseError on the
    first check the reference would fail.
    """
    def expect_vec(f, nbytes: int, what: str) -> bytes:
        try:
            fields = parse_fields(read_message(f))
        except EOFError as e:
            raise ReferenceParseError(f"{what}: stream truncated ({e})")
        if 1 not in fields:
            raise ReferenceParseError(f"{what}: not a VectorStorage")
        got = len(fields[1][0])
        if got != nbytes:
            raise ReferenceParseError(
                f"{what}: {got} bytes != target buffer {nbytes} "
                "(serialize.h:62-69 rejects)")
        return fields[1][0]

    def expect_props(f, required: Tuple[int, ...], what: str) -> dict:
        try:
            fields = parse_fields(read_message(f))
        except EOFError as e:
            raise ReferenceParseError(f"{what}: stream truncated ({e})")
        missing = [t for t in required if t not in fields]
        if missing:
            raise ReferenceParseError(
                f"{what}: missing required proto2 fields {missing}")
        return fields

    L = layout
    out: dict = {}
    with open(path, "rb") as f:
        expect_vec(f, 2 * L.K * 4, "beta [2K]")
        expect_vec(f, 2 * L.K * 4, "theta [2K]")
        rpm = expect_props(f, (1, 2, 3), "RpmProperties")
        rows, cols, rib = rpm[1][0], rpm[2][0], rpm[3][0]
        if rows != L.N or cols != L.K:
            raise ReferenceParseError(
                f"pi RPM {rows}x{cols} != target {L.N}x{L.K}")
        if rib != L.effective_rows_in_block:
            raise ReferenceParseError(
                f"rows_in_block {rib} != target device RowsPerBlock "
                f"{L.effective_rows_in_block} (serialize.h:100-104 "
                "rejects; pass --ref-rows-in-block for OpenCL targets)")
        for lo in range(0, rows, rib):
            block_rows = min(rib, rows - lo)
            expect_vec(f, block_rows * cols * 4, f"pi block @{lo}")
        expect_vec(f, L.N * 4, "phi [N]")
        expect_vec(f, L.phi_seed_count * 16, "phi rng seeds")
        out["phi_props"] = expect_props(f, (1, 2, 3), "PhiProperties")
        expect_vec(f, L.beta_seed_count * 16, "beta rng seeds")
        expect_vec(f, L.K * 4, "theta_sum [K]")
        out["beta_props"] = expect_props(f, (1, 2, 3, 4, 5, 6),
                                         "BetaProperties")
        if L.train_ppx:
            out["train_ppx_props"] = expect_props(
                f, (1, 2, 3), "train PerplexityProperties")
            expect_vec(f, L.train_ppx_size * 4, "train ppx_per_edge")
        out["heldout_props"] = expect_props(f, (1, 2, 3),
                                            "PerplexityProperties")
        expect_vec(f, L.heldout_size * 4, "heldout ppx_per_edge")
        out["learner_props"] = expect_props(f, (1, 2, 3, 4, 5),
                                            "LearnerProperties")
        for s in range(L.num_samples):
            st = expect_props(f, (1, 2, 3), f"SampleStorage[{s}]")
            if len(st[1][0]) % 8 or len(st[2][0]) % 4:
                raise ReferenceParseError(
                    f"SampleStorage[{s}]: ragged edges/nodes bytes")
            n_edges, n_nodes = len(st[1][0]) // 8, len(st[2][0]) // 4
            # not checked by Parse itself, but the first resumed
            # iteration aborts on over-capacity (learner.cc:185-191)
            # and launches zero-size kernels on empty — reject both
            if not (0 < n_edges <= L.dev_edges_len):
                raise ReferenceParseError(
                    f"samples[{s}]: {n_edges} in-flight edges "
                    f"(capacity {L.dev_edges_len}) — resume would "
                    "abort or run an empty step")
            if not (0 < n_nodes <= L.batch_slots):
                raise ReferenceParseError(
                    f"samples[{s}]: {n_nodes} in-flight nodes "
                    f"(capacity {L.batch_slots})")
            out[f"sample{s}_edges"] = n_edges
            out[f"sample{s}_nodes"] = n_nodes
            expect_vec(f, L.dev_edges_len * 8, f"dev_edges[{s}]")
            expect_vec(f, L.batch_slots * 4, f"dev_nodes[{s}]")
            expect_vec(f, L.ns_seed_count * 16,
                       f"neighbor sampler rng[{s}]")
            expect_vec(f, L.ns_data_len * 4,
                       f"neighbor sampler data[{s}]")
        trailing = f.read(1)
        if trailing:
            raise ReferenceParseError(
                "bytes remain after the final Sample section — the "
                "writer and the target build disagree on layout")
    return out
