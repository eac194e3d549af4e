"""The yardstick's arithmetic: the card's peaks, and the bytes and
float32 operations that a window of T steps and a whole step need.

Every count is a function of the shape alone: T steps, B node lanes,
E edge lanes, n shared neighbors, K communities, the bytes of one
stored pi value, and for the evaluation H population pairs every
``interval`` steps. Each input byte is counted once and each output byte
once, whatever implements the window. B and E are the lanes that a step
fills on average (the run takes them from the masks of the steps it
checks), not the buffers' capacity: the rows, noise and operands of an
empty lane are no work that a step needs, and a program that skips them
does not read as nearer its roofline for it.
"""

from __future__ import annotations

from dataclasses import dataclass

#: NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s and float32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


@dataclass(frozen=True)
class Shape:
    T: int              # steps per window
    B: float            # node lanes a step fills, on average
    E: float            # edge lanes a step fills, on average
    n: int              # shared neighbors per step
    K: int
    pi_bytes: int       # 4 (float32) or 2 (bfloat16)
    H: int              # evaluation pairs
    interval: int       # steps per evaluation


def edge_lanes(m: int, fan_out: int, link_cap: int) -> int:
    """A step's edge lanes as the device sampler sizes them: m, or a
    NodeLink draw's largest row (the degree, capped at ``link_cap`` when
    that is set); the node lanes are one more."""
    return max(m, min(fan_out, link_cap) if link_cap else fan_out)


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def window_bytes(s: Shape) -> int:
    """One window: read T(B + n) pi rows and T B row sums, every operand
    once (membership labels, ids, masks, lane maps, correction codes and
    the keep mask as the program holds them, the phi noise [T, B, K] and
    the theta noise [T, K, 2] in float32, the weights), theta and beta;
    write T B rows and sums, theta and beta."""
    t, b, e, n, k = s.T, s.B, s.E, s.n, s.K
    rows_read = t * (b + n) * k * s.pi_bytes + t * b * 4
    rows_written = t * b * k * s.pi_bytes + t * b * 4
    operands = (t * b * n                 # y_phi, bool
                + t * b * 4 + t * b       # nodes, node mask
                + t * n * 4               # shared neighbors
                + t * b * k * 4           # phi noise
                + t * k * 2 * 4           # theta noise
                + t * e * (1 + 1 + 4 + 4)  # y_edges, edge mask, two lane maps
                + t * (b + n) * 4         # correction codes
                + t * b                   # last-write-wins mask
                + t * 4)                  # weights
    state = 2 * (k * 2 * 4 + k * 4)      # theta and beta, read and written
    return rows_read + rows_written + operands + state


def step_flops(s: Shape) -> int:
    """One step's float32 operations: per node lane 4 n K for the two
    contractions, ~15 K for the phi step and its normalization, ~8 n for
    the per-neighbor terms; per edge lane ~14 K for the edge sums and
    the gradient fan-in; ~20 K for the theta step."""
    b, e, n, k = s.B, s.E, s.n, s.K
    return 4 * b * n * k + 15 * b * k + 8 * b * n + 14 * e * k + 20 * k


def window_least_seconds(s: Shape) -> float:
    return least_seconds(window_bytes(s), s.T * step_flops(s))


def eval_bytes(s: Shape) -> int:
    """One held-out evaluation: two rows of every pair, its ids and
    running average read, the average written."""
    return s.H * (2 * s.K * s.pi_bytes + 2 * 4 + 2 * 4)


def eval_flops(s: Shape) -> int:
    """~6 K per pair: the product, its three sums and the mix."""
    return 6 * s.H * s.K


def step_bytes(s: Shape) -> float:
    """One step's HBM traffic on average, as the port's bench.py counts
    a step's rows (gather B + n pi rows, scatter B, the B rows of phi
    noise in float32), plus its share of the evaluation."""
    rows = (s.B + s.n + s.B) * s.K * s.pi_bytes + s.B * s.K * 4
    return rows + eval_bytes(s) / s.interval


def step_least_seconds(s: Shape) -> float:
    return least_seconds(step_bytes(s),
                         step_flops(s) + eval_flops(s) / s.interval)
