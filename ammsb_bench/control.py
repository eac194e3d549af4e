"""The readings that the check's limits are set from, on many seeds in
one process (the benchmark's own runs never run this):

* ``program``: the program's numbers (the lower readings);
* ``control``: the reference at the precision below the configuration's
  (its ``control``: TF32 products and bfloat16 rows for float32, TF32
  products and float8 rows for bfloat16 rows) in the program's place,
  and each of its parts alone (``control.<part>``);
* planted faults in the program's place: ``unchanged`` (every chunk
  returns its state unchanged), ``half`` (half of each step's node and
  edge lanes left out, the edge sum scaled by two, a mean over the
  rest), ``fanin`` (theta's gradient fan-in dropped after each chunk's
  first window: the later theta updates take no gradient), ``answer``
  (one held-out pair's running average doubled where the evaluation
  produces it);
* ``float64``: the reference in float64 in the program's place, the
  witness of how far float32 rounding alone carries over a chunk.

    python3 -m ammsb_bench.control --workload <name> --seeds 1,2,3
        [--out control.jsonl]

Each seed runs the cell's set-up and its checked call (no window) and
prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

from ammsb_bench import check, reference as ref
from ammsb_bench.run import HERE, REPO, Cell, cell_spec, load_json


def half(d: ref.Draws) -> ref.Draws:
    """The draws with the second half of each step's node and edge lanes
    left out and the weight doubled."""
    b, e = d.nodes.shape[1], d.edges_u.shape[1]
    nm, em = d.node_mask.clone(), d.edge_mask.clone()
    nm[:, b // 2:] = False
    em[:, e // 2:] = False
    return dataclasses.replace(d, node_mask=nm, edge_mask=em,
                               weight=d.weight * 2.0)


def altered(ev: check.Evaluation) -> check.Evaluation:
    """The evaluation with its first pair's running average doubled and
    the perplexity that then follows."""
    avg = ev.avg.clone()
    avg[0] *= 2.0
    neg = -float(avg.clamp(min=1e-30).log().double().mean())
    return dataclasses.replace(ev, avg=avg, ppx=math.exp(neg))


def seed_readings(spec: dict, seed: int, device: str) -> dict:
    cell = Cell(spec, seed, device)
    judge, chunks, ev, steps = cell.checked_call()
    del cell
    control = spec["config"]["control"]
    out = {"seed": seed, "program": check.readings(judge, chunks, ev, steps)}
    out["control"] = check.readings(
        judge, chunks, ev, steps, lambda c: judge.follow(c, control))
    parts = control.split("+")
    for part in parts if len(parts) > 1 else ():
        out[f"control.{part}"] = check.readings(
            judge, chunks, ev, steps, lambda c, p=part: judge.follow(c, p))
    out["unchanged"] = check.readings(judge, chunks, ev, steps,
                                      lambda c: c.start)
    out["half"] = check.readings(
        judge, chunks, ev, steps,
        lambda c: judge.follow(dataclasses.replace(c, draws=half(c.draws))))
    t_win = judge.md.T
    out["fanin"] = check.readings(
        judge, chunks, ev, steps,
        lambda c: judge.follow(c, theta_grad_steps=max(0, t_win - c.offset)))
    out["answer"] = check.readings(judge, chunks, altered(ev), steps)
    out["float64"] = check.readings(judge, chunks, ev, steps,
                                    lambda c: judge.follow(c, "f64"))
    return out


def main(argv=None, *, bench: dict = None, root=HERE,
         device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload,
                     bench or load_json(REPO / "BENCHMARK.json"), root)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = seed_readings(spec, seed, device)
        line["seconds"] = time.perf_counter() - t0
        lines.append(line)
        print(json.dumps(line, default=str), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(dict(line, workload=args.workload),
                                   default=str) + "\n")
    summary = {}
    for kind in (k for k in lines[0] if isinstance(lines[0][k], dict)):
        summary[kind] = {name: [min(x[kind][name] for x in lines),
                                max(x[kind][name] for x in lines)]
                         for name in check.NAMES}
    print(json.dumps({"workload": args.workload, "seeds": len(lines),
                      "min_max": summary}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
