"""The readings that the correctness limits are set from.

For each seed, in one process: the cell's set-up, warm-up and a short
window at the cell's own load; then the checked frames against the
reference (the program's reading, the lower one) and the control, the
reference computed one precision step lower (`reference/precision.py`:
fp8 sweep stacks, bf16 products), against the reference (the upper
one). Prints one JSON line per seed and a summary: each number's
largest program reading and smallest control reading.

    python3 -m mvbench.control --workload all64.orbit --seconds 3
        --seeds 11 12 13 ...

On the card only; it is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(spec, workload: str, seed: int, seconds: float, device,
             control: bool = True) -> dict:
    """One seed -> {"program": numbers, "control": numbers}."""
    from mvbench import check, harness
    from mvbench.reference.precision import LOWER

    run = harness.Run(spec, workload, seed, device)
    try:
        run.warmup()
        frames = len(run.window(seconds))
    finally:
        run.close()
    out = {"seed": seed, "frames": frames,
           "program": run.numbers()["worst"]}
    if control:
        exact = run.reference()
        lower = run.reference(LOWER)
        rows = [check.frame_numbers(
            check.Sample(r.state.frame_idx - 1, None, r.hdr,
                         r.state.taa_history, r.image), e)
            for r, e in zip(lower, exact)]
        out["control"] = check.worst(rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also run the control")
    args = ap.parse_args(argv)

    import torch

    from mvbench.spec import Spec

    if not torch.cuda.is_available():
        print("mvbench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec()
    rows = []
    for i, seed in enumerate(args.seeds):
        r = readings(spec, args.workload, seed, args.seconds, "cuda",
                     control=i < args.control_seeds)
        print(json.dumps(r), flush=True)
        rows.append(r)
    names = rows[0]["program"]
    summary = {n: {"program_max": max(r["program"][n] for r in rows),
                   "control_min": min(r["control"][n] for r in rows
                                      if "control" in r)}
               for n in names}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
