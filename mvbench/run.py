"""The benchmark of `multivolumes_tpu_torch`: one run of one cell.

    python3 -m mvbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics; with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `check`, each compared number with its limit (also
the last lines of standard error). Without a card it exits 2 and prints
no result; it exits 1 without a result if JAX or the JAX package was
loaded. See `mvbench/README.md`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")

    import torch

    from mvbench import check, harness
    from mvbench.spec import Spec

    spec = Spec(ROOT)
    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mvbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.measure(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    found = harness.forbidden_modules()
    if found:
        print(f"mvbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 1
    check.print_numbers(result["check"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
