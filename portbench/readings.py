"""Readings for a cell's limits: set-up, the checked steps and the
reference, without a window, for each seed and variant
(:mod:`portbench.faults`), in one process.

    python portbench/readings.py --workload <cell> --seeds 1 2 3 \\
        --variants program tf32 [--out <file>]

prints one JSON line per (variant, seed): its gaps and ``correct``
against the cell's limits as they stand."""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--variants", nargs="+", default=["program"])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    from portbench import faults, harness, spec

    cell = spec.Cell(root, args.workload)
    device = torch.device("cuda", 0) if args.device == "cuda" else (
        torch.device("cpu"))
    out = open(args.out, "a") if args.out else None
    for name in args.variants:
        mutate, extra = faults.variant(name)
        for seed in args.seeds:
            t0 = time.time()
            r = harness.run_cell(cell, seed, 0, False, device, t0,
                                 mutate=mutate, extra_argv=extra,
                                 window=False)
            line = json.dumps({"workload": args.workload, "variant": name,
                               "seed": seed, "correct": r["correct"],
                               "seconds": time.time() - t0,
                               "gaps": {k: [c["value"], c["at"]]
                                        for k, c in r["checks"].items()}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            if device.type == "cuda":
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
