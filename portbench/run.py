"""Run one cell of the benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and
``hebbax_torch``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; ``checks``, each compared number with
its limit, comes last); the compared numbers also close standard error.
With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones.

The run needs as many CUDA cards as the cell asks for and exits 1 without
a result otherwise; ``--device cpu`` runs it on the CPU for the tests.
It refuses imports of JAX, flax, optax and hebbax, and exits 3 without a
result if, once the window has closed, a module of one is loaded.
"""

import argparse
import importlib.abc
import json
import os
import sys
import time

ROOT = os.getcwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hebbax")


def process_start():
    """The process's start as a ``time.time()`` value (from /proc where it
    is readable, else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


class _Refuse(importlib.abc.MetaPathFinder):
    """Refuses the forbidden packages, so that a library that would load
    JAX as an option (TensorBoard's TensorFlow does, where installed)
    goes without it; the port importing one fails the run."""

    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"portbench refuses {name!r} in a run")
        return None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    start = process_start()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    # caches of the program's builds stay at fixed paths in the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.meta_path.insert(0, _Refuse())
    # the checkout's packages before any other copy on the path
    sys.path[:] = [ROOT] + [p for p in sys.path if p != ROOT]

    import torch

    from portbench import harness, spec

    cell = spec.Cell(ROOT, args.workload)
    if args.device == "cuda":
        need = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"portbench: the cell needs {need} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  f" available", file=sys.stderr)
            return 1
    device = torch.device("cuda", 0) if args.device == "cuda" else (
        torch.device("cpu"))
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, start)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, "
              f"at {c['at']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
