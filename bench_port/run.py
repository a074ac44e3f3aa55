"""Run one cell of the benchmark of ``lssp_tpu_torch`` once:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the result as one JSON object, the last line of standard
output, and each number the correctness check compared beside its limit
as the last lines of standard error.  ``--trace 1`` reports the cell's
per-layer metrics instead of its end-to-end ones.

``--control 1`` puts the control (``harness.Control``: the program's fp32
path, no fp64 refinement) in the program's place; its answers have to
fail the check.  ``--rank``, ``--init``, ``--device`` and ``--root`` are
for the processes a distributed cell starts for its other ranks, and for
the CPU tests.
"""
import time

T_START = time.perf_counter()       # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


from bench_port import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    harness.add_rank_options(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    import torch
    cell = harness.find_cell(harness.load_manifest(args.root), args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA devices, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    rank = harness.rank_of(args, cell)
    base = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", str(args.trace), "--control", str(args.control)]
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                           device=args.device, root=args.root, rank=rank, argv=base,
                           control=bool(args.control))
    if out is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
