"""The readings a cell's correctness limit is set from, in one process
(and, for a distributed cell, its other ranks):

    python3 bench_port/readings.py --workload <cell> --seeds 1,2,... --requests <m>
        [--control-seeds 7,8,9 --control-requests <c>]

For each seed, ``m`` requests of the cell's own traffic through the
program, as a run's window makes them (the same right-hand sides from
the seed and the index), each answer checked against the plain
reference: the worst relative residual a seed (the lower reading is the
largest of them).  Then the control (``harness.Control``) in the
program's place on its seeds: the smallest of its worst residuals is
the upper reading.  Prints one JSON object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


from bench_port import harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--control-requests", type=int, default=1)
    harness.add_rank_options(p)
    return p.parse_args(argv)


def worst_by_seed(session, seed_list, requests):
    """{seed: (worst relative residual, answers missing, inner its)} on
    rank 0; every rank runs the same requests."""
    out = {}
    for seed in seed_list:
        answers, its = [], []
        for i in range(requests):
            _, x, nits, _ = session.request(session.rhs(seed, harness.WINDOW, i))
            answers.append(x if session.rank.rank == 0 else None)
            its.append(int(nits.max()))
        if session.rank.rank == 0:
            worst, missing = session.check(seed, answers)
            out[seed] = {"worst": worst, "missing": missing, "its": its}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    _, cell, config, traffic = harness.cell_parts(args.workload, args.root)

    def body(rank):
        session = harness.Session(config, traffic, args.device, rank)
        session.system.prepare()
        session.request(session.rhs(args.seeds[0], harness.WARMUP, 0))
        program = worst_by_seed(session, args.seeds, args.requests)
        control = {}
        if args.control_seeds:
            session.system = harness.Control(config, traffic, session.A_ref, session.device,
                                             session.mesh)
            control = worst_by_seed(session, args.control_seeds, args.control_requests)
        session.close()
        return {"program": program, "control": control}

    rank = harness.rank_of(args, cell)
    out, _ = harness.with_ranks(os.path.abspath(__file__), cell, traffic, rank, args.device,
                                args.root, argv, body)
    if args.rank == 0:
        prog = [v["worst"] for v in out["program"].values()]
        ctl = [v["worst"] for v in out["control"].values()]
        out.update(cell=args.workload, limit=config["rtol"],
                   lower=max(prog) if prog else None, upper=min(ctl) if ctl else None,
                   seconds=time.perf_counter() - T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
