"""One run of one cell of the benchmark of ``lssp_tpu_torch``.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the matrix, the solver, the precisions, the
guarantee) and a traffic mix (``traffic/<name>.json``: the entry point,
the right-hand sides a request carries, how many requests warm up and how
many the trace covers).  A metric is a reader, ``metrics/<name with its
dots as underscores>.py``.  All three are found by name, so a cell, a mix
or a metric is added by adding files and entries.

The run: set-up (the program's import, the matrix from the frozen
generators, ``prepare_ir`` or the distributed build, the warm-up
requests), then a closed loop of one client for ``seconds``, each request
a fresh right-hand side made from the seed and the request's index
before its clock starts; then the check of every answer against the
plain reference (``reference.py``), and the result line.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from bench_port import generators, reference
from bench_port.record import Run
from bench_port.trace import Profile, reduce_events

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
RUN_PY = os.path.join(BENCH, "run.py")

# top-level module names that may not be loaded in a run: JAX and the JAX
# package, which the port is measured without
FORBIDDEN = ("jax", "jaxlib", "flax", "lssp_tpu")

# the two streams of right-hand sides drawn from a seed
WINDOW, WARMUP = 0, 1


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_data(kind: str, name: str, root: str = ROOT) -> dict:
    """``bench_port/<kind>/<name>.json`` under ``root``: a configuration
    (``configs``) or a traffic mix (``traffic``)."""
    with open(os.path.join(root, "bench_port", kind, f"{name}.json")) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it (those whose ``workloads`` list
    the cell; without the key, those that move an end-to-end metric the
    cell reports)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, root: str = ROOT):
    """The ``read`` function of metric ``name``."""
    path = os.path.join(root, "bench_port", "metrics", name.replace(".", "_") + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole (``lssp_tpu_torch`` is not ``lssp_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def rhs_seed(seed: int, stream: int, index: int) -> int:
    """A 64-bit generator seed for right-hand side ``index`` of ``stream``."""
    ss = np.random.SeedSequence([seed % 2 ** 64, stream, index])
    return int(ss.generate_state(1, np.uint64)[0])


def make_rhs(seed: int, stream: int, index: int, n: int, k: int, device) -> torch.Tensor:
    """An N(0, 1) fp64 right-hand side ((n,) or (n, k)), made on ``device``
    by a generator of its own: the same seed and index give the same
    values."""
    g = torch.Generator(device=device)
    g.manual_seed(rhs_seed(seed, stream, index))
    shape = (n,) if k == 1 else (n, k)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float64)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """The program under test in one cell: its copy of the matrix and the
    entry point the traffic names, called as a user calls it."""

    def __init__(self, config: dict, traffic: dict, A_ref, device, mesh=None):
        import lssp_tpu_torch as lt
        self.lt, self.config, self.traffic = lt, config, traffic
        self.device, self.mesh = device, mesh
        # the program's own copy: nothing it does to its input reaches the reference
        self.A = lt.sparse.CSR(A_ref.indptr.copy(), A_ref.indices.copy(), A_ref.data.copy(),
                               tuple(A_ref.shape))
        c = config
        self.options = lt.SolverOptions(rtol=c["rtol"], atol=0.0, rbtol=0.0, maxit=c["maxit"],
                                        restart=c.get("restart"))
        self.pc_options = lt.PCOptions(**c["pc_options"]) if c.get("pc_options") else None
        self.inner = getattr(torch, c["inner_dtype"])
        entry = traffic["entry"]
        if entry not in ("solve_ir", "solve_ir_multi", "dist_solve_ir"):
            raise ValueError(f"unknown entry {entry!r}")
        self.entry = entry
        self.method = c["block_method"] if entry == "solve_ir_multi" else c["method"]

    def prepare(self) -> None:
        """The program's set-up phase, as a user runs it before solving:
        ``prepare_ir`` (the distributed build happens in the first call)."""
        if self.entry != "dist_solve_ir":
            self.lt.prepare_ir(self.A, method=self.method, pc=self.config["pc"],
                               pc_options=self.pc_options, inner_dtype=self.inner,
                               device=self.device)

    def __call__(self, b):
        """One request: (x, its inner iterations by column, converged)."""
        lt, c = self.lt, self.config
        kw = dict(method=self.method, pc=c["pc"], options=self.options,
                  pc_options=self.pc_options, inner_rtol=c["inner_rtol"],
                  max_outer=c["max_outer"], inner_dtype=self.inner)
        if self.entry == "solve_ir":
            x, info = lt.solve_ir(self.A, b, device=self.device, **kw)
        elif self.entry == "solve_ir_multi":
            x, info = lt.solve_ir_multi(self.A, b, device=self.device, **kw)
        else:
            x, info = lt.parallel.dist_solve_ir(self.A, b, mesh=self.mesh, **kw)
        return x, np.atleast_1d(np.asarray(info.nits)), bool(np.all(info.converged))


class Control(System):
    """The control: the program's own fp32 path switched on in its place,
    ``solve`` / ``solve_multi`` / ``dist_solve`` on the matrix in fp32
    with no fp64 refinement, the precision below the configuration's
    fp64 answer.  Its answers have to fail the check."""

    def __init__(self, config: dict, traffic: dict, A_ref, device, mesh=None):
        super().__init__(config, traffic, A_ref, device, mesh)
        self.A = self.lt.sparse.CSR(A_ref.indptr.copy(), A_ref.indices.copy(),
                                    A_ref.data.astype(np.float32), tuple(A_ref.shape))

    def prepare(self) -> None:
        pass

    def __call__(self, b):
        lt, c = self.lt, self.config
        kw = dict(method=self.method, pc=c["pc"], options=self.options,
                  pc_options=self.pc_options)
        b = b.to(torch.float32)
        if self.entry == "solve_ir":
            x, info = lt.solve(self.A, b, device=self.device, **kw)
        elif self.entry == "solve_ir_multi":
            x, info = lt.solve_multi(self.A, b, device=self.device, **kw)
        else:
            x, info = lt.parallel.dist_solve(self.A, b, mesh=self.mesh, **kw)
        return x, np.atleast_1d(np.asarray(info.nits)), bool(np.all(info.converged))


@dataclasses.dataclass
class Rank:
    """How this process takes part in a run of ``world`` ranks."""

    rank: int = 0
    world: int = 1
    init: str | None = None


def add_rank_options(parser) -> None:
    """The options of a process that a distributed cell starts for each
    of its other ranks (and of the CPU tests: ``--device cpu``, ``--root``
    a directory with the manifest and the benchmark's data files)."""
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--init", default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--root", default=ROOT)


def rank_of(args, cell: dict) -> Rank:
    return Rank(rank=args.rank, init=args.init,
                world=int(cell["chips"]) if args.init is not None else 1)


def start_ranks(script: str, argv: list, world: int, device: str, root: str) -> tuple:
    """Rank 0's part of a distributed run: a free local port for the
    rendezvous and one process for each other rank, running ``script``
    with this run's arguments.  Returns (address, processes)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init = f"tcp://127.0.0.1:{port}"
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, script, *argv, "--rank", str(r), "--init", init,
               "--device", device, "--root", root]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT))
    return init, procs


def collect_ranks(procs, timeout: float = 240.0) -> list:
    """Each other rank's last stdout line (a JSON object); every process
    has ended when this returns."""
    out = []
    try:
        for r, p in enumerate(procs, start=1):
            stdout, _ = p.communicate(timeout=timeout)
            lines = [ln for ln in stdout.splitlines() if ln.strip()]
            if p.returncode != 0 or not lines:
                raise RuntimeError(f"rank {r} ended with {p.returncode}")
            out.append(json.loads(lines[-1]))
    finally:
        stop(procs)
    return out


def stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def profiler(device):
    """A ``torch.profiler`` of the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


class Session:
    """One process's part of a cell: the group (for a distributed entry),
    the benchmark's matrix, the program (or the control) on it, and the
    requests."""

    def __init__(self, config: dict, traffic: dict, device, rank, control: bool = False):
        self.config, self.traffic, self.rank = config, traffic, rank
        self.mesh = None
        if rank.init is not None:
            from lssp_tpu_torch.parallel import multihost
            multihost.initialize(rank.init, rank.world, rank.rank, device=device,
                                 timeout=datetime.timedelta(seconds=300))
            self.mesh = multihost.global_mesh(slots=int(config.get("slots", 1)))
            device = self.mesh.device
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.A_ref = generators.build(config)
        self.n, self.k = self.A_ref.shape[0], int(traffic.get("k", 1))
        self.system = (Control if control else System)(config, traffic, self.A_ref, device,
                                                       self.mesh)

    def rhs(self, seed: int, stream: int, index: int) -> torch.Tensor:
        return make_rhs(seed, stream, index, self.n, self.k, self.device)

    def request(self, b):
        """One request, timed from its start to the synchronise after it
        returned: (seconds, x or None, inner its by column, converged).
        A request that raises has no answer."""
        sync(self.device)
        t0 = time.perf_counter()
        try:
            x, its, converged = self.system(b)
        except (RuntimeError, ValueError, FloatingPointError) as e:
            print(f"request raised {type(e).__name__}: {e}", file=sys.stderr)
            x, its, converged = None, np.zeros(self.k, np.int64), False
        sync(self.device)
        return time.perf_counter() - t0, x, its, converged

    def agree(self, more: bool) -> bool:
        """Rank 0's word for every rank (a distributed run): whether
        another request follows."""
        if self.mesh is None:
            return more
        flag = torch.tensor([1.0 if more else 0.0], device=self.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def check(self, seed: int, answers: list) -> tuple:
        """Every answer against the plain reference: (the worst relative
        residual, the answers missing or not finite).  Frees each answer
        as it goes."""
        worst, missing = 0.0, 0
        for j, x in enumerate(answers):
            if x is None:
                missing += 1
                continue
            b = self.rhs(seed, WINDOW, j).cpu().numpy()
            r = reference.relres(self.A_ref, b, x.detach().cpu().numpy())
            answers[j] = None
            if not np.all(np.isfinite(r)):
                missing += 1
            else:
                worst = max(worst, float(np.max(r)))
        return worst, missing

    def close(self) -> None:
        if self.mesh is not None:
                dist.destroy_process_group()


class Answers(list):
    """The window's answers, kept for the check after it closes.  Each goes
    to host memory after its request, outside its latency, as a user that
    consumes the answer frees it, so the card holds only the program's
    state.  The requests of the traced stretch copy theirs into slots on
    the card made in set-up instead, a copy the trace hardly sees, and
    ``release`` moves those to the host once the stretch has closed."""

    def __init__(self, like=None, slots: int = 0):
        super().__init__()
        self.slots = [] if like is None else [torch.empty_like(like) for _ in range(slots)]
        self.held = []

    def keep(self, x, traced: bool) -> None:
        if x is None:
            self.append(None)
            return
        x = x.detach()
        if (traced and self.slots and self.slots[-1].shape == x.shape
                and self.slots[-1].dtype == x.dtype):
            slot = self.slots.pop()
            slot.copy_(x)
            self.held.append(len(self))
            self.append(slot)
        else:
            self.append(x.to("cpu", copy=True))

    def release(self) -> None:
        for j in self.held:
            self[j] = self[j].to("cpu")
        self.held.clear()
        self.slots.clear()


def answer_crcs(answers) -> list:
    """A crc32 of each answer's bits, for the ranks to compare."""
    return [None if x is None else zlib.crc32(x.detach().cpu().numpy().tobytes())
            for x in answers]


# the one value each of these keys may have: what the harness implements.
# A data file that asks for another is refused, not run as something else.
IMPLEMENTED = {"traffic": {"rhs": "normal", "loop": "closed", "clients": 1},
               "configs": {"outer_dtype": "float64"}}


def implemented(kind: str, data: dict, name: str) -> None:
    """Raise where ``data`` (a ``kind`` file) sets a key of ``IMPLEMENTED``
    to a value the harness does not run."""
    for key, value in IMPLEMENTED[kind].items():
        if key in data and data[key] != value:
            raise ValueError(f"{kind}/{name}.json: {key} {data[key]!r} is not implemented "
                             f"(the harness runs {key} {value!r})")


def cell_parts(cell_name: str, root: str) -> tuple:
    """(manifest, cell, configuration, traffic) of a cell, with its rank
    count checked against the configuration's and each setting checked
    against what the harness implements."""
    manifest = load_manifest(root)
    cell = find_cell(manifest, cell_name)
    config = load_data("configs", cell["config"], root)
    traffic = load_data("traffic", cell["traffic"], root)
    implemented("configs", config, cell["config"])
    implemented("traffic", traffic, cell["traffic"])
    if traffic["entry"] == "dist_solve_ir" and int(config.get("ranks", 1)) != int(cell["chips"]):
        raise ValueError(f"{cell_name}: configuration {config['name']} runs on "
                         f"{config.get('ranks')} ranks, the cell on {cell['chips']} chips")
    return manifest, cell, config, traffic


def with_ranks(script: str, cell: dict, traffic: dict, rank: Rank, device: str, root: str,
               argv: list, body):
    """Run ``body(rank)`` in this process, having started the other ranks
    first where the cell is distributed and this is rank 0.  Returns
    (body's result, the other ranks' last lines)."""
    procs = []
    if traffic["entry"] == "dist_solve_ir" and rank.rank == 0 and rank.init is None:
        rank.world = int(cell["chips"])
        rank.init, procs = start_ranks(script, argv, rank.world, device, root)
    try:
        out = body(rank)
        return out, collect_ranks(procs) if procs else []
    finally:
        stop(procs)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", root: str = ROOT, rank: Rank | None = None,
             argv: list | None = None, control: bool = False) -> dict | None:
    """One run of ``cell_name``.  Returns the result line's object on rank
    0, another rank's readings elsewhere; None where a forbidden module
    was loaded (named on stderr).  ``control``: the control in the
    program's place."""
    manifest, cell, config, traffic = cell_parts(cell_name, root)
    out, ranks = with_ranks(RUN_PY, cell, traffic, rank or Rank(), device, root, argv or [],
                            lambda r: _run(cell, config, traffic, seed, seconds, trace,
                                           t_start, device, r, control))
    if out.get("rank", 0) != 0:
        return out
    out["ranks"] = ranks
    return finish(manifest, cell, out, trace, root)


def _run(cell, config, traffic, seed, seconds, trace, t_start, device, rank, control):
    from lssp_tpu_torch.parallel import dist_ops
    from lssp_tpu_torch.utils import profile as prog_profile
    session = Session(config, traffic, device, rank, control)
    device = session.device

    prog_profile.reset_phases()
    session.system.prepare()
    phases_setup = prog_profile.phase_times()
    warm = None
    for j in range(int(traffic.get("warmup_requests", 1))):
        _, warm, _, _ = session.request(session.rhs(seed, WARMUP, j))
    profile_from = 1
    profile_to = profile_from + int(traffic.get("profile_requests", 2)) if trace else -1
    answers = Answers(warm, max(profile_to - profile_from, 0))
    del warm
    if trace:
        # the profiler's own start-up (CUPTI) belongs to set-up, not the window
        with profiler(device):
            torch.ones(1, device=device).add_(1)
            sync(device)

    prog_profile.reset_phases()
    dist_ops.collectives.clear()
    prof = None
    latencies, nits, failed = [], [], 0
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    deadline = t_window + seconds
    i = 0
    while True:
        if i == profile_from and trace:
            prof = profiler(device)
            prof.__enter__()
            t_prof = time.perf_counter()
        seconds_i, x, its, converged = session.request(session.rhs(seed, WINDOW, i))
        latencies.append(seconds_i)
        nits.append(its)
        answers.keep(x, profile_from <= i < profile_to)
        del x
        failed += not converged
        i += 1
        if i == profile_to:
            prof_wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
            answers.release()
        # rank 0's clock closes the window for every rank
        if not session.agree(time.perf_counter() < deadline):
            break
    window_s = time.perf_counter() - t_window
    if prof is not None and i < profile_to:           # the window closed first
        prof_wall = time.perf_counter() - t_prof
        prof.__exit__(None, None, None)
        answers.release()
    # the program's peak over set-up and the window: the answers are on the
    # host (with --trace 1, the traced stretch's few slots on the card too)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    phases_window = prog_profile.phase_times()
    collectives = dict(dist_ops.collectives) if session.mesh is not None else None

    profile_out = None if prof is None else reduce_events(prof.events(), prof_wall)
    crcs = answer_crcs(answers) if session.mesh is not None else None
    if rank.rank != 0:
        answers.clear()
        session.close()
        return {"rank": rank.rank, "memory_peak_bytes": int(memory_peak), "crcs": crcs,
                "forbidden": forbidden_modules(),
                "busy_s": None if profile_out is None else profile_out.busy_s,
                "wall_s": None if profile_out is None else profile_out.wall_s}

    # every answer against the plain reference, once the window has closed
    worst, missing = session.check(seed, answers)
    session.close()
    run = Run(cell=cell["name"], config=config, traffic=traffic, latencies=latencies,
              nits=nits, window_s=window_s, setup_s=setup_s, phases_setup=phases_setup,
              phases_window=phases_window, collectives=collectives,
              profiles=[profile_out] if profile_out is not None else [],
              profiled=list(range(profile_from, min(i, profile_to))) if trace else [],
              matrix=generators.structure(session.A_ref) if trace else None,
              card=torch.cuda.get_device_name(device) if device.type == "cuda" else None)
    return {"run": run, "memory_peak_bytes": int(memory_peak), "failed": failed,
            "crcs": crcs, "device": device,
            "checks": {"relres_max": {"value": worst, "limit": float(config["rtol"])},
                       "answers_missing": {"value": missing, "limit": 0}}}


def power_limit_w(device) -> float | None:
    """The card's power limit in W (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", str(torch.device(device).index or 0)],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def finish(manifest, cell, out, trace, root=ROOT) -> dict | None:
    """Rank 0: the result line's object from this rank's run and the
    other ranks' readings; None where a forbidden module was loaded in
    any rank once the window had closed."""
    run = out["run"]
    ranks = out["ranks"]
    checks = out["checks"]
    if out["crcs"] is not None:
        differ = sum(any(r["crcs"][j] != c for r in ranks) for j, c in enumerate(out["crcs"]))
        checks["ranks_disagree"] = {"value": differ, "limit": 0}
    for r in ranks:
        if r["busy_s"] is not None:
            run.profiles.append(Profile(wall_s=r["wall_s"], busy_s=r["busy_s"], device_ops=[],
                                        gaps_by_host_op={}))
    metrics = {}
    for m in metrics_for(manifest, cell["name"], trace):
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = out["device"]
    cuda = device.type == "cuda"
    world = 1 + len(ranks)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": world,
           "memory_peak_bytes": max([out["memory_peak_bytes"]]
                                    + [r["memory_peak_bytes"] for r in ranks])}
    if cuda:
        dev["power_limit_w"] = power_limit_w(device)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": run.requests, "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if trace and run.profiles:
        dev["busy_s"] = sum(p.busy_s for p in run.profiles) / len(run.profiles)
        dev["window_s"] = sum(p.wall_s for p in run.profiles) / len(run.profiles)
        result["breakdown"] = run.profiles[0].breakdown()
    result["checks"] = checks
    # the last step: nothing that the readers or the result loaded can slip past
    forbidden = sorted(set(forbidden_modules()).union(*[r["forbidden"] for r in ranks]))
    if forbidden:
        print(f"forbidden modules loaded: {', '.join(forbidden)}", file=sys.stderr)
        return None
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result
