"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one
card: one cell of ``BENCHMARK.json`` a run.

    python3 bench/run.py --workload kron-s24-do --seed 7 --seconds 10 --trace 0

A cell names a configuration (``bench/configs/<name>.json``: the graph's
generator and sizes, the session the port runs, the guarantees) and a
traffic mix (``bench/traffic/<name>.json``: roots a call, pods, direction
optimisation, search keys, calls checked).  Each metric is a reader,
``bench/metrics/<name>.py``, found by its name.  Nothing here names a
cell, a mix or a metric, so a later cell or metric is files and entries.

A run: generate the edge list on the card and draw the search keys from
the configuration's instance seed, order the calls' key groups by
``--seed`` (the harness's work), hand the pairs to the port's build
(``graph/rmat.py::preprocess``, ``graph/formats.py::build_blocked``),
plan and compile the session, warm up one call a key group, then:

  --trace 0  call the session back to back for ``--seconds``, each call
             timed by the host clock up to a synchronize, and print the
             cell's end-to-end metrics;
  --trace 1  run one cycle of the keys under ``torch.profiler`` (spans
             from here around each call and its synchronize), count the
             synchronizing calls of a second cycle under sync debug mode
             "warn", record the kernels' inputs over a third, and print
             the cell's per-layer metrics and the breakdown.

After the window a seeded sample of the calls' parents is held against
the plain reference (``bench/reference.py``), once the port's state is
freed.  The last line on standard output is the result; the compared
numbers, each beside its limit, close both streams.  Exit code 2: no
card, or fewer than the cell asks for; 3: JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from contextlib import ExitStack  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's own packages, never the script's directory
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    # every kernel cache of a run inside the checkout, at a fixed path
    for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                       ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(_var, str(ROOT / "build" / _sub))

import torch  # noqa: E402

from bench import devtrace, graphs, reference  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """No card, or fewer than the cell asks for."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(root: Path, name: str):
    """(cell, configuration, traffic mix, benchmark) of the cell
    ``name``, each found by its name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic, bench


def metrics_of(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def load_reader(root: Path, name: str):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PortProgram:
    """The system under test: the port's build, session and searches.
    ``call`` returns the parents as the session leaves them on the
    device; ``parents`` lays them out (roots, n) afterwards."""

    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.setup: Dict[str, float] = {}
        self.engine = None

    def build(self, raw: list, n: int) -> int:
        """Hand over the edge list (``raw`` is emptied): the port's
        dedup and symmetrize, and its 2D blocked graph.  Returns
        m_input."""
        from repro_torch.graph.formats import build_blocked
        from repro_torch.graph.rmat import preprocess
        s = self.cfg["session"]
        src, dst = raw
        raw.clear()
        t0 = time.perf_counter()
        edges = preprocess(src, dst, n)
        del src, dst
        self.graph = build_blocked(edges, *s["grid"], align=s["align"])
        del edges
        self.sync()
        self.setup["build_s"] = time.perf_counter() - t0
        return int(self.graph.m_input)

    def compile(self) -> None:
        from repro_torch.configs.base import BFSConfig
        from repro_torch.core.engine import plan_bfs
        from repro_torch.launch.mesh import make_local_mesh
        s, t = self.cfg["session"], self.traffic
        mesh = make_local_mesh(*s["grid"], device=self.device,
                               pods=t.get("pods"))
        bcfg = BFSConfig(decomposition=s["decomposition"],
                         storage=s["storage"], fold_mode=s["fold_mode"],
                         alpha=s["alpha"], beta=s["beta"],
                         direction_optimizing=t["direction_optimizing"],
                         instrument=s["instrument"])
        self.engine = plan_bfs(self.graph, bcfg, mesh,
                               local_mode=s["local_mode"]).compile()

    def setup_times(self) -> Dict[str, float]:
        """The build's seconds and the session's (the graph shipped, the
        program built, its warm-up search, any batched program)."""
        e = self.engine
        return {"build_s": self.setup["build_s"], "ship_s": e.ship_s,
                "compile_s": e.compile_s + e.batch_compile_s}

    def warm_up(self, groups) -> None:
        """One call a key group: every frontier shape the window sees."""
        for g in groups:
            self.call(g)
        self.sync()

    def call(self, roots: List[int]):
        if self.traffic.get("pods"):
            return self.engine.search_batch(roots)[0]
        return self.engine.search(roots[0])[0]

    def parents(self, out, n_roots: int) -> torch.Tensor:
        if self.traffic.get("pods"):
            out = torch.movedim(out, -2, 0)
        return out.reshape(n_roots, -1)[:, : 1 << self.cfg["scale"]]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def kernel_names(self) -> List[str]:
        from repro_torch.kernels.build import CSRC
        return devtrace.kernel_names(CSRC)

    def close(self) -> None:
        self.engine = self.graph = None


class Run:
    """What a run gathers for the readers."""

    def __init__(self, cell, traffic, device):
        self.cell, self.device = cell, device
        self.roots_per_call = traffic["roots_per_call"]
        self.setup: Dict[str, float] = {}
        self.m_input = 0
        self.times: List[float] = []   # completed calls, seconds
        self.lost_s = 0.0               # calls that raised, seconds
        self.failed_calls = 0
        self.port_peak_bytes = 0
        self.trace: Optional[devtrace.DeviceTrace] = None
        self.syncs: Optional[int] = None
        self.sync_searches = 0
        self.records: Dict[str, list] = {}
        self.port_kernels: List[str] = []


class Sample:
    """A reservoir of ``k`` calls' outputs, uniform over every call
    made, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0
        self.items: List[tuple] = []

    def offer(self, roots, out) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((roots, out))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (roots, out)

    def bytes(self) -> int:
        return sum(o.numel() * o.element_size() for _, o in self.items)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def check_device(device: torch.device, chips: int) -> None:
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", program: Callable = PortProgram,
             t_start: Optional[float] = None) -> dict:
    """One run of the cell ``name``: the result object, its ``checks``
    last.  ``device="cpu"`` skips the look for a card and runs the port's
    plain versions (the tests).  ``setup_s`` counts from ``t_start``
    (the process's start in ``main``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic, bench = load_cell(root, name)
    dev = torch.device(device)
    check_device(dev, cell["chips"])
    run = Run(cell, traffic, dev)
    readers = [(m, load_reader(root, m["name"]))
               for m in metrics_of(bench, cell, trace)]
    s_sample = graphs.sub_seeds(seed)[3]

    # the harness's inputs: the raw edge list and the search keys
    n = 1 << cfg["scale"]
    raw = list(graphs.edges(cfg, dev))
    keys = graphs.search_keys(raw[0], raw[1], n, traffic["keys"],
                              cfg["instance_seed"])
    # the calls' root groups are the instance's; the run's seed orders
    # the groups, so every seed does the same work
    r = run.roots_per_call
    groups = graphs.order([keys[i:i + r]
                           for i in range(0, len(keys) - r + 1, r)], seed)
    mem_peak = _peak(dev)

    # set-up: the port's build, its session, one warm-up call a group
    _reset_peak(dev)
    prog = program(cfg, traffic, dev)
    run.m_input = prog.build(raw, n)
    prog.compile()
    prog.warm_up(groups)
    run.port_peak_bytes = _peak(dev)
    mem_peak = max(mem_peak, run.port_peak_bytes)
    run.setup.update(prog.setup_times())
    run.setup["setup_s"] = time.perf_counter() - t_start

    sample = Sample(traffic["checked_calls"], s_sample)
    _reset_peak(dev)
    if trace:
        _traced(run, prog, groups, sample,
                [mod for _, mod in readers if hasattr(mod, "wrap")])
    else:
        _window(run, prog, groups, sample, seconds)
        run.port_peak_bytes = max(run.port_peak_bytes,
                                  _peak(dev) - sample.bytes())
    mem_peak = max(mem_peak, _peak(dev))

    values = {}
    for m, mod in readers:
        v = mod.read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, once the port's state is freed
    outs = [(roots, prog.parents(out, len(roots)))
            for roots, out in sample.items]
    prog.close()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cfg, dev, outs, run.failed_calls)
    del outs

    searches = (len(run.times) + run.failed_calls) * r if not trace \
        else len(groups) * r
    result = {"correct": all(c["value"] <= c["limit"] if "limit" in c
                             else c["value"] >= c["at_least"]
                             for c in checks.values()),
              "attempted": searches, "failed": run.failed_calls * r,
              "metrics": values, "device": device_info(dev, mem_peak, run)}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result


def _window(run: Run, prog, groups, sample: Sample, seconds: float) -> None:
    """The measured window: calls back to back, one caller, each timed
    up to its synchronize; the keys in turn, in whole cycles, until
    ``seconds`` have passed at the end of one."""
    i = 0
    t_w = time.perf_counter()
    while True:
        roots = groups[i % len(groups)]
        t0 = time.perf_counter()
        try:
            out = prog.call(roots)
            prog.sync()
        except Exception:          # a failed call counts, the run goes on
            if not run.failed_calls:
                traceback.print_exc()
            run.failed_calls += 1
            run.lost_s += time.perf_counter() - t0
        else:
            run.times.append(time.perf_counter() - t0)
            sample.offer(roots, out)
        i += 1
        if i % len(groups) == 0 and time.perf_counter() - t_w >= seconds:
            return


def _traced(run: Run, prog, groups, sample: Sample, wrapping) -> None:
    """The traced window (one cycle of the keys under the profiler), the
    synchronizing calls of a second cycle, and a third under the
    ``wrap`` of each reader in ``wrapping``, which records the calls'
    inputs."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            for roots in groups:
                with record_function(devtrace.SPAN_PREFIX + "call"):
                    out = prog.call(roots)
                with record_function(devtrace.SPAN_PREFIX + "sync"):
                    prog.sync()
                sample.offer(roots, out)
    searches = len(groups) * run.roots_per_call
    run.trace = devtrace.DeviceTrace(prof, searches)
    del prof
    run.port_kernels = prog.kernel_names()

    if run.device.type == "cuda":
        syncs = 0
        for roots in groups:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    prog.call(roots)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            prog.sync()
            syncs += sum("synchroniz" in str(w.message) for w in caught)
        run.syncs, run.sync_searches = syncs, searches

    with ExitStack() as stack:
        for mod in wrapping:
            stack.enter_context(mod.wrap(run))
        for roots in groups:
            prog.call(roots)
        prog.sync()


def check(cfg: dict, dev, outs, failed_calls: int) -> dict:
    """The sampled calls' parents against the plain reference's, which
    rebuilds its graph from the raw edge list, generated anew."""
    n = 1 << cfg["scale"]
    src, dst = graphs.edges(cfg, dev)
    rs, rd = reference.build(src, dst)
    del src, dst
    want: Dict[int, torch.Tensor] = {}
    wrong = checked = 0
    for roots, par in outs:
        for j, root in enumerate(roots):
            if root not in want:
                want[root] = reference.parents(n, rs, rd, root)
            wrong += reference.wrong_parents(par[j], want[root])
            checked += 1
    return {"failed_calls": {"value": failed_calls, "limit": 0},
            "checked_searches": {"value": checked, "at_least": 1},
            "wrong_parents": {"value": wrong, "limit": 0}}


def device_info(dev, mem_peak: int, run: Run) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": run.cell["chips"], "memory_peak_bytes": mem_peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def check_lines(checks: dict) -> List[str]:
    out = []
    for k, c in checks.items():
        lim = f"limit {c['limit']}" if "limit" in c \
            else f"at least {c['at_least']}"
        out.append(f"check {k} {c['value']} {lim}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the port's plain versions and skips the "
                         "look for a card (tests only)")
    args = ap.parse_args(argv)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), args.device, t_start=T_START)
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"no result: loaded {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
