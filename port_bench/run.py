"""The benchmark of ``na_mpnn_tpu_torch`` on one card.

    python3 -m port_bench.run --workload design.rna --seed 7 --seconds 30 --trace 0

Runs one cell of ``BENCHMARK.json`` (one configuration under one traffic
mix) and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and last ``checks``, each number compared
with its limit (also the last lines of standard error).

Everything a cell needs is found by name: the configuration's file, the
mix ``traffic/<traffic>.json`` and its driver ``drivers/<driver>.py``, the
limits ``limits/<workload>.json``, and each metric's reader
``metrics/<metric>.py``. A reader exposes ``WRAPS`` (the program's
attributes whose calls it needs as spans, dotted from the package) and
``read(run)``, which returns the number or None where the run holds nothing
for it.

With ``--trace 0`` the cell's end-to-end metrics are printed; with
``--trace 1`` its per-layer metrics, from spans around the wrapped calls
over the window and a ``torch.profiler`` slice of the requests right after
it. Set-up (``setup_s``) runs from the process's start to the first timed
request: imports, the card, the kernels' build where the checkout has none,
the weights, the traffic and a warm request. The window closes with the
first request that ends after ``--seconds``; rates are over all the work and
all the time of the window. After it the peak memory is read, the
program's state is freed and the reference judges a sample of the answers.
"""
from __future__ import annotations

import os
import time


def _process_age():
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "na_mpnn_tpu")
PACKAGE = "na_mpnn_tpu_torch"


def load_spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``."""
    return _load_module(os.path.join(HERE, "metrics", metric + ".py"),
                        "port_bench.metrics." + metric.replace(".", "_"))


def driver_class(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}").Driver


def metrics_of(spec, workload: str, trace: bool):
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones (a metric with a ``workloads`` list belongs to those
    cells; one without it to every cell that reports what it moves)."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN and sys.modules[m] is not None})


def resolve(dotted: str):
    """(owner, attribute) of a name dotted from the program's package:
    ``models.mpnn.sample``, ``train.trainer.Trainer.loss_and_grads``."""
    parts = dotted.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(".".join([PACKAGE] + parts[:cut]))
        except ModuleNotFoundError:
            continue
        for p in parts[cut:-1]:
            owner = getattr(owner, p)
        return owner, parts[-1]
    raise ValueError(f"{dotted}: not found in {PACKAGE}")


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    mix: dict
    seed: int
    device: str
    out: str
    trace: bool


@dataclasses.dataclass
class Run:
    """What a reader reads: the cell, the window's requests (each with
    ``t0``, ``t1`` and the driver's record of its work), the window, the set-up
    time, the spans, and in traced runs the profile and the requests of the
    profiled slice."""
    cell: Cell
    requests: list
    t_start: float
    t_end: float
    setup_s: float
    spans: object = None
    profile: object = None
    profiled: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self):
        return self.t_end - self.t_start


def limits_of(workload):
    path = os.path.join(HERE, "limits", workload + ".json")
    with open(path) as f:
        return json.load(f)


def work_of(request):
    """A request's work: the residues of a served structure, or the
    unpadded tokens of a training step."""
    return request.get("residues", request.get("tokens", 0))


def window_summary(run):
    """One line on how the window's time fell: the quartiles of the requests'
    seconds per unit of work (each request's own, from its start to its end)
    and the rate of each half of the window, which tell a run that is slow
    throughout from one that stalls in places."""
    reqs = [r for r in run.requests if r["ok"] and work_of(r)]
    if len(reqs) < 4:
        return f"window: {len(reqs)} requests"
    per = sorted(1e3 * (r["t1"] - r["t0"]) / work_of(r) for r in reqs)
    q = statistics.quantiles(per, n=4)
    mid = run.t_start + run.window_s / 2
    halves = []
    for a, b in ((run.t_start, mid), (mid, run.t_end)):
        done = sum(work_of(r) for r in reqs if a <= r["t1"] < b)
        halves.append(done / (b - a) if b > a else 0.0)
    slow = sorted(reqs, key=lambda r: -(r["t1"] - r["t0"]) / work_of(r))[:3]
    return (f"window: {len(reqs)} requests in {run.window_s:.3f} s; ms per unit of work "
            f"min {per[0]:.5f} q1 {q[0]:.5f} median {q[1]:.5f} q3 {q[2]:.5f} "
            f"max {per[-1]:.5f}; work per s first half {halves[0]:.1f} second half "
            f"{halves[1]:.1f}; slowest at "
            + ", ".join(f"{r['t0'] - run.t_start:.2f} s" for r in slow))


def run_cell(workload, seed, seconds, trace, device="cuda", spec=None, plant=None,
             controls=(), overrides=None, config_overrides=None):
    """Run one cell in this process -> (result dict, checks [(name, value,
    limit)], extra readings). ``plant`` (a callable taking the driver) breaks
    the program before set-up; ``controls`` are precisions whose readings
    are returned beside the program's; ``overrides`` replace entries of the
    mix and ``config_overrides`` keys of the configuration (tests run small
    mixes, and the training step at float32)."""
    from . import traffic

    spec = spec or load_spec()
    entry = next(w for w in spec["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = dict(json.load(f), **(config_overrides or {}))
    mix = dict(traffic.load(entry["traffic"]), **(overrides or {}))
    out = tempfile.mkdtemp(prefix="port_bench_")
    try:
        return _run(Cell(workload, config, mix, seed, device, out, bool(trace)),
                    seconds, spec, plant, controls)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _run(cell, seconds, spec, plant, controls):
    import torch

    from .trace import Profile, Spans

    workload, mix, device, out = cell.workload, cell.mix, cell.device, cell.out
    trace = cell.trace
    wanted = metrics_of(spec, workload, trace)
    readers = {m["name"]: reader(m["name"]) for m in wanted}

    drv = driver_class(mix["driver"])(cell)
    if plant is not None:
        plant(drv)
    drv.setup()
    spans = Spans(sync=True) if trace else None
    if spans is not None:
        for name in sorted({w for r in readers.values() for w in getattr(r, "WRAPS", [])}):
            owner, attr = resolve(name)
            spans.wrap(owner, attr, name.split(".")[-1])

    def one(i):
        t0 = time.perf_counter()
        try:
            rec = drv.request(i)
            ok = True
        except Exception:  # noqa: BLE001 — a failed request is counted, not fatal
            traceback.print_exc()
            rec, ok = {}, False
        if device != "cpu" and drv.sync_each:
            torch.cuda.synchronize()
        rec.update(t0=t0, t1=time.perf_counter(), ok=ok)
        return rec

    requests = []
    t_start = time.perf_counter()
    setup_s = t_start - T0
    while not requests or requests[-1]["t1"] - t_start < seconds:
        requests.append(one(len(requests)))
    if device != "cpu":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    profile, profiled = None, []
    if trace:
        profile = Profile(out)
        spans.sync = False      # the slice's idle time is the program's own
        profile.start()
        t_p = time.perf_counter()
        n = len(requests)
        while len(requests) == n or time.perf_counter() - t_p < mix.get("profile_seconds", 2.0):
            requests.append(one(len(requests)))
        profile.stop()
        requests, profiled = requests[:n], requests[n:]
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    if spans is not None:
        spans.restore()
    drv.restore()
    run = Run(cell, requests, t_start, t_end, setup_s, spans, profile, profiled)
    print(window_summary(run), file=sys.stderr)

    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    limits = limits_of(workload)
    readings = dict(drv.check(requests))
    checks = [(k, readings[k], limits[k]) for k in limits]
    extra = {c: dict(drv.check(requests, control=c)) for c in controls}
    failed = sum(1 for r in requests if not r["ok"])
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": len(requests), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if profile is not None:
        result["device"].update(busy_s=profile.busy_s, window_s=profile.window_s)
        result["breakdown"] = {"device_ops": [[k, v] for k, v in profile.device_ops],
                               "idle_gaps": [[k, v] for k, v in profile.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks, extra


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    build = os.path.join(ROOT, "build", "port_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    spec = load_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result, checks, _ = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", spec)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
