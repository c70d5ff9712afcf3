"""Where a LigandMPNN training step's device time goes, on the card:

    python3 -m port_bench.profile_context --seed 7 --steps 6

Sets up the ligand.train cell (``drivers/ligand_train.py``), runs two
steps, then ``--steps`` steps under ``torch.profiler``, and gives each
kernel's device time to the program's spans that launched it (the launch
on the host lies inside the span, on the same thread): ``features.context``,
``model.context``, their backwards (``features.context.backward``,
``model.context.backward``), the rest of the step. Prints one JSON line:
the busy time (the union of the device's intervals), each part's device
seconds and share of the summed kernel time, the largest kernels, the
steps' tokens and the card.

The program runs the context features and layers on the trainer's one
autograd graph, so their backward kernels launch from the trainer's
backward call with nothing to mark them. For the profile alone,
``mark_backwards`` puts each on a graph of its own (``_Marked``), whose
backward is one call marked in the trace: the same operations and kernels,
the gradients passed on as autograd passes them.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import traffic
from .run import Cell, ROOT, forbidden_modules

PARTS = ("features.context", "model.context", "features.context.backward",
         "model.context.backward")


class _Marked(torch.autograd.Function):
    """``fn(*inputs)`` on an autograd graph of its own; the backward runs
    that graph's backward under ``record_function(name + ".backward")`` and
    returns the inputs' gradients."""

    @staticmethod
    def forward(ctx, fn, name, *inputs):
        ctx.name = name
        ctx.inputs = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        with torch.enable_grad():
            outs = fn(*ctx.inputs)
        ctx.single = torch.is_tensor(outs)
        ctx.outs = (outs,) if ctx.single else tuple(outs)
        detached = tuple(o.detach() for o in ctx.outs)
        return detached[0] if ctx.single else detached

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function(ctx.name + ".backward"):
            pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                     if g is not None and o.requires_grad]
            wanted = [t for t in ctx.inputs if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs], allow_unused=True))
            out = [next(got) if t.requires_grad else None for t in ctx.inputs]
        ctx.outs = ctx.inputs = None
        return (None, None, *out)


def mark_backwards():
    """Run ``models.ligand``'s ``context_features`` and ``context_encoder``
    each as a ``_Marked`` graph (their parameter trees flattened into its
    inputs)."""
    from na_mpnn_tpu_torch.models import ligand
    features, encoder = ligand.context_features, ligand.context_encoder

    def context_features(p, cfg, X, Y, Y_t, cdt=None):
        leaves, spec = tree_flatten(p)
        n = len(leaves)

        def run(*t):
            return features(tree_unflatten(list(t[:n]), spec), cfg, t[n], t[n + 1], Y_t, cdt)
        return _Marked.apply(run, "features.context", *leaves, X, Y)

    def context_encoder(params, cfg, h_V, V, Y_nodes, Y_edges, Y_m, mask, drop=None):
        leaves, spec = tree_flatten(params)
        n = len(leaves)

        def run(*t):
            return encoder(tree_unflatten(list(t[:n]), spec), cfg, *t[n:], Y_m, mask, drop)
        return _Marked.apply(run, "model.context", *leaves, h_V, V, Y_nodes, Y_edges)

    ligand.context_features = context_features
    ligand.context_encoder = context_encoder


def attribute(events):
    """(busy seconds, device seconds by part, kernels by name) of a chrome
    trace's events."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in spans
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    marks = collections.defaultdict(list)
    for e in spans:
        if e.get("cat") == "user_annotation" and e["name"] in PARTS:
            marks[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for v in marks.values():
        v.sort()
    parts = collections.defaultdict(float)
    names = collections.defaultdict(float)
    for k in kernels:
        names[k["name"][:80]] += k["dur"] / 1e6
        launch = launches.get(k.get("args", {}).get("correlation"))
        part = "rest"
        if launch is not None:
            ms = marks.get(launch["tid"], [])
            i = bisect.bisect_right(ms, (launch["ts"], float("inf"), "")) - 1
            best = None
            for j in range(i, max(i - 50, -1), -1):
                a, b, name = ms[j]
                if a <= launch["ts"] <= b and (best is None or a >= best[0]):
                    best = (a, name)
            if best is not None:
                part = best[1]
        parts[part] += k["dur"] / 1e6
    merged = []
    for k in sorted(kernels, key=lambda e: e["ts"]):
        s, t = k["ts"], k["ts"] + k["dur"]
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    return busy, dict(parts), sorted(names.items(), key=lambda kv: -kv[1])[:12]


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile

    from .drivers.ligand_train import Driver

    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--steps", type=int, default=6)
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "port_bench", "configs", "ligand_mpnn.json")) as f:
        cfg = json.load(f)
    with tempfile.TemporaryDirectory() as out:
        drv = Driver(Cell("ligand.train", cfg, traffic.load("ligand.train"), args.seed,
                          "cuda", out, False))
        drv.setup()
        mark_backwards()
        for i in range(2):
            drv.request(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            reqs = [drv.request(2 + i) for i in range(args.steps)]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            busy, parts, top = attribute(json.load(f)["traceEvents"])
    total = sum(parts.values())
    context = sum(parts.get(k, 0.0) for k in PARTS)
    print(json.dumps({
        "steps": args.steps, "tokens": sum(r["tokens"] for r in reqs),
        "shapes": [r["shape"] for r in reqs], "wall_s": wall, "busy_s": busy,
        "kernel_s": total, "parts_s": parts,
        "context_share_of_kernel_time": context / total if total else None,
        "context_share_of_busy": context / busy if busy else None,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "top_kernels": top, "device": torch.cuda.get_device_name(0)}), flush=True)
    if forbidden_modules():
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
