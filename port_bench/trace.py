"""What a traced run (``--trace 1``) records: spans around the calls into
the program that the cell's metric readers name, and a ``torch.profiler``
trace of a bounded slice of requests right after the window.

A span synchronises the card before and after its call, so its host time
is the call's time on the card too; it also marks the call in the profiler
as ``port_bench.<name>``. The profile is reduced to the device's busy time
(the union of its operations' intervals), the operations by name, the
kernel launches inside each marked call, and the longest idle gaps by the
host operation that ran across them.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel|cuLaunchKernelEx)")


def _batch_shape(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dict) and "S" in a:
            return tuple(a["S"].shape)
    return None


class Spans:
    """Wraps attributes of the program's modules or classes and records each
    call as (start, end, shape of its batch's ``S``) under its name. With
    ``sync`` off (inside the profiled slice) a span only marks its call."""

    def __init__(self, sync: bool):
        self.sync = sync and torch.cuda.is_available()
        self.records = collections.defaultdict(list)
        self._undo = []

    def wrap(self, owner, attr: str, name: str):
        original = getattr(owner, attr)
        spans = self

        def timed(*args, **kwargs):
            if spans.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function("port_bench." + name):
                out = original(*args, **kwargs)
            if spans.sync:
                torch.cuda.synchronize()
            spans.records[name].append((t0, time.perf_counter(),
                                        _batch_shape(args, kwargs)))
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, original))

    def restore(self):
        for owner, attr, original in reversed(self._undo):
            setattr(owner, attr, original)
        self._undo.clear()

    def within(self, name, t0, t1):
        """The spans of ``name`` that lie inside [t0, t1]."""
        return [s for s in self.records.get(name, []) if s[0] >= t0 and s[1] <= t1]


def kernel_base(name: str) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters (``void (anonymous namespace)::tile_kernel<128, float>(...)``
    -> ``tile_kernel``)."""
    head = name.replace("(anonymous namespace)::", "")
    head = head[5:] if head.startswith("void ") else head
    return head.split("(")[0].split("<")[0].split("::")[-1].strip()


class Profile:
    """A ``torch.profiler`` capture of a slice of requests, reduced."""

    def __init__(self, out_dir):
        self.path = os.path.join(out_dir, "profile.json")
        self._prof = None
        self.t0 = self.t1 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        self._reduce(events)

    def _reduce(self, events):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        dev = sorted((e for e in spans if e.get("cat") in DEVICE_CATS),
                     key=lambda e: e["ts"])
        host = [e for e in spans if e.get("cat") not in DEVICE_CATS]
        self.window_s = ((max(e["ts"] + e["dur"] for e in spans)
                          - min(e["ts"] for e in spans)) / 1e6 if spans else 0.0)
        merged = []
        for e in dev:
            s, t = e["ts"], e["ts"] + e["dur"]
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) / 1e6
        by_name = collections.defaultdict(float)
        self.kernels = collections.defaultdict(float)      # base name -> s
        for e in dev:
            by_name[e["name"]] += e["dur"] / 1e6
            if e.get("cat") == "kernel":
                self.kernels[kernel_base(e["name"])] += e["dur"] / 1e6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        launches = sorted(e["ts"] for e in host
                          if e.get("cat") == "cuda_runtime" and LAUNCH.match(e["name"]))
        self.launches_in = collections.defaultdict(int)
        for e in host:
            if e.get("cat") == "user_annotation" and e["name"].startswith("port_bench."):
                a, b = e["ts"], e["ts"] + e["dur"]
                self.launches_in[e["name"][len("port_bench."):]] += (
                    bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a))
        self.idle_gaps = self._gaps(merged, host)

    @staticmethod
    def _gaps(merged, host, keep=2000):
        """The idle time between device operations by the innermost host
        operation that covers each gap's middle (the longest ``keep`` gaps)."""
        gaps = sorted(((t - s, s, t) for (_, s), (t, _) in zip(merged, merged[1:])),
                      reverse=True)[:keep]
        cpu = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                     if e.get("cat") in ("cpu_op", "user_annotation", "python_function"))
        starts = [c[0] for c in cpu]
        totals = collections.defaultdict(float)
        for dur, s, t in gaps:
            mid = (s + t) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "host (no operation recorded)"
            for j in range(i, max(i - 400, -1), -1):
                if cpu[j][1] >= mid:
                    name = cpu[j][2]
                    break
            totals[name] += dur / 1e6
        return sorted(totals.items(), key=lambda kv: -kv[1])[:10]
