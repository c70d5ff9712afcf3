"""The port's spans (``na_mpnn_tpu_torch/trace.py``) on the CPU: a CLI call
in each mode records its stages under one ``cli.call`` with one request id,
the stages cover the call, the encoder runs once per sampled structure (and
B + 1 times in score mode), the decode loop counts its steps (none
replayed on the CPU); a training step records its four stages; under
``torch.profiler`` the spans are named in the trace with the tracer off;
off and outside a profile nothing is recorded and ``record_function`` is
never entered; the buffer is bounded; ``ops.launch`` counts as
``LAUNCHES`` did."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import collections
import dataclasses
import gc
import json
import threading

import pytest
import torch

from chip_smoke import write_synthetic_pdb
from na_mpnn_tpu_torch import ops, trace
from na_mpnn_tpu_torch.cli.run import cli_entry
from na_mpnn_tpu_torch.data.pdb import parse_pdb
from na_mpnn_tpu_torch.models import ModelConfig, init_params
from na_mpnn_tpu_torch.params import save_checkpoint_npz
from na_mpnn_tpu_torch.train.collate import collate_batch
from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

# the mode's flags and the encoder rows one call runs (the score mode
# encodes its B tiled copies and once more for the unconditional pass)
MODES = {
    "design": (["--mode", "design", "--batch_size", "2"], 1),
    "specificity": (["--mode", "specificity", "--design_na_only", "1",
                     "--output_specificity", "1", "--batch_size", "3",
                     "--output_pdbs", "0"], 1),
    "score": (["--mode", "score", "--batch_size", "2"], 3),
}
STAGES = ("cli.load", "cli.parse", "cli.featurize", "cli.model", "cli.outputs")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    pdb = str(d / "mix.pdb")
    write_synthetic_pdb(pdb, (("A", "protein", 18), ("B", "dna", 8),
                              ("C", "dna", 8), ("D", "rna", 6)), seed=4)
    ckpt = str(d / "model.npz")
    save_checkpoint_npz(ckpt, init_params(5, ModelConfig(), device="cpu"))
    return d, pdb, ckpt


@pytest.fixture
def tracer():
    """The tracer on and empty; off and empty again afterwards."""
    trace.clear()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.clear()


def _within(inner, outer):
    """``inner`` opened and closed while ``outer`` was open."""
    return outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


def _run_cli(inputs, mode, out):
    d, pdb, ckpt = inputs
    cli_entry(["--checkpoint_na_mpnn", ckpt, "--pdb_path", pdb, "--seed", "3",
               "--out_folder", str(d / out), "--device", "cpu",
               "--stats_format", "npz", *MODES[mode][0]])


def test_off_records_nothing_and_enters_no_annotation(inputs, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    trace.disable()
    trace.clear()
    _run_cli(inputs, "design", "off")
    assert trace.records() == [] and entered == []
    assert trace.span("cli.call") is trace.span("train.step")    # the shared no-op


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_stages(inputs, tracer, mode):
    _run_cli(inputs, mode, mode)
    recs = tracer.records()
    by = collections.defaultdict(list)
    for r in recs:
        by[r.name].append(r)
    call, = by["cli.call"]
    structure, = by["cli.structure"]
    assert {r.request for r in recs} == {call.request}
    assert _within(structure, call)
    for name in STAGES:
        assert by[name], name
        for r in by[name]:
            assert _within(r, call if name == "cli.load" else structure), name
    covered = sum(r.t1 - r.t0 for name in STAGES for r in by[name])
    assert covered >= 0.95 * (call.t1 - call.t0)
    assert sum(r.counts["rows"] for r in by["model.encode"]) == MODES[mode][1]
    assert all(any(_within(r, m) for m in by["cli.model"]) for r in by["model.encode"])
    L = 40      # the residues of the four chains
    if mode == "score":
        assert not by["sample.decode"]
        return
    decode, = by["sample.decode"]
    assert decode.counts == {"steps": L, "replayed": 0}
    assert len(by["sample.step"]) == L
    assert all(_within(r, decode) for r in by["sample.step"])


def test_train_step_stages(tmp_path, tracer):
    pdb = str(tmp_path / "s.pdb")
    write_synthetic_pdb(pdb, (("A", "protein", 16), ("B", "dna", 8), ("C", "rna", 6)))
    parsed = parse_pdb(pdb)
    keys = ("X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
            "dna_mask", "rna_mask", "R_polymer_type")
    batch = collate_batch([{k: parsed[k] for k in keys}] * 2)
    cfg = dataclasses.replace(model_config_from_params({"MIXED_PRECISION": 0}),
                              hidden_dim=32, node_features=32, edge_features=32,
                              k_neighbors=8)
    trainer = Trainer(cfg, seed=0, device="cpu")
    tracer.clear()
    trainer.train_step(batch, torch.Generator().manual_seed(0))
    recs = tracer.records()
    step, = [r for r in recs if r.name == "train.step"]
    assert step.counts == {}
    stages = [r for r in recs if r.name in ("train.batch", "train.forward",
                                            "train.backward", "train.update")]
    assert [r.name for r in stages] == ["train.batch", "train.forward",
                                        "train.backward", "train.update"]
    assert all(_within(r, step) for r in stages)
    assert all(r.request == step.request for r in recs)
    assert [r.name for r in recs if r.name == "model.encode"] == ["model.encode"]


def test_profiler_names_the_spans_with_the_tracer_off(inputs, tmp_path):
    trace.disable()
    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run_cli(inputs, "design", "profiled")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    for name in ("cli.call", *STAGES, "cli.structure", "model.encode",
                 "sample.decode", "cli.pdbs"):
        assert names[name] >= 1, name
    assert names["sample.step"] == 40
    assert trace.records() == []


def test_buffer_is_bounded(tracer, monkeypatch):
    assert trace._records.maxlen == trace.MAX_RECORDS
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=16))
    for i in range(100):
        with trace.span("s", i=i):
            pass
    kept = trace.records()
    assert len(kept) == 16 and [r.counts["i"] for r in kept] == list(range(84, 100))
    for _ in range(3):    # held records are nested tuples the collector stops walking
        gc.collect()
    assert not any(gc.is_tracked(r) for r in trace._records)


def test_nesting_threads_and_late_counts(tracer):
    """A request holds the spans opened while its first span is open, those
    of other threads too; the next outermost span starts another; a span
    keeps the counts it was opened with."""
    with trace.span("outer", n=3):
        with trace.span("inner"):
            pass
        worker = threading.Thread(target=lambda: trace.span("other").__enter__().__exit__())
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    with trace.span("next"):
        pass
    r = {x.name: x for x in trace.records()}
    assert _within(r["inner"], r["outer"]) and _within(r["other"], r["outer"])
    assert r["inner"].request == r["other"].request == r["outer"].request
    assert r["next"].request != r["outer"].request
    assert r["outer"].counts == {"n": 3} and r["inner"].counts == {}


def test_counts_added_while_open(tracer):
    """``add`` sums into the counts a span was opened with, new keys too;
    on a span of a tracer that is off it does nothing."""
    with trace.span("work", files=0) as s:
        for _ in range(3):
            s.add(files=1)
        s.add(templates=1)
    trace.disable()
    with trace.span("off", files=0) as s:
        s.add(files=1)
    work, = trace.records()
    assert work.counts == {"files": 3, "templates": 1}


def test_launch_counts_as_before(tracer, inputs):
    before = dict(ops.LAUNCHES)
    _run_cli(inputs, "design", "launches")      # the plain versions: no launch
    assert dict(ops.LAUNCHES) == before
    assert not [r for r in trace.records() if r.name.startswith("kernel.")]
    with ops.launch("probe"):
        pass
    with pytest.raises(RuntimeError):
        with ops.launch("probe"):
            raise RuntimeError("launch failed")
    assert ops.LAUNCHES["probe"] - before.get("probe", 0) == 1
    assert [r.name for r in trace.records() if r.name.startswith("kernel.")] == \
        ["kernel.probe", "kernel.probe"]
    ops.LAUNCHES.pop("probe")
