"""The harness: discovery by name, the isolation check, the last line's
keys, and a small CPU rehearsal of every cell, the program's plain path
held to the reference."""
import json
import os
import sys
import uuid

import pytest

from port_bench import run
from port_bench.tests import small

WORKLOADS = ["design.rna", "specificity.dna", "design.score", "design.train"]


def test_isolation_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "na_mpnn_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlibrary", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "na_mpnn_tpu.models", object())
    assert run.forbidden_modules() == ["na_mpnn_tpu.models"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert "jax" in run.forbidden_modules()


def test_discovery_finds_new_files_without_edits():
    name = "dummy_" + uuid.uuid4().hex[:8]
    metric = os.path.join(run.HERE, "metrics", name + ".py")
    mix = os.path.join(run.HERE, "traffic", name + ".json")
    try:
        with open(metric, "w") as f:
            f.write("WRAPS = ['models.mpnn.sample']\n\ndef read(run):\n    return 42.0\n")
        with open(mix, "w") as f:
            json.dump({"driver": "cli", "argv": ["--mode", "design"]}, f)
        assert run.reader(name).read(None) == 42.0
        from port_bench import traffic
        assert traffic.load(name)["driver"] == "cli"
        assert run.driver_class("cli").__module__ == "port_bench.drivers.cli"
    finally:
        os.remove(metric)
        os.remove(mix)


def test_every_metric_has_a_reader_and_every_wrap_resolves():
    spec = run.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        r = run.reader(m["name"])
        for w in r.WRAPS:
            owner, attr = run.resolve(w)
            assert callable(getattr(owner, attr))
    for w in spec["workloads"]:
        assert run.metrics_of(spec, w["name"], False)
        assert run.metrics_of(spec, w["name"], True)
        assert os.path.exists(os.path.join(run.HERE, "limits", w["name"] + ".json"))


def test_metrics_of_splits_end_to_end_and_per_layer():
    spec = run.load_spec()
    names = {m["name"] for m in run.metrics_of(spec, "design.train", False)}
    assert names == {"train_tokens_per_s", "setup_s"}
    layer = {m["name"] for m in run.metrics_of(spec, "design.score", True)}
    assert "fused_layers_roofline.score" in layer and "fwd_bwd_ms.train" not in layer


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cpu_rehearsal(workload):
    """Each cell end to end on the CPU at a small size, traced: the program
    (its plain versions of the kernels) agrees with the reference, and the
    result has the keys of the last line, ``checks`` last."""
    result, checks, _ = run.run_cell(workload, 2 ** 31 + 5, 0.5, True, device="cpu",
                                     overrides=small.mix(workload))
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(result["device"])
    for name, value, limit in checks:
        assert value <= limit, (name, value, limit)
    readings = dict((k, v) for k, v, _ in checks)
    if workload == "design.train":
        assert readings["loss_gap"] < 5e-3     # bf16 program, fp32 reference
    else:
        assert readings["logp_gap"] < 1e-4    # fp32 against fp32


def test_cpu_rehearsal_untraced_reports_end_to_end():
    result, _, _ = run.run_cell("design.rna", 11, 0.5, False, device="cpu",
                                overrides=small.mix("design.rna"))
    assert set(result["metrics"]) == {"residues_per_s", "setup_s"}
    assert "breakdown" not in result and list(result)[-1] == "checks"


def test_train_reference_at_float32():
    """At float32 the program's training step and the reference's agree to
    round-off: the same noise, dropout masks and decode orders."""
    _, checks, _ = run.run_cell("design.train", 3, 0.2, False, device="cpu",
                                overrides=small.TRAIN,
                                config_overrides={"MIXED_PRECISION": 0})
    readings = {k: v for k, v, _ in checks}
    assert readings["loss_gap"] < 1e-5
    assert readings["grad_gap"] < 1e-4 and readings["update_gap"] < 1e-4
