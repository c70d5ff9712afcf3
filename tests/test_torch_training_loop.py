"""The port's data stack and training loop on the CPU against the JAX
package: ``cli/preprocess`` (every side file equal), ``NADataset`` +
``make_batch_iter`` + ``PrefetchLoader`` (the same batches, every key,
bitwise, from the same CSV and ``RandomState``; 2 spawn workers equal to
none), ``MetricManager`` (``as_dict`` within 1e-6 relative: JAX's float32
sums against the port's float64 sums; the print string equal), and
``run_training`` at a tiny
width (the JAX log keys plus ``loader_wait_s`` and ``steps``, a checkpoint
the JAX ``Trainer.restore`` reads, 2 epochs straight equal to 1 epoch plus a
resume for 1, bitwise). The device's random draws of the two packages
differ, so the loop's random parts are compared with themselves. The module
runs under ``torch.use_deterministic_algorithms(True)``: on the CPU the
backward of an index gather (``index_put_`` with accumulation) otherwise
sums in an order that changes from call to call, in the last bits."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import csv
import json
import os

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from na_mpnn_tpu import constants as jconst
from na_mpnn_tpu.cli.preprocess import main as jax_preprocess
from na_mpnn_tpu.data import dataset as jds
from na_mpnn_tpu.data.loader import PrefetchLoader as JaxLoader
from na_mpnn_tpu.data.parsers import make_parsers as jax_parsers
from na_mpnn_tpu.train import metrics as jmetrics
from na_mpnn_tpu.train import trainer as jtrainer

from na_mpnn_tpu_torch import constants
from na_mpnn_tpu_torch.data import dataset as ds
from na_mpnn_tpu_torch.data.loader import PrefetchLoader
from na_mpnn_tpu_torch.data.parsers import make_parsers
from na_mpnn_tpu_torch.train import metrics
from na_mpnn_tpu_torch.train.trainer import run_training, tree_leaves

STRUCTURES = [(("A", "protein", 14 + 3 * i), ("B", "dna", 8 + i), ("C", "dna", 8 + i))
              for i in range(5)]
BATCH_TOKENS = 100
TINY = dict(HIDDEN_DIM=32, NUM_NEIGHBORS=8, NUM_ENCODER_LAYERS=1,
            NUM_DECODER_LAYERS=1, BATCH_TOKENS=BATCH_TOKENS,
            LOSS_TOKENS=BATCH_TOKENS)


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 synthetic PDBs preprocessed by the port; the training CSV with one
    empty optional cell (``ppm_paths``), one row at sampling probability
    0.5 and one row dated after the cutoff."""
    root = tmp_path_factory.mktemp("train_data")
    csv_path = chip_smoke.write_training_set(str(root / "port"), STRUCTURES, seed=3)
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    rows[1]["ppm_paths"] = ""
    rows[3]["sampling_probability"] = "0.5"
    rows.append({**rows[0], "date": "2031-05-05"})
    edited = str(root / "train_edited.csv")
    with open(edited, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return {"root": root, "csv": csv_path, "edited": edited}


def test_preprocess_side_files_equal_jax(data):
    root = data["root"]
    out_jax = str(root / "jax_preprocessed")
    jax_preprocess([str(root / "port" / "input.csv"), out_jax, "1", "0",
                    str(root / "port" / "preprocess.json")])
    out_port = str(root / "port" / "preprocessed")
    dirs = sorted(os.listdir(out_jax))
    assert dirs == sorted(os.listdir(out_port))
    assert os.listdir(os.path.join(out_jax, "bad")) == []
    n = 0
    for d in dirs:
        files = sorted(os.listdir(os.path.join(out_jax, d)))
        assert files == sorted(os.listdir(os.path.join(out_port, d))), d
        for name in files:
            a, b = (os.path.join(o, d, name) for o in (out_jax, out_port))
            if name.endswith(".csv"):
                with open(a) as fa, open(b) as fb:
                    assert fa.read() == fb.read(), (d, name)
                continue
            ja = np.load(a, allow_pickle=True).item()
            pa = np.load(b, allow_pickle=True).item()
            assert list(ja) == list(pa), (d, name)
            for k in ja:
                np.testing.assert_array_equal(np.asarray(pa[k]), np.asarray(ja[k]))
                assert np.asarray(pa[k]).dtype == np.asarray(ja[k]).dtype
            n += 1
    assert n == 8 * len(STRUCTURES)


def _jax_batches(csv_path, seed):
    import pandas as pd
    df = pd.read_csv(csv_path)
    df["date"] = pd.to_datetime(df["date"], format="%Y-%m-%d")
    cutoff = pd.to_datetime("2030-01-01", format="%Y-%m-%d")
    dataset = jds.NADataset(*jax_parsers(skip_res=["HOH"]), config=jds.DatasetConfig(
        atom_list_to_save=tuple(jconst.BACKBONE_ATOMS), batch_tokens=BATCH_TOKENS))
    clusters = jds.make_batch_iter(df, BATCH_TOKENS, 1, cutoff, False, 1000,
                                   rng=np.random.RandomState(seed))
    return list(JaxLoader(dataset, clusters, num_workers=0))


def _port_batches(csv_path, seed, num_workers):
    rows = ds.read_examples_csv(csv_path)
    dataset = ds.NADataset(*make_parsers(skip_res=["HOH"]), config=ds.DatasetConfig(
        atom_list_to_save=tuple(constants.BACKBONE_ATOMS), batch_tokens=BATCH_TOKENS))
    clusters = ds.make_batch_iter(rows, BATCH_TOKENS, 1, ds.parse_date("2030-01-01"),
                                  False, 1000, rng=np.random.RandomState(seed))
    loader = PrefetchLoader(dataset, clusters, num_workers=num_workers)
    try:
        return list(loader)
    finally:
        loader.close()


def _assert_same_batches(got, want):
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


def test_dataset_and_loader_batches_equal_jax(data):
    rows = ds.read_examples_csv(data["edited"])
    assert rows[1]["ppm_paths"] == "" and isinstance(rows[3]["sampling_probability"], float)
    assert str(rows[-1]["date"]) == "2031-05-05"
    for seed in (0, 7):
        want = _jax_batches(data["edited"], seed)
        got = _port_batches(data["edited"], seed, 0)
        _assert_same_batches(got, want)
    _assert_same_batches(_port_batches(data["edited"], 7, 2), got)


def test_metric_manager_matches_jax():
    rng = np.random.RandomState(2)
    B, L = 3, 20

    def batch():
        S = rng.randint(0, 33, (B, L))
        return dict(
            loss=rng.rand(B, L).astype(np.float32) * 3,
            accuracy=(rng.rand(B, L) > 0.5).astype(np.float32),
            cbp_accuracy=(rng.rand(B, L) > 0.5).astype(np.float32),
            cbp_mask=(rng.rand(B, L) > 0.6).astype(np.int32), S_true=S,
            S_pred=np.where(rng.rand(B, L) > 0.3, S, rng.randint(0, 33, (B, L))),
            mask_for_loss=(rng.rand(B, L) > 0.1).astype(np.float32),
            polymer={k: (rng.rand(B, L) > 0.5).astype(np.int32)
                     for k in ("protein", "dna", "rna")},
            interface=(rng.rand(B, L) > 0.7).astype(np.int32))

    jm = jmetrics.generate_metric_manager(metrics_to_compute="all")
    pm = metrics.generate_metric_manager(metrics_to_compute="all")
    for split in ("train", "train", "valid"):
        b = batch()
        args = (b["loss"], b["accuracy"], b["cbp_accuracy"], b["cbp_mask"],
                b["S_true"], b["S_pred"], split, b["mask_for_loss"])
        jm.accumulate(*map(jax.numpy.asarray, args[:6]), split,
                      jax.numpy.asarray(args[7]),
                      {k: jax.numpy.asarray(v) for k, v in b["polymer"].items()},
                      {"interface": jax.numpy.asarray(b["interface"]),
                       "nonInterface": 1 - jax.numpy.asarray(b["interface"])})
        t = torch.from_numpy
        pm.accumulate(*[t(np.asarray(a)) for a in args[:6]], split, t(args[7]),
                      {k: t(v) for k, v in b["polymer"].items()},
                      {"interface": t(b["interface"]),
                       "nonInterface": 1 - t(b["interface"])})
    jm.compute_metrics()
    pm.compute_metrics()
    want, got = jm.as_dict(), pm.as_dict()
    assert list(got) == list(want) and len(want) > 100
    for k, w in want.items():
        if np.isnan(w):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - w) <= 1e-6 * max(abs(w), 1.0), (k, got[k], w)
    assert pm.create_print_string(0, 5, "1.000", "2.000") == \
        jm.create_print_string(0, 5, "1.000", "2.000")


def _config(data, base, **kw):
    return chip_smoke.training_config(data["csv"], str(base), **TINY, **kw)


def _log(base):
    with open(os.path.join(str(base), "log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def two_epochs(data, tmp_path_factory):
    base = tmp_path_factory.mktemp("two_epochs")
    trainer = run_training(_config(data, base), max_epochs=2, device="cpu")
    return base, trainer


def test_run_training_logs_and_checkpoint_read_by_jax(data, two_epochs):
    base, trainer = two_epochs
    logs = _log(base)
    assert [r["epoch"] for r in logs] == [1, 2]
    jax_keys = {"epoch", "step"} | set(jmetrics.generate_metric_manager(
        jconst.restype_to_int_table(True), "basic").as_dict())
    for r in logs:
        assert set(r) - jax_keys == {"loader_wait_s", "steps"}
        assert jax_keys <= set(r)
        assert np.isfinite(r["train_loss"]) and r["steps"] >= 2
    assert logs[1]["step"] == trainer.step == logs[0]["steps"] + logs[1]["steps"]
    with open(os.path.join(str(base), "log.txt")) as f:
        assert len(f.read().splitlines()) == 3
    cfg = _config(data, base)
    jt = jtrainer.Trainer(jtrainer.model_config_from_params(cfg), seed=3)
    meta = jt.restore(os.path.join(str(base), "last.npz"))
    assert int(meta["epoch"]) == 2 and jt.step == trainer.step
    leaves = jax.tree.leaves(jt.params)
    port = list(tree_leaves(trainer.params))
    assert len(leaves) == len(port)
    for a, b in zip(leaves, port):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_resume_replays_the_epoch_bitwise(data, two_epochs, tmp_path):
    base, straight = two_epochs
    run_training(_config(data, tmp_path), max_epochs=1, device="cpu")
    resumed = run_training(
        _config(data, tmp_path, PREV_CHECKPOINT=str(tmp_path / "last.npz")),
        max_epochs=1, device="cpu")
    a, b = _log(base), _log(tmp_path)
    for r in a + b:
        r.pop("loader_wait_s")
    assert json.dumps(a) == json.dumps(b)
    assert torch.equal(straight.flat, resumed.flat)
    assert torch.equal(straight.opt_state.mu, resumed.opt_state.mu)
    assert torch.equal(straight.opt_state.nu, resumed.opt_state.nu)


@pytest.mark.parametrize("override", [{"ATOMS_TO_LOAD": "all"},
                                      {"CHECKPOINT_FORMAT": "orbax"}])
def test_unported_options_raise(data, tmp_path, override):
    """Orbax checkpoints still raise. The 65-atom table (``ATOMS_TO_LOAD:
    all``), which raised before its frame was ported (the case keeps its
    id), trains an epoch: 65-atom batches, a 67-slot RBF block, finite
    losses, a checkpoint with its ``[16 + 16 * 67^2, H]`` edge weight."""
    if "CHECKPOINT_FORMAT" in override:
        with pytest.raises(NotImplementedError):
            run_training(_config(data, tmp_path, **override), max_epochs=1,
                         device="cpu")
        return
    tr = run_training(_config(data, tmp_path, **override), max_epochs=1,
                      device="cpu")
    assert tr.cfg.atom_table == "all" and tr.cfg.total_atoms == 67
    assert tuple(tr.params["features"]["edge_embedding"]["w"].shape) == (
        16 + 16 * 67 ** 2, 32)
    (log,) = _log(tmp_path)
    assert np.isfinite(log["train_loss"]) and log["steps"] >= 1
    assert os.path.exists(tmp_path / "last.npz")
