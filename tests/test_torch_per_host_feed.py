"""The per-host training feed (``PER_HOST_FEED``, on by default with more
than one rank and ``MESH_GRAPH_AXIS`` 1): each rank of a gloo world of 2
CPU processes parses and collates only its own rows of each global batch
(``data/loader.py``, ``shard=(rank, world)``), pads them to the world's
longest L and sums its own metric rows, added over the ranks at the
epoch's end (``MetricManager.all_reduce_across_hosts``). One epoch of
``run_training`` with the feed ends with the replicated feed's parameters
(``PER_HOST_FEED: 0``, every rank loading the whole batch), bitwise, and
logs its epoch metrics within 1e-12 relative (float64 sums in another
order). Six structures at 120 batch tokens give clusters of one to three
structures, padded to an even global batch, so some ranks' rows are all
padding (the loader's all-masked batch). Also the loader's shard alone:
its rows are the replicated batch's rows of that rank."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import json

import numpy as np

import chip_smoke
from na_mpnn_tpu_torch.data import loader
from test_torch_mesh_workers import run_training_params, spawn

STRUCTURES = [(("A", "protein", 14 + 3 * i), ("B", "dna", 8), ("C", "dna", 8))
              for i in range(6)]


def _config(csv_path, base, **kw):
    return chip_smoke.training_config(
        csv_path, str(base), HIDDEN_DIM=32, NUM_NEIGHBORS=8,
        NUM_ENCODER_LAYERS=1, NUM_DECODER_LAYERS=1, BATCH_TOKENS=120,
        LOSS_TOKENS=100, **kw)


def test_per_host_feed_epoch_equals_the_replicated_feed(tmp_path):
    csv_path = chip_smoke.write_training_set(str(tmp_path / "ds"), STRUCTURES,
                                             seed=11)
    runs, logs = {}, {}
    for feed in (1, 0):
        base = tmp_path / f"feed{feed}"
        runs[feed] = spawn(run_training_params, 2, tmp_path / f"store{feed}",
                           (_config(csv_path, base, PER_HOST_FEED=feed),))
        with open(base / "log.jsonl") as f:
            logs[feed] = json.loads(f.readline())
    assert [r[1] for r in runs[1]] == [True, True]
    assert [r[1] for r in runs[0]] == [False, False]
    steps = {r[0] for rs in runs.values() for r in rs}
    assert len(steps) == 1 and steps.pop() >= 2
    for r in runs[1] + runs[0][1:]:
        np.testing.assert_array_equal(r[2], runs[0][0][2])
    assert logs[1]["steps"] == logs[0]["steps"]
    assert np.isfinite(logs[0]["train_loss"])
    for k, v in logs[0].items():
        if k == "loader_wait_s":
            continue
        w = logs[1][k]
        if np.isnan(v):
            assert np.isnan(w), k
        else:
            assert abs(w - v) <= 1e-12 * abs(v), (k, v, w)


def test_loader_shard_rows_are_the_replicated_rows(tmp_path):
    from na_mpnn_tpu_torch.data.dataset import (DatasetConfig, NADataset,
                                                make_batch_iter, parse_date,
                                                read_examples_csv)
    from na_mpnn_tpu_torch.data.parsers import make_parsers
    from na_mpnn_tpu_torch.train.collate import repad_length

    csv_path = chip_smoke.write_training_set(str(tmp_path / "ds"), STRUCTURES[:3],
                                             seed=12)
    cif, pdb = make_parsers()
    ds = NADataset(cif_parser=cif, pdb_parser=pdb, config=DatasetConfig())
    (cluster,) = list(make_batch_iter(read_examples_csv(csv_path), 10000, 1,
                                      parse_date("2030-01-01"), False, 1000,
                                      rng=np.random.RandomState(0)))
    whole = loader._load_and_collate(ds, cluster, 2)
    assert len(cluster) == 3 and whole["S"].shape[0] == 4
    for rank in range(2):
        part = loader._load_and_collate(ds, cluster, 2, shard=(rank, 2))
        part = repad_length(part, whole["S"].shape[1])
        for k, v in part.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, whole[k][2 * rank:2 * rank + 2],
                                              err_msg=k)
    empty = loader._load_and_collate(ds, cluster[:1], 4, shard=(1, 2))
    assert empty["S"].shape[0] == 2 and not empty["mask"].any()
    assert empty["X"].shape[2] == ds.num_atoms
