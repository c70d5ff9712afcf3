"""Parallel prefetching data loader (the port's copy of the JAX package's
``data/loader.py``).

A process pool parses and collates structure clusters ahead of the training
step, so that host-side parsing overlaps the device's work:

* the pool is persistent across epochs: created on first iteration, reused
  by every later one (``set_clusters`` swaps the epoch's clusters in);
* the dataset is pickled to each worker once, at pool start, not per task;
* each worker keeps a cache of parsed structures: epochs revisit the same
  files, so the steady state skips the parser and re-runs only the per-visit
  randomness (``NADataset.loader`` is still called per visit).

The workers start by ``spawn`` (a fresh interpreter each): the parent has
already initialised CUDA, which a forked child must not touch, and the
workers import only numpy and the port's data modules. ``close()`` shuts the
pool down.

With ``shard=(rank, world)`` (the per-host feed, ``PER_HOST_FEED``) each
process parses and collates only its own rows of each global batch: every
rank derives the same clusters from the shared batch-order seed, and the
global batch size from the cluster's size alone, so the ranks agree on it
without communicating (JAX ``data/loader.py:38-64``).
"""
from __future__ import annotations

import collections
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, Iterator, List, Optional, Tuple

from ..train.collate import bucket_batch, collate_batch

# Worker-process global (set by _worker_init; one dataset per worker).
_WORKER_DATASET = None


def _worker_init(dataset, parse_cache_size):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    dataset.enable_parse_cache(parse_cache_size)


def _load_and_collate(dataset, cluster, pad_batch_multiple, shard=None):
    if shard is not None:
        # This rank's rows of the global batch, whose size is a function of
        # the cluster's size alone (every rank has the same clusters); a row
        # that fails to parse stays padded, and a rank whose rows all fail
        # yields an all-masked batch, so every rank takes every step.
        rank, world = shard
        B_glob = bucket_batch(len(cluster))
        if pad_batch_multiple:
            B_glob = -(-B_glob // pad_batch_multiple) * pad_batch_multiple
        if B_glob % world:
            raise ValueError(f"global batch of {B_glob} rows does not split "
                             f"over {world} ranks")
        B_loc = B_glob // world
        structures = [dataset.loader(example, assembly_id)
                      for example, assembly_id in
                      cluster[rank * B_loc:(rank + 1) * B_loc]]
        structures = [s for s in structures if s]
        if not structures:
            return _empty_local_batch(dataset, B_loc)
        return collate_batch(structures, pad_batch_to=B_loc)
    structures = [dataset.loader(example, assembly_id)
                  for example, assembly_id in cluster]
    structures = [s for s in structures if s]
    pad_b = None
    if structures:
        # Bucket the batch dim and round up to the data-parallel divisor
        # when meshed (padded rows are fully masked and carry no loss).
        pad_b = bucket_batch(len(structures))
        if pad_batch_multiple:
            m = pad_batch_multiple
            pad_b = -(-pad_b // m) * m
    return collate_batch(structures, pad_batch_to=pad_b)


def _empty_local_batch(dataset, B_loc, L=64):
    """An all-masked batch of ``B_loc`` rows in the dataset's own atom table
    (16 or 65 atoms): a rank whose rows of a cluster all fail to parse takes
    its step on it (PAD tokens carry no loss)."""
    import numpy as np

    from .. import constants

    nA = dataset.num_atoms
    s = {
        "X": np.zeros([1, nA, 3], np.float32),
        "X_m": np.zeros([1, nA], np.int32),
        "mask": np.zeros([1], np.int32),
        "S": np.full([1], constants.RESTYPE_TO_INT["PAD"], np.int64),
        "R_idx": np.full([1], -100, np.int32),
        "chain_labels": np.full([1], -1, np.int64),
        "protein_mask": np.zeros([1], np.int32),
        "dna_mask": np.zeros([1], np.int32),
        "rna_mask": np.zeros([1], np.int32),
        "R_polymer_type": np.full([1], constants.POLYTYPE_TO_INT["PAD"],
                                  np.int64),
    }
    return collate_batch([s], pad_to=L, pad_batch_to=B_loc)


def _worker_load(cluster, pad_batch_multiple, shard):
    return _load_and_collate(_WORKER_DATASET, cluster, pad_batch_multiple,
                             shard)


class PrefetchLoader:
    """Iterate collated batches with worker-process prefetching.

    clusters: iterable of [(example_dict, assembly_id), ...] lists (the
    output of ``data.dataset.make_batch_iter``). ``num_workers=0`` loads
    inline (no processes; an inline parse cache still applies). Batches come
    in cluster order whatever the number of workers. ``shard=(rank,
    world)``: only this rank's rows of each global batch (the module's
    docstring).
    """

    def __init__(self, dataset, clusters: Iterable[List[Tuple]],
                 num_workers: int = 0, prefetch: int = 4,
                 pad_batch_multiple: Optional[int] = None,
                 parse_cache_size: int = 256,
                 shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.clusters = list(clusters)
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.pad_batch_multiple = pad_batch_multiple
        self.parse_cache_size = parse_cache_size
        self.shard = shard
        self._pool = None

    def __len__(self):
        return len(self.clusters)

    def set_clusters(self, clusters: Iterable[List[Tuple]]):
        """Swap the epoch's cluster list without recreating the pool."""
        self.clusters = list(clusters)

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(self.dataset, self.parse_cache_size))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __iter__(self) -> Iterator:
        if self.num_workers <= 0:
            self.dataset.enable_parse_cache(self.parse_cache_size)
            for cluster in self.clusters:
                batch = _load_and_collate(self.dataset, cluster,
                                          self.pad_batch_multiple, self.shard)
                if batch is not None:
                    yield batch
            return

        pool = self._ensure_pool()
        pending = collections.deque()
        it = iter(self.clusters)

        def submit_next():
            cluster = next(it, None)
            if cluster is None:
                return False
            pending.append(pool.submit(_worker_load, cluster,
                                       self.pad_batch_multiple, self.shard))
            return True

        for _ in range(self.num_workers + self.prefetch):
            if not submit_next():
                break
        while pending:
            batch = pending.popleft().result()
            submit_next()
            if batch is not None:
                yield batch
