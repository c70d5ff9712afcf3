"""Metric manager: mask-cross-product training metrics, accumulated on the
device (the port of the JAX package's ``train/metrics.py``).

Rows are {train, valid} x {, protein, dna, rna} x {, interface,
nonInterface}; columns are weights / canonicalBasePairWeights / loss /
accuracy / canonicalBasePairAccuracy / per-restype pred and true counts /
perplexity. Each batch adds its per-row sums in float64 on the device where
its tensors live (no host transfer per step; the JAX package sums in
float32); ``compute_metrics`` drains the sums to the host once per epoch.
With the per-host feed each rank sums its own rows, and
``all_reduce_across_hosts`` adds the ranks' sums before ``compute_metrics``.
The print string and ``as_dict`` are the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import constants


class MetricManager:
    def __init__(self, restype_to_int, weight_metrics, sum_metrics,
                 count_metrics, extra_metrics, dataset_names,
                 polymer_mask_names, interface_mask_names):
        self.restype_to_int = restype_to_int
        self.weight_metrics = weight_metrics
        self.sum_metrics = sum_metrics
        self.count_metrics = count_metrics
        self.extra_metrics = extra_metrics
        self.dataset_names = dataset_names
        self.polymer_mask_names = polymer_mask_names
        self.interface_mask_names = interface_mask_names

        self.all_mask_names = self._get_all_masks()
        self.mask_to_row = {m: i for i, m in enumerate(self.all_mask_names)}
        self.row_to_mask = {i: m for i, m in enumerate(self.all_mask_names)}

        self.metric_names = (
            list(weight_metrics) + list(sum_metrics)
            + ["pred" + m for m in count_metrics]
            + ["true" + m for m in count_metrics] + list(extra_metrics))
        self.metric_to_col = {m: i for i, m in enumerate(self.metric_names)}
        self.zero_metrics()

    def _get_all_masks(self) -> List[str]:
        names = []
        for d in self.dataset_names:
            for p in [""] + self.polymer_mask_names:
                for i in [""] + self.interface_mask_names:
                    n = d + (("_" + p) if p else "") + (("_" + i) if i else "")
                    names.append(n)
        return names

    def zero_metrics(self):
        self.metrics = np.zeros((len(self.mask_to_row), len(self.metric_to_col)),
                                np.float64)
        self._device_acc = {}

    def _batch_delta(self, loss, accuracy, cbp_accuracy, cbp_mask, S_true,
                     S_pred, masks_stack):
        """masks_stack: [R, B, L], the per-row combined masks -> [R, C]
        float64 sums."""
        def row_sum(x):
            return (x * masks_stack).sum(dim=(1, 2))

        cols = []
        if "weights" in self.weight_metrics:
            cols.append(masks_stack.sum(dim=(1, 2)))
        if "canonicalBasePairWeights" in self.weight_metrics:
            cols.append(row_sum(cbp_mask[None]))
        for metric in self.sum_metrics:
            if metric == "loss":
                cols.append(row_sum(loss[None]))
            elif metric == "accuracy":
                cols.append(row_sum(accuracy[None]))
            else:  # canonicalBasePairAccuracy
                cols.append(row_sum((cbp_accuracy * cbp_mask)[None]))
        for residue in self.count_metrics:
            cols.append(row_sum((S_pred == self.restype_to_int[residue])[None]))
        for residue in self.count_metrics:
            cols.append(row_sum((S_true == self.restype_to_int[residue])[None]))
        for _ in self.extra_metrics:
            cols.append(torch.zeros(masks_stack.shape[0], dtype=torch.float64,
                                    device=masks_stack.device))
        return torch.stack(cols, dim=-1)

    def accumulate(self, loss, accuracy, cbp_accuracy, cbp_mask, S_true,
                   S_pred, train_or_valid, mask_for_loss, polymer_masks,
                   interface_masks):
        """Add one batch's sums; the arrays (tensors or numpy, ``[B, L]``)
        are taken to the device of ``loss``."""
        dev = torch.as_tensor(loss).device

        def f64(x):
            return torch.as_tensor(x, device=dev).to(torch.float64)

        row_names, mask_list = [], []
        for p in [""] + list(polymer_masks.keys()):
            for i in [""] + list(interface_masks.keys()):
                name = train_or_valid
                m = f64(mask_for_loss)
                if p:
                    name += "_" + p
                    m = m * f64(polymer_masks[p])
                if i:
                    name += "_" + i
                    m = m * f64(interface_masks[i])
                row_names.append(name)
                mask_list.append(m)
        delta = self._batch_delta(
            f64(loss), f64(accuracy), f64(cbp_accuracy), f64(cbp_mask),
            torch.as_tensor(S_true, device=dev), torch.as_tensor(S_pred, device=dev),
            torch.stack(mask_list, dim=0))
        key = tuple(row_names)
        prev = self._device_acc.get(key)
        self._device_acc[key] = delta if prev is None else prev + delta

    def _drain_device_acc(self):
        for row_names, acc in self._device_acc.items():
            rows = np.array([self.mask_to_row[n] for n in row_names])
            self.metrics[rows] += acc.cpu().numpy()
        self._device_acc = {}

    def all_reduce_across_hosts(self, device="cpu"):
        """The per-host feed: each rank accumulated only its own rows; add
        the ranks' float64 sums (before normalisation) with one
        ``dist.all_reduce`` on ``device`` (the process group's: the card for
        NCCL), so every rank holds the global epoch's sums. Call before
        ``compute_metrics``; a no-op without a group of more than one rank
        (JAX ``metrics.py:126-138``, whose float32 cast is not copied)."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        self._drain_device_acc()
        total = torch.from_numpy(self.metrics).to(device)
        dist.all_reduce(total)
        self.metrics = total.cpu().numpy()

    # -- epoch-end normalization ----------------------------------------
    def compute_metrics(self):
        self._drain_device_acc()
        for metric, weight_metric in self.sum_metrics.items():
            w = self.metrics[:, self.metric_to_col[weight_metric]]
            c = self.metric_to_col[metric]
            zero = w == 0
            self.metrics[zero, c] = np.nan
            self.metrics[~zero, c] = self.metrics[~zero, c] / w[~zero]
        for metric, weight_metric in self.count_metrics.items():
            w = self.metrics[:, self.metric_to_col[weight_metric]]
            zero = w == 0
            for pref in ("true", "pred"):
                c = self.metric_to_col[pref + metric]
                self.metrics[zero, c] = np.nan
                self.metrics[~zero, c] = self.metrics[~zero, c] / w[~zero]
        if "perplexity" in self.extra_metrics:
            loss = self.metrics[:, self.metric_to_col["loss"]]
            self.metrics[:, self.metric_to_col["perplexity"]] = np.exp(loss)

    def create_print_string(self, e, step, train_time, valid_time) -> str:
        out = f"epoch: {e+1}, step: {step}, train_time: {train_time}, valid_time: {valid_time}"
        for r in range(len(self.row_to_mask)):
            name = self.row_to_mask[r]
            for metric in self.metric_names:
                data = np.format_float_positional(
                    np.float32(self.metrics[r, self.metric_to_col[metric]]),
                    unique=False, precision=3)
                out += f", {name}_{metric}: {data}"
        return out

    def as_dict(self) -> Dict[str, float]:
        """Structured (jsonl-friendly) view of the metric table."""
        out = {}
        for r in range(len(self.row_to_mask)):
            name = self.row_to_mask[r]
            for metric in self.metric_names:
                out[f"{name}_{metric}"] = float(self.metrics[r, self.metric_to_col[metric]])
        return out


def generate_metric_manager(restype_to_int=None, metrics_to_compute="basic"):
    """The JAX package's factory (reference generate_metric_manager)."""
    if restype_to_int is None:
        restype_to_int = constants.restype_to_int_table(True)
    base = dict(
        weight_metrics=["weights", "canonicalBasePairWeights"],
        sum_metrics={"loss": "weights", "accuracy": "weights",
                     "canonicalBasePairAccuracy": "canonicalBasePairWeights"},
        extra_metrics=["perplexity"],
    )
    counts = {r: "weights" for r in ["DA", "DC", "DG", "DT", "A", "C", "G", "U"]}
    if metrics_to_compute == "basic":
        kw = dict(base, count_metrics={}, dataset_names=["train", "valid"],
                  polymer_mask_names=["protein", "dna", "rna"],
                  interface_mask_names=[])
    elif metrics_to_compute == "all":
        kw = dict(base, count_metrics=counts, dataset_names=["train", "valid"],
                  polymer_mask_names=["protein", "dna", "rna"],
                  interface_mask_names=["interface", "nonInterface"])
    elif metrics_to_compute == "na_only_inference":
        kw = dict(base, count_metrics=counts, dataset_names=["valid"],
                  polymer_mask_names=["dna", "rna"], interface_mask_names=[])
    else:
        raise ValueError(f"unknown metrics_to_compute: {metrics_to_compute}")
    return MetricManager(restype_to_int=restype_to_int, **kw)
