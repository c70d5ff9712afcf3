"""Visualization & log analysis.

Script-form port of the reference notebooks (reference visualization/*.ipynb):
training-curve parsing of the epoch log lines, in-silico result aggregation,
and PPM sequence logos.

The port's own copy of the JAX package's ``eval/visualize.py``. A plotting
and log tool that never runs on the card: it keeps the JAX module's
``pandas`` and ``matplotlib`` imports inside its functions, so importing
it needs neither.
"""
from __future__ import annotations

import glob
import json
from typing import Dict, Optional

import numpy as np


def parse_training_log(log_path: str) -> "pandas.DataFrame":
    """Parse the metric-manager epoch lines of log.txt into a DataFrame
    (the reference's plot_training_metrics.ipynb parses the same format:
    'epoch: N, step: N, ..., <mask>_<metric>: value, ...')."""
    import pandas as pd

    rows = []
    for line in open(log_path):
        line = line.strip()
        if not line.startswith("epoch:"):
            continue
        row: Dict = {}
        for item in line.split(", "):
            if ": " not in item:
                continue
            k, v = item.split(": ", 1)
            try:
                row[k] = float(v)
            except ValueError:
                row[k] = v
        rows.append(row)
    return pd.DataFrame(rows)


def plot_training_metrics(log_path: str, metrics=("loss", "accuracy"),
                          splits=("train", "valid"), out_path: Optional[str] = None):
    """Training curves for the given metric/split combinations."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = parse_training_log(log_path)
    fig, axes = plt.subplots(1, len(metrics), figsize=(5 * len(metrics), 4))
    if len(metrics) == 1:
        axes = [axes]
    for ax, metric in zip(axes, metrics):
        for split in splits:
            col = f"{split}_{metric}"
            if col in df:
                ax.plot(df["step"], df[col], label=split)
        ax.set_xlabel("step")
        ax.set_ylabel(metric)
        ax.legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


LOGO_COLORS = {"A": "#109648", "C": "#255C99", "G": "#F7B32B", "T": "#D62839",
               "U": "#D62839"}


def _draw_logo(ax, ppm, alphabet, true_sequence=None, logo_type="information"):
    """Render one logo onto `ax`: information-content-scaled (or raw
    probability) letter stacks, small-on-bottom, optional true-sequence
    x-tick labels (the reference's plot_seq_logo rendering contract,
    visualization/plot_seq_logos.ipynb)."""
    ppm = np.asarray(ppm, np.float64)
    eps = 1e-10
    p = (ppm + eps) / (ppm + eps).sum(-1, keepdims=True)
    if logo_type == "information":
        ic = np.log2(len(alphabet)) + np.sum(p * np.log2(p), axis=-1)  # bits
        heights = p * ic[:, None]
        y_max = np.log2(len(alphabet))
    else:
        heights = p
        y_max = 1.0
    for pos in range(len(ppm)):
        order = np.argsort(heights[pos])
        y = 0.0
        for k in order:
            h = heights[pos, k]
            if h <= 0:
                continue
            ax.text(pos + 0.5, y + h / 2, alphabet[k], ha="center",
                    va="center", fontsize=14, fontweight="bold",
                    color=LOGO_COLORS.get(alphabet[k], "black"),
                    transform=ax.transData)
            y += h
    ax.set_xlim(0, len(ppm))
    ax.set_ylim(0, y_max)
    if true_sequence is not None:
        ax.set_xticks(np.arange(len(ppm)) + 0.5)
        ax.set_xticklabels([alphabet[int(t)] if 0 <= int(t) < len(alphabet)
                            else "" for t in true_sequence], fontsize=8)
    ax.set_ylabel("bits" if logo_type == "information" else "p")


def sequence_logo(ppm: np.ndarray, alphabet=("A", "C", "G", "T"),
                  out_path: Optional[str] = None, title: str = "",
                  true_sequence=None, logo_type: str = "information"):
    """Information-content-scaled sequence logo from an [L,4] PPM (role of
    the reference's seq-logo notebook cells)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(max(4, 0.45 * len(ppm)), 2.5))
    _draw_logo(ax, ppm, alphabet, true_sequence=true_sequence,
               logo_type=logo_type)
    ax.set_xlabel("position")
    ax.set_title(title)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def load_predicted_ppm_and_true_sequence(score_json_path: str,
                                         num_chains_to_plot: int = 1):
    """From a specificity score JSON (harness.score_specificity_prediction
    output), extract aligned [P,4] experimental and predicted DNA PPMs plus
    the true sequence over the first `num_chains_to_plot` DNA chains — the
    reference's load_predicted_pwm_and_true_sequence
    (visualization/plot_seq_logos.ipynb cell 4)."""
    from .. import constants

    score = json.load(open(score_json_path))
    subject = json.load(open(score["subject_path"]))

    aligned_ppm = np.asarray(score["aligned_ppm"], np.float64)
    ppm_mask = np.asarray(score["ppm_mask"], np.int32)
    pred_ppm = np.asarray(subject["predicted_ppm_na_mpnn_format"], np.float64)
    mask = np.asarray(subject["mask"], np.int32)
    dna_mask = np.asarray(subject["dna_mask"], np.int32)
    true_seq = np.asarray(subject["true_sequence_na_mpnn_format"], np.int64)
    chain_labels = np.asarray(subject["chain_labels"], np.int64)

    pos = (ppm_mask == 1) & (mask == 1) & (dna_mask == 1)
    dna_chains = list(dict.fromkeys(chain_labels[pos].tolist()))
    keep_chains = set(dna_chains[:num_chains_to_plot])
    pos = pos & np.isin(chain_labels, list(keep_chains))

    dna_cols = [constants.restype_to_int_table(True)[r]
                for r in ("DA", "DC", "DG", "DT")]
    ref4 = aligned_ppm[pos][:, dna_cols]
    pred4 = pred_ppm[pos][:, dna_cols]
    pred4 = pred4 / np.maximum(pred4.sum(-1, keepdims=True), 1e-12)
    token0 = min(dna_cols)
    return ref4, pred4, true_seq[pos] - token0


def plot_seq_logo_comparison(score_json_path: str,
                             num_chains_to_plot: int = 1,
                             out_path: Optional[str] = None,
                             titles=("experimental", "predicted")):
    """Predicted-vs-experimental PPM logo comparison figure: two stacked
    logos over the same DNA positions, true sequence as x-tick labels
    (role of the reference plot_seq_logo_comparison,
    visualization/plot_seq_logos.ipynb cells 12-21)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ref4, pred4, true_seq = load_predicted_ppm_and_true_sequence(
        score_json_path, num_chains_to_plot)
    alphabet = ("A", "C", "G", "T")
    fig, axes = plt.subplots(2, 1, figsize=(max(4, 0.45 * len(ref4)), 4.6),
                             sharex=True)
    for ax, ppm, title in zip(axes, (ref4, pred4), titles):
        _draw_logo(ax, ppm, alphabet, true_sequence=true_seq)
        ax.set_title(title, fontsize=9)
    axes[-1].set_xlabel("position (true base)")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def running_mean(x, N: int):
    """Cumulative-sum running mean (the reference's smoothing helper,
    visualization/plot_training_metrics.ipynb cell 4)."""
    x = np.asarray(x, np.float64)
    if N <= 1 or len(x) < N:
        return x
    c = np.cumsum(np.insert(x, 0, 0.0))
    return (c[N:] - c[:-N]) / float(N)


# Per-polymer palette + linestyles of the reference training-curve figures
# (visualization/plot_training_metrics.ipynb cell 2).
POLYMER_PALETTE = {"protein": "#D3D3D3", "dna": "#FF7F7F", "rna": "#7F7FFF"}
SPLIT_LINESTYLE = {"train": "solid", "valid": "dashed"}


def plot_per_polymer_training_curves(log_path: str,
                                     metrics=("accuracy", "loss"),
                                     polymers=("protein", "dna", "rna"),
                                     splits=("train", "valid"),
                                     smooth: int = 1,
                                     out_path: Optional[str] = None):
    """Per-residue-type training-curve panels: one panel per metric, one
    line per (polymer, split) with the reference palette — protein grey,
    DNA red, RNA blue; train solid, valid dashed (role of the reference
    plot_results calls, visualization/plot_training_metrics.ipynb cells
    8-9). `smooth` applies an N-point running mean."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = parse_training_log(log_path)
    fig, axes = plt.subplots(1, len(metrics), figsize=(5.2 * len(metrics), 4))
    if len(metrics) == 1:
        axes = [axes]
    for ax, metric in zip(axes, metrics):
        for polymer in polymers:
            for split in splits:
                col = f"{split}_{polymer}_{metric}"
                if col not in df:
                    continue
                y = running_mean(df[col].to_numpy(), smooth)
                x = df["step"].to_numpy()[len(df) - len(y):]
                ax.plot(x, y, label=f"{polymer.upper()} ({split})",
                        color=POLYMER_PALETTE.get(polymer),
                        linestyle=SPLIT_LINESTYLE.get(split, "solid"))
        ax.set_xlabel("step")
        ax.set_ylabel(metric)
        ax.legend(fontsize=7, frameon=False)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def aggregate_result_jsons(results_glob: str) -> "pandas.DataFrame":
    """Collect per-design/per-structure score JSONs into one table (role of
    the reference plot_in_silico_results.ipynb aggregation cells)."""
    import pandas as pd

    rows = []
    for path in sorted(glob.glob(results_glob)):
        try:
            row = json.load(open(path))
        except json.JSONDecodeError:
            continue
        flat = {k: v for k, v in row.items()
                if np.isscalar(v) or isinstance(v, str)}
        flat["result_path"] = path
        rows.append(flat)
    return pd.DataFrame(rows)


def dataset_statistics(scan_csv: str, out_path: str = None):
    """Dataset composition summary + optional figure from a curation scan CSV
    (role of the reference visualization/plot_dataset_statistics.ipynb):
    polymer-type counts, chain-count/heavy-atom/coverage distributions,
    method breakdown, deposition-date histogram. Returns the summary dict."""
    import ast
    import pandas as pd

    df = pd.read_csv(scan_csv)
    type_counts: dict = {}
    n_chains = []
    for v in df.get("poly_type", []):
        types = ast.literal_eval(v) if isinstance(v, str) else (v or [])
        n_chains.append(len(types))
        for t in types:
            type_counts[t] = type_counts.get(t, 0) + 1
    summary = {
        "num_structures": int(len(df)),
        "polymer_type_counts": type_counts,
        "mean_chains_per_structure": float(np.mean(n_chains)) if n_chains else 0.0,
        "method_counts": df["method"].value_counts().to_dict()
        if "method" in df else {},
        "median_resolution": float(df["resolution"].dropna().median())
        if "resolution" in df and df["resolution"].notna().any() else None,
        "mean_coverage": float(df["coverage"].mean()) if "coverage" in df else None,
        "total_heavy_atoms": int(df["num_heavy"].sum()) if "num_heavy" in df else None,
    }
    if out_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
        if type_counts:
            axes[0].bar(range(len(type_counts)), list(type_counts.values()))
            axes[0].set_xticks(range(len(type_counts)))
            axes[0].set_xticklabels([t[:12] for t in type_counts], rotation=45,
                                    ha="right", fontsize=7)
            axes[0].set_title("chains by polymer type")
        if "num_heavy" in df:
            axes[1].hist(df["num_heavy"].dropna(), bins=30)
            axes[1].set_title("heavy atoms / structure")
        if "resolution" in df and df["resolution"].notna().any():
            axes[2].hist(df["resolution"].dropna(), bins=30)
            axes[2].set_title("resolution (Å)")
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
    return summary


def load_experimental_results(csv_path: str):
    """Load an OpenKnotBench-style experimental results CSV (role of the
    reference visualization/plot_experimental_results.ipynb data cells):
    slice each row's design subsequence out of the full construct via
    sub_start/sub_end (1-based inclusive, as the benchmark encodes them) and
    collect its per-position reactivity vector from the reactivity_* columns
    (error columns excluded). Returns the DataFrame with added `design_seq`
    and `reactivity_vec` columns."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    if {"sequence", "sub_start", "sub_end"} <= set(df.columns):
        df["design_seq"] = df.apply(
            lambda r: r["sequence"][int(r["sub_start"]) - 1:int(r["sub_end"])],
            axis=1)
    react_cols = [c for c in df.columns
                  if "reactivity" in c and "error" not in c]
    if react_cols:
        vecs = []
        for _, r in df.iterrows():
            v = np.asarray(r[react_cols], np.float64)
            if "sub_start" in df.columns:
                v = v[int(r["sub_start"]) - 1:int(r["sub_end"])]
            vecs.append(v)
        df["reactivity_vec"] = vecs
    return df


def experimental_results_summary(csv_path: str, methods=None, rounds=None,
                                 score_col: str = "target_openknot_score",
                                 method_col: str = "method",
                                 round_col: str = "round",
                                 out_path: Optional[str] = None):
    """Per-method score statistics + boxplot from an experimental benchmark
    CSV (role of the reference plot_openknot_score_boxplot: filter to the
    given methods/rounds, print count/median per method, draw per-method
    score boxplots). Returns the (method, round) -> {count, median, mean}
    summary DataFrame."""
    import pandas as pd

    df = load_experimental_results(csv_path)
    if methods is not None and method_col in df:
        df = df[df[method_col].isin(list(methods))]
    if rounds is not None and round_col in df:
        df = df[df[round_col].isin(list(rounds))]
    group_cols = [c for c in (method_col, round_col) if c in df]
    summary = df.groupby(group_cols)[score_col].agg(
        ["count", "median", "mean"]).reset_index()

    if out_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        order = (list(methods) if methods is not None
                 else sorted(df[method_col].unique()))
        data = [df[df[method_col] == m][score_col].dropna() for m in order]
        fig, ax = plt.subplots(figsize=(1.0 + 0.9 * len(order), 3.2))
        ax.boxplot(data, showfliers=False)
        ax.set_xticks(range(1, len(order) + 1), order)  # portable across mpl versions
        for i, vals in enumerate(data):
            if len(vals):
                x = np.random.RandomState(0).normal(i + 1, 0.06, len(vals))
                ax.plot(x, vals, ".", ms=3, alpha=0.5)
        ax.set_ylabel(score_col)
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
    return summary


def summarize_scores(results_glob: str, group_by: str = None):
    """Aggregate score JSONs into per-metric mean/median/count stats (role of
    the reference plot_in_silico_results.ipynb / plot_experimental_results
    summary cells). Returns (per_row_df, summary_df)."""
    import pandas as pd

    df = aggregate_result_jsons(results_glob)
    num = df.select_dtypes("number")
    if group_by and group_by in df:
        summary = df.groupby(group_by)[num.columns].agg(
            ["mean", "median", "count"])
    else:
        summary = pd.DataFrame({
            "mean": num.mean(), "median": num.median(),
            "count": num.count(),
        })
    return df, summary


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("curves")
    c.add_argument("log_path")
    c.add_argument("out_path")
    lg = sub.add_parser("logo")
    lg.add_argument("specificity_npz")
    lg.add_argument("out_path")
    ag = sub.add_parser("aggregate")
    ag.add_argument("results_glob")
    ag.add_argument("out_csv")
    st = sub.add_parser("dataset_stats")
    st.add_argument("scan_csv")
    st.add_argument("out_png")
    sm = sub.add_parser("summarize")
    sm.add_argument("results_glob")
    sm.add_argument("out_csv")
    sm.add_argument("--group_by")
    ex = sub.add_parser("experimental")
    ex.add_argument("csv_path")
    ex.add_argument("out_png")
    ex.add_argument("--methods", nargs="*")
    ex.add_argument("--score_col", default="target_openknot_score")
    args = p.parse_args(argv)

    if args.cmd == "curves":
        plot_training_metrics(args.log_path, out_path=args.out_path)
    elif args.cmd == "logo":
        from .harness import compute_human_readable_ppm
        data = np.load(args.specificity_npz, allow_pickle=True)
        hr = compute_human_readable_ppm(data["predicted_ppm"],
                                        data["dna_mask"], data["rna_mask"])
        sequence_logo(hr, out_path=args.out_path)
    elif args.cmd == "aggregate":
        aggregate_result_jsons(args.results_glob).to_csv(args.out_csv, index=False)
    elif args.cmd == "dataset_stats":
        print(json.dumps(dataset_statistics(args.scan_csv, args.out_png),
                         indent=2))
    elif args.cmd == "summarize":
        _, summary = summarize_scores(args.results_glob, args.group_by)
        summary.to_csv(args.out_csv)
        print(summary)
    elif args.cmd == "experimental":
        summary = experimental_results_summary(
            args.csv_path, methods=args.methods, score_col=args.score_col,
            out_path=args.out_png)
        print(summary.to_string(index=False))


if __name__ == "__main__":
    main()
