"""The dense RBF projection and its weight gradient (kernel rows 5 and 6,
``csrc/rbf_edge.cu``, ``csrc/rbf_edge_dw.cu``) on the group walks of
``csrc/rbf_tile.cuh``. The kernels run only on the card; this file holds,
on the CPU, what the wrappers (``ops/rbf_edge.py`` through
``ops/rbf_common.py``'s ``group_forward`` and ``group_dw``) hand them and a
plain model of what they compute from it with the dense bins: the edges'
lists and group lists, the reference-order ``W`` permuted into the four
pair-major group tables (``_pair_row_map``) with no fold scale, the
forward tile by tile of each list (``per_group_forward`` of
``test_torch_rbf_fwd_groups.py``), the weight gradient per group table over
that group's list in ``DW_SPLITS`` fixed ranges summed in order, written
back through the row map. The bins are the exact Gaussians at fp32 and the
exact Gaussians rounded to bf16 at bf16 (not the classed bf16 branch's
damped bins).

Structures (``test_torch_rbf_fwd_groups.py``'s): protein rows, nucleic rows,
two residues with atoms in both blocks, masked rows; a protein-only one;
each with its own rows as keys and as a 16-row shard against the
structure's 48 key rows (the graph-parallel route's operands, Lk != L).

Tolerances. At float64 the model adds only exact zeros beyond the dense
sum, so it equals ``rbf_edge_features_plain`` / ``rbf_edge_dw_plain`` to
1e-8 (the repo's float64 bar). Against the JAX ``rbf_edge_features`` and
its VJP (``rbf_edge_embed`` / ``rbf_edge_embed_dw`` with the Pallas kernels
in interpret mode): 2e-6 relative at fp32 (the bar of
``test_torch_kernels.py``), and at bf16 ``TOL_RBF`` = 1e-3, the bar and
reason of ``test_torch_bf16_rows5to8.py`` (both sides round each masked
exact bin to bf16, but the JAX kernel takes ``(D - mu) * (1 / sigma)`` and
its own exp, so a bin within an fp32 ulp of a bf16 boundary rounds apart,
moving a sum by 2^-8 of that one term). The shard's JAX reference is the
whole structure's output at the shard's rows, and its gradient with the
cotangent zero on every other row.
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.ops import rbf_edge as jrbf

from na_mpnn_tpu_torch.models.features import all_pair_rbf
from na_mpnn_tpu_torch.ops import rbf_classed, rbf_common, rbf_edge
from test_torch_rbf_fwd_groups import (B, H, K, TILE, _member, _operands,
                                       _structure, per_group_forward)

CSRC = Path(rbf_common.__file__).resolve().parent.parent / "csrc"
TOL_RBF = 1e-3
KEYS = ["own", "shard"]
KINDS = ["mixed", "protein"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_math_warmed_up():
    """Computes the bins once and throws them away: a process's first
    multi-threaded ``torch.sqrt`` on the CPU can compute one thread's chunk
    at low accuracy, which the bf16 bins amplify past ``TOL_RBF`` (see
    ``test_torch_bf16_rows5to8.py``'s fixture of the same name)."""
    X, Xm, E_idx, _ = _structure("mixed")
    X, Xm = torch.from_numpy(X), torch.from_numpy(Xm)
    all_pair_rbf(X, torch.from_numpy(E_idx), Xm, 16)


def _cotangent(Eq, seed=5):
    return np.random.RandomState(seed).randn(*Eq.shape, H).astype(np.float32)


def _lists(Mq, Mk, Eq):
    """The weight gradient's group lists on CPU tensors (masks in PERM
    order, flat key rows), as ``group_dw`` makes them."""
    Lq, Lk = Mq.shape[1], Mk.shape[1]
    Mq = Mq[:, :, rbf_common.PERM].reshape(B * Lq, 18)
    Mk = Mk[:, :, rbf_common.PERM].reshape(B * Lk, 18)
    nbr = (Eq + Lk * torch.arange(B)[:, None, None]).reshape(-1)
    return rbf_common.edge_group_lists(rbf_common.edge_groups(Mq, Mk, nbr, K))


def _group_slices():
    sizes = [16 * len(q) * len(n) for q, n in rbf_common.GROUP_SELS]
    ends = np.cumsum(sizes)
    return [(int(e - s), int(e)) for s, e in zip(sizes, ends)]


def per_group_dw(bins, lists, counts, g):
    """The weight-gradient walk: ``bins [E, 5184]`` (reference order) and
    the cotangent ``g [E, H]`` -> ``[5184, H]`` in the reference order; each
    group table's pair-major rows over that group's list, in ``DW_SPLITS``
    fixed ranges whose partials are added in order."""
    rowmap = rbf_common._pair_row_map(torch.device("cpu"))
    bins_k = bins[:, rowmap]
    out = torch.full((rowmap.shape[0], g.shape[1]), float("nan"), dtype=g.dtype)
    S = rbf_common.DW_SPLITS
    for grp, (lo, hi) in enumerate(_group_slices()):
        cnt = int(counts[grp])
        acc = torch.zeros((hi - lo, g.shape[1]), dtype=g.dtype)
        for s in range(S):
            edges = lists[grp, s * cnt // S:(s + 1) * cnt // S]
            acc = acc + bins_k[edges, lo:hi].T @ g[edges]
        out[rowmap[lo:hi]] = acc
    assert not torch.isnan(out).any()
    return out


def _dense_bins(Xq, Mq, Eq, Xk, Mk, low):
    """``[E, 5184]`` float64: the exact bins, at bf16 rounded to bf16."""
    bins = all_pair_rbf(Xq, Eq, Mq, 16, Xk, Mk).reshape(Eq.numel(), -1)
    return (bins.to(torch.bfloat16) if low else bins).double()


def _model(ops, W, G, low, damped=False):
    """The kernels' forward ``[E, H]`` and weight gradient ``[5184, H]`` at
    float64 from fp32 operands: the dense bins (``damped``: the classed
    bf16 branch's damped bins against the fold-scaled weight, the gradient
    taken back through the fold scales) against ``W`` (at bf16 rounded)."""
    Xq, Mq, Xk, Mk, Eq = (torch.from_numpy(v) for v in ops)
    member, code = _member(Mq, Mk, Eq)
    lists, counts = _lists(Mq, Mk, Eq)
    Wt, g = torch.from_numpy(W), torch.from_numpy(G).reshape(-1, H)
    if damped:
        bins = rbf_classed.rbf_bins_bf16(Xq, Mq, Eq, Xk, Mk).double()
        Wt = rbf_classed.fold_scaled(Wt)
    else:
        bins = _dense_bins(Xq, Mq, Eq, Xk, Mk, low)
    if low:
        Wt, g = Wt.to(torch.bfloat16), g.to(torch.bfloat16)
    out = per_group_forward(bins, member, code, Wt.double())
    dw = per_group_dw(bins, lists, counts, g.double())
    if damped:
        scales = torch.from_numpy(rbf_classed.bin_fold_scales()).repeat(18 * 18)
        dw = dw * scales.double()[:, None]
    return out, dw


def _jax(X, Xm, E_idx, W, G, keys, low):
    """JAX's dense forward ``[E, H]`` and weight gradient at the operands'
    query rows: the shard's rows of the whole structure's output, and the
    gradient with the cotangent zero outside them."""
    sl = slice(16, 32) if keys == "shard" else slice(None)
    cot = np.zeros(E_idx.shape + (H,), np.float32)
    cot[:, sl] = G

    def f(w):
        return jrbf.rbf_edge_features(jnp.asarray(X), jnp.asarray(Xm),
                                      jnp.asarray(E_idx.astype(np.int32)), w,
                                      compute_dtype=jnp.bfloat16 if low else jnp.float32,
                                      interpret=True)

    out = np.asarray(f(jnp.asarray(W)))[:, sl].reshape(-1, H)
    dw = jax.grad(lambda w: jnp.sum(f(w) * jnp.asarray(cot)))(jnp.asarray(W))
    return out, np.asarray(dw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


def _rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("kind", KINDS)
def test_dense_group_walk_equals_the_plain_dense_float64(kind, keys):
    X, Xm, E_idx, W = _structure(kind)
    Xq, Mq, Xk, Mk, Eq = (torch.from_numpy(v).double() if v.dtype == np.float32
                          else torch.from_numpy(v)
                          for v in _operands(X, Xm, E_idx, keys))
    Wt = torch.from_numpy(W).double()
    g = torch.from_numpy(_cotangent(Eq)).double()
    bins = _dense_bins(Xq, Mq, Eq, Xk, Mk, low=False)
    got = per_group_forward(bins, *_member(Mq, Mk, Eq), Wt)
    want = rbf_edge.rbf_edge_features_plain(Xq, Mq, Eq, Wt, Xk, Mk)
    np.testing.assert_allclose(got.numpy(), want.reshape(-1, H).numpy(), rtol=0,
                               atol=1e-8)
    dw = per_group_dw(bins, *_lists(Mq, Mk, Eq), g.reshape(-1, H))
    np.testing.assert_allclose(dw.numpy(), rbf_edge.rbf_edge_dw_plain(
        Xq, Mq, Eq, g, Xk, Mk).numpy(), rtol=0, atol=1e-8)


@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("low", [False, True])
def test_dense_group_walk_matches_jax_pallas(low, keys):
    X, Xm, E_idx, W = _structure("mixed", seed=1)
    ops = _operands(X, Xm, E_idx, keys)
    G = _cotangent(ops[4])
    out, dw = _model(ops, W, G, low)
    out_j, dw_j = _jax(X, Xm, E_idx, W, G, keys, low)
    tol = TOL_RBF if low else 2e-6
    assert _rel(out, out_j) < tol
    assert _rel(dw, dw_j) < tol


@pytest.mark.parametrize("keys", KEYS)
def test_dense_bf16_takes_the_exact_bins_rounded(keys):
    """The dense bf16 model (exact bins rounded to bf16, ``bf16(W)``) sits
    ten times nearer JAX's dense bf16 output and gradient, in root mean
    square, than the same walk with the classed bf16 branch's damped bins
    against ``bf16(W * fold scale)`` (the readings: 3.3e-5-3.9e-5 against
    2.0e-3-3.0e-3)."""
    X, Xm, E_idx, W = _structure("mixed", seed=2)
    ops = _operands(X, Xm, E_idx, keys)
    G = _cotangent(ops[4], seed=6)
    out_j, dw_j = _jax(X, Xm, E_idx, W, G, keys, low=True)
    out, dw = _model(ops, W, G, low=True)
    out_d, dw_d = _model(ops, W, G, low=True, damped=True)
    assert 10 * _rms(out, out_j) < _rms(out_d, out_j)
    assert 10 * _rms(dw, dw_j) < _rms(dw_d, dw_j)


def _header_int(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_walk_constants_are_the_kernels():
    """The wrappers' constants against ``csrc/rbf_tile.cuh`` and the widths
    each source instantiates: the forward's tile (which the model above
    walks), the weight gradient's splits (its scratch), the dense forward's
    widths, the weight gradients' and the classed forward's."""
    tile = (CSRC / "rbf_tile.cuh").read_text()
    assert _header_int(tile, "kTM") == TILE
    assert _header_int(tile, "kSplit") == rbf_common.DW_SPLITS

    def widths(source, pattern):
        found = re.findall(pattern, (CSRC / source).read_text())
        assert found
        return {tuple(int(w) for w in f.split(",")) for f in found}

    inst = r"group_(?:forward|dw)<k\w+, ([\d, ]+)>"
    assert widths("rbf_edge.cu", r"#define RBF_EDGE_WIDTHS ([\d, ]+)\n") == {
        rbf_edge.FORWARD_WIDTHS}
    assert widths("rbf_edge_dw.cu", inst) == {rbf_edge.DW_WIDTHS}
    assert widths("rbf_classed.cu", inst) == {rbf_classed.WIDTHS}
    assert widths("rbf_classed_dw.cu", inst) == {rbf_classed.WIDTHS}


@pytest.mark.parametrize("which", ["forward", "forward_bf16", "dw", "dw_bf16"])
def test_unsupported_widths_raise_before_any_launch(which):
    """A width the walk is not built for raises ``ValueError`` naming H and
    the widths, whatever the device (the width is checked first), and never
    falls back to the plain version."""
    X, Xm, E_idx, _ = _structure("mixed")
    X, Xm, E_idx = (torch.from_numpy(v) for v in (X, Xm, E_idx))
    H_bad = 100 if which.startswith("forward") else 96
    arg = (torch.zeros((18 * 18 * 16, H_bad)) if which.startswith("forward")
           else torch.zeros(E_idx.shape + (H_bad,)))
    fn = getattr(rbf_edge, {"forward": "rbf_edge_cuda",
                            "forward_bf16": "rbf_edge_bf16_cuda",
                            "dw": "rbf_edge_dw_cuda",
                            "dw_bf16": "rbf_edge_dw_bf16_cuda"}[which])
    with pytest.raises(ValueError, match=rf"H={H_bad} not supported \(widths 32, 64"):
        fn(X, Xm, E_idx, arg)
