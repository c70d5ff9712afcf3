"""The per-edge classification behind the classed RBF forward kernel
(``csrc/rbf_classed.cu``; ``ops/rbf_classed.py``: ``edge_list_codes``,
``edge_tile_order``, ``_pair_row_map``). The kernel runs only on the card;
this file holds, on the CPU, the glue it is given and a plain model of what
it computes from it: the four group tables in the pair-major row order, the
edges of one group alone in that group's list, the edges of several groups
in a fifth list whose tiles of 64 run each group one of their edges feeds,
in the order 0..3, into the same sums, and every output row written once.

Structures: protein rows, nucleic rows, two residues with atoms of both
blocks (edges between them feed all four groups, edges to one of them two),
masked rows; a protein-only one (three groups and the several-group list
empty); each with its own rows as keys and as a 16-row shard against the
structure's 48 key rows (the graph-parallel route's operands, Lk != L).

Tolerances: at float64 the model adds only exact zeros beyond the dense
sum, so it equals the plain forward to 1e-8 (the repo's float64 bar).
Against the JAX ``rbf_edge_features_classed`` / ``_qk`` with the Pallas
kernel in interpret mode: 2e-6 relative at fp32 (the bar of
``test_torch_kernels.py``), 2^-8 at bf16 (the bar of
``test_torch_bf16_kernels.py``: a bin near a bf16 rounding boundary may
round apart, moving a sum by 2^-8 of one term)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from na_mpnn_tpu.ops import rbf_classed as jrbf

from na_mpnn_tpu_torch.models.features import all_pair_rbf
from na_mpnn_tpu_torch.ops import rbf_classed

H, B, LK, K, TILE = 32, 2, 48, 8, 64


def _structure(kind, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(B, LK, 18, 3) * 5).astype(np.float32)
    Xm = np.zeros((B, LK, 18), np.float32)
    if kind == "mixed":
        Xm[:, :20, [0, 1, 2, 3, 16]] = 1        # protein
        Xm[:, 20:, 4:16] = 1                    # nucleic backbone
        Xm[:, 20:, 17] = 1                      # virtual base-N
        Xm[:, 5, 4] = 1                         # protein residue with an NA atom
        Xm[:, 30, [0, 1]] = 1                   # nucleic residue with N, CA
    else:
        Xm[:, :, [0, 1, 2, 3, 16]] = 1
    Xm[:, 46:] = 0                              # masked residues
    E_idx = rng.randint(0, LK, (B, LK, K)).astype(np.int64)
    E_idx[:, 5, 0], E_idx[:, 30, 0] = 30, 5     # both-block residues meet
    W = (rng.randn(18 * 18 * 16, H) * 0.01).astype(np.float32)
    return X, Xm, E_idx, W


def _operands(X, Xm, E_idx, keys):
    """(query coords, query masks, key coords, key masks, E_idx) with the
    structure's own rows as keys, or the 16-row shard [16, 32) against
    all 48 key rows."""
    if keys == "own":
        return X, Xm, X, Xm, E_idx
    sl = slice(16, 32)
    return X[:, sl], Xm[:, sl], X, Xm, E_idx[:, sl]


def _member(Mq_ref, Mk_ref, E_idx):
    """The per-edge groups and list codes on CPU tensors: masks in PERM
    order, flat key rows (``ops/rbf_edge.py::edge_operands`` takes CUDA
    tensors only)."""
    Lq, Lk = Mq_ref.shape[1], Mk_ref.shape[1]
    Mq = Mq_ref[:, :, rbf_classed.PERM].reshape(B * Lq, 18)
    Mk = Mk_ref[:, :, rbf_classed.PERM].reshape(B * Lk, 18)
    nbr = (E_idx + Lk * torch.arange(B)[:, None, None]).reshape(-1)
    return (rbf_classed.edge_groups(Mq, Mk, nbr, K),
            rbf_classed.edge_list_codes(Mq, Mk, nbr, K))


def _lists(code):
    """The kernel's five lists from the sorted order and the counts."""
    order, counts = rbf_classed.edge_tile_order(code)
    ends = torch.cumsum(counts, 0)
    return [order[int(e - c):int(e)] for e, c in zip(ends, counts)]


def _group_slices():
    sizes = [16 * len(q) * len(n) for q, n in rbf_classed.GROUP_SELS]
    ends = np.cumsum(sizes)
    return [(int(e - s), int(e)) for s, e in zip(sizes, ends)]


def per_group_forward(bins, member, code, W):
    """The kernel's decomposition: ``bins [E, 5184]`` and ``W [5184, H]`` in
    the reference order -> ``[E, H]``, tile by tile of each list, each
    group's pair-major rows in turn."""
    rowmap = rbf_classed._pair_row_map(torch.device("cpu"))
    bins_k, table = bins[:, rowmap], W[rowmap]
    out = torch.full((bins.shape[0], W.shape[1]), float("nan"), dtype=bins.dtype)
    slices = _group_slices()
    for lst, edges in enumerate(_lists(code)):
        for i0 in range(0, edges.shape[0], TILE):
            tile = edges[i0:i0 + TILE]
            groups = ([lst] if lst < 4 else
                      [g for g in range(4) if bool(member[g, tile].any())])
            acc = torch.zeros((tile.shape[0], W.shape[1]), dtype=bins.dtype)
            for g in groups:
                lo, hi = slices[g]
                acc = acc + bins_k[tile, lo:hi] @ table[lo:hi]
            assert torch.isnan(out[tile]).all()     # each row written once
            out[tile] = acc
    assert not torch.isnan(out).any()
    return out


@pytest.mark.parametrize("keys", ["own", "shard"])
@pytest.mark.parametrize("kind", ["mixed", "protein"])
def test_tile_lists_partition_the_edges(kind, keys):
    Xq, Mq, _, Mk, E_idx = (torch.from_numpy(v) for v in
                            _operands(*_structure(kind)[:3], keys))
    member, code = _member(Mq, Mk, E_idx)
    assert code.dtype == torch.uint8
    lists = _lists(code)
    E = E_idx.numel()
    assert len(lists) == 5
    assert torch.equal(torch.sort(torch.cat(lists)).values, torch.arange(E))
    n_groups = member.sum(0)
    assert torch.all(n_groups >= 1)
    for g in range(4):
        assert torch.equal(lists[g], torch.nonzero(member[g] & (n_groups == 1)).squeeze(1))
    assert torch.equal(lists[4], torch.nonzero(n_groups > 1).squeeze(1))
    counts = [len(x) for x in lists]
    if kind == "mixed":
        assert bool((n_groups == 4).any()) and bool((n_groups == 2).any())
        assert counts[1] > 0 and counts[2] > 0
    else:
        assert counts[1:] == [0, 0, 0, 0] and counts[0] == E


@pytest.mark.parametrize("keys", ["own", "shard"])
@pytest.mark.parametrize("kind", ["mixed", "protein"])
def test_per_group_forward_equals_the_plain_forward_float64(kind, keys):
    X, Xm, E_idx, W = _structure(kind)
    Xq, Mq, Xk, Mk, Eq = (torch.from_numpy(v) for v in _operands(X, Xm, E_idx, keys))
    Xq, Mq, Xk, Mk = Xq.double(), Mq.double(), Xk.double(), Mk.double()
    Wt = torch.from_numpy(W).double()
    bins = all_pair_rbf(Xq, Eq, Mq, 16, Xk, Mk).reshape(Eq.numel(), -1)
    got = per_group_forward(bins, *_member(Mq, Mk, Eq), Wt)
    want = rbf_classed.rbf_edge_features_classed_plain(Xq, Mq, Eq, Wt, Xk, Mk)
    np.testing.assert_allclose(got.numpy(), want.reshape(-1, H).numpy(), rtol=0,
                               atol=1e-8)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


@pytest.mark.parametrize("keys", ["own", "shard"])
@pytest.mark.parametrize("low", [False, True])
def test_per_group_forward_matches_jax_pallas(low, keys):
    X, Xm, E_idx, W = _structure("mixed", seed=1)
    ops = _operands(X, Xm, E_idx, keys)
    Xq, Mq, Xk, Mk, Eq = (torch.from_numpy(v) for v in ops)
    member, code = _member(Mq, Mk, Eq)
    Wt = torch.from_numpy(W)
    if low:   # damped bf16 bins against bf16(W * fold scale), summed wide
        bins = rbf_classed.rbf_bins_bf16(Xq, Mq, Eq, Xk, Mk).double()
        table = rbf_classed.fold_scaled(Wt).to(torch.bfloat16).double()
    else:
        bins = all_pair_rbf(Xq, Eq, Mq, 16, Xk, Mk).reshape(Eq.numel(), -1).double()
        table = Wt.double()
    got = per_group_forward(bins, member, code, table)
    kw = {"compute_dtype": jnp.bfloat16} if low else {}
    want = jrbf.rbf_edge_features_classed_qk(
        *(jnp.asarray(v) for v in ops[:4]), jnp.asarray(ops[4].astype(np.int32)),
        jnp.asarray(W), interpret=True, **kw)
    assert _rel(got.numpy(), np.asarray(want).reshape(-1, H)) < (2.0 ** -8 if low else 2e-6)
