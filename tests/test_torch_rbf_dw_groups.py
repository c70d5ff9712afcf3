"""The per-edge group lists and the pair-major row order behind the classed
RBF weight-gradient kernel (``ops/rbf_common.py``: ``edge_groups``,
``edge_group_lists``, ``_pair_row_map``). The kernel runs only on the card;
this file holds, on the CPU, the glue it is given and the decomposition it
computes: each group table's rows summed over that group's edge list only.

Structure: protein rows, nucleic rows (a protein-DNA interface through the
random neighbours), one residue with atoms of both blocks, and masked rows.

Tolerances: the decomposition adds only exact zeros to each group's rows,
so at float64 it equals the full plain gradient to 1e-12. Against the JAX
``_classed_dw`` (``jax.grad`` of the Pallas projection in interpret mode),
2e-5 relative at fp32, the bar of ``test_torch_train_kernels.py``, and 2^-8
at bf16, the bar of ``test_torch_bf16_kernels.py`` (a bin near a bf16
rounding boundary may round apart, moving a sum by 2^-8 of one term)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.ops import rbf_classed as jrbf

from na_mpnn_tpu_torch.ops import rbf_classed, rbf_common

H = 64


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    B, L, K, A, R = 2, 40, 8, 18, 16
    X = rng.randn(B, L, A, 3).astype(np.float32) * 5
    Xm = np.zeros((B, L, A), np.float32)
    Xm[:, :20, [0, 1, 2, 3, 16]] = 1        # protein
    Xm[:, 20:, 4:16] = 1                    # nucleic backbone
    Xm[:, 20:, 17] = 1                      # virtual base-N
    Xm[:, 38:] = 0                          # masked residues
    Xm[0, 5, 4] = 1                         # a residue in both blocks
    E_idx = rng.randint(0, L, (B, L, K)).astype(np.int64)
    W = rng.randn(A * A * R, H).astype(np.float32) * 0.01
    G = rng.randn(B, L, K, H).astype(np.float32)
    return X, Xm, E_idx, W, G


def _lists(X, Xm, E_idx):
    # the masks and neighbour rows as the wrapper lays them out for the
    # kernel (ops/rbf_common.py::edge_operands, which takes CUDA tensors only)
    B, L, K = E_idx.shape
    M = Xm[:, :, rbf_common.PERM].reshape(B * L, 18)
    nbr = (E_idx + L * torch.arange(B)[:, None, None]).reshape(-1)
    member = rbf_common.edge_groups(M, M, nbr, K)
    lists, counts = rbf_common.edge_group_lists(member)
    return member, lists, counts


def _group_slices():
    """(start, stop) of each group's rows in the kernel's row order."""
    sizes = [16 * len(q) * len(n) for q, n in rbf_common.GROUP_SELS]
    ends = np.cumsum(sizes)
    return [(int(e - s), int(e)) for s, e in zip(sizes, ends)]


def _by_groups(dw_fn, X, Xm, E_idx, G, lists, counts):
    """The kernel's decomposition: each group's rows from the plain weight
    gradient over that group's listed edges alone (the cotangent of every
    other edge set to 0), written through the pair-major row map."""
    rowmap = rbf_common._pair_row_map(torch.device("cpu"))
    out = torch.zeros((rowmap.shape[0], G.shape[-1]), dtype=G.dtype)
    flat = G.reshape(-1, G.shape[-1])
    for grp, (lo, hi) in enumerate(_group_slices()):
        keep = torch.zeros(flat.shape[0], dtype=G.dtype)
        keep[lists[grp, :counts[grp]]] = 1
        dw = dw_fn(X, Xm, E_idx, (flat * keep[:, None]).view(G.shape))
        rows = rowmap[lo:hi]
        out[rows] = dw[rows]
    return out


def test_group_lists_follow_the_sides_of_both_residues(case):
    X, Xm, E_idx, _, _ = (torch.from_numpy(v) for v in case)
    member, lists, counts = _lists(X, Xm, E_idx)
    E = E_idx.numel()
    K = E_idx.shape[2]
    assert member.shape == (4, E)
    assert torch.equal(counts, member.sum(1))
    for grp in range(4):
        got = lists[grp, :counts[grp]]
        assert torch.equal(got, torch.nonzero(member[grp]).squeeze(1))
    # every edge in at least one group; the both-blocks residue (structure 0,
    # row 5) as a query is in a P group and an N group for each neighbour
    assert torch.all(member.any(0))
    e5 = torch.arange(5 * K, 6 * K)
    assert torch.all(member[0, e5] | member[1, e5])
    assert torch.all(member[2, e5] | member[3, e5])
    # an interface: protein queries with nucleic neighbours and the reverse
    assert int(counts[1]) > 0 and int(counts[2]) > 0
    # residue sides: protein 0, nucleic 1, both blocks 2
    sides = rbf_common.residue_sides(Xm.reshape(-1, 18)[:, rbf_common.PERM])
    assert int(sides[5]) == 2 and int(sides[0]) == 0 and int(sides[25]) == 1


def test_pair_row_map_is_a_permutation_onto_the_reference_order():
    """Each group's rows in the kernel's pair-major order map onto the
    reference rows of that group's table (``group_rows``, the forward
    kernel's bin-major order), and all of them onto the whole weight."""
    rowmap = rbf_common._pair_row_map(torch.device("cpu"))
    assert torch.equal(torch.sort(rowmap).values, torch.arange(18 * 18 * 16))
    for (lo, hi), want in zip(_group_slices(), rbf_common.group_rows()):
        assert sorted(rowmap[lo:hi].tolist()) == sorted(want.tolist())
        # pair-major: 16 consecutive kernel rows are one pair's 16 bins
        blk = rowmap[lo:hi].view(-1, 16)
        assert torch.equal(blk - blk[:, :1], torch.arange(16).expand_as(blk))


def test_group_decomposition_equals_the_full_gradient_float64(case):
    X, Xm, E_idx, _, G = (torch.from_numpy(v) for v in case)
    X, Xm, G = X.double(), Xm.double(), G.double()
    _, lists, counts = _lists(X.float(), Xm.float(), E_idx)
    got = _by_groups(rbf_classed.rbf_classed_dw_plain, X, Xm, E_idx, G,
                     lists, counts)
    want = rbf_classed.rbf_classed_dw_plain(X, Xm, E_idx, G)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


@pytest.mark.parametrize("low", [False, True])
def test_group_decomposition_matches_jax_classed_dw(case, low):
    X, Xm, E_idx, W, G = case
    Xt, Xmt, Et, Gt = (torch.from_numpy(v) for v in (X, Xm, E_idx, G))
    _, lists, counts = _lists(Xt, Xmt, Et)
    dw_fn = (rbf_classed.rbf_classed_dw_bf16_plain if low
             else rbf_classed.rbf_classed_dw_plain)
    got = _by_groups(dw_fn, Xt, Xmt, Et, Gt, lists, counts)
    full = dw_fn(Xt, Xmt, Et, Gt)
    assert _rel(got, full) < 1e-6
    kw = {"compute_dtype": jnp.bfloat16} if low else {}
    ref = jax.grad(lambda w: jnp.sum(jrbf.rbf_edge_features_classed(
        jnp.asarray(X), jnp.asarray(Xm), jnp.asarray(E_idx.astype(np.int32)), w,
        interpret=True, **kw) * jnp.asarray(G)))(jnp.asarray(W))
    if low:   # the gradient of W through the fold scales the model applies
        scales = torch.from_numpy(rbf_classed.bin_fold_scales()).repeat(18 * 18)
        got = got * scales[:, None]
    assert _rel(got.numpy(), ref) < (2.0 ** -8 if low else 2e-5)
