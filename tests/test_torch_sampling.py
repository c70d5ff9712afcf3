"""Symmetry-tied and multi-structure sampling (``models/mpnn.py::
build_decode_groups``, ``sample_tied``, ``sample_multi``) against the JAX
package at float64 (``kernels="xla"`` under ``jax.enable_x64``): the same
weights, inputs, decode order and JAX's own Gumbel noise (per decode group,
or per decode step) must draw the same tokens, and the probabilities agree
within 1e-8, the bar of ``test_torch_model64.py``."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.data.featurize import make_pair_bias_ctx as jax_pair_ctx
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.models.mpnn import build_decode_groups as jax_groups
from na_mpnn_tpu.models.mpnn import sample_decoding_order as jax_order
from na_mpnn_tpu.models.mpnn import sample_multi as jax_sample_multi
from na_mpnn_tpu.models.mpnn import sample_tied as jax_sample_tied

from na_mpnn_tpu_torch.data.featurize import make_pair_bias_ctx
from na_mpnn_tpu_torch.models import (ModelConfig, build_decode_groups, sample,
                                      sample_multi, sample_tied)
from na_mpnn_tpu_torch.params import from_jax_params
from ref_oracle import make_synthetic_structure

ATOL = 1e-8
SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
             dropout=0.0)
L = 48
NL = 33
# tied sets (one holds the fixed position 2) and their weights
SYM = [[10, 20, 30], [11, 40], [2, 25]]
SYM_W = [[0.5, 1.0, 2.0], [1.0, 1.0], [1.0, 0.7]]


def _structure(seed, n_masked=0):
    b = make_synthetic_structure(L=L, seed=seed, n_protein=20, n_dna=16)
    b["chain_mask"] = np.ones_like(b["mask"])
    b["chain_mask"][0, :6] = 0
    if n_masked:
        b["mask"][0, -n_masked:] = 0
    b["X"] = b["X"].astype(np.float64)
    return b


@pytest.fixture(scope="module")
def case():
    """(JAX config, JAX params at float64, port params)."""
    with jax.enable_x64(True):
        cfg_j = JaxConfig(kernels="xla", **SMALL)
        pj = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_init(jax.random.PRNGKey(2), cfg_j))
    return cfg_j, pj, from_jax_params(pj, device="cpu", dtype=torch.float64)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _pair_matrix(rng):
    P = np.zeros((NL, NL), np.float32)
    P[rng.randint(0, 20, 12), rng.randint(0, 20, 12)] = 1.5
    return P


def test_build_decode_groups_matches_jax():
    rng = np.random.RandomState(0)
    for trial in range(5):
        order = rng.permutation(L)
        weights = SYM_W if trial % 2 else [[]]
        want = jax_groups(order, SYM, weights, L)
        got = build_decode_groups(order, SYM, weights, L)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="exactly once"):
        build_decode_groups(np.arange(L), [[1, 2], [2, 3]], [[]], L)


@pytest.mark.parametrize("with_pair_bias", [False, True])
def test_sample_tied_float64_token_exact(case, with_pair_bias):
    cfg_j, pj, pt = case
    B, T = 3, 0.5
    b = _structure(seed=4)
    rng = np.random.RandomState(8)
    bias = rng.randn(L, NL) * 0.3
    P = _pair_matrix(rng)
    groups, weights, flat = jax_groups(rng.permutation(L), SYM, SYM_W, L)
    key = jax.random.PRNGKey(13)
    with jax.enable_x64(True):
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (B, NL), jnp.float64))
                           for k in jax.random.split(key, groups.shape[0])])
        ctx_j = (jax_pair_ctx(b["chain_labels"][0], b["R_idx"][0], P)
                 if with_pair_bias else None)
        out_j = jax_sample_tied(jax.tree.map(jnp.asarray, pj), cfg_j, _jb(b), key,
                                groups, weights, flat, num_samples=B,
                                temperature=T, bias=jnp.asarray(bias),
                                pair_bias_ctx=ctx_j)
        out_j = {k: np.asarray(v) for k, v in out_j.items()}
    ctx = (make_pair_bias_ctx(b["chain_labels"][0], b["R_idx"][0], P, device="cpu")
           if with_pair_bias else None)
    out = sample_tied(pt, ModelConfig(**SMALL), _tb(b), None, groups, weights, flat,
                      num_samples=B, temperature=T, bias=torch.from_numpy(bias),
                      pair_bias_ctx=ctx, gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(out["S"].numpy(), out_j["S"])
    np.testing.assert_array_equal(out["decoding_order"].numpy(),
                                  out_j["decoding_order"])
    for k in ("sampling_probs", "log_probs"):
        np.testing.assert_allclose(out[k].numpy(), out_j[k], atol=ATOL, rtol=0)
    S = out["S"].numpy()
    for tied in SYM[:2]:          # designed tied positions carry one token
        assert (S[:, tied] == S[:, tied[:1]]).all()
    # the fixed position keeps its native token and passes it on
    np.testing.assert_array_equal(S[:, 2], np.broadcast_to(b["S"][0, 2], (B,)))
    np.testing.assert_array_equal(S[:, 25], S[:, 2])


def test_sample_multi_float64_token_exact(case):
    cfg_j, pj, pt = case
    S_rep, T = 2, 0.7
    parts = [_structure(seed=5), _structure(seed=6, n_masked=7)]
    b = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    N = 2
    rng = np.random.RandomState(9)
    bias = rng.randn(N, L, NL) * 0.3
    P = _pair_matrix(rng)
    key = jax.random.PRNGKey(21)
    with jax.enable_x64(True):
        u = np.stack([np.asarray(jax_pair_ctx(b["chain_labels"][i], b["R_idx"][i],
                                              P)["u_diag"]) for i in range(N)])
        ctx_j = {"pair_bias_AA": jnp.asarray(P), "u_diag": jnp.asarray(u)}
        out_j = jax_sample_multi(jax.tree.map(jnp.asarray, pj), cfg_j, _jb(b), key,
                                 samples_per_structure=S_rep, temperature=T,
                                 bias=jnp.asarray(bias), pair_bias_ctx=ctx_j)
        out_j = {k: np.asarray(v) for k, v in out_j.items()}
        key_order, key_steps = jax.random.split(key)
        cm = np.repeat((b["mask"] * b["chain_mask"]).astype(np.float64), S_rep, 0)
        order = np.array(jax_order(key_order, jnp.asarray(cm)))
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (N * S_rep, NL),
                                                        jnp.float64))
                           for k in jax.random.split(key_steps, L)])
    ctx = {"pair_bias_AA": torch.from_numpy(P), "u_diag": torch.from_numpy(u)}
    out = sample_multi(pt, ModelConfig(**SMALL),
                       {**_tb(b), "decoding_order": torch.from_numpy(order)}, None,
                       samples_per_structure=S_rep, temperature=T,
                       bias=torch.from_numpy(bias), pair_bias_ctx=ctx,
                       gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(out["decoding_order"].numpy(),
                                  out_j["decoding_order"])
    np.testing.assert_array_equal(out["S"].numpy(), out_j["S"])
    for k in ("sampling_probs", "log_probs"):
        np.testing.assert_allclose(out[k].numpy(), out_j[k], atol=ATOL, rtol=0)


def test_sample_multi_of_one_structure_equals_sample(case):
    """One structure through ``sample_multi`` (its per-row pair-bias
    adjacency ``[1, L-1]``) equals ``sample`` from the same generator seed."""
    _, _, pt = case
    b = _tb(_structure(seed=7))
    P = _pair_matrix(np.random.RandomState(3))
    ctx = make_pair_bias_ctx(b["chain_labels"][0].numpy(), b["R_idx"][0].numpy(),
                             P, device="cpu")
    cfg = ModelConfig(**SMALL)
    out_a = sample(pt, cfg, b, torch.Generator().manual_seed(7), num_samples=3,
                   temperature=0.3, pair_bias_ctx=ctx)
    out_b = sample_multi(pt, cfg, b, torch.Generator().manual_seed(7),
                         samples_per_structure=3, temperature=0.3,
                         pair_bias_ctx={**ctx, "u_diag": ctx["u_diag"][None]})
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k


@pytest.mark.parametrize("with_pair_bias", [False, True])
def test_untied_groups_decode_as_sample(case, with_pair_bias):
    """``sample_tied`` with every group of one (weights 1) is ``sample`` in
    the same decode order with the same Gumbel noise, bit for bit: both
    samplers run one decoder step and one draw."""
    _, _, pt = case
    B, T = 3, 0.5
    b = _tb(_structure(seed=4))
    rng = np.random.RandomState(11)
    bias = torch.from_numpy(rng.randn(L, NL) * 0.3)
    ctx = (make_pair_bias_ctx(b["chain_labels"][0].numpy(), b["R_idx"][0].numpy(),
                              _pair_matrix(rng), device="cpu")
           if with_pair_bias else None)
    flat = rng.permutation(L)
    gumbel = torch.from_numpy(rng.gumbel(size=(L, B, NL)))
    cfg = ModelConfig(**SMALL)
    tied = sample_tied(pt, cfg, b, None, flat[:, None], np.ones((L, 1)), flat,
                       num_samples=B, temperature=T, bias=bias, pair_bias_ctx=ctx,
                       gumbel=gumbel)
    one = sample(pt, cfg, {**b, "decoding_order": torch.from_numpy(flat)}, None,
                 num_samples=B, temperature=T, bias=bias, pair_bias_ctx=ctx,
                 gumbel=gumbel)
    for k in ("S", "sampling_probs", "log_probs"):
        assert torch.equal(tied[k], one[k]), k


def test_sample_tied_draws_from_generator(case):
    """Without injected noise the tied sampler draws from its generator:
    the same seed gives the same design, and tied positions stay equal."""
    _, _, pt = case
    b = _tb(_structure(seed=4))
    groups, weights, flat = build_decode_groups(np.random.RandomState(1).permutation(L),
                                                SYM, SYM_W, L)

    def run(seed):
        return sample_tied(pt, ModelConfig(**SMALL), b,
                           torch.Generator().manual_seed(seed), groups, weights,
                           flat, num_samples=2, temperature=1.0)

    a, a2 = run(1), run(1)
    assert torch.equal(a["S"], a2["S"])
    S = a["S"].numpy()
    assert (S[:, SYM[0]] == S[:, SYM[0][:1]]).all()
    assert torch.allclose(a["sampling_probs"].sum(-1)[:, 6:],
                          torch.ones(2, L - 6, dtype=torch.float64))
