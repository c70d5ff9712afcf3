"""The port's model (plain path, CPU, float64) against the JAX package's XLA
path under ``jax.enable_x64``: the same weights and inputs give the same
function to 1e-8 (the bar ``test_parity_model.py`` sets against the
original PyTorch code). ``sample`` gets JAX's own decode order and Gumbel
noise and must draw the same tokens."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.data.featurize import make_pair_bias_ctx as jax_pair_ctx
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import encode as jax_encode
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.models import sample as jax_sample
from na_mpnn_tpu.models import score as jax_score
from na_mpnn_tpu.models import unconditional_probs as jax_uncond

from na_mpnn_tpu_torch.data.featurize import make_pair_bias_ctx
from na_mpnn_tpu_torch.models import (ModelConfig, encode, sample, score,
                                      unconditional_probs)
from na_mpnn_tpu_torch.params import from_jax_params
from ref_oracle import make_synthetic_structure

ATOL = 1e-8
SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
             dropout=0.0)


@pytest.fixture(scope="module")
def case():
    """(JAX params, port params, JAX batch, port batch) at float64, L=48."""
    with jax.enable_x64(True):
        cfg_j = JaxConfig(kernels="xla", **SMALL)
        pj = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_init(jax.random.PRNGKey(0), cfg_j))
        b = make_synthetic_structure(L=48, seed=4, n_protein=20, n_dna=16)
        b["chain_mask"] = np.ones_like(b["mask"])
        b["chain_mask"][0, :6] = 0
        b["X"] = b["X"].astype(np.float64)
    pt = from_jax_params(pj, device="cpu", dtype=torch.float64)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    return cfg_j, pj, b, pt, bt


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_encode_float64(case):
    cfg_j, pj, b, pt, bt = case
    with jax.enable_x64(True):
        hv_j, he_j, e_j = jax_encode(jax.tree.map(jnp.asarray, pj), cfg_j, _jb(b))
        hv_j, he_j, e_j = map(np.asarray, (hv_j, he_j, e_j))
    hv, he, e = encode(pt, ModelConfig(**SMALL), bt)
    np.testing.assert_array_equal(e.numpy(), e_j)
    np.testing.assert_allclose(hv.numpy(), hv_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(he.numpy(), he_j, atol=ATOL, rtol=0)


def test_score_and_unconditional_float64(case):
    cfg_j, pj, b, pt, bt = case
    order = np.random.RandomState(3).permutation(48)[None]
    with jax.enable_x64(True):
        pjj = jax.tree.map(jnp.asarray, pj)
        lp_j = np.asarray(jax_score(pjj, cfg_j, _jb(b),
                                    decoding_order=jnp.asarray(order))["log_probs"])
        un_j = np.asarray(jax_uncond(pjj, cfg_j, _jb(b))["log_probs"])
    cfg = ModelConfig(**SMALL)
    out = score(pt, cfg, bt, decoding_order=torch.from_numpy(order))
    np.testing.assert_allclose(out["log_probs"].numpy(), lp_j, atol=ATOL, rtol=0)
    un = unconditional_probs(pt, cfg, bt)["log_probs"].numpy()
    np.testing.assert_allclose(un, un_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_pair_bias", [False, True])
def test_sample_float64_token_exact(case, with_pair_bias):
    cfg_j, pj, b, pt, bt = case
    B, L, nl, T = 3, 48, 33, 0.5
    rng = np.random.RandomState(7)
    order = np.stack([rng.permutation(L) for _ in range(B)])
    bias = rng.randn(L, nl) * 0.3
    pair = np.zeros((nl, nl), np.float32)
    pair[rng.randint(0, 20, 12), rng.randint(0, 20, 12)] = 1.5
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(True):
        _, key_steps = jax.random.split(key)
        keys = jax.random.split(key_steps, L)
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (B, nl), jnp.float64))
                           for k in keys])
        ctx_j = (jax_pair_ctx(b["chain_labels"][0], b["R_idx"][0], pair)
                 if with_pair_bias else None)
        out_j = jax_sample(jax.tree.map(jnp.asarray, pj), cfg_j,
                           {**_jb(b), "decoding_order": jnp.asarray(order)}, key,
                           num_samples=B, temperature=T, bias=jnp.asarray(bias),
                           pair_bias_ctx=ctx_j)
        out_j = {k: np.asarray(v) for k, v in out_j.items()}
    ctx = (make_pair_bias_ctx(b["chain_labels"][0], b["R_idx"][0], pair,
                              device="cpu") if with_pair_bias else None)
    out = sample(pt, ModelConfig(**SMALL),
                 {**bt, "decoding_order": torch.from_numpy(order)}, None,
                 num_samples=B, temperature=T, bias=torch.from_numpy(bias),
                 pair_bias_ctx=ctx, gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(out["S"].numpy(), out_j["S"])
    np.testing.assert_array_equal(out["decoding_order"].numpy(),
                                  out_j["decoding_order"])
    for k in ("sampling_probs", "log_probs"):
        np.testing.assert_allclose(out[k].numpy(), out_j[k], atol=ATOL, rtol=0)
    # fixed positions keep the native tokens; designed ones vary
    np.testing.assert_array_equal(out["S"].numpy()[:, :6],
                                  np.broadcast_to(b["S"][0, :6], (B, 6)))


def test_sample_draws_from_generator(case):
    """Without injected noise the port draws order and tokens from its
    generator: the same seed gives the same design, another seed another."""
    _, _, _, pt, bt = case
    cfg = ModelConfig(**SMALL)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return sample(pt, cfg, bt, g, num_samples=2, temperature=1.0)

    a, b2, c = run(1), run(1), run(2)
    assert torch.equal(a["S"], b2["S"])
    assert torch.equal(a["decoding_order"], b2["decoding_order"])
    assert not torch.equal(a["decoding_order"], c["decoding_order"])
    assert torch.allclose(a["sampling_probs"].sum(-1)[:, 6:],
                          torch.ones(2, 42, dtype=torch.float64))


def test_layer_functions_float64():
    """``modules.enc_layer_apply`` / ``dec_layer_apply`` (the layers on
    ``[B,L,K,*]`` edges) equal the JAX package's, and the encoder layer
    equals the flat message-table route the model runs."""
    from na_mpnn_tpu.models.modules import dec_layer_apply as jax_dec
    from na_mpnn_tpu.models.modules import enc_layer_apply as jax_enc
    from na_mpnn_tpu.models.modules import init_dec_layer, init_enc_layer
    from na_mpnn_tpu_torch.models.modules import (dec_layer_apply,
                                                  enc_layer_apply, layer_norm,
                                                  pff_apply)
    from na_mpnn_tpu_torch.ops import message_kernels as mk

    rng = np.random.RandomState(5)
    B, L, K, H = 2, 12, 5, 32
    a = {"h_V": rng.randn(B, L, H), "h_E": rng.randn(B, L, K, H),
         "ctx": rng.randn(B, L, K, 3 * H), "mask": (rng.rand(B, L) > 0.2) * 1.0,
         "m_att": (rng.rand(B, L, K) > 0.3) * 1.0,
         "E_idx": rng.randint(0, L, (B, L, K))}
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float64), t)  # noqa: E731
        pe = f64(init_enc_layer(jax.random.PRNGKey(2), H, 2 * H))
        pd = f64(init_dec_layer(jax.random.PRNGKey(3), H, 3 * H))
        j = {k: jnp.asarray(v) for k, v in a.items()}
        hv_j, he_j = jax_enc(jax.tree.map(jnp.asarray, pe), j["h_V"], j["h_E"],
                             j["E_idx"], j["mask"], j["m_att"])
        hd_j = jax_dec(jax.tree.map(jnp.asarray, pd), j["h_V"], j["ctx"], j["mask"])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    pet = from_jax_params(pe, device="cpu", dtype=torch.float64)
    pdt = from_jax_params(pd, device="cpu", dtype=torch.float64)
    hv, he = enc_layer_apply(pet, t["h_V"], t["h_E"], t["E_idx"], t["mask"],
                             t["m_att"])
    np.testing.assert_allclose(hv.numpy(), np.asarray(hv_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(he.numpy(), np.asarray(he_j), atol=ATOL, rtol=0)
    hd = dec_layer_apply(pdt, t["h_V"], t["ctx"], t["mask"])
    np.testing.assert_allclose(hd.numpy(), np.asarray(hd_j), atol=ATOL, rtol=0)

    # the flat route of mpnn.encode on the same layer
    N = B * L
    h_V2, h_E2 = t["h_V"].reshape(N, H), t["h_E"].reshape(N * K, H)
    eidx2, m2 = t["E_idx"].reshape(-1), t["m_att"].reshape(-1)
    dh = mk.message_agg_table_flat(pet, h_V2, h_E2, h_V2 @ pet["W1"]["w"][2 * H:],
                                   eidx2, m2, K=K, L=L)
    hv_f = layer_norm(pet["norm1"], t["h_V"] + dh.view(B, L, H))
    hv_f = layer_norm(pet["norm2"], hv_f + pff_apply(pet["dense"], hv_f))
    hv_f = t["mask"][..., None] * hv_f
    hv_f2 = hv_f.reshape(N, H)
    m = mk.message_edge_table_flat(pet, hv_f2, h_E2, hv_f2 @ pet["W11"]["w"][2 * H:],
                                   eidx2, K=K, L=L)
    he_f = layer_norm(pet["norm3"], h_E2 + m)
    np.testing.assert_allclose(hv_f.numpy(), hv.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(he_f.view(B, L, K, H).numpy(), he.numpy(),
                               atol=ATOL, rtol=0)
