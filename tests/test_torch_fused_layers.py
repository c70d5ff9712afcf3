"""Rows 11 and 12 of the kernel table (the fused layer updates) on the CPU.

* The port's plain ``fused_node_update`` (enc, dec) and
  ``fused_edge_update`` against the JAX package's Pallas kernels in
  interpret mode, fp32, H = 128, K = 16 and 32, masked nodes and edges and
  random decoder masks. The JAX kernels take a pre-gathered neighbour
  operand ``G``; here it is the port's table gathered in numpy. Tolerance
  3e-5 absolute on LayerNorm outputs of order 1: JAX holds the same kernels
  to 2e-5 against XLA (``tests/test_kernels.py``); the port adds the
  difference between the Pallas kernels' Abramowitz-Stegun erf (error up to
  1.5e-7) and the exact erf, and another summation order.
* The port's ``enc_layer`` / ``dec_layer`` on the fused route against JAX
  ``enc_layer_fused`` / ``dec_layer_fused`` (interpret) at L = 40 and 50,
  with the same tolerance.
* float64: the fused route equals the message-table route and JAX
  ``enc_layer_apply`` / ``dec_layer_apply`` within 1e-8.
* Dispatch: which route each entry point takes.
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models.modules import cat_neighbors_nodes as jax_cat
from na_mpnn_tpu.models.modules import dec_layer_apply as jax_dec_apply
from na_mpnn_tpu.models.modules import enc_layer_apply as jax_enc_apply
from na_mpnn_tpu.models.modules import gather_nodes as jax_gather
from na_mpnn_tpu.models.modules import init_dec_layer, init_enc_layer
from na_mpnn_tpu.models.mpnn import autoregressive_edge_masks as jax_ar_masks
from na_mpnn_tpu.ops import fused_layers as jfl

from na_mpnn_tpu_torch.models import ModelConfig, encode, forward, init_params
from na_mpnn_tpu_torch.models import mpnn
from na_mpnn_tpu_torch.ops import fused_layers as fl
from na_mpnn_tpu_torch.ops import message_kernels as mk
from na_mpnn_tpu_torch.params import from_jax_params
from ref_oracle import make_synthetic_structure

ATOL32 = 3e-5
ATOL64 = 1e-8
H = 128


def _layers(seed, dtype=np.float32):
    """An encoder and a decoder layer (JAX layout, numpy) with random biases
    and LayerNorm parameters, so that a misplaced term shows."""
    rng = np.random.RandomState(seed)

    def randomize(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = randomize(v)
            elif k in ("b", "bias"):
                out[k] = (0.3 * rng.randn(*v.shape)).astype(dtype)
            elif k == "scale":
                out[k] = (1.0 + 0.3 * rng.randn(*v.shape)).astype(dtype)
            else:
                out[k] = np.asarray(v, dtype)
        return out

    pe = randomize(init_enc_layer(jax.random.PRNGKey(seed), H, 2 * H))
    pd = randomize(init_dec_layer(jax.random.PRNGKey(seed + 1), H, 3 * H))
    return pe, pd


def _operands(B, L, K, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    N = B * L
    mask = (rng.rand(N) > 0.15).astype(dtype)
    eidx = rng.randint(0, L, (N * K,)).astype(np.int64)
    node = np.repeat(np.arange(N), K)
    m_att = mask[node] * mask[(node // L) * L + eidx]
    m1d = mask[node]
    mbw = m1d * (rng.rand(N * K) > 0.5)
    return dict(h_V=rng.randn(N, H).astype(dtype),
                h_E=rng.randn(N * K, H).astype(dtype),
                table=rng.randn(N, H).astype(dtype),
                table2=rng.randn(N, 2 * H).astype(dtype),
                eidx=eidx, row=(node // L) * L + eidx, mask=mask,
                m_att=m_att.astype(dtype), m1d=m1d.astype(dtype),
                mbw=mbw.astype(dtype))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("K", [16, 32])
@pytest.mark.parametrize("kind", ["enc", "dec", "edge"])
def test_plain_fused_updates_match_pallas(kind, K):
    B, L = 2, 40                     # N = 80, a multiple of NODE_TILE
    o = _operands(B, L, K, seed=K + len(kind))
    pe, pd = _layers(K)
    jp = jax.tree.map(jnp.asarray, pd if kind == "dec" else pe)
    tp = from_jax_params(pd if kind == "dec" else pe, device="cpu")
    if kind == "edge":
        G = o["table"][o["row"]]
        want = jfl.fused_edge_update(jnp.asarray(o["h_V"]), jnp.asarray(o["h_E"]),
                                     jnp.asarray(G), jp, K, interpret=True)
        got = fl.fused_edge_update_plain(tp, _t(o["h_V"]), _t(o["h_E"]),
                                         _t(o["table"]), _t(o["eidx"]), K=K, L=L)
    elif kind == "enc":
        G = o["table"][o["row"]]
        want = jfl.fused_node_update(
            jnp.asarray(o["h_V"]), jnp.asarray(o["h_E"]), jnp.asarray(G),
            jp["W1"]["w"][H:2 * H], jnp.asarray(o["m_att"])[:, None],
            jnp.asarray(o["mask"])[:, None], jp, K, interpret=True)
        got = fl.fused_node_update_plain(
            "enc", tp, _t(o["h_V"]), _t(o["h_E"]), _t(o["table"]), _t(o["eidx"]),
            _t(o["m_att"]), None, _t(o["mask"]), K=K, L=L)
    else:
        # the JAX decoder variant: the e-term rides the static slot, the
        # causal context the G slot (dec_layer_fused's operands)
        wb = pd["W1"]["w"][H:2 * H]
        static = o["m1d"][:, None] * (o["h_E"].astype(np.float64) @ wb)
        g = o["table2"][o["row"]].astype(np.float64)
        G = o["mbw"][:, None] * g[:, :H] + o["m1d"][:, None] * g[:, H:]
        want = jfl.fused_node_update(
            jnp.asarray(o["h_V"]), jnp.asarray(static, jnp.float32),
            jnp.asarray(G, jnp.float32), jnp.zeros((H, H)),
            jnp.ones((B * L * K, 1)), jnp.asarray(o["mask"])[:, None], jp, K,
            has_static=True, interpret=True)
        got = fl.fused_node_update_plain(
            "dec", tp, _t(o["h_V"]), _t(o["h_E"]), _t(o["table2"]), _t(o["eidx"]),
            _t(o["m1d"]), _t(o["mbw"]), _t(o["mask"]), K=K, L=L)
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL32, rtol=0)
    if kind != "edge":   # masked nodes come out as zeros
        assert not got.numpy()[o["mask"] == 0].any()


def _layer_case(L, K, seed, dtype=np.float32):
    """[B,L,...] layer inputs: nodes, edges, neighbours, masks, a decode
    order's backward-edge mask and a sequence embedding."""
    B = 2
    rng = np.random.RandomState(seed)
    mask = np.ones((B, L), dtype)
    mask[1, -5:] = 0
    E_idx = np.stack([np.stack([rng.choice(L, K, replace=False) for _ in range(L)])
                      for _ in range(B)]).astype(np.int64)
    m_att = mask[:, :, None] * np.take_along_axis(
        mask[:, None, :].repeat(L, 1), E_idx, axis=2)
    order = np.stack([rng.permutation(L) for _ in range(B)])
    return dict(h_V=rng.randn(B, L, H).astype(dtype),
                h_E=rng.randn(B, L, K, H).astype(dtype),
                h_S=rng.randn(B, L, H).astype(dtype),
                h_Venc=rng.randn(B, L, H).astype(dtype),
                E_idx=E_idx, mask=mask, m_att=m_att.astype(dtype), order=order)


def _port_layers(c, pe, pd, dtype, drop=None):
    """The port's enc_layer and dec_layer on flat edges, no gradient."""
    t = {k: _t(v) for k, v in c.items()}
    B, L, K = c["E_idx"].shape
    pet = from_jax_params(pe, device="cpu", dtype=dtype)
    pdt = from_jax_params(pd, device="cpu", dtype=dtype)
    eidx2 = t["E_idx"].reshape(-1)
    with torch.no_grad():
        hv, he2 = mpnn.enc_layer(pet, t["h_V"], t["h_E"].reshape(-1, H), eidx2,
                                 t["m_att"].reshape(-1), t["mask"], drop)
        mask_bw, _ = mpnn.autoregressive_edge_masks(t["order"], t["E_idx"], t["mask"])
        m1d2 = t["mask"][:, :, None].expand(B, L, K).reshape(-1)
        hd = mpnn.dec_layer(pdt, t["h_V"], t["h_Venc"], t["h_S"],
                            t["h_E"].reshape(-1, H), eidx2, m1d2,
                            mask_bw.reshape(-1), t["mask"], drop)
    return hv.numpy(), he2.view(B, L, K, H).numpy(), hd.numpy()


def _jax_dec_context(pd, c):
    """The decoder's causal context as JAX builds it: ``[B,L,K,3H]`` for
    ``dec_layer_apply``, and (e-term, context) for ``dec_layer_fused``."""
    j = {k: jnp.asarray(v) for k, v in c.items()}
    w = jnp.asarray(pd["W1"]["w"])
    wb, ws, wv = w[H:2 * H], w[2 * H:3 * H], w[3 * H:]
    mask_bw, mask_fw = jax_ar_masks(j["order"], j["E_idx"], j["mask"])
    mask_bw, mask_fw = mask_bw.astype(j["h_V"].dtype), mask_fw.astype(j["h_V"].dtype)
    h_ES = jax_cat(j["h_S"], j["h_E"], j["E_idx"])
    h_EX = jax_cat(jnp.zeros_like(j["h_S"]), j["h_E"], j["E_idx"])
    full = (mask_bw * jax_cat(j["h_V"], h_ES, j["E_idx"])
            + mask_fw * jax_cat(j["h_Venc"], h_EX, j["E_idx"]))
    e_term = j["mask"][:, :, None, None] * jnp.dot(j["h_E"], wb)
    ctx = (mask_bw * (jax_gather(jnp.dot(j["h_S"], ws), j["E_idx"])
                      + jax_gather(jnp.dot(j["h_V"], wv), j["E_idx"]))
           + mask_fw * jax_gather(jnp.dot(j["h_Venc"], wv), j["E_idx"]))
    return full, e_term, ctx


@pytest.mark.parametrize("L", [40, 50])
def test_fused_route_layers_match_jax_fused_layers(L):
    K = 16
    c = _layer_case(L, K, seed=L)
    pe, pd = _layers(L)
    hv, he, hd = _port_layers(c, pe, pd, torch.float32)
    jpe, jpd = jax.tree.map(jnp.asarray, pe), jax.tree.map(jnp.asarray, pd)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    hv_j, he_j = jfl.enc_layer_fused(jpe, j["h_V"], j["h_E"], j["E_idx"],
                                     j["mask"], j["m_att"], interpret=True)
    _, e_term, ctx = _jax_dec_context(pd, c)
    hd_j = jfl.dec_layer_fused(jpd, j["h_V"], ctx, e_term, j["mask"],
                               interpret=True)
    for got, want in ((hv, hv_j), (he, he_j), (hd, hd_j)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL32, rtol=0)


def test_fused_route_float64_equals_table_route_and_jax():
    K = 12
    c = _layer_case(30, K, seed=3, dtype=np.float64)
    pe, pd = _layers(3, np.float64)
    fused = _port_layers(c, pe, pd, torch.float64)
    table = _port_layers(c, pe, pd, torch.float64, drop=mpnn._no_dropout)
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in c.items()}
        hv_j, he_j = jax_enc_apply(jax.tree.map(jnp.asarray, pe), j["h_V"], j["h_E"],
                                   j["E_idx"], j["mask"], j["m_att"])
        full, _, _ = _jax_dec_context(pd, c)
        hd_j = jax_dec_apply(jax.tree.map(jnp.asarray, pd), j["h_V"], full, j["mask"])
        want = [np.asarray(x) for x in (hv_j, he_j, hd_j)]
    for f, t, w in zip(fused, table, want):
        np.testing.assert_allclose(f, t, atol=ATOL64, rtol=0)
        np.testing.assert_allclose(f, w, atol=ATOL64, rtol=0)


SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=8)


@pytest.fixture
def route_counts(monkeypatch):
    """Calls of each route's plain function: the fused updates, the
    message table (forward) and its backward, the pre-gathered message MLP
    and its backward."""
    counts = {}

    def count(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for mod, name in ((fl, "fused_node_update_plain"),
                      (fl, "fused_edge_update_plain"),
                      (mk, "message_table_plain"),
                      (mk, "message_table_bwd_plain"),
                      (mk, "message_mlp_plain"),
                      (mk, "message_mlp_bwd_plain")):
        count(mod, name)
    return counts


def _small_batch():
    b = make_synthetic_structure(L=30, seed=1, n_protein=14, n_dna=8)
    b["chain_mask"] = np.ones_like(b["mask"])
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    bt["decoding_order"] = torch.arange(30)[None]
    return bt


def test_dispatch_by_dropout_and_gradient(route_counts):
    """Inference entry points and a no-grad forward take the fused route;
    a differentiated forward and a forward with dropout take the message
    table in the encoder (with its backward when differentiated). L = 30 is
    not a multiple of 32, so their decoder takes the gathered route (the
    pre-gathered message MLP and its backward), as the JAX training decoder
    does; the fused route does not depend on L."""
    from na_mpnn_tpu_torch.models import sample, score, unconditional_probs
    from na_mpnn_tpu_torch.train.trainer import tree_leaves

    cfg = ModelConfig(dropout=0.1, **SMALL)
    params = init_params(0, cfg, device="cpu")
    bt = _small_batch()
    fused = {"fused_node_update_plain": 4, "fused_edge_update_plain": 2}

    def took(fn):
        route_counts.clear()
        fn()
        return dict(route_counts)

    assert took(lambda: encode(params, cfg, bt)) == {
        "fused_node_update_plain": 2, "fused_edge_update_plain": 2}
    assert took(lambda: score(params, cfg, bt, decoding_order=bt["decoding_order"])) == fused
    assert took(lambda: unconditional_probs(params, cfg, bt)) == fused
    assert took(lambda: sample(params, cfg, bt, torch.Generator().manual_seed(0))) == {
        "fused_node_update_plain": 2, "fused_edge_update_plain": 2}
    with torch.no_grad():
        assert took(lambda: forward(params, cfg, bt)) == fused
        # dropout drawn from a generator: the message table in the encoder,
        # the gathered route in the decoder, no backward
        assert took(lambda: forward(params, cfg, bt, torch.Generator().manual_seed(0))) \
            == {"message_table_plain": 4, "message_mlp_plain": 2}
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    # a gradient wanted, no dropout: the same routes and their backwards
    assert took(lambda: forward(params, cfg, bt)[0].sum().backward()) == {
        "message_table_plain": 4, "message_table_bwd_plain": 4,
        "message_mlp_plain": 2, "message_mlp_bwd_plain": 2}


def test_eval_step_takes_fused_route_train_step_the_table(route_counts):
    import dataclasses

    from na_mpnn_tpu_torch.train.collate import collate_batch
    from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

    b = make_synthetic_structure(L=30, seed=2, n_protein=14, n_dna=8)
    keys = ("X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
            "dna_mask", "rna_mask", "R_polymer_type")
    nb = collate_batch([{k: b[k][0] for k in keys}] * 2)
    cfg = dataclasses.replace(model_config_from_params({"MIXED_PRECISION": 0}), **SMALL)
    tr = Trainer(cfg, seed=0, device="cpu")
    tr.eval_step(nb)
    assert route_counts == {"fused_node_update_plain": 4, "fused_edge_update_plain": 2}
    route_counts.clear()
    tr.train_step(nb, torch.Generator().manual_seed(0))
    assert set(route_counts) == {"message_table_plain", "message_table_bwd_plain"}


@pytest.mark.parametrize("use_buckets", [False, True])
def test_train_step_route_by_length(route_counts, use_buckets):
    """A train step at L = 50 (collated with ``use_buckets=False``) runs the
    table route in the encoder and the gathered route in the decoder, each
    with its backward; at a bucketed L (64) it calls no message MLP on
    gathered operands at all."""
    import dataclasses

    from na_mpnn_tpu_torch.train.collate import collate_batch
    from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

    b = make_synthetic_structure(L=50, seed=4, n_protein=24, n_dna=12)
    keys = ("X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
            "dna_mask", "rna_mask", "R_polymer_type")
    nb = collate_batch([{k: b[k][0] for k in keys}] * 2, use_buckets=use_buckets)
    assert nb["S"].shape == (2, 64 if use_buckets else 50)
    cfg = dataclasses.replace(model_config_from_params({"MIXED_PRECISION": 0}), **SMALL)
    Trainer(cfg, seed=0, device="cpu").train_step(nb, torch.Generator().manual_seed(0))
    want = {"message_table_plain": 4, "message_table_bwd_plain": 4}
    if use_buckets:
        want = {"message_table_plain": 6, "message_table_bwd_plain": 6}
    else:
        want.update(message_mlp_plain=2, message_mlp_bwd_plain=2)
    assert route_counts == want
