"""The port's model (plain path, CPU, fp32) against the JAX package with its
Pallas kernels (``kernels="pallas"``, interpret mode): encode, score and
unconditional probs within 1e-4.

At L = 64 the JAX package runs the message-table kernel; at L = 50 (not a
multiple of 32) it runs the fused-layer kernels instead. The port's
inference entry points run its fused layer updates at every L, so the test
pins both JAX routes to the port's fused route. ``sample`` is held at float64 only
(``test_torch_model64.py``): at fp32 a near-tie could flip a token and with
it every later step."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import na_mpnn_tpu.ops as jax_ops
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import encode as jax_encode
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.models import score as jax_score
from na_mpnn_tpu.models import unconditional_probs as jax_uncond

from na_mpnn_tpu_torch.models import ModelConfig, encode, score, unconditional_probs
from na_mpnn_tpu_torch.params import from_jax_params
from ref_oracle import make_synthetic_structure

ATOL = 1e-4
SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
             dropout=0.0)


@pytest.mark.parametrize("L", [64, 50])
def test_fp32_against_pallas_kernels(monkeypatch, L):
    monkeypatch.setattr(jax_ops, "INTERPRET", True)
    cfg_j = JaxConfig(kernels="pallas", **SMALL)
    pj = jax_init(jax.random.PRNGKey(1), cfg_j)
    b = make_synthetic_structure(L=L, seed=L, n_protein=L // 2, n_dna=L // 4)
    b["chain_mask"] = np.ones_like(b["mask"])
    order = np.random.RandomState(L).permutation(L)[None]
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    hv_j, he_j, e_j = jax_encode(pj, cfg_j, bj)
    lp_j = jax_score(pj, cfg_j, bj, decoding_order=jnp.asarray(order))["log_probs"]
    un_j = jax_uncond(pj, cfg_j, bj)["log_probs"]

    cfg = ModelConfig(**SMALL)
    pt = from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    hv, he, e = encode(pt, cfg, bt)
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(hv.numpy(), np.asarray(hv_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(he.numpy(), np.asarray(he_j), atol=ATOL, rtol=0)
    lp = score(pt, cfg, bt, decoding_order=torch.from_numpy(order))["log_probs"]
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), atol=ATOL, rtol=0)
    un = unconditional_probs(pt, cfg, bt)["log_probs"]
    np.testing.assert_allclose(un.numpy(), np.asarray(un_j), atol=ATOL, rtol=0)


def test_plain_option_matches_auto_on_cpu():
    """``kernels="torch"`` (the plain versions, called directly) and
    ``kernels="auto"`` (the wrappers, which take the plain versions for CPU
    tensors) give the same result; ``kernels="cuda"`` refuses CPU tensors."""
    b = make_synthetic_structure(L=40, seed=2, n_protein=20, n_dna=10)
    b["chain_mask"] = np.ones_like(b["mask"])
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    from na_mpnn_tpu_torch.models import init_params
    pt = init_params(0, ModelConfig(**SMALL), device="cpu")
    a = encode(pt, ModelConfig(**SMALL), bt)
    t = encode(pt, ModelConfig(kernels="torch", **SMALL), bt)
    for x, y in zip(a, t):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        encode(pt, ModelConfig(kernels="cuda", **SMALL), bt)
    # remat (once refused here) runs and changes no forward value
    for x, y in zip(a, encode(pt, ModelConfig(remat="full", **SMALL), bt)):
        assert torch.equal(x, y)
