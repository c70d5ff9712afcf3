"""The token embedding ``embed_tokens`` (``models/mpnn.py``): its forward is
the row gather ``W_s.emb[S]`` at every dtype, and its gradient is the
one-hot product ``one_hot(S)^T @ g`` summed in fp32 (float64 at float64),
which is the same on every launch on the card, where PyTorch's own gather
backward adds rows with atomics.

Tolerances: the forward is bitwise the gather (no product in it). The
gradient against JAX's VJP of ``emb[S]`` at float64: 1e-12 (the same terms,
summed in another order). At fp32, against the float64 sums: 1e-6 relative
(fp32 sums of a few hundred terms)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models.mpnn import embed_tokens as jax_embed_tokens

from na_mpnn_tpu_torch.models.mpnn import embed_tokens

VOCAB, H = 33, 32


def _case(seed, dtype):
    rng = np.random.RandomState(seed)
    emb = rng.randn(VOCAB, H)
    S = rng.randint(0, VOCAB, (3, 70))
    S[0, :5] = 7                      # repeated tokens: several rows per entry
    g = rng.randn(3, 70, H)
    return emb, S, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_forward_is_the_row_gather(dtype):
    emb, S, _ = _case(0, dtype)
    w = torch.tensor(emb, dtype=dtype, requires_grad=True)
    St = torch.from_numpy(S)
    out = embed_tokens({"W_s": {"emb": w}}, St)
    assert out.dtype == dtype and out.requires_grad
    assert torch.equal(out.detach(), w.detach()[St])
    with torch.no_grad():             # the sampler's path: the plain gather
        assert torch.equal(embed_tokens({"W_s": {"emb": w}}, St), w.detach()[St])


def test_gradient_matches_jax_vjp_float64():
    emb, S, g = _case(1, torch.float64)
    w = torch.tensor(emb, requires_grad=True)
    (embed_tokens({"W_s": {"emb": w}}, torch.from_numpy(S)) * torch.from_numpy(g)).sum().backward()
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda e: jax_embed_tokens({"W_s": {"emb": e}}, jnp.asarray(S)),
                         jnp.asarray(emb))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    assert w.grad.dtype == torch.float64
    np.testing.assert_allclose(w.grad.numpy(), want, rtol=0, atol=1e-12)
    # tokens that never occur get an exact zero
    absent = np.setdiff1d(np.arange(VOCAB), S)
    assert np.all(w.grad.numpy()[absent] == 0)


def test_gradient_at_fp32_is_the_one_hot_product():
    emb, S, g = _case(2, torch.float32)
    w = torch.tensor(emb, dtype=torch.float32, requires_grad=True)
    gt = torch.tensor(g, dtype=torch.float32)
    embed_tokens({"W_s": {"emb": w}}, torch.from_numpy(S)).backward(gt)
    want = np.zeros((VOCAB, H))
    np.add.at(want, S.reshape(-1), gt.double().numpy().reshape(-1, H))
    assert w.grad.dtype == torch.float32
    rel = np.abs(w.grad.double().numpy() - want).max() / np.abs(want).max()
    assert rel < 1e-6
    again = torch.tensor(emb, dtype=torch.float32, requires_grad=True)
    embed_tokens({"W_s": {"emb": again}}, torch.from_numpy(S)).backward(gt)
    assert torch.equal(again.grad, w.grad)
