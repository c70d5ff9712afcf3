"""The graph-parallel sampler and the chunked graph-parallel featurisation
(``parallel/graph_parallel.py``: ``sample_graph_parallel``,
``_knn_local_rows``, ``gp_rbf_row_chunk``) against the JAX package at
float64 (``kernels="xla"`` under ``jax.enable_x64``).

* ``_knn_local_rows`` with key chunks of 16, 32, 64 and 128 against JAX's
  at L = 70 (exact ties, masked rows and keys, k = 32 above the smallest
  chunk): the selection ``E_idx`` bitwise, and bitwise the port's one-shot
  selection (its distances too).
* On gloo meshes of 2 and 4 ranks and at D x G = 2 x 2 (one spawn each,
  every case in it): given JAX's decode order and JAX's own per-step Gumbel
  noise (drawn as ``test_torch_sampling.py`` draws it), the port's sampler
  draws the tokens of JAX ``sample_graph_parallel`` (a 2-device mesh) and of
  JAX ``sample``, its probabilities within 1e-8 of both (the bar of
  ``test_torch_model64.py``); from a ``torch.Generator`` the tokens,
  order and probabilities of the port's one-device ``sample`` with the same
  seed, with and without a per-position bias and a pair bias; and the
  forward with ``gp_knn_key_chunk=24`` and ``gp_rbf_row_chunk=5`` (K = 16:
  a key chunk that does not divide L, row blocks of 5 and a shorter last
  one) against JAX ``forward`` within 1e-8, its log-probs and the gradient
  of every parameter of a scalar of them, as JAX's
  ``test_graph_parallel.py:295`` holds its chunked forward. The ranks run
  ``test_torch_mesh_workers.py`` (no JAX); the JAX references run here."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import forward as jax_forward
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.models import sample as jax_sample
from na_mpnn_tpu.parallel import graph_parallel as jgp
from na_mpnn_tpu.parallel.mesh import make_mesh as jax_mesh

from na_mpnn_tpu_torch.ops.knn import knn_graph_qk_plain
from na_mpnn_tpu_torch.parallel.graph_parallel import _knn_local_rows
from ref_oracle import make_synthetic_structure
import test_torch_mesh_workers as workers
from test_torch_mesh_workers import spawn

ATOL = 1e-8
SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
             dropout=0.0)
L, NL, B = 32, 33, 2


def test_key_chunked_knn_matches_jax():
    rng = np.random.RandomState(3)
    Bk, Lq, Lk, k = 2, 16, 70, 32
    Xk = rng.randn(Bk, Lk, 3).astype(np.float32) * 4
    Xk[:, 40] = Xk[:, 5]                      # exact ties
    Xk[:, 41] = Xk[:, 5]
    Xq = Xk[:, 20:20 + Lq].copy()
    mq = (rng.rand(Bk, Lq) > 0.1).astype(np.float32)
    mk = (rng.rand(Bk, Lk) > 0.15).astype(np.float32)
    mq[1, 3] = 0.0                             # a masked query row
    t = [torch.from_numpy(a) for a in (Xq, Xk, mq, mk)]
    D0, I0 = knn_graph_qk_plain(*t, k)
    for chunk in (16, 32, 64, 128):
        D, I = _knn_local_rows(*t, k, chunk)
        assert torch.equal(I, I0) and torch.equal(D, D0), chunk
        _, I_j = jgp._knn_local_rows(*map(jnp.asarray, (Xq, Xk, mq, mk)), k,
                                     key_chunk=chunk)
        np.testing.assert_array_equal(I.numpy(), np.asarray(I_j), err_msg=str(chunk))


@pytest.fixture(scope="module")
def reference():
    """The structure (two fixed positions, a masked tail), the float64
    parameters, decode orders, JAX's per-step noise and JAX's two samplers'
    outputs; a bias and a pair bias; and the forward's batch, order,
    cotangent, JAX log-probs and flat gradient."""
    b = make_synthetic_structure(L=L, seed=4, n_protein=16, n_dna=10)
    b["X"] = b["X"].astype(np.float64)
    b["chain_mask"] = np.ones_like(b["mask"])
    b["chain_mask"][0, :2] = 0
    b["mask"][0, -3:] = 0
    rng = np.random.RandomState(8)
    order = np.stack([rng.permutation(L) for _ in range(B)])
    bias = rng.randn(L, NL) * 0.3
    adjacent = ((np.diff(b["R_idx"][0]) == 1)
                & (b["chain_labels"][0, 1:] == b["chain_labels"][0, :-1]))
    pair = {"pair_bias_AA": rng.randn(NL, NL) * 0.5,
            "u_diag": adjacent.astype(np.float64)}
    key = jax.random.PRNGKey(13)
    with jax.enable_x64(True):
        cfg_j = JaxConfig(kernels="xla", **SMALL)
        pj = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_init(jax.random.PRNGKey(2), cfg_j))
        pjj = jax.tree.map(jnp.asarray, pj)
        bj = {**{k: jnp.asarray(v) for k, v in b.items()},
              "decoding_order": jnp.asarray(order)}
        _, key_steps = jax.random.split(key)
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (B, NL), jnp.float64))
                           for k in jax.random.split(key_steps, L)])
        outs = {"gp": jgp.sample_graph_parallel(pjj, cfg_j, bj, key,
                                                jax_mesh(n_devices=2, graph_axis=2),
                                                num_samples=B, temperature=0.5),
                "sample": jax_sample(pjj, cfg_j, bj, key, num_samples=B,
                                     temperature=0.5)}
        outs = {n: {k: np.asarray(v) for k, v in o.items()} for n, o in outs.items()}

        parts = [make_synthetic_structure(L=L, seed=s, n_protein=14, n_dna=12)
                 for s in (21, 22)]
        fb = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        fb["X"] = fb["X"].astype(np.float64)
        fb["mask"][1, -4:] = 0
        f_order = np.stack([rng.permutation(L) for _ in range(2)])
        R = rng.randn(2, L, NL)

        def f(p):
            lp = jax_forward(p, cfg_j, {**{k: jnp.asarray(v) for k, v in fb.items()},
                                        "decoding_order": jnp.asarray(f_order)})[0]
            return jnp.sum(lp * R), lp

        (_, lp_j), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(pjj)
        g_j = np.concatenate([np.asarray(g).reshape(-1)
                              for g in jax.tree.leaves(grads)])
    return {"b": b, "pj": pj, "order": order, "gumbel": gumbel, "jax": outs,
            "bias": bias, "pair": pair, "fwd": (fb, f_order, R),
            "lp_j": np.asarray(lp_j), "g_j": g_j}


@pytest.mark.parametrize("data,graph", [(1, 2), (1, 4), (2, 2)])
def test_sample_graph_parallel_matches_jax_and_sample(reference, tmp_path, data,
                                                      graph):
    r = reference
    res = spawn(workers.sampler_cases, data * graph, tmp_path / "store",
                (data, graph, r["pj"], r["b"], r["order"], r["gumbel"], r["bias"],
                 r["pair"], SMALL, r["fwd"]))
    for out in res:                  # every rank holds the whole result
        got = out["given"]
        for want in r["jax"].values():
            np.testing.assert_array_equal(got["S"], want["S"])
            np.testing.assert_array_equal(got["decoding_order"],
                                          want["decoding_order"])
            for k in ("sampling_probs", "log_probs"):
                np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got["S"][:, :2],
                                      np.broadcast_to(r["b"]["S"][0, :2], (B, 2)))
        for case in ("generator", "bias"):
            gp, one = out[case]
            for k in ("S", "decoding_order"):
                np.testing.assert_array_equal(gp[k], one[k], err_msg=case)
            for k in ("sampling_probs", "log_probs"):
                np.testing.assert_allclose(gp[k], one[k], atol=ATOL, rtol=0,
                                           err_msg=case)
        np.testing.assert_allclose(out["forward"][1], r["g_j"], atol=ATOL, rtol=0)
    lp = np.full(r["lp_j"].shape, np.nan)
    for rank, out in enumerate(res):
        d, g = divmod(rank, graph)
        lp[d * 2 // data:(d + 1) * 2 // data,
           g * L // graph:(g + 1) * L // graph] = out["forward"][0]
    np.testing.assert_allclose(lp, r["lp_j"], atol=ATOL, rtol=0)
    assert np.abs(r["g_j"]).max() > 1e-3
