"""The port's message MLP on a pre-gathered neighbour operand (TPU rows 7
and 8: ``_message_fwd_call``, ``_message_bwd_call``) on the CPU: its plain
versions and its autograd Function against the JAX package's Pallas kernels
in interpret mode, on the same inputs made with numpy, for every
(``contract_e``, ``aggregate``) pair the JAX function takes.

Tolerances: against the Pallas kernels at fp32, 1e-5 relative to the max
(the Pallas kernel's GELU uses the Abramowitz-Stegun erf, error up to
1.5e-7; the port the exact erf); the plain backward against autograd of the
plain forward at float64, 1e-10 (the same function, summed in another
order); the autograd Function's gradients against ``jax.grad`` through
``message_mlp`` (interpret) at fp32, 1e-4 of each leaf's max (the weight
gradients sum 512 edge rows, and the erf difference enters every GELU
derivative)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.ops import message_kernels as jmk

from na_mpnn_tpu_torch.ops import message_kernels as mk

FLAGS = [(True, True), (False, True), (True, False), (False, False)]
ARGS = ("h_V", "e_in", "G", "mask", "wa", "wb", "b1", "w2", "b2", "w3", "b3")
GRAD_NAMES = ("g_hV", "g_ein", "g_G", "dwa", "dwb", "db1", "dw2", "db2",
              "dw3", "db3")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _case(dtype, aggregate, B=2, L=32, K=8, H=128, seed=5):
    """Inputs of one launch as numpy arrays: random biases, a 0/1 mask with
    zeros, the output's cotangent ``g``."""
    rng = np.random.RandomState(seed)
    N = B * L
    f = lambda *s: (rng.randn(*s) * 0.5).astype(dtype)  # noqa: E731
    a = {"h_V": f(N, H), "e_in": f(N * K, H), "G": f(N * K, H),
         "mask": (rng.rand(N * K) > 0.2).astype(dtype),
         "wa": f(H, H) / 8, "wb": f(H, H) / 8, "b1": f(H), "w2": f(H, H) / 8,
         "b2": f(H), "w3": f(H, H) / 8, "b3": f(H),
         "g": f(N if aggregate else N * K, H)}
    return a, K


def _jax_args(a):
    return (a["h_V"], a["e_in"], a["G"], a["mask"][:, None], a["wa"], a["wb"],
            a["b1"][None], a["w2"], a["b2"][None], a["w3"], a["b3"][None])


def _jax_mlp(args, K, contract_e, aggregate):
    return jmk.message_mlp(*args, K, jnp.float32, contract_e, aggregate, True)


@pytest.mark.parametrize("contract_e,aggregate", FLAGS)
def test_plain_forward_matches_pallas(contract_e, aggregate):
    a, K = _case(np.float32, aggregate)
    want = _jax_mlp(tuple(map(jnp.asarray, _jax_args(a))), K, contract_e, aggregate)
    got = mk.message_mlp_plain(*[torch.from_numpy(a[k]) for k in ARGS], K=K,
                               contract_e=contract_e, aggregate=aggregate)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("contract_e", [True, False])
def test_layer_entries_match_jax(contract_e):
    """``message_agg_batched`` (both edge operands) and
    ``message_edge_batched`` against the JAX functions of the same names
    (Pallas kernels in interpret mode) on ``[B,L,K,H]`` operands; L = 20, so
    the JAX side pads N to its 32-node tile and the port does not."""
    rng = np.random.RandomState(7)
    B, L, K, H = 2, 20, 8, 128
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    p = {n: {"w": f(3 * H if n in ("W1", "W11") else H, H) / 8, "b": f(H)}
         for n in ("W1", "W2", "W3", "W11", "W12", "W13")}
    h_V, e_in, G = f(B, L, H), f(B, L, K, H), f(B, L, K, H)
    mask = (rng.rand(B, L, K) > 0.2).astype(np.float32)
    pj = jax.tree.map(jnp.asarray, p)
    pt = {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in p.items()}
    t = torch.from_numpy
    want = jmk.message_agg_batched(pj, jnp.asarray(h_V), jnp.asarray(e_in),
                                   jnp.asarray(G), jnp.asarray(mask),
                                   contract_e=contract_e, interpret=True)
    got = mk.message_agg_batched(pt, t(h_V), t(e_in), t(G), t(mask),
                                 contract_e=contract_e)
    assert got.shape == (B, L, H)
    assert _rel(got, want) < 1e-5
    if contract_e:
        want = jmk.message_edge_batched(pj, jnp.asarray(h_V), jnp.asarray(e_in),
                                        jnp.asarray(G), interpret=True)
        got = mk.message_edge_batched(pt, t(h_V), t(e_in), t(G))
        assert got.shape == (B, L, K, H)
        assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("contract_e,aggregate", FLAGS)
def test_plain_backward_matches_autograd_float64(contract_e, aggregate):
    a, K = _case(np.float64, aggregate, B=2, L=6, K=5, H=32)
    args = [torch.from_numpy(a[k]) for k in ARGS]
    g = torch.from_numpy(a["g"])
    diff = [x.clone().requires_grad_(k != "mask") for k, x in zip(ARGS, args)]
    out = mk.message_mlp_plain(*diff, K=K, contract_e=contract_e,
                               aggregate=aggregate)
    leaves = [x for k, x in zip(ARGS, diff) if k != "mask"]
    ref = torch.autograd.grad(out, leaves, g, allow_unused=True)
    got = mk.message_mlp_bwd_plain(*args, g, K=K, contract_e=contract_e,
                                   aggregate=aggregate)
    # got: g_hV, g_ein, g_G, dwa, dwb, db1, dw2, db2, dw3, db3; ref in ARGS order
    order = (ref[0], ref[1], ref[2], ref[3], ref[4], ref[5], ref[6], ref[7],
             ref[8], ref[9])
    for name, x, want in zip(GRAD_NAMES, got, order):
        if want is None:                     # wb unused without contract_e
            assert name == "dwb" and not contract_e
            assert float(x.abs().max()) == 0.0
            continue
        np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-10, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("contract_e,aggregate", FLAGS)
def test_function_gradients_match_jax_grad(contract_e, aggregate):
    a, K = _case(np.float32, aggregate)
    R = np.random.RandomState(9).randn(*a["g"].shape).astype(np.float32)
    jargs = tuple(map(jnp.asarray, _jax_args(a)))
    diff_idx = (0, 1, 2, 4, 5, 6, 7, 8, 9, 10)      # all but the mask

    def loss(*d):
        full = list(jargs)
        for i, x in zip(diff_idx, d):
            full[i] = x
        return jnp.sum(_jax_mlp(tuple(full), K, contract_e, aggregate) * R)

    want = jax.grad(loss, argnums=tuple(range(10)))(*[jargs[i] for i in diff_idx])
    args = [torch.from_numpy(a[k]).requires_grad_(k != "mask") for k in ARGS]
    out = mk.message_mlp(*args, K=K, contract_e=contract_e, aggregate=aggregate)
    (out * torch.from_numpy(R)).sum().backward()
    leaves = [x for k, x in zip(ARGS, args) if k != "mask"]
    assert args[3].grad is None
    for k, leaf, w in zip([k for k in ARGS if k != "mask"], leaves, want):
        w = np.asarray(w).reshape(leaf.shape)
        if not contract_e and k == "wb":
            assert float(leaf.grad.abs().max()) == 0.0 and np.abs(w).max() == 0.0
            continue
        assert _rel(leaf.grad, w) < 1e-4, k


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise (only ``message_mlp``, the
    dispatcher, takes the plain version for CPU tensors)."""
    a, K = _case(np.float32, True, B=1, L=4, K=4, H=32)
    args = [torch.from_numpy(a[k]) for k in ARGS]
    flags = dict(K=K, contract_e=False, aggregate=True)
    with pytest.raises(ValueError, match="CUDA"):
        mk.message_mlp_cuda(*args, **flags)
    with pytest.raises(ValueError, match="CUDA"):
        mk.message_mlp_bwd_cuda(*args, torch.from_numpy(a["g"]), **flags)
    assert mk.table_gather_ok(64) and not mk.table_gather_ok(50)
