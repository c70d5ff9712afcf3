"""Rows 11 and 12 split as their CUDA kernels split them, on the CPU.

The node update's kernel (``csrc/fused_layers.cu``) is two launches: the
message sum over ``csrc/message_tile.cuh``'s tiles into an fp32 ``dh``, then
the tail (LN1, the feed-forward block, LN2, the node mask) over tiles of
``tail_tile_rows`` nodes. Its plain version is the composition of
``fused_node_message_plain`` and ``fused_node_tail_plain``; the edge update
is one launch (``fused_edge_update_plain``). At H = 128, B = 2 and L = 37
(N = 74, a multiple of none of the kernels' tiles: 64-row message tiles of
2 or 4 whole nodes at K = 32 or 16, tail tiles of 16-64 nodes), with masked
nodes and edges and random decoder masks:

* the composition is the plain node update, bitwise, and ``dh`` stays fp32
  for bf16 operands;
* the message part against JAX's Pallas message kernel
  (``_message_fwd_call``, aggregating, interpret mode), whose body is the
  JAX fused kernel's message part (``_compute_x``, ``_gelu``, ``_dotp``,
  ``_seg_sum``); fed fp32 arrays that hold bf16 values at
  ``compute_dtype=bfloat16`` it returns the unrounded ``dh`` that the JAX
  fused kernel carries into LN1;
* the tail against JAX ``fused_node_update`` with W3's weight zero, so that
  every message is b3 and ``dh = sum_k(w) * b3 / 30`` (w = mask_att in the
  encoder, 1 in the decoder), which the tail is given;
* the composition and the edge update against JAX ``fused_node_update`` /
  ``fused_edge_update``;
* the tail's tile map ``tail_tile_rows``.

The JAX kernels run on N padded with masked rows to their grid (32 nodes),
as JAX's own layer wrappers pad it. Tolerances, as
``test_torch_fused_layers.py`` and ``test_torch_bf16_kernels.py`` state them:
fp32 3e-5 absolute on LayerNorm outputs of order 1 (JAX holds the same
kernels to 2e-5 against XLA; the port adds the difference between the
Pallas kernels' Abramowitz-Stegun erf, error up to 1.5e-7, and the exact
erf, and another summation order), and 3e-5 of its largest magnitude on
``dh``; bf16 2^-6 of the largest magnitude (four bf16 steps: a rounding
that flips upstream on one side only, plus the output's own rounding).
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.ops import fused_layers as jfl
from na_mpnn_tpu.ops import message_kernels as jmk

from na_mpnn_tpu_torch.ops import fused_layers as fl
from na_mpnn_tpu_torch.params import from_jax_params
from test_torch_fused_layers import _layers, _operands

BF = jnp.bfloat16
ATOL32 = 3e-5
TOL_BF16 = 2.0 ** -6
H = 128
B, L = 2, 37
PAD = 32


def _r16(a):
    """numpy fp32 values rounded to bf16 (round to nearest even)."""
    return torch.from_numpy(np.array(a, np.float32)).bfloat16().float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


def _case(K, low, kind):
    """Operands (numpy, bf16-rounded where ``low``) and the layer's
    parameters: numpy (JAX layout) and the port's tensors."""
    o = _operands(B, L, K, seed=K + len(kind) + 7 * low)
    pe, pd = _layers(K + 3)
    p = pd if kind == "dec" else pe
    if low:
        o = {k: (_r16(v) if v.dtype == np.float32 else v) for k, v in o.items()}
        p = jax.tree.map(_r16, p)
    dt = torch.bfloat16 if low else torch.float32
    return o, p, from_jax_params(p, device="cpu", dtype=dt), dt


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _pad(a, K=1):
    """Rows of a node (K = 1) or edge (K) array padded with zeros to the JAX
    kernels' grid of PAD nodes."""
    n = a.shape[0] // K
    extra = (-n % PAD) * K
    return np.concatenate([a, np.zeros((extra,) + a.shape[1:], a.dtype)])


def _port_node_args(kind, o, tp, dt):
    if kind == "enc":
        return ("enc", tp, _t(o["h_V"], dt), _t(o["h_E"], dt), _t(o["table"], dt),
                _t(o["eidx"], torch.int64), _t(o["m_att"], dt), None, _t(o["mask"], dt))
    return ("dec", tp, _t(o["h_V"], dt), _t(o["h_E"], dt), _t(o["table2"], dt),
            _t(o["eidx"], torch.int64), _t(o["m1d"], dt), _t(o["mbw"], dt),
            _t(o["mask"], dt))


def _jax_edge_terms(kind, o, p):
    """The JAX kernels' edge operands: enc (h_E, G = table[row], wb); dec the
    e-term m1d * (h_E @ wb) in the static slot and the causal context
    G = mbw * A[row] + m1d * B[row] (``dec_layer_fused``'s operands), both
    from float64 sums of the (bf16-rounded) operands."""
    wb = p["W1"]["w"][H:2 * H]
    if kind == "enc":
        return o["h_E"], o["table"][o["row"]], wb
    static = o["m1d"][:, None] * (o["h_E"].astype(np.float64) @ wb.astype(np.float64))
    g = o["table2"][o["row"]].astype(np.float64)
    G = o["mbw"][:, None] * g[:, :H] + o["m1d"][:, None] * g[:, H:]
    return static.astype(np.float32), G.astype(np.float32), None


def _jax_node_update(kind, o, p, K, low):
    """JAX ``fused_node_update`` (interpret mode) on the padded operands;
    bf16 arrays (the decoder's fp32 e-term aside) and ``compute_dtype`` at
    bf16. Returns [N, H] fp32."""
    cast = (lambda a: jnp.asarray(a, BF)) if low else jnp.asarray  # noqa: E731
    e, G, wb = _jax_edge_terms(kind, o, p)
    N = B * L
    enc = kind == "enc"
    att = o["m_att"] if enc else np.ones(N * K, np.float32)
    jp = jax.tree.map(cast, p)
    # the decoder's e-term enters unrounded, as the port's kernel adds it
    out = jfl.fused_node_update(
        cast(_pad(o["h_V"])), (cast if enc else jnp.asarray)(_pad(e, K)), cast(_pad(G, K)),
        cast(wb if enc else np.zeros((H, H), np.float32)), cast(_pad(att, K))[:, None],
        cast(_pad(o["mask"]))[:, None], jp, K, compute_dtype=BF if low else jnp.float32,
        has_static=not enc, interpret=True)
    return np.asarray(jnp.asarray(out[:N], jnp.float32))


def _close(got, want, low):
    got = got.float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    if low:
        assert _rel(got, want) < TOL_BF16
    else:
        np.testing.assert_allclose(got, want, atol=ATOL32, rtol=0)


@pytest.mark.parametrize("low", [False, True])
@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_plain_node_update_is_message_then_tail(kind, low):
    """The plain node update equals its two parts composed, bitwise; the
    message part's dh is fp32 (unrounded) for bf16 operands."""
    K = 16
    o, _, tp, dt = _case(K, low, kind)
    args = _port_node_args(kind, o, tp, dt)
    dh = fl.fused_node_message_plain(*args[:8], K=K, L=L)
    assert dh.dtype == torch.float32 and dh.shape == (B * L, H)
    if low:   # unrounded: most entries are not bf16 numbers
        assert (dh != dh.bfloat16().float()).float().mean() > 0.5
    whole = fl.fused_node_update_plain(*args, K=K, L=L)
    parts = fl.fused_node_tail_plain(tp, args[2], dh, args[8])
    assert whole.dtype == dt and torch.equal(whole, parts)


@pytest.mark.parametrize("low", [False, True])
@pytest.mark.parametrize("K", [16, 32])
@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_message_part_matches_pallas(kind, K, low):
    o, p, tp, dt = _case(K, low, kind)
    e, G, wb = _jax_edge_terms(kind, o, p)
    N = B * L
    att = o["m_att"] if kind == "enc" else np.ones(N * K, np.float32)
    w = p["W1"]["w"]
    args = [_pad(o["h_V"]), _pad(e, K), _pad(G, K), _pad(att, K)[:, None], w[:H],
            wb if kind == "enc" else np.zeros((H, H), np.float32), p["W1"]["b"][None],
            p["W2"]["w"], p["W2"]["b"][None], p["W3"]["w"], p["W3"]["b"][None]]
    want = jmk._message_fwd_call(*map(jnp.asarray, args), K,
                                 BF if low else jnp.float32, kind == "enc", True, True)
    want = np.asarray(want)[:N]
    assert want.dtype == np.float32
    got = fl.fused_node_message_plain(*_port_node_args(kind, o, tp, dt)[:8], K=K, L=L)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < (TOL_BF16 if low else ATOL32)
    assert not got.numpy()[o["mask"] == 0].any() or kind == "dec"


@pytest.mark.parametrize("low", [False, True])
@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_tail_matches_pallas(kind, low):
    """W3's weight zero: every message is b3, so dh = sum_k(w) * b3 / 30."""
    K = 16
    o, p, _, dt = _case(K, low, kind)
    p["W3"]["w"] = np.zeros_like(p["W3"]["w"])
    tp = from_jax_params(p, device="cpu", dtype=dt)
    N = B * L
    w = o["m_att"] if kind == "enc" else np.ones(N * K, np.float32)
    dh = (w.reshape(N, K, 1) * p["W3"]["b"].astype(np.float32)).sum(1) / np.float32(30)
    want = _jax_node_update(kind, o, p, K, low)
    got = fl.fused_node_tail_plain(tp, _t(o["h_V"], dt), _t(dh), _t(o["mask"], dt))
    assert got.dtype == dt
    _close(got, want, low)
    assert not got.float().numpy()[o["mask"] == 0].any()


@pytest.mark.parametrize("low", [False, True])
@pytest.mark.parametrize("K", [16, 32])
@pytest.mark.parametrize("kind", ["enc", "dec", "edge"])
def test_composition_matches_pallas(kind, K, low):
    o, p, tp, dt = _case(K, low, kind)
    if kind == "edge":
        cast = (lambda a: jnp.asarray(a, BF)) if low else jnp.asarray  # noqa: E731
        want = jfl.fused_edge_update(
            cast(_pad(o["h_V"])), cast(_pad(o["h_E"], K)),
            cast(_pad(o["table"][o["row"]], K)), jax.tree.map(cast, p), K,
            compute_dtype=BF if low else jnp.float32, interpret=True)
        want = np.asarray(jnp.asarray(want, jnp.float32))[:B * L * K]
        got = fl.fused_edge_update_plain(tp, _t(o["h_V"], dt), _t(o["h_E"], dt),
                                         _t(o["table"], dt), _t(o["eidx"], torch.int64),
                                         K=K, L=L)
    else:
        want = _jax_node_update(kind, o, p, K, low)
        got = fl.fused_node_update_plain(*_port_node_args(kind, o, tp, dt), K=K, L=L)
        assert not got.float().numpy()[o["mask"] == 0].any()
    assert got.dtype == dt
    _close(got, want, low)


def test_tail_tile_rows():
    """The tail's nodes per tile: one of the kernel's tiles, at least 2048 /
    H rows (each of its 16 warps owns 8 columns or more); at the main
    path's shapes on 132 SMs: design (N = 389) and a group (800) 16, score
    (3890) 32, eval_step (6144) 64."""
    assert fl.TAIL_ROWS == (64, 32, 16)
    for H_ in (32, 64, 128):
        for n_sm in (1, 7, 132):
            for N in (1, 15, 16, 17, 389, 800, 3890, 6144, 20000):
                rows = fl.tail_tile_rows(N, H_, n_sm)
                assert rows in fl.TAIL_ROWS and rows * H_ >= 2048
    assert fl.tail_tile_rows(5, 32, 132) == 64 and fl.tail_tile_rows(5, 64, 132) == 32
    got = [fl.tail_tile_rows(N, 128, 132) for N in (389, 800, 3890, 6144)]
    assert got == [16, 16, 32, 64]


def test_tail_tile_rows_are_the_kernels():
    """The tile sizes the wrapper picks are those the kernel instantiates
    (``launch_tail_rows``: 16, 32 and 64 nodes, 16 * RB)."""
    from pathlib import Path
    import re
    src = (Path(fl.__file__).resolve().parent.parent / "csrc" / "fused_layers.cu").read_text()
    body = src[src.index("int launch_tail_rows("):]
    body = body[:body.index("\n}\n")]
    cases = {int(c): int(rb) for c, rb in
             re.findall(r"case (\d+):\s*(?:if constexpr \(H >= \d+\)\s*)?return "
                        r"launch_tail<H, (\d+)>", body)}
    assert cases == {r: r // 16 for r in fl.TAIL_ROWS}


@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_weights_aligned(dtype, offset):
    """The feed-forward block's W_in [H, 4H] and W_out [4H, H], views at
    ``offset`` elements into a flat vector, as the node update's wrapper
    hands them to the tail (``aligned_weights`` one at a time): each starts
    16-byte aligned, with the same values, and is copied only when its view
    does not."""
    from na_mpnn_tpu_torch.ops.message_kernels import aligned_weights
    flat = torch.from_numpy(np.random.RandomState(offset).randn(8 * H * H + 8)).to(dtype)
    assert flat.data_ptr() % 16 == 0
    for i, shape in enumerate(((H, 4 * H), (4 * H, H))):
        start = offset + i * 4 * H * H
        view = flat[start:start + 4 * H * H].view(shape)
        w, = aligned_weights(view)
        assert w.data_ptr() % 16 == 0 and w.shape == shape and w.dtype == dtype
        assert torch.equal(w, view)
        assert (w.data_ptr() == view.data_ptr()) == (start * flat.element_size() % 16 == 0)
