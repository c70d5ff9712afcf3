"""What the pre-gathered message MLP's kernels (TPU rows 7 and 8:
``csrc/message_mlp.cu`` on the forward walk of ``csrc/message_tile.cuh``,
``csrc/message_mlp_bwd.cu`` on the backward walk of
``csrc/message_bwd_tile.cuh``) take from their wrappers
(``ops/message_kernels.py``), and a plain model of how they split the work,
held on the CPU, where the kernels do not run.

The model splits rows 7 and 8 as the kernels split them:

* the forward over tiles of ``table_tile_nodes(K)`` whole nodes: per tile
  ``x = ((h_V@Wa + G) + b1) + (e_in@Wb or e_in)`` in that order, the two
  products, and with ``aggregate`` each node's K rows summed in the order
  k = 0..K-1, then / 30 and rounded once;
* the backward over tiles of ``bwd_tile_nodes(K)`` whole nodes: per tile x
  recomputed as the forward does and never rounded, ``g_m`` (with
  ``aggregate`` the cotangent times ``mask_att / 30`` divided in the mask's
  own type, as JAX divides it), ``g_y``, ``g_x``, the tile's bias partials,
  its K-sums ``s`` and ``g_hV``, ``g_G = g_x`` and ``g_ein`` (``g_x`` without
  ``contract_e``); the per-edge operands of the weight gradients as the
  scratch holds them (rounded at bf16); the bias partials reduced over the
  tiles in the kernel's order (32 lanes each adding every 32nd tile, then a
  butterfly); the weight gradients as split-K products over the kernel's
  row ranges (``split_rows``, the kernels' cut), the partials added in order.

Tolerances. The model at float64 against ``message_mlp_plain`` /
``message_mlp_bwd_plain``: 1e-8 of the max (the same function summed in
other orders). At fp32 against the JAX ``_message_fwd_call`` /
``_message_bwd_call`` in interpret mode: the bars of
``tests/test_torch_message_mlp.py``, 1e-5 of the max on the output and the
per-node and per-edge gradients (the JAX GELU uses the Abramowitz-Stegun
erf, error up to 1.5e-7), 1e-4 on the weight and bias sums. At bf16: the
bar of ``tests/test_torch_bf16_rows5to8.py``, 2^-6 of the max on every
bf16 output (both sides round at the same points, but XLA on the CPU sums
in other orders and drops some bf16 roundings). The JAX kernels take N in
multiples of their 32-node tile: N = 37 nodes are padded to 64 with zero
rows and a zero cotangent, which add nothing, so that the model also runs
with a tile that is not full. Widths: H = 32 (the bars hold at any width).
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from na_mpnn_tpu.ops import message_kernels as jmk

from na_mpnn_tpu_torch.models.modules import MESSAGE_SCALE, dotp, gelu, widen
from na_mpnn_tpu_torch.ops import message_kernels as mk

CSRC = Path(mk.__file__).resolve().parent.parent / "csrc"
FLAGS = [(False, True), (True, True), (True, False), (False, False)]
KS = [1, 30, 32, 48, 64]
ARGS = ("h_V", "e_in", "G", "mask", "wa", "wb", "b1", "w2", "b2", "w3", "b3")
GRADS = ("g_hV", "g_ein", "g_G", "dwa", "dwb", "db1", "dw2", "db2", "dw3", "db3")
N_NODES, H = 37, 32
SPLITS = 3          # weight-gradient row ranges of the model (any number works)
GRAD_CHUNK = 64     # rows per weight-gradient chunk (message_bwd_tile.cuh: kChunk)
BF = jnp.bfloat16
TOL_BF16 = 2.0 ** -6


def _ids(flags):
    return [f"ce{int(c)}-agg{int(a)}" for c, a in flags]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


def _rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean()))


def _case(K, aggregate, seed, N=N_NODES):
    """Operands of one launch as numpy fp32 arrays on bf16 values (so that
    each dtype takes the same numbers): a 0/1 mask with zeros, random
    biases, the output's cotangent ``g``."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=0.5):
        return np.asarray(torch.from_numpy(rng.randn(*shape) * scale).to(
            torch.bfloat16).float())

    a = {"h_V": f(N, H), "e_in": f(N * K, H), "G": f(N * K, H),
         "mask": (rng.rand(N * K) > 0.2).astype(np.float32),
         "wa": f(H, H, scale=0.2), "wb": f(H, H, scale=0.2), "b1": f(H),
         "w2": f(H, H, scale=0.2), "b2": f(H), "w3": f(H, H, scale=0.2),
         "b3": f(H), "g": f(N if aggregate else N * K, H)}
    return a


def _torch(a, dtype):
    return [torch.from_numpy(a[k]).to(dtype) for k in ARGS], torch.from_numpy(
        a["g"]).to(dtype)


# ---------------------------------------------------------------------------
# The model of the kernels' decomposition
# ---------------------------------------------------------------------------

def _tile_x(hv, ein, g, wa, wb, b1, K, contract_e, low):
    """A tile's pre-GELU x in the walks' order of sums, unrounded."""
    x = dotp(hv, wa, low).repeat_interleave(K, dim=0) + widen(g)
    x = x + widen(b1)
    return x + (dotp(ein, wb, low) if contract_e else widen(ein))


def _ksum(v, nodes, K):
    """Each node's K rows summed in the order k = 0..K-1."""
    v = v.view(nodes, K, -1)
    s = v[:, 0]
    for k in range(1, K):
        s = s + v[:, k]
    return s


def model_forward(args, *, K, contract_e, aggregate):
    """Row 7 tile by tile (tiles of ``table_tile_nodes(K)`` nodes)."""
    h_V, e_in, G, mask, wa, wb, b1, w2, b2, w3, b3 = args
    N = h_V.shape[0]
    low = h_V.dtype == torch.bfloat16
    tn = mk.table_tile_nodes(K)
    outs = []
    for n0 in range(0, N, tn):
        n1 = min(n0 + tn, N)
        e = slice(n0 * K, n1 * K)
        x = _tile_x(h_V[n0:n1], e_in[e], G[e], wa, wb, b1, K, contract_e, low)
        m = dotp(gelu(dotp(gelu(x), w2, low) + widen(b2)), w3, low) + widen(b3)
        if aggregate:
            m = _ksum(m * widen(mask[e])[:, None], n1 - n0, K) / MESSAGE_SCALE
        outs.append(m)
    return torch.cat(outs).to(h_V.dtype)


def split_rows(R, splits):
    """The rows ``[lo, hi)`` of each of ``splits`` weight-gradient ranges
    over ``R`` rows, as the kernels cut them: range ``s`` takes chunks
    ``s * n // splits`` up to ``(s + 1) * n // splits`` of the ``n`` chunks
    of ``GRAD_CHUNK`` rows (the last one short); its partial is added to the
    others in the order of ``s``."""
    n = -(-R // GRAD_CHUNK)
    return [(min(s * n // splits * GRAD_CHUNK, R),
             min((s + 1) * n // splits * GRAD_CHUNK, R)) for s in range(splits)]


def _reduce_tiles(bpart):
    """The bias partials [tiles, 3H] summed as the kernel sums them: lane l
    of 32 adds tiles l, l + 32, ... in order, then a butterfly over the
    lanes (xor 16, 8, 4, 2, 1); lane 0's sum."""
    lanes = torch.zeros((32, bpart.shape[1]), dtype=bpart.dtype)
    for b in range(bpart.shape[0]):
        lanes[b % 32] = lanes[b % 32] + bpart[b]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ o]
    return lanes[0]


def model_backward(args, g, *, K, contract_e, aggregate, splits=SPLITS,
                   scale="type"):
    """Row 8 tile by tile (tiles of ``bwd_tile_nodes(K)`` nodes) ->
    (``g_hV, g_ein, g_G`` in the operands' type, the weight and bias sums
    ``dwa, dwb, db1, dw2, db2, dw3, db3`` unrounded). ``scale``: "type"
    takes the aggregate cotangent's scale ``mask_att / 30`` in the mask's
    type (the kernel's); "fp32" takes the table backward's ``(g * mask_att)
    / 30`` in fp32, for the guard that tells them apart."""
    h_V, e_in, G, mask, wa, wb, b1, w2, b2, w3, b3 = args
    dt = h_V.dtype
    low = dt == torch.bfloat16
    N = h_V.shape[0]
    tn = mk.bwd_tile_nodes(K)

    def kept(t):    # as the scratch holds an operand: rounded at bf16
        return t.to(dt).float() if low else t

    cols = {k: [] for k in ("g_hV", "g_ein", "g_G", "u1", "gm", "u2", "gy", "s", "ge")}
    bpart = []
    for n0 in range(0, N, tn):
        n1 = min(n0 + tn, N)
        e = slice(n0 * K, n1 * K)
        x = _tile_x(h_V[n0:n1], e_in[e], G[e], wa, wb, b1, K, contract_e, low)
        u1 = gelu(x)
        y = dotp(u1, w2, low) + widen(b2)
        if not aggregate:
            g_m = widen(g[e])
        elif scale == "type":
            g_m = widen(g[n0:n1]).repeat_interleave(K, dim=0) * widen(
                mask[e][:, None] / MESSAGE_SCALE)
        else:
            g_m = widen(g[n0:n1]).repeat_interleave(K, dim=0) * widen(
                mask[e])[:, None] / MESSAGE_SCALE
        g_y = dotp(g_m, w3.T, low) * mk.gelu_grad(y)
        g_x = dotp(g_y, w2.T, low) * mk.gelu_grad(x)
        s = _ksum(g_x, n1 - n0, K)
        bpart.append(torch.cat([g_x.sum(0), g_y.sum(0), g_m.sum(0)]))
        cols["g_hV"].append(dotp(s, wa.T, low))
        cols["g_G"].append(g_x)
        cols["g_ein"].append(dotp(g_x, wb.T, low) if contract_e else g_x)
        for k, v in (("u1", u1), ("gm", g_m), ("u2", gelu(y)), ("gy", g_y), ("s", s),
                     ("ge", g_x)):
            cols[k].append(kept(v))
    c = {k: torch.cat(v) for k, v in cols.items()}
    pairs = ((widen(h_V), c["s"]), (widen(e_in), c["ge"]) if contract_e else None,
             (c["u1"], c["gy"]), (c["u2"], c["gm"]))
    wsum = []
    for pq in pairs:
        total = torch.zeros((H, H), dtype=c["s"].dtype)
        if pq is not None:
            P, Q = pq
            for lo, hi in split_rows(P.shape[0], splits):
                total = total + P[lo:hi].T @ Q[lo:hi]
        wsum.append(total)
    db1, db2, db3 = _reduce_tiles(torch.stack(bpart)).split(H)
    edge = tuple(c[k].to(dt) for k in ("g_hV", "g_ein", "g_G"))
    return edge, (wsum[0], wsum[1], db1, wsum[2], db2, wsum[3], db3)


def _model(a, K, ce, agg, dtype, scale="type"):
    """[output, the ten backward outputs] of the model on ``a`` in ``dtype``
    (weight and bias sums rounded once to ``dtype``, as the wrapper does)."""
    args, g = _torch(a, dtype)
    out = model_forward(args, K=K, contract_e=ce, aggregate=agg)
    edge, sums = model_backward(args, g, K=K, contract_e=ce, aggregate=agg,
                                scale=scale)
    g_hV, g_ein, g_G = edge
    dwa, dwb, db1, dw2, db2, dw3, db3 = (t.to(dtype) for t in sums)
    return [out, g_hV, g_ein, g_G, dwa, dwb, db1, dw2, db2, dw3, db3]


def _jax(a, K, ce, agg, dtype, cast_sums=True):
    """[output, the ten backward outputs] of the JAX kernels in interpret
    mode at ``dtype`` (fp32 numpy, biases ``[H]``), N padded to a multiple
    of 32 nodes with zero rows; ``cast_sums`` rounds the weight and bias
    sums to ``dtype``, as the JAX VJP casts them."""
    N = a["h_V"].shape[0]
    Np = -(-N // jmk.NODE_TILE) * jmk.NODE_TILE
    rows = {"h_V": Np, "e_in": Np * K, "G": Np * K, "mask": Np * K,
            "g": Np if agg else Np * K}

    def pad(k, v):
        if k not in rows:
            return v
        return np.concatenate([v, np.zeros((rows[k] - v.shape[0],) + v.shape[1:],
                                           v.dtype)])

    p = {k: pad(k, v) for k, v in a.items()}
    jargs = [jnp.asarray(p[k], dtype)[:, None] if k == "mask" else
             jnp.asarray(p[k], dtype)[None] if k in ("b1", "b2", "b3") else
             jnp.asarray(p[k], dtype) for k in ARGS]
    out = jmk._message_fwd_call(*jargs, K, dtype, ce, agg, True)
    grads = jmk._message_bwd_call(*jargs, jnp.asarray(p["g"], dtype), K, dtype,
                                  ce, agg, True)
    keep = {"out": N if agg else N * K, "g_hV": N, "g_ein": N * K, "g_G": N * K}
    res = []
    for name, t in zip(("out",) + GRADS, (out, *grads)):
        if cast_sums or name in keep:
            t = jnp.asarray(t).astype(dtype)
        t = np.asarray(jnp.asarray(t, jnp.float32))
        res.append(t[:keep[name]] if name in keep else
                   t.reshape(-1) if name.startswith("db") else t)
    return res


# ---------------------------------------------------------------------------
# The model against the plain versions and against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("contract_e,aggregate", FLAGS, ids=_ids(FLAGS))
def test_model_matches_plain_float64(contract_e, aggregate, K):
    a = _case(K, aggregate, seed=K + 2 * contract_e + aggregate)
    args, g = _torch(a, torch.float64)
    flags = dict(K=K, contract_e=contract_e, aggregate=aggregate)
    edge, sums = model_backward(args, g, **flags)
    got = [model_forward(args, **flags), *edge, *sums]
    want = [mk.message_mlp_plain(*args, **flags),
            *mk.message_mlp_bwd_plain(*args, g, **flags)]
    for name, x, w in zip(("out",) + GRADS, got, want):
        assert x.dtype == torch.float64 and x.shape == w.shape, name
        if name == "dwb" and not contract_e:
            assert not bool(x.any()) and not bool(w.any())
            continue
        assert _rel(x, w) < 1e-8, name


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("contract_e,aggregate", FLAGS, ids=_ids(FLAGS))
def test_model_matches_pallas_fp32(contract_e, aggregate, K):
    a = _case(K, aggregate, seed=40 + K + 2 * contract_e + aggregate)
    got = _model(a, K, contract_e, aggregate, torch.float32)
    want = _jax(a, K, contract_e, aggregate, jnp.float32)
    for name, x, w in zip(("out",) + GRADS, got, want):
        assert x.shape == w.shape, name
        tol = 1e-5 if name in ("out", "g_hV", "g_ein", "g_G") else 1e-4
        if name == "dwb" and not contract_e:
            assert not bool(x.any())
            continue
        assert _rel(x, w) < tol, name


@pytest.mark.parametrize("K", [1, 30, 64])
@pytest.mark.parametrize("contract_e,aggregate", FLAGS, ids=_ids(FLAGS))
def test_model_matches_pallas_bf16(contract_e, aggregate, K):
    a = _case(K, aggregate, seed=80 + K + 2 * contract_e + aggregate)
    got = _model(a, K, contract_e, aggregate, torch.bfloat16)
    want = _jax(a, K, contract_e, aggregate, BF)
    for name, x, w in zip(("out",) + GRADS, got, want):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape, name
        if name == "dwb" and not contract_e:
            assert not bool(x.any())
            continue
        assert _rel(x.float(), w) < TOL_BF16, name


# ---------------------------------------------------------------------------
# The aggregate cotangent's scale at bf16
# ---------------------------------------------------------------------------

GUARD_K = 30
GUARD_SEED = 120


def _write_exact_reference(path):
    """JAX's bf16 rows 8 of both aggregate flag pairs, its weight and bias
    sums fp32, into an npz (run in a process whose XLA keeps every bf16
    rounding, ``exact_reference``)."""
    out = {}
    for ce in (False, True):
        res = _jax(_case(GUARD_K, True, GUARD_SEED + ce), GUARD_K, ce, True, BF,
                   cast_sums=False)
        out[f"{int(ce)}_g_hV"], out[f"{int(ce)}_db3"] = res[1], res[10]
    np.savez(path, **out)


@pytest.fixture(scope="module")
def exact_reference(tmp_path_factory):
    """JAX's bf16 backward from a process started with
    ``--xla_allow_excess_precision=false``: by default XLA on the CPU keeps
    the bf16 ``mask_att / 30`` in fp32 (``jax.jit(lambda g, m: g * (m /
    30.0))`` returns ``g / 30`` for a bf16 ``m``), which is the fp32 scale
    this guard must tell apart."""
    path = tmp_path_factory.mktemp("exact_mlp") / "reference.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=" ".join([os.environ.get("XLA_FLAGS", ""),
                                   "--xla_allow_excess_precision=false"]).strip(),
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(tests), tests, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                   env=env, check=True, timeout=600)
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("contract_e", [False, True])
def test_bf16_aggregate_scale_is_the_masks_type(exact_reference, contract_e):
    """At bf16 the aggregating backward scales the cotangent by
    ``bf16(mask_att / 30)``, as JAX divides the bf16 mask; the table
    backward's fp32 ``(g * mask_att) / 30`` (``bf16(1/30)`` = 0.033325 is
    not 1/30) would move every ``g_m``. The model with the mask's type sits
    nearer JAX's bf16 ``g_hV`` and fp32 ``db3`` than the same model with
    the fp32 scale."""
    a = _case(GUARD_K, True, GUARD_SEED + contract_e)
    args, g = _torch(a, torch.bfloat16)
    flags = dict(K=GUARD_K, contract_e=contract_e, aggregate=True)
    res = {s: model_backward(args, g, **flags, scale=s) for s in ("type", "fp32")}
    tag = str(int(contract_e))
    for name, pick in (("g_hV", lambda r: r[0][0].float()),
                       ("db3", lambda r: r[1][6])):
        want = exact_reference[f"{tag}_{name}"].reshape(-1)
        near = _rms(pick(res["type"]).reshape(-1), want)
        far = _rms(pick(res["fp32"]).reshape(-1), want)
        assert near < far, (name, near, far)


# ---------------------------------------------------------------------------
# The tile maps and their constants
# ---------------------------------------------------------------------------

def _const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_backward_tile_constants_are_the_kernels():
    """The wrapper's backward tile map and the model's chunk and splits
    against the shared backward walk's source: 128-row tiles of at most 16 whole nodes,
    64-row weight-gradient chunks, each split range whole chunks of
    ``ch0 = s * nch / splits``, and the C entry refusing a tile map outside
    them."""
    text = (CSRC / "message_bwd_tile.cuh").read_text()
    assert _const(text, "kTileRows") == mk.BWD_TILE_ROWS == 128
    assert _const(text, "kMaxTileNodes") == mk.BWD_MAX_TILE_NODES == 16
    assert _const(text, "kChunk") == GRAD_CHUNK
    assert "const int nch = (R + kChunk - 1) / kChunk;" in text
    assert "ch0 = (int)((long long)blockIdx.x * nch / gridDim.x)" in text
    assert "ch1 = (int)((long long)(blockIdx.x + 1) * nch / gridDim.x)" in text
    entry = (CSRC / "message_mlp_bwd.cu").read_text()
    assert "tn * K > kTileRows" in entry and "tn > kMaxTileNodes" in entry
    assert "K > kTileRows / 2" in entry and mk.MAX_K == mk.BWD_TILE_ROWS // 2
    fwd = (CSRC / "message_tile.cuh").read_text()
    assert _const(fwd, "kTileRows") == mk.TILE_ROWS
    assert "kOpGathered" in (CSRC / "message_mlp.cu").read_text()


def test_tile_maps_hold_whole_nodes():
    for K in range(1, mk.MAX_K + 1):
        tn = mk.bwd_tile_nodes(K)
        assert 1 <= tn <= mk.BWD_MAX_TILE_NODES and tn * K <= mk.BWD_TILE_ROWS
        assert tn == mk.BWD_MAX_TILE_NODES or (tn + 1) * K > mk.BWD_TILE_ROWS


@pytest.mark.parametrize("splits", [1, 3, 44])
def test_split_rows_cover_the_rows_in_chunks(splits):
    """Each weight gradient's ranges lie end to end over all R rows, each
    starting on a chunk boundary, the kernel's formula row for row."""
    for R in (0, 1, 63, 64, 65, 1110, 6000, 192000):
        ranges = split_rows(R, splits)
        assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == R
        nch = (R + GRAD_CHUNK - 1) // GRAD_CHUNK
        for s, ((lo, hi), nxt) in enumerate(zip(ranges, ranges[1:] + [(R, R)])):
            assert hi == nxt[0] and lo <= hi and lo % GRAD_CHUNK == 0
            assert lo == min(s * nch // splits * GRAD_CHUNK, R)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """K outside 1..64 and H outside (32, 64, 128) raise ``ValueError``
    naming them, never a plain fallback; CPU tensors raise too."""
    a = _case(4, True, seed=3, N=4)
    args, g = _torch(a, torch.float32)
    flags = dict(contract_e=False, aggregate=True)
    for fn, extra in ((mk.message_mlp_cuda, ()), (mk.message_mlp_bwd_cuda, (g,))):
        with pytest.raises(ValueError, match="K=65"):
            fn(*args, *extra, K=65, **flags)
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, *extra, K=4, **flags)
    wide = [torch.zeros(t.shape[:-1] + (48,)) if t.dim() == 2 and t.shape[-1] == H
            else t for t in args]
    with pytest.raises(ValueError, match="H=48"):
        mk.message_mlp_cuda(*wide, K=4, **flags)


if __name__ == "__main__":      # the exact reference, in its own process
    _write_exact_reference(sys.argv[1])
