"""The bf16 variants of kernel rows 5-8 on the CPU, and the training steps
that run them.

* Rows 5 and 6 (the dense RBF and its weight gradient): each plain bf16
  version against the JAX package's ``rbf_edge_embed`` /
  ``rbf_edge_embed_dw`` at ``compute_dtype=bfloat16`` in interpret mode
  (through ``rbf_edge_features`` and its custom VJP), E = 512 edges (two of
  the TPU kernel's 256-edge tiles) at H = 128, on inputs made from a seed
  with numpy; the query/key form gives the self-keyed rows it covers.
* Rows 7 and 8 (the pre-gathered message MLP and its backward): each plain
  bf16 version against ``_message_fwd_call`` / ``_message_bwd_call`` at
  bf16 in interpret mode, all four ``(contract_e, aggregate)`` pairs, the
  output and all ten backward outputs (the weight gradients rounded once to
  bf16, as the JAX VJP casts them); and against the same kernels run by an
  XLA that keeps every bf16 rounding the program states.
* A bf16 ``Trainer`` step at L = 50 (``collate_batch(use_buckets=False)``,
  B = 2, full width, dropout and noise off, decode order given; the decoder
  on the gathered route, rows 7 and 8) and one with ``rbf_mode="dense"``
  (B = 2, L = 32; rows 5 and 6) against the JAX package's ``forward`` +
  ``loss_smoothed`` at bf16 with the Pallas kernels in interpret mode.

Tolerances. bf16 keeps 8 significant bits (unit roundoff 2^-8).
* Rows 5, 6 (fp32 sums of bf16 products): 1e-3 of the largest magnitude
  (the readings: 2.0e-4 forward, 5.8e-4 dW; the fp32 function lies 2.4e-3
  away). Both sides round each masked bin to bf16, but the JAX kernel
  computes ``(D - mu) * (1 / sigma)`` with its own exp, the port ``(D - mu)
  / sigma`` with PyTorch's, so a bin within an fp32 ulp of a bf16 rounding
  boundary rounds apart; one flipped bin moves a sum by 2^-8 of that one
  term.
* Rows 7, 8 (bf16 outputs): 2^-6 of the output's largest magnitude, four
  bf16 steps of the largest value, as rows 9 and 10 in
  ``test_torch_bf16_kernels.py``: the two sides round at the same points,
  but XLA on the CPU sums in other orders and its GELU uses the
  Abramowitz-Stegun erf (error 1.5e-7), so a value near a rounding boundary
  rounds to the neighbouring bf16 number on one side only and moves what it
  feeds by one bf16 step of itself. Against the reference that keeps every
  rounding: 2^-7, and 1.5 times nearer than the fp32 function in root mean
  square (``test_message_mlp_bf16_rounds_where_jax_does``).
* The steps: the loss within 1e-3 relative and each gradient leaf within
  3e-2 of its largest entry plus the JAX reference's own bf16 error on that
  leaf (against the port's fp32 gradient of the same step), the bars of
  ``test_torch_bf16_train.py``. At L = 50 the JAX training *encoder* runs
  plain-XLA bf16 layers (JAX ``mpnn.py:196-206``), whose ``jnp.dot`` on
  bf16 operands returns bf16, while the port's encoder runs rows 9 and 10 at
  bf16, which round at other points (fp32 activations between products):
  the reference's own-error term on each leaf covers that difference too.
  These bars cannot tell a bf16 step from an fp32 one: the port's fp32 step
  lies as near JAX's bf16 step as its bf16 step does, since the plain-XLA
  parts of the JAX bf16 trunk round at other points than the port and XLA
  on the CPU drops some bf16 roundings. So each step also differs from the
  port's fp32 step by more than fp32 rounding, and runs the bf16 functions
  of rows 5-8 (the recorded calls); where each rounds is held by the kernel
  tests: rows 5, 6 ten times nearer JAX than the fp32 function (rms), rows
  7, 8 against a JAX reference that keeps every bf16 rounding
  (``exact_reference``).
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import na_mpnn_tpu.ops as jax_ops
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.ops import message_kernels as jmk
from na_mpnn_tpu.ops import rbf_edge as jrbf

from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
from na_mpnn_tpu_torch.ops import message_kernels as mk
from na_mpnn_tpu_torch.ops import rbf_edge
from na_mpnn_tpu_torch.train.collate import collate_batch
from ref_oracle import make_synthetic_structure
from test_torch_bf16_kernels import _np, _r16, _rel, _t16
from test_torch_bf16_train import _jax_loss

BF = jnp.bfloat16
TOL_BF16 = 2.0 ** -6
TOL_RBF = 1e-3
H = 128


def _rms(got, want):
    """Root-mean-square distance relative to ``want``'s: a bf16 rounding
    that flips on a few elements moves it little, one that is skipped
    everywhere moves it by the rounding itself."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / (np.mean(want ** 2) + 1e-300)))


def _rbf_case(B=2, L=32, K=8, seed=0):
    """Protein and nucleic residues, absent atoms and a masked row; E = B*L*K
    = 512 edges at the defaults."""
    rng = np.random.RandomState(seed)
    X = (rng.randn(B, L, 18, 3) * 5).astype(np.float32)
    Xm = np.zeros((B, L, 18), np.float32)
    Xm[:, :L // 2, [0, 1, 2, 3, 16]] = 1
    Xm[:, L // 2:, 4:16] = 1
    Xm[:, L // 2:, 17] = 1
    Xm[:, -2:] = 0
    Xm[0, 5, 4] = 1
    E_idx = rng.randint(0, L, (B, L, K)).astype(np.int32)
    W = (rng.randn(18 * 18 * 16, H) * 0.01).astype(np.float32)
    G = rng.randn(B, L, K, H).astype(np.float32)
    return X, Xm, E_idx, W, G


@pytest.fixture(scope="module", autouse=True)
def _cpu_math_warmed_up():
    """Runs the plain dense RBF once and throws the result away. The first
    multi-threaded ``torch.sqrt`` of a process on the CPU can compute one
    thread's chunk of its tensor at low accuracy (relative errors up to
    3.2e-4 on about an eighth of the elements, in about one fresh process
    in ten; the second call is exact to its usual ulp). The bf16 bins
    amplify that past ``TOL_RBF`` (``out`` read 1.1e-3 where it reads
    2.0e-4), and whether this module holds its xdist worker's first such
    call depends on the files that ran before it."""
    X, Xm, E_idx, W, _ = _rbf_case()
    rbf_edge.rbf_edge_features(torch.from_numpy(X), torch.from_numpy(Xm),
                               torch.from_numpy(E_idx).long(),
                               torch.from_numpy(W), low=True)


def test_rbf_edge_bf16_and_its_weight_gradient_match_pallas():
    """Rows 5 and 6 at bf16: the forward and the gradient of the
    reference-order weight, against the JAX dense kernel and its custom VJP
    at bf16; no kernel launches on the CPU."""
    X, Xm, E_idx, W, G = _rbf_case()
    assert E_idx.size == 2 * jrbf.EDGE_TILE

    def jax_rbf(w):
        return jrbf.rbf_edge_features(jnp.asarray(X), jnp.asarray(Xm),
                                      jnp.asarray(E_idx), w, compute_dtype=BF,
                                      interpret=True)

    out_j = jax_rbf(jnp.asarray(W))
    dw_j = jax.grad(lambda w: jnp.sum(jax_rbf(w) * jnp.asarray(G)))(jnp.asarray(W))
    Wt = torch.from_numpy(W).requires_grad_(True)
    reset_launches()
    out = rbf_edge.rbf_edge_features(torch.from_numpy(X), torch.from_numpy(Xm),
                                     torch.from_numpy(E_idx).long(), Wt, low=True)
    dw, = torch.autograd.grad(out, Wt, torch.from_numpy(G))
    assert not any(LAUNCHES.values())
    assert out.dtype == dw.dtype == torch.float32
    assert _rel(out.detach(), out_j) < TOL_RBF
    assert _rel(dw, dw_j) < TOL_RBF
    # the bf16 function, not the fp32 one: ten times nearer JAX's bf16
    # function than the fp32 one is (rms 4e-5 against 2.1e-3, forward and dW)
    W32 = torch.from_numpy(W).requires_grad_(True)
    out32 = rbf_edge.rbf_edge_features(torch.from_numpy(X), torch.from_numpy(Xm),
                                       torch.from_numpy(E_idx).long(), W32)
    dw32, = torch.autograd.grad(out32, W32, torch.from_numpy(G))
    assert 10 * _rms(out.detach(), out_j) < _rms(out.detach(), out32.detach())
    assert 10 * _rms(dw, dw_j) < _rms(dw, dw32)
    empty = np.asarray(out_j) == 0.0
    assert empty.any() and np.all(out.detach().numpy()[empty] == 0.0)


def test_rbf_edge_bf16_query_key_rows_equal_the_structure_rows():
    """The query/key form (a shard's rows against the whole structure's key
    rows, Lq != Lk) computes the self-keyed rows it covers, in the forward
    and in the weight gradient, up to the order of the fp32 sums (through
    the autograd Function on the CPU, and with ``plain=True``)."""
    X, Xm, E_idx, W, G = _rbf_case(seed=1)
    Xt, Mt = torch.from_numpy(X), torch.from_numpy(Xm)
    Et = torch.from_numpy(E_idx).long()
    s0, Lq = 8, 16
    for plain in (False, True):
        Wt = torch.from_numpy(W).requires_grad_(True)
        full = rbf_edge.rbf_edge_features(Xt, Mt, Et, Wt, low=True, plain=plain)
        qk = rbf_edge.rbf_edge_features_qk(
            Xt[:, s0:s0 + Lq].contiguous(), Mt[:, s0:s0 + Lq].contiguous(), Xt,
            Mt, Et[:, s0:s0 + Lq].contiguous(), Wt, low=True, plain=plain)
        # the same bf16 products; the plain product sums them in another
        # order for another number of rows
        assert _rel(qk.detach(), full[:, s0:s0 + Lq].detach()) < 1e-6
        g = torch.from_numpy(G[:, s0:s0 + Lq])
        dw_qk, = torch.autograd.grad(qk, Wt, g)
        dw_full, = torch.autograd.grad(full[:, s0:s0 + Lq], Wt, g)
        # the same products, summed over the zero cotangent rows too
        assert _rel(dw_qk, dw_full) < 1e-6


FLAGS = [(False, True), (True, True), (True, False), (False, False)]
GRADS = ("g_hV", "g_ein", "g_G", "dwa", "dwb", "db1", "dw2", "db2", "dw3",
         "db3")


MLP_INPUTS = ("h_V", "e_in", "G", "mask", "wa", "wb", "b1", "w2", "b2", "w3",
              "b3")


def _mlp_case(contract_e, aggregate):
    """Rows 7, 8 inputs on bf16 values (fp32 numpy), from a seed: the
    operands, the mask, the weights and the output's cotangent ``g``."""
    rng = np.random.RandomState(7 + 2 * contract_e + aggregate)
    N, K = 64, 8

    def f(*shape, scale=0.5):
        return _r16(rng.randn(*shape) * scale)

    a = {"h_V": f(N, H), "e_in": f(N * K, H), "G": f(N * K, H),
         "wa": f(H, H, scale=1 / 16), "wb": f(H, H, scale=1 / 16), "b1": f(H),
         "w2": f(H, H, scale=1 / 16), "b2": f(H), "w3": f(H, H, scale=1 / 16),
         "b3": f(H)}
    a["mask"] = (rng.rand(N * K) > 0.2).astype(np.float32)
    a["g"] = f(N if aggregate else N * K, H)
    return a, K


def _jax_mlp(a, K, contract_e, aggregate):
    """The JAX ``_message_fwd_call`` / ``_message_bwd_call`` at bf16 in
    interpret mode -> [output, the ten backward outputs rounded to bf16]
    (fp32 numpy)."""
    rows = {"b1", "b2", "b3", "mask"}
    jargs = [jnp.asarray(a[k], BF)[:, None] if k == "mask" else
             jnp.asarray(a[k], BF)[None, :] if k in rows else jnp.asarray(a[k], BF)
             for k in MLP_INPUTS]
    out = jmk._message_fwd_call(*jargs, K, BF, contract_e, aggregate, True)
    grads = jmk._message_bwd_call(*jargs, jnp.asarray(a["g"], BF), K, BF,
                                  contract_e, aggregate, True)
    return [_np(out)] + [_np(jnp.asarray(w).astype(BF)) for w in grads]


def _port_mlp(a, K, contract_e, aggregate, dtype=torch.bfloat16):
    """The port's plain rows 7, 8 on the values of ``a`` in ``dtype`` ->
    [output, the ten backward outputs]."""
    targs = [torch.from_numpy(a[k]).to(dtype) for k in MLP_INPUTS]
    flags = dict(K=K, contract_e=contract_e, aggregate=aggregate)
    out = mk.message_mlp_plain(*targs, **flags)
    grads = mk.message_mlp_bwd_plain(*targs, torch.from_numpy(a["g"]).to(dtype),
                                     **flags)
    return [out, *grads]


@pytest.mark.parametrize("contract_e,aggregate", FLAGS,
                         ids=[f"ce{int(c)}-agg{int(a)}" for c, a in FLAGS])
def test_message_mlp_bf16_and_backward_match_pallas(contract_e, aggregate):
    """Rows 7 and 8 at bf16: every operand and weight bf16; the output and
    the ten backward outputs in bf16."""
    a, K = _mlp_case(contract_e, aggregate)
    want = _jax_mlp(a, K, contract_e, aggregate)
    got = _port_mlp(a, K, contract_e, aggregate)
    N = a["h_V"].shape[0]
    assert got[0].dtype == torch.bfloat16
    assert got[0].shape == (N if aggregate else N * K, H)
    for name, w, t in zip(("out",) + GRADS, want, got):
        assert t.dtype == torch.bfloat16, name
        assert _rel(t.float(), w.reshape(t.shape)) < TOL_BF16, name
    if not contract_e:
        assert not bool(got[5].any())


def _write_exact_reference(path):
    """``_jax_mlp`` of every flag pair into an npz (run in a process whose
    XLA keeps every bf16 rounding, ``exact_reference``)."""
    out = {}
    for ce, agg in FLAGS:
        for i, x in enumerate(_jax_mlp(*_mlp_case(ce, agg), ce, agg)):
            out[f"{int(ce)}{int(agg)}_{i}"] = x
    np.savez(path, **out)


@pytest.fixture(scope="module")
def exact_reference(tmp_path_factory):
    """The JAX rows 7, 8 of every flag pair from a process started with
    ``--xla_allow_excess_precision=false``. By default XLA on the CPU may
    keep a bf16 value in fp32 and drop a rounding the program states: in
    the aggregating backward ``g_m``, the fp32 cotangent times the bf16
    ``mask_att / 30``, reaches the products unrounded (``jax.jit(lambda g,
    m: g * (m / 30.0))`` returns ``g / 30`` for a bf16 ``m``, where eager
    mode returns ``g * bf16(1/30)``), which puts the reference as far from
    the port's bf16 version as the fp32 function lies."""
    path = tmp_path_factory.mktemp("exact_bf16") / "reference.npz"
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


@pytest.mark.parametrize("contract_e,aggregate", FLAGS,
                         ids=[f"ce{int(c)}-agg{int(a)}" for c, a in FLAGS])
def test_message_mlp_bf16_rounds_where_jax_does(exact_reference, contract_e,
                                                aggregate):
    """Rows 7 and 8 plain bf16 against the JAX kernels with every bf16
    rounding of the program kept (``exact_reference``): each output within
    2^-7 of its largest magnitude (the readings reach 5.9e-3, a bias
    gradient whose fp32 sums, taken in other orders, round to neighbouring
    bf16 numbers) and, in root mean square, at least 1.5 times nearer than
    the plain fp32 function on the same values (the readings: 1.8 times
    for that bias gradient, 5 to 80 times elsewhere), so a rounding the
    port skipped or added fails."""
    a, K = _mlp_case(contract_e, aggregate)
    got = _port_mlp(a, K, contract_e, aggregate)
    f32 = _port_mlp(a, K, contract_e, aggregate, torch.float32)
    tag = f"{int(contract_e)}{int(aggregate)}"
    for i, (name, t, t32) in enumerate(zip(("out",) + GRADS, got, f32)):
        want = exact_reference[f"{tag}_{i}"].reshape(t.shape)
        if name == "dwb" and not contract_e:
            assert not want.any() and not bool(t.any())
            continue
        assert _rel(t.float(), want) < 2.0 ** -7, name
        assert 1.5 * _rms(t.float(), want) < _rms(t.float(), t32), name


# ---------------------------------------------------------------------------
# bf16 Trainer steps against JAX
# ---------------------------------------------------------------------------

TOKENS = 6000.0
NO_NOISE = {"PROTEIN_BACKBONE_NOISE": 0, "DNA_BACKBONE_NOISE": 0,
            "RNA_BACKBONE_NOISE": 0, "DROPOUT": 0.0}


def _batch(L, B=2):
    rng = np.random.RandomState(5)
    parsed = []
    for i in range(B):
        s = make_synthetic_structure(L=L, seed=61 + i, n_protein=L // 2 - 2,
                                     n_dna=L // 4 + 1)
        parsed.append({k: v[0] for k, v in s.items()})
    b = {k: v for k, v in collate_batch(parsed, use_buckets=False).items()
         if np.asarray(v).dtype.kind in "biuf"}
    assert b["S"].shape == (B, L)
    ppm = np.zeros((B, L, 33), np.float32)
    ppm[..., 21:25] = rng.dirichlet(np.ones(4), size=(B, L))
    b["aligned_ppm"] = ppm
    b["ppm_mask"] = (b["dna_mask"] * (rng.rand(B, L) > 0.3)).astype(np.int32)
    order = np.stack([rng.permutation(L) for _ in range(B)])
    return b, order


def _port_step(pj, b, order, mixed_precision, **cfg_kw):
    """(loss, gradient leaves, the launches' plain-function calls) of one
    port ``Trainer.loss_and_grads`` on the CPU with JAX's parameters."""
    from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

    cfg = dataclasses.replace(
        model_config_from_params({**NO_NOISE, "MIXED_PRECISION": mixed_precision}),
        **cfg_kw)
    tr = Trainer(cfg, device="cpu", loss_tokens=TOKENS)
    with torch.no_grad():
        for leaf, x in zip(tr.leaves, jax.tree.leaves(pj)):
            leaf.copy_(torch.from_numpy(np.asarray(x)))
    batch = tr.device_batch(b)
    batch["decoding_order"] = torch.from_numpy(order)
    loss, grad = tr.loss_and_grads(batch)[:2]
    parts, off = [], 0
    for leaf in tr.leaves:
        parts.append(grad[off:off + leaf.numel()].numpy())
        off += leaf.numel()
    return float(loss), parts


def _counting(mod, name, calls, monkeypatch):
    """Record the calls of ``mod.name`` (a function, or a tuple of the
    autograd Function's four kernels) under their function names."""
    def wrap(fn):
        def wrapper(*a, **kw):
            calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
            return fn(*a, **kw)
        return wrapper
    obj = getattr(mod, name)
    monkeypatch.setattr(mod, name, tuple(map(wrap, obj))
                        if isinstance(obj, tuple) else wrap(obj))


def _check_against_jax(monkeypatch, L, rbf_mode, counted):
    """The port's bf16 step (with the calls of ``counted`` recorded) against
    JAX's bf16 forward + loss in interpret mode and the port's fp32 step;
    returns the recorded calls of the bf16 step."""
    b, order = _batch(L)
    cfg_j = JaxConfig(kernels="pallas", compute_dtype="bfloat16", dropout=0.0,
                      rbf_mode=rbf_mode)
    pj = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(2), cfg_j))
    monkeypatch.setattr(jax_ops, "INTERPRET", True)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: _jax_loss(cfg_j, p, b, order, False)[1])(
            jax.tree.map(jnp.asarray, pj))
    grads_j = [np.asarray(g).reshape(-1) for g in jax.tree.leaves(grads_j)]
    calls = {}
    for mod, name in counted:
        _counting(mod, name, calls, monkeypatch)
    loss, grads = _port_step(pj, b, order, 1, rbf_mode=rbf_mode)
    seen = dict(calls)
    loss32, grads32 = _port_step(pj, b, order, 0, rbf_mode=rbf_mode)
    loss_j = float(loss_j)
    assert abs(loss - loss_j) <= 1e-3 * abs(loss_j)
    assert len(grads) == len(grads_j) > 100
    for i, (g, g_j, g32) in enumerate(zip(grads, grads_j, grads32)):
        tol = 3e-2 * float(np.abs(g_j).max()) + float(np.abs(g_j - g32).max())
        assert float(np.abs(g - g_j).max()) <= tol + 1e-12, i
    # The bars above pass the port's fp32 step too (the readings: its
    # gradient lies 2.53% from JAX's bf16 one at L = 50, the bf16 step's
    # 2.48%; 0.83% and 0.68% dense, in L2). The bf16 step is not the fp32
    # one: it differs from it by more than fp32 rounding.
    assert abs(loss - loss32) > 1e-6 * abs(loss32)
    assert max(_rel(g, g32) for g, g32 in zip(grads, grads32)) > 2.0 ** -8
    return seen


def test_bf16_unbucketed_step_matches_jax(monkeypatch):
    """L = 50: the decoder's gathered route at bf16, rows 7 and 8 in every
    decoder layer."""
    seen = _check_against_jax(
        monkeypatch, 50, "classed",
        [(mk, "message_mlp_plain"), (mk, "message_mlp_bwd_plain")])
    assert seen == {"message_mlp_plain": 3, "message_mlp_bwd_plain": 3}


def test_bf16_dense_step_matches_jax(monkeypatch):
    """``rbf_mode="dense"`` at bf16: rows 5 and 6 in their bf16 function
    (one forward, one weight gradient), not the fp32 one."""
    seen = _check_against_jax(
        monkeypatch, 32, "dense",
        [(rbf_edge, "_KERNELS_BF16"), (rbf_edge, "_KERNELS")])
    assert seen == {"rbf_edge_bf16_plain": 1, "rbf_edge_dw_bf16_plain": 1}


if __name__ == "__main__":
    _write_exact_reference(sys.argv[1])
