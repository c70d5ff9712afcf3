"""The bf16 trunk (``MIXED_PRECISION: 1``, the JAX training default) of the
one-device training path on the CPU.

* One ``Trainer`` step at the released width (H=128, K=32, 3+3 layers; B=2,
  L=32, so the JAX trunk takes its message-table kernels) against the JAX
  package's ``forward`` + ``loss_smoothed`` at bf16 with the Pallas kernels
  in interpret mode. Dropout and noise are off and the decode order is
  given. The loss within 1e-3 relative: it averages per-token errors of
  order bf16's unit roundoff (2^-8) that differ in sign. Each gradient leaf
  within 3e-2 of its largest entry (the bar the JAX package sets its own
  bf16 path against the dense fp32 one, ``test_message_kernels.py:58``)
  plus the JAX reference's own bf16 error on that leaf, measured against
  the fp32 gradient of the same step: the JAX VJP sums some bias gradients
  in bf16 (the positional bias, broadcast over every edge, comes out tens
  of percent off the fp32 gradient), the port sums them in fp32 and rounds
  once.
* The same bf16 step against the port's own fp32 step: loss within 1e-3
  relative, each gradient leaf within 3e-2 of its largest entry.
* One ``eval_step`` at bf16 against JAX's evaluation forward: the port takes
  its fused route (rows 11, 12), JAX its table route (row 9), so the
  comparison crosses routes; the loss per token within 3e-2 absolute (bf16
  logits of order 1, through 6 layers of LayerNorm-bounded activations).
* ``run_training`` from a config without ``MIXED_PRECISION`` trains the
  bf16 trunk, writes its fp32 ``.npz`` and resumes.
* The options that once refused, ``remat`` and the graph-parallel chunks,
  run in a bf16 ``Trainer`` and leave the one-device forward as it is.
* The bf16 combinations that run since the rest of the bf16 trunk was
  ported, one step each at a tiny width: the dense RBF, a one-rank mesh
  ``Trainer``, and the gathered decoder route (L = 40) whose ``eval_step``
  still takes the fused route. Their parity with JAX is held in
  ``test_torch_bf16_rows5to8.py`` and ``test_torch_bf16_mesh.py``.
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import na_mpnn_tpu.ops as jax_ops
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import forward as jax_forward
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.train import losses as jax_losses

from na_mpnn_tpu_torch.models import (forward, init_params, sample, score,
                                      unconditional_probs)
from na_mpnn_tpu_torch.ops import fused_layers as fl
from na_mpnn_tpu_torch.train.collate import collate_batch
from na_mpnn_tpu_torch.train.trainer import (Trainer, model_config_from_params,
                                             run_training)
from ref_oracle import make_synthetic_structure

B, L = 2, 32
TOKENS = 6000.0
NO_NOISE = {"PROTEIN_BACKBONE_NOISE": 0, "DNA_BACKBONE_NOISE": 0,
            "RNA_BACKBONE_NOISE": 0, "DROPOUT": 0.0}


def _batch():
    rng = np.random.RandomState(5)
    parts = [make_synthetic_structure(L=L, seed=51 + i, n_protein=L // 2,
                                      n_dna=L // 4) for i in range(B)]
    b = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    ppm = np.zeros((B, L, 33), np.float32)
    ppm[..., 21:25] = rng.dirichlet(np.ones(4), size=(B, L))
    b["aligned_ppm"] = ppm
    b["ppm_mask"] = (b["dna_mask"] * (rng.rand(B, L) > 0.3)).astype(np.int32)
    b["canonical_base_pair_mask"] = np.zeros((B, L), np.int32)
    b["canonical_base_pair_index"] = np.tile(np.arange(L), (B, 1))
    order = np.stack([rng.permutation(L) for _ in range(B)])
    return b, order


def _jax_loss(cfg_j, params, b, order, deterministic):
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bj["decoding_order"] = jnp.asarray(order)
    lp, _ = jax_forward(params, cfg_j, bj, deterministic=deterministic)
    mfl = jax_losses.mask_for_loss(bj["S"], bj["mask"]).astype(lp.dtype)
    pm = {k: bj[f"{k}_mask"] for k in ("protein", "dna", "rna")}
    return jax_losses.loss_smoothed(
        bj["S"], lp, mfl, pm, jax_losses.make_polymer_restype_masks(True),
        weight=0.1, tokens=TOKENS, num_letters=33, ppm_mask=bj["ppm_mask"],
        aligned_ppm=bj["aligned_ppm"])


def _trainer(pj, mixed_precision):
    cfg = model_config_from_params({**NO_NOISE, "MIXED_PRECISION": mixed_precision}
                                   if mixed_precision is not None else NO_NOISE)
    tr = Trainer(cfg, device="cpu", loss_tokens=TOKENS)
    with torch.no_grad():
        for leaf, a in zip(tr.leaves, jax.tree.leaves(pj)):
            leaf.copy_(torch.from_numpy(np.asarray(a)))
    return tr


@pytest.fixture(scope="module")
def step():
    """JAX's bf16 loss and gradients (Pallas, interpret mode) and the port's
    bf16 (the default config) and fp32 Trainer gradients from the same
    parameters, batch and decode order."""
    b, order = _batch()
    cfg_j = JaxConfig(kernels="pallas", compute_dtype="bfloat16", dropout=0.0)
    pj = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(2), cfg_j))
    before = jax_ops.INTERPRET
    jax_ops.INTERPRET = True
    try:
        loss_j, grads_j = jax.value_and_grad(
            lambda p: _jax_loss(cfg_j, p, b, order, False)[1])(
                jax.tree.map(jnp.asarray, pj))
        lpt_j = _jax_loss(cfg_j, jax.tree.map(jnp.asarray, pj), b, order, True)[0]
    finally:
        jax_ops.INTERPRET = before
    out = {"jax": (float(loss_j), [np.asarray(g).reshape(-1)
                                    for g in jax.tree.leaves(grads_j)]),
           "jax_eval": np.asarray(lpt_j), "pj": pj, "b": b, "order": order}
    for tag, mp in (("bf16", None), ("fp32", 0)):
        tr = _trainer(pj, mp)
        batch = tr.device_batch(b)
        batch["decoding_order"] = torch.from_numpy(order)
        loss, grad = tr.loss_and_grads(batch)[:2]
        assert grad.dtype == torch.float32 and grad.shape == tr.flat.shape
        parts, off = [], 0
        for leaf in tr.leaves:
            parts.append(grad[off:off + leaf.numel()].numpy())
            off += leaf.numel()
        out[tag] = (float(loss), parts)
        out[tag + "_trainer"] = tr
    return out


def test_default_config_is_the_bf16_trunk():
    assert model_config_from_params({}).compute_dtype == "bfloat16"
    assert model_config_from_params({"MIXED_PRECISION": 0}).compute_dtype == "float32"


def test_bf16_train_step_matches_jax_pallas(step):
    loss_j, grads_j = step["jax"]
    loss, grads = step["bf16"]
    _, grads32 = step["fp32"]
    assert abs(loss - loss_j) <= 1e-3 * abs(loss_j)
    assert len(grads) == len(grads_j) > 100
    for i, (g, g_j, g32) in enumerate(zip(grads, grads_j, grads32)):
        tol = 3e-2 * float(np.abs(g_j).max()) + float(np.abs(g_j - g32).max())
        assert float(np.abs(g - g_j).max()) <= tol + 1e-12, i


def test_bf16_train_step_near_fp32(step):
    loss, grads = step["bf16"]
    loss32, grads32 = step["fp32"]
    assert loss != loss32
    assert abs(loss - loss32) <= 1e-3 * abs(loss32)
    for i, (g, g32) in enumerate(zip(grads, grads32)):
        assert float(np.abs(g - g32).max()) <= 3e-2 * float(np.abs(g32).max()) + 1e-12, i


def test_bf16_eval_step_matches_jax(step, monkeypatch):
    calls = []
    for name in ("fused_node_update", "fused_edge_update"):
        fn = getattr(fl, name)
        monkeypatch.setattr(fl, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    tr = step["bf16_trainer"]
    batch = tr.device_batch(step["b"])
    batch["decoding_order"] = torch.from_numpy(step["order"])
    m = tr._eval_step_impl(batch)
    assert calls.count("fused_node_update") == 6 and calls.count("fused_edge_update") == 3
    lpt = m["loss_per_token"].numpy()
    assert lpt.dtype == np.float32 and lpt.shape == (B, L)
    np.testing.assert_allclose(lpt, step["jax_eval"], atol=3e-2, rtol=0)


def test_run_training_defaults_to_bf16_and_resumes(tmp_path):
    csv_path = chip_smoke.write_training_set(str(tmp_path / "ds"), [
        (("A", "protein", 14 + 3 * i), ("B", "dna", 8), ("C", "dna", 8))
        for i in range(3)], seed=4)
    cfg = chip_smoke.training_config(
        csv_path, str(tmp_path / "run"), HIDDEN_DIM=32, NUM_NEIGHBORS=8,
        NUM_ENCODER_LAYERS=1, NUM_DECODER_LAYERS=1, BATCH_TOKENS=100,
        LOSS_TOKENS=100)
    del cfg["MIXED_PRECISION"]
    first = run_training(cfg, max_epochs=1, device="cpu")
    assert first.cfg.compute_dtype == "bfloat16" and first.step > 0
    last = str(tmp_path / "run" / "last.npz")
    with np.load(last) as z:
        assert all(z[k].dtype == np.float32 for k in z.files
                   if np.issubdtype(z[k].dtype, np.floating))
    resumed = run_training({**cfg, "PREV_CHECKPOINT": last}, max_epochs=1,
                           device="cpu")
    assert resumed.step > first.step
    with open(tmp_path / "run" / "log.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in logs)


TINY = dict(hidden_dim=32, node_features=32, edge_features=32, k_neighbors=8,
            num_encoder_layers=1, num_decoder_layers=1)


def _tiny(**kw):
    return dataclasses.replace(model_config_from_params({}), **TINY, **kw)


def test_inference_entry_points_run_a_bf16_trunk():
    """As in the JAX package, score, unconditional probs and the sampler
    take a bf16 encoder and decoder trunk and fp32 logits (the sampler's
    decode steps in fp32 from the bf16 encoder's outputs): log-probs within
    3e-2 of the fp32 model's (two bf16 layers at H = 32)."""
    b = make_synthetic_structure(L=40, seed=3, n_protein=20, n_dna=10)
    b["chain_mask"] = np.ones_like(b["mask"])
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    params = init_params(0, _tiny(), device="cpu")
    order = torch.from_numpy(np.random.RandomState(0).permutation(40)[None])
    out = {}
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(_tiny(), compute_dtype=dt)
        out[dt] = (score(params, cfg, bt, decoding_order=order)["log_probs"],
                   unconditional_probs(params, cfg, bt)["log_probs"])
        s = sample(params, cfg, bt, torch.Generator().manual_seed(0), num_samples=2)
        assert s["S"].shape == (2, 40) and bool(torch.isfinite(s["log_probs"]).all())
    for a, b32 in zip(out["bfloat16"], out["float32"]):
        assert a.dtype == torch.float32
        assert float((a - b32).abs().max()) < 3e-2


@pytest.mark.parametrize("kw", [dict(remat="full"), dict(gp_knn_key_chunk=64),
                                dict(gp_rbf_row_chunk=64)],
                         ids=["remat", "knn_key_chunk", "rbf_row_chunk"])
def test_unported_options_refuse(kw):
    """The three options these cases once saw refused now run (the name is
    kept): a bf16 ``Trainer`` takes them, and its training forward with
    dropout gives bitwise the log-probs of the default config from the same
    generator seed. ``remat`` changes only what the backward recomputes
    (``test_torch_remat.py`` holds its gradients), and the one-device
    forward does not read the graph-parallel chunks (nor does JAX's;
    ``test_torch_gp_sampler.py`` holds them on meshes)."""
    cfg = _tiny(**kw)
    Trainer(cfg, device="cpu")
    b = make_synthetic_structure(L=32, seed=1, n_protein=16, n_dna=8)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    params = init_params(0, cfg, device="cpu")
    got, want = (forward(params, c, bt, torch.Generator().manual_seed(3))[0]
                 for c in (cfg, _tiny()))
    assert torch.isfinite(got).all() and torch.equal(got, want)


def _unbucketed(L=40):
    parsed = [{k: v[0] for k, v in make_synthetic_structure(
        L=L, seed=s, n_protein=20, n_dna=10).items()} for s in (1, 2)]
    nb = collate_batch(parsed, use_buckets=False)
    assert nb["S"].shape == (2, L)
    return nb


def _moved(tr, nb, generator=None):
    """One train step's loss, checked finite, and that it moved the
    parameters."""
    flat0 = tr.flat.clone()
    loss = float(tr.train_step(nb, generator)["loss_av"])
    assert np.isfinite(loss) and not torch.equal(tr.flat, flat0)
    assert bool(torch.isfinite(tr.flat).all())
    return loss


def test_bf16_dense_rbf_trains_a_step():
    """``rbf_mode="dense"`` at bf16: the bf16 dense RBF and its weight
    gradient (plain versions on the CPU), not the fp32 ones."""
    from na_mpnn_tpu_torch.ops import rbf_edge

    calls = []
    tr = Trainer(_tiny(rbf_mode="dense"), device="cpu")
    before = tuple(rbf_edge._KERNELS_BF16)
    try:
        rbf_edge._KERNELS_BF16 = tuple(
            (lambda *a, _f=f, **k: calls.append(_f.__name__) or _f(*a, **k))
            for f in before)
        _moved(tr, _unbucketed(32), torch.Generator().manual_seed(0))
    finally:
        rbf_edge._KERNELS_BF16 = before
    assert calls == ["rbf_edge_bf16_plain", "rbf_edge_dw_bf16_plain"]


def test_bf16_mesh_trainer_runs_a_step(tmp_path):
    """``Trainer(mesh=(1,1))`` at bf16 (the G = 1 policy: the whole bf16
    trunk) runs one step; the parameters stay fp32."""
    import torch.distributed as dist

    from na_mpnn_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    initialize_distributed(1, 0, "cpu", init_file=str(tmp_path / "store"))
    try:
        tr = Trainer(_tiny(), mesh=make_mesh(1, 1, "cpu"))
        _moved(tr, _unbucketed(64))
        assert tr.flat.dtype == torch.float32
    finally:
        dist.destroy_process_group()


def test_bf16_unbucketed_batch_trains_and_evaluates():
    """At L % 32 != 0 a bf16 training step takes the gathered decoder route
    (rows 7, 8 at bf16: the plain versions see bf16 operands), with and
    without a generator; evaluation at that L takes the fused route."""
    from na_mpnn_tpu_torch.ops import message_kernels as mk

    seen = []
    fn = mk.message_mlp_plain
    nb = _unbucketed()
    tr = Trainer(_tiny(), device="cpu")
    try:
        mk.message_mlp_plain = lambda *a, **k: seen.append(a[0].dtype) or fn(*a, **k)
        _moved(tr, nb, torch.Generator().manual_seed(0))
        _moved(tr, nb)
    finally:
        mk.message_mlp_plain = fn
    assert seen == [torch.bfloat16] * 2
    calls = []
    fused = fl.fused_node_update
    try:
        fl.fused_node_update = lambda *a, **k: calls.append(a[0]) or fused(*a, **k)
        m = tr.eval_step(nb)
    finally:
        fl.fused_node_update = fused
    assert calls == ["enc", "dec"]
    assert bool(torch.isfinite(m["loss_per_token"]).all())
