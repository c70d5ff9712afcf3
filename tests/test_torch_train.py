"""The port's training host side on the CPU against the JAX package:
collation, the Noam-Adam optimizer, one trainer step, checkpoint
interchange, and the distributions of dropout and coordinate noise.

Tolerances: collation is exact (key by key, dtype by dtype); the optimizer
agrees with the optax chain to 1e-12 relative at float64 (the global norm is
summed in another order); one fp32 trainer step from the same parameters and
optimizer state leaves the parameters within 1e-6 relative (max norm over
the whole vector) and each leaf's update within 1e-5 of its largest entry
(fp32 gradients summed in another order); checkpoints round-trip bitwise.
The random draws of the two packages differ, so dropout and noise are
checked by their statistics, within 4 sigma."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.train import collate as jax_collate
from na_mpnn_tpu.train.checkpoint import save_checkpoint_npz as jax_save_npz
from na_mpnn_tpu.train.optimizer import make_optimizer, noam_schedule
from na_mpnn_tpu.train.trainer import Trainer as JaxTrainer

from na_mpnn_tpu_torch.models import ModelConfig
from na_mpnn_tpu_torch.models.features import augment_coordinates
from na_mpnn_tpu_torch.models.modules import dropout
from na_mpnn_tpu_torch.train import collate
from na_mpnn_tpu_torch.train.optimizer import NoamAdam
from na_mpnn_tpu_torch.train.trainer import (BATCH_KEYS, Trainer, to_device,
                                             tree_leaves)
from ref_oracle import make_synthetic_structure

SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
             dropout=0.0, compute_dtype="float32")


def _structures():
    """Two per-structure dicts of the loader contract; the second carries
    canonical base pairs and a PPM."""
    out = []
    for L, seed in ((40, 1), (52, 2)):
        b = make_synthetic_structure(L=L, seed=seed, n_protein=16, n_dna=16)
        out.append({k: v[0] for k, v in b.items()})
    s = out[1]
    L = s["S"].shape[0]
    rng = np.random.RandomState(0)
    s["canonical_base_pair_mask"] = (s["dna_mask"] * (rng.rand(L) > 0.5)).astype(np.int32)
    s["canonical_base_pair_index"] = rng.permutation(L).astype(np.int64)
    s["ppm_mask"] = (s["dna_mask"] * (rng.rand(L) > 0.3)).astype(np.int32)
    ppm = np.zeros((L, 33))
    ppm[:, 21:25] = rng.dirichlet(np.ones(4), size=L)
    s["aligned_ppm"] = ppm
    return out


def test_collate_matches_jax():
    structs = _structures()
    for kw in ({}, {"pad_to": 80, "pad_batch_to": 3}, {"use_buckets": False}):
        got = collate.collate_batch(structs, **kw)
        want = jax_collate.collate_batch(structs, **kw)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
        assert collate.repad_length(got, 128)["S"].tolist() == \
            jax_collate.repad_length(want, 128)["S"].tolist()
    for n in (1, 63, 64, 65, 700, 768, 769, 6144, 7000):
        assert collate.bucket_length(n) == jax_collate.bucket_length(n)
        assert collate.bucket_batch(n) == jax_collate.bucket_batch(n)
    assert collate.collate_batch([]) is None


def test_dropout_statistics():
    n, rate = 400_000, 0.2
    x = torch.full((n,), 3.0, dtype=torch.float64)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    keep = 1.0 - rate
    sigma = (keep * rate / n) ** 0.5
    assert abs(float(kept.double().mean()) - keep) < 4 * sigma
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 3.0 / keep,
                                           dtype=torch.float64))
    assert dropout(x, 0.0, torch.Generator()) is x
    assert dropout(x, rate, None) is x
    masks = [dropout(x, rate, torch.Generator().manual_seed(s)) != 0
             for s in (5, 5, 6)]
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])


def test_coordinate_noise_statistics():
    """Per-polymer Gaussian noise of the configured width on present atoms,
    none on absent atoms."""
    b = make_synthetic_structure(L=400, seed=4, n_protein=200, n_dna=120)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    bt["X"] = bt["X"].double()
    cfg = ModelConfig(protein_augment_eps=0.1, dna_augment_eps=0.2,
                      rna_augment_eps=0.3)
    d = augment_coordinates(bt["X"], bt["X_m"], bt, cfg,
                            torch.Generator().manual_seed(1)) - bt["X"]
    present = bt["X_m"].bool()
    assert float(d[~present].abs().max()) == 0.0
    for key, eps in (("protein_mask", 0.1), ("dna_mask", 0.2),
                     ("rna_mask", 0.3)):
        sel = present & bt[key].bool()[..., None]
        v = d[sel]                                     # [n, 3]
        n = v.numel()
        std = float(v.std())
        # the sample standard deviation of n normal draws: sigma / sqrt(2n)
        assert abs(std - eps) < 4 * eps / (2 * n) ** 0.5, (key, std)


def test_optimizer_matches_optax_float64():
    P = 1000
    rng = np.random.RandomState(0)
    grads = [rng.randn(P) * 0.01, rng.randn(P) * 0.2, rng.randn(P) * 0.01]
    assert np.linalg.norm(grads[1]) > 1.0 > np.linalg.norm(grads[0])
    port = NoamAdam(128, grad_clip_norm=1.0)
    state_t = port.init(torch.zeros(P, dtype=torch.float64))
    with jax.enable_x64(True):
        opt = make_optimizer(128, grad_clip_norm=1.0)
        state_j = opt.init(jnp.zeros(P, jnp.float64))
        for g in grads:
            u_j, state_j = opt.update(jnp.asarray(g), state_j)
            u_t = port.update(torch.from_numpy(g), state_t)
            np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j),
                                       rtol=1e-12, atol=0)
            leaves = jax.tree.leaves(state_j)
            assert int(leaves[0]) == state_t.count
            assert int(leaves[3]) == state_t.schedule_count
            np.testing.assert_allclose(state_t.mu.numpy(), leaves[1],
                                       rtol=1e-12, atol=0)
            np.testing.assert_allclose(state_t.nu.numpy(), leaves[2],
                                       rtol=1e-12, atol=0)
        sched = noam_schedule(128)
        for c in (0, 1, 2, 3, 100, 3999, 4000, 4001, 100_000):
            assert port.learning_rate(c) == float(sched(jnp.asarray(c, jnp.int32)))


def _trainer_pair(tmp_path):
    """A port and a JAX trainer holding the same parameters and a
    non-trivial optimizer state (count 3999, near the top of the warmup),
    through the port's checkpoint."""
    tr = Trainer(ModelConfig(**SMALL), loss_tokens=100.0, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    P = tr.flat.numel()
    tr.opt_state.mu.copy_(torch.from_numpy(rng.randn(P).astype(np.float32) * 1e-3))
    tr.opt_state.nu.copy_(torch.from_numpy(
        rng.uniform(1e-6, 1e-5, P).astype(np.float32)))
    tr.opt_state.count = tr.opt_state.schedule_count = 3999
    path = str(tmp_path / "start.npz")
    tr.save(path, epoch=0, save_step=0)
    jt = JaxTrainer(JaxConfig(kernels="xla", **SMALL), loss_tokens=100.0, seed=1)
    jt.restore(path)
    return tr, jt


def test_trainer_step_matches_jax(tmp_path):
    tr, jt = _trainer_pair(tmp_path)
    nb = collate.collate_batch(_structures())
    B, L = nb["S"].shape
    rng = np.random.RandomState(2)
    order = np.stack([rng.permutation(L) for _ in range(B)])
    batch_j = {k: jnp.asarray(nb[k]) for k in BATCH_KEYS}
    batch_j["decoding_order"] = jnp.asarray(order)
    params_j, opt_j, m_j = jax.jit(jt._train_step_impl)(
        jt.params, jt.opt_state, batch_j, jax.random.PRNGKey(0))
    batch_t = to_device(nb, "cpu")
    batch_t["decoding_order"] = torch.from_numpy(order)
    m_t = tr._train_step_impl(batch_t, None)

    loss_j = float(m_j["loss_av"])
    assert abs(float(m_t["loss_av"]) - loss_j) < 1e-6 * abs(loss_j)
    flat_j = np.concatenate([np.asarray(p).reshape(-1)
                             for p in jax.tree.leaves(params_j)])
    flat_0 = np.concatenate([np.asarray(p).reshape(-1)
                             for p in jax.tree.leaves(jt.params)])
    flat_t = tr.flat.numpy()
    assert np.abs(flat_t - flat_j).max() <= 1e-6 * np.abs(flat_j).max()
    # each leaf's update to 1e-5 of its largest entry (a zero-initialised
    # bias after one step is its update, as accurate as its fp32 gradient),
    # plus the two fp32 rounding units of the stored parameters
    offsets = np.cumsum([0] + [p.numel() for p in tree_leaves(tr.params)])
    ulp = np.finfo(np.float32).eps
    for a, b in zip(offsets[:-1], offsets[1:]):
        d_j, d_t = flat_j[a:b] - flat_0[a:b], flat_t[a:b] - flat_0[a:b]
        tol = 1e-5 * np.abs(d_j).max() + 2 * ulp * np.abs(flat_j[a:b]).max()
        assert np.abs(d_t - d_j).max() <= tol, (a, b)
    assert np.abs(flat_j - flat_0).max() > 1e-4  # a step that shows a fault
    leaves_j = jax.tree.leaves(opt_j)
    assert int(leaves_j[0]) == tr.opt_state.count == 4000
    np.testing.assert_allclose(tr.opt_state.mu.numpy(), leaves_j[1],
                               atol=1e-6 * float(np.abs(leaves_j[1]).max()))
    np.testing.assert_array_equal(m_t["S_pred"].numpy(), np.asarray(m_j["S_pred"]))


def test_train_steps_follow_the_generator():
    """With dropout 0.1 and 0.1 A noise, two trainers that start alike and
    draw from generators of one seed take identical steps; another seed
    takes other steps."""
    nb = collate.collate_batch(_structures())
    cfg = ModelConfig(**{**SMALL, "dropout": 0.1, "protein_augment_eps": 0.1,
                         "dna_augment_eps": 0.1, "rna_augment_eps": 0.1})

    def run(seed):
        tr = Trainer(cfg, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        losses = [float(tr.train_step(nb, gen)["loss_av"]) for _ in range(2)]
        return losses, tr.flat.clone()

    (la, fa), (lb, fb), (lc, fc) = run(3), run(3), run(4)
    assert la == lb and torch.equal(fa, fb)
    assert la[0] != lc[0] and not torch.equal(fa, fc)


def _opt_leaves(tr):
    s = tr.opt_state
    return [np.asarray(s.count), s.mu.numpy(), s.nu.numpy(),
            np.asarray(s.schedule_count)]


def test_checkpoint_interchange(tmp_path):
    """port save -> JAX restore -> JAX save -> port restore, bitwise; and
    the legacy per-leaf optimizer layout, read by both."""
    tr, jt = _trainer_pair(tmp_path)
    want_params = [p.detach().numpy().copy() for p in tree_leaves(tr.params)]
    want_opt = [np.array(v) for v in _opt_leaves(tr)]
    for got, want in zip(jax.tree.leaves(jt.params), want_params):
        np.testing.assert_array_equal(np.asarray(got), want)
    for got, want in zip(jax.tree.leaves(jt.opt_state), want_opt):
        np.testing.assert_array_equal(np.asarray(got), want)

    jt.step = 11
    path = str(tmp_path / "jax.npz")
    jt.save(path, epoch=3, save_step=10)
    tr2 = Trainer(ModelConfig(**SMALL), seed=7, device="cpu")
    meta = tr2.restore(path)
    assert tr2.step == 11 and meta["epoch"] == 3 and meta["save_step"] == 10
    for got, want in zip(tree_leaves(tr2.params), want_params):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    for got, want in zip(_opt_leaves(tr2), want_opt):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype

    # legacy layout: (count, mu of every leaf, nu of every leaf, count)
    shapes = [w.shape for w in want_params]
    split = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]
    mus = [m.reshape(s) for m, s in zip(np.split(want_opt[1], split), shapes)]
    nus = [m.reshape(s) for m, s in zip(np.split(want_opt[2], split), shapes)]
    legacy = {f"leaf{i:04d}": v for i, v in enumerate(
        [np.asarray(5, np.int32), *mus, *nus, np.asarray(5, np.int32)])}
    path = str(tmp_path / "legacy.npz")
    jax_save_npz(path, jax.tree.map(np.asarray, jt.params), meta={"step": 5},
                 opt_state_flat=legacy)
    tr3 = Trainer(ModelConfig(**SMALL), seed=8, device="cpu")
    tr3.restore(path)
    jt.restore(path)
    for got, want in zip(_opt_leaves(tr3), jax.tree.leaves(jt.opt_state)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(tr3.opt_state.mu.numpy(), want_opt[1])
    assert tr3.opt_state.count == 5


def test_trainer_refuses_a_checkpoint_of_another_shape(tmp_path):
    tr = Trainer(ModelConfig(**SMALL), seed=0, device="cpu")
    path = str(tmp_path / "a.npz")
    tr.save(path, epoch=0, save_step=0)
    other = Trainer(ModelConfig(**{**SMALL, "hidden_dim": 64,
                                   "node_features": 64,
                                   "edge_features": 64}), seed=0, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        other.restore(path)
