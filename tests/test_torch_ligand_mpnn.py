"""LigandMPNN in the port (``models/ligand.py``) against the plain
reference written from the published code (``port_bench/reference/
ligand_model.py``, ``ligand_train.py``), on seeded random weights in
LigandMPNN's own state-dict layout, at the published widths (H = 128, K =
32, 3 + 3 layers, 25 context atoms, 2 context layers) and a small size:
two structures of 40 and 36 residues with 30 and 22 context atoms (fewer
than 25: absent slots), on the CPU in float32.

Tolerances: the two implementations sum in different orders (the port
splits ``W1`` by rows and broadcasts the receiving row's product; the
trunk runs its layers' plain kernels), so float32 rounding alone separates
them: here by 3e-6 in ``h_V`` and ``h_E``, 4e-6 in log-probabilities,
5e-7 of a leaf's gradient norm and 8e-8 of the loss. Each limit is about
7-25x that; the log-probability limit is 400x under the 4e-2 that a bf16
context encoder gives at fp32 inference
(``test_bf16_context_fails_the_tolerance``).
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from na_mpnn_tpu_torch.models import ligand as PL
from na_mpnn_tpu_torch.models import mpnn
from na_mpnn_tpu_torch.models.config import ligand_config
from na_mpnn_tpu_torch.models.features import features_from_coords
from na_mpnn_tpu_torch.params import (from_jax_params, from_torch_state_dict,
                                      load_params_any, to_torch_state_dict)
from na_mpnn_tpu_torch.train.collate import collate_batch
from na_mpnn_tpu_torch.train.trainer import Trainer, to_device, tree_leaves
from port_bench import weights_ligand
from port_bench.reference import ligand_model as LM
from port_bench.reference import ligand_train as LT
from port_bench.reference import model as RM

FEATURE_TOL = 2e-5      # features, h_V, h_E: float32 rounding gives 3e-6
LOGP_TOL = 1e-4         # log-probabilities: rounding 4e-6; a bf16 context 4e-2
GRAD_TOL = 1e-5         # a leaf's gradient gap over its norm (or the median's): 5e-7

CFG = {"HIDDEN_DIM": 128, "NUM_RBF": 16, "NUM_POSITIONAL_EMBEDDINGS": 16,
       "MAX_RELATIVE_FEATURE": 32, "VOCAB_SIZE": 21, "NUM_LETTERS": 21,
       "NUM_ENCODER_LAYERS": 3, "NUM_DECODER_LAYERS": 3, "NUM_CONTEXT_LAYERS": 2,
       "NUM_NEIGHBORS": 32, "ATOM_CONTEXT_NUM": 25, "DROPOUT": 0.1,
       "PROTEIN_BACKBONE_NOISE": 0.1, "LABEL_SMOOTHING": 0.1, "LOSS_TOKENS": 6000,
       "GRADIENT_NORM": 1.0}


def _cfg(**kw):
    return ligand_config(k_neighbors=32, kernels="torch", **kw)


def _structure(rng, L, n_atoms):
    """A protein chain of ``L`` residues on a random walk of 3.8 A steps
    (N, CA, C, O about each centre) and ``n_atoms`` context atoms of mixed
    elements near its residues; two atoms share one position (a tie)."""
    steps = rng.standard_normal((L, 3))
    c = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=1, keepdims=True), 0)
    X = np.zeros((L, 16, 3), np.float32)
    X_m = np.zeros((L, 16), np.int32)
    X[:, :4] = c[:, None] + rng.standard_normal((L, 4, 3)) * 1.2
    X_m[:, :4] = 1
    Y = (c[rng.integers(0, L, n_atoms)] + rng.standard_normal((n_atoms, 3)) * 4).astype(np.float32)
    Y[1] = Y[0]
    Y_t = rng.choice([6, 7, 8, 15, 16, 17, 30, 26, 53], n_atoms).astype(np.int32)
    return {"X": X, "X_m": X_m, "S": rng.integers(0, 20, L), "mask": np.ones(L, np.int32),
            "R_idx": np.arange(1, L + 1, dtype=np.int32),
            "chain_labels": (np.arange(L) >= L // 2).astype(np.int64),
            "protein_mask": np.ones(L, np.int32), "dna_mask": np.zeros(L, np.int32),
            "rna_mask": np.zeros(L, np.int32), "R_polymer_type": np.zeros(L, np.int64),
            "Y": Y, "Y_t": Y_t, "Y_m": np.ones(n_atoms, np.int32)}


def make_case():
    rng = np.random.default_rng(11)
    raw = [_structure(rng, 40, 30), _structure(rng, 36, 22)]
    np_batch = collate_batch(raw, pad_token=PL.UNKNOWN)
    batch = to_device(np_batch, "cpu")
    batch["chain_mask"] = batch["mask"]
    ref = LT.pad(raw, np_batch["S"].shape[1], "cpu")
    sd = weights_ligand.make(CFG, 3, "cpu")
    params = from_jax_params(from_torch_state_dict(sd, _cfg()), device="cpu")
    return {"raw": raw, "np_batch": np_batch, "batch": batch, "ref": ref, "sd": sd,
            "params": params}


@pytest.fixture(scope="module")
def case():
    return make_case()


def _real(x, mask):
    return x[mask > 0]


def test_nearest_atoms_and_ties(case):
    """The selection, its order and its ties (two atoms at one place: the
    lower index first; a residue with fewer atoms than slots), the masked
    padding rows and atoms included, bitwise against the reference."""
    b, ref = case["batch"], case["ref"]
    got = PL.nearest_atoms(b["X"], b["mask"].float(), b["Y"], b["Y_t"], b["Y_m"], 25)
    want = LM.nearest_atoms(ref["X"], ref["mask"].float(), ref["Y"], ref["Y_t"], ref["Y_m"])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].long(), want[1])
    assert torch.equal(got[2].float(), want[2])
    # the second structure has 22 atoms: three slots absent on every row
    assert int(got[2][1, :36].sum(-1).max()) == 22
    # the tied pair: wherever atom 0 is taken, atom 1 (same place) follows it
    Y0 = b["Y"][0, 0]
    for row in got[0][0, :40]:
        hits = torch.nonzero((row == Y0).all(-1))[:, 0]
        if hits.numel():
            assert hits.numel() == 2 and int(hits[1]) == int(hits[0]) + 1
    # distances sorted, ties by index: the reference's order is the selection's
    d = ((PL.virtual_cb(b["X"])[:, :, None] - got[0]) ** 2).sum(-1)
    real = (got[2] > 0) & (b["mask"][..., None] > 0)
    assert bool(((d[..., 1:] >= d[..., :-1]) | ~real[..., 1:]).all())


def test_context_features(case):
    """V (``node_project_down``), the atoms' nodes and the atom-graph
    edges, and the trunk's edges on the 18-slot frame with the 25 pairs'
    rows scattered into it, against ``ProteinFeaturesLigand``."""
    cfg, p, b, ref = _cfg(), case["params"], case["batch"], case["ref"]
    mask = b["mask"].float()
    Y, Y_t, Y_m = PL.nearest_atoms(b["X"], mask, b["Y"], b["Y_t"], b["Y_m"], 25)
    V, Y_nodes, Y_edges = PL.context_features(p["context"], cfg, b["X"], Y, Y_t)
    _, E, E_idx, _ = features_from_coords(PL.trunk_features(p, cfg), cfg, b, b["X"],
                                          plain=True)
    rY, rt, rm = LM.nearest_atoms(ref["X"], ref["mask"], ref["Y"], ref["Y_t"], ref["Y_m"])
    with torch.no_grad():
        rV, rE, rE_idx, rYn, rYe, _ = LM.features(case["sd"], ref, 32, RM.Precision(),
                                                  Y=rY, Y_t=rt, Y_m=rm)
    assert torch.equal(E_idx[mask > 0], rE_idx[mask > 0])
    for a, w in ((V, rV), (Y_nodes, rYn), (Y_edges, rYe), (E, rE)):
        assert float((_real(a, mask) - _real(w, mask)).abs().max()) < FEATURE_TOL


def test_encode_h_V(case):
    cfg = _cfg(dropout=0.0)
    with torch.no_grad():
        h_V, h_E, _ = mpnn.encode(case["params"], cfg, case["batch"])
        ref = case["ref"]
        rY = LM.nearest_atoms(ref["X"], ref["mask"], ref["Y"], ref["Y_t"], ref["Y_m"])
        r_V, r_E, _ = LM.encode(case["sd"], ref, 32, RM.Precision(), Y=rY[0], Y_t=rY[1],
                                Y_m=rY[2])
    mask = case["batch"]["mask"]
    assert float((_real(h_V, mask) - _real(r_V, mask)).abs().max()) < FEATURE_TOL
    assert float((_real(h_E, mask) - _real(r_E, mask)).abs().max()) < FEATURE_TOL


def _order(mask, seed):
    g = torch.Generator().manual_seed(seed)
    return mpnn.sample_decoding_order(mask.float(), g)


def test_score_and_unconditional(case):
    cfg, b, ref = _cfg(dropout=0.0), case["batch"], case["ref"]
    order = _order(b["mask"], 5)
    got = mpnn.score(case["params"], cfg, b, decoding_order=order)["log_probs"]
    unc = mpnn.unconditional_probs(case["params"], cfg, b)["log_probs"]
    with torch.no_grad():
        want = LM.log_probs(case["sd"], ref, 32, RM.Precision(), ref["S"].long(), order)
        want_unc = LM.log_probs(case["sd"], ref, 32, RM.Precision(), None, order)
    mask = b["mask"]
    assert float((_real(got, mask) - _real(want, mask)).abs().max()) < LOGP_TOL
    assert float((_real(unc, mask) - _real(want_unc, mask)).abs().max()) < LOGP_TOL


def test_sampler_log_probs_along_its_tokens(case):
    """The sampler's log-probabilities at each position, given the tokens
    it drew before it in its own order, against the reference's teacher-
    forced decoder on those tokens and that order; X is never drawn."""
    cfg = _cfg(dropout=0.0)
    one = {k: v[:1] for k, v in case["batch"].items()}
    out = mpnn.sample(case["params"], cfg, one, torch.Generator().manual_seed(9),
                      num_samples=3, temperature=1.0)
    ref1 = {k: v[:1] for k, v in case["ref"].items()}
    assert int((out["S"][:, :40] == PL.UNKNOWN).sum()) == 0
    for r in range(3):
        with torch.no_grad():
            want = LM.log_probs(case["sd"], ref1, 32, RM.Precision(), out["S"][r:r + 1],
                                out["decoding_order"][r:r + 1])
        gap = (out["log_probs"][r, :40] - want[0, :40]).abs().max()
        assert float(gap) < LOGP_TOL


def _tree_of(trainer, flat):
    """The trainer's parameter tree with each leaf's slice of ``flat``."""
    it, at = iter(range(len(trainer.leaves))), [0]

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [build(v) for v in tree]
        next(it)
        n = tree.numel()
        out = flat[at[0]:at[0] + n].view(tree.shape)
        at[0] += n
        return out
    return build(trainer.params)


def _trainer(sd, **kw):
    t = Trainer(_cfg(protein_augment_eps=0.1, dropout=0.1, **kw), device="cpu")
    tree = from_torch_state_dict(sd, t.cfg)
    with torch.no_grad():
        t.flat.copy_(torch.cat([torch.as_tensor(np.asarray(a)).reshape(-1)
                                for a in tree_leaves(tree)]))
    return t


def test_training_step_loss_and_every_gradient(case):
    """One training step's loss and every leaf's gradient (noise on the
    residues and on each context slot, every dropout, the decode order, all
    from one generator in the same order), and the step's update."""
    sd = case["sd"]
    t = _trainer(sd)
    loss, grad, *_ = t.loss_and_grads(t.device_batch(case["np_batch"]),
                                      torch.Generator().manual_seed(17))
    g_port = to_torch_state_dict(_tree_of(t, grad), t.cfg)
    sd_ref = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    value = LT.loss_of(sd_ref, CFG, case["ref"], torch.Generator().manual_seed(17),
                       RM.Precision())
    got = torch.autograd.grad(value, list(sd_ref.values()), allow_unused=True)
    g_ref = {k: (torch.zeros_like(v) if d is None else d)
             for (k, v), d in zip(sd_ref.items(), got)}
    assert abs(float(loss) - float(value.detach())) / float(value.detach()) < 1e-6
    assert set(g_port) == set(g_ref)
    norms = {k: float(v.norm()) for k, v in g_ref.items()}
    med = float(np.median(list(norms.values())))
    for k in g_ref:
        gap = float(np.linalg.norm(g_port[k] - g_ref[k].numpy()))
        assert gap / max(norms[k], med) < GRAD_TOL, k
    # the update: one clipped Noam-Adam step from the same start
    t2 = _trainer(sd)
    t2.train_step(case["np_batch"], torch.Generator().manual_seed(17))
    after = to_torch_state_dict(_tree_of(t2, t2.flat.detach()), t2.cfg)
    _, _, ref_after = LT.train_steps(sd, CFG, [case["ref"]],
                                     [torch.Generator().manual_seed(17)], RM.Precision())
    moved = {k: float((ref_after[k] - sd[k]).norm()) for k in sd}
    med = float(np.median(list(moved.values())))
    for k in sd:
        gap = float(np.linalg.norm(after[k] - ref_after[k].numpy()))
        assert gap / max(moved[k], med) < 1e-2, k


def test_profile_marks_keep_the_gradient(case, monkeypatch):
    """The profile's marked context graphs (``port_bench/profile_context.py
    ::mark_backwards``: the context features and layers each on an autograd
    graph of its own, its backward one marked call) give the program's loss
    and gradient, and mark each backward once a step."""
    from port_bench import profile_context
    sd, np_batch = case["sd"], case["np_batch"]
    t = _trainer(sd)
    loss, grad, *_ = t.loss_and_grads(t.device_batch(np_batch),
                                      torch.Generator().manual_seed(17))
    monkeypatch.setattr(PL, "context_features", PL.context_features)
    monkeypatch.setattr(PL, "context_encoder", PL.context_encoder)
    profile_context.mark_backwards()
    t2 = _trainer(sd)
    with torch.profiler.profile() as prof:
        loss2, grad2, *_ = t2.loss_and_grads(t2.device_batch(np_batch),
                                             torch.Generator().manual_seed(17))
    names = [e.name for e in prof.events()]
    assert names.count("model.context.backward") == 1
    assert names.count("features.context.backward") == 1
    assert abs(float(loss2) - float(loss)) <= 1e-6 * abs(float(loss))
    assert float((grad2 - grad).norm()) <= 1e-6 * float(grad.norm())


def test_state_dict_loads_and_round_trips(case, tmp_path):
    """A LigandMPNN-keyed ``.pt`` (``model_state_dict``, ``num_edges``,
    ``atom_context_num``) loads through ``load_params_any``, gives the
    reference's log-probabilities, and exports back to the same keys and
    values."""
    path = str(tmp_path / "ligandmpnn_v_32_010_25.pt")
    torch.save({"model_state_dict": case["sd"], "num_edges": 32, "atom_context_num": 25},
               path)
    params, meta = load_params_any(path, _cfg(), device="cpu")
    assert meta["num_edges"] == 32 and meta["atom_context_num"] == 25
    back = to_torch_state_dict(params, _cfg())
    assert set(back) == set(case["sd"])
    for k, v in case["sd"].items():
        assert np.array_equal(back[k], v.numpy()), k
    b, ref = case["batch"], case["ref"]
    order = _order(b["mask"], 8)
    got = mpnn.score(params, _cfg(dropout=0.0), b, decoding_order=order)["log_probs"]
    with torch.no_grad():
        want = LM.log_probs(case["sd"], ref, 32, RM.Precision(), ref["S"].long(), order)
    assert float((_real(got, b["mask"]) - _real(want, b["mask"])).abs().max()) < LOGP_TOL


def test_bf16_context_fails_the_tolerance(case):
    """The log-probability tolerance is tight enough that the context
    encoder in bf16 (the training precision) fails it at fp32 inference."""
    cfg, b, ref = _cfg(dropout=0.0), case["batch"], case["ref"]
    order = _order(b["mask"], 5)
    original = PL.context_features

    def bf16_features(p, cfg, X, Y, Y_t, cdt=None):
        from na_mpnn_tpu_torch.models.modules import cast_tree
        return original(cast_tree(p, torch.bfloat16), cfg, X, Y, Y_t, torch.bfloat16)
    PL.context_features = bf16_features
    try:
        got = mpnn.score(case["params"], cfg, b, decoding_order=order)["log_probs"]
    finally:
        PL.context_features = original
    with torch.no_grad():
        want = LM.log_probs(case["sd"], ref, 32, RM.Precision(), ref["S"].long(), order)
    assert float((_real(got, b["mask"]) - _real(want, b["mask"])).abs().max()) > LOGP_TOL


def test_cli_score_and_design_on_protein_dna_ligand(case, tmp_path):
    """``--model_type ligand_mpnn`` through the CLI on a protein-DNA
    structure with a ligand and waters: the protein residues are scored and
    designed, the DNA and the ligand are context; the score mode's
    log-probabilities under its own orders match the reference reading the
    file with its own reader."""
    from na_mpnn_tpu_torch.cli.run import cli_entry

    pdb = str(tmp_path / "complex.pdb")
    chip_smoke.write_synthetic_pdb(pdb, (("A", "protein", 40), ("B", "dna", 10)))
    with open(pdb) as f:
        lines = [ln for ln in f.read().splitlines() if ln != "END"]
    rng = np.random.default_rng(4)
    for i, el in enumerate(["C", "N", "O", "S", "C", "C", "P", "CL", "H", "O"]):
        xyz = rng.standard_normal(3) * 3.0
        name = (el + str(i))[:4]
        lines.append(f"HETATM{900 + i:>5} {name:<4} LIG L   1    {xyz[0]:8.3f}{xyz[1]:8.3f}"
                     f"{xyz[2]:8.3f}  1.00 10.00          {el:>2}")
    lines.append(f"HETATM  950  O   HOH W   1    {1.0:8.3f}{2.0:8.3f}{3.0:8.3f}  1.00 10.00"
                 "           O")
    with open(pdb, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")
    ckpt = str(tmp_path / "lig.pt")
    torch.save({"model_state_dict": case["sd"], "num_edges": 32, "atom_context_num": 25},
               ckpt)
    out = str(tmp_path / "out")
    common = ["--model_type", "ligand_mpnn", "--checkpoint_na_mpnn", ckpt,
              "--pdb_path", pdb, "--out_folder", out, "--device", "cpu", "--seed", "3",
              "--stats_format", "npz"]
    cli_entry(common + ["--mode", "score", "--batch_size", "2"])
    stats = np.load(os.path.join(out, "stats", "complex.npz"))
    r = LM.read_pdb(pdb)
    assert stats["log_probs"].shape == (2, 40, 21)
    assert len(r["Y"]) == 10 * 11 + 9          # DNA backbone + ligand heavy atoms
    ref = {k: torch.as_tensor(v)[None] for k, v in r.items()}
    with torch.no_grad():
        for row in range(2):
            order = torch.as_tensor(stats["decoding_order"][row:row + 1])
            want = LM.log_probs(case["sd"], ref, 32, RM.Precision(), ref["S"], order)
            assert float(np.abs(stats["log_probs"][row] - want[0].numpy()).max()) < LOGP_TOL
        want_unc = LM.log_probs(case["sd"], ref, 32, RM.Precision(), None, order)
    assert float(np.abs(stats["unconditional_log_probs"] - want_unc[0].numpy()).max()) < LOGP_TOL
    cli_entry(common + ["--mode", "design", "--batch_size", "2"])
    with open(os.path.join(out, "seqs", "complex.fa")) as f:
        seqs = f.read().splitlines()[1::2]
    assert len(seqs) == 3 and all(len(s) == 40 and "X" not in s for s in seqs[1:])
    assert os.path.exists(os.path.join(out, "backbones", "complex_1.pdb"))
