#!/usr/bin/env python3
"""The RBF projection kernels' outputs of one source tree of the PyTorch
port, saved for a bitwise comparison with another tree's on the same card.

    python3 scripts/torch_rbf_ab.py dump TREE OUT.pt
    python3 scripts/torch_rbf_ab.py compare A.pt B.pt

``dump`` imports ``na_mpnn_tpu_torch`` from the checkout at TREE (built
there at first use), makes the training operands of ``chip_smoke.py``
(8 synthetic protein-DNA structures collated to B=8 x L=768, K=32, the
kNN graph, a full-width weight from seed 1, a cotangent from seed 3) and
saves, at fp32 and bf16, the classed forward and weight gradient (rows 3
and 4) and the dense ones (rows 5 and 6), on the whole structure and for
its second 192-row shard against the 768 key rows. ``compare`` exits 1
unless every row 3 and 4 output is bitwise equal in the two files, and
prints how far apart rows 5 and 6 are. Needs one CUDA card.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dump(tree, out):
    sys.path.insert(0, REPO)
    import chip_smoke            # the batch helpers; imports no package module
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import na_mpnn_tpu_torch
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.models.features import build_augmented_atoms
    from na_mpnn_tpu_torch.ops import knn, rbf_classed, rbf_edge
    from na_mpnn_tpu_torch.train.trainer import to_device

    if not torch.cuda.is_available():
        raise SystemExit("torch_rbf_ab: no CUDA card")
    pkg = os.path.dirname(na_mpnn_tpu_torch.__file__)
    if not pkg.startswith(os.path.abspath(tree)):
        raise SystemExit(f"torch_rbf_ab: imported {pkg}, not the tree's package")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(chip_smoke.OUT, exist_ok=True)
    dev = torch.device("cuda")
    cfg = ModelConfig()
    batch = to_device(chip_smoke.training_batch(), dev)
    X, M, X_ref = build_augmented_atoms(batch["X"], batch["X_m"], batch, cfg)
    _, E = knn.knn_graph_cuda(X_ref, batch["mask"].float(), cfg.k_neighbors)
    W = init_params(1, cfg, device=dev)["features"]["edge_embedding"]["w"][
        cfg.num_positional_embeddings:].contiguous()
    W_fold = rbf_classed.fold_scaled(W)
    g = torch.randn(E.shape + (cfg.hidden_dim,),
                    generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    s = slice(192, 384)
    shard = (X[:, s].contiguous(), M[:, s].contiguous(), E[:, s].contiguous())
    outs = {}
    for where, (Xq, Mq, Eq), keys, gq in (
            ("all", (X, M, E), (None, None), g),
            ("shard", shard, (X, M), g[:, s].contiguous())):
        for name, fn, w in (
                ("row3_fp32", rbf_classed.rbf_edge_features_classed_cuda, W),
                ("row3_bf16", rbf_classed.rbf_classed_bf16_cuda, W_fold),
                ("row5_fp32", rbf_edge.rbf_edge_cuda, W),
                ("row5_bf16", rbf_edge.rbf_edge_bf16_cuda, W)):
            outs[f"{name}_{where}"] = fn(Xq, Mq, Eq, w, *keys).cpu()
        for name, fn in (("row4_fp32", rbf_classed.rbf_classed_dw_cuda),
                         ("row4_bf16", rbf_classed.rbf_classed_dw_bf16_cuda),
                         ("row6_fp32", rbf_edge.rbf_edge_dw_cuda),
                         ("row6_bf16", rbf_edge.rbf_edge_dw_bf16_cuda)):
            outs[f"{name}_{where}"] = fn(Xq, Mq, Eq, gq, *keys).cpu()
    torch.save(outs, out)
    print(f"torch_rbf_ab: {len(outs)} outputs of {pkg} -> {out}", flush=True)


def compare(a_path, b_path):
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    same = True
    for key in sorted(a):
        x, y = a[key], b[key]
        rel = float((x - y).abs().max()) / (float(y.abs().max()) + 1e-30)
        bitwise = torch.equal(x, y)
        held = key.startswith(("row3", "row4"))
        same &= bitwise or not held
        print(f"{key}: bitwise {bitwise}, max rel diff {rel:.3g}"
              + ("" if held else " (not required)"), flush=True)
    print("rows 3 and 4 bitwise equal in both trees" if same
          else "rows 3 and 4 differ between the trees", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        raise SystemExit(__doc__)
