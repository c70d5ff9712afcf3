#!/usr/bin/env python3
"""The message kernels' outputs of one source tree of the PyTorch port
(rows 9-12: the message-table forward and backward and the fused layer
updates), saved for a bitwise comparison with another tree's on the same
card.

    python3 scripts/torch_message_ab.py dump TREE OUT.pt
    python3 scripts/torch_message_ab.py compare A.pt B.pt

``dump`` imports ``na_mpnn_tpu_torch`` from the checkout at TREE (built
there at first use) and, at fp32 and bf16, on random operands from seed 13
at the training shape (B=8 x L=768, K=32, H=128: 6144 nodes, random
neighbour indices and masks, mbw <= m1d) with the layer weights of
``chip_smoke._random_layer``, saves: row 9 in its three modes with and
without x, row 10 in its three modes (from a random x and cotangent), and
rows 11 (encoder and decoder node update, its fp32 dh too) and 12.
``compare`` prints how far apart each output is and exits 1 unless every
one is bitwise equal in the two files. Needs one CUDA card.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("enc_node", "enc_edge", "dec")
SHAPE = (8, 768)   # B structures of L nodes: the training shape


def dump(tree, path):
    sys.path.insert(0, REPO)
    import chip_smoke            # the operand helpers; imports no package module
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import na_mpnn_tpu_torch
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.models.modules import cast_tree
    from na_mpnn_tpu_torch.ops import message_kernels as mk

    if not torch.cuda.is_available():
        raise SystemExit("torch_message_ab: no CUDA card")
    pkg = os.path.dirname(na_mpnn_tpu_torch.__file__)
    if not pkg.startswith(os.path.abspath(tree)):
        raise SystemExit(f"torch_message_ab: imported {pkg}, not the tree's package")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ModelConfig()
    H, K = cfg.hidden_dim, cfg.k_neighbors
    B, L = SHAPE
    N, E = B * L, B * L * K
    gen = torch.Generator(device=dev).manual_seed(13)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    eidx2 = torch.randint(0, L, (E,), generator=gen, device=dev)
    m1d = (torch.rand((E,), generator=gen, device=dev) > 0.1).float()
    mbw = m1d * (torch.rand((E,), generator=gen, device=dev) > 0.5).float()
    m_att = m1d * (torch.rand((E,), generator=gen, device=dev) > 0.2).float()
    mask2 = (torch.rand((N,), generator=gen, device=dev) > 0.05).float()
    pe, pd = chip_smoke._random_layer(cfg, 13, dev)
    ops32 = [rand(N, H), rand(E, H), rand(N, H), rand(N, 2 * H), m_att, m1d, mbw,
             mask2]
    x32, g_node32, g_edge32 = rand(E, H), rand(N, H), rand(E, H)
    outs = {}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        h_V2, h_E2, tab, tab2, m_att2, m1d2, mbw2, mask22 = [t.to(dt) for t in ops32]
        x, g_node, g_edge = x32.to(dt), g_node32.to(dt), g_edge32.to(dt)
        pe_t, pd_t = (pe, pd) if tag == "fp32" else (cast_tree(pe, dt), cast_tree(pd, dt))
        for mode in MODES:
            table, m, w = ((tab2, m1d2, mbw2) if mode == "dec" else
                           (tab, m_att2, torch.ones_like(m_att2)))
            p = pd_t if mode == "dec" else pe_t
            names = ("W11", "W12", "W13") if mode == "enc_edge" else ("W1", "W2", "W3")
            weights = mk._weights(p, H, *names)
            args = (h_V2, h_E2, table, eidx2, m, w, *weights)
            out, xk = mk.message_table_cuda(mode, *args, K=K, L=L, save_x=True)
            outs[f"row9_{mode}_{tag}"] = out.cpu()
            outs[f"row9_{mode}_x_{tag}"] = xk.cpu()
            outs[f"row9_{mode}_nox_{tag}"] = mk.message_table_cuda(mode, *args, K=K,
                                                                   L=L).cpu()
            g = g_edge if mode == "enc_edge" else g_node
            grads = mk.message_table_bwd_cuda(mode, h_V2, h_E2, x, eidx2, m, w,
                                              *weights, g, K=K, L=L)
            for i, t in enumerate(grads):
                outs[f"row10_{mode}_{i}_{tag}"] = t.cpu()
        cases = chip_smoke._fused_cases(
            pe_t, pd_t, [h_V2, h_E2, tab, tab2, m_att2, m1d2, mbw2, mask22], eidx2,
            K, L, L)
        for name, (call, kernel, _, _, _, message) in cases.items():
            outs[f"{name}_{tag}"] = call(kernel).cpu()
            if message is not None:
                outs[f"{name}_dh_{tag}"] = message(False).cpu()
    torch.save(outs, path)
    print(f"torch_message_ab: {len(outs)} outputs of {pkg} -> {path}", flush=True)


def compare(a_path, b_path):
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    if sorted(a) != sorted(b):
        raise SystemExit(f"torch_message_ab: the files hold other outputs "
                         f"({sorted(set(a) ^ set(b))})")
    same = True
    for key in sorted(a):
        x, y = a[key].float(), b[key].float()
        rel = float((x - y).abs().max()) / (float(y.abs().max()) + 1e-30)
        bitwise = torch.equal(a[key], b[key])
        same &= bitwise
        print(f"{key}: bitwise {bitwise}, max rel diff {rel:.3g}", flush=True)
    print(f"rows 9-12: all {len(a)} outputs bitwise equal in both trees" if same
          else "rows 9-12 differ between the trees", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        raise SystemExit(__doc__)
