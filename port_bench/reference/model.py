"""NA-MPNN's forward pass in plain PyTorch: features, encoder, the
teacher-forced decoder and the unconditional decoder, on a state dict in the
reference layout (``features.*``, ``W_v``, ``W_e``, ``W_s``, ``W_out``,
``encoder_layers.i.*``, ``decoder_layers.i.*``; ``nn.Linear`` weights
``[out, in]``).

The equations are ProteinMPNN's with NA-MPNN's changes: an 18-slot atom
frame (16 backbone slots, a virtual Cb on protein and a virtual base N on
nucleic acids), the RBF of every present atom pair of an edge (16 bins over
2-22 A), the kNN on the residue centre (CA + C1'), polymer-type node
features, a relative-position block with a cross-chain bucket, 33 letters.

Every product of a weight goes through ``Precision``: float32 with TF32
off (the reference), or its operands rounded to TF32 or to scaled float8
e4m3 (the lower precisions a control puts in the program's place).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import tokens as T

LN_EPS = 1e-5
MESSAGE_SCALE = 30.0
RBF_BINS, RBF_MIN, RBF_MAX = 16, 2.0, 22.0
MAX_REL = 32


class Precision:
    """Rounding of the operands of every weight product: ``fp32`` (none),
    ``tf32`` (10 mantissa bits, round to nearest even, as the tensor cores
    take float32 operands) or ``fp8`` (float8 e4m3 after scaling each
    tensor's largest magnitude to 448). The rounding passes the gradient
    straight through."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def __call__(self, x):
        if self.name == "fp32":
            return x
        with torch.no_grad():
            if self.name == "tf32":
                u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                u = (((u + 0xFFF + ((u >> 13) & 1)) >> 13) << 13) & 0xFFFFFFFF
                q = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
                q = q.view(torch.float32).view(x.shape)
            else:
                s = 448.0 / x.abs().amax().clamp_min(1e-30)
                q = (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s
        return x + (q - x).detach()


@contextlib.contextmanager
def exact_float32():
    """TF32 off for float32 products on the card, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linear(sd, name, x, prec):
    return F.linear(prec(x), prec(sd[name + ".weight"]), sd.get(name + ".bias"))


def layer_norm(sd, name, x):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"], sd[name + ".bias"],
                        LN_EPS)


def gather_nodes(x, idx):
    """``x [B,L,C]`` at ``idx [B,L,K]`` -> ``[B,L,K,C]``."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


def _virtual(a1, a2, a3, w):
    b, c = a2 - a1, a3 - a2
    return w[0] * torch.linalg.cross(b, c, dim=-1) + w[1] * b + w[2] * c + a2


def noised(batch, eps, noise):
    """Coordinates with the training noise: ``eps`` A times ``noise`` on every
    present atom of a protein, DNA or RNA residue."""
    e = (batch["protein_mask"] * eps[0] + batch["dna_mask"] * eps[1]
         + batch["rna_mask"] * eps[2]).to(batch["X"].dtype)
    return batch["X"] + batch["X_m"][..., None].to(batch["X"].dtype) \
        * e[:, :, None, None] * noise


def neighbours(X_ref, mask, k):
    """The k nearest present residues of each residue (itself included),
    nearest first, ties to the lower index. The squared distance is summed
    as ``(dx*dx + dy*dy) + dz*dz``, so equal distances compare equal however
    the program orders its sum; absent pairs sort last."""
    m2 = mask[:, None, :] * mask[:, :, None]
    d = X_ref[:, :, None, :] - X_ref[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    d2 = d2 + d[..., 2] * d[..., 2]
    D = m2 * torch.sqrt(d2 + 1e-6)
    D = D + (1.0 - m2) * D.amax(-1, keepdim=True)
    return torch.sort(D, dim=-1, stable=True)[1][..., :min(k, D.shape[-1])]


def features(sd, batch, k, prec, X=None):
    """(``h_V``, ``h_E``, ``E_idx``, ``mask_attend``) after ``W_v`` and
    ``W_e``. ``batch``: float tensors ``[B,L,...]`` (``X``, ``X_m``, ``mask``,
    the polymer masks, ``R_idx``, ``chain_labels``, ``R_polymer_type``);
    ``X`` replaces ``batch["X"]`` (the noised coordinates)."""
    X = batch["X"] if X is None else X
    X_m, mask = batch["X_m"].to(X.dtype), batch["mask"].to(X.dtype)
    s = T.SLOT
    cb = _virtual(X[:, :, s["N"]], X[:, :, s["CA"]], X[:, :, s["C"]], T.CB_WEIGHTS)
    nn = _virtual(X[:, :, s["O4'"]], X[:, :, s["C1'"]], X[:, :, s["C2'"]],
                  T.NA_N_WEIGHTS)
    Xa = torch.cat([X, cb[:, :, None], nn[:, :, None]], dim=2)        # [B,L,18,3]
    Ma = torch.cat([X_m, batch["protein_mask"].to(X.dtype)[..., None],
                    (batch["dna_mask"] + batch["rna_mask"]).to(X.dtype)[..., None]],
                   dim=2)
    E_idx = neighbours(X[:, :, s["CA"]] + X[:, :, s["C1'"]], mask, k)
    B, L, K = E_idx.shape
    A = Xa.shape[2]

    # the RBF of every atom pair (a of i, b of j), bin r at (a*A + b)*16 + r
    Xj, Mj = gather_nodes(Xa.reshape(B, L, -1), E_idx), gather_nodes(Ma, E_idx)
    d = Xa[:, :, None, :, None, :] - Xj.reshape(B, L, K, 1, A, 3)
    D = torch.sqrt((d * d).sum(-1) + 1e-6)
    mu = torch.linspace(RBF_MIN, RBF_MAX, RBF_BINS, dtype=X.dtype, device=X.device)
    rbf = torch.exp(-((D[..., None] - mu) / ((RBF_MAX - RBF_MIN) / RBF_BINS)) ** 2)
    rbf = rbf * Ma[:, :, None, :, None, None] * Mj[:, :, :, None, :, None]

    # relative position, clipped at +-32, a bucket of its own across chains
    R = batch["R_idx"].long()
    same = (batch["chain_labels"].long()[:, :, None]
            == gather_nodes(batch["chain_labels"].long()[..., None], E_idx)[..., 0])
    off = R[:, :, None] - gather_nodes(R[..., None], E_idx)[..., 0]
    pos = torch.where(same, torch.clamp(off + MAX_REL, 0, 2 * MAX_REL),
                      2 * MAX_REL + 1)
    pos = linear(sd, "features.embeddings.linear",
                 F.one_hot(pos, 2 * MAX_REL + 2).to(X.dtype), prec)
    E = linear(sd, "features.edge_embedding",
               torch.cat([pos, rbf.reshape(B, L, K, -1)], dim=-1), prec)
    E = layer_norm(sd, "features.norm_edges", E)
    V = F.one_hot(batch["R_polymer_type"].long(), len(T.POLYTYPES)).to(X.dtype)
    V = layer_norm(sd, "features.norm_nodes",
                   linear(sd, "features.node_embedding", V, prec))
    mask_attend = mask[:, :, None] * gather_nodes(mask[..., None], E_idx)[..., 0]
    return (linear(sd, "W_v", V, prec), linear(sd, "W_e", E, prec), E_idx,
            mask_attend)


def _mlp(sd, p, x, prec, names=("W1", "W2", "W3")):
    x = F.gelu(linear(sd, f"{p}.{names[0]}", x, prec))
    x = F.gelu(linear(sd, f"{p}.{names[1]}", x, prec))
    return linear(sd, f"{p}.{names[2]}", x, prec)


def _ffn(sd, p, x, prec):
    return linear(sd, f"{p}.dense.W_out",
                  F.gelu(linear(sd, f"{p}.dense.W_in", x, prec)), prec)


def _keep(x, drop, slot):
    return x if drop is None else drop(x, slot)


def encoder(sd, h_V, h_E, E_idx, mask, mask_attend, prec, drop=None):
    """The encoder layers: node update (message of ``[h_i, e_ij, h_j]``,
    masked by ``mask_attend``, summed over neighbours / 30, LayerNorm, FFN,
    LayerNorm, node mask), then the edge update with the new ``h_V``.
    ``drop(x, slot)``: dropout on the node message (0), the FFN output (1)
    and the edge message (2)."""
    K = E_idx.shape[2]
    for i in range(sum(1 for k in sd if k.startswith("encoder_layers.")
                       and k.endswith(".W1.weight"))):
        p = f"encoder_layers.{i}"
        x = torch.cat([h_V[:, :, None].expand(-1, -1, K, -1), h_E,
                       gather_nodes(h_V, E_idx)], dim=-1)
        m = mask_attend[..., None] * _mlp(sd, p, x, prec)
        h_V = layer_norm(sd, f"{p}.norm1",
                         h_V + _keep(m.sum(2) / MESSAGE_SCALE, drop, 0))
        h_V = layer_norm(sd, f"{p}.norm2", h_V + _keep(_ffn(sd, p, h_V, prec), drop, 1))
        h_V = mask[..., None] * h_V
        x = torch.cat([h_V[:, :, None].expand(-1, -1, K, -1), h_E,
                       gather_nodes(h_V, E_idx)], dim=-1)
        m = _mlp(sd, p, x, prec, ("W11", "W12", "W13"))
        h_E = layer_norm(sd, f"{p}.norm3", h_E + _keep(m, drop, 2))
    return h_V, h_E


def decoder(sd, h_V, h_E, E_idx, mask, S, order, prec, drop=None):
    """Log-probabilities ``[B,L,33]`` of every position given the letters
    ``S`` of the positions decoded before it in ``order`` (``order[b, t]``
    is the position decoded at step t); ``S`` None gives the unconditional
    probabilities (no letter known, every neighbour on its encoder state).
    ``drop`` as in ``encoder`` (slots 0 and 1)."""
    B, L, K = E_idx.shape
    m1 = mask[:, :, None, None]
    if S is None:
        before = torch.zeros((B, L, K, 1), dtype=h_V.dtype, device=h_V.device)
        h_S = torch.zeros_like(h_V)
    else:
        rank = torch.argsort(order, dim=-1)
        before = (gather_nodes(rank[..., None], E_idx)[..., 0]
                  < rank[:, :, None]).to(h_V.dtype)[..., None]
        h_S = sd["W_s.weight"][S]
    h_ES = torch.cat([h_E, gather_nodes(h_S, E_idx)], dim=-1)
    h_enc = m1 * (1.0 - before) * torch.cat(
        [h_E, torch.zeros_like(h_E), gather_nodes(h_V, E_idx)], dim=-1)
    for i in range(sum(1 for k in sd if k.startswith("decoder_layers.")
                       and k.endswith(".W1.weight"))):
        p = f"decoder_layers.{i}"
        ctx = m1 * before * torch.cat([h_ES, gather_nodes(h_V, E_idx)], dim=-1) + h_enc
        x = torch.cat([h_V[:, :, None].expand(-1, -1, K, -1), ctx], dim=-1)
        m = _mlp(sd, p, x, prec)
        h_V = layer_norm(sd, f"{p}.norm1",
                         h_V + _keep(m.sum(2) / MESSAGE_SCALE, drop, 0))
        h_V = layer_norm(sd, f"{p}.norm2", h_V + _keep(_ffn(sd, p, h_V, prec), drop, 1))
        h_V = mask[..., None] * h_V
    return torch.log_softmax(linear(sd, "W_out", h_V, prec), dim=-1)


def sampling_log_probs(log_probs, temperature, omit):
    """``log`` of ``sampling_probs`` in float64: ``-inf`` for the letters no
    sampler draws, finite (if far below) for omitted ones."""
    x = ((log_probs.double() - 1e8 * omit.double()) / temperature)
    never = torch.zeros(x.shape[-1], dtype=torch.bool, device=x.device)
    never[T.NEVER_SAMPLED] = True
    return torch.log_softmax(x.masked_fill(never, float("-inf")), dim=-1)


def sampling_probs(log_probs, temperature, omit):
    """The distribution a sampler draws from: ``softmax((logits - 1e8 *
    omit) / T)`` with the letters no sampler draws removed and the rest
    renormalised (``log_probs`` are the unbiased ones; ``omit`` ``[33]``)."""
    p = torch.softmax((log_probs - 1e8 * omit) / temperature, dim=-1)
    never = torch.zeros_like(omit)
    never[T.NEVER_SAMPLED] = 1.0
    p = p * (1.0 - never)
    return p / p.sum(-1, keepdim=True)
