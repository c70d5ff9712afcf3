"""Building blocks of the NA-MPNN message-passing network, as plain
functions on tensors and parameter dicts.

The numerics follow the JAX package's ``models/modules.py``:

* linear weights are stored ``[in, out]`` (``x @ w + b``), the JAX layout,
  so a parameter tree moves between the two packages without transposes;
* GELU is the exact (erf) form;
* LayerNorm uses eps=1e-5 with (at least) fp32 statistics;
* the neighbour-sum message aggregation divides by ``MESSAGE_SCALE`` = 30.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
MESSAGE_SCALE = 30.0


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x)


def widen(x):
    """A bf16 tensor as fp32 (exact); any other tensor as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def dotp(a, b, low: bool):
    """``a @ b``; with ``low`` (the bf16 trunk) the JAX package's ``_dotp``:
    both operands rounded to bf16, the exact products summed in fp32, an
    fp32 result."""
    if low:
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    return a @ b


def dropout(x, rate: float, generator):
    """Inverted dropout: keep each entry with probability ``1 - rate`` (a
    mask drawn from ``generator``, uniform draws in fp32 for a bf16 ``x``)
    and scale kept entries by ``1 / keep``. Identity when ``rate <= 0`` or
    ``generator`` is None (evaluation)."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, dtype=widen(x).dtype,
                   device=x.device)
    return torch.where(u < keep, x / keep, 0.0)


def linear(p, x):
    out = x @ p["w"]
    return out + p["b"] if "b" in p else out


def cast_tree(tree, dtype):
    """The parameter tree with every floating leaf cast to ``dtype`` (a
    differentiable cast: gradients flow back in the leaves' own type)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def layer_norm(p, x):
    """LayerNorm over the last axis; statistics in fp32 for narrower types."""
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    y = F.layer_norm(xf, xf.shape[-1:], p["scale"].to(xf.dtype),
                     p["bias"].to(xf.dtype), LN_EPS)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Graph gathers
# ---------------------------------------------------------------------------

def flat_rows(idx, L):
    """Flat global row ``b*L + idx[b, ...]`` of a per-structure index
    ``idx [B, ...]`` (int64, same shape)."""
    B = idx.shape[0]
    base = torch.arange(B, device=idx.device, dtype=torch.int64) * L
    return base.view((B,) + (1,) * (idx.dim() - 1)) + idx.long()


def take_rows(x, idx):
    """Per-batch row gather: ``x [B,L,...]``, ``idx [B,...]`` ->
    ``out[b, t] = x[b, idx[b, t]]`` of shape ``idx.shape + x.shape[2:]``."""
    B, L = x.shape[:2]
    rest = x.shape[2:]
    out = x.reshape(B * L, *rest)[flat_rows(idx, L).reshape(-1)]
    return out.reshape(tuple(idx.shape) + tuple(rest))


def gather_nodes(nodes, neighbor_idx):
    """Features ``[B,L,C]`` at neighbour indices ``[B,L,K]`` -> ``[B,L,K,C]``."""
    return take_rows(nodes, neighbor_idx)


def gather_edges(edges, neighbor_idx):
    """Features ``[B,L,L,C]`` at neighbour indices ``[B,L,K]`` -> ``[B,L,K,C]``."""
    idx = neighbor_idx.long()[..., None].expand(*neighbor_idx.shape, edges.shape[-1])
    return torch.gather(edges, 2, idx)


def gather_nodes_t(nodes, neighbor_idx):
    """Features ``[B,L,C]`` at per-batch indices ``[B,K]`` -> ``[B,K,C]``."""
    idx = neighbor_idx.long()[..., None].expand(*neighbor_idx.shape, nodes.shape[-1])
    return torch.gather(nodes, 1, idx)


def cat_neighbors_nodes(h_nodes, h_neighbors, E_idx):
    """``cat(h_neighbors, gather(h_nodes))`` along the features:
    ``[B,L,K,C1]`` and ``[B,L,C2]`` -> ``[B,L,K,C1+C2]``."""
    return torch.cat([h_neighbors, gather_nodes(h_nodes, E_idx)], dim=-1)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def pff_apply(p, h_V):
    """Position-wise feed-forward H -> 4H -> H with GELU."""
    return linear(p["W_out"], gelu(linear(p["W_in"], h_V)))


def pff_acc(p, h, low: bool):
    """``pff_apply`` with ``dotp`` products and widened biases (the fused
    kernels' form: at bf16, fp32 activations and bf16 product operands)."""
    hid = gelu(dotp(h, p["W_in"]["w"], low) + widen(p["W_in"]["b"]))
    return dotp(hid, p["W_out"]["w"], low) + widen(p["W_out"]["b"])


def _split_w1(p, H, name="W1"):
    """View the ``[cH, H]`` concat weight as c row blocks ``[H, H]``."""
    w = p[name]["w"]
    c = w.shape[0] // H
    return [w[i * H:(i + 1) * H] for i in range(c)], p[name]["b"]


def _message_tail(p, x, w2="W2", w3="W3"):
    return linear(p[w3], gelu(linear(p[w2], gelu(x))))


def enc_layer_apply(p, h_V, h_E, E_idx, mask_V=None, mask_attend=None):
    """Deterministic encoder layer on ``[B,L,K,H]`` edges (node update, then
    edge update), with ``cat(h_Vi, h_E, h_Vj) @ W1`` split into row blocks.
    The model runs the flat form on the message-table kernel instead
    (``mpnn.encode``); this form is the layer as the JAX package writes it."""
    H = h_V.shape[-1]

    def edge_message(h_V, w1, w2, w3):
        (wa, wb, wc), b1 = _split_w1(p, H, w1)
        x = ((h_V @ wa)[:, :, None, :] + h_E @ wb
             + gather_nodes(h_V @ wc, E_idx) + b1)
        return _message_tail(p, x, w2, w3)

    h_message = edge_message(h_V, "W1", "W2", "W3")
    if mask_attend is not None:
        h_message = mask_attend[..., None] * h_message
    h_V = layer_norm(p["norm1"], h_V + h_message.sum(-2) / MESSAGE_SCALE)
    h_V = layer_norm(p["norm2"], h_V + pff_apply(p["dense"], h_V))
    if mask_V is not None:
        h_V = mask_V[..., None] * h_V
    h_message = edge_message(h_V, "W11", "W12", "W13")
    h_E = layer_norm(p["norm3"], h_E + h_message)
    return h_V, h_E


def dec_layer_apply(p, h_V, h_E, mask_V=None, mask_attend=None):
    """Deterministic decoder layer on a pre-gathered ``[B,L,K,3H]`` context."""
    h_V_expand = h_V[:, :, None, :].expand(*h_E.shape[:-1], h_V.shape[-1])
    h_EV = torch.cat([h_V_expand, h_E], dim=-1)
    h_message = linear(p["W3"], gelu(linear(p["W2"], gelu(linear(p["W1"], h_EV)))))
    if mask_attend is not None:
        h_message = mask_attend[..., None] * h_message
    h_V = layer_norm(p["norm1"], h_V + h_message.sum(-2) / MESSAGE_SCALE)
    h_V = layer_norm(p["norm2"], h_V + pff_apply(p["dense"], h_V))
    if mask_V is not None:
        h_V = mask_V[..., None] * h_V
    return h_V


# ---------------------------------------------------------------------------
# Initialisers (numpy trees in the JAX layout: xavier-uniform, zero bias)
# ---------------------------------------------------------------------------

def _xavier_uniform(rng: np.random.Generator, shape):
    a = math.sqrt(6.0 / (shape[0] + shape[1]))
    return rng.uniform(-a, a, size=shape).astype(np.float32)


def init_linear(rng, d_in, d_out, bias=True):
    p = {"w": _xavier_uniform(rng, (d_in, d_out))}
    if bias:
        p["b"] = np.zeros((d_out,), np.float32)
    return p


def init_layer_norm(d):
    return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}


def init_pff(rng, d_hidden, d_ff):
    return {"W_in": init_linear(rng, d_hidden, d_ff),
            "W_out": init_linear(rng, d_ff, d_hidden)}


def init_enc_layer(rng, d_hidden, d_in):
    return {
        "W1": init_linear(rng, d_hidden + d_in, d_hidden),
        "W2": init_linear(rng, d_hidden, d_hidden),
        "W3": init_linear(rng, d_hidden, d_hidden),
        "W11": init_linear(rng, d_hidden + d_in, d_hidden),
        "W12": init_linear(rng, d_hidden, d_hidden),
        "W13": init_linear(rng, d_hidden, d_hidden),
        "norm1": init_layer_norm(d_hidden),
        "norm2": init_layer_norm(d_hidden),
        "norm3": init_layer_norm(d_hidden),
        "dense": init_pff(rng, d_hidden, d_hidden * 4),
    }


def init_dec_layer(rng, d_hidden, d_in):
    return {
        "W1": init_linear(rng, d_hidden + d_in, d_hidden),
        "W2": init_linear(rng, d_hidden, d_hidden),
        "W3": init_linear(rng, d_hidden, d_hidden),
        "norm1": init_layer_norm(d_hidden),
        "norm2": init_layer_norm(d_hidden),
        "dense": init_pff(rng, d_hidden, d_hidden * 4),
    }
