"""Random weights of a configuration, made on the device from the seed in
one draw, in the reference's state-dict layout (the layout of the released
``s_19137.pt`` and ``s_70114.pt``), and written as such a checkpoint.

Weights are uniform in +-sqrt(6 / (fan_in + fan_out)), biases in +-0.1,
LayerNorm scales in 1 +- 0.2 and offsets in +-0.1, the token embedding of
unit variance: no term starts at zero or one, so a misplaced one shows.
"""
from __future__ import annotations

import math

import torch

from .reference import tokens as T


def shapes(cfg: dict):
    """(name, shape, kind) of every tensor, kind one of weight, bias, scale,
    offset, embedding."""
    H = cfg["HIDDEN_DIM"]
    n_pos, bins = cfg["NUM_POSITIONAL_EMBEDDINGS"], cfg["NUM_RBF"]
    atoms = len(T.ATOMS) + 2
    out = [("features.embeddings.linear.weight", (n_pos, 2 * cfg["MAX_RELATIVE_FEATURE"] + 2), "weight"),
           ("features.embeddings.linear.bias", (n_pos,), "bias"),
           ("features.node_embedding.weight", (H, len(T.POLYTYPES)), "weight"),
           ("features.norm_nodes.weight", (H,), "scale"),
           ("features.norm_nodes.bias", (H,), "offset"),
           ("features.edge_embedding.weight", (H, n_pos + bins * atoms * atoms), "weight"),
           ("features.norm_edges.weight", (H,), "scale"),
           ("features.norm_edges.bias", (H,), "offset")]
    for name, d_in, d_out in (("W_v", H, H), ("W_e", H, H), ("W_out", H, T.NUM_LETTERS)):
        out += [(name + ".weight", (d_out, d_in), "weight"), (name + ".bias", (d_out,), "bias")]
    out.append(("W_s.weight", (cfg["VOCAB_SIZE"], H), "embedding"))

    def layer(prefix, names, norms, d_in):
        rows = []
        for n in names:
            fan = d_in if n in ("W1", "W11") else H
            rows += [(f"{prefix}.{n}.weight", (H, fan), "weight"), (f"{prefix}.{n}.bias", (H,), "bias")]
        for n in norms:
            rows += [(f"{prefix}.{n}.weight", (H,), "scale"), (f"{prefix}.{n}.bias", (H,), "offset")]
        rows += [(f"{prefix}.dense.W_in.weight", (4 * H, H), "weight"),
                 (f"{prefix}.dense.W_in.bias", (4 * H,), "bias"),
                 (f"{prefix}.dense.W_out.weight", (H, 4 * H), "weight"),
                 (f"{prefix}.dense.W_out.bias", (H,), "bias")]
        return rows

    for i in range(cfg["NUM_ENCODER_LAYERS"]):
        out += layer(f"encoder_layers.{i}", ("W1", "W2", "W3", "W11", "W12", "W13"),
                     ("norm1", "norm2", "norm3"), 3 * H)
    for i in range(cfg["NUM_DECODER_LAYERS"]):
        out += layer(f"decoder_layers.{i}", ("W1", "W2", "W3"), ("norm1", "norm2"),
                     4 * H)
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """The state dict of ``cfg`` for ``seed``: one ``torch.rand`` on
    ``device`` from a generator there, cut and scaled."""
    rows = shapes(cfg)
    sizes = [math.prod(s) for _, s, _ in rows]
    gen = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2 ** 63)
    u = 2.0 * torch.rand(sum(sizes), generator=gen, device=device) - 1.0
    sd, at = {}, 0
    for (name, shape, kind), n in zip(rows, sizes):
        x = u[at:at + n].view(shape)
        at += n
        if kind == "weight":
            x = x * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif kind in ("bias", "offset"):
            x = 0.1 * x
        elif kind == "scale":
            x = 1.0 + 0.2 * x
        else:
            x = math.sqrt(3.0) * x
        sd[name] = x.contiguous()
    return sd


def save(sd: dict, path: str):
    """Write ``sd`` as a reference checkpoint (``{"model_state_dict": ...}``,
    CPU float32 tensors)."""
    torch.save({"model_state_dict": {k: v.detach().cpu() for k, v in sd.items()}},
               path)
