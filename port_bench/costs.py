"""The yardstick: the card's peaks and the operations and bytes that the
model's work needs, counted from shapes (the same whatever kernel runs).

Peaks are NVIDIA's data sheet for the H100 SXM, dense: float32 operands
are held against the TF32 tensor-core rate (the highest at which the card
takes float32 operands), bf16 against the bf16 rate, bytes against HBM3.

Counts are the least work that the inputs need, whatever the program
does: unpadded residues only, one encode of a structure however many
decodes read it, and within each function node-level products are
counted once per node (``h_V @ W`` before the gather), a message sum
``sum_k w_k (W3 g_k + b3)`` as ``W3 (sum_k w_k g_k)``; every input byte is
read once and every output byte written once. The formulas of the message
table (forward and backward) and of the fused layer updates are the smoke
test's (``chip_smoke.py``), against these peaks.
"""
from __future__ import annotations

PEAK_FLOPS = {"fp32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
ESIZE = {"fp32": 4, "bf16": 2}


def least_seconds(ops, nbytes, dtype):
    """The least time the card can take for ``ops`` operations and ``nbytes``
    bytes: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def message_table(mode, N, K, H, dtype, save_x=False):
    """(ops, bytes) of one message-table forward (row 9) over N nodes:
    ``enc_node``, ``enc_edge`` or ``dec``; with ``save_x`` the first
    activation is written too."""
    e = ESIZE[dtype]
    C = 2 * H if mode == "dec" else H
    if mode == "enc_edge":
        ops = N * K * (6 * H * H + 30 * H) + N * 2 * H * H
    else:
        ops = N * K * (4 * H * H + 30 * H) + N * 4 * H * H
    out = N * K * H if mode == "enc_edge" else N * H
    nbytes = (e * (N * H + N * K * H + N * C + 2 * N * K + 4 * H * H + 3 * H + out
                   + (N * K * H if save_x else 0)) + 8 * N * K)
    return ops, nbytes


def message_table_bwd(mode, N, K, H, dtype):
    """(ops, bytes) of one message-table backward (row 10): per edge the
    recomputed W2 product, dW2, the input and edge gradients and dWb (10
    H^2; 14 in ``enc_edge``), about 40 H elementwise; per node 8 H^2 (4 in
    ``enc_edge``)."""
    e = ESIZE[dtype]
    C = 2 * H if mode == "dec" else H
    per_edge, per_node = (14, 4) if mode == "enc_edge" else (10, 8)
    ops = N * K * (per_edge * H * H + 40 * H) + N * per_node * H * H
    nbytes = (e * (N * H + 3 * N * K * H + N * H + 2 * N * K + N * H + N * C
                   + 4 * H * H + H + 4 * H * H + 3 * H) + 8 * N * K)
    return ops, nbytes


def fused_update(kind, N, K, H, dtype):
    """(ops, bytes) of one fused layer update (rows 11, 12): ``node_enc`` or
    ``node_dec`` (the message sum over a table of H or 2H columns, the FFN,
    two LayerNorms) or ``edge`` (the encoder's edge message and LN3)."""
    e = ESIZE[dtype]
    w = 4 * H * H + 3 * H
    if kind == "edge":
        ops = N * K * (6 * H * H + 38 * H) + N * 2 * H * H
        nbytes = e * (N * H + 2 * N * K * H + N * H + w + 2 * H) + 8 * N * K
        return ops, nbytes
    C = H if kind == "node_enc" else 2 * H
    ops = N * K * (4 * H * H + 30 * H) + N * (20 * H * H + 20 * H)
    nbytes = (e * (2 * N * H + N * K * H + N * C + 2 * N * K + N + w + 8 * H * H
                   + 9 * H) + 8 * N * K)
    return ops, nbytes


def features_flops(N, K, H, pairs_per_edge, n_pos=16):
    """The featuriser of N nodes: the RBF projection of every present atom
    pair (16 (2H + 8) each), the positional block and the LayerNorms."""
    E = N * K
    return E * pairs_per_edge * 16 * (2 * H + 8) + E * (2 * n_pos * H + 10 * H) + N * 14 * H


def encoder_flops(N, K, H, layers):
    """The encoder stack over N nodes, with the embeddings of nodes and edges."""
    node = fused_update("node_enc", N, K, H, "fp32")[0]
    edge = fused_update("edge", N, K, H, "fp32")[0]
    return layers * (node + edge) + 2 * N * K * H * H + 2 * N * H * H


def decoder_flops(N, K, H, layers, letters=33):
    """The parallel decoder stack over N nodes and the output head."""
    return layers * fused_update("node_dec", N, K, H, "fp32")[0] + 2 * N * H * letters


def sampler_flops(B, L, K, H, layers, letters=33):
    """Autoregressive sampling of B rows of L positions after one encode:
    the per-layer edge terms of every row once (2 H^2 per edge and layer),
    then per decode step and row the decoder on one position (the message of
    K neighbours: 8 H^2 each beyond the first layer, 6 H^2 in it, its sum,
    the FFN and LayerNorms) and the head."""
    statics = layers * B * L * K * 2 * H * H
    per_pos = (layers * (K * (6 * H * H + 30 * H) + 2 * H * H + 16 * H * H + 20 * H)
               + (layers - 1) * K * 2 * H * H + 2 * H * letters)
    return statics + B * L * per_pos


# atoms present per residue in the 18-slot frame: the backbone and the
# polymer's virtual atom
ATOMS_PRESENT = {"protein": 5, "dna": 12, "rna": 13}


def pairs_per_edge(chains):
    """Present atom pairs of an average edge of a structure (chains of
    (id, kind, length)): the square of its mean atoms per residue."""
    n = sum(c[2] for c in chains)
    return (sum(ATOMS_PRESENT[c[1]] * c[2] for c in chains) / n) ** 2


def serve_flops(mode, chains, cfg):
    """Model operations of one CLI request: design and specificity encode
    once and sample ``batch_size`` rows; score encodes once and decodes its
    ``batch_size`` orders and once more for the unconditional probabilities
    (the program encodes each tiled copy and again for the unconditional
    pass; that repeated work is not counted)."""
    L = sum(c[2] for c in chains)
    K, H = cfg["NUM_NEIGHBORS"], cfg["HIDDEN_DIM"]
    enc, dec = cfg["NUM_ENCODER_LAYERS"], cfg["NUM_DECODER_LAYERS"]
    B = cfg["inference"][mode]["batch_size"]
    p = pairs_per_edge(chains)

    def encode(N):
        return features_flops(N, K, H, p) + encoder_flops(N, K, H, enc)
    if mode == "score":
        return encode(L) + decoder_flops(B * L + L, K, H, dec)
    return encode(L) + sampler_flops(B, L, K, H, dec)


def train_flops(tokens, pairs, cfg):
    """Model operations of one training step over ``tokens`` unpadded
    residues: the forward and a backward of twice its work."""
    K, H = cfg["NUM_NEIGHBORS"], cfg["HIDDEN_DIM"]
    fwd = (features_flops(tokens, K, H, pairs)
           + encoder_flops(tokens, K, H, cfg["NUM_ENCODER_LAYERS"])
           + decoder_flops(tokens, K, H, cfg["NUM_DECODER_LAYERS"]))
    return 3 * fwd


def train_table_seconds(N, cfg, backward):
    """The least time of one training step's message-table launches over
    ``N`` unpadded residues: an encoder node and an encoder edge update per
    encoder layer and a decoder update per decoder layer, the forward saving
    its first activation for the backward (row 9), or the backward (row 10),
    at the trunk's precision."""
    dt = "bf16" if cfg["MIXED_PRECISION"] else "fp32"
    K, H = cfg["NUM_NEIGHBORS"], cfg["HIDDEN_DIM"]
    total = 0.0
    for mode, n in (("enc_node", cfg["NUM_ENCODER_LAYERS"]),
                    ("enc_edge", cfg["NUM_ENCODER_LAYERS"]),
                    ("dec", cfg["NUM_DECODER_LAYERS"])):
        work = (message_table_bwd(mode, N, K, H, dt) if backward
                else message_table(mode, N, K, H, dt, save_x=True))
        total += n * least_seconds(*work, dt)
    return total


def score_fused_seconds(L, B, cfg):
    """The least time of the fused layer updates (rows 11, 12, float32) that
    one score request of ``L`` residues and ``B`` orders needs: the encoder's
    node and edge updates once, the decoder's node updates over the ``B``
    orders and the unconditional pass."""
    K, H = cfg["NUM_NEIGHBORS"], cfg["HIDDEN_DIM"]
    enc, dec = cfg["NUM_ENCODER_LAYERS"], cfg["NUM_DECODER_LAYERS"]
    return (enc * least_seconds(*fused_update("node_enc", L, K, H, "fp32"), "fp32")
            + enc * least_seconds(*fused_update("edge", L, K, H, "fp32"), "fp32")
            + dec * least_seconds(*fused_update("node_dec", B * L + L, K, H, "fp32"), "fp32"))
