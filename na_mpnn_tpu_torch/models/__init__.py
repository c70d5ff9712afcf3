from .config import ModelConfig
from .mpnn import (autoregressive_edge_masks, build_decode_groups, encode,
                   forward, init_params, sample, sample_decoding_order,
                   sample_multi, sample_tied, score, unconditional_probs)

__all__ = [
    "ModelConfig", "init_params", "encode", "forward", "sample", "score",
    "unconditional_probs", "sample_decoding_order", "autoregressive_edge_masks",
    "sample_multi", "build_decode_groups", "sample_tied",
]
