from .config import ModelConfig
from .mpnn import (autoregressive_edge_masks, encode, forward, init_params,
                   sample, sample_decoding_order, score, unconditional_probs)

__all__ = [
    "ModelConfig", "init_params", "encode", "forward", "sample", "score",
    "unconditional_probs", "sample_decoding_order", "autoregressive_edge_masks",
]
