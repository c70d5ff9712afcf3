from .config import ModelConfig
from .mpnn import (autoregressive_edge_masks, build_decode_groups, encode,
                   forward, init_params, sample, sample_decoding_order,
                   sample_multi, sample_tied, score, unconditional_probs)

__all__ = [
    "ModelConfig", "init_params", "encode", "forward", "sample", "score",
    "unconditional_probs", "sample_decoding_order", "autoregressive_edge_masks",
    "sample_multi", "build_decode_groups", "sample_tied",
    "from_torch_state_dict", "load_torch_checkpoint",
]


def __getattr__(name):
    # The reference-checkpoint readers live in ``params.py``, which imports
    # this package: resolved at first use, not at import.
    if name in ("from_torch_state_dict", "load_torch_checkpoint"):
        from .. import params
        return getattr(params, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
