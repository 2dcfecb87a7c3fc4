"""The model stack of the port: the dense decoder-only family, for serving.

``config`` (the schema), ``layers`` (norms, RoPE, activations, the
parameter initialiser), ``attention`` (blockwise and decode attention),
``blocks`` (attention, MLP and decoder layers), ``lm`` (``DecoderLM``,
``init``, caches, ``prefill``, ``decode``) and ``weights`` (weights
carried over from the reference's parameter tree).
"""
from repro_torch.models.config import MLACfg, MoECfg, ModelConfig, SSMCfg

__all__ = ["ModelConfig", "MoECfg", "MLACfg", "SSMCfg"]
