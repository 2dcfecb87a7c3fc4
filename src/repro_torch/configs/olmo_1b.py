"""olmo-1b [dense] — non-parametric LayerNorm.

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304 [arXiv:2402.00838; hf]
"""
from repro_torch.models.config import ModelConfig

ID = "olmo-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=50_304,
        mlp="swiglu", norm="nonparam_ln", tie_embeddings=True,
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
        remat="none",
    )
