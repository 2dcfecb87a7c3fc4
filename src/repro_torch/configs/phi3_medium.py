"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified]
"""
from repro_torch.models.config import ModelConfig

ID = "phi3-medium-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        d_ff=17920, vocab_size=100_352,
        mlp="swiglu", norm="rmsnorm", tie_embeddings=False,
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
        remat="none",
    )
