"""gemma-7b [dense] — GeGLU, head_dim=256, embedding scaling.

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000
[arXiv:2403.08295; hf]
"""
from repro_torch.models.config import ModelConfig

ID = "gemma-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        head_dim=256, d_ff=24576, vocab_size=256_000,
        mlp="geglu", norm="rmsnorm", tie_embeddings=True,
        embed_scale=True,
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, param_dtype="float32",
        compute_dtype="float32", remat="none",
    )
