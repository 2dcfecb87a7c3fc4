"""internvl2-2b [vlm] — InternViT (STUB) + InternLM2-1.8b backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf].  input_specs() supplies 256 precomputed patch
embeddings (stub InternViT) prepended to the text sequence; loss masks
patch positions.
"""
from repro_torch.models.config import ModelConfig

ID = "internvl2-2b"

N_PATCHES = 256


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="vlm",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab_size=92_553, n_patches=N_PATCHES,
        mlp="swiglu", norm="rmsnorm", tie_embeddings=True,
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, n_patches=4,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
