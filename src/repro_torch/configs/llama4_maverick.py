"""llama4-maverick-400b-a17b [moe] — MoE top-1 + shared, alternating layers.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128 experts top-1
[hf:meta-llama/Llama-4-*; unverified].  Early fusion: multimodal tokens
share the text embedding space — modality frontends are out of scope
(text path only; see DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig, MoECfg

ID = "llama4-maverick-400b-a17b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202_048,
        moe=MoECfg(n_experts=128, top_k=1, n_shared=1, d_expert=8192,
                   every=2),
        mlp="swiglu", norm="rmsnorm", tie_embeddings=False,
        opt_moments_dtype="int8",
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256,
        moe=MoECfg(n_experts=4, top_k=1, n_shared=1, d_expert=64, every=2),
        param_dtype="float32", compute_dtype="float32", remat="none",
        opt_moments_dtype="float32",
    )
