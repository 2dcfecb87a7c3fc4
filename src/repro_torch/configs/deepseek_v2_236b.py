"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff=1536(expert) vocab=102400 [arXiv:2405.04434; hf]
~236B total / ~21B active.
"""
from repro_torch.models.config import MLACfg, ModelConfig, MoECfg

ID = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab_size=102_400,
        mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536,
                   nope_head_dim=128, rope_head_dim=64, v_head_dim=128),
        moe=MoECfg(n_experts=160, top_k=6, n_shared=2, d_expert=1536),
        mlp="swiglu", norm="rmsnorm", tie_embeddings=False,
        opt_moments_dtype="int8",   # 236B: fp32 moments would not fit
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab_size=256,
        mla=MLACfg(kv_lora_rank=16, q_lora_rank=24, nope_head_dim=8,
                   rope_head_dim=4, v_head_dim=8),
        moe=MoECfg(n_experts=8, top_k=2, n_shared=2, d_expert=32),
        param_dtype="float32", compute_dtype="float32", remat="none",
        opt_moments_dtype="float32",
    )
