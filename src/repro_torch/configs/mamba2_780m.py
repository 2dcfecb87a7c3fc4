"""mamba2-780m [ssm] — attention-free, SSD (state-space duality).

48L d_model=1536 vocab=50280 ssm_state=128, no MLP
[arXiv:2405.21060; unverified].  O(1)-state decode => runs long_500k.
"""
from repro_torch.models.config import ModelConfig, SSMCfg

ID = "mamba2-780m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="ssm",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,  # unused
        d_ff=0, vocab_size=50_280,
        ssm=SSMCfg(d_state=128, expand=2, head_dim=64, n_groups=1,
                   chunk=128),
        mlp="none", norm="rmsnorm", tie_embeddings=True,
        subquadratic=True,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, vocab_size=256,
        ssm=SSMCfg(d_state=16, expand=2, head_dim=8, n_groups=1, chunk=8),
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
