"""zamba2-2.7b [hybrid] — Mamba2 stack + shared attention block.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  The shared transformer block (one set of weights)
is applied every 6 mamba layers (9 applications); Zamba2's
concat-with-embedding input to the shared block is simplified to the
running hidden state (noted in DESIGN.md).  Hybrid => runs long_500k with
a sequence-sharded KV cache for the shared block.
"""
from repro_torch.models.config import ModelConfig, SSMCfg

ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab_size=32_000,
        ssm=SSMCfg(d_state=64, expand=2, head_dim=64, n_groups=1,
                   chunk=128),
        shared_every=6,
        mlp="swiglu", norm="rmsnorm", tie_embeddings=True,
        subquadratic=True,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=4, shared_every=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm=SSMCfg(d_state=8, expand=2, head_dim=8, n_groups=1, chunk=8),
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
