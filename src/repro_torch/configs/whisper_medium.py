"""whisper-medium [audio] — encoder-decoder, conv frontend STUBBED.

24L enc + 24L dec, d_model=1024 16H d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified].  input_specs() supplies precomputed frame
embeddings (the assignment's stub-frontend rule); seq_len cells size the
ENCODER, the decoder runs at dec_len=448 (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

ID = "whisper-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51_865,
        mlp="gelu", norm="layernorm", encdec=True, n_dec_layers=24,
        dec_len=448, tie_embeddings=True,
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().with_(
        n_layers=2, n_dec_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, dec_len=8,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
