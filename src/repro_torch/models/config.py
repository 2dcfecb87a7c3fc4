"""Model configuration schema (port of ``repro.models.config``).

The same dataclasses, fields and defaults as the reference, so that a
configuration reads the same in both packages; ``pdtype`` and ``cdtype``
return torch dtypes.  The dry-run's shape cells (``ShapeCell``,
``SHAPE_CELLS``, ``cell_applicable``) are not ported yet (ROADMAP.md,
queue 1: the model and training stack).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # expert hidden dim (per expert)
    every: int = 1               # MoE layer every k-th layer (llama4: 2)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    lb_coef: float = 1e-2


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536      # 0 => dense q projection
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128             # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // n_heads
    mlp: str = "swiglu"          # swiglu | geglu | none
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid (zamba2): shared attention block applied every `shared_every`
    # ssm layers; 0 disables.
    shared_every: int = 0
    # enc-dec (whisper)
    encdec: bool = False
    n_dec_layers: int = 0
    dec_len: int = 448
    # vlm: number of stub image patches prepended to the text sequence
    n_patches: int = 0
    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma: scale embeddings by sqrt(d)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # attention implementation: PyTorch blockwise (runs anywhere) or the
    # CUDA flash kernel K8 (its plain version on the CPU)
    use_flash_attention: bool = False
    # training policy
    remat: str = "full"          # full | dots | none
    scan_layers: bool = True
    opt_moments_dtype: str = "float32"   # float32 | int8
    # long-context serving
    subquadratic: bool = False   # True => may run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
