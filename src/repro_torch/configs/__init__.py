"""Architecture registry (port of ``repro.configs``).

``get_config(arch_id)`` / ``get_reduced(arch_id)`` resolve the 10
architectures, each module holding the same ``ID``, ``config()`` and
``reduced()`` as the reference's.  The dry-run's ``input_specs`` and
``cache_specs`` are not ported yet (ROADMAP.md, queue 1: the model and
training stack).
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_236b, gemma_7b, h2o_danube, internvl2_2b, llama4_maverick,
    mamba2_780m, olmo_1b, phi3_medium, whisper_medium, zamba2_2p7b,
)
from repro_torch.core.dist_lsh import DistLSHConfig
from repro_torch.core.pipeline import DedupConfig
from repro_torch.models.config import ModelConfig

_MODULES = [
    deepseek_v2_236b, llama4_maverick, phi3_medium, olmo_1b, h2o_danube,
    gemma_7b, whisper_medium, zamba2_2p7b, mamba2_780m, internvl2_2b,
]

REGISTRY = {m.ID: m for m in _MODULES}
ARCH_IDS = list(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    return REGISTRY[arch_id].config()


def get_reduced(arch_id: str) -> ModelConfig:
    return REGISTRY[arch_id].reduced()


def paper_dedup_config() -> DedupConfig:
    """Paper §7/§9 defaults: n=8, M=100, r=2, b=50, thresholds 75/40."""
    return DedupConfig()


def paper_dist_lsh_config() -> DistLSHConfig:
    return DistLSHConfig()


__all__ = [
    "REGISTRY", "ARCH_IDS", "get_config", "get_reduced",
    "paper_dedup_config", "paper_dist_lsh_config",
]
