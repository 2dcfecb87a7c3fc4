"""The kernels' public wrappers under ``repro.kernels.ops``'s names.

Each wrapper launches its CUDA kernel for tensors on the card and runs
its plain PyTorch version for tensors on the CPU.  K2 returns agreement
counts (``pair_counts``); ``indexed_pair_estimate`` divides them by M,
correctly rounded.  K7's two forms (``masked_indexed_pair_counts``,
``masked_pair_counts``) return int32 counts as well, and
``masked_indexed_pair_estimate`` divides them by M, and
``pair_estimate`` (the pre-gathered estimate) divides K7's pre-gathered
counts with every lane valid.  ``flash_attention`` is K8.
"""
from __future__ import annotations

from repro_torch.kernels.bandfold import band_values
from repro_torch.kernels.byte_shingle import byte_token_hashes, bytes_to_bands
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_ingest import fused_ingest
from repro_torch.kernels.minhash import minhash_signatures
from repro_torch.kernels.ngram import ngram_hashes
from repro_torch.kernels.sigjaccard import (
    indexed_pair_estimate,
    masked_indexed_pair_counts,
    masked_indexed_pair_estimate,
    masked_pair_counts,
    pair_counts,
    pair_estimate,
)

__all__ = [
    "minhash_signatures",
    "ngram_hashes",
    "band_values",
    "fused_ingest",
    "byte_token_hashes",
    "bytes_to_bands",
    "pair_counts",
    "pair_estimate",
    "indexed_pair_estimate",
    "masked_indexed_pair_counts",
    "masked_indexed_pair_estimate",
    "masked_pair_counts",
    "flash_attention",
]
