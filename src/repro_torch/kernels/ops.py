"""The kernels' public wrappers under ``repro.kernels.ops``'s names.

Each wrapper launches its CUDA kernel for tensors on the card and runs
its plain PyTorch version for tensors on the CPU.  K2 returns agreement
counts (``pair_counts``); ``indexed_pair_estimate`` divides them by M,
correctly rounded.  The reference's masked pair counts (K7) and flash
attention (K8) are not ported yet.
"""
from __future__ import annotations

from repro_torch.kernels.bandfold import band_values
from repro_torch.kernels.byte_shingle import byte_token_hashes, bytes_to_bands
from repro_torch.kernels.fused_ingest import fused_ingest
from repro_torch.kernels.minhash import minhash_signatures
from repro_torch.kernels.ngram import ngram_hashes
from repro_torch.kernels.sigjaccard import indexed_pair_estimate, pair_counts

__all__ = [
    "minhash_signatures",
    "ngram_hashes",
    "band_values",
    "fused_ingest",
    "byte_token_hashes",
    "bytes_to_bands",
    "pair_counts",
    "indexed_pair_estimate",
]
