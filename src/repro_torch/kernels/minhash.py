"""K4: minhash signatures of n-gram hashes under any validity mask.

``minhash_signatures`` launches the CUDA kernel (``csrc/minhash.cu``) for
tensors on the card and runs ``minhash_signatures_plain``
(``core.minhash.signatures``) for tensors on the CPU.  A row with no
valid position gets 0xFFFFFFFF in every entry.
"""
from __future__ import annotations

import torch

from repro_torch.core.minhash import signatures as minhash_signatures_plain
from repro_torch.kernels import build

# Kernel launches made by ``minhash_signatures`` in this process.
launches = 0


def minhash_signatures(ngrams: torch.Tensor, valid: torch.Tensor,
                       seeds: torch.Tensor) -> torch.Tensor:
    """(D, L) int32 hash words, (D, L) bool mask, (M,) int32 seed words ->
    (D, M) int32 signature words."""
    global launches
    if ngrams.dim() != 2 or valid.shape != ngrams.shape or seeds.dim() != 1:
        raise ValueError(f"bad shapes: ngrams {tuple(ngrams.shape)}, valid "
                         f"{tuple(valid.shape)}, seeds {tuple(seeds.shape)}")
    for name, t, dtype in (("ngrams", ngrams, torch.int32),
                           ("valid", valid, torch.bool),
                           ("seeds", seeds, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != ngrams.device:
            raise ValueError(f"{name} is on {t.device}, ngrams on "
                             f"{ngrams.device}")
    D, L = ngrams.shape
    M = seeds.shape[0]
    if L < 1 or M < 1:
        raise ValueError(f"need L, M >= 1 (L={L}, M={M})")
    if ngrams.device.type == "cpu":
        return minhash_signatures_plain(ngrams, valid, seeds)
    if ngrams.device.type != "cuda":
        raise ValueError(f"no kernel for device {ngrams.device}")
    ngrams, valid, seeds = (t.contiguous() for t in (ngrams, valid, seeds))
    sig = torch.empty((D, M), dtype=torch.int32, device=ngrams.device)
    if D == 0:
        return sig
    lib = build.library()
    with torch.cuda.device(ngrams.device):
        code = lib.minhash_launch(
            ngrams.data_ptr(), valid.data_ptr(), seeds.data_ptr(),
            sig.data_ptr(), D, L, M, torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "minhash_signatures")
    launches += 1
    return sig
