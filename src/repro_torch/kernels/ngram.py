"""K3: rolling n-gram hashes of a packed token matrix, and their validity.

``ngram_hashes`` launches the CUDA kernel (``csrc/ngram.cu``) for the
hashes of tensors on the card and runs ``ngram_hashes_plain``
(``core.shingle.ngram_hashes``) for tensors on the CPU; validity is
plain tensor code (``core.shingle.ngram_valid``) either way.  A window
running past column L reads zeros in both.  (The Pallas kernel's halo
is clamped at its last tile, so its hashes differ there; those
positions are never valid.)
"""
from __future__ import annotations

import torch

from repro_torch.core.shingle import ngram_hashes as ngram_hashes_plain
from repro_torch.core.shingle import ngram_valid
from repro_torch.kernels import build

# Kernel launches made by ``ngram_hashes`` in this process.
launches = 0


def ngram_hashes(tokens: torch.Tensor, lengths: torch.Tensor, n: int = 8):
    """(D, L) int32 token words, (D,) int32 lengths ->
    ((D, L) int32 hash words, (D, L) bool validity)."""
    global launches
    if tokens.dim() != 2 or lengths.shape != (tokens.shape[0],):
        raise ValueError(f"bad shapes: tokens {tuple(tokens.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    for name, t in (("tokens", tokens), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != tokens.device:
            raise ValueError(f"{name} is on {t.device}, tokens on "
                             f"{tokens.device}")
    D, L = tokens.shape
    if L < 1 or n < 1:
        raise ValueError(f"need L, n >= 1 (L={L}, n={n})")
    if tokens.device.type == "cpu":
        return ngram_hashes_plain(tokens, lengths, n=n)
    if tokens.device.type != "cuda":
        raise ValueError(f"no kernel for device {tokens.device}")
    tokens = tokens.contiguous()
    hashes = torch.empty((D, L), dtype=torch.int32, device=tokens.device)
    if D > 0:
        lib = build.library()
        with torch.cuda.device(tokens.device):
            code = lib.ngram_hashes_launch(
                tokens.data_ptr(), hashes.data_ptr(), D, L, n,
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(code, "ngram_hashes")
        launches += 1
    return hashes, ngram_valid(lengths, L, n)
