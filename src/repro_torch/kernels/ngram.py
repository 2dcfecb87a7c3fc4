"""K3: rolling n-gram hashes of a packed token matrix, and their validity.

``ngram_hashes`` launches the CUDA kernel (``csrc/ngram.cu``) for tensors
on the card, hashes and validity in one pass, and runs
``ngram_hashes_plain`` (``core.shingle.ngram_hashes``) for tensors on the
CPU.  A window running past column L reads zeros in both.  (The Pallas
kernel's halo is clamped at its last tile, so its hashes differ there;
those positions are never valid.)

The kernel walks the flat matrix in quads of positions, with 16-byte
loads and stores where L % 4 == 0 and the bases are aligned, and 4-byte
ones otherwise; ``schedule`` asks the library which.
"""
from __future__ import annotations

import torch

from repro_torch.core.shingle import ngram_hashes as ngram_hashes_plain
from repro_torch.kernels import build

# Kernel launches made by ``ngram_hashes`` in this process.
launches = 0


def schedule(tokens: torch.Tensor, hashes: torch.Tensor,
             valid: torch.Tensor) -> str:
    """``"vector"`` or ``"scalar"``: the path a launch over these three
    (D, L) card tensors takes (``ngram_hashes_schedule``)."""
    s = build.library().ngram_hashes_schedule(
        tokens.data_ptr(), hashes.data_ptr(), valid.data_ptr(),
        tokens.shape[1])
    return "vector" if s > 0 else "scalar"


def ngram_hashes(tokens: torch.Tensor, lengths: torch.Tensor, n: int = 8):
    """(D, L) int32 token words, (D,) int32 lengths ->
    ((D, L) int32 hash words, (D, L) bool validity)."""
    global launches
    if tokens.dim() != 2 or lengths.shape != (tokens.shape[0],):
        raise ValueError(f"bad shapes: tokens {tuple(tokens.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if tokens.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"need int32 tokens and lengths, got {tokens.dtype} "
                        f"and {lengths.dtype}")
    device = tokens.device
    if lengths.device != device:
        raise ValueError(f"lengths is on {lengths.device}, tokens on {device}")
    D, L = tokens.shape
    if L < 1 or n < 1:
        raise ValueError(f"need L, n >= 1 (L={L}, n={n})")
    if device.type == "cpu":
        return ngram_hashes_plain(tokens, lengths, n=n)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    tokens, lengths = tokens.contiguous(), lengths.contiguous()
    hashes = torch.empty((D, L), dtype=torch.int32, device=device)
    valid = torch.empty((D, L), dtype=torch.bool, device=device)
    if D > 0:
        build.launch("ngram_hashes_launch", device, tokens.data_ptr(),
                     lengths.data_ptr(), hashes.data_ptr(), valid.data_ptr(),
                     D, L, n)
        launches += 1
    return hashes, valid
