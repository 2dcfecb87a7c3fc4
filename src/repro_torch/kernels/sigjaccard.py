"""K2: pair agreement counts -- gather two signature rows, count agreements.

``pair_counts(sig, a_idx, b_idx)`` returns, for each pair p, the number
of m with ``sig[a_idx[p], m] == sig[b_idx[p], m]`` as int32.  It launches
the CUDA kernel (``csrc/sigjaccard.cu``) for tensors on the card and runs
``pair_counts_plain`` for tensors on the CPU.  The Jaccard estimate,
``indexed_pair_estimate``, is ``minhash.estimate_from_counts(counts, M)``,
divided in PyTorch and correctly rounded.
"""
from __future__ import annotations

import torch

from repro_torch.core.minhash import estimate_from_counts
from repro_torch.kernels import build

# Kernel launches made by ``pair_counts`` in this process.
launches = 0


def pair_counts_plain(sig: torch.Tensor, a_idx: torch.Tensor,
                      b_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather both rows, compare, sum."""
    return (sig[a_idx] == sig[b_idx]).sum(dim=-1, dtype=torch.int32)


def pair_counts(sig: torch.Tensor, a_idx: torch.Tensor,
                b_idx: torch.Tensor) -> torch.Tensor:
    """(D, M) int32 words, (P,) int64 row indices x2 -> (P,) int32 counts.

    Every index must lie in [0, D): the kernel does not check them, so
    callers do (``verify.SignatureVerifier`` does, on the host).
    """
    global launches
    if sig.dim() != 2 or sig.dtype != torch.int32:
        raise TypeError(f"sig must be a 2-D int32 tensor, got "
                        f"{sig.dtype} {tuple(sig.shape)}")
    if a_idx.shape != b_idx.shape or a_idx.dim() != 1:
        raise ValueError(f"index shapes differ or are not 1-D: "
                         f"{tuple(a_idx.shape)} vs {tuple(b_idx.shape)}")
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
        if t.device != sig.device:
            raise ValueError(f"{name} is on {t.device}, sig on {sig.device}")
    D, M = sig.shape
    if D < 1 or M < 1:
        raise ValueError(f"sig must have rows and columns, got {(D, M)}")
    if sig.device.type == "cpu":
        return pair_counts_plain(sig, a_idx, b_idx)
    if sig.device.type != "cuda":
        raise ValueError(f"no kernel for device {sig.device}")
    sig, a_idx, b_idx = sig.contiguous(), a_idx.contiguous(), b_idx.contiguous()
    P = a_idx.shape[0]
    counts = torch.empty((P,), dtype=torch.int32, device=sig.device)
    if P == 0:
        return counts
    lib = build.library()
    with torch.cuda.device(sig.device):
        code = lib.pair_counts_launch(
            sig.data_ptr(), D, M, a_idx.data_ptr(), b_idx.data_ptr(), P,
            counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "pair_counts")
    launches += 1
    return counts


def indexed_pair_estimate(sig: torch.Tensor, a_idx: torch.Tensor,
                          b_idx: torch.Tensor) -> torch.Tensor:
    """(P,) float32 Jaccard estimates: ``pair_counts`` / M, correctly rounded."""
    return estimate_from_counts(pair_counts(sig, a_idx, b_idx), sig.shape[1])
