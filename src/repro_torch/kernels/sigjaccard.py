"""K2 and K7: pair agreement counts -- compare two signature rows per pair.

K2, ``pair_counts(sig, a_idx, b_idx)``, returns for each pair p the
number of m with ``sig[a_idx[p], m] == sig[b_idx[p], m]`` as int32.  It
launches the CUDA kernel (``csrc/sigjaccard.cu``) for tensors on the card
and runs ``pair_counts_plain`` for tensors on the CPU.  The Jaccard
estimate, ``indexed_pair_estimate``, is
``minhash.estimate_from_counts(counts, M)``, divided in PyTorch and
correctly rounded.

K7 (``csrc/sigjaccard_masked.cu``) is the masked form that the sharded
step's device-resident stage 2 runs: the count where ``valid[p]`` is set
and 0 elsewhere.  ``masked_indexed_pair_counts`` gathers rows of one
matrix after clipping both indices to [0, D - 1];
``masked_pair_counts`` takes two pre-gathered (P, M) row matrices.  Like
K2, each launches its kernel for tensors on the card and runs its
``*_plain`` version for tensors on the CPU.  ``pair_estimate``, the
reference's pre-gathered estimate, is K7's pre-gathered counts with every
lane valid, divided by M in PyTorch.

All three launchers run one lane-group body (``csrc/pair_counts_common.cuh``):
G lanes a pair (``lane_group`` there), 16-byte loads where M % 4 == 0 and
the rows' bases are 16-byte aligned, else 4-byte loads in the same lane
map.  ``schedule`` asks the library which of the two a launch takes.
"""
from __future__ import annotations

import torch

from repro_torch.core.minhash import estimate_from_counts
from repro_torch.kernels import build

# Kernel launches made by ``pair_counts`` (K2) in this process.
launches = 0
# Kernel launches made by the two masked forms (K7) in this process.
masked_launches = 0


def schedule(M: int, a: torch.Tensor, b: torch.Tensor) -> tuple[int, str]:
    """(G, ``"vector"`` or ``"scalar"``): what a launch over rows of M
    words whose bases are ``a`` and ``b`` (card tensors) runs, as the
    library's launchers decide it."""
    s = build.library().pair_counts_schedule(M, a.data_ptr(), b.data_ptr())
    return abs(s), "vector" if s > 0 else "scalar"


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
    build.launch("pair_counts_launch", sig.device, sig.data_ptr(), D, M,
                 a_idx.data_ptr(), b_idx.data_ptr(), P, counts.data_ptr())
    launches += 1
    return counts


def indexed_pair_estimate(sig: torch.Tensor, a_idx: torch.Tensor,
                          b_idx: torch.Tensor) -> torch.Tensor:
    """(P,) float32 Jaccard estimates: ``pair_counts`` / M, correctly rounded."""
    return estimate_from_counts(pair_counts(sig, a_idx, b_idx), sig.shape[1])


def masked_indexed_pair_counts_plain(sig: torch.Tensor, a_idx: torch.Tensor,
                                     b_idx: torch.Tensor,
                                     valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clip, gather both rows, compare, sum, mask."""
    D = sig.shape[0]
    a = a_idx.to(torch.int64).clamp(0, D - 1)
    b = b_idx.to(torch.int64).clamp(0, D - 1)
    return masked_pair_counts_plain(sig[a], sig[b], valid)


def masked_pair_counts_plain(sig_a: torch.Tensor, sig_b: torch.Tensor,
                             valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: compare, sum, mask."""
    counts = (sig_a == sig_b).sum(dim=-1, dtype=torch.int32)
    return torch.where(valid, counts, 0)


def _check_lanes(P: int, device, **lanes) -> None:
    """Shapes, types and devices of the per-pair inputs of K7."""
    for name, (t, dtype) in lanes.items():
        if t.dtype != dtype or t.shape != (P,):
            raise TypeError(f"{name} must be a ({P},) {dtype} tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, rows on {device}")


def _launch_masked(fn_name: str, device, *args) -> None:
    global masked_launches
    build.launch(fn_name, device, *args)
    masked_launches += 1


def masked_indexed_pair_counts(sig: torch.Tensor, a_idx: torch.Tensor,
                               b_idx: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """(D, M) int32 words, (P,) int32 indices x2, (P,) bool ->
    (P,) int32 agreement counts where ``valid``, 0 elsewhere.

    Both indices are clipped to [0, D - 1] for every lane, so a valid
    lane whose index lies outside the matrix gets the clipped row's
    count; rows of lanes that are not valid are never read.
    """
    if sig.dim() != 2 or sig.dtype != torch.int32:
        raise TypeError(f"sig must be a 2-D int32 tensor, got "
                        f"{sig.dtype} {tuple(sig.shape)}")
    if a_idx.dim() != 1:
        raise ValueError(f"a_idx must be 1-D, got {tuple(a_idx.shape)}")
    P = a_idx.shape[0]
    _check_lanes(P, sig.device, a_idx=(a_idx, torch.int32),
                 b_idx=(b_idx, torch.int32), valid=(valid, torch.bool))
    D, M = sig.shape
    if D < 1 or M < 1:
        raise ValueError(f"sig must have rows and columns, got {(D, M)}")
    if sig.device.type == "cpu":
        return masked_indexed_pair_counts_plain(sig, a_idx, b_idx, valid)
    if sig.device.type != "cuda":
        raise ValueError(f"no kernel for device {sig.device}")
    sig, a_idx, b_idx, valid = (t.contiguous()
                                for t in (sig, a_idx, b_idx, valid))
    counts = torch.empty((P,), dtype=torch.int32, device=sig.device)
    if P == 0:
        return counts
    _launch_masked("masked_indexed_pair_counts_launch", sig.device,
                   sig.data_ptr(), D, M, a_idx.data_ptr(), b_idx.data_ptr(),
                   valid.data_ptr(), P, counts.data_ptr())
    return counts


def masked_pair_counts(sig_a: torch.Tensor, sig_b: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """(P, M) int32 words x2, (P,) bool -> (P,) int32 agreement counts
    where ``valid``, 0 elsewhere.  Rows of lanes that are not valid are
    never read."""
    if sig_a.dim() != 2 or sig_a.dtype != torch.int32 \
            or sig_b.dtype != torch.int32 or sig_b.shape != sig_a.shape:
        raise TypeError(f"sig_a and sig_b must be (P, M) int32 tensors, got "
                        f"{sig_a.dtype} {tuple(sig_a.shape)} and "
                        f"{sig_b.dtype} {tuple(sig_b.shape)}")
    if sig_b.device != sig_a.device:
        raise ValueError(f"sig_b is on {sig_b.device}, sig_a on {sig_a.device}")
    P, M = sig_a.shape
    _check_lanes(P, sig_a.device, valid=(valid, torch.bool))
    if M < 1:
        raise ValueError(f"rows must have M >= 1 words, got M = {M}")
    if sig_a.device.type == "cpu":
        return masked_pair_counts_plain(sig_a, sig_b, valid)
    if sig_a.device.type != "cuda":
        raise ValueError(f"no kernel for device {sig_a.device}")
    sig_a, sig_b, valid = (t.contiguous() for t in (sig_a, sig_b, valid))
    counts = torch.empty((P,), dtype=torch.int32, device=sig_a.device)
    if P == 0:
        return counts
    _launch_masked("masked_pair_counts_launch", sig_a.device,
                   sig_a.data_ptr(), sig_b.data_ptr(), M, valid.data_ptr(), P,
                   counts.data_ptr())
    return counts


def masked_indexed_pair_estimate(sig: torch.Tensor, a_idx: torch.Tensor,
                                 b_idx: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """(P,) float32: ``masked_indexed_pair_counts`` / M, correctly rounded
    (0.0 where not ``valid``)."""
    return estimate_from_counts(
        masked_indexed_pair_counts(sig, a_idx, b_idx, valid), sig.shape[1])


def pair_estimate(sig_a: torch.Tensor, sig_b: torch.Tensor) -> torch.Tensor:
    """(P, M) int32 words x2 -> (P,) float32 agreement fraction: K7's
    pre-gathered counts with every lane valid / M, correctly rounded."""
    valid = torch.ones(sig_a.shape[:1], dtype=torch.bool, device=sig_a.device)
    return estimate_from_counts(masked_pair_counts(sig_a, sig_b, valid),
                                sig_a.shape[1])
