"""K4: minhash signatures of n-gram hashes under any validity mask.

``minhash_signatures`` launches the CUDA kernel (``csrc/minhash.cu``) for
tensors on the card and runs ``minhash_signatures_plain``
(``core.minhash.signatures``) for tensors on the CPU.  A row with no
valid position gets 0xFFFFFFFF in every entry.

The kernel's min loop is K1's (``csrc/minhash_pool_common.cuh``): a lane
keeps S seeds in registers, ``lanes`` = ceil(M / S) lanes cover the seeds
(in ``passes`` rounds where that exceeds the block), and ``slices``
groups of lanes share a pool of hashes of the block's ``docs`` rows,
rounds of ``tile`` columns at a time.  K4 fills that pool by compacting
each row's valid hashes.  ``schedule`` asks the library for the map,
keyed as ``fused_ingest.schedule``; ``path`` for the loads it takes
(16-byte where L % 4 == 0 and the bases are aligned, else 4-byte).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.minhash import signatures as minhash_signatures_plain
from repro_torch.kernels import build
from repro_torch.kernels import fused_ingest as k1

# Kernel launches made by ``minhash_signatures`` in this process.
launches = 0


def schedule(M: int, L: int) -> dict:
    """The lane map the built kernel takes for rows of L positions and M
    seeds (``minhash_schedule``), keyed by ``fused_ingest.MAP_KEYS``."""
    out = (ctypes.c_int32 * len(k1.MAP_KEYS))()
    build.check_launch(build.library().minhash_schedule(
        M, L, ctypes.addressof(out)), "minhash_schedule")
    return dict(zip(k1.MAP_KEYS, out))


def path(ngrams: torch.Tensor, valid: torch.Tensor) -> str:
    """``"vector"`` or ``"scalar"``: the loads a launch over these two
    (D, L) card tensors takes (``minhash_path``)."""
    s = build.library().minhash_path(ngrams.data_ptr(), valid.data_ptr(),
                                     ngrams.shape[1])
    return "vector" if s > 0 else "scalar"


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
    build.launch("minhash_launch", ngrams.device, ngrams.data_ptr(),
                 valid.data_ptr(), seeds.data_ptr(), sig.data_ptr(), D, L, M)
    launches += 1
    return sig
