"""K5: the band fold -- (D, M) signatures to (D, M/r, 2) band values.

``band_values`` launches the CUDA kernel (``csrc/bandfold.cu``) for
tensors on the card and runs ``band_values_plain``
(``core.lsh.band_values``) for tensors on the CPU.  ``DedupSession.refine``
calls it with ``config.use_kernels`` to re-band the representatives'
retained signature rows; it is also reached through ``kernels.ops``.  No
configuration of ``DedupPipeline.run`` calls it (K1 folds in its own
pass, and the staged path folds with ``core.lsh``, as the reference
does).
"""
from __future__ import annotations

import torch

from repro_torch.core.lsh import band_values as band_values_plain
from repro_torch.kernels import build

# Kernel launches made by ``band_values`` in this process.
launches = 0


def band_values(sig: torch.Tensor, r: int) -> torch.Tensor:
    """(D, M) int32 signature words -> (D, M // r, 2) int32 band words.

    Raises ``ValueError`` unless r divides M.
    """
    global launches
    if sig.dim() != 2 or sig.dtype != torch.int32:
        raise TypeError(f"sig must be a 2-D int32 tensor, got "
                        f"{sig.dtype} {tuple(sig.shape)}")
    D, M = sig.shape
    if r < 1 or M < 1 or M % r:
        raise ValueError(f"M={M} not divisible by r={r}")
    if sig.device.type == "cpu":
        return band_values_plain(sig, r)
    if sig.device.type != "cuda":
        raise ValueError(f"no kernel for device {sig.device}")
    sig = sig.contiguous()
    bands = torch.empty((D, M // r, 2), dtype=torch.int32, device=sig.device)
    if D == 0:
        return bands
    lib = build.library()
    with torch.cuda.device(sig.device):
        code = lib.band_values_launch(
            sig.data_ptr(), bands.data_ptr(), D, M, r,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "band_values")
    launches += 1
    return bands
