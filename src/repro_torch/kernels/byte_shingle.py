"""K6: byte-level tokenizing on the device, and the byte ingest chain.

``byte_token_hashes`` turns a (D, LB) uint8 matrix of UTF-8 bytes into
per-position token ids: a token is a maximal run of ASCII alphanumerics,
A-Z fold to a-z, every other byte (all bytes >= 0x80 among them) and
every position at or past the row's length is a separator.  Where a
token ends (exclusive), ``ends`` is 1 and ``tok`` holds
``hash_u32(FNV-1a of its folded bytes, id_seed)``; both are 0 elsewhere.
That is ``shingle.token_ids(shingle.tokenize(text, do_stem=False))``
position by position.  It launches the CUDA kernel
(``csrc/byte_shingle.cu``) for tensors on the card and runs
``byte_token_hashes_plain`` for tensors on the CPU.  The kernel takes
the flat matrix 16 positions a thread, with 16-byte loads and stores
where all three base pointers are 16-byte aligned and 1- and 4-byte ones
otherwise; ``schedule`` asks the library which.

``bytes_to_bands`` is the whole byte ingest: K6, a compaction of the
token ends into a dense token matrix (plain tensor code), then K1.  Its
outputs equal the host chain ``tokenize(do_stem=False)`` ->
``pack_documents`` -> ``fused_ingest`` bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.hashing import (
    FNV_OFFSET32,
    FNV_PRIME32,
    hash_u32,
    mul32,
    to_bits,
)
from repro_torch.kernels import build
from repro_torch.kernels import fused_ingest as k1

# Seed of the token-id hash (``core.shingle.token_ids``'s default).
TOKEN_SEED = 0x7045

# Kernel launches made by ``byte_token_hashes`` in this process.
launches = 0


def schedule(data: torch.Tensor, tok: torch.Tensor, ends: torch.Tensor) -> str:
    """``"vector"`` or ``"scalar"``: the path a launch over these three
    card tensors' base pointers takes (``byte_token_hashes_schedule``)."""
    s = build.library().byte_token_hashes_schedule(
        data.data_ptr(), tok.data_ptr(), ends.data_ptr())
    return "vector" if s > 0 else "scalar"


def byte_token_hashes_plain(data: torch.Tensor, lengths: torch.Tensor,
                            id_seed: int = TOKEN_SEED):
    """Plain PyTorch version: one step per byte column, carrying each
    row's FNV state and whether the previous byte was a token byte."""
    D, LB = data.shape
    b = data.to(torch.int64)
    upper = (b >= 65) & (b <= 90)
    pos = torch.arange(LB, device=data.device)[None, :]
    alnum = (upper | ((b >= 97) & (b <= 122)) | ((b >= 48) & (b <= 57))) \
        & (pos < lengths.to(torch.int64)[:, None])
    # Column-major, so each step reads contiguous memory.
    alnum = alnum.T.contiguous()
    folded = torch.where(upper, b + 32, b).T.contiguous()
    ends = torch.zeros((LB, D), dtype=torch.bool, device=data.device)
    state = torch.zeros((LB, D), dtype=torch.int64, device=data.device)
    h = torch.full((D,), FNV_OFFSET32, dtype=torch.int64, device=data.device)
    prev = torch.zeros((D,), dtype=torch.bool, device=data.device)
    for i in range(LB):
        cur = alnum[i]
        ends[i] = prev & ~cur
        state[i] = h
        h0 = torch.where(prev, h, FNV_OFFSET32)
        h = torch.where(cur, mul32(h0 ^ folded[i], FNV_PRIME32), h)
        prev = cur
    tok = torch.where(ends, hash_u32(state, id_seed), 0)
    return to_bits(tok).T.contiguous(), ends.T.to(torch.int32).contiguous()


def byte_token_hashes(data: torch.Tensor, lengths: torch.Tensor, *,
                      id_seed: int = TOKEN_SEED):
    """(D, LB) uint8 bytes, (D,) int32 byte lengths ->
    ((D, LB) int32 token-id words, (D, LB) int32 token ends).

    A token touching the last column has no column to end in, so
    callers keep the width above every length (``shingle.pack_bytes``
    does; ``bytes_to_bands`` pads one more column).
    """
    global launches
    if data.dim() != 2 or lengths.shape != (data.shape[0],):
        raise ValueError(f"bad shapes: data {tuple(data.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if data.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError(f"need uint8 data and int32 lengths, got "
                        f"{data.dtype} and {lengths.dtype}")
    if lengths.device != data.device:
        raise ValueError(f"lengths is on {lengths.device}, data on "
                         f"{data.device}")
    if data.device.type == "cpu":
        return byte_token_hashes_plain(data, lengths, id_seed)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    D, LB = data.shape
    data, lengths = data.contiguous(), lengths.contiguous()
    tok = torch.empty((D, LB), dtype=torch.int32, device=data.device)
    ends = torch.empty((D, LB), dtype=torch.int32, device=data.device)
    if D == 0 or LB == 0:
        return tok, ends
    lib = build.library()
    with torch.cuda.device(data.device):
        code = lib.byte_token_hashes_launch(
            data.data_ptr(), lengths.data_ptr(), tok.data_ptr(),
            ends.data_ptr(), D, LB, id_seed & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "byte_token_hashes")
    launches += 1
    return tok, ends


def compact_tokens(tok: torch.Tensor, ends: torch.Tensor, width: int):
    """Per-position token ids -> ((D, width) token matrix, (D,) counts).

    Row d's ids, in order, fill the first ``counts[d]`` columns; the
    rest stay zero, since K1 reads the matrix past a row's length.
    ``width`` must hold every row's tokens.
    """
    D = tok.shape[0]
    counts = ends.sum(dim=1, dtype=torch.int32)
    tokens = torch.zeros((D, width), dtype=torch.int32, device=tok.device)
    # nonzero lists the ends row by row, left to right, so an end's
    # column in the token matrix is its place in that list less the
    # number of ends in the rows above.
    row, col = ends.nonzero(as_tuple=True)
    above = torch.cumsum(counts, dim=0) - counts
    dst = torch.arange(row.shape[0], device=tok.device) - above[row]
    tokens[row, dst] = tok[row, col]
    return tokens, counts


def bytes_to_bands(data: torch.Tensor, lengths: torch.Tensor,
                   seeds: torch.Tensor, *, n: int = 8, r: int = 2,
                   id_seed: int = TOKEN_SEED):
    """(D, LB) uint8 bytes, (D,) int32 byte lengths, (M,) int32 seed words
    -> ((D, M) signatures, (D, M // r, 2) band values, (D,) token counts).

    Callers pass ``pow2_bucket`` widths (``shingle.pack_bytes``), so the
    token matrix's width, derived from LB, takes few values as well.
    """
    D, LB = data.shape
    M = seeds.shape[0]
    if M < 1 or r < 1 or M % r:
        raise ValueError(f"M={M} not divisible by r={r}")
    if D == 0:
        dev = data.device
        return (torch.zeros((0, M), dtype=torch.int32, device=dev),
                torch.zeros((0, M // r, 2), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    # One zero column, so a token ending at the last byte of a full
    # row still ends (a position past the length is a separator).
    buf = F.pad(data, (0, 1))
    tok, ends = byte_token_hashes(buf, lengths, id_seed=id_seed)
    # Token ends are at least two bytes apart, so (LB + 1) // 2 columns
    # hold every row's tokens; the width follows the bucketed LB.
    lt_bucket = (LB + 1) // 2 + 1
    tokens, counts = compact_tokens(tok, ends, lt_bucket)
    sig, bands, _ = k1.fused_ingest(tokens, counts, seeds, n=n, r=r)
    return sig, bands, counts
