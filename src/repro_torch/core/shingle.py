"""Shingling: documents -> word n-gram hashes (port of ``repro.core.shingle``).

Host side: text -> stemmed word tokens -> uint32 token ids (a hash
vocabulary) -> a zero-padded token-id matrix; or, for byte ingest, text
-> a zero-padded UTF-8 byte matrix (``pack_bytes``), tokenized on the
device by ``kernels.byte_shingle``.  Tensor side: the padded matrix ->
rolling polynomial n-gram hashes and their validity.

The paper uses word 8-grams with stemming; the stemmer is a light
suffix stripper that equates inflected forms.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.hashing import (
    FNV_OFFSET32,
    FNV_PRIME32,
    MASK32,
    NGRAM_BASE,
    as_u32,
    fmix32,
    hash_u32,
    mul32,
    to_bits,
)

_WORD_RE = re.compile(r"[A-Za-z0-9]+")

_SUFFIXES = (
    "ational", "iveness", "fulness", "ousness",
    "ication", "izations", "ization",
    "ingly", "edly", "ings",
    "ing", "ies", "ied", "ely", "es", "ed", "ly", "s",
)


def stem(word: str) -> str:
    """Suffix-strip stemmer (keeps >=3 chars of stem)."""
    w = word.lower()
    for suf in _SUFFIXES:
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def tokenize(text: str, do_stem: bool = True) -> list[str]:
    toks = _WORD_RE.findall(text)
    if do_stem:
        return [stem(t) for t in toks]
    return [t.lower() for t in toks]


def token_ids(tokens: list[str], seed: int = 0x7045) -> np.ndarray:
    """Hash words to uint32 ids: FNV-1a over UTF-8, then ``hash_u32``."""
    out = np.empty(len(tokens), dtype=np.int64)
    for i, t in enumerate(tokens):
        h = FNV_OFFSET32
        for ch in t.encode("utf-8"):
            h = ((h ^ ch) * FNV_PRIME32) & MASK32
        out[i] = h
    if len(tokens):
        out = hash_u32(torch.from_numpy(out), seed).numpy()
    return out.astype(np.uint32)


def ngram_set(tokens: list[str], n: int = 8) -> set[tuple[str, ...]]:
    """Exact n-gram set (oracle for exact Jaccard)."""
    if len(tokens) < n:
        return {tuple(tokens)} if tokens else set()
    return {tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)}


@dataclass(frozen=True)
class PackedDocs:
    """A batch of documents as a padded token-id matrix."""

    tokens: np.ndarray  # (D, L) uint32
    lengths: np.ndarray  # (D,) int32

    @property
    def num_docs(self) -> int:
        return self.tokens.shape[0]


def pow2_bucket(n: int, floor: int = 256) -> int:
    """Smallest power of two >= max(n, floor).

    Padded widths go through this so that batches of varying length
    share a few shapes.  Signatures do not depend on the padding (the
    validity mask comes from the real lengths).
    """
    b = max(1, int(floor))
    while b < n:
        b *= 2
    return b


def pack_documents(
    docs: list[list[str]], max_len: int | None = None
) -> PackedDocs:
    """Token lists -> zero-padded (D, L) uint32 id matrix and lengths.

    ``L`` is ``max_len`` or the longest document; longer documents are
    cut to ``L`` tokens.
    """
    lengths = np.array([len(d) for d in docs], dtype=np.int32)
    L = int(max_len or max(1, lengths.max(initial=1)))
    toks = np.zeros((len(docs), L), dtype=np.uint32)
    for i, d in enumerate(docs):
        ids = token_ids(d[:L])
        toks[i, : len(ids)] = ids
        lengths[i] = min(lengths[i], L)
    return PackedDocs(tokens=toks, lengths=lengths)


@dataclass(frozen=True)
class PackedBytes:
    """A batch of documents as a padded UTF-8 byte matrix."""

    data: np.ndarray  # (D, LB) uint8, zero-padded rows
    lengths: np.ndarray  # (D,) int32 byte lengths

    @property
    def num_docs(self) -> int:
        return self.data.shape[0]


def pack_bytes(docs: list[str | bytes],
               max_len: int | None = None) -> PackedBytes:
    """Documents -> zero-padded (D, LB) uint8 matrix of their UTF-8 bytes.

    The width must exceed every document's byte length: a token ends at
    the first separator after it, so a token running to a document's
    last byte needs one more column to end in.  ``max_len`` (a
    ``pow2_bucket`` width) is checked against that; without it the
    width is the longest length + 1.
    """
    raw = [d if isinstance(d, bytes) else d.encode("utf-8") for d in docs]
    lengths = np.array([len(b) for b in raw], dtype=np.int32)
    need = int(lengths.max(initial=0)) + 1
    L = int(max_len) if max_len is not None else need
    if L < need:
        raise ValueError(
            f"pack_bytes width {L} < max doc bytes + 1 ({need}); a token "
            "ending at the last column would be lost")
    data = np.zeros((len(raw), L), dtype=np.uint8)
    for i, b in enumerate(raw):
        data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return PackedBytes(data=data, lengths=lengths)


def ngram_valid(lengths: torch.Tensor, L: int, n: int = 8) -> torch.Tensor:
    """(D, L) validity of the n-gram positions of documents of ``lengths``.

    Position i is valid iff i + n <= length; a document shorter than n
    keeps one shingle, its whole prefix, at position 0.  So the valid
    positions are a prefix of the row, of ``nvalid`` positions.
    """
    ln = lengths.to(torch.int64)
    nvalid = torch.where(ln >= n, ln - n + 1, (ln > 0).to(torch.int64))
    pos = torch.arange(L, device=lengths.device)
    return pos[None, :] < nvalid[:, None]


def ngram_hashes(
    tokens: torch.Tensor, lengths: torch.Tensor, n: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rolling polynomial hash of every length-n token window.

    tokens: (D, L) uint32 words (int32 bits); lengths: (D,) int.
    Returns (hashes (D, L) int32 bits, valid (D, L) bool).

    h(i) = fmix32( sum_k NGRAM_BASE^(n-1-k) * t[i+k] )  (mod 2^32), with
    zeros past column L.  Validity is ``ngram_valid``'s.
    """
    t = as_u32(tokens)
    L = t.shape[1]
    padded = F.pad(t, (0, n))
    acc = torch.zeros_like(t)
    for k in range(n):
        acc = (mul32(acc, NGRAM_BASE) + padded[:, k : k + L]) & MASK32
    return to_bits(fmix32(acc)), ngram_valid(lengths, L, n)
