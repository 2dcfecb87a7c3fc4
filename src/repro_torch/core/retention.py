"""Bounded retained state for long-lived dedup sessions.

Port of ``repro.core.retention``.  A ``DedupSession`` without a policy
retains three things forever: the verifier's per-doc rows (signatures,
or interned n-gram ids in exact mode) and the ``BandIndex`` bucket
lists, so memory grows with every doc ever ingested.  This module is
the policy layer that caps them at O(clusters + recency window):

* **Row eviction is lossless.**  The engine compresses every candidate
  to its union-find root before verification, so the only rows a later
  chunk can read are the rows of current roots.  A doc that loses
  roothood (``ThresholdUnionFind.track_deposed``) has its row released
  once it ages out of a small LRU window.
* **Band-index compaction is the only lossy mechanism.**  Bucket lists
  are first rewritten onto retained docs (an evicted member is replaced
  by its cluster root); once a band holds more than ``band_key_budget``
  keys, its least recently hit keys are compacted into a per-band Bloom
  filter.  A later hit on a compacted key is counted in
  ``filter_only_hits``: the value was seen, by a doc the index can no
  longer name.

``RetentionPolicy`` is the configuration; ``RetentionManager`` drives
the sweep (drain deposed roots, release verifier rows, rewrite and
compact the band index) and keeps the root set that
``DedupSession.refine`` re-bands.  Host code (numpy); nothing here
touches the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Distinct 32-bit odd mixing constants (murmur3 / splitmix tails).
_MIX1 = 0x9E3779B1
_MIX2 = 0x85EBCA77
_MIX3 = 0xC2B2AE3D
_U32 = 0xFFFFFFFF


def _mix32_many(keys: np.ndarray, salt: int) -> np.ndarray:
    """The filter's hash: a 32-bit avalanche of each (hi, lo) band key of
    a (K, 2) array and a salt, in uint64 arithmetic.  Each product wraps
    modulo 2**64 and only its low 32 bits are kept, so the result is the
    32-bit hash ``(hi * _MIX1 + lo * _MIX2 + salt * _MIX3 + 0x27D4EB2F)``
    mod 2**32 followed by three xor-shift / multiply rounds."""
    k = keys.astype(np.uint64)
    x = (k[:, 0] * np.uint64(_MIX1) + k[:, 1] * np.uint64(_MIX2)
         + np.uint64((salt * _MIX3 + 0x27D4EB2F) & _U32)) & np.uint64(_U32)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & np.uint64(_U32)
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & np.uint64(_U32)
    x ^= x >> np.uint64(16)
    return x


class BandBloomFilter:
    """Membership filter for compacted (hi, lo) band keys.

    One per band; holds the keys whose exact bucket lists were dropped.
    No false negatives; a false positive only adds to the
    ``filter_only_hits`` count, it never creates an edge.  ``add_keys``
    and ``contains_keys`` are the batch forms of ``add`` and ``in`` over
    (K, 2) uint32 keys, with the same bit layout.
    """

    def __init__(self, bits: int = 1 << 17, num_hashes: int = 4):
        if bits <= 0 or bits & (bits - 1):
            raise ValueError(f"bits must be a power of two, got {bits}")
        self.bits = int(bits)
        self.num_hashes = int(num_hashes)
        self._words = np.zeros(self.bits // 32, dtype=np.uint32)
        self.n_added = 0

    def add(self, key: tuple[int, int]) -> None:
        self.add_keys([key])

    def __contains__(self, key: tuple[int, int]) -> bool:
        return bool(self.contains_keys([key])[0])

    def _bit_indices(self, keys) -> np.ndarray:
        """(num_hashes, K) bit positions of (K, 2) keys."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1, 2)
        mask = np.uint64(self.bits - 1)
        return np.stack([_mix32_many(keys, s) & mask
                         for s in range(self.num_hashes)])

    def add_keys(self, keys) -> None:
        """``add`` each of (K, 2) keys."""
        idx = self._bit_indices(keys).ravel()
        if idx.size == 0:
            return
        np.bitwise_or.at(self._words, (idx >> np.uint64(5)).astype(np.int64),
                         np.left_shift(np.uint32(1),
                                       (idx & np.uint64(31)).astype(np.uint32)))
        self.n_added += idx.size // self.num_hashes

    def contains_keys(self, keys) -> np.ndarray:
        """(K,) bool: ``key in self`` for each of (K, 2) keys."""
        idx = self._bit_indices(keys)
        words = self._words[(idx >> np.uint64(5)).astype(np.int64)]
        bits = (words >> (idx & np.uint64(31)).astype(np.uint32)) & np.uint32(1)
        return bits.astype(bool).all(axis=0)

    @property
    def memory_bytes(self) -> int:
        return self._words.nbytes

    def copy(self) -> "BandBloomFilter":
        """Independent copy: a view freezes the filter state, so a later
        ``add`` cannot flip a bit under a probe."""
        out = BandBloomFilter(self.bits, self.num_hashes)
        out._words = self._words.copy()
        out.n_added = self.n_added
        return out


@dataclass(frozen=True)
class RetentionPolicy:
    """Bounded-memory configuration for a ``DedupSession``.

    ``lru_window``      the most recent docs are never evicted, even when
                        not roots; ``None`` turns row eviction off
                        (append-only rows) while the root set is still
                        tracked for the ``refine`` cadence.
    ``band_key_budget`` the most exact (band value -> docs) keys kept per
                        band; beyond it the least recently hit keys
                        compact into the band's Bloom filter.  ``None``:
                        no limit (eviction stays on and lossless).
    ``bloom_bits`` / ``bloom_hashes``  per-band filter geometry.
    ``refine_every``    run ``DedupSession.refine`` every K ingest steps;
                        0 turns the cadence off (``refine()`` still works).
    """

    lru_window: int | None = 512
    band_key_budget: int | None = None
    bloom_bits: int = 1 << 17
    bloom_hashes: int = 4
    refine_every: int = 0

    PRESETS = ("small", "medium", "unlimited", "none")

    @classmethod
    def preset(cls, name: str, *, refine_every: int = 0) -> "RetentionPolicy":
        """Named budgets (the CLI's ``--retain-budget``)."""
        if name == "small":
            return cls(lru_window=128, band_key_budget=2048,
                       bloom_bits=1 << 16, refine_every=refine_every)
        if name == "medium":
            return cls(lru_window=1024, band_key_budget=1 << 16,
                       refine_every=refine_every)
        if name == "unlimited":
            return cls(lru_window=512, band_key_budget=None,
                       refine_every=refine_every)
        if name == "none":
            # Append-only rows and unlimited keys: only the root set is
            # kept (for the refine cadence).
            return cls(lru_window=None, band_key_budget=None,
                       refine_every=refine_every)
        raise ValueError(f"unknown retention preset {name!r}; "
                         f"one of {cls.PRESETS}")


class RetentionManager:
    """Drives eviction sweeps for one ``DedupSession``.

    Keeps the root set (fed by ``ThresholdUnionFind.drain_deposed``) and
    the deposed docs still inside the window; each sweep releases the
    verifier rows of docs that are no longer roots and older than the
    LRU window, and rewrites their band-index entries onto their roots.
    """

    def __init__(self, policy: RetentionPolicy):
        self.policy = policy
        self.roots: set[int] = set()
        self._pending: list[int] = []
        self._seen = None  # the first sweep learns the session's base
        self.n_evicted = 0

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def representatives(self) -> list[int]:
        """Sorted current roots (every one has a retained row)."""
        return sorted(self.roots)

    def sweep(self, session, protect_from: int | None = None) -> int:
        """One eviction pass; returns the number of docs evicted.

        ``protect_from`` also shields ids at or above that bound.
        """
        uf = session.uf
        if self._seen is None:
            self._seen = int(session.allocator.base)
        n_merged = int(session.n_merged)
        if n_merged > self._seen:
            self.roots.update(range(self._seen, n_merged))
            self._seen = n_merged
        drained = uf.drain_deposed()
        if drained:
            self.roots.difference_update(drained)
            if self.policy.lru_window is not None:
                self._pending.extend(drained)
        if self.policy.lru_window is None:
            return 0                 # append-only rows, roots tracked
        cutoff = n_merged - self.policy.lru_window
        if protect_from is not None:
            cutoff = min(cutoff, int(protect_from))
        evict = [d for d in self._pending if d < cutoff]
        if not evict:
            return 0
        self._pending = [d for d in self._pending if d >= cutoff]
        session._release_rows(evict)
        session.band_index.evict(evict, uf.find)
        # A streaming session also rewrites the evicted docs' band-store
        # rows onto their roots (a no-op for the host backend), so its
        # phase-1 store stops growing with evicted history.
        session._compact_band_store(evict, uf.find)
        self.n_evicted += len(evict)
        return len(evict)
