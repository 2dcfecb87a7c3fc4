"""Out-of-core band-matrix storage (paper §5): the memory tier.

Port of the memory tier of ``repro.core.bandstore``.  The paper keeps
its band matrix in Apache Cassandra; here the designs are realized over
stdlib ``sqlite3`` with the same schemas and access patterns:

Design 1: one row per band-matrix cell      (band_id, doc_id, value)
Design 2: one row per (band, doc-part) slice (band_id, part_id, values[])

``BandStoreBackend`` is the interface a session's store implements:
writes (``put_band_rows`` / ``insert_document`` and ``commit``), the
band-major scan (``read_band``, ``iter_band_runs``), a pure probe
(``probe_keys``), and ``compact``, which rewrites evicted docs' rows
onto their cluster roots.  ``make_store("memory")`` gives the
``Design2Store`` the streaming backend writes its phase 1 into.

Design 2 parts are blobs of little-endian numpy bytes (schema v2: a
header of magic, version and count, then int64 doc ids, then uint32
band values), the same bytes the reference writes, so a store file
written by either package reads the same through the other.

Not ported yet: the sqlite tier (``SqliteBandStore``, a key-level disk
index with Bloom-first lookups, and ``DiskSignatureVerifier``);
``make_store("sqlite")`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import sqlite3
from typing import Iterator

import numpy as np

STORE_KINDS = ("memory", "sqlite")

_SQLITE_TIER = ("the sqlite band-store tier (SqliteBandStore, "
                "DiskSignatureVerifier) is not ported yet (ROADMAP.md, "
                "queue 1 item 2: the sqlite tier)")


class BandStoreBackend:
    """Interface every band-store tier implements.

    Write path: ``put_band_rows`` / ``insert_document``, then ``commit``.
    Scan path: ``read_band`` (the paper's "select * where band_id = j")
    and ``iter_band_runs`` (sorted equal-value runs, the staged engine's
    candidate structure).  Probe path: ``probe_keys``, a pure read
    mapping query band values to stored doc ids.  Retention: ``compact``
    rewrites evicted docs' band rows onto their cluster roots, so the
    store stops growing with evicted history; the engine maps every
    candidate to its union-find root before verifying, so the rewrite
    changes no clustering.
    """

    kind = "abstract"
    conn: sqlite3.Connection

    # -- write path --------------------------------------------------------

    def insert_document(self, doc_id: int, band_sig: np.ndarray) -> None:
        raise NotImplementedError

    def put_band_rows(self, doc_ids, bands: np.ndarray) -> None:
        """Insert a chunk: ``doc_ids`` (D,) int, ``bands`` (D, b, 2)."""
        bands = np.asarray(bands)
        for i, doc in enumerate(doc_ids):
            self.insert_document(int(doc), bands[i])

    def commit(self) -> None:
        raise NotImplementedError

    # -- scan path ---------------------------------------------------------

    def read_band(self, band_id: int):
        raise NotImplementedError

    def iter_band_runs(self, num_bands: int) -> Iterator:
        """Per-band sorted equal-value runs (``candidates.BandRuns``)."""
        from repro_torch.core.candidates import make_band_runs

        for j in range(int(num_bands)):
            docs, vals = self.read_band(j)
            yield make_band_runs(j, vals, docs)

    # -- probe path (pure) -------------------------------------------------

    def probe_keys(self, bands: np.ndarray):
        """(Q, b, 2) query bands -> (per-query sorted unique int64 doc-id
        arrays, per-query filter-only hit counts, all 0 here).

        A pure read: it changes no store state.  Walks ``read_band`` with
        a host dict per band.
        """
        bands = np.asarray(bands)
        q = len(bands)
        cands: list[set[int]] = [set() for _ in range(q)]
        for j in range(bands.shape[1]):
            docs, vals = self.read_band(j)
            lookup: dict[tuple[int, int], list[int]] = {}
            for d, (hi, lo) in zip(docs.tolist(), vals.tolist()):
                lookup.setdefault((hi, lo), []).append(d)
            for i, key in enumerate(map(tuple, bands[:, j, :].tolist())):
                olds = lookup.get(key)
                if olds is not None:
                    cands[i].update(olds)
        return ([np.array(sorted(s), dtype=np.int64) for s in cands],
                [0] * q)

    # -- retention ---------------------------------------------------------

    def compact(self, doc_ids, root_of) -> None:
        raise NotImplementedError

    def n_entries(self) -> int:
        """Total (band, value, doc) entries currently stored."""
        raise NotImplementedError

    # -- accounting --------------------------------------------------------

    def file_size_bytes(self) -> int:
        """Current database size, page_count * page_size (``:memory:``
        connections included)."""
        (pages,) = self.conn.execute("PRAGMA page_count").fetchone()
        (size,) = self.conn.execute("PRAGMA page_size").fetchone()
        return int(pages) * int(size)


def make_store(kind: str, path: str = ":memory:", *,
               part_size: int = 50, num_bands: int = 50):
    """Factory behind ``DedupConfig.store``: ``"memory"`` gives a
    ``Design2Store``; ``"sqlite"`` is not ported yet and raises
    ``NotImplementedError``.  ``num_bands`` is the sqlite tier's."""
    if kind == "memory":
        return Design2Store(path, part_size=part_size)
    if kind == "sqlite":
        raise NotImplementedError(_SQLITE_TIER)
    raise ValueError(f"unknown store kind {kind!r}; one of {STORE_KINDS}")


class Design1Store(BandStoreBackend):
    """One database row per band-matrix cell."""

    kind = "design1"

    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS band1 ("
            " band_id INTEGER, doc_id INTEGER,"
            " hi INTEGER, lo INTEGER,"
            " PRIMARY KEY (band_id, doc_id))")
        self.n_writes = 0
        self.write_bytes = 0

    def insert_document(self, doc_id: int, band_sig: np.ndarray):
        """band_sig: (b, 2) uint32, the doc's band-matrix column."""
        rows = [(j, int(doc_id), hi, lo)
                for j, (hi, lo) in enumerate(np.asarray(band_sig).tolist())]
        self.conn.executemany(
            "INSERT OR REPLACE INTO band1 VALUES (?,?,?,?)", rows)
        self.n_writes += len(rows)
        self.write_bytes += len(rows) * 16   # 32+32+64 bits (paper §8)

    def read_band(self, band_id: int):
        """'select * from table where band_id = id' (paper §5.2.1)."""
        rows = self.conn.execute(
            "SELECT doc_id, hi, lo FROM band1 WHERE band_id=?",
            (int(band_id),)).fetchall()
        if not rows:
            return (np.zeros(0, np.int64), np.zeros((0, 2), np.uint32))
        arr = np.array(rows, dtype=np.int64)
        return arr[:, 0], arr[:, 1:].astype(np.uint32)

    def n_entries(self) -> int:
        (n,) = self.conn.execute("SELECT COUNT(*) FROM band1").fetchone()
        return int(n)

    def commit(self):
        self.conn.commit()


# Design-2 blob schema v2: the part's doc ids travel inside the blob
# (magic, version and count, then int64 doc ids, then uint32 band
# values).  v1 blobs were the raw value array alone, ids implied as
# arange(doc0, doc0 + d), which is wrong for non-contiguous ids.
_BLOB_MAGIC = np.uint32(0x42443253)   # "BD2S"
_BLOB_VERSION = np.uint32(2)


def _encode_part_v2(doc_ids: np.ndarray, vals: np.ndarray) -> bytes:
    """Pack one (band, part) slice: header + int64 ids + uint32 values,
    little-endian."""
    d = len(doc_ids)
    header = np.array([_BLOB_MAGIC, _BLOB_VERSION, d], dtype="<u4")
    return (header.tobytes()
            + np.ascontiguousarray(doc_ids, dtype="<i8").tobytes()
            + np.ascontiguousarray(vals, dtype="<u4").tobytes())


def _decode_part(blob: bytes, doc0: int):
    """Decode a part blob of either schema version.

    v2 is self-describing; anything else is a v1 raw value array whose
    doc ids are ``arange(doc0, doc0 + d)`` (kept so that older stores
    stay readable).
    """
    if len(blob) >= 12:
        header = np.frombuffer(blob[:12], dtype="<u4")
        d = int(header[2])
        if (header[0] == _BLOB_MAGIC and header[1] == _BLOB_VERSION
                and len(blob) == 12 + d * 8 + d * 8):
            docs = np.frombuffer(blob[12 : 12 + d * 8], dtype="<i8")
            vals = np.frombuffer(blob[12 + d * 8 :],
                                 dtype="<u4").reshape(d, 2)
            return (docs.astype(np.int64, copy=False),
                    vals.astype(np.uint32, copy=False))
    vals = np.frombuffer(blob, dtype="<u4").reshape(-1, 2)
    return (np.arange(doc0, doc0 + len(vals), dtype=np.int64),
            vals.astype(np.uint32, copy=False))


class Design2Store(BandStoreBackend):
    """One database row per (band, band_part) slice of d documents.

    ``n_writes`` and ``write_bytes`` count the rows and bytes written
    (the paper's Design-2 write metrics: fewer, larger writes than
    Design 1).
    """

    kind = "memory"

    def __init__(self, path: str = ":memory:", part_size: int = 50):
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS band2 ("
            " band_id INTEGER, part_id INTEGER, doc0 INTEGER,"
            " vals BLOB, PRIMARY KEY (band_id, part_id))")
        self.part_size = part_size
        self.n_writes = 0
        self.write_bytes = 0
        self._buffer: list[tuple[int, np.ndarray]] = []
        self._next_part = 0

    def insert_document(self, doc_id: int, band_sig: np.ndarray):
        self._buffer.append((doc_id, np.asarray(band_sig).astype(np.uint32)))
        if len(self._buffer) >= self.part_size:
            self.flush_part()

    def flush_part(self):
        """Write the buffered docs as one part of every band."""
        if not self._buffer:
            return
        doc0 = self._buffer[0][0]
        doc_ids = np.array([d for d, _ in self._buffer], dtype=np.int64)
        stack = np.stack([b for _, b in self._buffer])   # (d, b, 2)
        rows = []
        for j in range(stack.shape[1]):
            blob = _encode_part_v2(doc_ids, stack[:, j, :])
            rows.append((j, self._next_part, doc0, blob))
            self.write_bytes += 8 + len(blob)   # 32+32 bits + blob
        self.conn.executemany(
            "INSERT OR REPLACE INTO band2 VALUES (?,?,?,?)", rows)
        self.n_writes += len(rows)
        self._next_part += 1
        self._buffer = []

    def read_band(self, band_id: int):
        """Every part of the band, in ``part_id`` order, appended
        (paper §5.2.2)."""
        cur = self.conn.execute(
            "SELECT part_id, doc0, vals FROM band2 WHERE band_id=? "
            "ORDER BY part_id", (int(band_id),))
        docs, vals = [], []
        for _, doc0, blob in cur.fetchall():
            d, v = _decode_part(blob, doc0)
            docs.append(d)
            vals.append(v)
        if not docs:
            return (np.zeros(0, np.int64), np.zeros((0, 2), np.uint32))
        return np.concatenate(docs), np.concatenate(vals)

    def _band_ids(self) -> list[int]:
        cur = self.conn.execute(
            "SELECT DISTINCT band_id FROM band2 ORDER BY band_id")
        return [int(j) for (j,) in cur.fetchall()]

    def compact(self, doc_ids, root_of) -> None:
        """Rewrite evicted docs' band rows onto their cluster roots.

        Per band: decode every part, map each evicted doc id to
        ``root_of(doc)`` in place (surviving entries keep their
        positions, so the scan's stable lexsort enumerates runs in the
        order an unevicted store would), drop repeated (value, doc)
        entries keeping the first, and rewrite the band's parts from
        part 0 (``_next_part`` keeps counting, so later flushes sort
        after them).  The buffer is flushed first.
        """
        self.flush_part()
        ev = {int(d): int(root_of(int(d))) for d in doc_ids}
        if not ev:
            return
        ev_ids = np.fromiter(ev, dtype=np.int64, count=len(ev))
        for j in self._band_ids():
            docs, vals = self.read_band(j)
            if len(docs) == 0 or not np.isin(docs, ev_ids).any():
                continue
            mapped = np.array([ev.get(d, d) for d in docs.tolist()],
                              dtype=np.int64)
            seen: set[tuple[int, int, int]] = set()
            keep = np.ones(len(mapped), dtype=bool)
            for i, (hi, lo, d) in enumerate(zip(vals[:, 0].tolist(),
                                                vals[:, 1].tolist(),
                                                mapped.tolist())):
                key = (hi, lo, d)
                if key in seen:
                    keep[i] = False
                else:
                    seen.add(key)
            new_docs, new_vals = mapped[keep], vals[keep]
            self.conn.execute("DELETE FROM band2 WHERE band_id=?", (j,))
            rows = []
            for p, s in enumerate(range(0, len(new_docs), self.part_size)):
                ids = new_docs[s : s + self.part_size]
                blob = _encode_part_v2(ids, new_vals[s : s + self.part_size])
                rows.append((j, p, int(ids[0]), blob))
            if rows:
                self.conn.executemany(
                    "INSERT INTO band2 VALUES (?,?,?,?)", rows)
        self.conn.commit()

    def n_entries(self) -> int:
        self.flush_part()
        return sum(len(self.read_band(j)[0]) for j in self._band_ids())

    def commit(self):
        self.flush_part()
        self.conn.commit()
