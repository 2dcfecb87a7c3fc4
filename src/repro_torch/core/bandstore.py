"""Out-of-core band-matrix storage (paper §5): the memory and sqlite tiers.

Port of ``repro.core.bandstore``.  The paper keeps its band matrix in
Apache Cassandra; here the designs are realized over stdlib ``sqlite3``
with the same schemas and access patterns:

Design 1: one row per band-matrix cell      (band_id, doc_id, value)
Design 2: one row per (band, doc-part) slice (band_id, part_id, values[])

``BandStoreBackend`` is the interface a session's store implements:
writes (``put_band_rows`` / ``insert_document`` and ``commit``), the
band-major scan (``read_band``, ``iter_band_runs``), a pure probe
(``probe_keys``), and ``compact``, which rewrites evicted docs' rows
onto their cluster roots.  ``make_store`` is the factory behind
``DedupConfig.store``:

* ``"memory"`` gives the ``Design2Store`` the streaming backend writes
  its phase 1 into (a host session's cross-step index is then the
  in-RAM ``session.BandIndex``);
* ``"sqlite"`` gives ``SqliteBandStore``, a key-level disk tier with
  Bloom-first lookups: one ``retention.BandBloomFilter`` a band holds
  every key ever inserted, so a probe touches disk only on filter hits.
  It is also the ``BandIndex`` of a host session under ``store="sqlite"``,
  and it keeps signature rows on disk for ``DiskSignatureVerifier``,
  which gathers them through an LRU row cache and scores them with K2'
  (``kernels.sigjaccard.pair_estimate``) on its device.

Both tiers give identical clusters and bit-identical per-edge sims.
Every blob is little-endian numpy bytes, the bytes the reference
writes: Design 2 parts (schema v2: a header of magic, version and
count, then int64 doc ids, then uint32 band values), sqlite buckets
(int64 doc ids) and signature rows (uint32).  So a store file written
by either package reads the same through the other.
"""
from __future__ import annotations

import sqlite3
from collections import OrderedDict
from typing import Iterator

import numpy as np

from repro_torch.core.hashing import u32_from_numpy
from repro_torch.core.retention import BandBloomFilter
from repro_torch.core.verify import BatchVerifier
from repro_torch.device import resolve_device
from repro_torch.kernels import sigjaccard

STORE_KINDS = ("memory", "sqlite")


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
    # Whether the store also holds the signature rows a verifier reads
    # (``put_signatures``): the sqlite tier does, the others leave them
    # to the caller.
    keeps_signatures = False
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
    ``Design2Store`` (``part_size`` docs a part), ``"sqlite"`` a
    ``SqliteBandStore`` of ``num_bands`` bands."""
    if kind == "memory":
        return Design2Store(path, part_size=part_size)
    if kind == "sqlite":
        return SqliteBandStore(path, num_bands=num_bands)
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


def _pack_docs(docs) -> bytes:
    """A bucket's doc ids as little-endian int64 bytes."""
    return np.asarray(docs, dtype="<i8").tobytes()


def _unpack_docs(blob: bytes) -> list[int]:
    return np.frombuffer(blob, dtype="<i8").tolist()


class SqliteBandStore(BandStoreBackend):
    """Key-level disk tier with Bloom-first lookups.

    Layout: one row per retained band KEY,

      ``bandkeys(band_id, hi, lo, docs BLOB, seq)``  PK (band_id, hi, lo)

    where ``docs`` is the key's bucket, an insertion-ordered int64 array,
    and ``seq`` a monotone last-touch counter (the LRU clock a
    ``key_budget`` compacts by).  ``docentries(doc_id, band_id, hi, lo)``
    is the per-doc reverse map ``evict`` rewrites through, and
    ``sigs(doc_id, row)`` holds the signature rows
    ``DiskSignatureVerifier`` reads.

    Two sets of ``retention.BandBloomFilter``, one filter a band each:

    * the PRIMARY filter holds every key ever inserted.  Inserts and
      probes consult it first (in one batch a band) and touch disk only
      for its hits: a miss is a definitive store miss, and a false
      positive costs one empty match in a batched SELECT;
    * the COMPACTION filter holds only the keys a key budget dropped,
      with ``session.BandIndex``'s semantics: a later miss that hits it
      counts one ``filter_only_hits``.

    The class plays both roles a session needs: the ``BandStoreBackend``
    scan, probe and compact interface (the streaming backend's store,
    the read path's probe) and the ``session.BandIndex`` API
    (``match_then_insert``, ``evict``, ``export_*``, ``stats``), so a
    host ``DedupSession`` keeps its cross-step index on disk.  Rows,
    ``seq`` values and counters equal the reference's for the same
    calls.  Reopening a file rebuilds the primary filters, key counts
    and the clock from its rows; compaction filters start empty (their
    keys are gone from the file by definition).
    """

    kind = "sqlite"
    keeps_signatures = True

    def __init__(self, path: str = ":memory:", num_bands: int = 50, *,
                 key_budget: int | None = None,
                 bloom_bits: int = 1 << 17, bloom_hashes: int = 4,
                 primary_bloom_bits: int = 1 << 20,
                 track_entries: bool = False):
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS bandkeys ("
            " band_id INTEGER, hi INTEGER, lo INTEGER,"
            " docs BLOB, seq INTEGER,"
            " PRIMARY KEY (band_id, hi, lo))")
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS docentries ("
            " doc_id INTEGER, band_id INTEGER,"
            " hi INTEGER, lo INTEGER)")
        self.conn.execute(
            "CREATE INDEX IF NOT EXISTS docentries_doc"
            " ON docentries (doc_id)")
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS sigs ("
            " doc_id INTEGER PRIMARY KEY, row BLOB)")
        self._num_bands = int(num_bands)
        self._key_budget = key_budget
        self._bloom_bits = int(bloom_bits)
        self._bloom_hashes = int(bloom_hashes)
        self._track_entries = bool(track_entries)
        self._primary = [BandBloomFilter(primary_bloom_bits, bloom_hashes)
                         for _ in range(self._num_bands)]
        self._filters: list[BandBloomFilter | None] = \
            [None] * self._num_bands
        self._key_counts = [0] * self._num_bands
        self._seq = 0
        self.filter_only_hits = 0
        self.compacted_keys = 0
        self.n_writes = 0
        self.write_bytes = 0
        rows = self.conn.execute(
            "SELECT band_id, hi, lo, seq FROM bandkeys").fetchall()
        if rows:
            arr = np.array(rows, dtype=np.int64)
            for j in np.unique(arr[:, 0]).tolist():
                keys = arr[arr[:, 0] == j, 1:3].astype(np.uint32)
                self._primary[j].add_keys(keys)
                self._key_counts[j] = len(keys)
            self._seq = int(arr[:, 3].max()) + 1

    # -- small helpers -----------------------------------------------------

    @property
    def num_bands(self) -> int:
        return self._num_bands

    def _filter(self, j: int) -> BandBloomFilter:
        if self._filters[j] is None:
            self._filters[j] = BandBloomFilter(
                self._bloom_bits, self._bloom_hashes)
        return self._filters[j]

    def _check_bands(self, bands, what: str) -> np.ndarray:
        bands = np.asarray(bands)
        if bands.ndim != 3 or bands.shape[1] != self._num_bands:
            raise ValueError(
                f"expected ({what}, {self._num_bands}, 2) bands, "
                f"got {bands.shape}")
        return bands

    def _maybe_keys(self, j: int, col: np.ndarray,
                    keys: list) -> list[tuple[int, int]]:
        """The sorted distinct keys of ``col`` the band's primary filter
        may hold (one batch filter read)."""
        hit = self._primary[j].contains_keys(col).tolist()
        return sorted({k for k, h in zip(keys, hit) if h})

    def _select_keys(self, j: int, keys: list[tuple[int, int]]) -> dict:
        """Existing buckets of ``keys`` in band ``j``, ``{key: [doc
        ids]}``, in statements of at most 400 keys (sqlite's host
        parameter cap).  Each statement joins its key list on the
        primary key, one index probe a key: the reference's ``(hi, lo)
        IN (VALUES ...)`` form selects the same rows, but sqlite plans
        it as a scan of the whole band."""
        out: dict[tuple[int, int], list[int]] = {}
        for s in range(0, len(keys), 400):
            part = keys[s : s + 400]
            sql = ("WITH q(hi, lo) AS (VALUES "
                   + ",".join(["(?,?)"] * len(part))
                   + ") SELECT b.hi, b.lo, b.docs FROM q JOIN bandkeys b "
                   "ON b.band_id=? AND b.hi=q.hi AND b.lo=q.lo")
            args = [v for key in part for v in key]
            args.append(j)
            for hi, lo, blob in self.conn.execute(sql, args):
                out[(hi, lo)] = _unpack_docs(blob)
        return out

    def _compact_band(self, j: int) -> None:
        """Past the key budget, drop the band's least recently touched
        keys (lowest ``seq``) into its compaction filter."""
        if self._key_budget is None or \
                self._key_counts[j] <= self._key_budget:
            return
        excess = self._key_counts[j] - self._key_budget
        victims = self.conn.execute(
            "SELECT hi, lo FROM bandkeys WHERE band_id=? "
            "ORDER BY seq LIMIT ?", (j, excess)).fetchall()
        self.conn.executemany(
            "DELETE FROM bandkeys WHERE band_id=? AND hi=? AND lo=?",
            [(j, hi, lo) for hi, lo in victims])
        if victims:
            self._filter(j).add_keys(np.array(victims, dtype=np.uint32))
        self.compacted_keys += len(victims)
        self._key_counts[j] -= len(victims)

    # -- BandIndex API: cross-step candidate generation ---------------------

    def match_then_insert(self, bands: np.ndarray,
                          doc_id_base: int) -> np.ndarray:
        """(C, b, 2) uint32 chunk bands -> (E, 2) int64 cross-step edges.

        ``session.BandIndex.match_then_insert`` line for line: the same
        edge order (band-major, then chunk order), a recency refresh of
        every touched key (its ``seq`` is the clock value of its last
        touch, one tick a (band, doc)), and the same budget compaction
        into the band's filter.  Only the primary filter's hits pay a
        SELECT.
        """
        bands = self._check_bands(bands, "C")
        edges: list[tuple[int, int]] = []
        for j in range(self._num_bands):
            col = bands[:, j, :]
            keys = list(map(tuple, col.tolist()))
            buckets = self._select_keys(j, self._maybe_keys(j, col, keys))
            preexisting = set(buckets)
            # A band's compaction filter changes only at its compaction,
            # after the walk, so its hits are read in one batch.
            flt = self._filters[j]
            in_filter = (flt.contains_keys(col).tolist()
                         if flt is not None else None)
            s0 = self._seq
            seq_of: dict[tuple[int, int], int] = {}
            for i, key in enumerate(keys):
                new_id = doc_id_base + i
                olds = buckets.get(key)
                if olds is not None:
                    edges.extend((old, new_id) for old in olds
                                 if old < doc_id_base)
                    olds.append(new_id)
                else:
                    if in_filter is not None and in_filter[i]:
                        # Seen before, partner compacted away: the pair
                        # can no longer be verified exactly.
                        self.filter_only_hits += 1
                    buckets[key] = [new_id]
                seq_of[key] = s0 + i + 1
            self._seq = s0 + len(keys)
            updates, inserts, new_keys = [], [], []
            for key, docs in buckets.items():
                blob = _pack_docs(docs)
                self.write_bytes += len(blob)
                if key in preexisting:
                    updates.append((blob, seq_of[key], j, key[0], key[1]))
                else:
                    inserts.append((j, key[0], key[1], blob, seq_of[key]))
                    new_keys.append(key)
            if updates:
                self.conn.executemany(
                    "UPDATE bandkeys SET docs=?, seq=? "
                    "WHERE band_id=? AND hi=? AND lo=?", updates)
            if inserts:
                self.conn.executemany(
                    "INSERT INTO bandkeys VALUES (?,?,?,?,?)", inserts)
                self._primary[j].add_keys(np.array(new_keys,
                                                   dtype=np.uint32))
                self._key_counts[j] += len(new_keys)
            self.n_writes += len(updates) + len(inserts)
            if self._track_entries and keys:
                self.conn.executemany(
                    "INSERT INTO docentries VALUES (?,?,?,?)",
                    [(doc_id_base + i, j, hi, lo)
                     for i, (hi, lo) in enumerate(keys)])
            self._compact_band(j)
        if not edges:
            return np.zeros((0, 2), dtype=np.int64)
        return np.array(edges, dtype=np.int64)

    def evict(self, doc_ids, root_of) -> None:
        """Rewrite evicted docs' bucket entries onto their cluster root
        (``session.BandIndex.evict``, on disk).  Needs ``track_entries``."""
        if not self._track_entries:
            raise ValueError(
                "SqliteBandStore was built without track_entries; "
                "eviction needs the per-doc reverse map")
        for d in doc_ids:
            d = int(d)
            rows = self.conn.execute(
                "SELECT band_id, hi, lo FROM docentries WHERE doc_id=? "
                "ORDER BY rowid", (d,)).fetchall()
            if not rows:
                continue
            self.conn.execute("DELETE FROM docentries WHERE doc_id=?", (d,))
            for j, hi, lo in rows:
                got = self.conn.execute(
                    "SELECT docs FROM bandkeys WHERE band_id=? AND "
                    "hi=? AND lo=?", (j, hi, lo)).fetchone()
                if got is None:
                    continue               # key already compacted
                docs = _unpack_docs(got[0])
                if d not in docs:
                    continue               # key was compacted and seen again
                docs.remove(d)
                r = int(root_of(d))
                if r not in docs:
                    docs.append(r)
                    self.conn.execute(
                        "INSERT INTO docentries VALUES (?,?,?,?)",
                        (r, j, hi, lo))
                self.conn.execute(
                    "UPDATE bandkeys SET docs=? WHERE band_id=? AND "
                    "hi=? AND lo=?", (_pack_docs(docs), j, hi, lo))

    def export_maps(self) -> tuple:
        """Per-band ``{(hi, lo): (doc ids,)}`` dicts read from disk: the
        in-memory view's shape.  A store-backed session publishes the
        live store instead (``SessionView.band_store``); this export is
        for parity checks and introspection."""
        maps: list[dict] = [dict() for _ in range(self._num_bands)]
        for j, hi, lo, blob in self.conn.execute(
                "SELECT band_id, hi, lo, docs FROM bandkeys"):
            maps[j][(hi, lo)] = tuple(_unpack_docs(blob))
        return tuple(maps)

    def export_filters(self) -> tuple:
        """Per-band compaction filter copies (``None`` for a band that
        compacted nothing)."""
        return tuple(f.copy() if f is not None else None
                     for f in self._filters)

    def published(self) -> tuple:
        """What a ``SessionView`` holds of the disk index: no maps or
        filters, and the live store, whose pure ``probe_keys`` the view's
        probe calls."""
        return (), (), self

    def stats(self) -> dict:
        """Memory, recall and disk accounting (``BandIndex.stats`` and
        the primary filters' bytes and the file's size)."""
        (tracked,) = self.conn.execute(
            "SELECT COUNT(DISTINCT doc_id) FROM docentries").fetchone()
        return {
            "n_keys": sum(self._key_counts),
            "n_entries": self.n_entries(),
            "n_docs_tracked": int(tracked),
            "compacted_keys": self.compacted_keys,
            "filter_only_hits": self.filter_only_hits,
            "bloom_bytes": sum(f.memory_bytes for f in self._filters
                               if f is not None),
            "primary_bloom_bytes": sum(f.memory_bytes
                                       for f in self._primary),
            "file_bytes": self.file_size_bytes(),
        }

    # -- BandStoreBackend API ----------------------------------------------

    def insert_document(self, doc_id: int, band_sig: np.ndarray) -> None:
        """Streaming phase-1 write of one doc's (b, 2) band column."""
        self.put_band_rows([doc_id], np.asarray(band_sig)[None])

    def put_band_rows(self, doc_ids, bands: np.ndarray) -> None:
        """Insert a chunk, ``doc_ids`` (D,) and ``bands`` (D, b, 2), in one
        batch a band.  The rows, ``seq`` values and write counters equal
        those of ``insert_document`` called doc by doc and band by band
        (the reference's loop): a (doc, band) is one write of its key's
        whole bucket and one clock tick, and new keys enter the table in
        the order that loop inserts them."""
        bands = np.asarray(bands)
        ids = [int(d) for d in doc_ids]
        if not ids:
            return
        b = bands.shape[1]
        s0 = self._seq
        updates, inserts = [], []
        for j in range(b):
            col = bands[:, j, :]
            keys = list(map(tuple, col.tolist()))
            existing = self._select_keys(j, self._maybe_keys(j, col, keys))
            groups: dict[tuple[int, int], list] = {}  # [first, last, docs]
            for i, key in enumerate(keys):
                g = groups.get(key)
                if g is None:
                    groups[key] = g = [i, i, []]
                g[1] = i
                g[2].append(ids[i])
            new_keys = []
            for key, (first, last, new) in groups.items():
                seq = s0 + last * b + j + 1
                old = existing.get(key)
                if old is None:
                    inserts.append(((first, j), (j, key[0], key[1],
                                                 _pack_docs(new), seq)))
                    new_keys.append(key)
                    e = 0
                else:
                    updates.append((_pack_docs(old + new), seq, j,
                                    key[0], key[1]))
                    e = len(old)
                # The loop writes the bucket once a doc, 8 bytes an id.
                n = len(new)
                self.write_bytes += 8 * (n * e + n * (n + 1) // 2)
            if new_keys:
                self._primary[j].add_keys(np.array(new_keys,
                                                   dtype=np.uint32))
                self._key_counts[j] += len(new_keys)
        self._seq = s0 + len(ids) * b
        self.n_writes += len(ids) * b
        inserts.sort(key=lambda t: t[0])
        self.conn.executemany(
            "UPDATE bandkeys SET docs=?, seq=? WHERE band_id=? "
            "AND hi=? AND lo=?", updates)
        self.conn.executemany("INSERT INTO bandkeys VALUES (?,?,?,?,?)",
                              [row for _, row in inserts])

    def read_band(self, band_id: int):
        """All (doc, value) entries of one band, key-major.

        Keys come back value-sorted and each bucket in insertion order;
        the scan's stable lexsort by value then enumerates equal-value
        runs in the order a ``Design2Store`` scan would.
        """
        rows = self.conn.execute(
            "SELECT hi, lo, docs FROM bandkeys WHERE band_id=? "
            "ORDER BY hi, lo", (int(band_id),)).fetchall()
        if not rows:
            return (np.zeros(0, np.int64), np.zeros((0, 2), np.uint32))
        docs = np.frombuffer(b"".join(r[2] for r in rows), dtype="<i8")
        counts = np.fromiter((len(r[2]) // 8 for r in rows), dtype=np.int64,
                             count=len(rows))
        keys = np.array([r[:2] for r in rows], dtype=np.uint32)
        return (docs.astype(np.int64), np.repeat(keys, counts, axis=0))

    def probe_keys(self, bands: np.ndarray):
        """Bloom-first pure probe (see ``BandStoreBackend.probe_keys``).

        A query key the band's primary filter misses is a store miss with
        no disk touched; the filter's hits are confirmed by one batched
        SELECT (a false positive comes back empty).  Store misses that
        hit the band's compaction filter count as filter-only hits, as
        in the in-memory view walk.  Mutates nothing: no recency
        refresh, no counter.
        """
        bands = self._check_bands(bands, "Q")
        q = len(bands)
        cands: list[set[int]] = [set() for _ in range(q)]
        filter_hits = [0] * q
        for j in range(self._num_bands):
            col = bands[:, j, :]
            keys = list(map(tuple, col.tolist()))
            buckets = self._select_keys(j, self._maybe_keys(j, col, keys))
            flt = self._filters[j]
            in_filter = (flt.contains_keys(col).tolist()
                         if flt is not None else None)
            for i, key in enumerate(keys):
                olds = buckets.get(key)
                if olds is not None:
                    cands[i].update(olds)
                elif in_filter is not None and in_filter[i]:
                    filter_hits[i] += 1
        return ([np.array(sorted(s), dtype=np.int64) for s in cands],
                filter_hits)

    def probe_stats(self, bands: np.ndarray) -> dict:
        """Probe accounting of one query batch: how often a primary
        filter said "maybe", how many of those the disk confirmed, and
        the filters' false-positive rate.  Mutates nothing."""
        bands = np.asarray(bands)
        q = len(bands)
        probes = q * self._num_bands
        bloom_maybe = 0
        disk_hits = 0
        for j in range(self._num_bands):
            col = bands[:, j, :]
            keys = list(map(tuple, col.tolist()))
            hit = self._primary[j].contains_keys(col).tolist()
            maybe = [k for k, h in zip(keys, hit) if h]
            bloom_maybe += len(maybe)
            buckets = self._select_keys(j, sorted(set(maybe)))
            disk_hits += sum(1 for k in maybe if k in buckets)
        return {
            "probes": probes,
            "bloom_maybe": bloom_maybe,
            "disk_hits": disk_hits,
            "bloom_fps": bloom_maybe - disk_hits,
            "fp_rate": ((bloom_maybe - disk_hits) / probes
                        if probes else 0.0),
        }

    def compact(self, doc_ids, root_of) -> None:
        """Rewrite evicted docs' bucket entries onto their roots (the
        streaming store's retention hook): each bucket maps its evicted
        docs in place and keeps the first of repeated ids, as
        ``Design2Store.compact`` does; ``seq`` is left as it is."""
        ev = {int(d): int(root_of(int(d))) for d in doc_ids}
        if not ev:
            return
        updates = []
        for j, hi, lo, blob in self.conn.execute(
                "SELECT band_id, hi, lo, docs FROM bandkeys").fetchall():
            docs = _unpack_docs(blob)
            if ev.keys().isdisjoint(docs):
                continue
            mapped = list(dict.fromkeys(ev.get(d, d) for d in docs))
            updates.append((_pack_docs(mapped), j, hi, lo))
        if updates:
            self.conn.executemany(
                "UPDATE bandkeys SET docs=? WHERE band_id=? AND hi=? "
                "AND lo=?", updates)
        if self._track_entries:
            self.conn.executemany("DELETE FROM docentries WHERE doc_id=?",
                                  [(d,) for d in ev])
        self.conn.commit()

    def n_entries(self) -> int:
        (total,) = self.conn.execute(
            "SELECT COALESCE(SUM(LENGTH(docs)), 0) FROM bandkeys").fetchone()
        return int(total) // 8

    def commit(self) -> None:
        self.conn.commit()

    # -- disk-resident signature rows ---------------------------------------

    def put_signatures(self, doc_ids, rows: np.ndarray) -> None:
        """Store (D, M) uint32 signature rows (little-endian) of
        ``doc_ids``, replacing any earlier row of the same doc."""
        rows = np.ascontiguousarray(rows, dtype="<u4")
        self.conn.executemany(
            "INSERT OR REPLACE INTO sigs VALUES (?,?)",
            [(int(d), rows[i].tobytes()) for i, d in enumerate(doc_ids)])

    def get_signature(self, doc_id: int) -> np.ndarray | None:
        got = self.conn.execute("SELECT row FROM sigs WHERE doc_id=?",
                                (int(doc_id),)).fetchone()
        if got is None:
            return None
        return np.frombuffer(got[0], dtype="<u4").astype(np.uint32,
                                                          copy=False)

    def n_signatures(self) -> int:
        (n,) = self.conn.execute("SELECT COUNT(*) FROM sigs").fetchone()
        return int(n)

    def release_signatures(self, doc_ids) -> None:
        self.conn.executemany("DELETE FROM sigs WHERE doc_id=?",
                              [(int(d),) for d in doc_ids])


class DiskSignatureVerifier(BatchVerifier):
    """Signature-agreement verifier over the rows of a ``SqliteBandStore``.

    The sqlite tier's stand-in for the full (n_docs, M) matrix in RAM:
    rows live in the store's ``sigs`` table and are gathered on the host
    through an LRU cache of ``cache_rows`` rows (``cache_hits`` and
    ``cache_misses`` count its reads).  A batch's a-rows and b-rows go to
    ``device`` as int32 words and K2' scores them
    (``kernels.sigjaccard.pair_estimate``: K7's pre-gathered counts with
    every lane valid, divided by M in PyTorch and correctly rounded), so
    sims equal ``(a == b).mean(axis=-1, dtype=np.float32)`` bit for bit.
    ``device`` defaults to ``"cuda"`` and raises without a card unless
    ``"cpu"`` is passed; on the CPU K2' runs its plain version.

    ``release_rows`` deletes rows from disk as well as from the cache, so
    a bounded session gets a bounded file; verifying a released or
    unknown doc raises ``KeyError``.
    """

    def __init__(self, store: SqliteBandStore, num_hashes: int,
                 cache_rows: int = 4096, *, device="cuda"):
        super().__init__()
        self.store = store
        self.num_hashes = int(num_hashes)
        self.cache_rows = int(cache_rows)
        self.device = resolve_device(device)
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    @property
    def n_live_rows(self) -> int:
        return self.store.n_signatures()

    def _row(self, doc: int) -> np.ndarray:
        row = self._cache.get(doc)
        if row is not None:
            self._cache.move_to_end(doc)
            self.cache_hits += 1
            return row
        row = self.store.get_signature(doc)
        if row is None:
            raise KeyError(
                f"doc {doc} has no retained signature row (evicted by "
                "the retention policy, or never ingested)")
        self.cache_misses += 1
        self._cache[doc] = row
        if len(self._cache) > self.cache_rows:
            self._cache.popitem(last=False)
        return row

    def rows_for(self, doc_ids) -> np.ndarray:
        """(len(doc_ids), M) uint32 rows, read through the cache in order."""
        ids = np.asarray(doc_ids, dtype=np.int64).ravel().tolist()
        out = np.empty((len(ids), self.num_hashes), dtype=np.uint32)
        for i, d in enumerate(ids):
            out[i] = self._row(d)
        return out

    def extend_signatures(self, doc_ids, sig: np.ndarray) -> None:
        """Write a chunk's rows through to the store (the one copy)."""
        self.store.put_signatures(doc_ids, sig)

    def release_rows(self, doc_ids) -> None:
        """The retention hook: drop evicted docs' rows from disk and cache."""
        self.store.release_signatures(doc_ids)
        for d in doc_ids:
            self._cache.pop(int(d), None)

    def _verify_batch(self, pairs: np.ndarray) -> np.ndarray:
        a = u32_from_numpy(self.rows_for(pairs[:, 0]), self.device)
        b = u32_from_numpy(self.rows_for(pairs[:, 1]), self.device)
        return sigjaccard.pair_estimate(a, b).cpu().numpy()


def candidate_pairs_from_store(store, num_bands: int,
                               max_pairs_per_band=None):
    """Band-major candidate pairs over any band store: the sorted (P, 2)
    pairs of ``candidates.candidate_pairs`` over a ``StoreBandSource``
    (``num_docs`` plays no part in enumeration, so it is 0)."""
    from repro_torch.core.candidates import StoreBandSource, candidate_pairs

    return candidate_pairs(StoreBandSource(store, num_bands, 0),
                           max_pairs_per_band)
