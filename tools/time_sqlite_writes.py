"""Time ``SqliteBandStore.put_band_rows`` against the doc-by-doc loop.

The streaming backend writes each flush's band rows through the batched
``put_band_rows`` (one filter read and one joined SELECT a band).  The
reference writes the same flush with ``insert_document`` called doc by
doc, one point SELECT and one UPDATE or INSERT a (doc, band).  This
script records the flushes of ``chip_smoke.py``'s phase Q3 corpus
(``r3_notes``, 3,072 notes in 4 chunks, ``chunk_docs=512``) from one
append-only sqlite streaming session, replays them into fresh store
files both ways, checks that both leave the same raw ``bandkeys`` rows,
``seq`` clock and write counters, and prints each flush's seconds.

The work is host sqlite and Python, so it runs on the CPU by default:

    PYTHONPATH=src python tools/time_sqlite_writes.py [--reps 2]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.core.bandstore import (  # noqa: E402
    SqliteBandStore,
    _pack_docs,
    _unpack_docs,
)
from repro_torch.core.pipeline import DedupConfig  # noqa: E402
from repro_torch.core.session import DedupSession  # noqa: E402
from repro_torch.data import inject_near_duplicates, make_i2b2_like  # noqa: E402


def insert_loop(store: SqliteBandStore, doc_ids, bands) -> None:
    """The reference's write of a flush: ``insert_document`` for each doc,
    band by band, one point SELECT behind the primary filter and one
    UPDATE or INSERT of the key's whole bucket."""
    for i, doc in enumerate(doc_ids):
        for j, (hi, lo) in enumerate(np.asarray(bands[i]).tolist()):
            docs = None
            if (hi, lo) in store._primary[j]:
                got = store.conn.execute(
                    "SELECT docs FROM bandkeys WHERE band_id=? AND hi=? "
                    "AND lo=?", (j, hi, lo)).fetchone()
                if got is not None:
                    docs = _unpack_docs(got[0])
            store._seq += 1
            if docs is not None:
                docs.append(int(doc))
                blob = _pack_docs(docs)
                store.conn.execute(
                    "UPDATE bandkeys SET docs=?, seq=? WHERE band_id=? "
                    "AND hi=? AND lo=?", (blob, store._seq, j, hi, lo))
            else:
                blob = _pack_docs([int(doc)])
                store.conn.execute(
                    "INSERT INTO bandkeys VALUES (?,?,?,?,?)",
                    (j, hi, lo, blob, store._seq))
                store._primary[j].add((hi, lo))
                store._key_counts[j] += 1
            store.n_writes += 1
            store.write_bytes += len(blob)


def record_flushes(device: str) -> list:
    """The (doc ids, bands) of every ``put_band_rows`` call of Q3's
    append-only sqlite streaming session."""
    notes, prov = inject_near_duplicates(
        make_i2b2_like(cs.PHASE_A_NOTES, seed=0), cs.PHASE_A_DUPS, seed=1)
    notes3 = cs.r3_notes(notes, prov)
    size = -(-len(notes3) // cs.H_CHUNKS)
    chunks = [notes3[i : i + size] for i in range(0, len(notes3), size)]
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band", store="sqlite")
    flushes = []
    batch = SqliteBandStore.put_band_rows

    def spy(self, doc_ids, bands):
        flushes.append(([int(d) for d in doc_ids], np.array(bands)))
        return batch(self, doc_ids, bands)

    SqliteBandStore.put_band_rows = spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            sess = DedupSession(cfg, backend="streaming",
                                chunk_docs=cs.T_CHUNK_DOCS,
                                store_path=os.path.join(tmp, "q3.db"),
                                device=device)
            for _ in sess.ingest_stream(chunks):
                pass
            del sess
    finally:
        SqliteBandStore.put_band_rows = batch
    return flushes


def replay(write, flushes, path: str) -> tuple[list[float], tuple]:
    store = SqliteBandStore(path, num_bands=flushes[0][1].shape[1])
    seconds = []
    for doc_ids, bands in flushes:
        t0 = time.perf_counter()
        write(store, doc_ids, bands)
        store.commit()
        seconds.append(time.perf_counter() - t0)
    rows = store.conn.execute(
        "SELECT * FROM bandkeys ORDER BY rowid").fetchall()
    state = (rows, store._seq, store._key_counts, store.n_writes,
             store.write_bytes)
    store.conn.close()
    return seconds, state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    flushes = record_flushes(args.device)
    out = {"flushes": [len(ids) for ids, _ in flushes],
           "num_bands": int(flushes[0][1].shape[1]), "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(args.reps):
            states = []
            for name, write in (("batch", SqliteBandStore.put_band_rows),
                                ("loop", insert_loop)):
                seconds, state = replay(
                    write, flushes, os.path.join(tmp, f"{name}{rep}.db"))
                states.append(state)
                out["runs"].append({"write": name, "rep": rep,
                                    "seconds": sum(seconds),
                                    "per_flush_s": seconds,
                                    "n_writes": state[3],
                                    "write_bytes": state[4]})
            cs.check(states[0] == states[1],
                     "batch and loop leave the same rows, clock and counters")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
