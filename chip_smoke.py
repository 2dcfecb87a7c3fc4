#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their plain versions.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a) and reads the build back: K1's min loop on the main path's lane
map (``k1_sass``: at most 6.75 ALU instructions and 6.75 / 64 SM clocks
a (position, seed) triple, no spills in any instantiation), K2's and K7's
instantiations (``k2_sass``: 16-byte loads, ``LDG.E.128``, and no spills
in the vector path of each of the three pair-count entry points),
K6's and K3's two paths (``k6_sass``, ``k3_sass``: ``LDG.E.128`` and
``STG.E.128`` in the vector path, no spills), and K4's min loop on the
main path's lane map (``k4_sass``: K1's gate, no spills in any of its
eight instantiations).  Every pair-count line says which path ran
(16-byte or scalar loads) and G, the lanes a pair, and gives the
gathered bytes at HBM's rate as a second floor beside the bound.  Then it runs these phases:

* Phase A, the main path: ``DedupPipeline.run`` with K1 (fused ingest)
  and K2 (pair agreement counts) on 16,384 synthetic clinical notes.
  Signatures and bands are held bit for bit against K1's plain version
  on the same packed matrix, every pair similarity against K2's plain
  counts / M, and labels, keep mask and pairs against the plain path
  (staged PyTorch signatures, numpy verifier) on the same notes.  K2's
  launches over the run's pairs, in the verifier's batches, are timed
  per call (host and device) and replayed from a CUDA graph (device
  alone); the run's ``verify_s`` per flush is reported.
* Phase A2, byte ingest: ``run`` with ``byte_ingest`` on the same notes,
  through K6 (byte token hashes), K1 and K2.  Signatures and bands are
  held against K6's plain version + compaction + K1's plain version on
  the same bytes and against the host no-stem chain; labels, keep mask
  and pairs against a plain-signature ``ClusterAccumulator`` with the
  numpy verifier.
* Phase A3, staged kernels: ``run`` with ``use_kernels`` and no fused
  ingest, through K3 (n-gram hashes and validity, one launch), K4
  (minhash) and K2; every output equals phase A's.  Then the
  ``kernels.ops`` entry point K3 -> K4 -> K5 (band fold) on phase A's
  matrix, each kernel against its plain version, K3's path and K4's
  lane map and path reported, K3 and K4 also timed from a CUDA graph.
* Phase H, the session layer and the read path on phase A's notes: a
  host ``DedupSession`` with phase A's config over 4 chunks (H1: K1 once
  a chunk, and K2), the same on the cut corpus (``cut_notes``: phase
  A's first 3,328 notes and near-duplicates of 768 of them; the record
  of R1, T1 and Q1), and with phase A2's config on the cut corpus (H2: K6,
  compaction, K1, K2), each holding its one-shot run's signatures,
  partition, keep mask and every shared pair's similarity, and every
  pair's similarity against K2's plain counts / M; a
  ``DedupQueryService`` with the ``kernel`` backend over H1 and H2 (H3:
  every 16th ingested note and 64 novel ones in microbatches of 64,
  through ``query`` and ``query_bytes``) equal to its ``numpy`` twin,
  every ingested note answering with similarity 1.0 and its own root,
  and the probe's dict walk timed against a device
  searchsorted probe, index build included, on H3's traffic, on every
  ingested note and on the CLI's 65 queries; and the dedup CLI,
  ``python -m repro_torch.launch.dedup``, run as a user runs it (H4).
* Phase R, bounded retained state with phase H's config and chunk
  count: R1 the cut corpus under an LRU window of 256 (labels and (a,
  b, sim) list equal phase H's record of it, rows evicted, retained
  rows, representatives, no filter-only hits; up to 64 evicted docs
  queried through a ``kernel``
  ``DedupQueryService`` answer with their cluster through a retained
  doc); R2 under ``RetentionPolicy.preset("small", refine_every=2)``
  on phase A's first 4,096 notes
  (keys compacted into Bloom filters, two refines, each refine's K5 fold
  equal to ``core.lsh.band_values`` on the same rows and each merge's sim
  equal to K2's plain counts / M and above the edge threshold, a query
  batch finding compacted keys without touching the session's count);
  R3 2,560 notes and 512 of their near-duplicates under R2's policy on
  the card and on the CPU, equal field by field, with rows evicted and
  keys compacted; R4 the dedup CLI with ``--retain-budget small
  --refine-every 2``.  K1, K2 and K5 launches are counted per run, and
  K5 is timed at the last refine's representative count.
* Phase T, the streaming backend with phase H's config, each band store
  a file in a temporary directory: T1 the cut corpus in 4 chunks through
  ``DedupSession(backend="streaming", chunk_docs=512)`` (K1 once a
  flush, K2), its partition, keep mask and shared sims equal phase H's
  record of it and no pair verified twice, each step split into phase 1,
  the store re-scan and the engine, with the store's write metrics; T2
  ``r3_notes`` byte streaming (K6 and K1) equal to a token streaming
  session fed no-stem token lists; T3 ``r3_notes`` under an LRU window
  of 128, equal to the append-only streaming session with a smaller
  store, on the card and on the CPU field by field; T4 a standalone
  ``StreamingDedup`` clustered at edge thresholds 0.75 and 0.6 with no
  K1 launch, then adopted by ``over_store`` and fed a copy of doc 0; T5
  the CLI's ``--streaming`` with H4's duplicate count.
  ``launches_phase_t`` on the K1, K2 and K6 lines.
* Phase Q, the sqlite band-store tier, each store a file in a temporary
  directory: Q1 the cut corpus in 4 chunks through a host session with
  ``store="sqlite"`` (its cross-step index a ``SqliteBandStore``; K1
  once a chunk, K2), labels and (a, b, sim) list equal to phase H's
  memory-tier record of it, with each step's cross-step time and edges
  and the store's counters; Q2 H3's queries through a ``kernel``
  ``DedupQueryService`` over Q1's view, probed through the store's
  Bloom-first ``probe_keys``, equal to the same service over the
  memory-tier record, with the probe's Bloom accounting; Q3 ``r3_notes``
  through a sqlite streaming session, append-only and under T3's
  window, verified off disk by ``DiskSignatureVerifier`` (K2', no K2),
  equal to T3's memory-tier sessions, every sim equal to K2's plain
  counts / M on the rows read back from disk, the window's signature
  rows and store entries shrunk to T3's; K2' timed on one verify batch
  of those rows; Q4 the CLI's ``--streaming --store sqlite`` with H4's
  duplicate count.  ``launches_phase_q`` on the K1, K2 and K2' lines.
* Phase S, the sharded step (``core.dist_lsh``) on the card over an
  NCCL process group of one rank, on phase A's packed matrix: stage 2
  on the host merge with K2, then on the device with K7 (masked pair
  counts).  Signatures equal phase A's, both runs' edge buffers are
  equal, nothing overflows, the device run's labels and (a, b, sim)
  list equal the host run's, and K7 equals its plain version on the
  step's gathered edges (its 5 launches timed per call and from a CUDA
  graph).
* Phase D, the sharded ``DedupSession`` (``backend="sharded"``) over the
  same NCCL group: D1 phase A's notes in 4 chunks (the third ending
  1,024 notes into the near-duplicates) at full width, K1 and device
  stage 2 (K7), phase S's buffers, under an LRU window of 1,024: its
  signatures and retained rows equal phase A's, nothing overflowed or
  re-scored on the host, rows evicted, also by the sweeps between band
  groups, every pair's similarity equal to K2's plain counts / M, its
  partition and shared sims equal to phase S's one-shot step's, each
  chunk's step timed alone; D2
  ``r3_notes`` in 3 chunks with host stage 2 on the card and on the CPU
  field by field, byte ingest (K6, K1) against no-stem tokens, device
  against host stage 2; D4 D2's notes and chunks under the ``small``
  preset refining every 2 steps, host and device stage 2, the card
  against the CPU and the sqlite index against the memory one field by
  field (rows evicted, keys compacted, refine's K5 and K2 launches),
  and 64 of H3's queries through ``query_view`` over the sqlite view
  against the memory view; D3 the CLI's ``--sharded --stage2 device
  --retain-budget small --refine-every 2 --store sqlite`` on the card
  against the same command on the CPU.  ``launches_phase_d`` on the
  K1, K2, K5, K6 and K7 lines.
* Phase B, paper-scale kernels: K1, and K3 -> K4 -> K5, on a 1,048,576 x
  256 token matrix (a tenth of the paper's 10M-note corpus as one ingest
  chunk); K2 on 16,777,216 random pairs through ``SignatureVerifier``;
  K7 on 16,777,216 pairs (indexed) and 4,194,304 pairs (pre-gathered);
  K6 and ``bytes_to_bands`` on 524,288 text-like rows of 2,048 bytes,
  the latter also step by step with CUDA events between its steps (pad,
  K6, compaction, K1; phase A2 does the same on its notes).
  Each kernel against its plain version bit for bit, K3's validity,
  K4's signatures and K5's bands against K1's, and K4 once more under a
  mask that is not a prefix (each row's odd positions cleared).
* Phase S2, the sharded step at one ingest chunk: phase B's matrix with
  65,536 rows made copies of others, device stage 2, the step timed
  part by part (K1, each band group's prescreen, K7); every planted
  copy's edge is found with count M.  Phase B also holds
  ``kernels.ops.pair_estimate`` (K7's pre-gathered form, every lane
  valid) against its plain version and K2's estimates.
* Phase F, K8 (flash attention) against its plain version: float32 at
  test_kernels.py's four shapes and at h2o-danube's, olmo's and gemma's
  prefill shapes to 3e-5, each timed beside its plain version and SDPA
  in float32; bf16 at the three prefill shapes to a bound of bf16's
  rounding (and to 2e-2), each timed beside the plain version and
  ``scaled_dot_product_attention``.  The built library's SASS shows
  tensor-core HMMA instructions in every bf16 instantiation and none in
  the float32 kernel; ptxas's registers, shared memory and spills (none
  allowed in any instantiation) and K8's own build time are printed.
* Phase M, serving h2o-danube-1.8b at full width: in float32, K8
  against ``blockwise_attention`` in every layer of a 6,144-token
  prefill and end to end at two layers; in bf16, ``serve_batch``
  (4 x 512 prompt tokens + 32, and 1 x 6,144 + 8) and ``ServeEngine``
  (8 requests over 4 slots), K8 launching once per layer per prefill.

Every line but the last is one JSON object; the last is
``{"ok": true, "device": {...}}``.  Any mismatch or fault raises, so the
script exits non-zero and prints no result; so it does without a CUDA
device, or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM rates (NVIDIA data sheet; the card's power limit is printed
# beside every run).  Integer work per SM and clock (CUDA programming
# guide, throughput table, compute capability 9.0): 64 lanes on the ALU
# pipe (add, logic, shift, compare, min), 64 lanes of 32-bit integer
# multiply (IMAD, on the FMA pipe, beside the ALU pipe), and four warp
# instructions issued, 128 lanes.  The clock is the card's maximum SM
# clock as nvidia-smi reports it.
HBM_BYTES_PER_S = 3.35e12
SMS, ALU_LANES, MUL_LANES, ISSUE_LANES = 132, 64, 64, 128

PHASE_A_NOTES, PHASE_A_DUPS = 12288, 4096
PHASE_B_DOCS, PHASE_B_LEN, PHASE_B_PAIRS = 1 << 20, 256, 1 << 24
# Byte ingest at paper scale: half of phase B's documents, so the byte
# matrix (1 GiB) and its per-position outputs (8 GiB) stay far inside
# the card's memory.
PHASE_B_BYTE_DOCS, PHASE_B_BYTES = 1 << 19, 2048
VERIFY_BATCH = 8192  # SignatureVerifier's default batch: K2's main-path launch size


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    emit(nvidia_smi=smi_query("name,power.limit"))
    clock_hz = float(smi_query("clocks.max.sm", units=False)) * 1e6

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib_path, log = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    # Create the CUDA context before any timed work.
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    emit(build={"seconds": build_s, "library": lib_path.name,
                "nvcc_s": nvcc_seconds(log),
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln]},
         context_s=time.perf_counter() - t0, clock_max_hz=clock_hz)
    k1_sass = k1_sass_check(lib_path, log)
    emit(k1_sass=k1_sass)
    emit(k2_sass=k2_sass(lib_path, log))
    emit(k6_sass=io_sass(lib_path, log, K6_KERNEL, "K6"))
    emit(k3_sass=io_sass(lib_path, log, K3_KERNEL, "K3"))
    emit(k4_sass=k4_sass(lib_path, log))

    from repro_torch.data import inject_near_duplicates, make_i2b2_like

    t0 = time.perf_counter()
    notes, prov = inject_near_duplicates(
        make_i2b2_like(PHASE_A_NOTES, seed=0), PHASE_A_DUPS, seed=1)
    emit(corpus={"notes": len(notes), "seconds": time.perf_counter() - t0})
    ctx, k1_line, k2_line = phase_a(torch, clock_hz, notes)
    k6_line = phase_a2(torch, clock_hz, notes, ctx)
    k3_line, k4_line, k5_line = phase_a3(torch, clock_hz, notes, ctx)
    t0 = time.perf_counter()
    h_launches = phase_h(torch, notes, prov, ctx)
    emit(phase_h={"seconds": time.perf_counter() - t0,
                  "launches": h_launches})
    for line in (k1_line, k2_line, k6_line):
        line["launches_phase_h"] = {path: counts[line["name"]]
                                    for path, counts in h_launches.items()}
    # Phase R takes H1's record, and R1, T1 and Q1 compare against phase
    # H's record of the cut notes (``ctx["h1_cut"]``).
    ctx["d_h1_ingest_s"] = ctx["h1"]["summary"]["ingest_s"]
    t0 = time.perf_counter()
    r_launches, k5_refine = phase_r(torch, clock_hz, notes, prov, ctx)
    emit(phase_r={"seconds": time.perf_counter() - t0,
                  "launches": r_launches})
    for line in (k1_line, k2_line, k5_line):
        line["launches_phase_r"] = {path: counts[line["name"]]
                                    for path, counts in r_launches.items()}
    k5_line["refine"] = k5_refine
    t0 = time.perf_counter()
    t_launches = phase_t(torch, notes, prov, ctx)
    emit(phase_t={"seconds": time.perf_counter() - t0,
                  "launches": t_launches})
    for line in (k1_line, k2_line, k6_line):
        line["launches_phase_t"] = {path: counts[line["name"]]
                                    for path, counts in t_launches.items()}
    t0 = time.perf_counter()
    q_launches, k2p_batch = phase_q(torch, clock_hz, notes, prov, ctx)
    emit(phase_q={"seconds": time.perf_counter() - t0,
                  "launches": q_launches})
    for line in (k1_line, k2_line):
        line["launches_phase_q"] = {path: counts[line["name"]]
                                    for path, counts in q_launches.items()}
    import torch.distributed as dist

    # One NCCL group of one rank: the sharded step's collectives run on
    # the card, and an in-memory store needs no network.
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        k7_line = phase_s(torch, clock_hz, ctx)
        t0 = time.perf_counter()
        d_launches = phase_d(torch, notes, prov, ctx)
        emit(phase_d={"seconds": time.perf_counter() - t0,
                      "launches": d_launches})
        paper = phase_b(torch, clock_hz, k1_sass)
    finally:
        dist.destroy_process_group()
    for line in (k1_line, k2_line, k5_line, k6_line, k7_line):
        line["launches_phase_d"] = {path: counts[line["name"]]
                                    for path, counts in d_launches.items()}
    lines = [k1_line, k2_line, k3_line, k4_line, k5_line, k6_line, k7_line]
    for line in lines:
        line["paper_scale"] = paper[line["name"]]
    # K2''s main path is phase Q3's disk verify: one of its batches
    # timed, the append-only run's launches; phase B's run at paper scale.
    lines.append({"name": "pair_estimate", "route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/sigjaccard_masked.cu",
                  "replaces": "src/repro/kernels/sigjaccard.py:53",
                  "library_ms": None, "match": True, **k2p_batch,
                  "launches": q_launches["q3_append_only"]["pair_estimate"],
                  "launches_phase_q": {path: counts["pair_estimate"]
                                       for path, counts in q_launches.items()},
                  "paper_scale": paper["pair_estimate"]})
    torch.cuda.empty_cache()
    k8_shapes = phase_f(torch, clock_hz, lib_path, log)
    lines.append(phase_m(torch, k8_shapes))
    emit(kernels=lines)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def smi_query(fields: str, units: bool = True) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the first card."""
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# -- timing and bounds ----------------------------------------------------------

def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn``'s launches replayed from a CUDA graph:
    the same kernels with no host work between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, reps)


def gathered(nbytes: int, ms: float) -> dict:
    """A second floor for the pair counts: the gathered bytes (two rows a
    pair, each read as often as a pair names it) at HBM's rate, and the
    rate a time of ``ms`` reaches on them."""
    return {"gathered_floor_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "gathered_tb_per_s": nbytes / (ms * 1e-3) / 1e12}


def pair_path(k2, M: int, a, b) -> dict:
    """Which pair-count path the launchers take for these rows."""
    G, path = k2.schedule(M, a, b)
    return {"G": G, "path": path, "pairs_per_warp": 32 // G}


class ChunkTimer:
    """Sums device time over chunks, leaving the checks between them out."""

    def __init__(self, torch):
        self.torch = torch
        self.pairs = []

    def __enter__(self):
        self.start = self.torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = self.torch.cuda.Event(enable_timing=True)
        end.record()
        self.pairs.append((self.start, end))

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def k1_bound(torch, lengths, L: int, M: int, n: int, r: int,
             clock_hz: float) -> dict:
    """Least time for K1 on these inputs: the larger of bytes and operations.

    Operations count what this data needs, by the pipe that can run
    them.  Each (valid position, seed) triple: the seed add, fmix32 (two
    multiplies, three shifts, three xors) and half a min (sm_90's
    three-input min folds two values into the minimum at once).  Each valid
    position: its n-gram hash (n multiply-adds, fmix32) and the multiply
    by the golden constant, which no seed changes.  Each fold step: one
    multiply-add and fmix32.  Bytes: each input read once, each output
    written once.
    """
    ln = lengths.to(torch.int64)
    nvalid = torch.where(ln >= n, ln - n + 1, (ln > 0).to(torch.int64))
    V = int(nvalid.clamp(max=L).sum())
    D = lengths.shape[0]
    triples, folds = V * M, D * (M // r) * 2 * r
    ops = {"alu": triples * 3.5 + V * 3 + folds * 3,
           "mul": triples * 2 + V * (n + 3) + folds * 3,
           "either": triples * 4 + V * 3 + folds * 3}
    nbytes = D * L * 4 + D * 4 + M * 4 + D * M * 4 + D * (M // r) * 2 * 4 + D * L
    return _bound(ops, nbytes, clock_hz) | {"valid_positions": V,
                                            "triples": triples}


def k2_bound(D: int, M: int, P: int, clock_hz: float) -> dict:
    """Least time for K2: sig and both index vectors read once, counts
    written once, and M compares plus M adds per pair.  ``gathered_bytes``
    is what a gather without row reuse moves (two rows per pair)."""
    nbytes = D * M * 4 + P * 8 * 2 + P * 4
    return _bound({"alu": P * M, "mul": 0, "either": P * M}, nbytes,
                  clock_hz) | {"gathered_bytes": P * 2 * M * 4}


def k7_bound(torch, valid, M: int, clock_hz: float, a=None, b=None,
             D: int = 0) -> dict:
    """Least time for K7 on this data; M compares and M adds per valid
    lane, and lanes that are not valid read no row.  Pre-gathered form
    (no ``a``, ``b``): the two rows of every valid lane, the mask and the
    counts, each once.  Indexed form: the distinct rows (indices clipped
    to [0, D)) that the valid lanes gather from the (D, M) matrix, each
    read once, plus both int32 indices, the mask and the counts."""
    P, V = valid.shape[0], int(valid.sum())
    if a is None:
        rows, extra = V * 2, 0
    else:
        ids = torch.cat([a[valid], b[valid]]).to(torch.int64)
        rows, extra = int(torch.unique(ids.clamp(0, D - 1)).numel()), 8
    nbytes = rows * M * 4 + P * (1 + 4 + extra)
    return _bound({"alu": V * M, "mul": 0, "either": V * M}, nbytes,
                  clock_hz) | {"pairs": P, "valid_pairs": V, "rows_read": rows,
                               "gathered_bytes": V * 2 * M * 4}


def k3_bound(D: int, L: int, n: int, clock_hz: float) -> dict:
    """Least time for ``ngram_hashes``: tokens and lengths read once,
    hashes and validity written once; each position n multiply-adds and
    fmix32 (two multiplies, three shifts, three xors)."""
    P = D * L
    return _bound({"alu": P * 3, "mul": P * (n + 2), "either": P * 3},
                  P * 9 + D * 4, clock_hz)


def k4_bound(valid, M: int, clock_hz: float) -> dict:
    """Least time for K4, counted as K1's min loop: each (valid position,
    seed) triple the seed add, fmix32 and half a three-input min; each
    valid position its multiply by the golden constant.  Bytes: hashes,
    mask and seeds read once, signatures written once."""
    D, L = valid.shape
    V = int(valid.sum())
    triples = V * M
    ops = {"alu": triples * 3.5, "mul": triples * 2 + V, "either": triples * 4}
    nbytes = D * L * 4 + D * L + M * 4 + D * M * 4
    return _bound(ops, nbytes, clock_hz) | {"valid_positions": V,
                                            "triples": triples}


def k5_bound(D: int, M: int, r: int, clock_hz: float) -> dict:
    """Least time for K5: signatures read once, band values written once;
    each of the 2r fold steps per band one multiply-add and fmix32."""
    folds = D * (M // r) * 2 * r
    return _bound({"alu": folds * 3, "mul": folds * 3, "either": folds * 3},
                  D * M * 4 + D * (M // r) * 8, clock_hz)


def k6_bound(D: int, W: int, token_bytes: int, tokens: int,
             clock_hz: float) -> dict:
    """Least time for K6 on this data: bytes and lengths read once, ids
    and ends (int32 each) written once.  Each position: its byte's class
    (three range checks, the length check) and the end test; each token
    byte: the case fold and an FNV-1a step (xor, multiply); each token:
    its id, hash_u32 (a multiply-add and fmix32)."""
    P = D * W
    ops = {"alu": P * 8 + token_bytes * 2 + tokens * 3,
           "mul": token_bytes + tokens * 3,
           "either": P * 3 + token_bytes + tokens * 4}
    return _bound(ops, P + D * 4 + P * 8, clock_hz) | {
        "token_bytes": token_bytes, "tokens": tokens}


def ops_ms(alu: float, mul: float, either: float, clock_hz: float) -> float:
    """Least time of integer work on the card, split by pipe.

    ``alu`` runs only on the ALU pipe (logic, compare, min), ``mul`` only
    on the multiply pipe, ``either`` on both (an add is an IMAD by 1, a
    shift an IMAD.HI or IMAD.SHL by a power of two); every operation
    takes an issue slot.
    """
    cycles = max(alu / ALU_LANES, mul / MUL_LANES,
                 (alu + mul + either) / ISSUE_LANES)
    return cycles / (SMS * clock_hz) * 1e3


def _bound(ops: dict, nbytes: int, clock_hz: float) -> dict:
    t_ops = ops_ms(ops["alu"], ops["mul"], ops["either"], clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes, "ops": ops, "bytes": nbytes}


# Opcodes of the integer ALU pipe.  VIADD (new in sm_90) is counted here;
# its pipe is not documented.
ALU_OPS = {"IADD3", "VIADD", "LOP3", "SHF", "ISETP", "IMNMX", "VIMNMX",
           "VIMNMX3", "SEL", "LEA", "MOV", "PRMT", "IABS", "POPC", "FLO"}


def sass_functions(lib_path) -> dict[str, str]:
    """Each kernel's SASS listing in the built library (``cuobjdump
    -sass``), by its mangled name."""
    from repro_torch.kernels import build

    text = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    return {f.split("\n", 1)[0].strip(): f
            for f in text.split("Function : ")[1:]}


def ptxas_entries(log: str) -> dict[str, dict]:
    """ptxas's report (``-Xptxas -v`` in the build log) for each kernel,
    by mangled name: registers, static shared memory, spill bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = out.setdefault(entry.group(1), {})
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            cur["spill_stores"], cur["spill_loads"] = map(int, spill.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            cur["registers"] = int(used.group(1))
            cur["static_smem"] = int(smem.group(1)) if smem else 0
    return out


# The pair-count kernels' instantiations: K2's kernel, and K7's one kernel
# over IndexedRows or GatheredRows, each for G lanes a pair and a path.
PAIR_KERNEL = re.compile(r"(masked_pair_counts_kernel|pair_counts_kernel)"
                         r"ILi(\d+)ELb([01])E")
PAIR_ENTRIES = ("pair_counts", "masked_indexed_pair_counts",
                "masked_pair_counts")


def pair_kernel_id(name: str):
    """(entry point, G, vector path?) of a pair-count kernel's mangled
    name, else None."""
    m = PAIR_KERNEL.search(name)
    if m is None:
        return None
    entry = ("pair_counts" if m.group(1) == "pair_counts_kernel"
             else "masked_indexed_pair_counts" if "IndexedRows" in name
             else "masked_pair_counts")
    return entry, int(m.group(2)), m.group(3) == "1"


def k2_sass(lib_path, log: str) -> list[dict]:
    """K2's and K7's build read back: for each instantiation, its global
    loads in SASS (``LDG.E.128`` is a 16-byte load) and ptxas's registers
    and spills.  Fails unless every vector-path instantiation of each of
    the three entry points loads 16 bytes at a time and spills nothing."""
    ptxas = {}
    for name, rep in ptxas_entries(log).items():
        key = pair_kernel_id(name)
        if key is not None:
            ptxas[key] = rep
    out = []
    for name, listing in sass_functions(lib_path).items():
        key = pair_kernel_id(name)
        if key is None:
            continue
        loads = re.findall(r"\bLDG\.[A-Z0-9_.]*", listing)
        out.append({"entry": key[0], "G": key[1],
                    "path": "vector" if key[2] else "scalar",
                    "ldg_128": sum(".128" in op for op in loads),
                    "ldg_kinds": sorted(set(loads)), **ptxas.get(key, {})})
    for entry in PAIR_ENTRIES:
        vec = [r for r in out if r["entry"] == entry and r["path"] == "vector"]
        check(len(vec) == 6, f"{entry}: six vector-path instantiations "
              f"(G = 1 .. 32) in SASS ({len(vec)})")
        check(all(r["ldg_128"] > 0 for r in vec),
              f"{entry}: LDG.E.128 in every vector-path instantiation ({vec})")
        check(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                  for r in vec),
              f"{entry}: ptxas reports no spills on the vector path ({vec})")
    return sorted(out, key=lambda r: (r["entry"], r["path"], r["G"]))


# K1's instantiations, one for each S (seeds a lane), and K6's, one for each
# path (16-byte or scalar).
K1_KERNEL = re.compile(r"fused_ingest_kernelILi(\d+)E")
K6_KERNEL = re.compile(r"byte_token_hashes_kernelILb([01])E")
# K3's, one for each path, and K4's, one for each S and path.
K3_KERNEL = re.compile(r"ngram_hashes_kernelILb([01])E")
K4_KERNEL = re.compile(r"minhash_kernelILi(\d+)ELb([01])E")
# K1's min loop, read from the instantiation the main path runs (M 100,
# rows of 256 tokens), must keep within these: ALU instructions a triple,
# and SM clocks a triple at full issue.  They are a regression floor set
# by the shipped loop (three SHF, three LOP3 and half a VIMNMX3 a triple,
# 6.5 ALU instructions, plus 0.25 of loop overhead; it reads 6.625), not a
# target: 5.5 and 0.09 a triple are reached only with fmix32's shifts on
# the FMA pipe as IMAD.HI, which issues at half IMAD's rate on the H100
# and measured slower (PERF.md).
K1_MAX_ALU = 6.75
K1_MAX_CYCLES = K1_MAX_ALU / ALU_LANES
# K1's instantiations: one for each S of kSeedsPerLane.
K1_SEEDS_PER_LANE = (1, 2, 4, 8)
# IMAD forms that issue at half IMAD's rate on the H100, two FMA-pipe
# slots each (PERF.md).
HALF_RATE_IMAD = ("IMAD.HI", "IMAD.WIDE")


def spill_free(rows: list[dict]) -> bool:
    return all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
               for r in rows)


def k1_sass_check(lib_path, log: str) -> dict:
    """K1's build read back: the main path's min loop (``sass_mix``) and
    ptxas's registers and spills for each S.  Fails where the loop spends
    more than ``K1_MAX_ALU`` ALU instructions or ``K1_MAX_CYCLES`` clocks
    a triple, or any instantiation spills."""
    from repro_torch.kernels import fused_ingest as k1

    plan = k1.schedule(100, 256)
    mix = sass_mix(lib_path, f"fused_ingest_kernelILi{plan['S']}E")
    ptxas = sorted(({"S": int(K1_KERNEL.search(name).group(1)), **rep}
                    for name, rep in ptxas_entries(log).items()
                    if K1_KERNEL.search(name)), key=lambda r: r["S"])
    check(mix["per_triple"]["alu"] <= K1_MAX_ALU,
          f"K1's min loop: at most {K1_MAX_ALU} ALU instructions a triple "
          f"({mix['per_triple']})")
    check(mix["cycles_per_triple"] <= K1_MAX_CYCLES,
          f"K1's min loop: at most {K1_MAX_CYCLES} clocks a triple "
          f"({mix['cycles_per_triple']})")
    check(tuple(r["S"] for r in ptxas) == K1_SEEDS_PER_LANE
          and spill_free(ptxas),
          f"K1: an instantiation for each S, none spilling ({ptxas})")
    return mix | {"lane_map": plan, "ptxas": ptxas}


def k4_sass(lib_path, log: str) -> dict:
    """K4's build read back: the main path's min loop (``sass_mix``, the
    16-byte path's instantiation) and ptxas's registers and spills for each
    S and path.  Fails where the loop exceeds K1's gate (``K1_MAX_ALU``
    ALU instructions, ``K1_MAX_CYCLES`` clocks a triple) or any
    instantiation spills."""
    from repro_torch.kernels import minhash as k4

    plan = k4.schedule(100, 256)
    mix = sass_mix(lib_path, f"minhash_kernelILi{plan['S']}ELb1E")
    ptxas = sorted(({"S": int(m.group(1)),
                     "path": "vector" if m.group(2) == "1" else "scalar", **rep}
                    for name, rep in ptxas_entries(log).items()
                    if (m := K4_KERNEL.search(name))),
                   key=lambda r: (r["path"], r["S"]))
    check(mix["per_triple"]["alu"] <= K1_MAX_ALU,
          f"K4's min loop: at most {K1_MAX_ALU} ALU instructions a triple "
          f"({mix['per_triple']})")
    check(mix["cycles_per_triple"] <= K1_MAX_CYCLES,
          f"K4's min loop: at most {K1_MAX_CYCLES} clocks a triple "
          f"({mix['cycles_per_triple']})")
    check(len(ptxas) == 2 * len(K1_SEEDS_PER_LANE) and spill_free(ptxas),
          f"K4: an instantiation for each S and path, none spilling ({ptxas})")
    return mix | {"lane_map": plan, "ptxas": ptxas}


def io_sass(lib_path, log: str, kernel: re.Pattern, name: str) -> list[dict]:
    """A streaming kernel's build read back (K3, K6): each path's global
    loads and stores in SASS (``.128`` is 16 bytes) and ptxas's registers
    and spills.  ``kernel`` matches its instantiations, group 1 the path
    (1: vector).  Fails unless the vector path loads and stores 16 bytes
    at a time and neither path spills."""
    ptxas = {kernel.search(n).group(1) == "1": rep
             for n, rep in ptxas_entries(log).items() if kernel.search(n)}
    out = []
    for fn, listing in sass_functions(lib_path).items():
        m = kernel.search(fn)
        if m is None:
            continue
        vec = m.group(1) == "1"
        loads = re.findall(r"\bLDG\.[A-Z0-9_.]*", listing)
        stores = re.findall(r"\bSTG\.[A-Z0-9_.]*", listing)
        out.append({"path": "vector" if vec else "scalar",
                    "ldg_128": sum(".128" in op for op in loads),
                    "stg_128": sum(".128" in op for op in stores),
                    "ldg_kinds": sorted(set(loads)),
                    "stg_kinds": sorted(set(stores)), **ptxas.get(vec, {})})
    vec = [r for r in out if r["path"] == "vector"]
    check(len(vec) == 1 and vec[0]["ldg_128"] > 0 and vec[0]["stg_128"] > 0,
          f"{name}'s vector path loads and stores 16 bytes at a time ({out})")
    check(len(out) == 2 and spill_free(out), f"{name}: no spills ({out})")
    return sorted(out, key=lambda r: r["path"])


def sass_mix(lib_path, kernel: str) -> dict:
    """The instruction mix of ``kernel``'s min loop, per (position, seed) triple.

    Reads the built library with ``cuobjdump -sass``, takes the loop (a
    backward branch) densest in min operations among those that also hold
    the hash's two multiplies a triple and, where the kernel reads 16
    bytes of shared memory anywhere, such a read (a loop that only takes
    minima, such as a reduction, is not the min loop), and sorts its
    instructions by pipe: ``fma`` (IMAD in all its forms, in FMA-pipe
    slots: two for ``HALF_RATE_IMAD``), ``alu`` (``ALU_OPS``) and
    ``other`` (shared-memory loads, branches).  A three-input min is two
    triples.  ``cycles_per_triple`` is the SM clocks the loop needs per
    triple at full issue: the largest of ALU and FMA pipe work over 64
    lanes and all instructions over 128.
    """
    listing = next(f for name, f in sass_functions(lib_path).items()
                   if kernel in name)
    ins = [(int(addr, 16), op, rest) for addr, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
        listing)]

    def mins(body):
        return sum({"VIMNMX3": 2, "VIMNMX": 1, "IMNMX": 1}.get(op.split(".")[0], 0)
                   for _, op, _ in body)

    loops = []
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            loops.append([x for x in ins if lo <= x[0] <= addr])
    check(bool(loops), f"{kernel}: no loop in the SASS listing")

    vec_reads = any(op == "LDS.128" for _, op, _ in ins)

    def hashes(body):
        ops = [op for _, op, _ in body]
        return (sum(op.split(".")[0] == "IMAD" for op in ops)
                >= 2 * mins(body) > 0
                and (not vec_reads or "LDS.128" in ops))

    body = max([b for b in loops if hashes(b)] or loops,
               key=lambda b: mins(b) / len(b))
    triples = mins(body)
    check(triples > 0, f"{kernel}: no min loop in the SASS listing")
    pipes = {"alu": 0, "fma": 0, "other": 0}
    for _, op, _ in body:
        base = op.split(".")[0]
        if base == "IMAD":
            pipes["fma"] += 2 if op.startswith(HALF_RATE_IMAD) else 1
        else:
            pipes["alu" if base in ALU_OPS else "other"] += 1
    per = {k: v / triples for k, v in pipes.items()}
    issue = len(body) / triples
    return {"loop": f"{body[0][0]:#x}-{body[-1][0]:#x}",
            "instructions": len(body), "triples_per_iteration": triples,
            "per_triple": per | {"issue": issue},
            "cycles_per_triple": max(per["alu"] / ALU_LANES,
                                     per["fma"] / MUL_LANES,
                                     issue / ISSUE_LANES)}


def clocks_under_load(torch, fn, reps: int, readings: int = 3) -> list[str]:
    """nvidia-smi's SM clock and power draw, read while ``reps`` queued
    runs of ``fn`` execute on the card."""
    for _ in range(reps):
        fn()
    out = [smi_query("clocks.sm,power.draw") for _ in range(readings)]
    torch.cuda.synchronize()
    return out


def max_abs_err(got, want) -> int:
    from repro_torch.core.hashing import as_u32

    return int((as_u32(got) - as_u32(want)).abs().max()) if got.numel() else 0


# -- phase A: the main path -----------------------------------------------------

def phase_a(torch, clock_hz: float, notes: list[str]):
    import numpy as np

    from repro_torch.core import shingle
    from repro_torch.core.candidates import BandMatrixSource
    from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
    from repro_torch.core.pipeline import DedupConfig, DedupPipeline
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2

    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band")
    pipe = DedupPipeline(cfg, device="cuda")

    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    res = pipe.run(notes)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"fused_ingest": k1.launches, "pair_counts": k2.launches}
    check(launches["fused_ingest"] > 0, "K1 launched on the main path")
    check(launches["pair_counts"] > 0, "K2 launched on the main path")

    D, M = len(notes), cfg.num_hashes
    check(res.signatures.shape == (D, M) and res.signatures.dtype == np.uint32,
          "signature matrix shape")
    check(res.bands.shape == (D, cfg.num_bands, 2), "band matrix shape")
    check(res.labels.shape == (D,) and res.keep_mask.shape == (D,),
          "labels and keep mask shape")
    pairs = np.array([(a, b) for a, b, _ in res.pairs], dtype=np.int64)
    sims = np.array([s for _, _, s in res.pairs], dtype=np.float32)
    check(len(pairs) > 0 and bool(np.all(np.isfinite(sims)))
          and sims.min() >= 0 and sims.max() <= 1, "pair similarities in [0, 1]")

    # K1 against its plain version on the packed matrix the run used.
    token_lists = pipe.tokenize(notes)
    lens = [len(t) for t in token_lists]
    packed = shingle.pack_documents(token_lists,
                                    shingle.pow2_bucket(max(lens)))
    tokens = u32_from_numpy(packed.tokens, "cuda")
    lengths = torch.from_numpy(packed.lengths).cuda()
    seeds = u32_from_numpy(pipe.seeds, "cuda")
    sig_p, bands_p, valid_p = k1.fused_ingest_plain(tokens, lengths, seeds)
    check(np.array_equal(u32_to_numpy(sig_p), res.signatures),
          "main-path signatures == K1 plain version")
    check(np.array_equal(u32_to_numpy(bands_p), res.bands),
          "main-path bands == K1 plain version")
    sig_k, bands_k, valid_k = k1.fused_ingest(tokens, lengths, seeds)
    k1_err = max(max_abs_err(sig_k, sig_p),
                 max_abs_err(bands_k, bands_p),
                 int((valid_k != valid_p).sum()))
    check(k1_err == 0, "K1 kernel == plain on the main-path matrix")
    k1_ms = cuda_ms(torch, lambda: k1.fused_ingest(tokens, lengths, seeds), 20)
    k1_plain_ms = cuda_ms(
        torch, lambda: k1.fused_ingest_plain(tokens, lengths, seeds), 3)

    # K2: every evaluated pair, in the verifier's batches.
    a = torch.from_numpy(pairs[:, 0]).cuda()
    b = torch.from_numpy(pairs[:, 1]).cuda()
    counts_p = k2.pair_counts_plain(sig_p, a, b)
    check(np.array_equal(counts_p.cpu().numpy().astype(np.float32)
                         / np.float32(M), sims),
          "main-path pair sims == K2 plain counts / M")
    batches = [(a[s : s + VERIFY_BATCH], b[s : s + VERIFY_BATCH])
               for s in range(0, len(pairs), VERIFY_BATCH)]
    counts_k = torch.cat([k2.pair_counts(sig_k, x, y) for x, y in batches])
    k2_err = int((counts_k - counts_p).abs().max())
    check(k2_err == 0, "K2 kernel == plain on the main-path pairs")
    k2_ms = cuda_ms(torch, lambda: [k2.pair_counts(sig_k, x, y)
                                    for x, y in batches], 10)
    k2_device_ms = graph_ms(torch, lambda: [k2.pair_counts(sig_k, x, y)
                                            for x, y in batches], 10)
    k2_plain_ms = cuda_ms(torch, lambda: [k2.pair_counts_plain(sig_k, x, y)
                                          for x, y in batches], 3)

    # The same notes through the plain path: staged PyTorch signatures on
    # the card and the numpy verifier, no kernel at all.
    t0 = time.perf_counter()
    plain = DedupPipeline(DedupConfig(
        exact_verification=False, verify_backend="numpy",
        verify_batch="band"), device="cuda").run(notes)
    plain_run_s = time.perf_counter() - t0
    check(np.array_equal(plain.signatures, res.signatures)
          and np.array_equal(plain.bands, res.bands),
          "signatures and bands == plain path")
    check(np.array_equal(plain.labels, res.labels)
          and np.array_equal(plain.keep_mask, res.keep_mask),
          "labels and keep mask == plain path")
    check(plain.pairs == res.pairs, "(a, b, sim) list == plain path")

    # Where the run's time went.  Candidate-run generation (lexsort per
    # band, run boundaries) happens inside the engine's loop, so it is
    # timed again alone on the same bands and taken out of cluster_s.
    t0 = time.perf_counter()
    groups = sum(1 for runs in BandMatrixSource(res.bands).iter_bands()
                 for _ in runs.iter_groups())
    candidates_s = time.perf_counter() - t0
    t = res.timings
    stages = {
        "tokenize": t["tokenize_s"],
        "pack (token ids, padding)": t["pack_s"],
        "upload": t["upload_s"],
        "ingest (K1)": t["ingest_s"],
        "download (signatures, bands)": t["download_s"],
        "verifier build": t["verifier_build_s"],
        "candidate runs (timed alone)": candidates_s,
        "verify (K2 batches, host side included)": t["verify_s"],
        "engine loop (cluster_s - verify - candidate runs)":
            t["cluster_s"] - t["verify_s"] - candidates_s,
        "labels and keep mask": t["labels_s"],
        "sorted pair list": t["pairs_s"],
    }
    stages["outside the timed stages"] = run_s - sum(stages.values())
    verify_us = t["verify_s"] / res.stats.verify_batches * 1e6
    emit(phase_a={
        "docs": D, "tokens_mean": float(np.mean(lens)), "tokens_max": max(lens),
        "L": int(packed.tokens.shape[1]), "run_s": run_s, "timings": t, "candidate_groups": groups,
        "stages_ranked": sorted(stages.items(), key=lambda kv: -kv[1]),
        "clusters": res.num_clusters,
        "duplicates_removed": res.num_duplicates_removed,
        "pairs_generated": res.stats.pairs_generated,
        "pairs_evaluated": res.stats.pairs_evaluated,
        "pairs_excluded": res.stats.pairs_excluded,
        "unions": res.stats.unions_done,
        "verify_batches": res.stats.verify_batches,
        "verify_us_per_flush": verify_us,
        "launches": launches, "plain_path_run_s": plain_run_s,
        "plain_path_match": True})
    common = {"route": "cuda", "library_ms": None, "match": True}
    k1_line = {"name": "fused_ingest", **common,
               "source": "src/repro_torch/kernels/csrc/fused_ingest.cu",
               "replaces": "src/repro/kernels/fused_ingest.py:109",
               "launches": launches["fused_ingest"], "max_abs_err": k1_err,
               "ms": k1_ms, "plain_ms": k1_plain_ms,
               "shape": {"D": D, "L": int(packed.tokens.shape[1]), "M": M},
               "lane_map": k1.schedule(M, int(packed.tokens.shape[1])),
               **k1_bound(torch, lengths, packed.tokens.shape[1], M,
                          cfg.ngram, cfg.rows_per_band, clock_hz)}
    k2_line = {"name": "pair_counts", **common,
               "source": "src/repro_torch/kernels/csrc/sigjaccard.cu",
               "replaces": "src/repro/kernels/sigjaccard.py:65",
               "launches": launches["pair_counts"], "max_abs_err": k2_err,
               "ms": k2_ms, "device_ms": k2_device_ms,
               "plain_ms": k2_plain_ms,
               "shape": {"D": D, "M": M, "P": len(pairs),
                         "batch": VERIFY_BATCH, "launches": len(batches)},
               "verify_us_per_flush": verify_us,
               **pair_path(k2, M, sig_k, sig_k),
               **k2_bound(D, M, len(pairs), clock_hz)}
    k2_line.update(gathered(k2_line["gathered_bytes"], k2_device_ms))
    ctx = {"res": res, "tokens": tokens, "lengths": lengths, "seeds": seeds,
           "sig": sig_k}
    return ctx, k1_line, k2_line


# -- phase A2: byte ingest ------------------------------------------------------

def phase_a2(torch, clock_hz: float, notes: list[str], ctx: dict) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core import shingle
    from repro_torch.core.candidates import BandMatrixSource
    from repro_torch.core.engine import ClusterAccumulator
    from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
    from repro_torch.core.pipeline import DedupConfig, DedupPipeline
    from repro_torch.core.verify import SignatureVerifier
    from repro_torch.kernels import byte_shingle as k6
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2

    cfg = DedupConfig(byte_ingest=True, use_kernels=True,
                      exact_verification=False, verify_batch="band")
    pipe = DedupPipeline(cfg, device="cuda")
    k6.launches = k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    res = pipe.run(notes)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"byte_token_hashes": k6.launches, "fused_ingest": k1.launches,
                "pair_counts": k2.launches}
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the byte path")
    D, M = len(notes), cfg.num_hashes
    check(res.signatures.shape == (D, M) and res.bands.shape ==
          (D, cfg.num_bands, 2), "byte path signature and band shapes")

    # K6's plain version + compaction + K1's plain version on the same bytes.
    nbytes = [len(t.encode("utf-8")) for t in notes]
    LB = shingle.pow2_bucket(max(nbytes) + 1)
    packed = shingle.pack_bytes(notes, LB)
    buf = F.pad(torch.from_numpy(packed.data).cuda(), (0, 1))
    lengths = torch.from_numpy(packed.lengths).cuda()
    seeds = u32_from_numpy(pipe.seeds, "cuda")
    tok_p, ends_p = k6.byte_token_hashes_plain(buf, lengths)
    tokens_p, counts_p = k6.compact_tokens(tok_p, ends_p, (LB + 1) // 2 + 1)
    sig_p, bands_p, _ = k1.fused_ingest_plain(tokens_p, counts_p, seeds)
    check(np.array_equal(u32_to_numpy(sig_p), res.signatures)
          and np.array_equal(u32_to_numpy(bands_p), res.bands),
          "byte path signatures and bands == K6 plain + compaction + K1 plain")
    tok_k, ends_k = k6.byte_token_hashes(buf, lengths)
    k6_err = max(max_abs_err(tok_k, tok_p), int((ends_k != ends_p).sum()))
    check(k6_err == 0, "K6 kernel == plain on the main-path bytes")
    k6_ms = cuda_ms(torch, lambda: k6.byte_token_hashes(buf, lengths), 20)
    k6_plain_ms = cuda_ms(
        torch, lambda: k6.byte_token_hashes_plain(buf, lengths), 2)
    token_bytes = token_byte_count(torch, buf, lengths)
    k6_path = k6.schedule(buf, tok_k, ends_k)
    ingest_split = bytes_to_bands_split(
        torch, torch.from_numpy(packed.data).cuda(), lengths, seeds,
        cfg.ngram, cfg.rows_per_band, 10)

    # The host chain without stemming, on the card.
    t0 = time.perf_counter()
    token_lists = [shingle.tokenize(t, do_stem=False) for t in notes]
    hp = shingle.pack_documents(token_lists, shingle.pow2_bucket(
        max(len(t) for t in token_lists)))
    sig_h, bands_h, _ = k1.fused_ingest_plain(
        u32_from_numpy(hp.tokens, "cuda"),
        torch.from_numpy(hp.lengths).cuda(), seeds)
    host_chain_s = time.perf_counter() - t0
    check(np.array_equal(u32_to_numpy(sig_h), res.signatures)
          and np.array_equal(u32_to_numpy(bands_h), res.bands),
          "byte path signatures and bands == host no-stem chain")
    check(np.array_equal(hp.lengths, counts_p.cpu().numpy()),
          "device token counts == host token counts")

    # Clustering from the plain signatures with the numpy verifier.
    t0 = time.perf_counter()
    sig_np, bands_np = u32_to_numpy(sig_p), u32_to_numpy(bands_p)
    acc = ClusterAccumulator(
        D, SignatureVerifier(sig_np, backend="numpy", device="cpu"),
        cfg.edge_threshold, cfg.tree_threshold,
        use_disjoint_sets=cfg.use_disjoint_sets, batch=cfg.verify_batch)
    acc.feed(BandMatrixSource(bands_np))
    labels = acc.uf.components()
    keep = np.zeros(D, dtype=bool)
    keep[np.unique(labels, return_index=True)[1]] = True
    plain_cluster_s = time.perf_counter() - t0
    check(np.array_equal(labels, res.labels)
          and np.array_equal(keep, res.keep_mask),
          "byte path labels and keep mask == plain clustering")
    check(acc.pairs == res.pairs, "byte path (a, b, sim) list == plain")

    t = res.timings
    stages = {"pack (byte matrix)": t["pack_s"], "upload": t["upload_s"],
              "ingest (K6, compaction, K1)": t["ingest_s"]}
    stages["rest (download, verify, cluster, pairs)"] = \
        run_s - sum(stages.values())
    emit(phase_a2={
        "docs": D, "bytes_mean": float(np.mean(nbytes)),
        "bytes_max": max(nbytes), "LB": LB, "token_width": (LB + 1) // 2 + 1,
        "run_s": run_s, "timings": t,
        "stages_ranked": sorted(stages.items(), key=lambda kv: -kv[1]),
        "clusters": res.num_clusters,
        "duplicates_removed": res.num_duplicates_removed,
        "pairs_evaluated": res.stats.pairs_evaluated,
        "launches": launches, "host_chain_s": host_chain_s,
        "plain_cluster_s": plain_cluster_s, "plain_match": True,
        "bytes_to_bands_split_ms": ingest_split})
    return {"name": "byte_token_hashes", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/byte_shingle.cu",
            "replaces": "src/repro/kernels/byte_shingle.py:102",
            "launches": launches["byte_token_hashes"], "max_abs_err": k6_err,
            "ms": k6_ms, "plain_ms": k6_plain_ms, "library_ms": None,
            "match": True, "shape": {"D": D, "W": LB + 1}, "path": k6_path,
            **k6_bound(D, LB + 1, token_bytes, int(counts_p.sum()),
                       clock_hz)}


def token_byte_count(torch, data, lengths, rows: int = 1 << 16) -> int:
    """Bytes of this data that lie in a token: ASCII alnum, before the
    row's length."""
    total = 0
    pos = torch.arange(data.shape[1], device=data.device)[None, :]
    for s in range(0, data.shape[0], rows):
        b = data[s : s + rows]
        lower = b | 0x20  # A-Z fold onto a-z; no other byte lands there
        alnum = ((lower >= 97) & (lower <= 122)) | ((b >= 48) & (b <= 57))
        total += int((alnum & (pos < lengths[s : s + rows, None])).sum())
    return total


def bytes_to_bands_split(torch, data, lengths, seeds, n: int, r: int,
                         reps: int) -> dict:
    """``bytes_to_bands`` step by step as it runs them (pad, K6, the
    compaction, K1), with CUDA events between the steps: ms a call, the
    mean over ``reps`` calls run back to back after one warm-up, as
    ``cuda_ms`` times the whole.  Its outputs are held to
    ``bytes_to_bands``'s."""
    import torch.nn.functional as F

    from repro_torch.kernels import byte_shingle as k6
    from repro_torch.kernels import fused_ingest as k1

    width = (data.shape[1] + 1) // 2 + 1
    names = ("pad", "byte_token_hashes", "compaction", "fused_ingest")

    def run(ev):
        ev[0].record()
        buf = F.pad(data, (0, 1))
        ev[1].record()
        tok, ends = k6.byte_token_hashes(buf, lengths)
        ev[2].record()
        tokens, counts = k6.compact_tokens(tok, ends, width)
        ev[3].record()
        sig, bands, _ = k1.fused_ingest(tokens, counts, seeds, n=n, r=r)
        ev[4].record()
        return sig, bands, counts

    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
              for _ in range(reps + 1)]
    got = run(events[0])
    torch.cuda.synchronize()
    for ev in events[1:]:
        run(ev)
    torch.cuda.synchronize()
    ms = {name: sum(ev[i].elapsed_time(ev[i + 1]) for ev in events[1:]) / reps
          for i, name in enumerate(names)}
    want = k6.bytes_to_bands(data, lengths, seeds, n=n, r=r)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "bytes_to_bands step by step == bytes_to_bands")
    return ms | {"sum": sum(ms.values())}


# -- phase A3: the staged kernels -------------------------------------------------

def phase_a3(torch, clock_hz: float, notes: list[str], ctx: dict):
    import numpy as np

    from repro_torch.core.hashing import u32_to_numpy
    from repro_torch.core.pipeline import DedupConfig, DedupPipeline
    from repro_torch.kernels import bandfold as k5
    from repro_torch.kernels import minhash as k4
    from repro_torch.kernels import ngram as k3
    from repro_torch.kernels import ops
    from repro_torch.kernels import sigjaccard as k2

    cfg = DedupConfig(use_kernels=True, fused_ingest=False,
                      exact_verification=False, verify_batch="band")
    k3.launches = k4.launches = k2.launches = 0
    t0 = time.perf_counter()
    res = DedupPipeline(cfg, device="cuda").run(notes)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"ngram_hashes": k3.launches, "minhash_signatures": k4.launches,
                "pair_counts": k2.launches}
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the staged path")
    want = ctx["res"]
    check(np.array_equal(res.signatures, want.signatures)
          and np.array_equal(res.bands, want.bands),
          "staged signatures and bands == phase A")
    check(np.array_equal(res.labels, want.labels)
          and np.array_equal(res.keep_mask, want.keep_mask),
          "staged labels and keep mask == phase A")
    check(res.pairs == want.pairs, "staged (a, b, sim) list == phase A")

    # The ops entry point: K3 -> K4 -> K5 on phase A's packed matrix.
    tokens, lengths, seeds = ctx["tokens"], ctx["lengths"], ctx["seeds"]
    n, r, M = cfg.ngram, cfg.rows_per_band, cfg.num_hashes
    k3.launches = k4.launches = k5.launches = 0
    ng, valid = ops.ngram_hashes(tokens, lengths, n=n)
    sig = ops.minhash_signatures(ng, valid, seeds)
    bands = ops.band_values(sig, r)
    torch.cuda.synchronize()
    ops_launches = {"ngram_hashes": k3.launches,
                    "minhash_signatures": k4.launches,
                    "band_values": k5.launches}
    check(all(c > 0 for c in ops_launches.values()),
          "K3, K4 and K5 launched on the ops entry point")
    check(np.array_equal(u32_to_numpy(sig), want.signatures)
          and np.array_equal(u32_to_numpy(bands), want.bands),
          "ops K3 -> K4 -> K5 == phase A signatures and bands")

    ng_p, valid_p = k3.ngram_hashes_plain(tokens, lengths, n=n)
    k3_err = max(max_abs_err(ng, ng_p), int((valid != valid_p).sum()))
    sig_p = k4.minhash_signatures_plain(ng_p, valid_p, seeds)
    k4_err = max_abs_err(sig, sig_p)
    bands_p = k5.band_values_plain(sig_p, r)
    k5_err = max_abs_err(bands, bands_p)
    check(k3_err == 0 and k4_err == 0 and k5_err == 0,
          "K3, K4, K5 kernels == plain on the main-path matrix")
    D, L = tokens.shape
    times = {
        "k3": cuda_ms(torch, lambda: k3.ngram_hashes(tokens, lengths, n=n), 20),
        "k3_plain": cuda_ms(
            torch, lambda: k3.ngram_hashes_plain(tokens, lengths, n=n), 3),
        "k4": cuda_ms(torch, lambda: k4.minhash_signatures(ng, valid, seeds),
                      20),
        "k4_plain": cuda_ms(
            torch, lambda: k4.minhash_signatures_plain(ng, valid, seeds), 3),
        "k5": cuda_ms(torch, lambda: k5.band_values(sig, r), 20),
        "k5_plain": cuda_ms(torch, lambda: k5.band_values_plain(sig, r), 3),
    }
    # The same launches replayed from a CUDA graph: the device alone, with
    # no host work between them.
    device = {
        "k3": graph_ms(torch, lambda: k3.ngram_hashes(tokens, lengths, n=n),
                       20),
        "k4": graph_ms(torch, lambda: k4.minhash_signatures(ng, valid, seeds),
                       20),
    }
    emit(phase_a3={"docs": D, "L": L, "run_s": run_s, "timings": res.timings,
                   "launches": launches, "ops_launches": ops_launches,
                   "phase_a_match": True})
    common = {"route": "cuda", "library_ms": None, "match": True}
    k3_line = {"name": "ngram_hashes", **common,
               "source": "src/repro_torch/kernels/csrc/ngram.cu",
               "replaces": "src/repro/kernels/ngram.py:40",
               "launches": launches["ngram_hashes"], "max_abs_err": k3_err,
               "ms": times["k3"], "device_ms": device["k3"],
               "plain_ms": times["k3_plain"], "with_validity": True,
               "path": k3.schedule(tokens, ng, valid),
               "shape": {"D": D, "L": L, "n": n}, **k3_bound(D, L, n, clock_hz)}
    k4_line = {"name": "minhash_signatures", **common,
               "source": "src/repro_torch/kernels/csrc/minhash.cu",
               "replaces": "src/repro/kernels/minhash.py:56",
               "launches": launches["minhash_signatures"],
               "max_abs_err": k4_err, "ms": times["k4"],
               "device_ms": device["k4"], "plain_ms": times["k4_plain"],
               "schedule": k4.schedule(M, L), "path": k4.path(ng, valid),
               "shape": {"D": D, "L": L, "M": M},
               **k4_bound(valid, M, clock_hz)}
    k5_line = {"name": "band_values", **common,
               "source": "src/repro_torch/kernels/csrc/bandfold.cu",
               "replaces": "src/repro/kernels/bandfold.py:41",
               "path": "kernels.ops entry point (phase A3); "
                       "DedupSession.refine (phase R2)",
               "launches": ops_launches["band_values"], "max_abs_err": k5_err,
               "ms": times["k5"], "plain_ms": times["k5_plain"],
               "shape": {"D": D, "M": M, "r": r}, **k5_bound(D, M, r, clock_hz)}
    return k3_line, k4_line, k5_line


# -- phase H: the host session, the read path and the dedup CLI ------------------

H_CHUNKS, H_QUERY_STRIDE, H_NOVEL, H_MICROBATCH = 4, 16, 64, 64
# The cut depth of H2, R1, T1 and Q1 (``cut_notes``): 4,096 notes, a
# quarter of phase A's, to pay for phase D's retention and sqlite paths.
CUT_SOURCES, CUT_DUPS = 3328, 768


def canonical(labels):
    """Cluster labels as the first doc of each cluster: the partition,
    whatever doc union by rank made the root."""
    first = {}
    return [first.setdefault(int(r), i) for i, r in enumerate(labels)]


def session_run(torch, cfg, notes, want, device: str, counters: dict, *,
                store_path: str = ":memory:") -> tuple:
    """One ``DedupSession.ingest_stream`` over ``H_CHUNKS`` chunks, held
    against the one-shot ``want`` (a ``DedupResult`` of the same config)
    and, pair by pair, against K2's plain counts / M.

    A chunked session and a one-shot run evaluate different root pairs
    (the union order differs) and may pick other roots, so what must
    agree is what the reference's session contract pins: the partition,
    the keep mask and the similarity of every pair both evaluate.
    ``counters`` maps names to kernel modules; their launches are set to
    0 before the run and returned after it.  A sqlite-tier session keeps
    its cross-step index at ``store_path``, and each step also records
    the index's write counters."""
    import numpy as np

    from repro_torch.core.session import DedupSession

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    sess = DedupSession(cfg, device=device, store_path=store_path)
    size = -(-len(notes) // H_CHUNKS)
    chunks = [notes[i : i + size] for i in range(0, len(notes), size)]
    steps = []
    t0 = time.perf_counter()
    for snap in sess.ingest_stream(chunks):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        t = sess.stage_timings
        steps.append({"seconds": now - t0, "merge_s": t["merge_s"],
                      "cross_step_edges": t["cross_step_edges"],
                      "cross_step_s": t["cross_step_s"],
                      "pairs_evaluated": snap.stats.pairs_evaluated})
        if hasattr(sess.band_index, "n_writes"):
            steps[-1].update(store_n_writes=sess.band_index.n_writes,
                             store_write_bytes=sess.band_index.write_bytes)
        t0 = now
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    check(snap.n_docs == len(notes), "session covers every note")
    check(np.array_equal(sess.signatures, want.signatures),
          "session signatures == one-shot signatures")
    check(canonical(snap.labels) == canonical(want.labels),
          "session partition == one-shot partition")
    keep = np.zeros(len(notes), dtype=bool)
    keep[np.unique(snap.labels, return_index=True)[1]] = True
    check(np.array_equal(keep, want.keep_mask),
          "session keep mask == one-shot keep mask")
    sims = {(a, b): s for a, b, s in want.pairs}
    shared = [(s, sims[(a, b)]) for a, b, s in snap.pairs if (a, b) in sims]
    check(len(shared) > 0 and all(x == y for x, y in shared),
          "sims of pairs both evaluate are equal")
    check_pair_sims(torch, sess.signatures, snap, device, "session")
    summary = {
        "chunks": len(chunks), "steps": steps,
        "ingest_s": sum(x["seconds"] for x in steps),
        "pairs_evaluated": snap.stats.pairs_evaluated,
        "one_shot_pairs_evaluated": want.stats.pairs_evaluated,
        "shared_pairs": len(shared),
        "labels_equal_as_ids": bool(np.array_equal(snap.labels, want.labels)),
        "verify_batches": snap.stats.verify_batches,
        "launches": launches}
    return sess, snap, summary


def check_pair_sims(torch, signatures, snap, device: str, what: str) -> None:
    """Every pair of ``snap`` against K2's plain counts / M on the rows of
    ``signatures``, a (D, M) uint32 matrix whose row i is doc i."""
    import numpy as np

    from repro_torch.kernels import sigjaccard as k2

    pairs = np.array([(a, b) for a, b, _ in snap.pairs], dtype=np.int64)
    got = np.array([s for _, _, s in snap.pairs], dtype=np.float32)
    sig = torch.from_numpy(signatures.view(np.int32)).to(device)
    M = sig.shape[1]
    for s in range(0, len(pairs), 1 << 20):
        a = torch.from_numpy(pairs[s : s + (1 << 20), 0]).to(device)
        b = torch.from_numpy(pairs[s : s + (1 << 20), 1]).to(device)
        want_s = (k2.pair_counts_plain(sig, a, b).cpu().numpy()
                  .astype(np.float32) / np.float32(M))
        check(np.array_equal(got[s : s + len(want_s)], want_s),
              f"{what} pair sims == K2 plain counts / M")


def serve_queries(torch, svc, queries: list[str], device: str,
                  by_bytes: bool = False) -> tuple[list, dict]:
    """``queries`` through ``svc`` in microbatches of ``H_MICROBATCH``
    (``submit`` and ``step``, or ``query_bytes``), each timed on the host
    clock (its results are on the host when it returns)."""
    import numpy as np

    results, lat = [], []
    t_all = time.perf_counter()
    for s in range(0, len(queries), H_MICROBATCH):
        batch = queries[s : s + H_MICROBATCH]
        t0 = time.perf_counter()
        if by_bytes:
            results += svc.query_bytes(batch)
        else:
            rids = [svc.submit(t) for t in batch]
            done = {r.rid: r.result for r in svc.run_until_drained()}
            results += [done[r] for r in rids]
        if device == "cuda":
            torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all
    return results, {"microbatches": len(lat),
                     "median_microbatch_ms": float(np.median(lat)) * 1e3,
                     "first_microbatch_ms": lat[0] * 1e3,
                     "max_microbatch_ms": max(lat) * 1e3,
                     "queries_per_s": len(queries) / total}


def searchsorted_index(torch, view, device: str) -> tuple:
    """The TPU reference's probe index, kept here only to time it against
    the port's dict walk (``query.probe_candidates``): per band the
    sorted ``hi << 32 | lo`` keys of the view's bucket map on the card,
    padded with the int64 maximum, and each band's key count.  A
    published view needs it built anew."""
    import numpy as np

    per_band = [np.sort(band_key64(list(m.keys()))) for m in view.band_maps]
    width = max(1, max(len(k) for k in per_band))
    keys = np.full((len(per_band), width), np.iinfo(np.int64).max, np.int64)
    for j, k in enumerate(per_band):
        keys[j, : len(k)] = k
    return (torch.from_numpy(keys).to(device),
            torch.tensor([len(k) for k in per_band], device=device))


def band_key64(hi_lo):
    """(..., 2) uint32 band lanes -> one int64 key each (``hi << 32 | lo``,
    wrapping: a bijection, so equal keys are equal bands)."""
    import numpy as np

    a = np.asarray(hi_lo, dtype=np.int64).reshape(-1, 2)
    return (a[:, 0] << 32) | a[:, 1]


def searchsorted_probe(torch, index, view, bands) -> list:
    """Candidates of (Q, b, 2) ``bands`` through ``searchsorted_index``:
    one ``searchsorted`` of the batch's keys on the card, then the host
    dicts read for the hits alone (a hit needs ``idx < count``, so a key
    equal to the padding is no hit)."""
    import numpy as np

    keys, counts = index
    q, b = bands.shape[:2]
    qk = torch.from_numpy(np.ascontiguousarray(
        band_key64(bands).reshape(q, b).T)).to(keys.device)
    idx = torch.searchsorted(keys, qk)
    found = torch.gather(keys, 1, idx.clamp(max=keys.shape[1] - 1)) == qk
    hits = (found & (idx < counts[:, None])).T.cpu().numpy()
    cands = [set() for _ in range(q)]
    for j, m in enumerate(view.band_maps):
        col = bands[:, j, :].tolist()
        for i in np.flatnonzero(hits[:, j]).tolist():
            cands[i].update(m[tuple(col[i])])
    return [np.array(sorted(c), dtype=np.int64) for c in cands]


def probe_crossover(torch, view, bands, batch: int, device: str) -> dict:
    """The port's dict-walk probe against the searchsorted probe, index
    build included, over ``bands`` in batches of ``batch``.  Each batch
    must give the same candidates both ways."""
    import numpy as np

    from repro_torch.core import query

    walk, probe = [], []
    t0 = time.perf_counter()
    index = searchsorted_index(torch, view, device)
    if device == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for s in range(0, len(bands), batch):
        part = bands[s : s + batch]
        t0 = time.perf_counter()
        want = query.probe_candidates(view, part)[0]
        t1 = time.perf_counter()
        got = searchsorted_probe(torch, index, view, part)
        probe.append(time.perf_counter() - t1)
        walk.append(t1 - t0)
        check(len(got) == len(want)
              and all(np.array_equal(x, y) for x, y in zip(got, want)),
              "searchsorted probe == dict walk")
    return {"queries": len(bands), "batch": batch, "batches": len(walk),
            "dict_walk_ms": sum(walk) * 1e3,
            "dict_walk_median_batch_ms": float(np.median(walk)) * 1e3,
            "searchsorted_build_ms": build_s * 1e3,
            "searchsorted_probe_ms": sum(probe) * 1e3,
            "searchsorted_median_batch_ms": float(np.median(probe)) * 1e3,
            "searchsorted_total_ms": (build_s + sum(probe)) * 1e3}


def cli_session(torch, device: str):
    """The warm session and the 65 queries of H4's CLI run (``--notes
    2000 --dups 1000 --steps 4 --fused-ingest --estimate --backend
    kernel --query 64``), built in process.  ``verify_batch`` is
    ``band``: the probe reads only the band maps, which it leaves as
    they are."""
    import numpy as np

    from repro_torch.core import DedupConfig, DedupSession
    from repro_torch.data import inject_near_duplicates, make_i2b2_like

    notes, _ = inject_near_duplicates(make_i2b2_like(2000), 1000)
    cfg = DedupConfig(fused_ingest=True, exact_verification=False,
                      verify_backend="kernel", verify_batch="band")
    sess = DedupSession(cfg, device=device)
    bounds = np.linspace(0, len(notes), 5).astype(int)
    for a, b in zip(bounds, bounds[1:]):
        sess.ingest(notes[a:b])
    return sess, notes[:64] + ["entirely unrelated query text " * 12]


def query_bands(sess, texts: list[str]):
    """(Q, b, 2) uint32 band values of ``texts`` through the session's
    own pipeline, as ``DedupQueryService.query`` computes them."""
    from repro_torch.core import shingle

    pipe = sess._impl.pipe
    toks = pipe.tokenize(texts)
    pad = shingle.pow2_bucket(max(len(t) for t in toks))
    return pipe.compute_arrays(toks, pad_len=pad)[1]


def phase_h(torch, notes: list[str], prov: list, ctx: dict,
            device: str = "cuda") -> dict:
    """The host ``DedupSession`` over phase A's notes in ``H_CHUNKS``
    chunks (H1: fused ingest, K1 and K2), and H1's config on
    ``cut_notes`` (``phase_h1_cut``: the record of R1, T1 and Q1, held
    against its own one-shot run); H2: byte ingest (K6, compaction, K1
    and K2) on ``cut_notes``, held against A2's config run one-shot on
    them; the read path over those sessions (H3: ``DedupQueryService``
    with the ``kernel`` backend against its ``numpy`` twin, ``query``
    over H1 and ``query_bytes`` over H2; the probe's dict walk against a
    device searchsorted probe), and the dedup CLI (H4).  Returns each
    path's kernel launches."""
    from repro_torch.core.pipeline import DedupConfig, DedupPipeline
    from repro_torch.data import make_i2b2_like
    from repro_torch.kernels import byte_shingle as k6
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2
    from repro_torch.serving import DedupQueryService

    counters = {"fused_ingest": (k1, "launches"),
                "pair_counts": (k2, "launches"),
                "byte_token_hashes": (k6, "launches")}
    launches = {}

    # H1: phase A's config, 4 chunks.
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band")
    sess, snap, h1 = session_run(torch, cfg, notes, ctx["res"], device,
                                 counters)
    launches["h1_session"] = h1["launches"]
    v = sess.verifier
    ctx["h1"] = {"labels": snap.labels, "pairs": snap.pairs, "summary": h1,
                 "n_live_rows": v.n_live_rows,
                 "device_buffer_rows": len(v._dev),
                 "device_buffer_bytes": v._dev.numel() * 4}
    check(h1["launches"]["fused_ingest"] == H_CHUNKS,
          "K1 launched once a chunk in the session")
    check(h1["launches"]["pair_counts"] > 0, "K2 launched in the session")
    emit(phase_h1=h1)
    del snap

    # H1's config on the cut corpus, against its own one-shot run: the
    # record of the paths run at the cut depth (R1, T1, Q1).
    cut = cut_notes(notes, prov)
    t0 = time.perf_counter()
    ctx["res_cut"] = DedupPipeline(cfg, device=device).run(cut)
    one_shot_s = time.perf_counter() - t0
    cut_sess, cut_snap, h1c = session_run(torch, cfg, cut, ctx["res_cut"],
                                          device, counters)
    launches["h1_cut_session"] = h1c["launches"]
    check(h1c["launches"]["fused_ingest"] == H_CHUNKS
          and h1c["launches"]["pair_counts"] > 0,
          "K1 once a chunk, and K2, in the cut-depth session")
    v = cut_sess.verifier
    ctx["h1_cut"] = {"labels": cut_snap.labels, "pairs": cut_snap.pairs,
                     "summary": h1c, "sess": cut_sess,
                     "n_live_rows": v.n_live_rows,
                     "device_buffer_rows": len(v._dev),
                     "device_buffer_bytes": v._dev.numel() * 4}
    emit(phase_h1_cut={**h1c, "notes": len(cut), "one_shot_s": one_shot_s,
                       "duplicates": cut_snap.num_duplicates})
    del cut_snap

    # H2: phase A2's config on the cut corpus, 4 chunks, against the same
    # config run one-shot on it.
    byte_cfg = DedupConfig(byte_ingest=True, use_kernels=True,
                           exact_verification=False, verify_batch="band")
    t0 = time.perf_counter()
    byte_res = DedupPipeline(byte_cfg, device=device).run(cut)
    one_shot_s = time.perf_counter() - t0
    byte_sess, _, h2 = session_run(torch, byte_cfg, cut, byte_res, device,
                                   counters)
    launches["h2_byte_session"] = h2["launches"]
    check(h2["launches"]["byte_token_hashes"] == H_CHUNKS
          and h2["launches"]["fused_ingest"] == H_CHUNKS
          and h2["launches"]["pair_counts"] > 0,
          "K6 and K1 launched once a chunk, and K2, in the byte session")
    emit(phase_h2={**h2, "notes": len(cut), "one_shot_s": one_shot_s})
    del byte_res

    # H3: the read path, kernel backend against its numpy twin: every
    # 16th note ingested by H1 (``query``) and by H2 (``query_bytes``),
    # and 64 novel ones.
    novel = make_i2b2_like(H_NOVEL, seed=7)
    h3 = {"microbatch": H_MICROBATCH}
    for name, s, by_bytes, corpus in (("query", sess, False, notes),
                                      ("query_bytes", byte_sess, True, cut)):
        ingested = list(range(0, len(corpus), H_QUERY_STRIDE))
        queries = [corpus[i] for i in ingested] + novel
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        got, timing = serve_queries(
            torch, DedupQueryService(s, backend="kernel",
                                     max_batch=H_MICROBATCH),
            queries, device, by_bytes)
        run_launches = {n: getattr(m, a) for n, (m, a) in counters.items()}
        want, twin = serve_queries(
            torch, DedupQueryService(s, backend="numpy",
                                     max_batch=H_MICROBATCH),
            queries, device, by_bytes)
        check(got == want, f"{name}: kernel service == numpy service")
        labels = s.snapshot().labels
        check(all(r.best_sim == 1.0 and r.cluster_root == int(labels[i])
                  for i, r in zip(ingested, got)),
              f"{name}: every ingested note answers sim 1.0, its own root")
        check(run_launches["fused_ingest"] == timing["microbatches"]
              and run_launches["pair_counts"] > 0,
              f"{name}: K1 once a microbatch, and K2, on the read path")
        if by_bytes:
            check(run_launches["byte_token_hashes"] == timing["microbatches"],
                  "query_bytes: K6 once a microbatch")
        launches[f"h3_{name}"] = run_launches
        if not by_bytes:
            # Phase Q's sqlite read path answers the same queries, and
            # phase D4 64 of them.
            ctx["h3"] = {"queries": queries,
                         "median_microbatch_ms":
                             timing["median_microbatch_ms"]}
            ctx["d4_queries"] = queries[:: len(queries) // D4_QUERIES][
                :D4_QUERIES]
        h3[name] = {**timing, "queries": len(queries),
                    "launches": run_launches, "numpy_twin": twin,
                    "duplicates": sum(r.is_duplicate for r in got),
                    "candidates": sum(r.n_candidates for r in got)}
    # The probe: the port's dict walk against the reference's device
    # searchsorted design, index build included, on H3's traffic (in its
    # microbatches and as one batch), on every ingested note at once,
    # and on the CLI's 65 queries against the CLI's session.
    queries = ctx["h3"]["queries"]
    view, q_bands = sess.view(), query_bands(sess, queries)
    h3["probe"] = {
        "h3_microbatches": probe_crossover(torch, view, q_bands,
                                           H_MICROBATCH, device),
        "h3_one_batch": probe_crossover(torch, view, q_bands, len(q_bands),
                                        device),
        "all_ingested": probe_crossover(torch, view, ctx["res"].bands,
                                        len(notes), device)}
    cli, cli_queries = cli_session(torch, device)
    h3["probe"]["cli"] = probe_crossover(
        torch, cli.view(), query_bands(cli, cli_queries), len(cli_queries),
        device)
    emit(phase_h3=h3)

    # H4: the dedup CLI, as a user runs it.
    argv = [sys.executable, "-m", "repro_torch.launch.dedup", "--notes",
            "2000", "--dups", "1000", "--steps", "4", "--fused-ingest",
            "--estimate", "--backend", "kernel", "--query", "64",
            "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=600)
    check(proc.returncode == 0, f"dedup CLI exits 0: {proc.stderr[-2000:]}")
    ctx["h4_report"] = proc.stdout.splitlines()
    emit(phase_h4={"argv": argv[1:], "seconds": time.perf_counter() - t0,
                   "report": proc.stdout.splitlines()})
    return launches


# -- phase R: bounded retained state and refine ------------------------------------

# R1_WINDOW is R1's LRU window at phase A's depth (D1 runs under it); R1 at
# the cut depth takes the same share of its notes.
R1_WINDOW, R_EVICTED_QUERIES, R_FILTER_QUERIES = 1024, 64, 256
# R2's depth: phase A's first 4,096 notes (cut from all 16,384 to pay
# for phase D), still twice the small preset's 2,048 keys a band, so keys
# are compacted and the queries of the first notes hit the filters.
R2_NOTES = 4096
R3_SOURCES, R3_DUPS = 2560, 512


def r3_notes(notes: list[str], prov: list, sources: int | None = None,
             n_dups: int | None = None) -> list[str]:
    """R3's corpus: the first ``R3_SOURCES`` notes (or ``sources``), then
    the injected near-duplicates of ``R3_DUPS`` (or ``n_dups``) distinct
    ones among them, in injection order.  More notes than R2's 2,048 keys
    a band, so keys are compacted; the duplicates land in the last chunk,
    so unions depose docs, the sweep evicts them and the second refine
    re-bands the roots."""
    sources = R3_SOURCES if sources is None else sources
    n_dups = R3_DUPS if n_dups is None else n_dups
    dups, seen = [], set()
    for dup, src, _ in prov:
        if src < sources and src not in seen:
            seen.add(src)
            dups.append(dup)
    check(len(dups) >= n_dups,
          f"found {len(dups)} near-duplicates of the first {sources} notes")
    return notes[:sources] + [notes[d] for d in dups[:n_dups]]


def cut_notes(notes: list[str], prov: list) -> list[str]:
    """The corpus of the session paths run at the cut depth (H2, R1, T1
    and Q1): phase A's first ``CUT_SOURCES`` notes, then the
    near-duplicates of ``CUT_DUPS`` distinct ones among them, 4,096 notes,
    a quarter of phase A's.  In ``H_CHUNKS`` chunks the near-duplicates
    fill the last chunk, as phase A's fill its last, and most of them
    are of notes in earlier chunks.  (A prefix of H1's chunks would hold
    none.)"""
    return r3_notes(notes, prov, CUT_SOURCES, CUT_DUPS)


def retention_run(torch, cfg, notes, policy, device: str, counters: dict,
                  setup=None) -> tuple:
    """One ``DedupSession`` under ``policy`` over ``notes`` in
    ``H_CHUNKS`` chunks (``ingest_stream``), each step timed on the host
    clock after a synchronize.  ``counters`` maps names to kernel
    modules; their launches are set to 0 before the run and returned
    after it.  ``setup(session)`` runs before the first chunk."""
    from repro_torch.core.session import DedupSession

    sess = DedupSession(cfg, retention=policy, device=device)
    if setup is not None:
        setup(sess)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    size = -(-len(notes) // H_CHUNKS)
    chunks = [notes[i : i + size] for i in range(0, len(notes), size)]
    steps, refines = [], 0
    t0 = time.perf_counter()
    for snap in sess.ingest_stream(chunks):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        t, v = sess.stage_timings, sess.verifier
        step = {"seconds": now - t0, "merge_s": t["merge_s"],
                "cross_step_edges": t["cross_step_edges"],
                "cross_step_s": t["cross_step_s"], "sweep_s": t["sweep_s"],
                "evicted": snap.evicted, "n_live_rows": v.n_live_rows,
                "rows": v._n_rows,
                "pairs_evaluated": snap.stats.pairs_evaluated}
        if v._dev is not None:
            step.update(device_buffer_rows=len(v._dev),
                        device_buffer_bytes=v._dev.numel() * 4)
        if sess.refines_run > refines:
            refines = sess.refines_run
            step.update({k: t[k] for k in ("refine_s", "refine_band_s",
                                           "refine_pairs", "refine_merges")})
        steps.append(step)
        t0 = now
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    summary = {"chunks": len(chunks), "steps": steps,
               "ingest_s": sum(x["seconds"] for x in steps),
               "pairs_evaluated": snap.stats.pairs_evaluated,
               "evicted": snap.evicted, "retained_rows": snap.retained_rows,
               "filter_only_hits": snap.filter_only_hits,
               "refines_run": sess.refines_run,
               "refine_merges": snap.refine_merges,
               "band_index": sess.band_index.stats(), "launches": launches}
    return sess, snap, summary


def traced_refine(torch, sess, record: list) -> None:
    """Wrap ``sess.refine`` so each round checks itself: the K5 fold of
    the representatives' rows equals ``core.lsh.band_values`` on the same
    device rows, and every merge's sim equals K2's plain counts / M on
    the two roots' rows (read before the round's sweep frees them) and
    clears ``edge_threshold``.  Appends one summary per round."""
    import numpy as np

    from repro_torch.core import lsh
    from repro_torch.kernels import bandfold as k5
    from repro_torch.kernels import sigjaccard as k2

    inner, launch = sess.refine, k5.band_values

    def refine():
        folds, merged = [], []
        uf, v = sess.uf, sess.verifier
        union = uf.union

        def fold(sig, r):
            out = launch(sig, r)
            folds.append({"reps": len(sig),
                          "equal": bool(torch.equal(out, lsh.band_values(sig, r))),
                          "rows": sig})
            return out

        def traced_union(x, y, sim):
            ok = union(x, y, sim)
            if ok:
                merged.append((sim, *v._slot_index([x, y]).tolist()))
            return ok

        uf.union, k5.band_values = traced_union, fold
        try:
            snap = inner()
        finally:
            del uf.union
            k5.band_values = launch
        check(all(f["equal"] for f in folds),
              "refine: K5 fold == core.lsh.band_values on the same rows")
        if merged:
            sig = v._device_signatures()
            slots = torch.tensor([m[1:] for m in merged], device=sig.device)
            want = (k2.pair_counts_plain(sig, slots[:, 0], slots[:, 1])
                    .cpu().numpy().astype(np.float32) / np.float32(sig.shape[1]))
            got = np.array([m[0] for m in merged], dtype=np.float32)
            check(np.array_equal(got, want),
                  "refine merge sims == K2 plain counts / M")
            check(bool((got > sess.config.edge_threshold).all()),
                  "refine merges clear edge_threshold")
        record.append({"reps": folds[0]["reps"] if folds else 0,
                       "k5_folds": len(folds), "merges": len(merged),
                       "pairs": sess.stage_timings["refine_pairs"],
                       "seconds": sess.stage_timings["refine_s"],
                       "band_s": sess.stage_timings["refine_band_s"],
                       "rows": folds[-1]["rows"] if folds else None})
        return snap

    sess.refine = refine


def phase_r(torch, clock_hz: float, notes: list[str], prov: list,
            ctx: dict, device: str = "cuda") -> tuple[dict, dict]:
    """Bounded retained state and the second clustering round on phase A's
    notes and config, in H1's 4 chunks.  R1: ``cut_notes`` under an LRU
    window of 256 (1,024 at phase A's depth), lossless (labels and pairs
    equal phase H's record of the same notes and chunks), then up to 64
    evicted docs queried through a ``kernel`` ``DedupQueryService``.
    R2: the ``small`` preset refining every 2 steps (K5 once a refine,
    each round checked by ``traced_refine``), and a query batch that
    finds compacted keys.  R3:
    ``r3_notes`` (2,560 notes and 512 of their near-duplicates, ``prov``
    the corpus's provenance) under R2's policy, on the card and on the
    CPU, equal field by field, with rows evicted and keys compacted.  R4: the CLI with ``--retain-budget small
    --refine-every 2``.  Returns each path's K1, K2 and K5 launches, and
    K5's time at the last refine's representative count."""
    import numpy as np

    from repro_torch.core import RetentionPolicy
    from repro_torch.core.pipeline import DedupConfig
    from repro_torch.kernels import bandfold as k5
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2
    from repro_torch.serving import DedupQueryService

    counters = {"fused_ingest": (k1, "launches"),
                "pair_counts": (k2, "launches"),
                "band_values": (k5, "launches")}
    launches = {}
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band")
    h1 = ctx.pop("h1")
    h1_cut = ctx["h1_cut"]
    cut = cut_notes(notes, prov)

    # R1: lossless eviction against H1's config on the same notes, under
    # R1's window cut as the notes are.
    window = R1_WINDOW * len(cut) // len(notes)
    sess, snap, r1 = retention_run(torch, cfg, cut,
                                   RetentionPolicy(lru_window=window),
                                   device, counters)
    launches["r1_session"] = r1["launches"]
    check(np.array_equal(snap.labels, h1_cut["labels"]),
          "R1 labels == H1's config on the cut notes")
    check(snap.pairs == h1_cut["pairs"],
          "R1 (a, b, sim) list == H1's config on the cut notes")
    check(snap.evicted > 0, "R1 evicted rows")
    check(snap.retained_rows == snap.n_docs - snap.evicted,
          "R1 retained rows == docs - evicted")
    check(snap.representatives.tolist()
          == sorted({int(r) for r in snap.labels}),
          "R1 representatives == the sorted roots")
    check(snap.filter_only_hits == 0, "R1 has no filter-only hits")
    check(r1["launches"]["fused_ingest"] == H_CHUNKS
          and r1["launches"]["pair_counts"] > 0,
          "R1: K1 once a chunk, and K2")
    view = sess.view()
    evicted = [d for d in range(snap.n_docs) if d not in view.slot_of]
    picks = evicted[:: max(1, len(evicted) // R_EVICTED_QUERIES)]
    picks = picks[:R_EVICTED_QUERIES]
    t0 = time.perf_counter()
    got = DedupQueryService(sess, backend="kernel").query(
        [cut[d] for d in picks])
    if device == "cuda":
        torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    check(all(r.is_duplicate and r.cluster_root == int(snap.labels[d])
              and r.matched_doc in view.slot_of
              for d, r in zip(picks, got)),
          "R1: evicted docs query to their cluster through a retained doc")
    r1.update(notes=len(cut), lru_window=window, evicted_queries=len(picks),
              evicted_query_s=query_s,
              h1={k: h1_cut[k] for k in ("n_live_rows", "device_buffer_rows",
                                          "device_buffer_bytes")},
              h1_steps=[{k: x[k] for k in ("seconds", "cross_step_edges",
                                           "cross_step_s")}
                        for x in h1_cut["summary"]["steps"]],
              h1_ingest_s=h1_cut["summary"]["ingest_s"],
              h1_full_ingest_s=h1["summary"]["ingest_s"])
    emit(phase_r1=r1)
    del sess, snap, view, h1

    # R2: the small preset, refining every 2 steps.
    policy = RetentionPolicy.preset("small", refine_every=2)
    rounds: list = []
    sess, snap, r2 = retention_run(
        torch, cfg, notes[:R2_NOTES], policy, device, counters,
        setup=lambda s: traced_refine(torch, s, rounds))
    launches["r2_session"] = r2["launches"]
    check(sess.band_index.compacted_keys > 0, "R2 compacted band keys")
    check(sess.refines_run == 2 and len(rounds) == 2, "R2 refined twice")
    check(r2["launches"]["band_values"] == sum(r["k5_folds"] for r in rounds)
          == 2, "R2: K5 once a refine")
    before = sess.band_index.filter_only_hits
    got = DedupQueryService(sess, backend="kernel").query(
        notes[:R_FILTER_QUERIES])
    check(sum(r.filter_only_hits for r in got) > 0,
          "R2 queries hit compacted keys in the Bloom filters")
    check(sess.band_index.filter_only_hits == before,
          "R2 queries leave the session's filter-only count as it was")
    rows = rounds[-1]["rows"]
    r = cfg.rows_per_band
    k5_refine = {"reps": len(rows),
                 "ms": cuda_ms(torch, lambda: k5.band_values(rows, r), 20),
                 "plain_ms": cuda_ms(torch,
                                     lambda: k5.band_values_plain(rows, r), 5),
                 **k5_bound(len(rows), rows.shape[1], r, clock_hz)}
    r2.update(notes=R2_NOTES,
              rounds=[{k: x[k] for k in x if k != "rows"} for x in rounds],
              filter_queries=len(got),
              query_filter_only_hits=sum(x.filter_only_hits for x in got),
              k5_refine=k5_refine)
    emit(phase_r2=r2)
    del sess, snap, rounds, rows

    # R3: R2's policy on notes and their near-duplicates, card and CPU.
    out = {}
    notes3 = r3_notes(notes, prov)
    for dev in (device, "cpu"):
        s3, snap3, summary = retention_run(torch, cfg, notes3, policy, dev,
                                           counters)
        out[dev] = {"labels": snap3.labels.tolist(), "pairs": snap3.pairs,
                    "evicted": snap3.evicted,
                    "retained_rows": snap3.retained_rows,
                    "representatives": snap3.representatives.tolist(),
                    "filter_only_hits": snap3.filter_only_hits,
                    "refine_merges": snap3.refine_merges,
                    "band_index": s3.band_index.stats(),
                    "refines_run": s3.refines_run,
                    "seconds": summary["ingest_s"]}
        if dev == device:
            launches["r3_session"] = summary["launches"]
    for field in out["cpu"]:
        if field != "seconds":
            check(out[device][field] == out["cpu"][field],
                  f"R3 {field}: card == CPU")
    check(out[device]["evicted"] > 0, "R3 evicted rows")
    check(out[device]["band_index"]["compacted_keys"] > 0,
          "R3 compacted band keys")
    check(out[device]["refines_run"] == 2, "R3 refined twice")
    emit(phase_r3={"notes": len(notes3), "card_s": out[device]["seconds"],
                   "cpu_s": out["cpu"]["seconds"],
                   "evicted": out["cpu"]["evicted"],
                   "band_index": out["cpu"]["band_index"],
                   "refine_merges": out["cpu"]["refine_merges"],
                   "launches": launches["r3_session"]})

    # R4: H4's CLI run under the small budget, refining every 2 steps.
    argv = [sys.executable, "-m", "repro_torch.launch.dedup", "--notes",
            "2000", "--dups", "1000", "--steps", "4", "--fused-ingest",
            "--estimate", "--backend", "kernel", "--query", "64",
            "--retain-budget", "small", "--refine-every", "2",
            "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=600)
    report = proc.stdout.splitlines()
    check(proc.returncode == 0,
          f"dedup CLI with retention exits 0: {proc.stderr[-2000:]}")
    check(any(ln.startswith("host[4 step(s)]: ") for ln in report),
          "dedup CLI with retention prints its report line")
    emit(phase_r4={"argv": argv[1:], "seconds": time.perf_counter() - t0,
                   "report": report})
    return launches, k5_refine


# -- phase T: the streaming backend over the band store ------------------------------

T_CHUNK_DOCS, T3_WINDOW, T4_EDGES = 512, 128, (0.75, 0.6)


def streaming_run(torch, cfg, chunks, device: str, counters: dict, *,
                  store_path: str, retention=None, tokenized: bool = False):
    """One streaming ``DedupSession`` (``chunk_docs`` ``T_CHUNK_DOCS``, its
    store at ``store_path``) fed ``chunks`` through ``ingest_stream``, each
    step timed on the host clock after a synchronize and split by the
    session's ``stage_timings``: phase 1 (kernel, band download, store
    write), the re-scan (``read_band`` decodes and sorts), the engine
    over it and the snapshot (labels and pair list); the rest of a step
    is the next chunk's dispatch (tokenize).  ``counters`` maps names to kernel modules; their launches
    are set to 0 before the run and returned after it."""
    from repro_torch.core.session import DedupSession

    sess = DedupSession(cfg, backend="streaming", chunk_docs=T_CHUNK_DOCS,
                        store_path=store_path, retention=retention,
                        device=device)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    steps = []
    t0 = time.perf_counter()
    for snap in sess.ingest_stream(chunks, tokenized=tokenized):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        t = sess.stage_timings
        steps.append({"seconds": now - t0,
                      **{k: t[k] for k in (
                          "phase1_s", "phase1_kernel_s", "phase1_pack_s",
                          "phase1_upload_s", "phase1_download_s",
                          "phase1_store_s", "phase1_flushes", "rescan_s",
                          "engine_s", "merge_s")},
                      "snapshot_s": t["labels_s"] + t["pairs_s"],
                      "pairs_evaluated": snap.stats.pairs_evaluated,
                      "evicted": snap.evicted})
        t0 = now
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    store = sess._impl.sd.store
    summary = {"chunks": len(chunks), "steps": steps,
               "ingest_s": sum(x["seconds"] for x in steps),
               "pairs_evaluated": snap.stats.pairs_evaluated,
               "pairs_above_edge": snap.stats.pairs_above_edge,
               "verify_batches": snap.stats.verify_batches,
               "evicted": snap.evicted, "retained_rows": snap.retained_rows,
               "store": {"n_writes": store.n_writes,
                         "write_bytes": store.write_bytes,
                         "n_entries": store.n_entries(),
                         "file_size_bytes": store.file_size_bytes()},
               "launches": launches}
    return sess, snap, summary


def keep_mask(labels):
    """The first doc of each cluster is kept."""
    import numpy as np

    keep = np.zeros(len(labels), dtype=bool)
    keep[np.unique(labels, return_index=True)[1]] = True
    return keep


def phase_t(torch, notes: list[str], prov: list, ctx: dict,
            device: str = "cuda") -> dict:
    """The streaming backend on phase A's notes and H1's config, its band
    store a file in a temporary directory.  T1: ``cut_notes`` in
    ``H_CHUNKS`` chunks, flushed every ``T_CHUNK_DOCS`` notes (K1 once a
    flush, K2), against phase H's host session and one-shot run of the
    same notes.  T2: ``r3_notes`` byte
    streaming (K6 and K1) against a token streaming session fed no-stem
    token lists.  T3: ``r3_notes`` under an LRU window of ``T3_WINDOW``
    against the append-only streaming session, on the card and on the
    CPU.  T4: a standalone ``StreamingDedup`` clustered at two edge
    thresholds without re-hashing, then adopted by ``over_store``.  T5:
    the CLI's ``--streaming`` against H4's host-mode duplicate count.
    Returns each path's K1, K2 and K6 launches."""
    import re
    import tempfile
    from dataclasses import replace

    import numpy as np

    from repro_torch.core import shingle
    from repro_torch.core.pipeline import DedupConfig
    from repro_torch.core.retention import RetentionPolicy
    from repro_torch.core.session import DedupSession
    from repro_torch.core.streaming import StreamingDedup
    from repro_torch.kernels import byte_shingle as k6
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2

    counters = {"fused_ingest": (k1, "launches"),
                "pair_counts": (k2, "launches"),
                "byte_token_hashes": (k6, "launches")}
    launches = {}
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band")
    h1, one = ctx["h1_cut"], ctx["res_cut"]
    cut = cut_notes(notes, prov)
    size = -(-len(cut) // H_CHUNKS)
    chunks = [cut[i : i + size] for i in range(0, len(cut), size)]
    notes3 = r3_notes(notes, prov)
    size3 = -(-len(notes3) // H_CHUNKS)
    chunks3 = [notes3[i : i + size3] for i in range(0, len(notes3), size3)]
    flushes = sum(-(-len(c) // T_CHUNK_DOCS) for c in chunks)
    flushes3 = sum(-(-len(c) // T_CHUNK_DOCS) for c in chunks3)

    with tempfile.TemporaryDirectory() as tmp:
        # T1: the streaming session on the cut corpus.
        sess, snap, t1 = streaming_run(torch, cfg, chunks, device, counters,
                                       store_path=os.path.join(tmp, "t1.db"))
        launches["t1_session"] = t1["launches"]
        sims = {(a, b): s for a, b, s in h1["pairs"]}
        shared = [(s, sims[(a, b)]) for a, b, s in snap.pairs
                  if (a, b) in sims]
        check(len(shared) > 0 and all(x == y for x, y in shared),
              "T1: sims of pairs T1 and H1 both evaluate are equal")
        check(canonical(snap.labels) == canonical(h1["labels"]),
              "T1 partition == H1 partition")
        check(np.array_equal(keep_mask(snap.labels), keep_mask(h1["labels"])),
              "T1 keep mask == H1 keep mask")
        # The reference's streaming session keeps the one-shot run's
        # contract at this size: its labels id for id, and exactly its
        # verified pairs at equal sims.
        check(np.array_equal(snap.labels, one.labels),
              "T1 labels == one-shot labels, id for id")
        check(snap.stats.pairs_evaluated == one.stats.pairs_evaluated,
              "T1 pairs_evaluated == the one-shot's: the store re-scan "
              "verifies no pair twice")
        check(len(snap.pairs) == len(one.pairs)
              and ({(a, b): s for a, b, s in snap.pairs}
                   == {(a, b): s for a, b, s in one.pairs}),
              "T1 verified pairs and sims == the one-shot's")
        check(np.array_equal(sess.signatures, one.signatures),
              "T1 session signatures == one-shot signatures")
        check_pair_sims(torch, sess.signatures, snap, device, "T1")
        check(len(sess._impl.sd._sig_cache) == 0,
              "T1: the phase-1 host cache stays empty")
        check(t1["launches"]["fused_ingest"] == flushes
              and t1["launches"]["pair_counts"] > 0,
              "T1: K1 once a flush, and K2")
        t1.update(notes=len(cut), chunk_docs=T_CHUNK_DOCS, flushes=flushes,
                  shared_pairs=len(shared),
                  one_shot_pairs_evaluated=one.stats.pairs_evaluated,
                  h1_ingest_s=h1["summary"]["ingest_s"])
        emit(phase_t1=t1)
        del sess, snap, shared, sims, h1

        # T2: byte streaming against token streaming of no-stem tokens.
        kw = dict(use_kernels=True, exact_verification=False,
                  verify_batch="band")
        _, byt, t2b = streaming_run(
            torch, DedupConfig(byte_ingest=True, **kw), chunks3, device,
            counters, store_path=os.path.join(tmp, "t2_bytes.db"))
        launches["t2_byte_session"] = t2b["launches"]
        toks3 = [[shingle.tokenize(t, do_stem=False) for t in c]
                 for c in chunks3]
        _, tok, t2t = streaming_run(
            torch, DedupConfig(fused_ingest=True, **kw), toks3, device,
            counters, store_path=os.path.join(tmp, "t2_tokens.db"),
            tokenized=True)
        check(byt.labels.tolist() == tok.labels.tolist(),
              "T2 byte labels == no-stem token labels")
        check(byt.pairs == tok.pairs, "T2 byte (a, b, sim) list == token's")
        check(t2b["launches"]["byte_token_hashes"] == flushes3
              and t2b["launches"]["fused_ingest"] == flushes3
              and t2b["launches"]["pair_counts"] > 0,
              "T2: K6 and K1 once a flush, and K2")
        emit(phase_t2={"notes": len(notes3), "bytes": t2b, "tokens": t2t,
                       "clusters": byt.num_clusters})
        del byt, tok

        # T3: eviction over the store, against append-only, card and CPU.
        _, plain, t3p = streaming_run(torch, cfg, chunks3, device, counters,
                                      store_path=os.path.join(tmp, "t3.db"))
        policy = RetentionPolicy(lru_window=T3_WINDOW)
        out = {}
        for i, dev in enumerate((device, "cpu")):
            s3, snap3, summary = streaming_run(
                torch, cfg, chunks3, dev, counters, retention=policy,
                store_path=os.path.join(tmp, f"t3_evict{i}.db"))
            out[dev] = {"labels": snap3.labels.tolist(), "pairs": snap3.pairs,
                        "evicted": snap3.evicted,
                        "retained_rows": snap3.retained_rows,
                        "n_entries": summary["store"]["n_entries"],
                        "summary": summary}
            if dev == device:
                launches["t3_session"] = summary["launches"]
        for field in ("labels", "pairs", "evicted", "retained_rows",
                      "n_entries"):
            check(out[device][field] == out["cpu"][field],
                  f"T3 {field}: card == CPU")
        check(out[device]["labels"] == plain.labels.tolist()
              and out[device]["pairs"] == plain.pairs,
              "T3 labels and pairs == the append-only streaming session's")
        check(out[device]["evicted"] > 0, "T3 evicted rows")
        check(out[device]["n_entries"] < t3p["store"]["n_entries"],
              "T3: the compacted store holds fewer entries")
        # Phase Q's sqlite streaming sessions run on the same notes.
        ctx["t3"] = {"plain": {"labels": plain.labels.tolist(),
                               "pairs": plain.pairs,
                               "n_entries": t3p["store"]["n_entries"],
                               "ingest_s": t3p["ingest_s"]},
                     "window": {k: out[device][k] for k in (
                         "labels", "pairs", "evicted", "retained_rows",
                         "n_entries")}}
        emit(phase_t3={"notes": len(notes3), "lru_window": T3_WINDOW,
                       "append_only": t3p, "card": out[device]["summary"],
                       "cpu_s": out["cpu"]["summary"]["ingest_s"],
                       "n_entries_append_only": t3p["store"]["n_entries"],
                       "n_entries_compacted": out[device]["n_entries"]})
        del plain, out

        # T4: phase 2 again at another threshold, without re-hashing.
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        sd = StreamingDedup(cfg, store_path=os.path.join(tmp, "t4.db"),
                            chunk_docs=T_CHUNK_DOCS, device=device)
        sd.ingest(notes3)
        t4 = {"notes": len(notes3), "phase1_s": time.perf_counter() - t0,
              "phase1_launches": {n: getattr(m, a)
                                  for n, (m, a) in counters.items()},
              "clusters": []}
        check(t4["phase1_launches"]["fused_ingest"]
              == -(-len(notes3) // T_CHUNK_DOCS), "T4: K1 once a flush")
        for edge in T4_EDGES:
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            uf, stats = sd.cluster(edge_threshold=edge)
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            run = {n: getattr(m, a) for n, (m, a) in counters.items()}
            check(run["fused_ingest"] == 0 and run["pair_counts"] > 0,
                  f"T4: cluster({edge}) launches K2 and no K1")
            labels = uf.components()[: sd.n_docs]
            t4["clusters"].append({
                "edge_threshold": edge, "seconds": seconds, "launches": run,
                "pairs_evaluated": stats["pairs_evaluated"],
                "duplicates": int(sd.n_docs - len(set(labels.tolist())))})
        pair_sims = [
            {(a, b): s for a, b, s in DedupSession.over_store(
                sd, config=replace(cfg, edge_threshold=edge)).acc.pairs}
            for edge in T4_EDGES]
        both = [(s, pair_sims[1][k]) for k, s in pair_sims[0].items()
                if k in pair_sims[1]]
        check(len(both) > 0 and all(x == y for x, y in both),
              "T4: sims of pairs both thresholds evaluate are equal")
        live = DedupSession.over_store(sd)
        snap = live.ingest([notes3[0]])
        check(snap.labels[len(notes3)] == snap.labels[0],
              "T4: a re-ingested copy of doc 0 joins doc 0's cluster")
        t4["shared_pairs"] = len(both)
        emit(phase_t4=t4)
        launches["t4_rethreshold"] = t4["clusters"][-1]["launches"]
        del sd, live, snap, pair_sims, both

        # T5: the CLI's streaming mode, as a user runs it.
        argv = [sys.executable, "-m", "repro_torch.launch.dedup", "--notes",
                "2000", "--dups", "1000", "--steps", "4", "--streaming",
                "--estimate", "--fused-ingest", "--use-kernels", "--chunk",
                str(T_CHUNK_DOCS), "--store-path",
                os.path.join(tmp, "t5.db"), "--device", device]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                              env={**os.environ,
                                   "PYTHONPATH": str(ROOT / "src")},
                              timeout=600)
        seconds = time.perf_counter() - t0
    report = proc.stdout.splitlines()
    check(proc.returncode == 0,
          f"streaming dedup CLI exits 0: {proc.stderr[-2000:]}")
    line = [ln for ln in report if ln.startswith("streaming[4 step(s)]: ")]
    check(len(line) == 1, "streaming dedup CLI prints its report line")
    dups = re.compile(r" (\d+) duplicates,")
    host = [ln for ln in ctx["h4_report"] if ln.startswith("host[")]
    check(dups.search(line[0]).group(1) == dups.search(host[0]).group(1),
          "T5: streaming CLI duplicates == H4's host-mode duplicates")
    emit(phase_t5={"argv": argv[1:], "seconds": seconds, "report": report,
                   "h4_report": host[0]})
    return launches


# -- phase Q: the sqlite band-store tier ---------------------------------------------

def phase_q(torch, clock_hz: float, notes: list[str], prov: list, ctx: dict,
            device: str = "cuda") -> tuple[dict, dict]:
    """The sqlite tier, each store a file in a temporary directory.  Q1: a host
    session with H1's config and ``store="sqlite"`` over ``cut_notes``
    in H1's chunk count (K1 once a chunk, K2), its cross-step index on
    disk, equal in labels and (a, b, sim) list to phase H's memory-tier
    session of the same notes.  Q2: H3's queries through a ``kernel``
    ``DedupQueryService`` over Q1's view, whose probe is the store's
    Bloom-first ``probe_keys``, equal to the same service's answers over
    that memory-tier session.  Q3: ``r3_notes`` through a sqlite
    streaming session, append-only and under T3's window, verified off
    disk by ``DiskSignatureVerifier`` (K2', no K2), equal to T3's
    memory-tier sessions; every sim equals K2's plain counts / M on the
    rows read back from disk.  Q4: the CLI's ``--streaming --store
    sqlite`` with H4's duplicate count.  Returns each path's K1, K2 and
    K2' launches, and K2''s time on a verify batch of Q3's rows."""
    import re
    import tempfile
    from dataclasses import replace

    import numpy as np

    from repro_torch.core import query
    from repro_torch.core.bandstore import (
        DiskSignatureVerifier,
        SqliteBandStore,
    )
    from repro_torch.core.hashing import u32_from_numpy
    from repro_torch.core.minhash import estimate_from_counts
    from repro_torch.core.pipeline import DedupConfig
    from repro_torch.core.retention import RetentionPolicy
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2
    from repro_torch.serving import DedupQueryService

    counters = {"fused_ingest": (k1, "launches"),
                "pair_counts": (k2, "launches"),
                "pair_estimate": (k2, "masked_launches")}
    launches = {}
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band", store="sqlite")
    h1, h3, t3 = ctx.pop("h1_cut"), ctx.pop("h3"), ctx.pop("t3")
    res_cut = ctx.pop("res_cut")
    cut = cut_notes(notes, prov)
    notes3 = r3_notes(notes, prov)
    size3 = -(-len(notes3) // H_CHUNKS)
    chunks3 = [notes3[i : i + size3] for i in range(0, len(notes3), size3)]
    flushes3 = sum(-(-len(c) // T_CHUNK_DOCS) for c in chunks3)

    with tempfile.TemporaryDirectory() as tmp:
        # Q1: phase H's cut-depth session with its cross-step index on
        # disk.
        sess, snap, q1 = session_run(torch, cfg, cut, res_cut, device,
                                     counters,
                                     store_path=os.path.join(tmp, "q1.db"))
        launches["q1_session"] = q1["launches"]
        index = sess.band_index
        check(isinstance(index, SqliteBandStore),
              "Q1: the cross-step index is a SqliteBandStore")
        check(np.array_equal(snap.labels, h1["labels"]),
              "Q1 labels == the memory tier's, id for id")
        check(snap.pairs == h1["pairs"],
              "Q1 (a, b, sim) list == the memory tier's")
        check(q1["launches"]["fused_ingest"] == H_CHUNKS
              and q1["launches"]["pair_counts"] > 0,
              "Q1: K1 once a chunk, and K2")
        q1.update(notes=len(cut), store={
            "stats": index.stats(), "n_writes": index.n_writes,
            "write_bytes": index.write_bytes},
            h1_ingest_s=h1["summary"]["ingest_s"])
        emit(phase_q1=q1)

        # Q2: H3's queries through the store's Bloom-first probe, against
        # the memory tier's dict walk over the same notes.
        want, _ = serve_queries(
            torch, DedupQueryService(h1.pop("sess"), backend="kernel",
                                     max_batch=H_MICROBATCH),
            h3["queries"], device)
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        svc = DedupQueryService(sess, backend="kernel",
                                max_batch=H_MICROBATCH)
        got, timing = serve_queries(torch, svc, h3["queries"], device)
        run_launches = {n: getattr(m, a) for n, (m, a) in counters.items()}
        launches["q2_query"] = run_launches
        view = sess.view()
        check(view.band_store is index and view.band_maps == (),
              "Q2: the view probes the live store")
        check(got == want, "Q2 answers == the memory tier's")
        check(run_launches["fused_ingest"] == timing["microbatches"]
              and run_launches["pair_counts"] > 0,
              "Q2: K1 once a microbatch, and K2, on the read path")
        q_bands = query_bands(sess, h3["queries"])
        probe = []
        for s in range(0, len(q_bands), H_MICROBATCH):
            t0 = time.perf_counter()
            query.probe_candidates(view, q_bands[s : s + H_MICROBATCH])
            probe.append(time.perf_counter() - t0)
        emit(phase_q2={**timing, "queries": len(h3["queries"]),
                       "launches": run_launches,
                       "duplicates": sum(r.is_duplicate for r in got),
                       "h3_median_microbatch_ms": h3["median_microbatch_ms"],
                       "probe_stats": index.probe_stats(q_bands),
                       "probe_median_microbatch_ms":
                           float(np.median(probe)) * 1e3})
        del sess, snap, svc, view, got, want, index, h1, h3, res_cut

        # Q3: streaming over a sqlite store, append-only and windowed.
        out = {}
        for name, policy in (("append_only", None),
                             ("window", RetentionPolicy(
                                 lru_window=T3_WINDOW))):
            s3, snap3, summary = streaming_run(
                torch, cfg, chunks3, device, counters, retention=policy,
                store_path=os.path.join(tmp, f"q3_{name}.db"))
            launches[f"q3_{name}"] = summary["launches"]
            want = t3["plain" if policy is None else "window"]
            check(snap3.labels.tolist() == want["labels"]
                  and snap3.pairs == want["pairs"],
                  f"Q3 {name}: labels and pairs == T3's memory tier")
            v, store = s3.verifier, s3._impl.sd.store
            check(isinstance(v, DiskSignatureVerifier)
                  and v.device.type == device,
                  f"Q3 {name}: verified off disk on the {device}")
            check(summary["launches"]["fused_ingest"] == flushes3
                  and summary["launches"]["pair_counts"] == 0
                  and summary["launches"]["pair_estimate"] > 0,
                  f"Q3 {name}: K1 once a flush, K2' and no K2")
            summary.update(
                n_signatures=store.n_signatures(),
                cache_hits=v.cache_hits, cache_misses=v.cache_misses,
                verify_batches=v.n_batches,
                verify_ms_per_batch=v.seconds / max(v.n_batches, 1) * 1e3)
            out[name] = (s3, snap3, summary)
        s3, snap3, plain = out["append_only"]
        store = s3._impl.sd.store
        rows = np.stack([store.get_signature(d) for d in range(len(notes3))])
        pairs = np.array([(a, b) for a, b, _ in snap3.pairs], dtype=np.int64)
        sims = np.array([s for _, _, s in snap3.pairs], dtype=np.float32)
        sig = u32_from_numpy(rows, device)
        M = sig.shape[1]
        counts = k2.pair_counts_plain(sig, torch.from_numpy(pairs[:, 0]).to(
            device), torch.from_numpy(pairs[:, 1]).to(device))
        check(np.array_equal(sims, counts.cpu().numpy().astype(np.float32)
                             / np.float32(M)),
              "Q3 sims == K2 plain counts / M on the rows read from disk")
        _, snapw, window = out["window"]
        storew = out["window"][0]._impl.sd.store
        check(snapw.evicted == t3["window"]["evicted"] > 0,
              "Q3 window: T3's evictions")
        check(storew.n_signatures() == snapw.retained_rows
              == t3["window"]["retained_rows"] < store.n_signatures(),
              "Q3 window: signature rows shrink to T3's retained rows")
        check(storew.n_entries() == t3["window"]["n_entries"]
              < store.n_entries() == t3["plain"]["n_entries"],
              "Q3 window: store entries shrink to T3's")
        # K2' alone on one verify batch of Q3's pairs, at its real size.
        P = min(VERIFY_BATCH, len(pairs))
        a, b = sig[torch.from_numpy(pairs[:P, 0]).to(device)], \
            sig[torch.from_numpy(pairs[:P, 1]).to(device)]
        every = torch.ones(P, dtype=torch.bool, device=device)

        def plain_k2p():
            return estimate_from_counts(
                k2.masked_pair_counts_plain(a, b, every), M)

        got = k2.pair_estimate(a, b)
        want = plain_k2p()
        check(torch.equal(got, want), "K2' on a Q3 batch == its plain version")
        batch = {"shape": {"P": P, "M": M},
                 "max_abs_err": float((got - want).abs().max()),
                 "ms": cuda_ms(torch, lambda: k2.pair_estimate(a, b), 20),
                 "plain_ms": cuda_ms(torch, plain_k2p, 5),
                 "verify_ms_per_batch": plain["verify_ms_per_batch"],
                 **k7_bound(torch, every, M, clock_hz)}
        if device == "cuda":
            batch["device_ms"] = graph_ms(
                torch, lambda: k2.pair_estimate(a, b), 20)
        emit(phase_q3={"notes": len(notes3), "lru_window": T3_WINDOW,
                       "append_only": plain, "window": window,
                       "t3_append_only_ingest_s": t3["plain"]["ingest_s"],
                       "k2_prime_batch": batch})
        del out, s3, snap3, store, storew, snapw, rows, sig, a, b

        # Q4: the CLI's streaming mode over a sqlite store.
        argv = [sys.executable, "-m", "repro_torch.launch.dedup", "--notes",
                "2000", "--dups", "1000", "--steps", "4", "--streaming",
                "--estimate", "--fused-ingest", "--use-kernels", "--chunk",
                str(T_CHUNK_DOCS), "--store", "sqlite", "--store-path",
                os.path.join(tmp, "q4.db"), "--device", device]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                              env={**os.environ,
                                   "PYTHONPATH": str(ROOT / "src")},
                              timeout=600)
        seconds = time.perf_counter() - t0
    report = proc.stdout.splitlines()
    check(proc.returncode == 0,
          f"sqlite streaming dedup CLI exits 0: {proc.stderr[-2000:]}")
    line = [ln for ln in report if ln.startswith("streaming[4 step(s)]: ")]
    check(len(line) == 1, "sqlite streaming dedup CLI prints its report line")
    dups = re.compile(r" (\d+) duplicates,")
    host = [ln for ln in ctx["h4_report"] if ln.startswith("host[")]
    check(dups.search(line[0]).group(1) == dups.search(host[0]).group(1),
          "Q4: sqlite streaming CLI duplicates == H4's host-mode duplicates")
    emit(phase_q4={"argv": argv[1:], "seconds": seconds, "report": report,
                   "h4_report": host[0]})
    return launches, batch


# -- phase S: the sharded step ----------------------------------------------------

def step_k7_inputs(torch, group: dict, D: int):
    """K7's indexed inputs in one band group of a one-rank step: the
    gathered edges, and the mask of those whose two ends are rows."""
    edges = group["edges"]
    a, b = edges[:, 0], edges[:, 1]
    inside = (a >= 0) & (a < D) & (b >= 0) & (b < D)
    return a, b, group["edge_mask"] & inside


def phase_s(torch, clock_hz: float, ctx: dict) -> dict:
    """``make_streamed_dedup_step`` and ``cluster_step_output`` on phase
    A's packed matrix over the NCCL group: stage 2 on host (K2), then on
    device (K7)."""
    import numpy as np

    from repro_torch.core import dist_lsh
    from repro_torch.core.hashing import u32_to_numpy
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2

    tokens, lengths, seeds = ctx["tokens"], ctx["lengths"], ctx["seeds"]
    D, M = tokens.shape[0], seeds.shape[0]
    mesh = dist_lsh.docs_mesh("cuda")
    check(mesh.group is not None and mesh.n_dev == 1,
          "the step runs on the NCCL group")
    # Edge capacity D_loc x bands per group: no band can drop an edge.
    base = dict(fused_ingest=True, band_groups=5, bucket_slack=1.0,
                edge_capacity=D * 10)
    # NCCL makes its communicator at the group's first collective: time
    # that alone, so neither run's step time carries it.
    t0 = time.perf_counter()
    torch.distributed.all_reduce(torch.zeros(1, device="cuda"),
                                 group=mesh.group)
    torch.cuda.synchronize()
    nccl_setup_s = time.perf_counter() - t0
    runs = {}
    for stage2 in ("host", "device"):
        cfg = dist_lsh.DistLSHConfig(**base, stage2=stage2)
        step = dist_lsh.make_streamed_dedup_step(cfg, mesh)
        step(tokens, lengths, seeds)  # untimed: first calls of each op
        torch.cuda.synchronize()
        k1.launches = k2.launches = k2.masked_launches = 0
        t0 = time.perf_counter()
        out = step(tokens, lengths, seeds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = dist_lsh.cluster_step_output(out, cfg, backend="kernel",
                                           batch="band", num_docs=D)
        t2 = time.perf_counter()
        runs[stage2] = dict(
            out=out, res=res, step_s=t1 - t0, cluster_step_output_s=t2 - t1,
            verify_s=res.stats.verify_seconds,
            launches={"fused_ingest": k1.launches, "pair_counts": k2.launches,
                      "masked_pair_counts": k2.masked_launches})
    host, dev = runs["host"], runs["device"]
    check(host["launches"]["fused_ingest"] > 0
          and host["launches"]["pair_counts"] > 0,
          "K1 and K2 launched on the host-stage-2 step")
    check(dev["launches"]["masked_pair_counts"] > 0,
          "K7 launched on the device-stage-2 step")
    check(np.array_equal(u32_to_numpy(host["out"]["sig"]),
                         ctx["res"].signatures),
          "sharded step signatures == phase A's")
    for hg, dg in zip(host["out"]["groups"], dev["out"]["groups"],
                      strict=True):
        check(all(torch.equal(hg[k], dg[k]) for k in
                  ("edges", "edge_mask", "prescreen_sims", "stats")),
              "host and device runs' edge buffers are equal")
    for run in runs.values():
        check(run["res"].overflow == 0 and not run["res"].retried,
              "no bucket or edge buffer overflowed")
    hr, dr = host["res"], dev["res"]
    check(np.array_equal(hr.labels(), dr.labels()),
          "device stage 2 labels == host stage 2 labels")
    check(hr.pairs == dr.pairs, "device stage 2 (a, b, sim) == host stage 2")
    check(dr.device_scored > 0, "edges served from device scores")
    # Phase D's first session takes the same notes in chunks.
    ctx["s_one_shot"] = {"labels": dr.labels(), "pairs": dr.pairs,
                         "config": base}

    # K7 on the step's own gathered edges, against its plain version and
    # against the counts the step returned.
    sig = dev["out"]["sig"]
    inputs = [step_k7_inputs(torch, grp, D) for grp in dev["out"]["groups"]]
    got = [k2.masked_indexed_pair_counts(sig, a, b, v) for a, b, v in inputs]
    want = [k2.masked_indexed_pair_counts_plain(sig, a, b, v)
            for a, b, v in inputs]
    k7_err = max(int((g_ - w).abs().max()) for g_, w in zip(got, want))
    check(k7_err == 0, "K7 == plain on the step's gathered edges")
    check(all(torch.equal(g_, grp["device_match_counts"])
              for g_, grp in zip(got, dev["out"]["groups"])),
          "the step's device counts == K7 on its gathered edges")
    k7_ms = cuda_ms(torch, lambda: [k2.masked_indexed_pair_counts(sig, *x)
                                    for x in inputs], 20)
    k7_device_ms = graph_ms(torch, lambda: [
        k2.masked_indexed_pair_counts(sig, *x) for x in inputs], 20)
    k7_plain_ms = cuda_ms(torch, lambda: [
        k2.masked_indexed_pair_counts_plain(sig, *x) for x in inputs], 5)
    valid = torch.cat([v for _, _, v in inputs])
    summary = {}
    for name, run in runs.items():
        res = run["res"]
        summary[name] = {
            "step_s": run["step_s"],
            "cluster_step_output_s": run["cluster_step_output_s"],
            "verify_s": run["verify_s"],
            "merge_s": run["cluster_step_output_s"] - run["verify_s"],
            "notes_per_s": D / (run["step_s"] + run["cluster_step_output_s"]),
            "launches": run["launches"], "num_edges": res.num_edges,
            "pairs_evaluated": res.stats.pairs_evaluated,
            "unions": res.stats.unions_done,
            "device_scored": res.device_scored,
            "host_rescored": res.host_rescored,
            "device_stats": res.device_stats.tolist()}
    emit(phase_s={"docs": D, "L": int(tokens.shape[1]),
                  "config": base, "runs": summary,
                  "nccl_setup_s": nccl_setup_s,
                  "clusters": int((np.unique(dr.labels(), return_counts=True)[1]
                                   >= 2).sum()),
                  "k7_ms": k7_ms, "k7_device_ms": k7_device_ms,
                  "k7_launches": dev["launches"][
                      "masked_pair_counts"], "host_match": True})
    return {"name": "masked_indexed_pair_counts", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sigjaccard_masked.cu",
            "replaces": "src/repro/kernels/sigjaccard.py:150",
            "launches": dev["launches"]["masked_pair_counts"],
            "max_abs_err": k7_err, "ms": k7_ms, "device_ms": k7_device_ms,
            "plain_ms": k7_plain_ms, "library_ms": None, "match": True,
            "shape": {"D": D, "M": M, "P": int(valid.shape[0]),
                      "launches": len(inputs)},
            **pair_path(k2, M, sig, sig),
            **k7_bound(torch, valid, M, clock_hz,
                       torch.cat([a for a, _, _ in inputs]),
                       torch.cat([b for _, b, _ in inputs]), D)}


def phase_s2(torch, clock_hz, g, tokens, lengths, seeds, sig) -> dict:
    """The sharded step (device stage 2) on phase B's matrix with 65,536
    rows made copies of other rows, timed part by part."""
    from repro_torch.core import dist_lsh
    from repro_torch.kernels import sigjaccard as k7

    D, M = sig.shape
    n_copies = 1 << 16
    # Sources keep at least n tokens, so no copy joins the empty rows'
    # run; rows 0-15 (forced lengths) are neither source nor copy.
    perm = torch.randperm(D - 16, generator=g, device="cuda") + 16
    src, dst = perm[:n_copies], perm[n_copies : 2 * n_copies]
    lengths[src] = lengths[src].clamp(min=8)
    tokens[dst] = tokens[src]
    lengths[dst] = lengths[src]
    cfg = dist_lsh.DistLSHConfig(fused_ingest=True, band_groups=5,
                                 bucket_slack=1.0, edge_capacity=D,
                                 stage2="device")
    mesh = dist_lsh.docs_mesh("cuda")
    step = dist_lsh.make_streamed_dedup_step(cfg, mesh)
    torch.cuda.synchronize()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    k7.masked_launches = 0
    t0 = time.perf_counter()
    out = step(tokens, lengths, seeds)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = k7.masked_launches
    check(launches == cfg.band_groups, "K7 launched once per band group")
    stats = torch.cat([grp["stats"] for grp in out["groups"]])
    check(int(stats[:, 2].sum()) == 0, "paper-scale step: nothing overflowed")

    # Every planted copy's edge, with count M, in every band group.
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    planted = lo * D + hi
    for grp in out["groups"]:
        a, b, v = step_k7_inputs(torch, grp, D)
        full = v & (grp["device_match_counts"] == M)
        found = a[full].to(torch.int64) * D + b[full].to(torch.int64)
        check(bool(torch.isin(planted, found).all()),
              "every planted copy's edge is found with count M")
    a, b, v = step_k7_inputs(torch, out["groups"][0], D)
    got = k7.masked_indexed_pair_counts(out["sig"], a, b, v)
    k7_err = int((got - k7.masked_indexed_pair_counts_plain(
        out["sig"], a, b, v)).abs().max())
    check(k7_err == 0, "paper-scale step: K7 == plain on its gathered edges")

    # The step's parts, timed alone (the step's own private stages).
    bg = cfg.bands_per_group
    cap, doc_ids = dist_lsh._group_layout(D, 0, cfg, mesh)
    sig_s, bands = dist_lsh._local_prepare(tokens, lengths, seeds, cfg)
    prepare_ms = cuda_ms(torch, lambda: dist_lsh._local_prepare(
        tokens, lengths, seeds, cfg), 3)
    sig_k = sig_s[:, : cfg.verify_k]
    prescreen_ms = [cuda_ms(torch, lambda j=j: dist_lsh._prescreen_scan(
        bands[:, j * bg : (j + 1) * bg], doc_ids, sig_k, cfg, mesh, cap), 1)
        for j in range(cfg.band_groups)]
    k7_ms = cuda_ms(torch, lambda: k7.masked_indexed_pair_counts(
        out["sig"], a, b, v), 10)
    k7_plain_ms = cuda_ms(torch, lambda: k7.masked_indexed_pair_counts_plain(
        out["sig"], a, b, v), 3)
    edges = [int(grp["stats"][0, 0]) for grp in out["groups"]]
    result = {"docs": D, "copies": n_copies, "step_s": step_s,
              "docs_per_s": D / step_s, "prepare_k1_ms": prepare_ms,
              "prescreen_ms_per_group": prescreen_ms,
              "k7_ms_per_group": k7_ms, "k7_plain_ms_per_group": k7_plain_ms,
              "k7_launches": launches, "k7_max_abs_err": k7_err,
              "k7_path": pair_path(k7, M, out["sig"], out["sig"]),
              "edges_per_group": edges,
              "candidates_per_group": [int(grp["stats"][0, 1])
                                       for grp in out["groups"]],
              "resident_gib_before": base_gib, "peak_gib": peak_gib,
              **{"k7_" + k: val for k, val in
                 k7_bound(torch, v, M, clock_hz, a, b, D).items()}}
    emit(phase_s2=result)
    return result


# -- phase D: the sharded session -------------------------------------------------

D_CHUNKS, D2_CHUNKS = 4, 3
# D1's chunk ends in phase A's notes: the third chunk ends ``R1_WINDOW``
# notes into the near-duplicates (which start at ``PHASE_A_NOTES``), so
# their unions depose docs among its last ``R1_WINDOW`` ids, and the
# sweeps between the fourth chunk's band groups are what evict them.  In
# four equal chunks every near-duplicate sits in the last one, and no
# sweep inside a step finds anything to evict.
D1_ENDS = (4096, 8192, PHASE_A_NOTES + R1_WINDOW, PHASE_A_NOTES + PHASE_A_DUPS)
D4_QUERIES = 64
D_COUNTERS = ("overflow", "retried", "device_scored", "host_rescored",
              "row_overflow")
STATS_FIELDS = ("pairs_generated", "pairs_evaluated", "pairs_excluded",
                "pairs_above_edge", "unions_done", "unions_rejected",
                "verify_batches")


def sharded_run(torch, cfg, dcfg, chunks, device: str, counters: dict, *,
                mesh=None, tokenized: bool = False, step_times=None,
                retention=None, store_path: str = ":memory:",
                wrap=None) -> tuple:
    """One sharded ``DedupSession`` over ``chunks`` (``ingest_stream``),
    under ``retention`` and with its cross-step index at ``store_path``
    (sqlite configs), each step timed on the host clock after a
    synchronize and split by the session's ``stage_timings``.
    ``counters`` maps names to (kernel module, counter); they are set to
    0 before the run and returned after it.  With ``step_times`` (a list)
    each chunk's sharded step is timed alone, between two synchronizes,
    into it.  ``wrap(sess)``, if given, is called on the new session
    before the run, for a caller's own probes."""
    from repro_torch.core.session import DedupSession

    sess = DedupSession(cfg, backend="sharded", dist_config=dcfg, mesh=mesh,
                        retention=retention, store_path=store_path,
                        device=device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    if step_times is not None:
        inner = sess._impl._run_step

        def timed_step(*args):
            sync()
            t0 = time.perf_counter()
            out = inner(*args)
            sync()
            step_times.append(time.perf_counter() - t0)
            return out

        sess._impl._run_step = timed_step
    if wrap is not None:
        wrap(sess)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    steps = []
    t0 = time.perf_counter()
    for snap in sess.ingest_stream(chunks, tokenized=tokenized):
        sync()
        now = time.perf_counter()
        t = sess.stage_timings
        steps.append({"seconds": now - t0, "merge_s": t["merge_s"],
                      "feed_s": t["feed_s"], "cross_step_s": t["cross_step_s"],
                      "cross_step_edges": t["cross_step_edges"],
                      "pairs_evaluated": snap.stats.pairs_evaluated})
        if retention is not None:
            steps[-1].update(sweep_s=t["sweep_s"], evicted=snap.evicted)
        t0 = now
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    n = snap.n_docs
    ingest_s = sum(x["seconds"] for x in steps)
    summary = {"chunks": len(chunks), "notes": n, "steps": steps,
               "ingest_s": ingest_s, "notes_per_s": n / ingest_s,
               "merge_s": sum(x["merge_s"] for x in steps),
               "pairs_evaluated": snap.stats.pairs_evaluated,
               "verify_batches": snap.stats.verify_batches,
               "launches": launches,
               **{f: getattr(snap, f) for f in D_COUNTERS}}
    if retention is not None:
        summary.update(evicted=snap.evicted,
                       retained_rows=snap.retained_rows,
                       refine_merges=snap.refine_merges,
                       filter_only_hits=snap.filter_only_hits,
                       band_index=sess.band_index.stats())
    return sess, snap, summary


def session_record(snap) -> dict:
    """What two runs of one sharded session must share, field by field."""
    return {"n_docs": snap.n_docs, "labels": snap.labels.tolist(),
            "pairs": snap.pairs,
            "stats": [getattr(snap.stats, f) for f in STATS_FIELDS],
            **{f: getattr(snap, f) for f in D_COUNTERS}}


def retention_record(sess, snap) -> dict:
    """``session_record`` and the retained state: rows evicted and kept,
    the roots, second-round merges, and the index's compaction."""
    return {**session_record(snap), "evicted": snap.evicted,
            "retained_rows": snap.retained_rows,
            "representatives": snap.representatives.tolist(),
            "refine_merges": snap.refine_merges,
            "filter_only_hits": snap.filter_only_hits,
            "compacted_keys": sess.band_index.compacted_keys}


def d4_run(torch, stage2: str, chunks, device: str, counters: dict, *,
           mesh=None, store_path: str | None = None) -> tuple:
    """One D4 session: D2's chunks through a sharded session with stage 2
    on ``stage2``, fused ingest and K5 in refine, under the ``small``
    preset refining every 2 steps, its cross-step index in sqlite at
    ``store_path`` (else in memory).  Returns the session, its
    ``retention_record``, ``sharded_run``'s summary and each refine's
    launches."""
    from repro_torch.core import dist_lsh
    from repro_torch.core.pipeline import DedupConfig
    from repro_torch.core.retention import RetentionPolicy
    from repro_torch.kernels import bandfold as k5
    from repro_torch.kernels import sigjaccard as k2

    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band",
                      store="memory" if store_path is None else "sqlite")
    dcfg = dist_lsh.DistLSHConfig(fused_ingest=True, band_groups=5,
                                  stage2=stage2,
                                  edge_capacity=len(chunks[0]) * 10)
    refines: list = []

    def count_refines(sess):
        """Each refine appends its K2 and K5 launches and timings."""
        refine = sess.refine

        def counted_refine():
            k2_0, k5_0 = k2.launches, k5.launches
            snap = refine()
            if device == "cuda":
                torch.cuda.synchronize()
            t = sess.stage_timings
            refines.append({"pair_counts": k2.launches - k2_0,
                            "band_values": k5.launches - k5_0,
                            **{k: t[k] for k in ("refine_s", "refine_band_s",
                                                 "refine_pairs",
                                                 "refine_merges")}})
            return snap

        sess.refine = counted_refine

    sess, snap, summary = sharded_run(
        torch, cfg, dcfg, chunks, device, counters, mesh=mesh,
        retention=RetentionPolicy.preset("small", refine_every=2),
        store_path=store_path or ":memory:", wrap=count_refines)
    return sess, retention_record(sess, snap), summary, refines


def d4_cpu_twins(chunks_path: str, out_path: str) -> None:
    """D4's two CPU sessions (stage 2 on the host, on the device) over the
    chunks in the JSON file ``chunks_path``, on a mesh of one shard
    without a group; their records, summaries and refines go to
    ``out_path`` (a pickle).  Phase D runs this in a subprocess beside
    its card sessions."""
    import pickle

    import torch

    from repro_torch.core import dist_lsh

    torch.set_num_threads(2)
    with open(chunks_path) as f:
        chunks = json.load(f)
    mesh = dist_lsh.DocsMesh(group=None, rank=0, n_dev=1,
                             device=torch.device("cpu"))
    out = {}
    for stage2 in ("host", "device"):
        out[stage2] = d4_run(torch, stage2, chunks, "cpu", {}, mesh=mesh)[1:]
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def phase_d(torch, notes: list[str], prov: list, ctx: dict,
            device: str = "cuda") -> dict:
    """The sharded ``DedupSession`` (``backend="sharded"``) over the
    one-rank NCCL group.  D1: phase A's notes in ``D_CHUNKS`` chunks
    (``D1_ENDS``) at full width (M 100, r 2, n 8) with K1 and device stage 2
    (K7), phase S's buffers, under an LRU window of ``R1_WINDOW``,
    held against phase A's signatures and phase S's one-shot step, every
    pair's sim against K2's plain counts / M; rows are evicted, also by
    the sweeps between band groups.  D2: ``r3_notes`` in ``D2_CHUNKS``
    chunks with host stage 2, on the card and on the CPU (a mesh of one
    shard without a group) field by field; byte ingest (K6 -> K1)
    against no-stem tokens; device stage 2 against host stage 2.  D4:
    D2's notes and chunks under the ``small`` preset refining every 2
    steps, host and device stage 2: the card against the CPU, and the
    sqlite index against the memory one, field by field, and 64 of H3's
    queries through ``query_view`` over both views.  D3: the CLI's
    ``--sharded --stage2 device`` with ``--retain-budget small
    --refine-every 2 --store sqlite`` on the card against the same
    command with ``--device cpu``.  Returns each path's K1, K2, K5, K6
    and K7 launches."""
    import pickle
    import tempfile
    from dataclasses import replace

    import numpy as np

    from repro_torch.core import dist_lsh, shingle
    from repro_torch.core.bandstore import SqliteBandStore
    from repro_torch.core.hashing import u32_to_numpy
    from repro_torch.core.pipeline import DedupConfig, DedupPipeline
    from repro_torch.core.query import query_view
    from repro_torch.core.retention import RetentionPolicy
    from repro_torch.kernels import bandfold as k5
    from repro_torch.kernels import byte_shingle as k6
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2

    counters = {"fused_ingest": (k1, "launches"),
                "pair_counts": (k2, "launches"),
                "band_values": (k5, "launches"),
                "byte_token_hashes": (k6, "launches"),
                "masked_indexed_pair_counts": (k2, "masked_launches")}
    launches = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    procs = {}
    tmp = tempfile.TemporaryDirectory()
    cli = [sys.executable, "-m", "repro_torch.launch.dedup", "--sharded",
           "--stage2", "device", "--fused-ingest", "--steps", "4",
           "--retain-budget", "small", "--refine-every", "2", "--store",
           "sqlite"]
    try:
        # D1: phase A's notes, phase S's buffers, 4 chunks, under R1's
        # window.
        one = ctx.pop("s_one_shot")
        cfg = DedupConfig(fused_ingest=True, exact_verification=False,
                          verify_backend="kernel", verify_batch="band")
        dcfg = dist_lsh.DistLSHConfig(
            fused_ingest=True, band_groups=5, stage2="device",
            bucket_slack=one["config"]["bucket_slack"],
            edge_capacity=one["config"]["edge_capacity"])
        check(len(D1_ENDS) == D_CHUNKS and D1_ENDS[-1] == len(notes),
              "D1's chunks cover phase A's notes")
        chunks = [notes[a:b] for a, b in zip((0,) + D1_ENDS[:-1], D1_ENDS)]
        step_s, sig_rows, in_step = [], [], []

        def probe_d1(sess):
            """Each chunk's retained signature rows go to ``sig_rows`` on
            the host; each sweep between band groups appends its
            evictions to ``in_step``."""
            retain, sweep = sess._retain, sess.retention.sweep

            def kept_retain(toks, sig):
                sig_rows.append(u32_to_numpy(sig))
                retain(toks, sig)

            def counted_sweep(s, protect_from=None):
                n = sweep(s, protect_from=protect_from)
                if protect_from is not None:
                    in_step.append(n)
                return n

            sess._retain = kept_retain
            sess.retention.sweep = counted_sweep

        sess, snap, d1 = sharded_run(
            torch, cfg, dcfg, chunks, device, counters, step_times=step_s,
            retention=RetentionPolicy(lru_window=R1_WINDOW), wrap=probe_d1)
        launches["d1_session"] = d1["launches"]
        n = len(notes)
        want_sig = ctx["res"].signatures
        v = sess.verifier
        check(snap.n_docs == n, "D1 covers every note")
        check(np.array_equal(np.concatenate(sig_rows), want_sig),
              "D1 signatures == phase A's")
        live = (np.array(sorted(v._slots.slot_of), dtype=np.int64)
                if v._slots is not None else np.arange(n))
        check(np.array_equal(v.rows_for(live), want_sig[live]),
              "D1 retained rows == phase A's rows of those docs")
        check(snap.overflow == snap.retried == snap.row_overflow == 0,
              "D1: nothing overflowed, no retry")
        check(snap.device_scored > 0 and snap.host_rescored == 0,
              "D1: device-scored edges, no host re-score")
        check(snap.evicted > 0, "D1 evicted rows")
        check(sum(in_step) > 0, "D1: the sweeps between band groups evicted "
              "rows")
        check(snap.retained_rows == v.n_live_rows == n - snap.evicted < n,
              "D1 retained rows == docs - evicted < docs")
        check_pair_sims(torch, want_sig, snap, device, "D1")
        check(d1["launches"]["fused_ingest"] == D_CHUNKS,
              "D1: K1 once a chunk")
        check(d1["launches"]["masked_indexed_pair_counts"]
              >= D_CHUNKS * dcfg.band_groups,
              "D1: K7 at least once a band group a chunk")
        check(d1["launches"]["pair_counts"] > 0, "D1: K2 launched")
        d1.update(d1_vs_one_shot(snap, one))
        d1.update(step_s=step_s, config={
            "band_groups": dcfg.band_groups, "stage2": dcfg.stage2,
            "bucket_slack": dcfg.bucket_slack,
            "edge_capacity": dcfg.edge_capacity,
            "lru_window": R1_WINDOW, "chunk_ends": list(D1_ENDS)},
            evicted_in_step=sum(in_step), sweeps_in_step=len(in_step),
            n_live_rows=v.n_live_rows, append_only_rows=n,
            device_buffer_rows=len(v._dev),
            device_buffer_bytes=v._dev.numel() * 4,
            one_shot_pairs_evaluated=len(one["pairs"]),
            cross_step_s=[x["cross_step_s"] for x in d1["steps"]],
            h1_ingest_s=ctx.pop("d_h1_ingest_s"))
        emit(phase_d1=d1)
        del sess, snap, one, v, sig_rows, want_sig

        # D2: r3_notes in 3 chunks.
        notes3 = r3_notes(notes, prov)
        size = len(notes3) // D2_CHUNKS
        check(size * D2_CHUNKS == len(notes3), "D2 chunks are equal")
        chunks = [notes3[i : i + size] for i in range(0, len(notes3), size)]

        # D3's two CLI runs (the card's, the CPU's), each over its own
        # sqlite file, and D4's CPU sessions go beside D2 and D4's card
        # sessions, which leave the card and most host cores idle; D1
        # runs alone.
        t_cli = time.perf_counter()
        for name, dev in (("card", device), ("cpu", "cpu")):
            procs[name] = subprocess.Popen(
                cli + ["--store-path", os.path.join(tmp.name, f"d3_{name}.db"),
                       "--device", dev],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        twin_in = os.path.join(tmp.name, "d4_chunks.json")
        twin_out = os.path.join(tmp.name, "d4_cpu.pkl")
        with open(twin_in, "w") as f:
            json.dump(chunks, f)
        procs["d4_cpu"] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path[:0] = [sys.argv[1]]; import chip_smoke; "
             "chip_smoke.d4_cpu_twins(sys.argv[2], sys.argv[3])",
             str(ROOT), twin_in, twin_out],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        host_cfg = dist_lsh.DistLSHConfig(fused_ingest=True, band_groups=5,
                                          edge_capacity=size * 10)
        runs, d2 = {}, {"notes": len(notes3), "chunks": D2_CHUNKS}
        cpu_mesh = dist_lsh.DocsMesh(group=None, rank=0, n_dev=1,
                                     device=torch.device("cpu"))
        nostem = [shingle.tokenize(t, do_stem=False) for t in notes3]
        nostem = [nostem[i : i + size] for i in range(0, len(notes3), size)]
        byte_cfg = DedupConfig(byte_ingest=True, exact_verification=False,
                               verify_backend="kernel", verify_batch="band")
        for name, c, dc, dev, mesh, inputs, tok in (
                ("host", cfg, host_cfg, device, None, chunks, False),
                ("host_cpu", cfg, host_cfg, "cpu", cpu_mesh, chunks, False),
                ("bytes", byte_cfg, dist_lsh.DistLSHConfig(
                    byte_ingest=True, band_groups=5,
                    edge_capacity=size * 10), device, None, chunks, False),
                ("nostem", cfg, host_cfg, device, None, nostem, True),
                ("device", cfg, dist_lsh.DistLSHConfig(
                    fused_ingest=True, band_groups=5, stage2="device",
                    edge_capacity=size * 10), device, None, chunks, False)):
            _, s2, summary = sharded_run(torch, c, dc, inputs, dev, counters,
                                         mesh=mesh, tokenized=tok)
            runs[name] = session_record(s2)
            launches[f"d2_{name}"] = summary["launches"]
            d2[name] = {k: summary[k] for k in (
                "ingest_s", "notes_per_s", "pairs_evaluated", "launches",
                *D_COUNTERS)}
        for field in runs["host_cpu"]:
            check(runs["host"][field] == runs["host_cpu"][field],
                  f"D2 {field}: card == CPU")
        for a, b in (("nostem", "bytes"), ("host", "device")):
            check(runs[a]["labels"] == runs[b]["labels"]
                  and runs[a]["pairs"] == runs[b]["pairs"],
                  f"D2: {b} labels and pairs == {a}'s")
        check(all(runs[r]["overflow"] == 0 for r in runs),
              "D2: nothing overflowed")
        check(runs["device"]["device_scored"] > 0
              and runs["device"]["host_rescored"] == 0,
              "D2 device: device-scored edges, no host re-score")
        for name, want in (("host", {"fused_ingest": D2_CHUNKS}),
                           ("bytes", {"byte_token_hashes": D2_CHUNKS,
                                      "fused_ingest": D2_CHUNKS}),
                           ("device", {"fused_ingest": D2_CHUNKS})):
            got = launches[f"d2_{name}"]
            check(all(got[k] == v for k, v in want.items())
                  and got["pair_counts"] > 0,
                  f"D2 {name}: K1 (K6) once a chunk, and K2")
        check(launches["d2_device"]["masked_indexed_pair_counts"]
              >= D2_CHUNKS * 5, "D2 device: K7 once a band group a chunk")
        d2["duplicates"] = runs["host"]["n_docs"] - len(
            set(runs["host"]["labels"]))
        emit(phase_d2=d2)
        del runs

        # D4: D2's notes and chunks under the small preset, refining every
        # 2 steps: the card's memory and sqlite sessions, then the CPU's
        # (run beside them) against the card's memory session.
        policy = RetentionPolicy.preset("small", refine_every=2)
        d4 = {"notes": len(notes3), "chunks": D2_CHUNKS,
              "lru_window": policy.lru_window,
              "band_key_budget": policy.band_key_budget,
              "refine_every": policy.refine_every}
        recs, views = {}, {}
        t_d4 = time.perf_counter()
        for stage2 in ("host", "device"):
            for name, path in (("card", None), ("sqlite", os.path.join(
                    tmp.name, f"d4_{stage2}.db"))):
                s4, rec, summary, refines = d4_run(
                    torch, stage2, chunks, device, counters, store_path=path)
                recs[stage2, name] = rec
                path_name = f"d4_{stage2}_{name}"
                launches[path_name] = got = summary["launches"]
                check(isinstance(s4.band_index, SqliteBandStore)
                      == (name == "sqlite"),
                      f"D4 {stage2} {name}: the cross-step index's tier")
                check(len(refines) == 1 and s4.refines_run == 1,
                      f"D4 {stage2} {name}: refined once")
                check(got["fused_ingest"] == D2_CHUNKS
                      and got["pair_counts"] > 0
                      and refines[0]["band_values"] == 1
                      and got["band_values"] == 1,
                      f"D4 {stage2} {name}: K1 once a chunk, K2, and K5 "
                      "once a refine")
                if stage2 == "device":
                    check(got["masked_indexed_pair_counts"]
                          >= D2_CHUNKS * 5,
                          f"D4 device {name}: K7 once a band group a chunk")
                    views[name] = s4.view()
                d4[path_name] = {**{k: summary[k] for k in (
                    "ingest_s", "notes_per_s", "pairs_evaluated",
                    "launches", "evicted", "retained_rows", "refine_merges",
                    "filter_only_hits", "band_index", *D_COUNTERS)},
                    "refines": refines}
                del s4
        d4["card_s"] = time.perf_counter() - t_d4
        t0 = time.perf_counter()
        proc = procs.pop("d4_cpu")
        _, err = proc.communicate(timeout=600)
        d4["waited_for_cpu_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"D4's CPU sessions exit 0: {err[-2000:]}")
        with open(twin_out, "rb") as f:
            twins = pickle.load(f)
        for stage2, (rec, summary, refines) in twins.items():
            recs[stage2, "cpu"] = rec
            d4[f"d4_{stage2}_cpu"] = {**{k: summary[k] for k in (
                "ingest_s", "evicted", "refine_merges", *D_COUNTERS)},
                "refines": refines}
        for stage2 in ("host", "device"):
            card = recs[stage2, "card"]
            for other in ("cpu", "sqlite"):
                for field in card:
                    check(recs[stage2, other][field] == card[field],
                          f"D4 {stage2} {field}: {other} == card memory")
            check(card["evicted"] > 0, f"D4 {stage2} evicted rows")
            check(card["overflow"] == card["row_overflow"] == 0,
                  f"D4 {stage2}: nothing overflowed")
            d4[f"{stage2}_evicted"] = card["evicted"]
            d4[f"{stage2}_compacted_keys"] = card["compacted_keys"]
        card = recs["device", "card"]
        check(card["device_scored"] > 0 and card["host_rescored"] == 0,
              "D4 device: device-scored edges, no host re-score")
        # 64 of H3's queries over the sqlite view against the memory view.
        queries = ctx.pop("d4_queries")
        pipe = DedupPipeline(replace(cfg, use_kernels=True), device=device)
        toks = pipe.tokenize(queries)
        q_sig, q_bands = pipe.compute_arrays(
            toks, pad_len=shingle.pow2_bucket(max(len(t) for t in toks)))
        answers = {}
        for name, view in views.items():
            t0 = time.perf_counter()
            answers[name] = query_view(view, q_bands, sig=q_sig,
                                       backend="kernel")
            d4[f"query_{name}_s"] = time.perf_counter() - t0
        check(views["sqlite"].band_store is not None
              and views["sqlite"].band_maps == ()
              and views["card"].band_store is None,
              "D4: the sqlite view probes the live store, the memory view "
              "its maps")
        check(answers["sqlite"] == answers["card"],
              "D4: query_view over the sqlite view == over the memory view")
        d4.update(queries=len(queries),
                  query_duplicates=sum(r.is_duplicate
                                       for r in answers["card"]),
                  query_filter_only_hits=sum(r.filter_only_hits
                                             for r in answers["card"]))
        emit(phase_d4=d4)
        del views, answers

        # D3: the CLI on the card, against its CPU twin.
        d4_end = time.perf_counter()
        reports, seconds = {}, {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            seconds[name] = time.perf_counter() - t_cli
            check(proc.returncode == 0,
                  f"sharded dedup CLI ({name}) exits 0: {err[-2000:]}")
            reports[name] = out.splitlines()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        tmp.cleanup()
    card, cpu = (cli_counts(reports[name]) for name in ("card", "cpu"))
    check(card is not None and card == cpu,
          f"sharded CLI: the card's report == the CPU's ({card}, {cpu})")
    check(card[-3] > 0, "sharded CLI: rows evicted")
    emit(phase_d3={"argv": cli[1:] + ["--store-path", "FILE", "--device",
                                      device],
                   "seconds_from_start": seconds,
                   "waited_after_d4_s": time.perf_counter() - d4_end,
                   "report": reports["card"], "cpu_report": reports["cpu"],
                   "counts": card})
    return launches


SHARDED_REPORT = re.compile(
    r"^sharded\[1 devices x \d+ band-group\(s\) x 4 step\(s\)\]: "
    r"(\d+) docs ingested, (\d+) clusters, (\d+) duplicates, (\d+) pairs "
    r"verified \((\d+) excluded\) in (\d+) batches .*, (\d+) overflow, "
    r"stage2=device (\d+) device-scored / (\d+) host-rescored / (\d+) "
    r"row-overflow, (\d+) rows retained \((\d+) evicted, (\d+) filter-only "
    r"hits, (\d+) refine merges\)")


def cli_counts(report: list[str]):
    """The counts of the sharded CLI's report line (docs, clusters,
    duplicates, pairs, excluded, batches, overflow, device-scored,
    host-rescored, row-overflow, rows retained, evicted, filter-only
    hits, refine merges), or None without one."""
    for line in report:
        m = SHARDED_REPORT.match(line)
        if m:
            return [int(x) for x in m.groups()]
    return None


def d1_vs_one_shot(snap, one: dict) -> dict:
    """D1 against phase S's one-shot step on the same notes.

    What holds at this size (checked on the CPU through the plain
    versions before any card run; PERF.md §6): the partition, so the keep
    mask, and the sim of every pair both evaluate.  The root ids need not:
    the session unions chunk by chunk, each chunk's step edges and then
    its cross-step edges (never prescreened, so it verifies far more
    pairs), and union by rank then names other roots than the one-shot
    step's single pass."""
    import numpy as np

    check(canonical(snap.labels) == canonical(one["labels"]),
          "D1 partition == phase S's one-shot partition")
    sims = {(a, b): s for a, b, s in one["pairs"]}
    shared = [(s, sims[(a, b)]) for a, b, s in snap.pairs if (a, b) in sims]
    check(len(shared) > 0 and all(x == y for x, y in shared),
          "D1: sims of the pairs both evaluate == phase S's")
    return {"labels_equal_as_ids": bool(np.array_equal(snap.labels,
                                                       one["labels"])),
            "shared_pairs": len(shared)}


# -- phase F: K8 against its plain version ----------------------------------------

# test_kernels.py's four float32 shapes (B, S, H, Hkv, Dh, window) and the
# prefills of three head widths, timed in float32 and in bf16: h2o-danube's
# long prompt (past its window), olmo's and gemma's.
K8_F32_SHAPES = [(2, 64, 8, 2, 16, None), (1, 100, 4, 4, 8, None),
                 (2, 96, 8, 2, 16, 24), (1, 37, 6, 2, 16, None)]
K8_PREFILL_SHAPES = {"h2o-danube-1.8b": (1, 6144, 32, 8, 80, 4096),
                     "olmo-1b": (1, 2048, 16, 16, 128, None),
                     "gemma-7b": (1, 1024, 16, 16, 256, None)}
BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores
FP32_LANES = 128            # FP32 FMA lanes per SM and clock


def unmasked_pairs(torch, Sq: int, Skv: int, causal: bool,
                   window: int | None) -> int:
    """(q, k) pairs per head that the causal and window masks leave."""
    q = torch.arange(Sq, dtype=torch.int64)
    hi = q.clamp(max=Skv - 1) if causal else torch.full_like(q, Skv - 1)
    lo = (q - window + 1).clamp(min=0) if window is not None else 0 * q
    return int((hi - lo + 1).clamp(min=0).sum())


def k8_bound(torch, shape, dtype, clock_hz: float) -> dict:
    """Least time for K8 (causal): q, k, v and the output each moved once,
    against 4 Dh flops per unmasked (q, k) pair and head at the card's peak
    for the dtype -- the tensor cores' dense bf16 rate, or for IEEE float32
    every FP32 lane doing an FMA each clock at the maximum SM clock."""
    B, S, H, Hkv, Dh, window = shape
    pairs = unmasked_pairs(torch, S, S, True, window)
    flops = 4 * Dh * pairs * H * B
    elt = 2 if dtype == torch.bfloat16 else 4
    nbytes = elt * B * S * (H * Dh * 2 + Hkv * Dh * 2)
    peak = (BF16_TENSOR_FLOPS if dtype == torch.bfloat16
            else SMS * FP32_LANES * 2 * clock_hz)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes, "flops": flops,
            "bytes": nbytes, "unmasked_pairs_per_head": pairs}


def sdpa_call(torch, q, k, v, window: int | None):
    """``scaled_dot_product_attention`` on the same inputs, as a yardstick:
    (B, H, S, D) views, GQA, and a boolean causal-and-window mask."""
    import torch.nn.functional as F

    pos = torch.arange(q.shape[1], device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def sdpa_backends(torch, call) -> list[str]:
    """The SDPA backends that accept this call, in PyTorch's order of
    preference: the default call runs on the first."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    accepted = []
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        # A backend that refuses the call warns why, then raises.
        with sdpa_kernel(getattr(SDPBackend, name)), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            try:
                call()
            except RuntimeError:  # a probe: this backend refuses the call
                continue
        accepted.append(name)
    torch.cuda.synchronize()
    return accepted


# K8's sources, and the targets of its bf16 redesign at the three prefill
# shapes (ms): at most SDPA's time and 10x the bound at h2o-danube's.
K8_SOURCES = ("flash_attention.cu", "flash_attention_f32.cu")
K8_TARGET_MS = {"h2o-danube-1.8b": 1.74, "olmo-1b": 0.59, "gemma-7b": 0.48}


def k8_ptxas(log: str) -> list[dict]:
    """ptxas's report for each K8 kernel instantiation: registers, static
    shared memory, spill bytes."""
    out = []
    for name, rep in ptxas_entries(log).items():
        m = re.search(r"flash_attention_(bf16|f32)_kernelILi(\d+)E", name)
        if m:
            out.append({"kernel": m.group(1), "tier": int(m.group(2)), **rep})
    return out


def k8_sass(lib_path) -> dict:
    """HMMA (tensor-core) instruction counts of each K8 instantiation in
    the built library's SASS, and how many of them take TF32; beside them
    the listing's static mix: instructions, FFMA and shared-memory loads."""
    out = {}
    for fname, f in sass_functions(lib_path).items():
        name = re.search(r"flash_attention_(bf16|f32)_kernelILi(\d+)E", fname)
        if name:
            ops = re.findall(r"\bHMMA(\.[A-Z0-9_.]*)?", f)
            mix = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?"
                             r"([A-Z][A-Z0-9_]*)", f)
            out[f"{name.group(1)}_{name.group(2)}"] = {
                "hmma": len(ops), "tf32_hmma": sum("TF32" in o for o in ops),
                "instructions": len(mix), "ffma": mix.count("FFMA"),
                "lds": mix.count("LDS")}
    return out


def nvcc_seconds(log: str) -> dict:
    """Each source's compile time, from the build log's ``== name (t s)``
    lines (one nvcc a source, all started together)."""
    return {name: float(t) for name, t in
            re.findall(r"^== (\S+) \(([\d.]+) s\)$", log, re.M)}


def bf16_bound(want, vbar):
    """How far K8 may lie from its plain version in bf16, element by element.

    Both round p = exp(s - m) to bf16 (relative error <= 2**-9) against the
    running max m of the moment, which depends on the order of the tiles,
    so their sums differ by at most 2**-8 of sum_j p_j |v_j| / l = ``vbar``
    (the plain version run on |v|); both round the output to bf16, at most
    one unit in the last place of ``want`` (<= 2**-7 |want|) apart; 1e-5
    takes the float32 sums in another order."""
    return 2**-7 * want.abs() + 2**-8 * vbar + 1e-5


def k8_inputs(torch, g, B, S, H, Hkv, Dh, dtype):
    """Unit-normal q (B, S, H, Dh), k and v (B, S, Hkv, Dh) on the card,
    drawn from the generator ``g``."""
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, S, H, Dh), (B, S, Hkv, Dh),
                               (B, S, Hkv, Dh)))


def k8_f32_cases(torch, k8, g, clock_hz: float):
    """K8 float32 (the module ``k8``) at the tests' four shapes, then the
    three prefill shapes, on ``k8_inputs`` from ``g``: each held to its
    ``flash_attention_plain`` to 3e-5 and timed by CUDA events (5
    launches) with its bound; at h2o-danube's also nvidia-smi's SM clock
    under its load, the clock the operations bound assumes.  Yields
    (row, q, k, v, plain output) a shape.  Phase F and
    ``tools/time_k8_f32.py`` both run it, so between them only ``k8``
    differs."""
    for arch, shape in ([(None, s) for s in K8_F32_SHAPES]
                        + list(K8_PREFILL_SHAPES.items())):
        q, k, v = k8_inputs(torch, g, *shape[:5], torch.float32)
        window = shape[5]
        got = k8.flash_attention(q, k, v, window=window)
        want = k8.flash_attention_plain(q, k, v, window=window)
        check(torch.allclose(got, want, atol=3e-5, rtol=0),
              f"K8 float32 == plain to 3e-5 at {shape}")
        r = {"arch": arch, "shape": shape,
             "max_abs_err": float((got - want).abs().max()),
             "ms": cuda_ms(torch, lambda: k8.flash_attention(
                 q, k, v, window=window), 5),
             **k8_bound(torch, shape, torch.float32, clock_hz)}
        r["ms_over_bound"] = r["ms"] / r["bound_ms"]
        if arch == M_ARCH:
            r["clocks_under_load"] = clocks_under_load(
                torch, lambda: k8.flash_attention(q, k, v, window=window),
                200)
        del got
        yield r, q, k, v, want


def phase_f(torch, clock_hz: float, lib_path, log: str) -> dict:
    """K8 against ``flash_attention_plain`` on the card: float32 to 3e-5
    at the tests' four shapes and the three prefill shapes, each timed
    beside its plain version and SDPA in float32 with its bound;
    bf16 to ``bf16_bound`` on unit-normal inputs, and to the coarser
    atol = rtol = 2e-2.  A mask off by one key (window + 1; every query
    one position later) must exceed the bound.  Timed beside its plain
    version and SDPA at the prefill shapes, with the ratio to
    ``K8_TARGET_MS`` and to SDPA reported.  First the build: every bf16
    instantiation holds HMMA instructions, the float32 kernel holds no
    HMMA (so no TF32), and no instantiation spills."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k8
    from repro_torch.models.attention import blockwise_attention

    ptxas = k8_ptxas(log)
    sass = k8_sass(lib_path)
    tiers = {}
    for kind in ("bf16", "f32"):  # the tiers themselves are the tests' to pin
        tiers[kind] = sorted(r["tier"] for r in ptxas if r["kernel"] == kind)
        in_sass = sorted(int(n.split("_")[1]) for n in sass
                         if n.startswith(kind))
        check(bool(tiers[kind]) and tiers[kind] == in_sass,
              f"K8 {kind}: the same instantiations in ptxas's log "
              f"{tiers[kind]} and in SASS {in_sass}")
    check(all(sass[f"bf16_{t}"]["hmma"] > 0 for t in tiers["bf16"]),
          f"K8 bf16: HMMA in every instantiation ({sass})")
    check(all(sass[f"f32_{t}"]["hmma"] == 0 for t in tiers["f32"]),
          f"K8 float32: no HMMA, so no TF32 ({sass})")
    check(all(r["spill_stores"] == r["spill_loads"] == 0 for r in ptxas),
          f"K8 bf16 and float32: no spills ({ptxas})")
    nvcc_s = nvcc_seconds(log)
    smem = build.library().flash_attention_f32_smem_bytes
    emit(k8_build={"ptxas": ptxas, "sass": sass, "nvcc_s": {
        name: nvcc_s.get(name) for name in K8_SOURCES},
        "f32_dynamic_smem_bytes": {t: smem(t) for t in tiers["f32"]}})

    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    f32 = []
    # The float32 kernel at the tests' shapes, then at the three prefill
    # shapes (h2o-danube's 6,144 tokens is phase M's float32 gate), each
    # timed beside its plain version and SDPA in float32 (IEEE products:
    # no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    for r, q, k, v, want in k8_f32_cases(torch, k8, g, clock_hz):
        window = r["shape"][5]
        call = sdpa_call(torch, q, k, v, window)
        lib = call().transpose(1, 2)
        r.update(
            plain_ms=cuda_ms(torch, lambda: k8.flash_attention_plain(
                q, k, v, window=window), 2),
            library_ms=cuda_ms(torch, call, 5),
            library_backends=sdpa_backends(torch, call),
            library_max_abs_err=float((lib - want).abs().max()))
        r["ms_over_library"] = r["ms"] / r["library_ms"]
        f32.append(r)
        del q, k, v, want, lib, call
    bf16 = {}
    for arch, shape in K8_PREFILL_SHAPES.items():
        q, k, v = k8_inputs(torch, g, *shape[:5], torch.bfloat16)
        window = shape[5]
        got = k8.flash_attention(q, k, v, window=window).float()
        want = k8.flash_attention_plain(q, k, v, window=window).float()
        tol = bf16_bound(want, k8.flash_attention_plain(
            q, k, v.abs(), window=window).float())

        def over(x):  # the largest error in units of the bound
            return float(((x.float() - want).abs() / tol).max())

        check(over(got) <= 1.0 and torch.allclose(got, want, atol=2e-2,
                                                  rtol=2e-2),
              f"K8 bf16 == plain to bf16_bound and 2e-2 at {arch}'s {shape}")
        mutants = {"query_one_later": over(blockwise_attention(
            q, k, v, window=window, q_offset=1))}
        if window is not None:
            mutants["window_plus_1"] = over(k8.flash_attention_plain(
                q, k, v, window=window + 1))
        check(min(mutants.values()) > 1.0,
              f"a mask one key off exceeds bf16_bound at {arch} ({mutants})")
        call = sdpa_call(torch, q, k, v, window)
        lib = call().transpose(1, 2).float()
        bf16[arch] = {
            "shape": shape, "max_abs_err": float((got - want).abs().max()),
            "median_abs_want": float(want.abs().median()),
            "median_bound": float(tol.median()),
            "max_err_over_bound": over(got),
            "mutants_max_err_over_bound": mutants,
            "ms": cuda_ms(torch, lambda: k8.flash_attention(
                q, k, v, window=window), 5),
            "plain_ms": cuda_ms(torch, lambda: k8.flash_attention_plain(
                q, k, v, window=window), 2),
            "library_ms": cuda_ms(torch, call, 5),
            "library_backends": sdpa_backends(torch, call),
            "library_max_abs_err": float((lib - want).abs().max()),
            **k8_bound(torch, shape, torch.bfloat16, clock_hz)}
        r = bf16[arch]
        r.update(target_ms=K8_TARGET_MS[arch],
                 ms_over_target=r["ms"] / K8_TARGET_MS[arch],
                 ms_over_library=r["ms"] / r["library_ms"],
                 ms_over_bound=r["ms"] / r["bound_ms"])
        del q, k, v, got, want, tol, lib, call
    out = {"float32": f32, "bf16": bf16,
           "card": smi_query("name,power.limit")}
    emit(phase_f=out)
    return out


# -- phase M: serving h2o-danube-1.8b at full width -------------------------------

M_ARCH = "h2o-danube-1.8b"
M_LONG_PROMPT = 6144            # past the 4,096-token window
M_ENGINE_REQUESTS = 8
M_GATE_LAYERS = 2               # depth of the end-to-end float32 gate


@contextlib.contextmanager
def float64_throughout(torch):
    """While open, RMSNorm, RoPE and the plain attention of the model stack
    compute in float64.  The port, as the reference, computes them in
    float32 whatever its inputs; these stand-ins keep the input's dtype,
    so a float64 model runs in float64 from embedding to logits."""
    from repro_torch.models import blocks, layers

    def rmsnorm(x, weight=None, eps=1e-6):
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return x if weight is None else x * (1.0 + weight)

    def apply_rope(x, positions, theta=10_000.0):
        half = x.shape[-1] // 2
        freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                             device=x.device) / half)
        ang = positions[..., None].double() * freqs
        if x.dim() == ang.dim() + 1:
            ang = ang[..., None, :]
        x1, x2 = torch.chunk(x, 2, dim=-1)
        cos, sin = torch.cos(ang), torch.sin(ang)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(q, k, v, *, causal=True, window=None):
        check(q.dtype == k.dtype == v.dtype == torch.float64,
              "float64 attention gets float64 q, k, v")
        S, Dh = q.shape[1], q.shape[3]
        g = q.shape[2] // k.shape[2]
        kt = k.repeat_interleave(g, dim=2).transpose(1, 2)  # (B, H, S, Dh)
        vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
        pos = torch.arange(S, device=q.device)
        out = []
        for q0 in range(0, S, 1024):  # 1,024 query rows at a time
            qpos = pos[q0:q0 + 1024, None]
            seen = pos[None, :] <= qpos if causal else pos[None, :] >= 0
            if window is not None:
                seen = seen & (pos[None, :] > qpos - window)
            s = q[:, q0:q0 + 1024].transpose(1, 2) @ kt.transpose(2, 3)
            w = (s * Dh**-0.5).masked_fill(~seen, float("-inf")).softmax(-1)
            out.append((w @ vt).transpose(1, 2))
        return torch.cat(out, dim=1)

    saved = layers.rmsnorm, blocks.apply_rope, blocks.blockwise_attention
    layers.rmsnorm, blocks.apply_rope, blocks.blockwise_attention = (
        rmsnorm, apply_rope, attention)
    try:
        yield
    finally:
        layers.rmsnorm, blocks.apply_rope, blocks.blockwise_attention = saved


def phase_m(torch, k8_shapes: dict) -> dict:
    """The serving slice at h2o-danube-1.8b's full width.  Float32, on a
    6,144-token prefill: in each of the 24 layers K8's output agrees with
    ``blockwise_attention``'s on the same q, k, v to 1e-3 of its largest
    magnitude, and at ``M_GATE_LAYERS`` layers so do the last-position
    logits of the two paths.
    bf16: ``serve_batch`` (B 4 x 512 + 32 tokens; B 1 x 6,144 + 8 tokens)
    and ``ServeEngine`` (8 requests, 4 slots), K8 launching once per layer
    per prefill.  Returns K8's line for the kernels table."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k8
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import blocks, lm
    from repro_torch.models.attention import blockwise_attention
    from repro_torch.serving import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False  # IEEE float32 products
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(M_ARCH)
    n_layers, vocab = base.n_layers, base.vocab_size
    rng = np.random.RandomState(17)
    long_prompt = rng.randint(2, vocab, size=(1, M_LONG_PROMPT)).astype(np.int32)
    out = {"arch": M_ARCH}

    def gen():
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        return g

    def last_logits(cfg, model, flash: bool):
        tokens = torch.as_tensor(long_prompt, device="cuda")
        with torch.inference_mode():
            _, logits = lm.prefill(cfg.with_(use_flash_attention=flash),
                                   model, tokens, None)
        return logits.float()

    # Correctness at full width in float32.  At the reference's init the
    # 24-layer stack amplifies float32 rounding until two correct paths
    # disagree in full (the float64 run below shows it), so the gates
    # are per layer on the same inputs, and end to end at a cut depth.
    cfg32 = base.with_(param_dtype="float32", compute_dtype="float32")
    model = lm.init(cfg32, gen(), device="cuda")
    layer_rel = []

    def k8_beside_plain(q, k, v, *, causal, window):
        got = k8.flash_attention(q, k, v, causal=causal, window=window)
        want = blockwise_attention(q, k, v, causal=causal, window=window)
        layer_rel.append(float((got - want).abs().max() / want.abs().max()))
        return got

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    blocks.flash_attention = k8_beside_plain
    try:
        k8.launches = 0
        flash = last_logits(cfg32, model, True)
    finally:
        blocks.flash_attention = k8.flash_attention
    check(k8.launches == n_layers, "float32 prefill: K8 once per layer")
    check(bool(torch.isfinite(flash).all()) and flash.shape == (1, 1, vocab),
          "float32 logits finite, (1, 1, V)")
    check(max(layer_rel) <= 1e-3,
          f"float32 full width: K8 == plain attention to 1e-3 in every "
          f"layer ({max(layer_rel)})")
    plain = last_logits(cfg32, model, False)
    layers = model.layers
    model.layers = layers[:M_GATE_LAYERS]
    cut = rel(last_logits(cfg32, model, True), last_logits(cfg32, model, False))
    model.layers = layers
    check(cut <= 1e-3, f"float32 full width, {M_GATE_LAYERS} layers: K8 "
          f"logits == plain to 1e-3 ({cut})")
    out["float32"] = {
        "params": sum(p.numel() for p in model.parameters()),
        "attention_rel_diff_per_layer": layer_rel,
        f"rel_logits_diff_{M_GATE_LAYERS}_layers": cut,
        f"rel_logits_diff_{n_layers}_layers": rel(flash, plain),
        "max_abs_logit": float(plain.abs().max()),
        "greedy_k8": serve_batch(cfg32.with_(use_flash_attention=True), model,
                                 long_prompt, 8)[0][0].tolist(),
        "greedy_plain": serve_batch(cfg32, model, long_prompt, 8)[0][0].tolist()}
    # The float32 kernel's launches on this slice: every layer of the
    # gated prefill, the cut depth and the greedy run's prefill.
    out["float32"]["k8_launches"] = f32_launches = k8.launches
    # The same weights in float64, norms, RoPE and attention included:
    # how far float32 rounding alone moves the logits.
    model.double()
    with float64_throughout(torch):
        wide = last_logits(base.with_(param_dtype="float64",
                                      compute_dtype="float64"), model, False)
    out["float32"]["rel_logits_diff_vs_float64"] = {
        "k8": rel(flash, wide), "plain": rel(plain, wide)}
    del model, layers, flash, plain, wide
    torch.cuda.empty_cache()

    # The slice in bf16, through K8.
    cfg = base.with_(use_flash_attention=True)
    model = lm.init(cfg, gen(), device="cuda")
    serve_batch(cfg, model, long_prompt[:, :64], 2)  # warm-up, untimed
    runs, launches = {}, 0
    for name, prompts, new in (
            ("b4_p512_n32", rng.randint(2, vocab, size=(4, 512)), 32),
            ("b1_p6144_n8", long_prompt, 8)):
        torch.cuda.reset_peak_memory_stats()
        k8.launches = 0
        toks, stats = serve_batch(cfg, model, prompts.astype(np.int32), new)
        check(k8.launches == n_layers, f"{name}: K8 launched once per layer")
        check(toks.shape == (prompts.shape[0], new)
              and bool(((toks >= 0) & (toks < vocab)).all()),
              f"{name}: tokens in the vocabulary")
        launches += k8.launches
        runs[name] = {**stats, "k8_launches": k8.launches,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "tokens": toks[0].tolist()}
    # K8 timed inside one more long prefill: CUDA events around each of its
    # 24 launches, against that prefill's host-timed span.
    spans = []

    def k8_timed(q, k, v, *, causal, window):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        got = k8.flash_attention(q, k, v, causal=causal, window=window)
        end.record()
        spans.append((start, end))
        return got

    blocks.flash_attention = k8_timed
    try:
        _, stats = serve_batch(cfg, model, long_prompt, 1)
    finally:
        blocks.flash_attention = k8.flash_attention
    torch.cuda.synchronize()
    k8_ms = [start.elapsed_time(end) for start, end in spans]
    check(len(k8_ms) == n_layers, "timed prefill: K8 once per layer")
    runs["b1_p6144_n8"]["k8_in_prefill"] = {
        "ms": k8_ms, "sum_ms": sum(k8_ms), "prefill_s": stats["prefill_s"],
        "share": sum(k8_ms) / 1e3 / stats["prefill_s"]}
    flash_bf = last_logits(cfg, model, True)
    plain_bf = last_logits(cfg, model, False)
    check(bool(torch.isfinite(flash_bf).all()), "bf16 logits finite")
    out["bf16"] = {"runs": runs, "rel_logits_diff_vs_plain": float(
        (flash_bf - plain_bf).abs().max() / plain_bf.abs().max())}

    # ServeEngine: 8 seeded requests of 64 to 1,024 tokens over 4 slots.
    eng = ServeEngine(cfg, model, slots=4, cache_len=1280, eos_id=-1)
    for n in rng.randint(64, 1025, size=M_ENGINE_REQUESTS):
        eng.submit(rng.randint(2, vocab, size=n).astype(np.int32),
                   max_tokens=16)
    k8.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(len(done) == M_ENGINE_REQUESTS
          and all(len(r.out) == 16 for r in done),
          "ServeEngine: every request finished with 16 tokens")
    check(k8.launches == n_layers * eng.stats.prefills,
          "ServeEngine: K8 once per layer per admission")
    launches += k8.launches
    out["engine"] = {"requests": len(done), "tokens_out": eng.stats.tokens_out,
                     "steps": eng.stats.steps, "prefills": eng.stats.prefills,
                     "mean_occupancy": eng.stats.mean_occupancy,
                     "wall_s": wall_s,
                     "tok_per_s": eng.stats.tokens_out / wall_s,
                     "k8_launches": k8.launches}
    del model, eng
    torch.cuda.empty_cache()
    emit(phase_m=out)

    main_shape = k8_shapes["bf16"][M_ARCH]
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_err_over_bound")
    keep32 = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
              "library_backends", "bound_ms", "bound_by", "ms_over_bound")
    f32 = {r["arch"]: {k: r[k] for k in keep32}
           for r in k8_shapes["float32"] if r["arch"]}
    f32_tests = [{k: r[k] for k in keep32}
                 for r in k8_shapes["float32"] if not r["arch"]]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "float32_source": "src/repro_torch/kernels/csrc/flash_attention_f32.cu",
            "replaces": "src/repro/kernels/flash_attention.py:35",
            "launches": launches, "match": True,
            **{k: main_shape[k] for k in keep},
            "library_backends": main_shape["library_backends"],
            "other_shapes": {a: {k: r[k] for k in keep}
                             for a, r in k8_shapes["bf16"].items()
                             if a != M_ARCH},
            "float32": {**f32[M_ARCH], "launches": f32_launches,
                        "other_shapes": {a: r for a, r in f32.items()
                                         if a != M_ARCH},
                        "test_shapes": f32_tests}}


# -- phase B: paper-scale kernels -------------------------------------------------

def phase_b(torch, clock_hz: float, k1_sass: dict) -> dict:
    import numpy as np

    from repro_torch.core.hashing import to_bits, u32_from_numpy
    from repro_torch.core.minhash import default_seeds
    from repro_torch.core.verify import SignatureVerifier
    from repro_torch.kernels import fused_ingest as k1
    from repro_torch.kernels import sigjaccard as k2

    D, L, M, n, r, P = (PHASE_B_DOCS, PHASE_B_LEN, 100, 8, 2, PHASE_B_PAIRS)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    tokens = to_bits(torch.randint(0, 2**32, (D, L), generator=g,
                                   device="cuda", dtype=torch.int64))
    lengths = torch.randint(0, L + 1, (D,), generator=g, device="cuda",
                            dtype=torch.int32)
    lengths[:8] = torch.arange(8, dtype=torch.int32)  # empty and 1-7 tokens
    lengths[8:16] = L
    seeds = u32_from_numpy(default_seeds(M), "cuda")
    torch.cuda.reset_peak_memory_stats()

    sig, bands, valid = k1.fused_ingest(tokens, lengths, seeds, n=n, r=r)
    k1_ms = cuda_ms(torch, lambda: k1.fused_ingest(tokens, lengths, seeds,
                                                   n=n, r=r), 5)
    rows, timer, k1_err = 8192, ChunkTimer(torch), 0
    for s in range(0, D, rows):
        with timer:
            ps, pb, pv = k1.fused_ingest_plain(
                tokens[s : s + rows], lengths[s : s + rows], seeds, n=n, r=r)
        k1_err = max(k1_err, max_abs_err(sig[s : s + rows], ps),
                     max_abs_err(bands[s : s + rows], pb),
                     int((valid[s : s + rows] != pv).sum()))
    k1_plain_ms = timer.ms()
    check(k1_err == 0, "paper-scale K1 kernel == plain")

    a = torch.randint(0, D, (P,), generator=g, device="cuda")
    b = torch.randint(0, D, (P,), generator=g, device="cuda")
    b[: P // 16] = a[: P // 16]  # identical rows: count M
    sims = SignatureVerifier(sig, backend="kernel", batch_pairs=P,
                             device="cuda")(torch.stack([a, b], 1).cpu().numpy())
    k2_ms = cuda_ms(torch, lambda: k2.pair_counts(sig, a, b), 5)
    rows, timer, k2_err = 1 << 20, ChunkTimer(torch), 0
    for s in range(0, P, rows):
        with timer:
            pc = k2.pair_counts_plain(sig, a[s : s + rows], b[s : s + rows])
        want = pc.cpu().numpy().astype(np.float32) / np.float32(M)
        got = sims[s : s + rows]
        check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              "paper-scale K2 through SignatureVerifier == plain counts / M")
        k2_err = max(k2_err, float(np.max(np.abs(got - want))))
    k2_plain_ms = timer.ms()
    check(bool(np.all(sims[: P // 16] == 1.0)), "a == b pairs have sim 1")

    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    k1_b = k1_bound(torch, lengths, L, M, n, r, clock_hz)
    # The issue time of the emitted min loop alone, at the maximum clock:
    # how far the compiled code, not the work, keeps K1 from its bound.
    loop_ms = (k1_sass["cycles_per_triple"] * k1_b["triples"]
               / (SMS * clock_hz) * 1e3)
    k1_out = {"shape": {"D": D, "L": L, "M": M}, "ms": k1_ms,
              "lane_map": k1.schedule(M, L),
              "plain_ms": k1_plain_ms, "max_abs_err": k1_err, **k1_b,
              "emitted_loop_ms": loop_ms,
              "clocks_under_load": clocks_under_load(
                  torch, lambda: k1.fused_ingest(tokens, lengths, seeds,
                                                 n=n, r=r), 300)}
    k2_out = {"shape": {"D": D, "M": M, "P": P}, "ms": k2_ms,
              "plain_ms": k2_plain_ms, "max_abs_err": k2_err,
              **pair_path(k2, M, sig, sig), **k2_bound(D, M, P, clock_hz)}
    k2_out.update(gathered(k2_out["gathered_bytes"], k2_ms))
    out = {"fused_ingest": k1_out, "pair_counts": k2_out,
           "pair_estimate": phase_b_pair_estimate(torch, clock_hz, sig, a, b,
                                                  sims)}
    out.update(phase_b_staged(torch, clock_hz, tokens, lengths, seeds, sig,
                              bands, valid, n, r))
    out["masked_indexed_pair_counts"] = phase_b_k7(torch, clock_hz, g, sig,
                                                   a, b)
    del bands, valid, a, b
    out["masked_indexed_pair_counts"]["sharded_step"] = phase_s2(
        torch, clock_hz, g, tokens, lengths, seeds, sig)
    del tokens, lengths, sig
    torch.cuda.empty_cache()
    out["byte_token_hashes"] = phase_b_bytes(torch, clock_hz, g, seeds, n, r)
    emit(phase_b={"fused_ingest": k1_out, "pair_counts": k2_out,
                  "peak_gib": peak_gib})
    return out


def phase_b_staged(torch, clock_hz, tokens, lengths, seeds, sig, bands, valid,
                   n: int, r: int) -> dict:
    """K3 -> K4 -> K5 on phase B's token matrix, each against its plain
    version on the same inputs; K3's validity, K4's signatures and K5's
    bands are K1's.  K4 also runs under a mask that is not a prefix
    (every other valid position cleared), against its plain version."""
    from repro_torch.kernels import bandfold as k5
    from repro_torch.kernels import minhash as k4
    from repro_torch.kernels import ngram as k3

    D, L = tokens.shape
    M = seeds.shape[0]
    ng, valid3 = k3.ngram_hashes(tokens, lengths, n=n)
    sig4 = k4.minhash_signatures(ng, valid3, seeds)
    bands5 = k5.band_values(sig4, r)
    check(torch.equal(valid3, valid) and torch.equal(sig4, sig)
          and torch.equal(bands5, bands),
          "paper-scale K3 -> K4 -> K5 == K1's validity, signatures, bands")
    odd = torch.arange(L, device=valid3.device) % 2 == 1
    sparse = valid3 & ~odd  # each row's odd positions cleared
    sig_sparse = k4.minhash_signatures(ng, sparse, seeds)
    ms = {"k3": cuda_ms(torch, lambda: k3.ngram_hashes(tokens, lengths, n=n), 5),
          "k4": cuda_ms(torch, lambda: k4.minhash_signatures(ng, valid3, seeds),
                        5),
          "k4_sparse": cuda_ms(
              torch, lambda: k4.minhash_signatures(ng, sparse, seeds), 5),
          "k5": cuda_ms(torch, lambda: k5.band_values(sig4, r), 5)}
    timers = {k: ChunkTimer(torch) for k in ("k3", "k4", "k4_sparse", "k5")}
    err = {k: 0 for k in timers}
    rows = 8192
    for s in range(0, D, rows):
        sl = slice(s, s + rows)
        with timers["k3"]:
            png, pvalid = k3.ngram_hashes_plain(tokens[sl], lengths[sl], n=n)
        with timers["k4"]:
            psig = k4.minhash_signatures_plain(ng[sl], valid3[sl], seeds)
        with timers["k4_sparse"]:
            psparse = k4.minhash_signatures_plain(ng[sl], sparse[sl], seeds)
        with timers["k5"]:
            pbands = k5.band_values_plain(sig4[sl], r)
        err["k3"] = max(err["k3"], max_abs_err(ng[sl], png),
                        int((valid3[sl] != pvalid).sum()))
        err["k4"] = max(err["k4"], max_abs_err(sig4[sl], psig))
        err["k4_sparse"] = max(err["k4_sparse"],
                               max_abs_err(sig_sparse[sl], psparse))
        err["k5"] = max(err["k5"], max_abs_err(bands5[sl], pbands))
    check(all(e == 0 for e in err.values()),
          f"paper-scale K3, K4 (prefix and sparse masks), K5 kernels == plain "
          f"({err})")
    out = {
        "ngram_hashes": {"shape": {"D": D, "L": L, "n": n}, "ms": ms["k3"],
                         "with_validity": True,
                         "path": k3.schedule(tokens, ng, valid3),
                         **k3_bound(D, L, n, clock_hz)},
        "minhash_signatures": {"shape": {"D": D, "L": L, "M": M},
                               "ms": ms["k4"], "schedule": k4.schedule(M, L),
                               "path": k4.path(ng, valid3),
                               **k4_bound(valid3, M, clock_hz)},
        "band_values": {"shape": {"D": D, "M": M, "r": r}, "ms": ms["k5"],
                        **k5_bound(D, M, r, clock_hz)},
    }
    for name, key in (("ngram_hashes", "k3"), ("minhash_signatures", "k4"),
                      ("band_values", "k5")):
        out[name].update(plain_ms=timers[key].ms(), max_abs_err=err[key])
    out["minhash_signatures"]["sparse_mask"] = {
        "mask": "K1's validity with each row's odd positions cleared",
        "ms": ms["k4_sparse"], "plain_ms": timers["k4_sparse"].ms(),
        "max_abs_err": err["k4_sparse"], **k4_bound(sparse, M, clock_hz)}
    emit(phase_b_staged=out)
    return out


def phase_b_pair_estimate(torch, clock_hz, sig, a, b, sims) -> dict:
    """``kernels.ops.pair_estimate`` (K7's pre-gathered counts, every lane
    valid, / M) on the rows of phase B's first 4,194,304 K2 pairs: equal
    bit for bit to its plain version and to K2's estimates of those pairs
    through ``SignatureVerifier``."""
    import numpy as np

    from repro_torch.core.minhash import estimate_from_counts
    from repro_torch.kernels import ops
    from repro_torch.kernels import sigjaccard as k7

    Q, M = 1 << 22, sig.shape[1]
    rows_a, rows_b = sig[a[:Q]], sig[b[:Q]]
    every = torch.ones(Q, dtype=torch.bool, device="cuda")

    def plain():
        return estimate_from_counts(
            k7.masked_pair_counts_plain(rows_a, rows_b, every), M)

    before = k7.masked_launches
    got = ops.pair_estimate(rows_a, rows_b)
    launches = k7.masked_launches - before
    check(launches == 1, "pair_estimate launched K7 once")
    want = plain()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), "pair_estimate == its plain version")
    check(np.array_equal(got.cpu().numpy().view(np.uint32),
                         sims[:Q].view(np.uint32)),
          "pair_estimate == K2's estimates through SignatureVerifier")
    out = {"shape": {"P": Q, "M": M}, "launches": launches,
           "ms": cuda_ms(torch, lambda: ops.pair_estimate(rows_a, rows_b), 5),
           "plain_ms": cuda_ms(torch, plain, 2), "max_abs_err": err,
           **pair_path(k7, M, rows_a, rows_b),
           **k7_bound(torch, every, M, clock_hz)}
    out.update(gathered(out["gathered_bytes"], out["ms"]))
    emit(phase_b_pair_estimate=out)
    return out


def phase_b_k7(torch, clock_hz, g, sig, a, b) -> dict:
    """K7 alone at paper scale, each form against its plain version.

    Indexed: phase B's K2 pairs as int32, half of them valid, 1/16 with
    a == b (K2's), 1/64 with an index outside [0, D).  Pre-gathered: the
    rows of the first 4,194,304 of those pairs."""
    from repro_torch.kernels import sigjaccard as k7

    D, M = sig.shape
    P = a.shape[0]
    ai, bi = a.to(torch.int32), b.to(torch.int32)
    out_of_range = torch.rand(P, generator=g, device="cuda") < 1 / 64
    ai = torch.where(out_of_range & (torch.arange(P, device="cuda") % 2 == 0),
                     ai - D, ai)
    bi = torch.where(out_of_range & (torch.arange(P, device="cuda") % 2 == 1),
                     bi + D, bi)
    valid = torch.rand(P, generator=g, device="cuda") < 0.5
    got = k7.masked_indexed_pair_counts(sig, ai, bi, valid)
    ms = cuda_ms(torch, lambda: k7.masked_indexed_pair_counts(sig, ai, bi,
                                                              valid), 5)
    rows, timer, err = 1 << 20, ChunkTimer(torch), 0
    for s in range(0, P, rows):
        sl = slice(s, s + rows)
        with timer:
            want = k7.masked_indexed_pair_counts_plain(sig, ai[sl], bi[sl],
                                                       valid[sl])
        err = max(err, int((got[sl] - want).abs().max()))
    check(err == 0, "paper-scale K7 (indexed) == plain")
    check(bool((got[~valid] == 0).all()), "K7 counts 0 where not valid")
    same = valid[: P // 16] & (ai[: P // 16] == bi[: P // 16])
    check(bool((got[: P // 16][same] == M).all()), "K7 a == b pairs count M")

    Q = 1 << 22
    rows_a = sig[ai[:Q].to(torch.int64).clamp(0, D - 1)]
    rows_b = sig[bi[:Q].to(torch.int64).clamp(0, D - 1)]
    vq = valid[:Q]
    got_rows = k7.masked_pair_counts(rows_a, rows_b, vq)
    rows_ms = cuda_ms(torch, lambda: k7.masked_pair_counts(rows_a, rows_b, vq),
                      5)
    rows_plain_ms = cuda_ms(
        torch, lambda: k7.masked_pair_counts_plain(rows_a, rows_b, vq), 2)
    rows_err = int((got_rows - k7.masked_pair_counts_plain(
        rows_a, rows_b, vq)).abs().max())
    check(rows_err == 0, "paper-scale K7 (pre-gathered) == plain")
    check(torch.equal(got_rows, got[:Q]),
          "K7 pre-gathered == indexed on the same pairs")
    out = {"shape": {"D": D, "M": M, "P": P}, "ms": ms,
           "plain_ms": timer.ms(), "max_abs_err": err,
           **pair_path(k7, M, sig, sig),
           **k7_bound(torch, valid, M, clock_hz, ai, bi, D),
           "pre_gathered": {"shape": {"P": Q, "M": M}, "ms": rows_ms,
                            "plain_ms": rows_plain_ms, "max_abs_err": rows_err,
                            **pair_path(k7, M, rows_a, rows_b),
                            **k7_bound(torch, vq, M, clock_hz)}}
    out.update(gathered(out["gathered_bytes"], ms))
    out["pre_gathered"].update(gathered(out["pre_gathered"]["gathered_bytes"],
                                        rows_ms))
    emit(phase_b_k7=out)
    del rows_a, rows_b
    return out


def text_like_bytes(torch, g, D: int, LB: int, rows: int = 1 << 16):
    """(D, LB) uint8 rows like clinical text, and their byte lengths.

    Bytes are drawn from a 256-entry table: 192 entries of ASCII letters
    (both cases) and digits (75 %), 61 of spaces and punctuation, 3 of
    bytes >= 0x80 (1.2 %).  Past each length the bytes are uniform
    garbage.  Lengths are uniform in 0..LB-1 with 0, 1 and LB-1 forced,
    and rows 3-7 are one alnum run to the end.
    """
    alnum = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    seps = b"      ..,,;:-/()" * 4
    table = (alnum * 4)[:192] + seps[:61] + bytes([0x80, 0xC3, 0xE2])
    table = torch.tensor(list(table), dtype=torch.uint8, device="cuda")
    lengths = torch.randint(0, LB, (D,), generator=g, device="cuda",
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, LB - 1], dtype=torch.int32)
    lengths[3:8] = LB - 1
    data = torch.empty((D, LB), dtype=torch.uint8, device="cuda")
    pos = torch.arange(LB, device="cuda")[None, :]
    for s in range(0, D, rows):
        n = min(rows, D - s)
        idx = torch.randint(0, 256, (n, LB), generator=g, device="cuda",
                            dtype=torch.uint8)
        garbage = torch.randint(0, 256, (n, LB), generator=g, device="cuda",
                                dtype=torch.uint8)
        data[s : s + n] = torch.where(pos < lengths[s : s + n, None],
                                      table[idx.long()], garbage)
    data[3:8, : LB - 1] = torch.tensor(list(b"qQz9A"), dtype=torch.uint8,
                                       device="cuda")[:, None]
    return data, lengths


def phase_b_bytes(torch, clock_hz, g, seeds, n: int, r: int) -> dict:
    """K6 and ``bytes_to_bands`` on text-like bytes, each against its plain
    chain (K6 plain, compaction, K1 plain) on the same bytes."""
    import torch.nn.functional as F

    from repro_torch.kernels import byte_shingle as k6
    from repro_torch.kernels import fused_ingest as k1

    D, LB = PHASE_B_BYTE_DOCS, PHASE_B_BYTES
    data, lengths = text_like_bytes(torch, g, D, LB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sig, bands, counts = k6.bytes_to_bands(data, lengths, seeds, n=n, r=r)
    torch.cuda.synchronize()
    chain_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    chain_ms = cuda_ms(torch, lambda: k6.bytes_to_bands(data, lengths, seeds,
                                                        n=n, r=r), 3)
    split = bytes_to_bands_split(torch, data, lengths, seeds, n, r, 3)
    buf = F.pad(data, (0, 1))
    tok, ends = k6.byte_token_hashes(buf, lengths)
    k6_ms = cuda_ms(torch, lambda: k6.byte_token_hashes(buf, lengths), 5)
    width = (LB + 1) // 2 + 1
    rows, sub, timer = 1 << 15, 8192, ChunkTimer(torch)
    k6_err, chain_err = 0, 0
    for s in range(0, D, rows):
        sl = slice(s, s + rows)
        with timer:
            ptok, pends = k6.byte_token_hashes_plain(buf[sl], lengths[sl])
        k6_err = max(k6_err, max_abs_err(tok[sl], ptok),
                     int((ends[sl] != pends).sum()))
        ptokens, pcounts = k6.compact_tokens(ptok, pends, width)
        chain_err = max(chain_err, int((counts[sl] != pcounts).sum()))
        for t in range(0, ptokens.shape[0], sub):
            psig, pbands, _ = k1.fused_ingest_plain(
                ptokens[t : t + sub], pcounts[t : t + sub], seeds, n=n, r=r)
            chain_err = max(
                chain_err, max_abs_err(sig[s + t : s + t + sub], psig),
                max_abs_err(bands[s + t : s + t + sub], pbands))
    check(k6_err == 0, "paper-scale K6 kernel == plain")
    check(chain_err == 0,
          "paper-scale bytes_to_bands == K6 plain + compaction + K1 plain")
    token_bytes = token_byte_count(torch, buf, lengths)
    path = k6.schedule(buf, tok, ends)
    out = {"shape": {"D": D, "W": LB + 1}, "ms": k6_ms, "path": path,
           "plain_ms": timer.ms(), "max_abs_err": k6_err,
           **k6_bound(D, LB + 1, token_bytes, int(counts.sum()), clock_hz),
           "bytes_to_bands_ms": chain_ms, "bytes_to_bands_split_ms": split,
           "bytes_to_bands_err": chain_err,
           "bytes_to_bands_peak_gib": chain_peak_gib,
           "tokens_mean": float(counts.double().mean()),
           "tokens_max": int(counts.max())}
    emit(phase_b_bytes=out)
    return out


if __name__ == "__main__":
    sys.exit(main())
