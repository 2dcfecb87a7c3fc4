"""Dedup command line of the port: the host, streaming and sharded modes
of ``repro.launch.dedup``.

The corpus is split into ``--steps`` chunks and ingested through one
``core.session.DedupSession``; one report line gives the cumulative
session counters, and ``--query N`` then re-queries N ingested notes
and one novel note through a ``DedupQueryService`` over the warm
session (a streaming session has no view to query, and says so).
``--streaming`` is the out-of-core two-phase mode: each step's notes go
into a band store at ``--store-path`` in flushes of ``--chunk`` notes,
and the store is re-scanned band-major.  ``--store sqlite`` puts the
state on disk behind Bloom-first lookups: the host mode's cross-step
index, or the streaming mode's band and signature rows (verified
through K2' on ``--device``).  Signatures, bands and
the ``kernel`` verify backend run on ``--device`` (``cuda`` unless
told: K1 with ``--fused-ingest``, K3 and K4 with ``--use-kernels``, K6
with ``--byte-ingest``, K2 with ``--backend kernel``, K5 in ``refine``
with ``--use-kernels``).
``--retain-budget`` bounds the session's retained rows and band keys
(``RetentionPolicy.preset``) and ``--refine-every K`` runs the second
clustering round every K steps.  ``--sharded`` runs each step through
``core.dist_lsh``'s sharded step (``--band-groups`` edge buffers, the
full-signature verify on the host merge or, with ``--stage2 device``,
on the card through K7) over a process group: the one ``torchrun``
starts (``--devices`` 0 or its world size), else a group of one rank
that the command makes itself (NCCL on the card, gloo with ``--device
cpu``; ``--devices`` 0 or 1); it takes ``--retain-budget``,
``--refine-every`` and ``--store sqlite --store-path`` as the host mode
does.

  PYTHONPATH=src python -m repro_torch.launch.dedup --notes 500 --dups 300
  PYTHONPATH=src python -m repro_torch.launch.dedup --steps 4 --fused-ingest \\
      --estimate --backend kernel --query 64
  PYTHONPATH=src python -m repro_torch.launch.dedup --device cpu --estimate \\
      --steps 4 --retain-budget small --refine-every 2
  PYTHONPATH=src python -m repro_torch.launch.dedup --streaming --chunk 512 \\
      --steps 4 --fused-ingest --estimate --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.dedup --streaming --estimate \\
      --store sqlite --store-path bands.db
  PYTHONPATH=src python -m repro_torch.launch.dedup --sharded --steps 4 \\
      --fused-ingest --stage2 device --band-groups 5
  PYTHONPATH=src python -m repro_torch.launch.dedup --sharded --steps 4 \\
      --stage2 device --retain-budget small --refine-every 2 \\
      --store sqlite --store-path bands.db
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.dedup \\
      --sharded --steps 4 --fused-ingest
"""
from __future__ import annotations

import argparse
import os
import time


def report_session(mode: str, snap, seconds: float, extra: str = ""):
    """The cumulative report line (``snap`` is a ``ClusterSnapshot``):
    docs ingested, duplicate clusters, duplicates and verify throughput,
    and, once anything was evicted, compacted away or refined, the
    retained state, as the reference prints it."""
    retain = ""
    if snap.evicted or snap.refine_merges or snap.filter_only_hits:
        retain = (f", {snap.retained_rows} rows retained "
                  f"({snap.evicted} evicted, "
                  f"{snap.filter_only_hits} filter-only hits, "
                  f"{snap.refine_merges} refine merges)")
    print(f"{mode}: {snap.n_docs} docs ingested, "
          f"{snap.num_clusters} clusters, "
          f"{snap.num_duplicates} duplicates, "
          f"{snap.stats.pairs_evaluated} pairs verified "
          f"({snap.stats.pairs_excluded} excluded) in "
          f"{snap.stats.verify_batches} batches "
          f"({snap.stats.verify_pairs_per_second:.0f} pairs/s)"
          f"{extra}{retain}, {seconds:.2f}s total")


def run_query_demo(sess, notes, n: int):
    """Read-path demo: re-query ``n`` ingested notes and one novel note.

    Stands up a ``DedupQueryService`` over the warm session and prints
    one summary line.  Queries never mutate the session.  A session that
    cannot publish a ``SessionView`` (streaming: no cross-step band
    index) is reported and skipped.
    """
    from repro_torch.serving.dedup_service import DedupQueryService

    try:
        view = sess.view()
    except ValueError as e:
        print(f"query demo skipped: {e}")
        return
    svc = DedupQueryService(sess)
    n = min(n, len(notes))
    novel = "entirely unrelated query text " * 12
    t0 = time.perf_counter()
    results = svc.query(list(notes[:n]) + [novel])
    dt = time.perf_counter() - t0
    hits = sum(r.is_duplicate for r in results[:n])
    best = max((r.best_sim for r in results[:n]), default=0.0)
    print(f"query[view v{view.version}]: {hits}/{n} re-queried notes "
          f"matched their clusters (best sim {best:.2f}), novel note "
          f"{'came back novel' if results[-1].novel else 'MATCHED (!)'}"
          f", {n + 1} queries in {dt * 1e3:.1f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--notes", type=int, default=500)
    ap.add_argument("--dups", type=int, default=300)
    ap.add_argument("--edge-threshold", type=float, default=0.75)
    ap.add_argument("--tree-threshold", type=float, default=0.40)
    ap.add_argument("--use-kernels", action="store_true",
                    help="staged signatures through K3 (n-gram hashes) and "
                         "K4 (minhash); the auto backend becomes kernel")
    ap.add_argument("--fused-ingest", action="store_true",
                    help="signatures and bands in one pass of K1")
    ap.add_argument("--byte-ingest", action="store_true",
                    help="raw UTF-8 bytes to bands on the device (K6, "
                         "compaction, K1; no stemming; implies --estimate)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "numpy", "torch", "kernel"),
                    help="estimate-mode verification backend")
    ap.add_argument("--batch", default="run", choices=("run", "band"),
                    help="engine batch granularity (band = max throughput)")
    ap.add_argument("--estimate", action="store_true",
                    help="signature-estimate verification (vs exact)")
    ap.add_argument("--device", default="cuda",
                    help="where signatures, bands and the device verify "
                         "backends run (cuda, or cpu for the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--steps", type=int, default=1,
                    help="split the corpus into N chunks and ingest them "
                         "incrementally through one DedupSession")
    ap.add_argument("--query", type=int, default=0, metavar="N",
                    help="after ingest, stand up a DedupQueryService over "
                         "the warm session and re-query N ingested notes "
                         "plus one novel note")
    ap.add_argument("--streaming", action="store_true",
                    help="two-phase out-of-core mode over a band store")
    ap.add_argument("--chunk", type=int, default=128,
                    help="streaming ingest chunk size")
    ap.add_argument("--store-path", default=":memory:",
                    help="sqlite database path for the store tier "
                         "(default :memory:)")
    ap.add_argument("--sharded", action="store_true",
                    help="run each step through the sharded step "
                         "(core.dist_lsh) over a process group")
    ap.add_argument("--devices", type=int, default=0,
                    help="sharded mode: the shard count, checked against "
                         "the process group (0: the group's)")
    ap.add_argument("--band-groups", type=int, default=1,
                    help="sharded mode: G bounded edge buffers of b/G "
                         "bands each")
    ap.add_argument("--stage2", default="host", choices=("host", "device"),
                    help="sharded mode: the full-signature verify on the "
                         "host merge, or on the device (K7; cross-shard "
                         "edges through the exchanged row buffers)")
    ap.add_argument("--retain-budget", default="none",
                    choices=("none", "small", "medium", "unlimited"),
                    help="bounded retained state: evict non-root rows past "
                         "an LRU window and compact old band-index keys "
                         "into per-band Bloom filters (none = append-only)")
    ap.add_argument("--refine-every", type=int, default=0,
                    help="run the second clustering round "
                         "(DedupSession.refine) every K ingest steps "
                         "(0 = off)")
    ap.add_argument("--store", default=None, choices=("memory", "sqlite"),
                    help="band-store tier: memory (in-RAM index / "
                         "Design-2 blob store) or sqlite (disk-resident "
                         "band + signature rows behind Bloom-first "
                         "lookups; identical clusters either way). "
                         "Default: $REPRO_STORE_BACKEND or memory")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core import DedupConfig, DedupSession, RetentionPolicy
    from repro_torch.data import inject_near_duplicates, make_i2b2_like

    retention = None
    if args.retain_budget != "none" or args.refine_every:
        # "none" with --refine-every keeps rows append-only (no eviction)
        # while tracking roots for the refine cadence.
        retention = RetentionPolicy.preset(
            args.retain_budget, refine_every=args.refine_every)

    notes = make_i2b2_like(args.notes)
    notes, _ = inject_near_duplicates(notes, args.dups)
    print(f"corpus: {len(notes)} notes ({args.dups} injected near-dups), "
          f"{args.steps} ingest step(s)")
    bounds = np.linspace(0, len(notes), max(1, args.steps) + 1).astype(int)
    chunks = [notes[a:b] for a, b in zip(bounds, bounds[1:])]
    cfg = DedupConfig(
        edge_threshold=args.edge_threshold,
        tree_threshold=args.tree_threshold,
        use_kernels=args.use_kernels,
        fused_ingest=args.fused_ingest,
        byte_ingest=args.byte_ingest,
        exact_verification=not (args.estimate or args.byte_ingest),
        verify_backend=args.backend,
        verify_batch=args.batch,
        # None falls back to the field default ($REPRO_STORE_BACKEND).
        **({"store": args.store} if args.store else {}))

    if args.sharded:
        run_sharded(ap, args, cfg, notes, chunks, retention)
        return

    if args.streaming:
        from repro_torch.core.shingle import tokenize
        from repro_torch.core.verify import ExactJaccardVerifier

        verifier = None
        if cfg.byte_ingest:
            # Raw texts stream to the device: there is nothing to
            # tokenize on the host (and byte ingest is estimate mode).
            stream_chunks = chunks
            tokenized = False
        else:
            # One tokenize pass: the chunks go in pre-tokenized, and the
            # exact verifier (the streaming backend's own verifier is the
            # signature estimate) is built over the same token lists.
            toks = [tokenize(t) for t in notes]
            if cfg.exact_verification:
                verifier = ExactJaccardVerifier.from_token_lists(
                    toks, cfg.ngram)
            stream_chunks = [toks[a:b] for a, b in zip(bounds, bounds[1:])]
            tokenized = True
        sess = DedupSession(cfg, backend="streaming", chunk_docs=args.chunk,
                            verifier=verifier, store_path=args.store_path,
                            retention=retention, device=args.device)
        t0 = time.perf_counter()
        for snap in sess.ingest_stream(stream_chunks, tokenized=tokenized):
            pass
        dt = time.perf_counter() - t0
        report_session(f"streaming[{args.steps} step(s)]", snap, dt)
        if args.query:
            run_query_demo(sess, notes, args.query)
        return

    sess = DedupSession(cfg, backend="host", store_path=args.store_path,
                        retention=retention, device=args.device)
    t0 = time.perf_counter()
    for chunk in chunks:
        snap = sess.ingest(chunk)
    dt = time.perf_counter() - t0
    report_session(f"host[{args.steps} step(s)]", snap, dt)
    if args.query:
        run_query_demo(sess, notes, args.query)


def process_group(ap, args):
    """The sharded mode's process group: the default group if one is
    initialized, or the one ``torchrun`` describes in the environment,
    else one rank made here over an in-memory store (NCCL on the card,
    gloo on the CPU).  Returns whether this call made it, so the caller
    destroys it.  ``--devices`` must be 0 or the group's size."""
    import torch
    import torch.distributed as dist

    made = False
    cpu = torch.device(args.device).type == "cpu"
    if not dist.is_initialized():
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "gloo" if cpu else "nccl"
        if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        made = True
    world = dist.get_world_size()
    if args.devices not in (0, world):
        if made:
            dist.destroy_process_group()
        ap.error(f"--devices {args.devices} does not match the process "
                 f"group's {world} rank(s); start one process a rank with "
                 "torchrun")
    return made


def run_sharded(ap, args, cfg, notes, chunks, retention):
    """``--sharded``: one sharded ``DedupSession`` over ``chunks``, with
    estimate verification (the step's verify is the signature
    estimate) and ``retention`` (a ``RetentionPolicy`` or ``None``);
    every rank runs it, rank 0 reports."""
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch.core import DedupSession, DistLSHConfig

    made = process_group(ap, args)
    try:
        dcfg = DistLSHConfig(edge_threshold=args.edge_threshold,
                             edge_capacity=8192,
                             band_groups=args.band_groups,
                             stage2=args.stage2,
                             fused_ingest=args.fused_ingest,
                             byte_ingest=args.byte_ingest)
        sess = DedupSession(replace(cfg, exact_verification=False),
                            backend="sharded", dist_config=dcfg,
                            store_path=args.store_path, retention=retention,
                            device=args.device)
        t0 = time.perf_counter()
        for snap in sess.ingest_stream(chunks):
            pass
        dt = time.perf_counter() - t0
        if dist.get_rank() != 0:
            return
        extra = (f", {snap.overflow} overflow"
                 f"{' (host fallback ran)' if snap.retried else ''}")
        if args.stage2 == "device":
            extra += (f", stage2=device {snap.device_scored} "
                      f"device-scored / {snap.host_rescored} "
                      f"host-rescored / {snap.row_overflow} row-overflow")
        report_session(
            f"sharded[{dist.get_world_size()} devices x {dcfg.band_groups} "
            f"band-group(s) x {args.steps} step(s)]", snap, dt, extra)
        if args.query:
            run_query_demo(sess, notes, args.query)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
