"""Rehearse ``chip_smoke.py``'s phase D (the sharded session) on the CPU.

Phase D runs on the card over a one-rank NCCL group.  This script runs
the same ``chip_smoke.phase_d`` with ``device="cpu"`` over a one-rank
gloo group, so every kernel is its plain PyTorch version: it builds what
phase D takes from phases A and S (``DedupPipeline.run`` with phase A's
config, phase S's one-shot device-stage-2 step and merge), replaces
``chip_smoke.check`` by a recorder, and prints each phase-D line and the
checks that failed.  On the CPU only the launch checks can fail (no
kernel launches there).  At phase A's size (the default) it takes a few
minutes on 4 threads; ``--notes`` and ``--dups`` shrink the corpus, and
``--r3-sources`` and ``--r3-dups`` shrink D2's (3 equal chunks: keep
their sum a multiple of 3).

    PYTHONPATH=src python tools/rehearse_phase_d.py
    PYTHONPATH=src python tools/rehearse_phase_d.py --notes 768 --dups 256 \\
        --r3-sources 600 --r3-dups 168
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--notes", type=int, default=cs.PHASE_A_NOTES)
    ap.add_argument("--dups", type=int, default=cs.PHASE_A_DUPS)
    ap.add_argument("--r3-sources", type=int, default=cs.R3_SOURCES)
    ap.add_argument("--r3-dups", type=int, default=cs.R3_DUPS)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.core import dist_lsh, minhash, shingle
    from repro_torch.core.pipeline import DedupConfig, DedupPipeline
    from repro_torch.data import inject_near_duplicates, make_i2b2_like

    torch.set_num_threads(args.threads)
    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cs.check = check
    cs.R3_SOURCES, cs.R3_DUPS = args.r3_sources, args.r3_dups
    # D1's third chunk ends a quarter of the near-duplicates in (R1's
    # window at phase A's size).
    quarter = (args.notes + args.dups) // 4
    cs.D1_ENDS = (quarter, 2 * quarter,
                  args.notes + min(cs.R1_WINDOW, args.dups // 4),
                  args.notes + args.dups)
    notes, prov = inject_near_duplicates(
        make_i2b2_like(args.notes, seed=0), args.dups, seed=1)
    D = len(notes)
    # Phase A's run (its signatures) and phase S's one-shot device step.
    res = DedupPipeline(DedupConfig(
        fused_ingest=True, use_kernels=True, exact_verification=False,
        verify_backend="kernel", verify_batch="band"), device="cpu").run(notes)
    packed = shingle.pack_documents([shingle.tokenize(t) for t in notes])
    base = dict(fused_ingest=True, band_groups=5, bucket_slack=1.0,
                edge_capacity=D * 10)
    cfg = dist_lsh.DistLSHConfig(**base, stage2="device")
    out = dist_lsh.make_streamed_dedup_step(cfg, dist_lsh.docs_mesh("cpu"))(
        packed.tokens, packed.lengths, minhash.default_seeds(cfg.num_hashes))
    one = dist_lsh.cluster_step_output(out, cfg, backend="kernel",
                                       batch="band", num_docs=D)
    # D4's queries, as phase H picks them from H3's.
    queries = notes[:: cs.H_QUERY_STRIDE] + make_i2b2_like(cs.H_NOVEL, seed=7)
    ctx = {"res": res, "d_h1_ingest_s": None,
           "s_one_shot": {"labels": one.labels(), "pairs": one.pairs,
                          "config": base},
           "d4_queries": queries[:: len(queries) // cs.D4_QUERIES][
               : cs.D4_QUERIES]}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        launches = cs.phase_d(torch, notes, prov, ctx, device="cpu")
        seconds = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    print(json.dumps({"phase_d": {"seconds": seconds, "notes": D,
                                  "one_shot_pairs": len(one.pairs),
                                  "launches": launches},
                      "failed_checks": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
