"""Rehearse ``chip_smoke.py``'s session phases H, R, T and Q on the CPU.

They run on the card in the script, one after another, handing records
on in ``ctx``.  This script runs the same ``chip_smoke.phase_h``,
``phase_r``, ``phase_t`` and ``phase_q`` with ``device="cpu"`` (every
kernel its plain PyTorch version), on a corpus a quarter of phase A's,
with the phases' sizes cut to match: it builds what they take
from phase A (a plain ``DedupPipeline.run``), replaces
``chip_smoke.check`` by a recorder and ``cuda_ms`` by a host clock, and
prints each phase's lines, its seconds and the checks that failed.  On
the CPU the launch checks fail (no kernel launches there), and at this
size so does R3's key compaction (fewer notes than a band's key
budget).  About 4 minutes on 4 threads, the four dedup CLIs included.

    PYTHONPATH=src python tools/rehearse_session_phases.py
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
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.pipeline import DedupConfig, DedupPipeline
    from repro_torch.data import inject_near_duplicates, make_i2b2_like

    torch.set_num_threads(args.threads)
    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    def host_ms(torch, fn, reps: int) -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    cs.check, cs.cuda_ms = check, host_ms
    # Sizes for 4,096 notes: R1 and the cut corpus at 1,792 notes, R2 and
    # R3 near their own windows and key budgets.
    cs.CUT_SOURCES, cs.CUT_DUPS = 1536, 256
    cs.R3_SOURCES, cs.R3_DUPS = 1280, 256
    cs.R2_NOTES, cs.R1_WINDOW = 2560, 256
    notes, prov = inject_near_duplicates(
        make_i2b2_like(3072, seed=0), 1024, seed=1)
    ctx = {"res": DedupPipeline(DedupConfig(
        fused_ingest=True, use_kernels=True, exact_verification=False,
        verify_backend="kernel", verify_batch="band"),
        device="cpu").run(notes)}
    seconds = {}
    t0 = time.perf_counter()
    cs.phase_h(torch, notes, prov, ctx, device="cpu")
    seconds["h"] = time.perf_counter() - t0
    for name, phase in (("r", lambda: cs.phase_r(torch, 1.98e9, notes, prov,
                                                 ctx, device="cpu")),
                        ("t", lambda: cs.phase_t(torch, notes, prov, ctx,
                                                 device="cpu")),
                        ("q", lambda: cs.phase_q(torch, 1.98e9, notes, prov,
                                                 ctx, device="cpu"))):
        t0 = time.perf_counter()
        phase()
        seconds[name] = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds, "notes": len(notes),
                      "failed_checks": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
