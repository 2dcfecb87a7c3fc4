"""Time K8's float32 kernel as chip_smoke.py's phase F does, for any checkout.

    python tools/time_k8_f32.py [--src PATH] [--label NAME]

Builds the kernels of ``PATH/repro_torch`` (default: this checkout's
``src``) and runs ``chip_smoke.k8_f32_cases`` with that checkout's
``kernels.flash_attention``: K8 float32 at the tests' four shapes and at
h2o-danube-1.8b's, olmo-1b's and gemma-7b's prefill shapes, on phase F's
inputs (the same seed and order), each checked against
``flash_attention_plain`` to 3e-5 (a miss raises) and timed by CUDA
events, with its bound.  One JSON line a shape, then one with ptxas's
report of each float32 instantiation, nvcc's time for the file and the
card's name and power limit.

``--src`` lets two checkouts meet on one card in one call: unpack the
other commit into a gitignored directory (``git archive``) and run
parent, change, change, parent, each in its own process.  Needs a CUDA
device; imports neither JAX nor the reference package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch to time")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_k8_f32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k8

    _, log = build.build()
    clock_hz = float(cs.smi_query("clocks.max.sm", units=False)) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    for row, *_ in cs.k8_f32_cases(torch, k8, g, clock_hz):
        print(json.dumps({"label": args.label, **row}), flush=True)
    print(json.dumps({"label": args.label,
                      "ptxas_f32": [r for r in cs.k8_ptxas(log)
                                    if r["kernel"] == "f32"],
                      "nvcc_s": cs.nvcc_seconds(log).get(
                          "flash_attention_f32.cu"),
                      "card": cs.smi_query("name,power.limit")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
