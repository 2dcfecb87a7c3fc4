"""Batched serving driver: prefill a batch of prompts, decode N tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Port of ``repro.launch.serve``.  ``main`` draws its weights with the
port's ``lm.init`` from a ``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_batch(cfg, model: lm.DecoderLM, prompts: np.ndarray, max_new: int,
                cache_len: int | None = None):
    """prompts: (B, S_p) int32.  Greedy-decodes max_new tokens on the
    model's device.

    Returns (tokens (B, max_new) int32, {"prefill_s", "decode_s",
    "tok_per_s"}), the clocks read after a synchronize on the card.
    """
    device = model.embed.device
    B, S = prompts.shape
    cache_len = cache_len or (S + max_new)
    cache = lm.make_cache(cfg, B, cache_len, device=device)

    _sync(device)
    t0 = time.perf_counter()
    cache, logits = lm.prefill(cfg, model,
                               torch.as_tensor(prompts, device=device), cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    out = []
    t0 = time.perf_counter()
    for i in range(max_new):
        out.append(tok)
        kv_len = torch.full((B,), S + i, dtype=torch.int32, device=device)
        logits, cache = lm.decode(cfg, model, cache, tok, kv_len)
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return (torch.stack(out, dim=1).cpu().numpy(),
            {"prefill_s": t_prefill, "decode_s": t_decode,
             "tok_per_s": B * max_new / max(t_decode, 1e-9)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    if cfg.encdec:
        raise SystemExit("encoder-decoder serving is not ported yet "
                         "(ROADMAP.md, queue 1: the model and training stack)")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = lm.init(cfg, gen, device=device)
    prompts = np.random.RandomState(0).randint(
        2, cfg.vocab_size, size=(args.batch, args.prompt_len)
    ).astype(np.int32)
    toks, stats = serve_batch(cfg, model, prompts, args.tokens)
    print(f"decoded {toks.shape} tokens; "
          f"prefill {stats['prefill_s']*1e3:.1f} ms, "
          f"{stats['tok_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
