"""Continuous-batching serving engine (port of ``repro.serving.engine``).

Slot-based scheduler over a fixed decode batch: requests queue up, free
slots are filled by prefilling the prompt into the slot's rows of the
shared KV cache, every engine step decodes ONE token for all slots, and
finished sequences (EOS, ``max_tokens`` or a full cache) free their
slot.  As in the reference, a slot's cache rows are reused stale (the
prefill's ``pos`` reset and the ``kv_len`` mask hide them), inactive
slots are decoded with ``kv_len`` 0 and their tokens dropped, and a
prompt is cut to ``cache_len - max_tokens - 1`` tokens, so the port's
tokens equal the reference's.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S_p,) int32
    max_tokens: int
    out: list = field(default_factory=list)
    enqueued_at: float = 0.0
    done: bool = False


@dataclass
class EngineStats:
    steps: int = 0
    tokens_out: int = 0
    prefills: int = 0
    batch_occupancy_sum: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.batch_occupancy_sum / max(1, self.steps)


class ServeEngine:
    """Fixed-slot continuous batching over a shared KV cache on the
    model's device."""

    def __init__(self, cfg: ModelConfig, model: lm.DecoderLM, *,
                 slots: int = 8, cache_len: int = 256, eos_id: int = 1):
        if cfg.encdec:
            raise ValueError("decoder-only engine")
        self.cfg = cfg
        self.model = model
        self.device = model.embed.device
        self.slots = slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.kv_len = np.zeros(slots, dtype=np.int32)
        self.next_tok = np.zeros(slots, dtype=np.int32)
        self.stats = EngineStats()
        self.cache = lm.make_cache(cfg, slots, cache_len, device=self.device)
        self._rid = 0

    def _prefill_one(self, tokens: np.ndarray, slot: int) -> int:
        """Prefill one slot: run the prompt, merge its k/v into the slot's
        rows of the shared cache (through views, in place); returns the
        greedy next token."""
        sub_cache = {name: t[:, slot : slot + 1]
                     for name, t in self.cache.items()}
        _, logits = lm.prefill(
            self.cfg, self.model,
            torch.as_tensor(tokens, device=self.device)[None], sub_cache)
        return int(torch.argmax(logits[0, -1]))

    # -- public API -------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_tokens: int = 32) -> int:
        self._rid += 1
        self.queue.append(Request(self._rid, np.asarray(prompt, np.int32),
                                  max_tokens, enqueued_at=time.time()))
        return self._rid

    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: admit, decode, retire.  Returns #active."""
        # 1. admit queued requests into free slots (prefill).
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                prompt = req.prompt[: self.cache_len - req.max_tokens - 1]
                self.next_tok[s] = self._prefill_one(prompt, s)
                self.active[s] = req
                self.kv_len[s] = len(prompt)
                self.stats.prefills += 1

        active_mask = np.array([r is not None for r in self.active])
        n_active = int(active_mask.sum())
        if n_active == 0:
            return 0

        # 2. batched decode of one token for every slot.
        logits, self.cache = lm.decode(
            self.cfg, self.model, self.cache,
            torch.as_tensor(self.next_tok, device=self.device),
            torch.as_tensor(self.kv_len, device=self.device))
        new_tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        new_tok = new_tok.cpu().numpy()

        # 3. commit tokens + retire finished requests.
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            req.out.append(int(self.next_tok[s]))
            self.kv_len[s] += 1
            self.stats.tokens_out += 1
            done = (len(req.out) >= req.max_tokens
                    or int(new_tok[s]) == self.eos_id
                    or self.kv_len[s] >= self.cache_len - 1)
            if done:
                req.done = True
                self.active[s] = None
                self.kv_len[s] = 0
            else:
                self.next_tok[s] = int(new_tok[s])
        self.stats.steps += 1
        self.stats.batch_occupancy_sum += n_active / self.slots
        return n_active

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        finished: list[Request] = []
        seen: set[int] = set()
        all_reqs: dict[int, Request] = {}
        for r in list(self.queue):
            all_reqs[r.rid] = r
        for _ in range(max_steps):
            for r in list(self.queue):
                all_reqs[r.rid] = r
            n = self.step()
            for rid, r in all_reqs.items():
                if r.done and rid not in seen:
                    seen.add(rid)
                    finished.append(r)
            if n == 0 and not self.queue:
                break
        return finished
