"""Batched LM serving engine: prefill + incremental decode over the dense
LM's per-layer KV caches.

Requests are grouped into fixed batch slots; a batch prefills together
(all prompts of one length) and then decodes lock-step with per-request
stop lengths. Greedy (argmax) or temperature sampling, the latter from a
``torch.Generator`` seeded with the batch's seed.

The engine implements the serving :class:`~repro_torch.serving.api.Engine`
step protocol — ``route`` buckets requests by prompt length, ``step`` runs
one formed micro-batch — so the :class:`~repro_torch.serving.api.Server`
drives it as it drives the GNN engine.

``stats`` keeps host-clock totals taken where the engine waits for the
card anyway (the sampled tokens are copied to the host after every
step): prefill time per batch and decode time per step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.api import resolve_device


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy


class ServeEngine:
    """Serve one dense LM on ``device`` (``cuda`` unless the caller names
    another). ``params`` is the reference's parameter tree (numpy or
    tensors; moved to ``device`` with their dtypes kept); ``backend`` is
    the kernel backend of prefill attention (``cuda`` or ``reference``)."""

    def __init__(self, cfg: ModelConfig, params: dict, max_len: int = 512, *,
                 device: torch.device | str | None = None,
                 backend: str | None = None):
        lm.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = lm.params_from_numpy(params, self.device)
        self.max_len = max_len
        self.backend = backend
        self._step_seed = 0
        # the Server serializes step(), so the counters have one writer
        self.stats = {"prefill_batches": 0, "prefill_tokens": 0,  # guarded-by: Server._step_lock
                      "prefill_ms_total": 0.0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_ms_total": 0.0}

    # -- Engine step protocol (what the Server drives) ---------------------

    def route(self, req: Request) -> int:
        """Validate one request and name its stream: the prompt-length
        bucket, since a batch prefills at one length."""
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError("empty prompt")
        if plen + req.max_new_tokens + 1 > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds engine max_len {self.max_len}")
        return plen

    def step(self, key: int, requests: Sequence[Request]) -> list:
        """Run one formed micro-batch (all prompts are length ``key``)."""
        seed, self._step_seed = self._step_seed, self._step_seed + 1
        return self.generate(list(requests), seed=seed)

    @torch.inference_mode()
    def generate(self, requests: Sequence[Request], seed: int = 0):
        """Serve one batch of equal-length prompts. Returns a list of
        generated token arrays, (max_new_tokens,) int32 each."""
        cfg = self.cfg
        b = len(requests)
        plen = len(requests[0].prompt)
        if any(len(r.prompt) != plen for r in requests):
            raise ValueError("batch requests by equal prompt length "
                             "(bucketing upstream)")
        toks = np.stack([np.asarray(r.prompt, np.int32) for r in requests])
        gen = torch.Generator(self.device).manual_seed(seed)
        t0 = time.perf_counter()
        logits, caches = lm.prefill(
            self.params, cfg, {"tokens": torch.from_numpy(toks).to(self.device)},
            self.max_len, backend=self.backend)
        cur = self._sample(logits[:, 0], requests, gen)
        cur_host = cur.cpu().numpy()  # analyze: allow(host-sync)
        t1 = time.perf_counter()
        self.stats["prefill_batches"] += 1
        self.stats["prefill_tokens"] += b * plen
        self.stats["prefill_ms_total"] += (t1 - t0) * 1e3

        outs: list[list] = [[] for _ in requests]
        max_new = max(r.max_new_tokens for r in requests)
        for step in range(max_new):
            for i, r in enumerate(requests):
                if step < r.max_new_tokens:
                    outs[i].append(cur_host[i])
            if step == max_new - 1:
                break
            t0 = time.perf_counter()
            logits, caches = lm.decode_step(
                self.params, cfg, {"tokens": cur[:, None], "pos": plen + step},
                caches)
            cur = self._sample(logits[:, 0], requests, gen)
            cur_host = cur.cpu().numpy()  # analyze: allow(host-sync)
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += b
            self.stats["decode_ms_total"] += (time.perf_counter() - t0) * 1e3
        return [np.asarray(o, np.int32) for o in outs]

    def _sample(self, logits: torch.Tensor, requests, gen: torch.Generator):
        """(B, V) logits -> (B,) int32 tokens: argmax where the request's
        temperature is 0, else a draw from softmax(logits / T)."""
        greedy = torch.argmax(logits, dim=-1)
        temps_host = np.asarray([r.temperature for r in requests], np.float32)
        if temps_host.max() == 0.0:
            return greedy.to(torch.int32)
        temps = torch.from_numpy(temps_host).to(logits.device)
        probs = torch.softmax(
            logits.float() / temps.clamp(min=1e-4)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return torch.where(temps <= 0, greedy, sampled).to(torch.int32)
