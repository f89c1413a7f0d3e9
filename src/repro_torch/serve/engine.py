"""Batched serving engine: request queue → lockstep greedy decode (the port
of ``repro.serve.engine``).

Static batching with early-retire masking: a wave of up to ``n_slots``
requests is admitted together (prompts right-aligned by padding to the wave's
max prompt length with token 0), fed through the decode step token by token,
decoded in lockstep with one step per token, and retired per request when its
budget is exhausted — finished slots continue to decode but their outputs
are dropped.

The engine runs where the parameters are (``params["embed"].device``) and
keeps the reference's positions exactly: after a prompt of ``plen`` tokens
the first generated token is fed at ``cur_len = plen + 2``, so cache slot
``plen`` is never written yet attended as a zero key and value (ROADMAP.md,
reference caveat R5). Its tokens are then the reference's.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models.api import ModelAPI


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Wave-batched greedy decoding over a fixed KV budget."""

    def __init__(self, api: ModelAPI, params, n_slots: int = 4, max_len: int = 128):
        if api.cfg.family == "audio":
            raise NotImplementedError("enc-dec serving uses launch/serve.py directly")
        self.api, self.params = api, params
        self.n_slots, self.max_len = n_slots, max_len
        self.device = params["embed"].device
        self.queue: deque[Request] = deque()

    def submit(self, req: Request):
        self.queue.append(req)

    def _decode(self, token: torch.Tensor, cache: dict, cur_len: int):
        """One step; returns the greedy tokens (b, 1) and the cache."""
        logits, cache = self.api.decode_fn(self.params, token, cache, cur_len,
                                           device=self.device)
        return torch.argmax(logits, -1).to(torch.int32)[:, None], cache

    def _run_wave(self, wave: list[Request]) -> None:
        b = self.n_slots
        plen = max(len(r.prompt) for r in wave)
        prompts = np.zeros((b, plen), np.int32)
        for s, r in enumerate(wave):
            prompts[s, plen - len(r.prompt):] = r.prompt      # right-aligned
        prompts = torch.from_numpy(prompts).to(self.device)
        cache = self.api.init_decode_state(b, self.max_len, device=self.device)
        cur = None
        for t in range(plen):
            cur, cache = self._decode(prompts[:, t:t + 1], cache, t + 1)
        budgets = np.array([r.max_new for r in wave] + [0] * (b - len(wave)))
        toks = cur[:, 0].tolist()
        for s, r in enumerate(wave):
            r.out.append(toks[s])
            budgets[s] -= 1
        steps = 0
        while (budgets > 0).any() and plen + steps < self.max_len - 1:
            cur, cache = self._decode(cur, cache, plen + steps + 2)
            toks = cur[:, 0].tolist()
            for s, r in enumerate(wave):
                if budgets[s] > 0:
                    r.out.append(toks[s])
                    budgets[s] -= 1
                    if budgets[s] == 0:
                        r.done = True
            steps += 1
        for r in wave:
            r.done = True

    def run(self) -> list[Request]:
        finished: list[Request] = []
        while self.queue:
            wave = [self.queue.popleft() for _ in range(min(self.n_slots, len(self.queue)))]
            self._run_wave(wave)
            finished.extend(wave)
        return finished
