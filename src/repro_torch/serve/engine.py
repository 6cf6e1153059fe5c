"""Continuous-batching LM serving engine of the port
(``repro.serve.engine``).

Slot-based scheduling over one decode step: requests occupy fixed batch
slots, free slots admit queued requests between steps (a new request's
prompt is fed token by token through the same decode step), and EOS,
max-tokens or the end of the cache retires a slot.  ``repro`` jits its
decode step; the port runs it eagerly.  As in ``repro``, admitting a
request does not reset its slot's cache: attention masks every position past
the slot's ``pos``, so stale K/V is never read, but a recurrent state
(xLSTM, Hymba's Mamba heads) starts from the previous request's.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, params, batch_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None, device=None):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos = eos_id
        self.queue: Deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.pending_feed: List[Deque[int]] = [deque() for _ in range(batch_slots)]
        self.cache = model.init_cache(batch_slots, max_seq, device=device)
        self.next_tok = np.zeros(batch_slots, np.int32)
        self.steps = 0
        self._submitted: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)
        self._submitted.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self.pos[s] = 0
                feed = deque(req.prompt)
                self.pending_feed[s] = feed
                self.next_tok[s] = feed.popleft()

    def step(self) -> int:
        """One engine step (one decode for every occupied slot).

        Returns the number of active requests after the step."""
        self._admit()
        occupied = [s for s in range(self.slots) if self.active[s] is not None]
        if not occupied:
            return 0
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self.next_tok[:, None].copy(), self.pos.copy())
        logits = logits[:, 0].float().cpu().numpy()
        self.steps += 1
        for s in occupied:
            req = self.active[s]
            self.pos[s] += 1
            if self.pending_feed[s]:
                # still prefilling this request's prompt
                self.next_tok[s] = self.pending_feed[s].popleft()
                continue
            nxt = int(np.argmax(logits[s]))
            req.generated.append(nxt)
            self.next_tok[s] = nxt
            if (
                len(req.generated) >= req.max_new
                or (self.eos is not None and nxt == self.eos)
                or self.pos[s] >= self.max_seq - 1
            ):
                req.done = True
                self.active[s] = None  # retire; slot admits next request
        return sum(r is not None for r in self.active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        """Step until queue and slots are empty (or max_steps); returns every
        submitted request that finished, in submission order."""
        for _ in range(max_steps):
            alive = self.step()
            if alive == 0 and not self.queue:
                break
        return [r for r in self._submitted if r.done]


def schedule_steps(prompt_lens, max_new, slots: int) -> List[int]:
    """The step at which each request retires, from the lengths alone (no
    EOS, a cache long enough): a request admitted before step ``t`` feeds
    its prompt in ``len(prompt) - 1`` steps and then generates one token a
    step, so it retires after step ``t + len(prompt) + max_new - 2``; a slot
    admits the next queued request at the start of the following step."""
    free = [1] * slots  # the first step at which each slot is free
    done = []
    for plen, new in zip(prompt_lens, max_new, strict=True):
        s = min(range(slots), key=lambda i: free[i])
        end = free[s] + plen + new - 2
        done.append(end)
        free[s] = end + 1
    return done
