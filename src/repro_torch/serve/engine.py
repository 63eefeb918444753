"""Serving engine: request queue + continuous batching over the decode step.

The decode path (``models.model.decode_step``) is a fixed-shape (B, 1)
step; the engine keeps B slots, admits requests into free slots (their KV
history interleaves safely because every cache row is per-batch-element),
and retires sequences on EOS/length. This is slot-based continuous
batching with ring-buffer caches.

Per-slot state semantics: ``DecodeState.pos`` is a (B,) vector — each slot
decodes from its own position — and admission resets the admitted slot's
row of every cache / recurrent state (``models.model.reset_decode_slot``).
A request admitted into a freed slot mid-stream therefore reproduces its
solo-run output token-for-token; it can neither write at the long-running
occupant's position nor attend to the previous occupant's cached
keys/values.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_decode_state, reset_decode_slot
from repro_torch.train.train_step import make_serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    finished_at: float = 0.0


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    produced: int = 0
    prompt_cursor: int = 0

    @property
    def free(self) -> bool:
        return self.req is None


class ServeEngine:
    """Synchronous continuous-batching engine (one decode step per tick) on
    ``device``: the card unless ``device="cpu"``. ``params`` (an ``LM``)
    must live there."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 capacity: int = 256, device=None):
        self.device = resolve_device(device)
        where = next(params.parameters()).device
        if where.type != self.device.type:
            raise ValueError(f"the parameters live on {where}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.capacity = capacity
        self._step = make_serve_step(cfg)
        self.state = init_decode_state(cfg, batch_slots, capacity=capacity,
                                       device=self.device)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self._tokens = np.zeros((batch_slots, 1), np.int32)
        self._uid = 0

    # -------------------------------------------------------------- admit --
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> int:
        self._uid += 1
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      submitted_at=time.perf_counter())
        self.queue.append(req)
        return req.uid

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                slot.req = self.queue.popleft()
                slot.produced = 0
                slot.prompt_cursor = 0
                # fresh request, fresh slot: zero the slot's position and
                # every cache row so nothing of the previous occupant leaks.
                # Unconditional on purpose — even a never-occupied free slot
                # is dirty by admission time, because free slots still tick
                # (their pos advances and token-0 rows land in their caches).
                reset_decode_slot(self.cfg, self.state, i, self.capacity)
                # and the host-side token buffer: a zero-length prompt would
                # otherwise feed the previous occupant's last sampled token
                self._tokens[i, 0] = 0

    # --------------------------------------------------------------- tick --
    def tick(self) -> int:
        """One decode step for all active slots; returns #active slots.

        Prompt tokens are fed through the same step (prefill-by-decode).
        """
        self._admit()
        active = 0
        for i, slot in enumerate(self.slots):
            if slot.free:
                self._tokens[i, 0] = 0
                continue
            active += 1
            req = slot.req
            if slot.prompt_cursor < len(req.prompt):
                self._tokens[i, 0] = req.prompt[slot.prompt_cursor]
                slot.prompt_cursor += 1
            # else: token already holds last sampled id (greedy)
        if active == 0:
            return 0
        tokens = torch.from_numpy(self._tokens).to(self.device)
        logits, self.state = self._step(self.params, tokens, self.state)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.req
            if slot.prompt_cursor < len(req.prompt):
                continue  # still prefilling the prompt
            tok = int(nxt[i])
            req.output.append(tok)
            slot.produced += 1
            self._tokens[i, 0] = tok
            if slot.produced >= req.max_new_tokens or \
                    (req.eos_id is not None and tok == req.eos_id):
                req.finished_at = time.perf_counter()
                self.done.append(req)
                slot.req = None  # retire: slot is admissible next tick
        return active

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and all(s.free for s in self.slots):
                break
            self.tick()
        return self.done
