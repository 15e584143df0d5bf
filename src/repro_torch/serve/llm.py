"""Batched LLM serving engine: prefill + continuous-batching decode, the
port of ``repro.serve.llm``.

Fixed B decode slots; finished sequences (EOS or max length) are evicted and
their slots refilled from the pending queue without stalling the other
slots: a continuous-batching loop in the vLLM sense, with shape-stable
steps (a slot refill splices a one-sequence prefill cache into slot ``s``,
not a reshape).  Decoding is greedy.  Every read of device state goes
through the counted ``utils.host`` pull.

Imported as ``repro_torch.serve.llm.ServeEngine``; ``repro_torch.serve``
exports the graph-query engine of the same name.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.utils import host


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [L] int32
    max_new_tokens: int = 32
    output: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Greedy-decoding engine with slot-based continuous batching, on the
    device of ``params``."""

    def __init__(self, params, cfg: tfm.TransformerConfig, batch_slots: int,
                 max_len: int, eos_id: int = 0):
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        self.device = params["embed"]["table"].device
        self.cache = tfm.init_kv_cache(cfg, batch_slots, max_len,
                                       device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_budget = np.zeros(batch_slots, np.int64)
        self.pending: collections.deque[Request] = collections.deque()
        self._decode = lambda p, t, c: tfm.decode_step(p, t, c, cfg)
        self._prefill1 = lambda p, t: tfm.prefill(p, t, cfg, max_len)

    # ------------------------------------------------------------- plumbing

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    def _fill_slots(self) -> None:
        for s in range(self.B):
            if self.slot_req[s] is not None or not self.pending:
                continue
            req = self.pending.popleft()
            logits, cache1 = self._prefill1(self.params,
                                            self._tokens(req.prompt[None, :]))
            # splice the single-sequence cache into slot s
            for key in ("k", "v"):
                self.cache[key][:, s] = cache1[key][:, 0]
            self.cache["len"][s] = cache1["len"][0]
            req.output.append(int(host(torch.argmax(logits[0]))))
            self.slot_req[s] = req
            self.slot_budget[s] = req.max_new_tokens - 1

    def _evict_finished(self) -> None:
        if all(req is None for req in self.slot_req):
            return
        lens = host(self.cache["len"])           # one pull for every slot
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if (req.output and req.output[-1] == self.eos) \
                    or self.slot_budget[s] <= 0 \
                    or int(lens[s]) >= self.max_len - 1:
                req.done = True
                self.slot_req[s] = None
                self.cache["len"][s] = 0

    # ----------------------------------------------------------------- run

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration; returns number of active slots."""
        self._evict_finished()
        self._fill_slots()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros(self.B, np.int32)
        for s in active:
            tokens[s] = self.slot_req[s].output[-1]
        logits, self.cache = self._decode(self.params, self._tokens(tokens),
                                          self.cache)
        nxt = host(torch.argmax(logits, dim=-1))
        for s in active:
            self.slot_req[s].output.append(int(nxt[s]))
            self.slot_budget[s] -= 1
        return len(active)

    def run_to_completion(self, max_iters: int = 10_000) -> None:
        for _ in range(max_iters):
            if self.step() == 0 and not self.pending:
                return
        raise RuntimeError("serve loop did not drain")
