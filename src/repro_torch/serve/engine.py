"""Batched LM serving: prefill + decode scheduler with constrained decoding.

The port's copy of the JAX package's ``serve/engine.py``.  A deliberately
small continuous-batching server: requests join a slot in a fixed-size
batch; each engine tick runs one decode step for every active slot;
finished sequences free their slot for the next queued request.
Constraint masks (``serve/constrain.py``) are applied per step — the
paper's bitmap intersection at vocab scale.

Same semantics as the JAX package, including its cross-slot cache writes:
``_step_one_slot`` decodes the whole batch at slot i's position (the other
slots get token 0), and every row writes its K/V there, so a slot further
along has its cache entry at that position overwritten.  A request's
tokens therefore depend on what shares the batch with it.  The JAX
package is the reference, so the port keeps this.  ``model.decode`` runs
eagerly.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.model import Model
from .admission import Ticket
from .constrain import apply_mask_to_logits


@dataclasses.dataclass
class Request:
    prompt: np.ndarray               # (P,) int
    max_new: int = 16
    constraint: Optional[torch.Tensor] = None  # packed vocab mask
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeServer:
    """Serves on ``model``'s device, which ``build_model`` resolved."""

    def __init__(self, model: Model, params: Any, batch_slots: int = 4,
                 max_seq: int = 256):
        self.device = model.device
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, dtype=np.int32)
        self.max_seq = max_seq
        self.cache = model.init_cache(batch_slots, max_seq)
        self._decode = model.decode
        self.queue: List[Request] = []
        self.ticks = 0
        self._tickets: Dict[int, List[Ticket]] = {}
        self._work = threading.Event()
        self._stop_ticker = threading.Event()
        self._ticker: Optional[threading.Thread] = None

    def submit(self, req: Request) -> Ticket:
        """Queue a request; returns a Ticket (same future type as the
        search front-end's admission queue) that resolves to the generated
        token list when the request completes.  Callers may keep polling
        ``req.done`` instead — the ticket is additive.  Submitting the
        same Request object twice returns a second ticket; both resolve
        at its first completion.  Wakes the background ticker if one is
        running (:meth:`start`)."""
        self.queue.append(req)
        ticket = Ticket(submitted_at=time.perf_counter(), deadline_us=0.0)
        self._tickets.setdefault(id(req), []).append(ticket)
        self._work.set()
        return ticket

    # ------------------------------------------------------------------
    # background ticker (the decode-side twin of the search engine's
    # background flusher): callers submit-and-wait on tickets, nobody
    # drives tick() by hand
    # ------------------------------------------------------------------

    def start(self) -> "DecodeServer":
        """Start a daemonized background tick loop (idempotent).

        The loop ticks while requests are queued or slots are active and
        parks on an event otherwise; ``submit`` sets the event.  Ticks run
        only on the ticker thread, so don't call :meth:`tick` /
        :meth:`run_until_drained` manually while it runs.
        """
        if self._ticker is not None and self._ticker.is_alive():
            return self
        self._stop_ticker.clear()
        self._ticker = threading.Thread(
            target=self._tick_loop, name="repro-torch-decode-ticker",
            daemon=True)
        self._ticker.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the ticker (idempotent); by default finish remaining work
        synchronously so every issued ticket resolves."""
        thread = self._ticker
        self._ticker = None
        if thread is not None:
            self._stop_ticker.set()
            self._work.set()
            thread.join()
        if drain:
            self.run_until_drained()

    def _tick_loop(self) -> None:
        while not self._stop_ticker.is_set():
            if self.queue or any(s is not None for s in self.slots):
                self.tick()
            else:
                self._work.clear()
                if self.queue:
                    continue  # a submit raced the clear: don't sleep on it
                self._work.wait(timeout=0.05)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # naive prefill: feed prompt tokens one by one through the
                # decode path, as the JAX package does
                self.pos[i] = 0
                for tok in req.prompt.tolist():
                    self._step_one_slot(i, tok)

    def _step_one_slot(self, i: int, token: int) -> int:
        tokens = np.zeros((len(self.slots), 1), dtype=np.int64)
        tokens[i, 0] = token
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device),
            int(self.pos[i]))
        self.pos[i] += 1
        req = self.slots[i]
        row = logits[i][None]
        if req is not None and req.constraint is not None:
            row = apply_mask_to_logits(row, req.constraint, self.cfg.vocab)
        return int(torch.argmax(row, dim=-1)[0])

    def tick(self) -> None:
        """One engine iteration: admit, decode one token per active slot."""
        self._admit()
        self.ticks += 1
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            last = req.out[-1] if req.out else int(req.prompt[-1])
            nxt = self._step_one_slot(i, last)
            req.out.append(nxt)
            if len(req.out) >= req.max_new or self.pos[i] >= self.max_seq - 1:
                req.done = True
                self.slots[i] = None
                for ticket in self._tickets.pop(id(req), []):
                    wait_us = (time.perf_counter() - ticket.submitted_at) * 1e6
                    ticket.resolve(req.out, wait_us=wait_us)

    def run_until_drained(self, max_ticks: int = 1000) -> None:
        while (self.queue or any(s is not None for s in self.slots)):
            self.tick()
            if self.ticks > max_ticks:
                raise RuntimeError("serve loop did not drain")
