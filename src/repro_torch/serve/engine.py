"""Continuous-batching serve engine over the paged decode path.

Port of ``repro/serve/engine.py`` (DESIGN §14): the same slot lifecycle,
admission policies, stall-on-exhausted-pool and all-stalled
``OutOfPages``.  One ``paged_decode_step`` serves a fixed grid of
``n_slots`` decode slots; admission, prefill progress, sampling, EOS/
max-token eviction and page allocation happen on the host between steps.
Prefill rides the decode path one token per step: a slot still consuming
its prompt feeds the next prompt token and its logits are ignored until
the prompt is exhausted.

Slot lifecycle:  FREE -> (admit) -> PREFILL -> DECODE -> (EOS | max-tokens)
-> evict -> FREE.  Eviction returns the slot's pages to the allocator,
points its page-table row back at the scratch page and zeroes the slot's
recurrent state (``api.reset_slot``: mamba's conv history and h), as
admission does again.  FREE and page-stalled slots are left out of the
``advance`` mask, so their recurrent state stays bitwise frozen; the
scratch page takes only their attention write.

A MoE model routes with a capacity per expert, so the tokens served for a
prompt can depend on which other requests share its steps.

Admission: ``continuous`` admits a request the moment a slot is free;
``static`` admits only when EVERY slot is free (the head-of-line-blocking
baseline).

Closed-loop callers submit everything and ``run``; an open-loop caller
(requests arriving at given engine steps) submits each arrival when
``step_count`` reaches it, calls ``step`` while ``has_work`` and
``idle_tick`` otherwise; ``active_slots`` counts the occupied slots.

If the pool runs dry mid-flight the affected slot STALLS: it does not
advance, its write lands in the scratch page, and it resumes once an
eviction frees pages.  If every active slot is stalled the engine raises
``OutOfPages``: pages are freed only by evictions, which need some slot to
advance, so such a step could never make progress.

The step runs on ``api.device`` under ``torch.inference_mode``; the K/V
pools and the recurrent state are updated in place.  Per step the host
copies the tokens, positions, page table and advance mask in, and takes
ONE sync: the per-slot argmax of the logits, which sampling needs on the
host.
"""
# lint: hot-path
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from .. import obs
from .paging import OutOfPages, PageAllocator

FREE, PREFILL, DECODE = "free", "prefill", "decode"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    arrival_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1

    @property
    def done(self) -> bool:
        return self.finish_step >= 0


class _Slot:
    __slots__ = ("index", "state", "req", "pos")

    def __init__(self, index: int):
        self.index = index
        self.state = FREE
        self.req: Optional[Request] = None
        self.pos = 0          # tokens fed into the cache so far


class ServeEngine:
    def __init__(self, api, params, *, n_slots: int = 4, page_size: int = 16,
                 max_len: int = 128, n_pages: Optional[int] = None,
                 admission: str = "continuous"):
        if admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if not api.has_paged:
            raise ValueError(
                f"{api.cfg.name}: the {api.cfg.family} family has no paged "
                "decode (serve it through api.init_cache / decode_step)")
        self.api = api
        self.device = api.device
        self.set_params(params)
        self.page_size = page_size
        self.max_pages = -(-max_len // page_size)
        self.max_len = self.max_pages * page_size
        self.n_slots = n_slots
        self.admission = admission
        # default pool: every slot can hold a full-length request (+scratch)
        self.n_pages = n_pages or 1 + n_slots * self.max_pages
        self.alloc = PageAllocator(self.n_pages)
        self.cache = api.init_paged_cache(params, n_slots, self.n_pages,
                                          page_size)
        self.page_table = np.zeros((n_slots, self.max_pages), np.int32)
        self.slots = [_Slot(i) for i in range(n_slots)]
        self.queue: deque = deque()
        self._next_rid = 0
        self.step_count = 0       # the engine clock (idle ticks included)
        self.real_steps = 0       # steps that actually ran the model
        self.generated_total = 0
        self.stall_events = 0

    # ------------------------------------------------------------- intake --
    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        need = len(prompt) + max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} tokens > max_len {self.max_len} "
                "(the paged cache does not wrap)")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival_step=self.step_count)
        self._next_rid += 1
        self.queue.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.state != FREE for s in self.slots)

    @property
    def active_slots(self) -> int:
        """Slots holding a request (prefilling or decoding)."""
        return sum(s.state != FREE for s in self.slots)

    # ---------------------------------------------------------- scheduling --
    def _admit(self) -> None:
        free = [s for s in self.slots if s.state == FREE]
        if self.admission == "static" and len(free) < self.n_slots:
            return                       # head-of-line: wait for the batch
        for slot in free:
            if not self.queue:
                break
            slot.req = self.queue.popleft()
            slot.pos = 0
            slot.state = PREFILL
            self.cache = self.api.reset_slot(self.cache, slot.index)

    def _ensure_page(self, slot: _Slot) -> bool:
        """Allocate the page slot.pos falls in, if not already owned.
        Returns False (stall) when the pool is dry."""
        if slot.pos % self.page_size:
            return True
        pidx = slot.pos // self.page_size
        if self.page_table[slot.index, pidx]:
            return True
        try:
            self.page_table[slot.index, pidx] = self.alloc.alloc()
            return True
        except OutOfPages:
            self.stall_events += 1
            return False

    def _evict(self, slot: _Slot) -> None:
        row = self.page_table[slot.index]
        self.alloc.free(row[row > 0])
        row[:] = 0
        self.cache = self.api.reset_slot(self.cache, slot.index)
        slot.req = None
        slot.pos = 0
        slot.state = FREE

    # -------------------------------------------------------------- stepping --
    def idle_tick(self) -> None:
        """Advance the engine clock without touching the device: an
        open-loop caller fast-forwards between arrivals with it (no model
        step, no kernel launch; ``real_steps`` stays)."""
        self.step_count += 1

    def _run(self, tokens, positions, adv_mask):
        """One fused decode step on the device; returns the per-slot argmax
        over the logical vocab as a host array (the step's one sync)."""
        def dev(a):
            return torch.from_numpy(a).to(self.device)

        with torch.inference_mode():
            with obs.span("serve.model"):
                logits, self.cache = self.api.paged_decode_step(
                    self.params, self.cache, dev(tokens), dev(positions),
                    dev(self.page_table), dev(adv_mask))
                best = logits[:, 0, :self.api.cfg.vocab].argmax(-1)
            with obs.span("serve.readback"):
                return np.asarray(best.cpu())   # lint: allow-host-sync

    def warmup(self) -> None:
        """Run one step before any request is admitted: every write lands
        in the scratch page.  On the card this builds and loads the
        kernels."""
        S = self.n_slots
        self._run(np.zeros((S, 1), np.int32), np.zeros((S,), np.int32),
                  np.zeros((S,), bool))

    def step(self) -> int:
        """One engine step: admit, run the fused decode, sample, evict.
        Returns the number of tokens generated this step (0 on an idle
        step, which still advances the clock)."""
        with obs.span("serve.step"):
            with obs.span("serve.admit"):
                self._admit()
            active = [s for s in self.slots if s.state != FREE]
            if not active:
                self.step_count += 1
                return 0

            with obs.span("serve.prepare"):
                S = self.n_slots
                tokens = np.zeros((S, 1), np.int32)
                positions = np.zeros((S,), np.int32)
                adv_mask = np.zeros((S,), bool)
                advance = []
                for slot in active:
                    if not self._ensure_page(slot):
                        # stalled: re-fed later; write -> scratch page
                        positions[slot.index] = slot.pos
                        continue
                    req = slot.req
                    if slot.pos < len(req.prompt):
                        tokens[slot.index, 0] = req.prompt[slot.pos]
                    else:
                        tokens[slot.index, 0] = req.generated[-1]
                    positions[slot.index] = slot.pos
                    adv_mask[slot.index] = True
                    advance.append(slot)

            if not advance:
                raise OutOfPages(
                    f"deadlock: all {len(active)} active slot(s) stalled on "
                    f"an exhausted pool of {self.n_pages - 1} page(s) and "
                    "no eviction can free any; size n_pages for the "
                    "expected concurrency")

            best = self._run(tokens, positions, adv_mask)

            with obs.span("serve.finish"):
                made = 0
                for slot in advance:
                    req = slot.req
                    slot.pos += 1
                    if slot.pos < len(req.prompt):
                        continue                   # still prefilling
                    if slot.state == PREFILL:
                        slot.state = DECODE
                    tok = int(best[slot.index])
                    req.generated.append(tok)
                    made += 1
                    if req.first_token_step < 0:
                        req.first_token_step = self.step_count
                    if ((req.eos_id is not None and tok == req.eos_id)
                            or len(req.generated) >= req.max_new_tokens):
                        req.finish_step = self.step_count
                        self._evict(slot)
                self.generated_total += made
                self.step_count += 1
                self.real_steps += 1
            obs.count("serve.slot_steps", len(advance))
            obs.count("serve.tokens", made)
            return made

    def run(self, max_steps: int = 100_000) -> None:
        """Drain the queue and all active slots (closed-loop drivers)."""
        while self.has_work:
            self.step()
            if self.step_count >= max_steps:
                raise RuntimeError("serve engine wedged")

    # --------------------------------------------------------------- weights --
    def set_params(self, params) -> None:
        """Hot-swap served weights (same shapes; nothing is rebuilt).  They
        must live on the engine's device."""
        dev = next(params.parameters()).device
        if dev.type != self.device.type:
            raise ValueError(f"params on {dev}, engine on {self.device}")
        self.params = params
