"""Continuous-batching scheduler + serving engine (subset of
``repro.serving.scheduler``).

Every scheduler step:

  1. **retire**  — sequences that hit their generation budget free their
                   pages back to the pool,
  2. **admit**   — the lifecycle sweep fails cancelled/expired requests,
                   then waiting requests claim free batch slots under
                   *optimistic* admission: only the prompt's pages are
                   reserved, never the worst-case generation length,
  3. **prefill** — ONE pending sequence runs one fixed-width prompt chunk,
  4. **decode**  — every prefilled, unfinished sequence decodes one token
                   through the autotuned ``paged_decode`` kernel; a slot
                   that outgrows its pages allocates one more, and on pool
                   exhaustion a victim (latest arrival first) is preempted
                   and re-queued. A resumed request re-prefills
                   ``prompt + tokens[:-1]`` — exactly the KV it had — so
                   its greedy output equals an uninterrupted run's.
                   With ``speculative=K`` the step is a **verify** instead:
                   each slot scores its last token plus K-1 n-gram drafts
                   in one pass through ``paged_verify`` and commits the
                   matched prefix plus the model's own next token, so its
                   output equals plain greedy decoding.

The ``Scheduler`` is host-side bookkeeping over a ``PagePool`` (numpy block
tables and lengths). ``ServingEngine`` binds the port's model to it and
runs ``lm.prefill_paged`` / ``lm.decode_step_paged`` eagerly on the
device with greedy argmax and a finite-logits flag computed there, so only
token ids and one bit per slot cross to the host each step.

Not in the port: prefix caching, fault injection, kernel quarantine (and
the re-jit after a verify fault), CUDA graphs and the reference's
wall-clock replay of arrivals (``run(real_time=True)``);
``ServingEngine.run`` makes every request eligible at once.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.quant import get_policy
from repro_torch.serving.drafter import NgramDrafter
from repro_torch.serving.page_pool import SCRATCH_PAGE, PagePool

# Per-request token-timestamp cap (bounded latency bookkeeping).
TOKEN_TIMES_CAP = 4096


class RequestState(str, enum.Enum):
    """QUEUED → RUNNING ⇄ PREEMPTED, terminating in FINISHED, FAILED or
    TIMED_OUT."""

    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    PREEMPTED = "PREEMPTED"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    TIMED_OUT = "TIMED_OUT"


TERMINAL_STATES = (RequestState.FINISHED, RequestState.FAILED,
                   RequestState.TIMED_OUT)


@dataclasses.dataclass
class Request:
    """One inference request."""

    rid: int
    prompt: np.ndarray                 # (P,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0               # seconds since trace start
    deadline: Optional[float] = None   # absolute trace-clock deadline
    max_retries: int = 8               # preemption/resume budget
    # filled in by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    token_times_dropped: int = 0
    state: RequestState = RequestState.QUEUED
    failure_reason: Optional[str] = None
    retries: int = 0
    cancelled: bool = False
    wait_steps: int = 0                # admission aging (head-of-line cap)
    not_before_step: int = 0           # backoff: earliest re-admission step

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def cancel(self) -> None:
        self.cancelled = True

    def note_token_time(self, t: float) -> None:
        if len(self.token_times) < TOKEN_TIMES_CAP:
            self.token_times.append(t)
        else:
            self.token_times_dropped += 1


@dataclasses.dataclass
class _Seq:
    """Per-slot state of an admitted sequence."""

    req: Request
    pages: List[int]
    view: np.ndarray                   # tokens to prefill
    pos: int = 0                       # resident (written) valid tokens
    prompt_done: bool = False


@dataclasses.dataclass
class StepStats:
    admitted: int = 0
    retired: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    preempted: int = 0
    failed: int = 0
    timed_out: int = 0
    degraded: int = 0      # non-finite verify bursts switched to decode

    def progressed(self) -> bool:
        return bool(self.admitted or self.retired or self.prefill_tokens
                    or self.decode_tokens or self.preempted or self.failed
                    or self.timed_out or self.degraded)


def latency_summary(requests: List[Request], t0: float) -> Dict[str, Any]:
    """Exact p50/p99 TTFT and inter-token latency (ms) from the recorded
    ``Request.token_times``; TTFT is first token minus run start ``t0``."""
    ttfts: List[float] = []
    itls: List[float] = []
    dropped = 0
    for r in requests:
        ts = r.token_times
        dropped += r.token_times_dropped
        if ts:
            ttfts.append((ts[0] - t0) * 1e3)
            itls.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]))

    def pct(xs: List[float], q: float) -> Optional[float]:
        return float(np.percentile(xs, q)) if xs else None

    return {
        "ttft_p50_ms": pct(ttfts, 50),
        "ttft_p99_ms": pct(ttfts, 99),
        "itl_p50_ms": pct(itls, 50),
        "itl_p99_ms": pct(itls, 99),
        "ttft_samples": len(ttfts),
        "itl_samples": len(itls),
        "token_times_dropped": dropped,
    }


class Scheduler:
    """Slot/page bookkeeping for a continuous batch.

    ``max_batch`` concurrent sequences; each owns up to ``max_pages``
    block-table entries. Unused entries map to the scratch page so device
    index maps never branch. ``lookahead`` bounds how far past a blocked
    queue head admission may scan; after ``aging_cap`` skips of the head
    the scan reverts to strict FIFO so big requests cannot starve.
    ``spec_k`` is the speculative verify width: a decode step may scatter
    that many positions before any of them is accepted, so capacity
    checks and the oversized-request bound charge the burst.
    """

    def __init__(self, pool: PagePool, max_batch: int, max_pages: int,
                 prefill_chunk: int = 8, lookahead: int = 4,
                 aging_cap: int = 64, spec_k: int = 1):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.max_pages = int(max_pages)
        self.prefill_chunk = int(prefill_chunk)
        self.spec_k = max(1, int(spec_k))
        self.lookahead = max(1, int(lookahead))
        self.aging_cap = int(aging_cap)
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[_Seq]] = [None] * self.max_batch
        self.finished: List[Request] = []
        self._tables = np.full((self.max_batch, self.max_pages),
                               SCRATCH_PAGE, np.int32)
        self._prefill_rr = 0
        self._step = 0
        self.total_prefill_tokens = 0
        self.preemptions = 0
        self.resumes = 0
        self.failures = 0
        self.timeouts = 0

    # -- request intake ----------------------------------------------------
    def max_tokens(self, req: Request) -> int:
        """Worst-case resident tokens over the request's lifetime, including
        the longest chunk-padded resume view. Under speculation the burst
        is charged too: the deepest verify step starts one committed token
        short of the budget (pos = total - 2) and scatters spec_k
        positions, though at most one of those drafts is kept."""
        c = self.prefill_chunk
        total = req.prompt_len + req.max_new_tokens
        pad = lambda n: -(-n // c) * c          # noqa: E731
        burst = total - 2 + self.spec_k if self.spec_k > 1 else 0
        return max(pad(req.prompt_len), pad(total - 1), total, burst)

    def _prefill_view(self, req: Request) -> np.ndarray:
        """The prompt, or on resume the prompt plus every generated token
        but the last (whose KV was never written)."""
        if req.tokens:
            return np.concatenate(
                [req.prompt,
                 np.asarray(req.tokens[:-1], np.int32)]).astype(np.int32)
        return np.asarray(req.prompt, np.int32)

    def reject(self, req: Request, reason: str) -> None:
        req.state = RequestState.FAILED
        req.failure_reason = reason
        self.failures += 1
        self.finished.append(req)

    def submit(self, req: Request) -> None:
        if req.prompt_len < 1 or req.max_new_tokens < 1:
            return self.reject(req, "empty prompt or zero generation budget")
        need = self.pool.pages_for(self.max_tokens(req))
        if need > self.max_pages:
            return self.reject(
                req, f"needs {need} pages > table width {self.max_pages}")
        if need > self.pool.num_pages - 1:
            return self.reject(
                req, f"needs {need} pages > pool capacity "
                     f"{self.pool.num_pages - 1}")
        req.state = RequestState.QUEUED
        self.waiting.append(req)

    # -- retire / release --------------------------------------------------
    def retire_finished(self) -> List[Request]:
        out = []
        for b, seq in enumerate(self.slots):
            if seq is not None and seq.prompt_done and seq.req.done():
                self._release_slot(b)
                seq.req.state = RequestState.FINISHED
                self.finished.append(seq.req)
                out.append(seq.req)
        return out

    def _release_slot(self, b: int) -> None:
        self.pool.free(self.slots[b].pages)
        self._tables[b, :] = SCRATCH_PAGE
        self.slots[b] = None

    # -- lifecycle ---------------------------------------------------------
    def _finish_abnormal(self, req: Request, state: RequestState,
                         reason: str) -> None:
        req.state = state
        req.failure_reason = reason
        if state is RequestState.TIMED_OUT:
            self.timeouts += 1
        else:
            self.failures += 1
        self.finished.append(req)

    def fail_slot(self, b: int, reason: str) -> None:
        """Abort a running sequence as FAILED (non-finite logits)."""
        seq = self.slots[b]
        assert seq is not None
        self._release_slot(b)
        self._finish_abnormal(seq.req, RequestState.FAILED, reason)

    def _expired(self, req: Request, now: float) -> Optional[str]:
        if req.cancelled:
            return "cancelled"
        if (req.deadline is not None and math.isfinite(now)
                and now > req.deadline):
            return "deadline"
        return None

    def _sweep_lifecycle(self, now: float) -> None:
        """Enforce cancellation and deadlines on waiting and running
        requests (``now=inf``: cancellation only)."""
        keep: Deque[Request] = deque()
        for req in self.waiting:
            why = self._expired(req, now)
            if why is None:
                keep.append(req)
            elif why == "cancelled":
                self._finish_abnormal(req, RequestState.FAILED, "cancelled")
            else:
                self._finish_abnormal(req, RequestState.TIMED_OUT,
                                      f"deadline {req.deadline} passed")
        self.waiting = keep
        for b, seq in enumerate(self.slots):
            if seq is None:
                continue
            why = self._expired(seq.req, now)
            if why is None:
                continue
            self._release_slot(b)
            if why == "cancelled":
                self._finish_abnormal(seq.req, RequestState.FAILED,
                                      "cancelled")
            else:
                self._finish_abnormal(seq.req, RequestState.TIMED_OUT,
                                      f"deadline {seq.req.deadline} passed")

    # -- admission ---------------------------------------------------------
    def admit(self, now: float = float("inf")) -> List[int]:
        """Optimistic admission into free slots: a request enters when the
        pool covers its chunk-padded prefill view."""
        self._step += 1
        self._sweep_lifecycle(now)
        admitted = []
        head = self.waiting[0] if self.waiting else None
        for b in range(self.max_batch):
            if self.slots[b] is not None:
                continue
            if self._admit_into(b, now) is None:
                break
            admitted.append(b)
        if (self.waiting and self.waiting[0] is head and head is not None
                and head.arrival <= now
                and head.not_before_step <= self._step):
            head.wait_steps += 1
        return admitted

    def _admit_into(self, b: int, now: float) -> Optional[int]:
        if not self.waiting:
            return None
        head = self.waiting[0]
        window = 1 if head.wait_steps > self.aging_cap else min(
            self.lookahead, len(self.waiting))
        for i in range(window):
            req = self.waiting[i]
            if req.arrival > now:
                break                  # deque is arrival-ordered
            if req.not_before_step > self._step:
                continue               # preemption backoff
            if self._try_place(b, i):
                return i
        return None

    def _try_place(self, b: int, i: int) -> bool:
        req = self.waiting[i]
        view = self._prefill_view(req)
        c = self.prefill_chunk
        pages = self.pool.alloc(self.pool.pages_for(-(-len(view) // c) * c))
        if pages is None:
            return False               # pool pressure: wait / look ahead
        del self.waiting[i]
        if req.state is RequestState.PREEMPTED:
            self.resumes += 1
        req.state = RequestState.RUNNING
        req.wait_steps = 0
        self.slots[b] = _Seq(req=req, pages=pages, view=view)
        self._tables[b, :] = SCRATCH_PAGE
        self._tables[b, :len(pages)] = pages
        return True

    # -- preemption --------------------------------------------------------
    def _reclaim_one(self) -> bool:
        """Free pages by retiring a finished-but-unretired sequence, else
        preempting the latest-arrival running one. False when no sequence
        is left to take pages from."""
        for b, seq in enumerate(self.slots):
            if seq is not None and seq.prompt_done and seq.req.done():
                self._release_slot(b)
                seq.req.state = RequestState.FINISHED
                self.finished.append(seq.req)
                return True
        victim = None
        for b, seq in enumerate(self.slots):
            if seq is None:
                continue
            if victim is None or ((seq.req.arrival, seq.req.rid)
                                  > (self.slots[victim].req.arrival,
                                     self.slots[victim].req.rid)):
                victim = b
        if victim is None:
            return False
        self.preempt(victim)
        return True

    def preempt(self, b: int) -> None:
        """Evict sequence ``b``: free its pages and re-queue it in arrival
        order with exponential step backoff; past ``max_retries`` the
        request fails instead of thrashing."""
        req = self.slots[b].req
        self._release_slot(b)
        req.state = RequestState.PREEMPTED
        req.retries += 1
        self.preemptions += 1
        if req.retries > req.max_retries:
            self._finish_abnormal(
                req, RequestState.FAILED,
                f"preempted {req.retries} times > max_retries "
                f"{req.max_retries}")
            return
        req.not_before_step = self._step + min(
            1 << min(req.retries - 1, 4), 16)
        items = list(self.waiting) + [req]
        items.sort(key=lambda r: (r.arrival, r.rid))
        self.waiting = deque(items)

    def _ensure_capacity(self, b: int, n: int = 1) -> bool:
        """Grow slot ``b``'s pages to cover its next ``n`` decode writes
        (n = spec_k for a verify burst), preempting victims on pool
        exhaustion. False iff ``b`` was preempted."""
        seq = self.slots[b]
        while self.pool.pages_for(seq.pos + n) > len(seq.pages):
            pg = self.pool.alloc(1)
            if pg is None:
                if not self._reclaim_one():
                    return False
                if self.slots[b] is not seq:
                    return False       # b itself was the victim
                continue
            seq.pages.extend(pg)
            self._tables[b, len(seq.pages) - 1] = pg[0]
        return True

    # -- prefill / decode --------------------------------------------------
    def next_prefill(self) -> Optional[Tuple[int, np.ndarray, int, int]]:
        """One sequence with pending prefill (round-robin) and its next
        chunk: (slot, padded chunk (C,), start, n_valid), or None."""
        c = self.prefill_chunk
        for off in range(self.max_batch):
            b = (self._prefill_rr + off) % self.max_batch
            seq = self.slots[b]
            if seq is None or seq.prompt_done:
                continue
            self._prefill_rr = (b + 1) % self.max_batch
            start = seq.pos
            chunk = seq.view[start:start + c]
            valid = len(chunk)
            if valid < c:
                chunk = np.concatenate([chunk, np.zeros(c - valid, np.int32)])
            return b, chunk.astype(np.int32), start, valid
        return None

    def mark_prefilled(self, slot: int, n_valid: int) -> None:
        seq = self.slots[slot]
        assert seq is not None and not seq.prompt_done
        seq.pos += n_valid
        self.total_prefill_tokens += n_valid
        if seq.pos >= len(seq.view):
            seq.prompt_done = True

    def decode_mask(self, lookahead: int = 1) -> np.ndarray:
        """Decode-ready slots, after growing each slot's pages to cover
        this step's write — ``lookahead`` positions of it for a verify
        burst (which may preempt victims, so readiness is derived
        afterwards)."""
        n = max(1, int(lookahead))
        for b in range(self.max_batch):
            seq = self.slots[b]
            if seq is not None and seq.prompt_done and not seq.req.done():
                self._ensure_capacity(b, n)
        return np.array(
            [s is not None and s.prompt_done and not s.req.done()
             and self.pool.pages_for(s.pos + n) <= len(s.pages)
             for s in self.slots], bool)

    def advance_decoded(self, mask: np.ndarray) -> None:
        for b in np.nonzero(mask)[0]:
            self.slots[int(b)].pos += 1

    def commit_verify(self, b: int, accepted: int) -> None:
        """Commit a verify step for slot ``b``: ``accepted`` tokens
        (1..spec_k) were appended to the request, so ``pos`` advances by
        that many. The rejected tail's pages are kept, not freed: the next
        burst needs them again, and the engine's device block-table cache
        (keyed on rid, readiness and page count) is sound only while a
        slot's page list grows and never shrinks — a free-then-regrow
        could hand a page to another slot while a stale device table still
        maps it here. ``max_tokens`` already charges the reservation, and
        retirement or preemption releases it. Stale draft KV past ``pos``
        is harmless: the next scatter overwrites it and attention never
        reads past ``kv_len``."""
        seq = self.slots[b]
        if seq is None or not 1 <= accepted <= self.spec_k:
            raise ValueError(f"commit_verify: slot {b}, {accepted} tokens "
                             f"of a burst of {self.spec_k}")
        seq.pos += accepted

    # -- device-facing state ----------------------------------------------
    def block_tables(self) -> np.ndarray:
        return self._tables.copy()

    def lens(self) -> np.ndarray:
        return np.array([0 if s is None else s.pos for s in self.slots],
                        np.int32)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def backoff_pending(self) -> bool:
        return any(r.not_before_step > self._step for r in self.waiting)

    def check_invariants(self) -> None:
        """Pool consistency + block tables consistent with ownership."""
        self.pool.check_invariants()
        owners: Dict[int, int] = {}
        for b, seq in enumerate(self.slots):
            if seq is None:
                assert (self._tables[b] == SCRATCH_PAGE).all()
                continue
            n = len(seq.pages)
            assert list(self._tables[b, :n]) == seq.pages
            assert (self._tables[b, n:] == SCRATCH_PAGE).all()
            assert seq.pos <= n * self.pool.page_size
            assert len(set(seq.pages)) == n, "page twice in one table"
            assert seq.req.state is RequestState.RUNNING
            for p in seq.pages:
                owners[p] = owners.get(p, 0) + 1
        assert all(c == 1 for c in owners.values()), \
            "page mapped to two slots"
        for p in owners:
            assert self.pool.refcount(p) >= 1, f"page {p} mapped but free"
        for req in self.finished:
            assert req.terminal(), \
                f"request {req.rid} finished in state {req.state}"


class ServingEngine:
    """Binds the port's model to the scheduler and serves a request list.

    Decode runs every step for all ready slots; at most one prefill chunk
    runs per step. Greedy (argmax) sampling keeps runs deterministic, so
    the port's tokens can be held against the reference engine's.

    The page pools are written in place. Device block tables are cached
    keyed on each slot's (request, decode-ready, page count): a slot's page
    list only grows while it is occupied, so the same key always means the
    same page ids, and the steady decode loop uploads no tables.

    ``speculative=K`` (K >= 2) turns decode steps into draft-and-verify
    steps: each ready slot scores its last committed token plus K-1
    self-speculative n-gram drafts (``serving.drafter``, one drafter per
    request fed ``prompt + tokens``) in one ``lm.verify_step_paged`` and
    commits the longest matched prefix plus the model's own next token.
    Greedy accept makes the output token-for-token that of plain decode;
    only the number of steps changes. A non-finite verify burst commits
    nothing and switches the engine to plain decode for the rest of the
    run, so the same positions are scored again by decode.

    ``quant="kv8"`` (or ``opts.quant``) serves int8 page pools with
    per-token f32 scale pools through the int8 branches of
    ``paged_decode`` and, under speculation, ``paged_verify`` (a degraded
    engine decodes over the same pools); a ``quant`` other than
    ``opts.quant`` raises ``ValueError``. A preempted request frees its
    pages and re-prefills, so its re-quantized bytes are the ones it had;
    a rolled-back verify burst leaves int8 entries and scales past the
    accepted prefix, which the next write overwrites.

    ``record_logits`` keeps, per request, the logits row each generated
    token was taken from (host copies; for parity tests at small sizes).
    """

    def __init__(self, cfg, model, *, num_pages: int, page_size: int,
                 max_batch: int, max_seq_len: int, prefill_chunk: int = 8,
                 opts=None, quant: Optional[str] = None, device=None,
                 speculative: int = 0, record_logits: bool = False):
        from repro_torch.models import lm

        self.cfg = cfg
        self.model = model
        self.device = torch.device(device if device is not None else
                                   next(model.parameters()).device)
        self.spec_k = int(speculative) if int(speculative) >= 2 else 1
        self.pool = PagePool(num_pages, page_size)
        self.scheduler = Scheduler(
            self.pool, max_batch=max_batch,
            max_pages=self.pool.pages_for(max_seq_len),
            prefill_chunk=prefill_chunk, spec_k=self.spec_k)
        self.max_seq_len = int(max_seq_len)
        if opts is None:
            opts = lm.ForwardOpts(quant=quant)
        elif quant is not None and opts.quant != quant:
            raise ValueError(
                f"quant={quant!r} conflicts with opts.quant={opts.quant!r}")
        self.opts = opts
        policy = get_policy(opts.quant)
        if policy is not None and policy.quantizes_weights:
            raise NotImplementedError(
                f"quant={opts.quant!r}: the weight policies are not ported "
                f"to the paged engine (w8a8 serves on the dense path)")
        kv_dtype = opts.kv_dtype()
        self.cache = lm.init_paged_cache(cfg, num_pages, page_size,
                                         device=self.device,
                                         kv_dtype=kv_dtype)
        self._lm = lm
        self._dev_tables_key = None
        self._dev_tables = None
        self.decode_steps = 0          # decode_step_paged calls made
        self.verify_passes = 0         # verify_step_paged calls made
        self.spec_steps = 0            # per-slot verifies committed
        self.spec_committed = 0        # tokens those committed
        self.spec_fallbacks = 0        # non-finite verify bursts
        self._spec_disabled = False    # degraded to plain decode
        self._drafters: Dict[int, NgramDrafter] = {}
        self.logits_log: Optional[Dict[int, List[np.ndarray]]] = (
            {} if record_logits else None)

    def _sample(self, logits: torch.Tensor):
        """Greedy token ids and a finite-logits flag, on the device, then
        one small copy to the host."""
        ok = torch.isfinite(logits).all(-1)
        toks = torch.argmax(logits, -1).to(torch.int32)
        return toks.cpu().numpy(), ok.cpu().numpy()

    def _drafter(self, req: Request) -> NgramDrafter:
        """The request's drafter, fed its committed stream (prompt and
        accepted tokens only, so the stream grows append-only across
        rollbacks)."""
        d = self._drafters.get(req.rid)
        if d is None:
            d = self._drafters[req.rid] = NgramDrafter()
        d.observe(list(map(int, req.prompt)) + req.tokens)
        return d

    def _log_logits(self, req: Request, row: torch.Tensor) -> None:
        if self.logits_log is not None:
            self.logits_log.setdefault(req.rid, []).append(
                row.float().cpu().numpy())

    def _check(self, req: Request) -> bool:
        if self.scheduler.max_tokens(req) > self.max_seq_len:
            self.scheduler.reject(
                req, f"prompt {req.prompt_len} + gen {req.max_new_tokens} "
                     f"exceeds max_seq_len {self.max_seq_len}")
            return False
        return True

    def _dev_tables_for(self, mask: np.ndarray) -> torch.Tensor:
        sched = self.scheduler
        key = tuple((s.req.rid if s is not None else -1, bool(m),
                     0 if s is None else len(s.pages))
                    for s, m in zip(sched.slots, mask))
        if self._dev_tables is None or key != self._dev_tables_key:
            # Rows not decoding (idle or mid-prefill) scatter their dummy
            # token into the scratch page, not through their real tables.
            tables = sched.block_tables()
            tables[~mask] = SCRATCH_PAGE
            self._dev_tables = torch.from_numpy(tables).to(self.device)
            self._dev_tables_key = key
        return self._dev_tables

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def step(self, now: float = float("inf")) -> StepStats:
        """One scheduler iteration; returns what happened."""
        sched = self.scheduler
        lm = self._lm
        stats = StepStats()
        pre = (sched.preemptions, sched.failures, sched.timeouts)
        retired = sched.retire_finished()
        stats.retired = len(retired)
        for req in retired:
            self._drafters.pop(req.rid, None)
        stats.admitted = len(sched.admit(now))

        chunk = sched.next_prefill()
        if chunk is not None:
            b, tokens, start, valid = chunk
            logits, self.cache = lm.prefill_paged(
                self.model, self.cfg, self._to_dev(tokens[None]), self.cache,
                self._to_dev(sched.block_tables()[b:b + 1]),
                self._to_dev(np.array([start], np.int32)), self.opts)
            sched.mark_prefilled(b, valid)
            stats.prefill_tokens = valid
            seq = sched.slots[b]
            if seq.prompt_done and not seq.req.tokens:
                # The first generated token comes from the prefill logits
                # at the chunk's last valid position. (A resumed sequence
                # skips this: its next token re-enters through decode.)
                row = logits[0, valid - 1]
                toks, ok = self._sample(row[None])
                if ok[0]:
                    seq.req.tokens.append(int(toks[0]))
                    seq.req.note_token_time(time.perf_counter())
                    self._log_logits(seq.req, row)
                else:
                    sched.fail_slot(b, "non-finite prefill logits")

        speculate = self.spec_k > 1 and not self._spec_disabled
        mask = sched.decode_mask(lookahead=self.spec_k if speculate else 1)
        if mask.any() and speculate:
            self._step_verify(mask, stats)
        elif mask.any():
            toks = np.zeros((sched.max_batch, 1), np.int32)
            for b in np.nonzero(mask)[0]:
                toks[b, 0] = sched.slots[int(b)].req.tokens[-1]
            lens = sched.lens() * mask        # inactive slots -> 0
            logits, self.cache = lm.decode_step_paged(
                self.model, self.cfg, self._to_dev(toks), self.cache,
                self._dev_tables_for(mask), self._to_dev(lens), self.opts)
            self.decode_steps += 1
            next_tok, okh = self._sample(logits)
            t = time.perf_counter()
            for b in np.nonzero(mask)[0]:
                seq = sched.slots[int(b)]
                if okh[b]:
                    seq.req.tokens.append(int(next_tok[b]))
                    seq.req.note_token_time(t)
                    self._log_logits(seq.req, logits[b])
                else:
                    sched.fail_slot(int(b), "non-finite decode logits")
            sched.advance_decoded(mask & okh)
            stats.decode_tokens = int((mask & okh).sum())
        stats.preempted = sched.preemptions - pre[0]
        stats.failed = sched.failures - pre[1]
        stats.timed_out = sched.timeouts - pre[2]
        return stats

    def _step_verify(self, mask: np.ndarray, stats: StepStats) -> None:
        """One speculative step for every ready slot: scatter the last
        committed token plus K-1 drafts, score all K positions in one
        ``verify_step_paged``, and commit per slot the longest prefix of
        drafts the model agrees with plus the model's next token (1..K
        tokens, capped at the request's budget). Position t's argmax is
        what sequential decode gives after the tokens before it, so the
        output equals plain greedy decode."""
        sched = self.scheduler
        K = self.spec_k
        toks = np.zeros((sched.max_batch, K), np.int32)
        for b in np.nonzero(mask)[0]:
            req = sched.slots[int(b)].req
            toks[b, 0] = req.tokens[-1]
            toks[b, 1:] = self._drafter(req).propose(K - 1)
        lens = sched.lens() * mask            # inactive slots -> 0
        logits, self.cache = self._lm.verify_step_paged(
            self.model, self.cfg, self._to_dev(toks), self.cache,
            self._dev_tables_for(mask), self._to_dev(lens), self.opts)
        self.verify_passes += 1
        outs, ok = self._sample(logits)       # (B, K) argmax, finite flags
        okh = ok.all(-1)
        t = time.perf_counter()
        committed = 0
        for b in np.nonzero(mask & okh)[0]:
            b = int(b)
            req = sched.slots[b].req
            a = 0
            while a < K - 1 and toks[b, a + 1] == outs[b, a]:
                a += 1
            take = min(a + 1, req.max_new_tokens - len(req.tokens))
            for i in range(take):
                req.tokens.append(int(outs[b, i]))
                req.note_token_time(t)
                self._log_logits(req, logits[b, i])
            sched.commit_verify(b, take)
            committed += take
            self.spec_steps += 1
        if not okh[mask].all():
            # Non-finite verify logits: nothing is committed for those
            # slots, and plain decode scores the same positions from the
            # next step on.
            self._spec_disabled = True
            self.spec_fallbacks += 1
            stats.degraded += 1
        self.spec_committed += committed
        stats.decode_tokens = committed

    def run(self, requests: List[Request]) -> Dict[str, Any]:
        """Serve ``requests`` until every one reaches a terminal state;
        every request is eligible at once."""
        for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            if self._check(req):
                self.scheduler.submit(req)
        t0 = time.perf_counter()
        steps = 0
        stalls = 0
        while self.scheduler.has_work():
            stats = self.step()
            steps += 1
            if stats.progressed():
                stalls = 0
                continue
            if self.scheduler.backoff_pending():
                stalls += 1
                if stalls > 100_000:
                    raise RuntimeError("scheduler made no progress "
                                       "(stalled in backoff)")
                continue
            raise RuntimeError("scheduler made no progress")
        self.scheduler.retire_finished()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        gen = sum(len(r.tokens) for r in requests)
        sched = self.scheduler
        out = {
            "requests": sum(r.done() for r in requests),
            "generated_tokens": gen,
            "steps": steps,
            "decode_steps": self.decode_steps,
            "verify_passes": self.verify_passes,
            "wall_s": wall,
            "tokens_per_s": gen / max(wall, 1e-9),
            "t0": t0,
            "preemptions": sched.preemptions,
            "resumes": sched.resumes,
            "failed_requests": sum(
                r.state is RequestState.FAILED for r in requests),
            "timed_out_requests": sum(
                r.state is RequestState.TIMED_OUT for r in requests),
            "terminal_requests": sum(r.terminal() for r in requests),
            "latency": latency_summary(requests, t0),
        }
        if self.spec_k > 1:
            out["speculative"] = {
                "draft_k": self.spec_k,
                "verify_steps": self.spec_steps,
                "committed_tokens": self.spec_committed,
                "accepted_per_step": (self.spec_committed
                                      / max(1, self.spec_steps)),
                "fallbacks": self.spec_fallbacks,
                "degraded": self._spec_disabled,
            }
        return out
