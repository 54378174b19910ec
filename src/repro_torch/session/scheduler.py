"""Continuous-batching serving scheduler, ported from
``repro.session.scheduler``: the same host logic, with the reference's
``jnp`` arrays replaced by the port's device tensors.  Each decode step
copies its tokens to the host once (``.cpu()``, where the reference takes
``np.asarray``); caches and the page pool are updated in place.

The static ``generate()`` batch waits for its slowest request: a slot that
finished early keeps burning a decode lane until the whole batch drains.
This module replaces that with the serving-side analogue of the paper's
batching-dominates-utilization observation: a ``RequestQueue`` feeding a
fixed ring of ``n_slots`` cache slots, where

  * every decode step runs at FULL batch width over all active slots, each
    slot at its own position (``stepfn.make_slot_serve_step``);
  * a finished request (stop token / ``max_new_tokens``) frees its slot
    immediately;
  * queued requests are admitted mid-flight: ALL free slots are filled in
    one pass, and requests sharing a prefill width go through ONE batched
    mixed-length prefill call (right-padded rows with per-row ``lengths``
    and ``segment_ids`` = -1 on the pad tail, so the masked prefill stays on
    the flash kernel); each resulting cache row is sliced out
    (``stepfn.cache_take_slot``) and written into its slot
    (``stepfn.cache_insert_slot``) — no other slot ever stalls or recompiles;
  * admission prefills are bucketed to power-of-two prompt lengths (pad to
    the bucket, gather logits at ``lengths-1``, invalidate padded cache
    slots) on causal-attention families, so mixed-length workloads compile
    at most log2(max_len) × n_slots prefill shapes instead of one per
    distinct length.

Slot lifecycle works across a family's cache layout through its
``cache_slot_axes`` hook (the ring caches of the dense and MoE stacks,
MoE's ``pre`` layers' too).  A family without padded prefill (MoE) is not
bucketed: requests of one prompt length share an admission, which fills
their caches by the decode scan.
Greedy decode here is token-for-token identical to running each request
alone through ``generate()``, and to the reference's scheduler.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stepfn
from repro_torch.session import kvpool


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus its decode budget/stop rule."""
    rid: int
    prompt: np.ndarray                 # (P,) int32 token ids
    max_new_tokens: int
    stop_token: Optional[int] = None
    submit_time: float = 0.0
    admit_time: Optional[float] = None


@dataclasses.dataclass
class ServingStats:
    """What the serving path actually achieved on a request set."""
    requests: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0
    wall_time_s: float = 0.0
    tok_per_s: float = 0.0
    occupancy: float = 0.0             # mean active-slot fraction per decode step
    mean_queue_wait_s: float = 0.0     # submit → admission (prefill start)
    max_queue_depth: int = 0
    # memory accounting (see repro_torch.session.kvpool): stranded_fraction is the
    # mean over decode steps of 1 - live_tokens / reserved_token_capacity —
    # fixed slots reserve n_active*max_len, the paged pool only mapped pages
    stranded_fraction: float = 0.0
    prompt_tokens: int = 0             # tokens across all admitted prompts
    prefill_tokens: int = 0            # tokens actually prefilled (≤ prompt)
    # paged-pool mode only
    page_size: int = 0
    pool_pages: int = 0                # allocatable pages (excl. trash page)
    pool_occupancy: float = 0.0        # mean allocated-page fraction per step
    prefix_hits: int = 0               # admissions that shared ≥ 1 token
    prefix_hit_rate: float = 0.0       # shared prompt tokens / prompt tokens

    def __str__(self) -> str:
        return (f"ServingStats(requests={self.requests}, "
                f"tok/s={self.tok_per_s:.1f}, "
                f"occupancy={self.occupancy:.2f}, "
                f"stranded={self.stranded_fraction:.2f}, "
                f"steps={self.decode_steps}, "
                f"queue_wait={self.mean_queue_wait_s * 1e3:.1f}ms)")


def _dev(a: np.ndarray, device) -> torch.Tensor:
    """A host int array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _argmax(logits: torch.Tensor) -> np.ndarray:
    """Greedy tokens of (B, V) logits, on the host (the first maximum, as
    ``jnp.argmax`` takes)."""
    return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()


class RequestQueue:
    """FIFO admission queue; records submit times for queue-wait stats."""

    def __init__(self, clock=time.perf_counter):
        self._q: deque = deque()
        self._next_rid = 0
        self._clock = clock
        self.max_depth = 0

    def submit(self, prompt, max_new_tokens: int,
               stop_token: Optional[int] = None) -> int:
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            # an empty prompt has no position to read first-token logits from:
            # the bucketed prefill would gather at lengths-1 == -1 (wrapping
            # to a padded slot → garbage token) and the unbucketed path would
            # crash on a (1, 0) tokens array — reject at the API edge instead
            raise ValueError("prompt must contain at least one token")
        rid = self._next_rid
        self._next_rid += 1
        self._q.append(Request(rid, prompt, int(max_new_tokens), stop_token,
                               submit_time=self._clock()))
        self.max_depth = max(self.max_depth, len(self._q))
        return rid

    def pop(self) -> Request:
        return self._q.popleft()

    def push_front(self, req: Request) -> None:
        """Return a popped-but-unadmitted request to the head of the queue
        (the paged scheduler defers admissions under pool pressure)."""
        self._q.appendleft(req)

    def pending(self) -> Tuple[Request, ...]:
        return tuple(self._q)

    def __len__(self) -> int:
        return len(self._q)


@dataclasses.dataclass
class _Slot:
    """Host-side decode state of one occupied cache slot."""
    req: Request
    t: int                             # next decode position (= tokens ingested)
    last: int                          # last emitted token (next step's input)
    out: List[int]                     # prompt + generated so far
    remaining: int                     # new tokens still owed


class ContinuousBatchingScheduler:
    """Slot-based continuous batching over an ``InferenceSession``.

    ``n_slots`` is the decode batch width; ``max_len`` the per-slot cache
    length (every admitted request needs prompt + max_new_tokens ≤ max_len).
    """

    def __init__(self, session, *, n_slots: int, max_len: int,
                 bucket_prefills: bool = True, paged: bool = False,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_sharing: bool = True):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.session = session
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        # admission prefills retrace per distinct prompt shape; padding to
        # power-of-two buckets bounds the trace count at log2(max_len) on
        # families whose prefill honors batch["lengths"] (causal attention
        # stacks — see ModelFamily.supports_padded_prefill)
        self.bucket_prefills = bool(bucket_prefills) and \
            session.family.supports_padded_prefill(session.cfg)
        self._fresh = None             # immutable width-n_slots cache template
        # --- block-paged KV pool mode (repro_torch.session.kvpool) ----
        self.paged = bool(paged)
        if self.paged and not session.family.supports_paged_cache(session.cfg):
            raise ValueError(
                f"family {session.cfg.family!r} does not support the paged "
                "KV pool (supports_paged_cache is False) — recurrent/state "
                "caches stay on contiguous slots")
        self.page_size = int(page_size)
        self.n_max = -(-self.max_len // self.page_size)
        # default pool: worst case of every slot fully grown, + trash page 0
        self.n_pages = int(n_pages) if n_pages is not None \
            else 1 + self.n_slots * self.n_max
        self.prefix_sharing = bool(prefix_sharing)
        self._paged_state = None       # (PagedKVManager, device-pool holder)

    # ------------------------------------------------------------------
    def _fresh_cache(self, width: int):
        """A zeroed width-``width`` prefill cache.  Only the full-width
        template is retained, and every admission prefills into a copy of
        its first ``width`` slots: the prefill updates its caches in place,
        where the reference's returns new ones and leaves the template as it
        was."""
        if self._fresh is None:
            self._fresh = self.session.init_cache(self.n_slots, self.max_len)
        return stepfn.cache_slice_slots(self.session.cfg, self._fresh, 0, width)

    def _check_fits(self, req: Request) -> None:
        P = len(req.prompt)
        if P + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {P} + max_new {req.max_new_tokens} "
                f"exceeds scheduler max_len {self.max_len}")
        if self.paged:
            need = -(-(P + req.max_new_tokens) // self.page_size)
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request {req.rid}: needs {need} pages of "
                    f"{self.page_size} tokens but the pool only has "
                    f"{self.n_pages - 1} allocatable pages")

    def _bucket_len(self, P: int) -> int:
        """Power-of-two prefill bucket for a prompt of length ``P``, capped
        at the slot's cache length (position p and p+size would collide in
        the ring past that)."""
        assert P >= 1, "empty prompts are rejected at RequestQueue.submit"
        return min(max(1 << (P - 1).bit_length(), 16), self.max_len)

    def _admit_many(self, caches, assignments: List[Tuple[int, Request]],
                    clock) -> Tuple:
        """Batched prefill-then-insert: requests sharing a prefill width
        (their bucket, or exact length when bucketing is off) are ingested in
        ONE mixed-length prefill call — shorter prompts ride right-padded
        with per-row ``lengths`` and ``segment_ids`` (-1 on the pad tail, so
        the masked prefill stays on the flash kernel) — and each resulting
        width-1 cache row is written into its slot.  Returns
        (caches, {slot_idx: _Slot})."""
        sess = self.session
        dev = sess.device
        groups: Dict[int, List[Tuple[int, Request]]] = {}
        for slot_idx, req in assignments:
            self._check_fits(req)
            P = len(req.prompt)
            L = self._bucket_len(P) if self.bucket_prefills else P
            groups.setdefault(L, []).append((slot_idx, req))

        states: Dict[int, _Slot] = {}
        for L, items in sorted(groups.items()):
            W = len(items)
            tokens = np.zeros((W, L), np.int32)
            lengths = np.zeros((W,), np.int32)
            for j, (_, req) in enumerate(items):
                tokens[j, :len(req.prompt)] = req.prompt
                lengths[j] = len(req.prompt)
            batch = {"tokens": _dev(tokens, dev)}
            if (lengths != L).any():
                batch["lengths"] = _dev(lengths, dev)
                # real tokens get segment 0, the pad tail -1: no row ever
                # attends into its padding, on any sdpa path
                batch["segment_ids"] = _dev(
                    np.where(np.arange(L)[None] < lengths[:, None], 0, -1)
                    .astype(np.int32), dev)
            logits, group_c = sess.prefill_cache_step(
                sess.params, batch, self._fresh_cache(W))
            toks0 = _argmax(logits)
            admit_time = clock()
            for j, (slot_idx, req) in enumerate(items):
                slot_c = group_c if W == 1 else sess.take_slot(group_c, j)
                caches = sess.insert_slot(caches, slot_c, slot_idx)
                req.admit_time = admit_time
                P = len(req.prompt)
                states[slot_idx] = _Slot(
                    req=req, t=P, last=int(toks0[j]),
                    out=list(map(int, req.prompt)) + [int(toks0[j])],
                    remaining=req.max_new_tokens - 1)
        return caches, states

    @staticmethod
    def _finished(state: _Slot) -> bool:
        stop = state.req.stop_token
        return state.remaining <= 0 or (stop is not None and state.last == stop)

    # ------------------------------------------------------------------
    def run(self, queue: RequestQueue,
            clock=time.perf_counter) -> Tuple[Dict[int, np.ndarray], ServingStats]:
        """Drain ``queue``; returns ({rid: prompt+generated token array},
        ``ServingStats``)."""
        with torch.inference_mode():
            if self.paged:
                return self._run_paged(queue, clock)
            return self._run_slots(queue, clock)

    def _run_slots(self, queue: RequestQueue,
                   clock) -> Tuple[Dict[int, np.ndarray], ServingStats]:
        """The ``run()`` loop over contiguous per-slot ring caches."""
        sess = self.session
        B = self.n_slots
        # preflight: reject impossible requests before ANY decode work, so a
        # bad request can't abort a half-drained queue and lose finished
        # outputs (requests are only popped once they fit)
        for req in queue.pending():
            self._check_fits(req)
        caches = sess.init_cache(B, self.max_len)
        slots: List[Optional[_Slot]] = [None] * B
        outputs: Dict[int, np.ndarray] = {}
        waits: List[float] = []
        steps = 0
        occupied = 0
        generated = 0
        n_requests = 0
        prompt_tokens = 0
        stranded = 0.0
        t0 = clock()

        def retire(i: int):
            nonlocal generated, caches
            st = slots[i]
            outputs[st.req.rid] = np.asarray(st.out, np.int32)
            generated += len(st.out) - len(st.req.prompt)
            # reset the freed slot on device (pos → -1, state → 0): stale
            # K/V must be invalid the moment the slot is free, not only
            # after the next admission happens to overwrite it
            caches = sess.zero_slot(caches, i)
            slots[i] = None

        while len(queue) or any(s is not None for s in slots):
            # admission: ALL free slots pick up queued requests in one go —
            # same-width prompts share a single batched mixed-length prefill
            free = [i for i in range(B) if slots[i] is None]
            if free and len(queue):
                assignments = [(i, queue.pop())
                               for i in free[:min(len(free), len(queue))]]
                caches, admitted = self._admit_many(caches, assignments, clock)
                for i, st in admitted.items():
                    slots[i] = st
                    waits.append(st.req.admit_time - st.req.submit_time)
                    n_requests += 1
                    prompt_tokens += len(st.req.prompt)
                    if self._finished(st):         # stop token in prefill,
                        retire(i)                  # or max_new_tokens == 1

            active = [i for i in range(B) if slots[i] is not None]
            if not active:
                continue

            # one decode step at full batch width, per-slot positions
            toks = np.zeros((B,), np.int32)
            ts = np.zeros((B,), np.int32)
            for i in active:
                toks[i] = slots[i].last
                ts[i] = slots[i].t
            nxt, caches = sess.slot_step(sess.params, _dev(toks, sess.device),
                                         _dev(ts, sess.device), caches)
            nxt = nxt.cpu().numpy()
            steps += 1
            occupied += len(active)
            live = sum(slots[i].t for i in active)
            stranded += 1.0 - live / (len(active) * self.max_len)

            for i in active:
                st = slots[i]
                st.last = int(nxt[i])
                st.out.append(st.last)
                st.t += 1
                st.remaining -= 1
                if self._finished(st):
                    retire(i)

        wall = max(clock() - t0, 1e-9)
        stats = ServingStats(
            requests=n_requests,
            generated_tokens=generated,
            decode_steps=steps,
            wall_time_s=wall,
            tok_per_s=generated / wall,
            occupancy=occupied / (steps * B) if steps else 0.0,
            mean_queue_wait_s=float(np.mean(waits)) if waits else 0.0,
            max_queue_depth=queue.max_depth,
            stranded_fraction=stranded / steps if steps else 0.0,
            prompt_tokens=prompt_tokens,
            prefill_tokens=prompt_tokens,     # fixed slots re-prefill it all
        )
        return outputs, stats

    # ------------------------------------------------------------------
    # block-paged KV pool mode (repro_torch.session.kvpool)
    # ------------------------------------------------------------------
    def _paged(self):
        """Lazy (manager, device-pool holder) — built once and kept across
        ``run()`` calls so the prefix cache persists between request waves
        (the shared-system-prompt case)."""
        if self._paged_state is None:
            sess = self.session
            holder = {"pool": sess.init_paged_pool(self.n_pages,
                                                   self.page_size)}

            def copy_page(src: int, dst: int) -> None:
                holder["pool"] = sess.pool_copy_page(holder["pool"], src, dst)

            pool = kvpool.PagePool(self.n_pages, self.page_size)
            cache = kvpool.PrefixCache(pool) if self.prefix_sharing else None
            mgr = kvpool.PagedKVManager(pool, self.n_slots, self.n_max,
                                        prefix_cache=cache,
                                        copy_page=copy_page)
            self._paged_state = (mgr, holder)
        return self._paged_state

    def _reserve_pages(self, req: Request) -> int:
        """Worst-case page count of a request fully decoded (every shared
        page COW'd into an exclusive copy)."""
        return -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)

    def _admit_many_paged(self, mgr, holder, assignments, clock, reserved):
        """Paged admission: map pages (longest cached prefix shared, COW on
        a partial boundary page), then ONE batched suffix prefill per shared
        padded width — rows carry per-request ``hist_lens`` so mixed history
        depths share a trace.

        Admission control is by worst-case RESERVATION, not free pages: a
        request enters only when its fully-decoded page count fits next to
        every active request's (``reserved``).  That guarantee makes decode
        growth infallible — live pages never exceed the reservation sum, and
        anything else in the pool is cache-owned and evictable.  Requests
        that don't fit are handed back for re-queueing (FIFO preserved).
        Returns ({slot: _Slot}, [deferred requests], prompt_toks,
        prefill_toks, shared_toks)."""
        sess = self.session
        dev = sess.device
        ps = mgr.pool.page_size
        avail = self.n_pages - 1 - reserved
        items = []                              # (slot, req, hist)
        deferred = []
        for slot_idx, req in assignments:
            self._check_fits(req)
            need = self._reserve_pages(req)
            if deferred or need > avail:        # keep FIFO order on pressure
                deferred.append(req)
                continue
            try:
                items.append((slot_idx, req, mgr.admit(slot_idx, req.prompt,
                                                       share=self.prefix_sharing)))
                avail -= need
            except MemoryError:
                deferred.append(req)

        groups: Dict[int, List[Tuple[int, Request, int]]] = {}
        for slot_idx, req, hist in items:
            Ls = len(req.prompt) - hist
            L = min(self._bucket_len(Ls), mgr.n_max * ps - hist) \
                if self.bucket_prefills else Ls
            groups.setdefault(L, []).append((slot_idx, req, hist))

        states: Dict[int, _Slot] = {}
        prompt_toks = prefill_toks = shared_toks = 0
        for L, rows in sorted(groups.items()):
            W = len(rows)
            tokens = np.zeros((W, L), np.int32)
            hists = np.zeros((W,), np.int32)
            lens = np.zeros((W,), np.int32)
            slot_ids = np.zeros((W,), np.int64)
            for j, (slot_idx, req, hist) in enumerate(rows):
                suffix = req.prompt[hist:]
                tokens[j, :len(suffix)] = suffix
                hists[j] = hist
                lens[j] = len(suffix)
                slot_ids[j] = slot_idx
            batch = {"tokens": _dev(tokens, dev),
                     "hist_lens": _dev(hists, dev),
                     "lengths": _dev(lens, dev)}
            logits, holder["pool"] = sess.paged_prefill_step(
                sess.params, batch, holder["pool"],
                _dev(mgr.tables[slot_ids], dev))
            toks0 = _argmax(logits)
            admit_time = clock()
            for j, (slot_idx, req, hist) in enumerate(rows):
                mgr.register(slot_idx, req.prompt)  # publish for future hits
                req.admit_time = admit_time
                P = len(req.prompt)
                prompt_toks += P
                prefill_toks += P - hist
                shared_toks += hist
                states[slot_idx] = _Slot(
                    req=req, t=P, last=int(toks0[j]),
                    out=list(map(int, req.prompt)) + [int(toks0[j])],
                    remaining=req.max_new_tokens - 1)
        return states, deferred, prompt_toks, prefill_toks, shared_toks

    def _run_paged(self, queue: RequestQueue,
                   clock) -> Tuple[Dict[int, np.ndarray], ServingStats]:
        """The ``run()`` loop over the block-paged pool: admission maps
        pages instead of copying slot caches, every decode step grows each
        request by at most one page (``ensure_writable`` — the COW
        boundary), retire releases pages back to the free list."""
        sess = self.session
        B = self.n_slots
        for req in queue.pending():
            self._check_fits(req)
        mgr, holder = self._paged()
        hits0 = mgr.cache.hits if mgr.cache is not None else 0
        slots: List[Optional[_Slot]] = [None] * B
        outputs: Dict[int, np.ndarray] = {}
        waits: List[float] = []
        steps = occupied = generated = n_requests = 0
        prompt_tokens = prefill_tokens = shared_tokens = 0
        pool_occ = stranded = 0.0
        t0 = clock()

        def retire(i: int):
            nonlocal generated
            st = slots[i]
            outputs[st.req.rid] = np.asarray(st.out, np.int32)
            generated += len(st.out) - len(st.req.prompt)
            mgr.free_slot(i)        # release pages; no device zeroing needed:
            slots[i] = None         # unmapped rows are masked at read time

        while len(queue) or any(s is not None for s in slots):
            free = [i for i in range(B) if slots[i] is None]
            if free and len(queue):
                assignments = [(i, queue.pop())
                               for i in free[:min(len(free), len(queue))]]
                reserved = sum(self._reserve_pages(slots[i].req)
                               for i in range(B) if slots[i] is not None)
                admitted, deferred, ptk, ftk, stk = self._admit_many_paged(
                    mgr, holder, assignments, clock, reserved)
                for req in reversed(deferred):
                    queue.push_front(req)
                if deferred and not admitted and \
                        all(s is None for s in slots):
                    raise MemoryError(
                        f"paged pool ({self.n_pages - 1} pages of "
                        f"{self.page_size}) cannot admit request "
                        f"{deferred[0].rid} even with every slot idle — "
                        "grow n_pages or shrink max_len")
                prompt_tokens += ptk
                prefill_tokens += ftk
                shared_tokens += stk
                for i, st in admitted.items():
                    slots[i] = st
                    waits.append(st.req.admit_time - st.req.submit_time)
                    n_requests += 1
                    if self._finished(st):
                        retire(i)

            active = [i for i in range(B) if slots[i] is not None]
            if not active:
                continue

            # next write position must be mapped & exclusively owned (lazy
            # page growth + the COW copy of shared/registered pages)
            for i in active:
                mgr.ensure_writable(i, slots[i].t)

            toks = np.zeros((B,), np.int32)
            ts = np.zeros((B,), np.int32)
            for i in active:
                toks[i] = slots[i].last
                ts[i] = slots[i].t
            nxt, holder["pool"] = sess.paged_slot_step(
                sess.params, _dev(toks, sess.device), _dev(ts, sess.device),
                holder["pool"], _dev(mgr.tables, sess.device))
            nxt = nxt.cpu().numpy()
            steps += 1
            occupied += len(active)
            pool_occ += mgr.pool.n_used / (self.n_pages - 1)
            live = sum(slots[i].t for i in active)
            cap = sum(mgr.capacity_tokens(i) for i in active)
            stranded += 1.0 - live / cap if cap else 0.0

            for i in active:
                st = slots[i]
                st.last = int(nxt[i])
                st.out.append(st.last)
                st.t += 1
                st.remaining -= 1
                if self._finished(st):
                    retire(i)

        wall = max(clock() - t0, 1e-9)
        stats = ServingStats(
            requests=n_requests,
            generated_tokens=generated,
            decode_steps=steps,
            wall_time_s=wall,
            tok_per_s=generated / wall,
            occupancy=occupied / (steps * B) if steps else 0.0,
            mean_queue_wait_s=float(np.mean(waits)) if waits else 0.0,
            max_queue_depth=queue.max_depth,
            stranded_fraction=stranded / steps if steps else 0.0,
            prompt_tokens=prompt_tokens,
            prefill_tokens=prefill_tokens,
            page_size=self.page_size,
            pool_pages=self.n_pages - 1,
            pool_occupancy=pool_occ / steps if steps else 0.0,
            prefix_hits=(mgr.cache.hits - hits0 if mgr.cache is not None
                         else 0),
            prefix_hit_rate=(shared_tokens / prompt_tokens
                             if prompt_tokens else 0.0),
        )
        return outputs, stats
