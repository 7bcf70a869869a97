"""Continuous-batching serving runtime: the counterpart of
``src/repro/core/serving.py``.

A **rolling decode batch** of ``batch`` slots: requests join a free slot at
the next step boundary (prefilled into the slot's rows of a shared per-slot
KV cache) and leave the moment they finish, freeing the slot for the next
queued request.  The decode computation never changes shape: idle slots
decode dead air whose cache writes are dropped (``cache_update_decode``).

* **Decode** is always ``(batch, 1)`` tokens against the full per-slot
  cache.
* **Prefill** is bucketed: prompts are right-padded to a power-of-two
  length bucket and grouped into a power-of-two batch bucket.  The pad mask
  keeps pad keys out of every real query's softmax (so these prefills take
  the plain attention paths, as in the reference: the kernel has no pad
  mask) and ``last_pos`` gathers each row's own last-position logits.
  Recurrent families (``ssm``: RWKV, ``hybrid``: Hymba's SSM heads) scan
  their state over every position, so padding would corrupt it: they are
  bucketed by *exact* prompt length (pad-free groups, one plan entry per
  distinct length), prefill runs unmasked and a hybrid model's attention
  stays on the flash-attention kernel.  ``warmup`` needs the exact
  ``prompt_lens`` for them.  Vision-language models serve token prompts
  (M-RoPE with three equal streams); encoder-decoder models are refused
  (``check_servable``).

Prefilled caches are copied into the rolling cache slot by slot along each
leaf's batch axis (axes found once by diffing ``init_caches`` shapes at two
batch sizes, built on the ``meta`` device); the cache is walked as a pytree,
so a ``{"stack", "pre"}`` dict of ``KVCache``s (DeepSeekMoE), the hybrid
``{"kv", "ssm"}`` and an ``RWKVState`` join as a flat ``KVCache`` does.
MoE models route their pad tokens too, as the reference's do:
capacity makes a served token depend on its batch.  Dummy rows of a padded
admission group aim at slot ``batch``, out of range, and are dropped.

Two drivers.  ``"mozart"`` (the default, as the reference's): prefill and
decode are annotated opaque library calls (every argument ``_``, the return
``Unknown``) run through ``mozart.pipeline(executor="eager")``; ``warmup``
lowers and compiles each one per bucket (labelled ``("decode", batch)`` and
``("prefill", bb, lb)``), so every warm step is a plan-cache hit with zero
planner calls and zero traces, and ``plan_cache_path`` lets a restarted
replica start warm.  A warm step runs the step function exactly once: the
``eager`` executor calls it on the whole arguments, never splits or merges
its output, and has no executor below it to re-drive a failed step (the K/V
writes are in place, so a second run would write twice).  ``"jit"``:
direct calls of the torch functions (the name is kept so callers match the
reference).  Each ``step()`` crosses the ``serve_step`` fault boundary
(``core/resilience.py``); ``AsyncServer`` fails the requests in flight when
a step raises, records ``MZ405`` and keeps driving.

Latency is honest: each decode step is timed through the host read of the
argmax.  Per-request latency runs submit -> final token.

``AsyncServer`` is the async front-end: a daemon thread drives
``ContinuousBatcher.step()`` while any number of ``asyncio`` callers
``await generate(...)``.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import resilience
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

__all__ = ["ServeRequest", "ContinuousBatcher", "AsyncServer"]

#: model families whose per-position recurrence makes padded prefill
#: incorrect (the state integrates every position, real or pad): bucketed
#: by exact prompt length instead.
_PAD_FREE_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new: int
    eos: int | None = None
    out: list = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    first_token_s: float | None = None
    done_s: float | None = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    #: wall-clock budget from submit, enforced at step boundaries: an
    #: expired request frees its slot and resolves with the tokens it has,
    #: flagged ``timed_out``.
    timeout_s: float | None = None
    deadline_s: float | None = None       # absolute (perf_counter), at submit
    timed_out: bool = False
    cancelled: bool = False
    #: terminal failure (overload shed, serving-step exception): the request
    #: resolved WITHOUT completing; awaiting callers re-raise this.
    error: BaseException | None = None

    @property
    def finished(self) -> bool:
        return self.done.is_set()

    def cancel(self) -> None:
        """Request cancellation at the next step boundary (thread-safe,
        idempotent); ``done`` is then set with the partial output."""
        self.cancelled = True


def _pow2_buckets(lo: int, hi: int) -> list:
    """Powers of two covering [lo, hi]: smallest bucket >= any n in range."""
    out, b = [], max(1, lo)
    while b < hi:
        out.append(b)
        b *= 2
    out.append(b)
    return out


def _bucket_for(n: int, buckets: list) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _cache_batch_axes(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """Per-leaf batch-axis index of the per-slot cache pytree: ``init_caches``
    shapes at ``batch`` and ``batch + 1`` (on the ``meta`` device) differ in
    exactly one dim per leaf."""
    a = pytree.tree_leaves(tfm.init_caches(cfg, batch, max_len, per_slot=True, device="meta"))
    b = pytree.tree_leaves(tfm.init_caches(cfg, batch + 1, max_len, per_slot=True,
                                           device="meta"))
    axes = []
    for la, lb in zip(a, b):
        diff = [i for i, (x, y) in enumerate(zip(la.shape, lb.shape)) if x != y]
        if len(diff) != 1:
            raise ValueError(f"cache leaf {tuple(la.shape)} has no unique batch "
                             f"axis vs {tuple(lb.shape)}")
        axes.append(diff[0])
    return axes


def _make_join(axes: list):
    """Copy of a prefill-group cache into rolling-cache slots, in place.

    ``slots`` (host ints) maps group row -> rolling slot; rows whose slot is
    out of range (dummy padding rows aimed at slot ``batch``) are dropped,
    not clamped."""
    def join(roll, pref, slots: np.ndarray):
        for r, p, ax in zip(pytree.tree_leaves(roll), pytree.tree_leaves(pref), axes):
            rows = np.nonzero((slots >= 0) & (slots < r.shape[ax]))[0]
            if rows.size:
                dst = torch.as_tensor(slots[rows], dtype=torch.long, device=r.device)
                src = torch.as_tensor(rows, dtype=torch.long, device=p.device)
                r.index_copy_(ax, dst, p.index_select(ax, src).to(r.dtype))
        return roll
    return join


def _make_prefill_bucket(cfg: ModelConfig, masked: bool = True):
    """The scheduler's prefill step for one admission group.

    ``masked=True`` (attention families): prompts right-padded to the length
    bucket, a pad mask over the garbage keys and ``last_pos`` at each row's
    own last real position.  ``masked=False`` (pad-free recurrent families):
    the group is exact-length, no padding exists, and the unmasked attention
    paths (the flash-attention kernel on a card) stay eligible."""
    def prefill_bucket(p, toks: torch.Tensor, plens: torch.Tensor, caches):
        if not masked:
            return tfm.prefill(p, cfg, tokens=toks, caches=caches)
        S = toks.shape[1]
        mask = torch.arange(S, dtype=torch.int32, device=toks.device)[None, :] < plens[:, None]
        return tfm.prefill(p, cfg, tokens=toks, caches=caches, pad_mask=mask,
                           last_pos=torch.clamp(plens - 1, min=0))
    return prefill_bucket


def _annotated_steps(cfg: ModelConfig, masked: bool):
    """Scheduler prefill/decode as annotated opaque library calls."""
    from repro_torch.core import annotate
    from repro_torch.core.split_types import Unknown, _

    decode = annotate(
        lambda p, tok, caches: tfm.decode_step(p, cfg, tok, caches),
        name="sched_decode_step", ret=Unknown(), p=_, tok=_, caches=_)
    prefill = annotate(
        _make_prefill_bucket(cfg, masked),
        name="sched_prefill_bucket", ret=Unknown(), p=_, toks=_, plens=_, caches=_)
    return prefill, decode


#: per-call pipeline counters the batcher sums (all 0 on a warm step).
DELTA_KEYS = ("planner_calls", "jit_traces", "autotuned_stages", "auto_measured_stages")


def check_driver(driver: str) -> None:
    if driver not in ("mozart", "jit"):
        raise ValueError(f"unknown driver {driver!r}")


def check_servable(cfg: ModelConfig) -> None:
    """Refuse an encoder-decoder model: its requests carry an encoder input
    that the token-prompt batchers have no place for.  (The reference
    fails later, with an ``AttributeError``, when its decode step encodes
    ``None``.)"""
    if cfg.encdec:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder model is not served by the batchers; the "
            f"reference serves such models only through prefill(enc_embeds=...) and "
            f"decode_step(enc_out=...)")


class ContinuousBatcher:
    """Rolling decode batch with step-boundary admission.

    Single-driver: ``step()`` (and ``run``/``warmup``) must be called from
    one thread at a time; ``submit()`` is thread-safe."""

    def __init__(self, cfg: ModelConfig, params, batch: int, max_len: int,
                 driver: str = "mozart", prompt_buckets: list | None = None,
                 plan_cache_path: str | None = None, max_queue: int | None = None,
                 device: torch.device | str = "cuda"):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        check_driver(driver)
        check_servable(cfg)
        self.device = torch.device(device)
        wdev = next(iter(params.parameters())).device
        if wdev.type != self.device.type:
            raise ValueError(f"parameters lie on {wdev}, the batcher serves on {device}")
        self.max_queue = max_queue
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.driver = driver
        self.pad_free = cfg.family in _PAD_FREE_FAMILIES
        self.prompt_buckets = sorted(prompt_buckets) if prompt_buckets else None
        self.batch_buckets = _pow2_buckets(1, batch)

        self.slots: list = [None] * batch
        self.caches = self._init_caches(batch)
        self._tok = np.zeros((batch, 1), np.int32)
        self._queue: collections.deque = collections.deque()
        self._qlock = threading.Lock()
        self._rids = itertools.count()

        self.stats: collections.Counter = collections.Counter()
        self.decode_lat_s: list = []
        self.request_lat_s: list = []
        self.occupancy: list = []

        self._join = _make_join(_cache_batch_axes(cfg, batch, max_len))
        if driver == "mozart":
            from repro_torch.core import mozart
            prefill_fn, decode_fn = _annotated_steps(cfg, masked=not self.pad_free)
            self._prefill = mozart.pipeline(prefill_fn, executor="eager", device=self.device,
                                            plan_cache_path=plan_cache_path)
            self._decode = mozart.pipeline(decode_fn, executor="eager", device=self.device,
                                           plan_cache_path=plan_cache_path)
        else:
            self._prefill = _make_prefill_bucket(cfg, masked=not self.pad_free)
            self._decode = lambda p, tok, caches: tfm.decode_step(p, cfg, tok, caches)

    def _init_caches(self, batch: int):
        return tfm.init_caches(self.cfg, batch, self.max_len, per_slot=True,
                               device=self.device)

    # -- driver dispatch -----------------------------------------------------
    def _call(self, step, *args):
        """``(outputs, stats delta)`` of one prefill or decode step."""
        if self.driver == "mozart":
            return step.call_with_stats(self.params, *args)
        return step(self.params, *args), {}

    def _call_prefill(self, toks: np.ndarray, plens: np.ndarray, caches):
        return self._call(self._prefill, torch.as_tensor(toks, device=self.device),
                          torch.as_tensor(plens, device=self.device), caches)

    def _call_decode(self, tok: np.ndarray, caches):
        return self._call(self._decode, torch.as_tensor(tok, device=self.device), caches)

    def _note_delta(self, delta: dict) -> None:
        for k in DELTA_KEYS:
            if delta.get(k, 0):
                self.stats[k] += delta[k]

    # -- admission -----------------------------------------------------------
    def submit(self, req: ServeRequest) -> ServeRequest:
        """Thread-safe enqueue.  A full bounded queue SHEDS the request: it
        resolves at once with ``req.error`` set (never hangs, never silently
        drops)."""
        if req.max_new < 1:
            raise ValueError(f"rid {req.rid}: max_new must be >= 1")
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"rid {req.rid}: prompt + max_new exceeds max_len "
                f"({len(req.prompt)} + {req.max_new} > {self.max_len})")
        req.submitted_s = time.perf_counter()
        if req.timeout_s is not None:
            req.deadline_s = req.submitted_s + req.timeout_s
        with self._qlock:
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                req.error = RuntimeError(
                    f"rid {req.rid}: admission queue full "
                    f"({self.max_queue}); request shed")
                self.stats["shed_requests"] += 1
                req.done.set()
                return req
            self._queue.append(req)
        return req

    def _bucket_len(self, plen: int) -> int:
        if self.pad_free:
            return plen                      # exact length: no padding at all
        if self.prompt_buckets:
            return _bucket_for(plen, self.prompt_buckets)
        return _pow2_buckets(1, plen)[-1]

    def _admit(self) -> None:
        while self._admit_once():
            pass

    def _admit_once(self) -> int:
        """Admit one same-length-bucket group into free slots; 0 = nothing."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return 0
        group: list = []
        with self._qlock:
            if not self._queue:
                return 0
            lb = self._bucket_len(len(self._queue[0].prompt))
            kept: collections.deque = collections.deque()
            while self._queue and len(group) < len(free):
                r = self._queue.popleft()
                if self._bucket_len(len(r.prompt)) == lb:
                    group.append(r)
                else:
                    kept.append(r)
            while kept:                       # preserve arrival order
                self._queue.appendleft(kept.pop())
        if not group:
            return 0

        bb = _bucket_for(len(group), self.batch_buckets)
        toks = np.zeros((bb, lb), np.int32)
        plens = np.ones((bb,), np.int32)      # dummy rows: 1-token prompt
        slots = np.full((bb,), self.batch, np.int32)   # default: dropped
        for i, r in enumerate(group):
            toks[i, : len(r.prompt)] = r.prompt
            plens[i] = len(r.prompt)
            slots[i] = free[i]

        t0 = time.perf_counter()
        (logits, pref_caches), delta = self._call_prefill(toks, plens, self._init_caches(bb))
        first = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        self.caches = self._join(self.caches, pref_caches, slots)
        del pref_caches
        dt = time.perf_counter() - t0

        self.stats["prefill_calls"] += 1
        self.stats["prefill_s_x1e6"] += int(dt * 1e6)
        self._note_delta(delta)
        now = time.perf_counter()
        for i, r in enumerate(group):
            s = int(slots[i])
            t = int(first[i])
            self.slots[s] = r
            r.first_token_s = now
            r.out.append(t)
            self._tok[s, 0] = t
            self.stats["tokens"] += 1
            self._retire_if_done(r, s, now)
        return len(group)

    # -- decode --------------------------------------------------------------
    def _retire_if_done(self, r: ServeRequest, slot: int, now: float) -> None:
        if len(r.out) >= r.max_new or (r.eos is not None and r.out[-1] == r.eos):
            r.done_s = now
            self.request_lat_s.append(now - r.submitted_s)
            self.slots[slot] = None
            self.stats["completed"] += 1
            r.done.set()

    def _decode_once(self) -> bool:
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return False
        t0 = time.perf_counter()
        (logits, new_caches), delta = self._call_decode(self._tok, self.caches)
        tok = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(np.int32)
        dt = time.perf_counter() - t0        # through the host read: honest
        self.caches = new_caches
        self.decode_lat_s.append(dt)
        self.occupancy.append(len(active))
        self.stats["decode_steps"] += 1
        self._note_delta(delta)
        now = time.perf_counter()
        for i, r in active:
            t = int(tok[i])
            r.out.append(t)
            self._tok[i, 0] = t
            self.stats["tokens"] += 1
            self._retire_if_done(r, i, now)
        return True

    # -- deadlines / cancellation / failure domains --------------------------
    def _expire(self, r: ServeRequest, now: float) -> None:
        """Resolve a deadline-expired or cancelled request with its partial
        output (its slot or queue place already released by the caller)."""
        if r.cancelled:
            self.stats["cancelled_requests"] += 1
        else:
            r.timed_out = True
            self.stats["timed_out_requests"] += 1
        r.done_s = now
        r.done.set()

    def _sweep_expired(self) -> None:
        """Step-boundary enforcement of deadlines and cancellation: expired
        queued requests leave the queue, expired active requests free their
        slot (the next ``_admit`` refills it) and keep their partial output."""
        now = time.perf_counter()

        def expired(r: ServeRequest) -> bool:
            return r.cancelled or (r.deadline_s is not None and now >= r.deadline_s)

        with self._qlock:
            gone = [r for r in self._queue if expired(r)]
            if gone:
                self._queue = collections.deque(r for r in self._queue if not expired(r))
        for r in gone:
            self._expire(r, now)
        for i, r in enumerate(self.slots):
            if r is not None and expired(r):
                self.slots[i] = None
                self._expire(r, now)

    def fail_pending(self, exc: BaseException) -> int:
        """Resolve EVERY in-flight request (active slots + queue) with
        ``exc``: after a step exception nothing may stay blocked on
        ``done.wait``.  Returns the number of requests failed."""
        with self._qlock:
            doomed = list(self._queue)
            self._queue.clear()
        for i, r in enumerate(self.slots):
            if r is not None:
                self.slots[i] = None
                doomed.append(r)
        now = time.perf_counter()
        for r in doomed:
            r.error = exc
            r.done_s = now
            self.stats["failed_requests"] += 1
            r.done.set()
        return len(doomed)

    def step(self) -> bool:
        """Sweep deadlines and cancellations, admit at the step boundary,
        then decode once; False when idle."""
        resilience.maybe_fail("serve_step")
        self._sweep_expired()
        self._admit()
        return self._decode_once()

    # -- warmup --------------------------------------------------------------
    def warmup(self, max_prompt_len: int | None = None,
               prompt_lens: list | None = None) -> None:
        """Pin every (batch, length) bucket's prefill and the decode step
        ahead of serving: with the ``mozart`` driver each is lowered and
        compiled (one plan entry per bucket, labelled), with ``jit`` run
        once (allocator and library warm-up).  For pad-free (recurrent)
        families pass ``prompt_lens``, the exact lengths expected; otherwise
        ``max_prompt_len`` bounds the pow-2 length buckets (default: the
        largest bucket under ``max_len``).  The serving counters start clean
        afterwards: warm steps after this point must add zero planner calls
        and traces."""
        if self.pad_free:
            len_buckets = sorted(set(prompt_lens or []))
            if not len_buckets:
                raise ValueError(f"{self.cfg.family} prefill is pad-free: warmup needs "
                                 "the exact prompt_lens it will serve")
        else:
            if self.prompt_buckets is None:
                hi = max_prompt_len or max(1, self.max_len - 1)
                self.prompt_buckets = _pow2_buckets(8, hi)
            len_buckets = self.prompt_buckets
        mozart = self.driver == "mozart"
        tok = torch.zeros((self.batch, 1), dtype=torch.int32, device=self.device)
        if mozart:
            self._decode.lower(self.params, tok, self._init_caches(self.batch))
            self._decode.compile(bucket=("decode", self.batch))
        (logits, _), _d = self._call_decode(tok, self._init_caches(self.batch))
        torch.argmax(logits[:, -1], dim=-1).cpu()
        for bb in self.batch_buckets:
            for lb in len_buckets:
                toks = torch.zeros((bb, lb), dtype=torch.int32, device=self.device)
                plens = torch.full((bb,), min(lb, 2), dtype=torch.int32, device=self.device)
                if mozart:
                    self._prefill.lower(self.params, toks, plens, self._init_caches(bb))
                    self._prefill.compile(bucket=("prefill", bb, lb))
                else:
                    self._call_prefill(toks, plens, self._init_caches(bb))
            # every row aims at slot ``batch``: all dropped
            self.caches = self._join(self.caches, self._init_caches(bb),
                                     np.full((bb,), self.batch, np.int32))
        for k in DELTA_KEYS:
            self.stats.pop(k, None)

    # -- batch front-end -----------------------------------------------------
    def reset_metrics(self) -> None:
        """Zero the per-run counters (stats, latency samples, occupancy)."""
        self.stats.clear()
        self.decode_lat_s.clear()
        self.request_lat_s.clear()
        self.occupancy.clear()

    def run(self, requests: list) -> dict:
        """Serve a request list to completion; returns the summary stats
        (counters reset on entry, so a reused batcher reports this run)."""
        self.reset_metrics()
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while True:
            try:
                busy = self.step()
            except Exception as e:
                # the error propagates, but every in-flight request
                # resolves first: nothing hangs
                self.fail_pending(e)
                raise
            if not busy:
                with self._qlock:
                    if not self._queue:
                        break
        return self.summary(time.perf_counter() - t0)

    def summary(self, wall_s: float) -> dict:
        def pct(xs, p):
            if not xs:
                return 0.0
            ys = sorted(xs)
            return ys[min(len(ys) - 1, int(round(p / 100 * (len(ys) - 1))))]

        toks = int(self.stats["tokens"])
        out = {
            "wall_s": wall_s,
            "tokens": toks,
            "tokens_per_s": toks / max(wall_s, 1e-9),
            "decode_steps": int(self.stats["decode_steps"]),
            "decode_us_per_call": (sum(self.decode_lat_s) * 1e6
                                   / max(len(self.decode_lat_s), 1)),
            "decode_p50_us": pct(self.decode_lat_s, 50) * 1e6,
            "decode_p99_us": pct(self.decode_lat_s, 99) * 1e6,
            "request_p50_ms": pct(self.request_lat_s, 50) * 1e3,
            "request_p99_ms": pct(self.request_lat_s, 99) * 1e3,
            "mean_occupancy": sum(self.occupancy) / max(len(self.occupancy), 1),
            "prefill_calls": int(self.stats["prefill_calls"]),
            "completed": int(self.stats["completed"]),
            "timed_out": int(self.stats["timed_out_requests"]),
            "cancelled": int(self.stats["cancelled_requests"]),
            "shed": int(self.stats["shed_requests"]),
            "failed": int(self.stats["failed_requests"]),
            "planner_calls": int(self.stats["planner_calls"]),
            "jit_traces": int(self.stats["jit_traces"]),
        }
        out["warm"] = out["planner_calls"] == 0 and out["jit_traces"] == 0
        if self.driver == "mozart":
            out["buckets"] = sorted(list(self._prefill.buckets) + list(self._decode.buckets))
        return out

    def make_request(self, prompt, max_new: int, eos: int | None = None,
                     timeout_s: float | None = None) -> ServeRequest:
        return ServeRequest(rid=next(self._rids), prompt=np.asarray(prompt, np.int32),
                            max_new=max_new, eos=eos, timeout_s=timeout_s)


class AsyncServer:
    """``asyncio`` front-end: a daemon thread drives the batcher's steps
    while any number of coroutines await ``generate()``."""

    def __init__(self, batcher: ContinuousBatcher, idle_poll_s: float = 1e-3):
        self.batcher = batcher
        self.idle_poll_s = idle_poll_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "AsyncServer":
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="serving-driver")
        self._thread.start()
        return self

    def _drive(self) -> None:
        # The driver thread must survive ANY step exception, or every
        # awaiting coroutine blocks on ``done.wait`` forever: a failing step
        # fails exactly the requests in flight and the thread keeps driving.
        while not self._stop.is_set():
            try:
                busy = self.batcher.step()
            except Exception as e:    # route into requests, never die silent
                n = self.batcher.fail_pending(e)
                self.batcher.stats["step_failures"] += 1
                resilience.record_event(
                    "MZ405", f"serving step failed ({type(e).__name__}: "
                             f"{e}); {n} requests failed")
                continue
            if not busy:
                time.sleep(self.idle_poll_s)

    async def generate(self, prompt, max_new: int, eos: int | None = None,
                       timeout_s: float | None = None) -> list:
        """Generate tokens for one prompt; resolves when the request leaves
        the batcher.  ``timeout_s`` bounds the wait (partial output,
        ``timed_out`` on the request); if even that never resolves (wedged
        driver), the await gives up shortly after and cancels the request.
        Raises the request's error (shed / step failure) if it failed."""
        req = self.batcher.make_request(prompt, max_new, eos=eos, timeout_s=timeout_s)
        self.batcher.submit(req)
        loop = asyncio.get_running_loop()
        if timeout_s is None:
            await loop.run_in_executor(None, req.done.wait)
        else:
            # grace past the deadline for the step-boundary sweep to run
            resolved = await loop.run_in_executor(None, req.done.wait, timeout_s + 5.0)
            if not resolved:
                req.cancel()
                await loop.run_in_executor(None, req.done.wait, 5.0)
                if not req.done.is_set():
                    raise TimeoutError(
                        f"rid {req.rid}: driver did not resolve the request "
                        f"within its deadline (thread wedged?)")
        if req.error is not None:
            raise req.error
        return list(req.out)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def __enter__(self) -> "AsyncServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
