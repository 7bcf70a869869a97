"""Batched serving driver: prefill + decode with a request queue; the
counterpart of ``src/repro/launch/serve.py``.

Two scheduling modes:

* ``--mode continuous`` (default): ``Server.run`` rides the continuous
  batcher (``repro_torch.core.serving``): requests join a rolling decode
  batch at step boundaries and leave the moment they finish.
* ``--mode fixed``: the fixed-group batcher (baseline): requests are grouped
  into fixed decode batches and each group drains fully before the next is
  admitted.  Prompts are left-padded to the group's longest prompt and
  prefill masks the pad keys out of every attention softmax.

Two drivers, orthogonal to the mode:

* ``--driver jit``: direct calls of the torch prefill and decode steps.
* ``--driver mozart``: prefill and decode are annotated library calls run
  through ``mozart.pipeline(executor="eager")``, lowered and compiled ahead
  of the request loop, so every decode step is a warm pipeline call (zero
  planner calls, zero traces).  ``--plan-cache`` (or ``MOZART_PLAN_CACHE``)
  persists the plans, so a restarted replica's first step is planned.

``decode_us_per_call`` is honest per-step latency: the timer spans the
decode AND the host read of the sampled token.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b --smoke --device cpu \
        --driver mozart --plan-cache plans.json
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import mozart
from repro_torch.core.serving import (ContinuousBatcher, ServeRequest, check_driver,
                                      check_servable)
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _mozart_steps(cfg: ModelConfig):
    """Prefill and decode as opaque annotated library calls for the pipeline
    API: every argument broadcasts (``_``: whole-model state, not rows) and
    the return is ``Unknown`` (logits and caches), so each step is its own
    stage running the unmodified function.  What the pipeline adds over a
    direct call is the lifecycle: the plan is resolved before the request
    loop and persists through the plan cache."""
    from repro_torch.core import annotate
    from repro_torch.core.split_types import Unknown, _

    decode = annotate(
        lambda p, tok, caches: tfm.decode_step(p, cfg, tok, caches),
        name="serve_decode_step", ret=Unknown(), p=_, tok=_, caches=_)
    prefill = annotate(
        lambda p, toks, mask, caches: tfm.prefill(p, cfg, tokens=toks, caches=caches,
                                                  pad_mask=mask),
        name="serve_prefill", ret=Unknown(), p=_, toks=_, mask=_, caches=_)
    return prefill, decode


class Server:
    def __init__(self, cfg: ModelConfig, params, batch: int, max_len: int,
                 driver: str = "jit", plan_cache_path: str | None = None,
                 mode: str = "continuous", device: torch.device | str = "cuda"):
        check_driver(driver)
        check_servable(cfg)
        if mode not in ("continuous", "fixed"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.driver = driver
        self.mode = mode
        self.device = torch.device(device)
        self._batcher = None
        if mode == "continuous":
            self._batcher = ContinuousBatcher(cfg, params, batch, max_len, driver=driver,
                                              plan_cache_path=plan_cache_path, device=device)
        elif driver == "mozart":
            prefill_fn, decode_fn = _mozart_steps(cfg)
            self._prefill = mozart.pipeline(prefill_fn, executor="eager", device=self.device,
                                            plan_cache_path=plan_cache_path)
            self._decode = mozart.pipeline(decode_fn, executor="eager", device=self.device,
                                           plan_cache_path=plan_cache_path)
        else:
            self._prefill = lambda p, toks, mask, caches: tfm.prefill(
                p, cfg, tokens=toks, caches=caches, pad_mask=mask)
            self._decode = lambda p, tok, caches: tfm.decode_step(p, cfg, tok, caches)

    def warmup(self, prompt_len: int, prompt_lens: list | None = None) -> None:
        """Before the first request: the continuous batcher pins its buckets
        (a pad-free batcher, the recurrent families', one per exact length:
        ``prompt_lens``, default ``[prompt_len]``); the fixed groups'
        pipelines (driver ``mozart``) are lowered and compiled at a full
        group of ``prompt_len`` tokens."""
        if self.mode == "continuous":
            if self._batcher.pad_free:
                self._batcher.warmup(prompt_lens=prompt_lens or [prompt_len])
            else:
                self._batcher.warmup(max_prompt_len=prompt_len)
            return
        if self.driver != "mozart":
            return
        dev = self.device
        caches = tfm.init_caches(self.cfg, self.batch, self.max_len, device=dev)
        toks = torch.zeros((self.batch, prompt_len), dtype=torch.int32, device=dev)
        mask = torch.ones((self.batch, prompt_len), dtype=torch.bool, device=dev)
        _logits, caches = self._prefill.lower(self.params, toks, mask, caches).compile()(
            self.params, toks, mask, caches)
        tok = torch.zeros((self.batch, 1), dtype=torch.int32, device=dev)
        self._decode.lower(self.params, tok, caches).compile()

    def run(self, requests: list[Request]) -> dict:
        if self.mode == "continuous":
            return self._run_continuous(requests)
        return self._run_fixed(requests)

    def _run_continuous(self, requests: list[Request]) -> dict:
        sreqs = [ServeRequest(rid=r.rid, prompt=np.asarray(r.prompt, np.int32),
                              max_new=r.max_new) for r in requests]
        stats = self._batcher.run(sreqs)
        for r, s in zip(requests, sreqs):
            r.out[:] = s.out
            r.done = True
        if self.driver == "mozart":
            stats["decode_warm"] = self._batcher._decode.warm()
            stats["decode_last_call"] = self._batcher._decode.last_call_stats
        return stats

    def _run_fixed(self, requests: list[Request]) -> dict:
        t0 = time.time()
        queue = list(requests)
        tokens_out = 0
        decode_calls = 0
        decode_s = 0.0
        dev = self.device
        while queue:
            group = queue[: self.batch]
            queue = queue[self.batch:]
            while len(group) < self.batch:            # pad group to fixed batch
                group.append(Request(rid=-1, prompt=group[0].prompt,
                                     max_new=group[0].max_new))
            plen = max(len(r.prompt) for r in group)
            # left-pad to the group's longest prompt; the mask keeps the pad
            # keys out of every attention softmax and out of the KV cache's
            # valid span (True = real token).
            prompts = np.stack([np.pad(r.prompt, (plen - len(r.prompt), 0))
                                for r in group])
            mask = np.stack([np.arange(plen) >= plen - len(r.prompt) for r in group])
            caches = tfm.init_caches(self.cfg, self.batch, self.max_len, device=dev)
            logits, caches = self._prefill(
                self.params, torch.as_tensor(prompts, dtype=torch.int32, device=dev),
                torch.as_tensor(mask, device=dev), caches)
            tok_host = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(np.int32)
            steps = max(r.max_new for r in group)
            for _ in range(steps):
                for r, t in zip(group, tok_host):
                    if r.rid >= 0 and not r.done:
                        r.out.append(int(t))
                        tokens_out += 1
                        if len(r.out) >= r.max_new:
                            r.done = True
                # time through the host read of the sampled token
                td = time.perf_counter()
                logits, caches = self._decode(
                    self.params, torch.as_tensor(tok_host[:, None], device=dev), caches)
                tok_host = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(np.int32)
                decode_s += time.perf_counter() - td
                decode_calls += 1
        wall = time.time() - t0
        stats = {"wall_s": wall, "tokens": tokens_out,
                 "tokens_per_s": tokens_out / max(wall, 1e-9),
                 "decode_us_per_call": decode_s * 1e6 / max(decode_calls, 1)}
        if self.driver == "mozart":
            stats["decode_warm"] = self._decode.warm()
            stats["decode_last_call"] = self._decode.last_call_stats
        return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--driver", choices=("jit", "mozart"), default="jit")
    ap.add_argument("--mode", choices=("continuous", "fixed"), default="continuous")
    ap.add_argument("--plan-cache", default=None,
                    help="plan-cache path for --driver mozart (also honours "
                         "MOZART_PLAN_CACHE)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = tfm.init_model(cfg, gen, args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new=args.max_new)
            for i in range(args.requests)]
    srv = Server(cfg, params, args.batch, max_len=args.prompt_len + args.max_new + 1,
                 driver=args.driver, plan_cache_path=args.plan_cache, mode=args.mode,
                 device=args.device)
    srv.warmup(args.prompt_len)
    stats = srv.run(reqs)
    print(f"served {stats['tokens']} tokens in {stats['wall_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s, "
          f"{stats['decode_us_per_call']:.0f}us/decode, driver={args.driver}, "
          f"mode={args.mode}, device={args.device})")
    if args.mode == "continuous":
        print(f"decode p50={stats['decode_p50_us']:.0f}us "
              f"p99={stats['decode_p99_us']:.0f}us  "
              f"request p50={stats['request_p50_ms']:.1f}ms "
              f"p99={stats['request_p99_ms']:.1f}ms  "
              f"occupancy={stats['mean_occupancy']:.2f}")
    if args.driver == "mozart":
        print(f"decode warm={stats['decode_warm']} last_call={stats['decode_last_call']}")


if __name__ == "__main__":
    main()
