"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --rmsnorm-compare OLD.cu   # also time another
                                   # version of csrc/rmsnorm.cu beside it
    python3 chip_smoke.py --split-pipeline-compare OLD.cu   # and an older
                                   # csrc/split_pipeline.cu (its parameter
                                   # block before persistent CTAs)

Phases (any failure exits nonzero; nothing runs on the CPU instead):

1. build   — build the split-pipeline, fused AdamW, flash-attention and
             RMSNorm kernels from the checkout's sources (one ``nvcc`` each
             for sm_90a, started together) and print their paths, build
             seconds, the compiler's register reports and the card's name
             and power limit;
2. kernel  — hold the split-pipeline kernel against its plain version:
             the lowered Black-Scholes, Haversine and quickstart programs at
             their main-path sizes, every opcode (result stored and
             forwarded), the Haversine program at n in {1, 15, 16, 1023,
             1024, 1025, 100003, 2**27 + 3} and on views one element off the
             16-byte grid, bool inputs and outputs on ragged n, a program at
             the 56-row limit and one of 16 inputs and 12 outputs (each case
             with its geometry and the tiles per load path), and
             add/max/min reductions at n in {1, 1500, 1000003, 2**27} (mul
             at n <= 4096, values near 1);
3. main    — ``mozart.session(executor="cuda")`` on Black-Scholes and
             Haversine at n = 2**27 and on the quickstart chain: every stage
             on the kernel, the launch count moved, outputs equal to the
             ``eager`` executor on the card and to the float64 numpy oracle
             on a 2**20 prefix; then the ``scan`` executor on Black-Scholes
             and Haversine, held to the same;
   dtypes  — the split pipeline at every dtype the Pallas kernel takes
             (ROADMAP B1) and 64-bit inputs narrowed (C9): Black-Scholes
             and Haversine at n = 2**27 in bfloat16, then float16, every
             stage on the kernel, outputs against ``eager`` and the float64
             oracle (the same half-rounded inputs, a 2**20 prefix) within
             2e-2 / 2e-3 of max|ref| (Haversine's asin(sqrt(a)) near a = 1
             given four roundings of ``a`` beyond that, ``hv_slack``); the
             hash bucketing chain ``mod(add(multiply(ids, 40503), 12345),
             1024)`` with ``sum(equal(b, 7))`` and ``max(b)`` on int64 ids,
             which reach the kernel as int32, equal to ``eager``; a uint8
             and an int16 chain that wrap, with their uint32 and int32 sums,
             at n in {1, 1000, 70001, 2**27 + 3}; Black-Scholes from float64
             inputs bit-equal to the float32 run; each launch held in place
             against its plain version (integers equal, halves within one
             ulp), timed (``torch.profiler``) beside its bytes bound and the
             plain version, and the float32 programs re-timed on the typed
             kernel;
   rewrite — the static rewrite pass (on by default) against
             ``rewrite=False``: Black-Scholes and Haversine at n = 2**27 on
             ``cuda`` (outputs bit-equal, equal to ``eager`` and the float64
             oracle, the MZ5xx records the CPU tests find, 31 against 32
             lowered instructions on Black-Scholes, the kernel's device time
             on both programs, the off program against its plain version),
             and the reference's ``smoke/rewrite`` chain at n = 2**26 (a dead
             8 x 2**26 ``matvec``, a repeated ``exp``, a ``compress`` to push
             down) on ``cuda`` and ``fused``: MZ501/502/503, fewer calls
             (and, on ``fused``, fewer interior bytes) with the pass on,
             bit-equal outputs, a warm third call with no planning, trace,
             lowering or build;
   handoff — the reference's ``smoke/handoff`` chain on the card: three
             evaluations of ``multiply(add(x, 1.0), 0.5)`` at n = 2**27
             float32 with ``mozart.evaluate()`` between them, on ``fused``,
             ``scan`` and ``cuda`` (whose first evaluation runs on ``fused``
             and is then reconfigured, as the reference's ``pallas`` row:
             a kernel stage merges its own outputs), each with handoff on and
             off, after two warm-up runs of each (the plan cache is on: the
             first hit tunes, so the checked run replays pinned plans with
             zero planner calls): on equals off (rtol 2e-5), zero interior
             bytes with handoff on, streamed outputs and stream ingests, less
             boundary traffic than with handoff off, and on ``cuda`` both
             stages on the kernel (2 launches); prints the ingest path
             counts, the host-clock medians of on and off (warm), the chip
             constants from the card's properties, the batch they chose and
             the batches and tiles the tuner pinned, and times the kernel on
             the chain's stage;
   plans   — the plan cache, the cost model and ``mozart.pipeline``: the
             handoff chain once more on ``fused``, ``scan`` and ``cuda``
             (every evaluation with zero planner calls and zero interior
             bytes); ``mozart.pipeline(fn, executor="cuda")`` on
             Black-Scholes and Haversine at n = 2**27, ``lower()``,
             ``compile()`` and 10 calls, each with zero planner calls,
             traces, lowerings and builds, one launch per stage, no fallback
             stage and outputs equal to ``eager`` and the float64 oracle;
             host-clock medians and quartiles of a cold session evaluation
             (plan cache cleared), a warm one and a pipeline call beside the
             kernel's device time (the host share is the difference), and of
             an ``arg_transparent`` pipeline's call (the retained replay: no
             capture and no cache lookup, held to the same checks), with a
             ``cProfile`` of a warm session evaluation and of a pipeline call;
             ``executor="auto"`` (every candidate timed on one sample size): the first hit measures and pins ``cuda``
             on every eligible stage (the picks and measured seconds are
             printed), warm calls measure and plan nothing; and a warm start
             from a saved plan file (save, clear, load, one ``auto``
             session with zero planner calls, tuning and measurement runs);
             warm sessions and pipeline calls with ``rewrite=False`` timed in
             the same rounds (the pass's host cost);
   chaos   — the reference's ``smoke/chaos``: ``compile:fail:1`` on a
             Black-Scholes ``mozart.pipeline(executor="cuda")`` at 2**27
             (the reference's walk ``cuda -> sharded -> scan``, ``cuda`` and
             ``sharded`` quarantined, the warm calls within
             ``QUARANTINE_TTL`` = 3 on ``scan`` with no launch, then the
             kernel again, equal to its plain version), ``chunk:oom:1`` on
             the handoff chain on ``fused`` (bounded halvings, the
             fault-free answer), and ``compile:fail:1`` on the pipeline with
             the one-rank card mesh (one demotion, to a ``sharded`` stage
             that runs); the serving scenario runs at the end of the serve
             phase.  Every other phase must show no
             fault fired, no demotion, quarantine skip, halving or
             swallowed error (a ``[resilience]`` line per phase);
4. times   — device times (``torch.profiler``) of the kernel, of the
             other geometries of its rule and of ``--split-pipeline-compare``
             builds, in turns, CUDA-event medians of the kernel and its plain
             version, and host-clock medians of warm (plan-cache hit)
             evaluations on the ``eager``, ``fused``, ``scan`` and ``cuda``
             executors on the same inputs, with the batches and tiles the
             tuner pinned, beside the kernel's bound;
5. adamw   — hold the fused AdamW kernel against its plain version on the
             card: n in {1, 1000, 70001, 2**27+3}, float32 and bfloat16,
             steps 1 and 7, gscale 1 and 0.5, a misaligned view, and every
             leaf of the train phase at its real size, where the kernel, its
             plain version and ``torch._fused_adamw_`` are also timed;
6. train   — gemma-7b at its published widths with n_layers cut to 8 (the
             only reduction), batch 2, seq 2048, random weights from a seed:
             five steps of ``lm.loss_fn`` -> backward ->
             ``adamw.update(path="kernel")`` on one batch; on step 1 the
             kernel path is held against the ``jnp`` path and the plain
             version, and ``mozart_adamw_update(executor="cuda")`` against
             the kernel path, per leaf group, with the group's
             split-pipeline and fused AdamW device times (``torch.profiler``)
             beside the split pipeline's bound; loss, launches, step and
             optimizer ms per step and the peak device memory are printed;
7. attn    — hold the flash-attention kernel against its plain version
             (``tests/test_kernels.py``'s TestFlashAttention cases, non-causal,
             windows 32 and 128, Sk > Sq, ragged Sq/Sk, in float32 on the
             simt variant and bfloat16 on the tc variant; bfloat16 edges of
             the tc variant: the model's head-split views, ragged Sq/Sk at D
             64/128/256, windows of 5 and 40 keys, and D 40, which the rule
             sends to simt; gemma's prefill shape (4, 16, 2048, 256) causal
             bfloat16), each line with the variant that ran, the launches
             per variant and, in bfloat16, ||kernel - plain|| / ||plain||
             (at most 1e-2), and the RMSNorm kernel (TestRMSNorm shapes,
             (8192, 3072), (65536, 3072), (2, 20000) and an offset view),
             float32 and bfloat16; time both at gemma's shapes (device times
             from ``torch.profiler``; RMSNorm on cold L2, each call on the
             next of 4 x buffers, medians of 5 interleaved rounds) beside
             their bounds, their plain versions, the simt variant on the
             tc variant's inputs, and ``F.scaled_dot_product_attention`` /
             ``F.rms_norm``;
8. ops     — the RMSNorm kernel's path, ``kernels.ops.rmsnorm`` (its only
             caller, as in the reference), at gemma's hidden-state shapes;
9. serve   — gemma-7b at its published widths and full depth (28 layers),
             random weights from a seed, under ``inference_mode``:
             ``lm.greedy_generate`` (batch 4, prompt 2048, 32 new tokens; 28
             flash-attention launches per prefill, all of the tc variant),
             its prefill held against
             the plain attention path (``use_kernel=False``), prefill and
             decode times; then ``launch.serve.Server(mode="continuous")``
             on 12 requests (prompts 256-2048, 8-48 new tokens) with decode
             and request percentiles, and 3 of them against sequential
             batch-1 ``prefill``/``decode_step``; the same 12 requests
             through ``Server(driver="mozart")`` (serving over
             ``mozart.pipeline``): tokens equal to the ``jit`` leg's, every
             step warm (0 planner calls, 0 traces) with one step-function
             call, the buckets labelled, decode p50/p99 and tokens/s beside
             the ``jit`` leg's, one decode step by each driver in turns (the
             mozart driver's per-step host cost), and a second batcher started from the saved
             plan file serving with 0 planner calls; then
             ``serve_step:fail:1`` in a 2-slot ``ContinuousBatcher`` driven
             by ``AsyncServer``, on each driver (2 requests fail with the
             ``InjectedFault``, MZ405, the driver thread survives, 2 more
             requests equal the fault-free run);
10. archs  — internlm2-20b (GQA group 6), granite-34b (MQA, plain GELU MLP),
             gemma3-4b (qk-norm, 1024-key windows on 5 of 6 layers),
             olmoe-1b-7b (MoE, 64 experts top-8, qk-norm),
             deepseek-moe-16b (MoE, 64 experts top-6 + 2 shared, a dense
             first layer), hymba-1.5b (attention and SSM heads, GQA group
             5 at head dim 64, 1024-key windows on 30 of 32 layers) and
             rwkv6-1.6b (RWKV-6, no attention) at their published widths, one at a time, random
             weights from a seed, at full depth where the card holds the
             weights, a 4 x 2048 prefill and its KV cache (else the depth is
             cut and the line says so; hymba at 16 layers and rwkv6 at 8,
             ``ARCH_RECURRENT_LAYERS``, for the script's time): a greedy prefill with one tc
             flash-attention launch per layer (window launches counted
             apart; deepseek's dense pre-layer included), each launch
             held in place against the kernel's plain version on its own
             q, k, v, the prefill against the plain attention path (first
             tokens equal; last-position logits within 2e-2 max|logit|, or
             within 1.5 x the distance between two plain paths of the same
             run where that is larger), 4 decode steps, for the MoE models
             the assignments the capacity dropped in the prefill and in one
             decode step, for gemma3-4b a short ``Server(driver="mozart")``
             run against batch-1 decoding, and for deepseek-moe-16b the
             same requests through ``Server`` on ``jit`` and ``mozart``
             (tokens equal, every mozart step warm: capacity routing makes a
             token depend on its batch, so batch-1 decoding is no oracle
             there).  The recurrent models (hymba-1.5b, rwkv6-1.6b; rwkv6
             launches no flash attention and has no plain comparison) hand
             their state from a 2032-token prefill to 16 forced decode
             steps (logits within 2e-2 max|logit| of the full prefill's,
             next tokens equal), time layer 0's recurrence with CUDA events
             and profile it, and serve through pad-free exact-length
             buckets (``warmup(prompt_lens=...)``): hymba on ``jit`` and
             ``mozart`` (tokens equal), rwkv6 on ``mozart``, each request
             against batch-1 decoding, and a warm start from the plan file.
             The embedding-input models: qwen2-vl-2b (M-RoPE, GQA group 6)
             prefills from ``input_embeds`` (the text rows the embedding
             table's, a 48 x 32 image's rows a seeded normal x 0.02) with
             the image's three position streams (``vl_positions``), checks
             M-RoPE of equal streams against RoPE and that the image layout
             moves the logits, and serves text through a ``mozart``
             ``Server`` against batch-1 decoding with a warm start from the
             plan file; seamless-m4t-large-v2 (encoder-decoder) encodes
             ``enc_embeds`` (4 x 2048 x 1024) in the prefill (24
             non-causal launches before the decoder's 24 causal ones,
             counted apart; cross-attention launches nothing), decodes with
             ``enc_out``, hands its cache over as the recurrent models do,
             and profiles the cross K/V recomputation's share of a decode
             step.  The attn phase times the kernel at these prefill shapes
             beside SDPA (seamless's encoder non-causal on both).
11. band   — logit softcap and the banded sliding-window path (ROADMAP
             A7.5) at gemma-7b's published widths, n_layers cut to 8
             (``BAND_LAYERS``, printed): a banded config (window 1024,
             ``banded_attention``) prefills 4 x 4096 with one tc window
             launch per layer, each held in place against the banded and the
             dense windowed plain paths, the logits against both plain
             prefills; the windowed kernel timed at (4, 16, 4096, 256) beside
             SDPA with a mask; then Gemma 2's softcap of 50 over 4 x 2048,
             wq and wk scaled so that the cap bites: no flash-attention
             launch, decode steps against teacher forcing, the cap's own
             effect on the logits outside that bound, and the softcap
             prefill (dense, off the kernel) timed beside the same prefill
             uncapped on the kernel;
12. libs   — the Table, Image and NLP integrations (ROADMAP A9) on the
             card: fig4's crime_index, data_cleaning and birth_analysis at
             2**24 rows of int64/float64 columns, movielens at 2**24 ratings
             x 4,000 movies, nashville and gotham at 4000 x 3000 x 3 float32,
             normalize_case -> pos_tag and token_counts over 2**17 x 64
             tokens, each on ``eager``, ``pipelined`` and ``cuda`` (every
             stage on ``fused``, counted in ``cuda_fallback_stages`` as the
             CPU tests hold), results on the card and equal to their oracles,
             cold and warm milliseconds; a ``{"libs": ...}`` JSON line;
13. verify — the annotation linter and dataflow analyzer (ROADMAP A10.1)
             on the card: ``mozart.verify()`` (every probe and every
             annotated op's output on the card, the CPU sweep's subjects and
             findings); ``mozart.verify`` on Black-Scholes and Haversine at
             n = 2**27 with ``executor="cuda"`` (no launch, no plan-cache
             entry, no device memory left; a ``cuda`` session then launches
             once per stage walked, its rewrite records the reported MZ5xx
             codes); a warm ``Pipeline.verify`` reusing the recorded handoff
             where the rewrite pass left the graph alone; then ``groupby_agg``
             over 2**22 float64 keys with NaNs (ROADMAP C11: one NaN group,
             last, against the CPU and numpy) and ``pos_tag`` on ids outside
             the vocabulary (C12: no device assert, the rows JAX reads);
             a ``{"verify": ...}`` JSON line;
14. lint   — the checking layer's runtime half (ROADMAP A10.2) and the
             analytic roofline (A11): ``python -m repro_torch.launch.lint``
             on the card (exit 0, every probe and op output on the card, the
             report equal to ``--device cpu``'s, both timed); with
             ``MOZART_SANITIZE=1`` the handoff chain at n = 2**27 on
             ``fused``, ``scan`` and ``cuda`` bit-equal to the unsanitized
             run with the same counters and split-pipeline launches; MZ301
             (a scan carry a ``cuda`` launch released, read again), MZ302 (a
             holed stream at a ``cuda`` stage's ingest: no demotion, no
             MZ402) and MZ303 (a corrupted scope) raised on card tensors; a
             warm ``cuda`` Black-Scholes at 2**27 timed with the sanitizer
             on and off in turns; ``model_flops`` and ``roofline_terms`` of
             the train phase's step and the serve phase's prefill beside
             their measured times; a ``{"lint": ...}`` JSON line;
15. sharded — the ``sharded`` executor (ROADMAP A8.1) on a one-rank NCCL
             mesh (``make_host_mesh()``; one H100 gives one rank, so the
             multi-rank collectives are held on the CPU by ``gloo`` worlds
             of 2-8 ranks): Black-Scholes and Haversine at n = 2**27 (card
             DTensors, Shard(0), local (2**27,), equal to ``fused`` at the
             same batch and to the float64 oracle); sum/max/min/prod of
             float32, int32, bool and bfloat16 inputs through the NCCL
             group, equal to ``fused``; the handoff chain at 2**27
             sharded -> sharded (no interior byte, no gather) and
             sharded -> ``cuda`` (the split-pipeline kernel on the
             consumer's stages, launches counted from 0); ``auto`` with the
             mesh (the pick per stage); elastic restore of a CPU-saved tree
             onto the card mesh; warm host milliseconds of ``sharded``,
             ``fused`` and ``cuda`` Black-Scholes in turns; a
             ``{"sharded": ...}`` JSON line.
16. zero1  — ZeRO-1 data-parallel training (ROADMAP A8.2a) on a one-rank
             NCCL mesh: (a) ``train(mesh=...)`` of gemma-7b at its published
             widths, 6 layers, 2 x 2048, 3 steps, against the mesh-free
             ``train()`` on the same seed (losses and parameters bit-equal
             expected; any difference is printed by step and leaf); (b) the
             sharded update with ``path="kernel"``: the fused AdamW kernel
             11 times per step (the wrapper's count and ``torch.profiler``),
             each leaf's local shard against ``path="jnp"`` on step 1, the
             losses against (a)'s; (c) a resume from the step-2 checkpoint
             at gemma-7b's smoke config (a checkpoint at published widths
             is 36 GB at 8 layers, 12.8 GB at one): step 3's loss and
             parameters equal to the uninterrupted run's; (d)
             ``optim/compress.py`` on step 1's gradients against the CPU
             on the same values (codes, scales, residuals bit-equal) and
             ``compressed_bytes``; (e) uint16/uint32 ``max``/``min``,
             ``maximum``/``minimum``, ``greater``/``less`` and ``where``
             (ROADMAP C13) on ``cuda`` and ``sharded`` at n = 2**24 against
             int64; peak memory, seconds and a ``{"zero1": ...}`` JSON line.
17. tp     — tensor parallelism over "model" (ROADMAP A8.2b): two spawned
             ranks on the one card in a ``gloo`` group (NCCL takes one rank
             per GPU), every tensor of the step on the card; first a
             probe of the collectives gloo takes on card tensors.  (a)
             ``train(mesh=make_host_mesh(1, 2))`` of gemma-7b at published
             widths, 4 layers, 2 x 2048, 3 steps (Megatron splits: 16 heads,
             F 24576 and the tied 256000-row vocabulary), against the
             mesh-free ``train()`` on the card (bfloat16: step 1 within 1e-3,
             steps 2-3 within 2e-2; the largest parameter difference beside
             one bfloat16 ulp; step ms, peak memory per rank, collective
             bytes); (b) ``path="kernel"``: the fused AdamW kernel once per
             leaf per step on each rank's slices (wrapper and profiler),
             equal to ``path="jnp"`` within one bfloat16 ulp; (c)
             olmoe-1b-7b at published widths, 2 layers, ``moe_groups`` 1,
             against its mesh-free run, every route and expert FFN (the
             backward's recompute on autograd's device thread included)
             seeing the model group, with checkpoints at steps 2 and 3;
             (d) (c) resumed from its step-2 checkpoint: step 3's loss
             and slices bit-equal; (e) C14's
             uint16/uint32 arithmetic at 2**24 on ``cuda``, ``sharded`` and
             ``fused``, and C15: a step holding 8 GiB that raises an injected
             ``torch.OutOfMemoryError`` is retried with the memory released;
             (f) ROADMAP C16: gemma-7b at published widths and depth (28
             layers), each rank's slices drawn straight from the seed
             (``train.rank_params``), its peak device memory across the
             init against its slices plus the largest leaf, bit-equal (per
             leaf checksums) to the slices of the mesh-free init drawn once
             in this process, whose whole-then-slice peak is measured too;
             (g) A8.2c, the expert-parallel MoE dispatch with
             ``models.shard_ctx`` installed as the reference's
             ``dryrun.py`` installs it: (g1) one olmoe-1b-7b MoE block at
             published widths on 2 x 2048 tokens, ``moe_groups`` 2, the
             default capacity factor, forward and backward against the
             mesh-free block on the permuted tokens (bfloat16: the serving
             rule against the float32 distance), with the collective bytes
             beside the reduce-before-combine path's; (g2)
             ``train(mesh=make_host_mesh(1, 2))`` of olmoe-1b-7b at 2
             layers, ``capacity_factor`` 8, its step on the kernel path:
             losses against the mesh-free ``train()``'s, the fused AdamW
             kernel once per leaf per step (wrapper and profiler), step ms,
             peak memory and collective bytes per rank;
             seconds and a ``{"tp": ...}`` JSON line.
18. dryrun — the production dry run (ROADMAP A11), after the tp phase:
             (a) on the host, beside (b), ``python -m
             repro_torch.launch.dryrun`` traces rank 0 of a fake 512-rank
             world at published widths, one process per cell, all at
             once: gemma-7b x ``train_4k``, gemma-7b x ``decode_32k`` and
             olmoe-1b-7b x ``prefill_32k`` on 16 x 16, gemma-7b x
             ``decode_32k`` on 2 x 16 x 16; each record ``ok``, with the
             reference's keys and ``models.config``'s parameter counts;
             after the 16 x 16 decode record, ``python -m
             repro_torch.launch.roofline`` on gemma-7b x ``decode_32k``
             with the card's constants; ``report.py``'s tables; (b) in
             a spawned process of the same fake world, rank 0's gemma-7b x
             ``decode_32k`` step run for real on ``cuda:0`` with the same
             builders (its slices, 8 rows x 2048 positions of cache
             pieces): resident bytes against ``argument_bytes``,
             ``max_memory_allocated`` against ``peak_bytes`` (a difference
             past 20% is printed for ROADMAP C), ``FlopCounterMode`` equal
             to the record's ``flops``; a ``{"dryrun": ...}`` JSON line.
             Should (a) or (b) fail, (a)'s processes are killed before the
             script exits.

The last lines are the card's name and power limit, a JSON ``kernels``
record and the device record.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parent
N_MAIN = 1 << 27
N_QUICKSTART = 1_000_000
PREFIX = 1 << 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
REPLACES = "src/repro/kernels/split_pipeline.py:48"
SOURCE = "src/repro_torch/csrc/split_pipeline.cu"
ADAMW_REPLACES = "src/repro/kernels/fused_adamw.py:24"
ADAMW_SOURCE = "src/repro_torch/csrc/fused_adamw.cu"
ADAMW_SIZES = (1, 1000, 70001, (1 << 27) + 3)
ADAMW_OPS = 17                   # float32 operations per element
ADAMW_EPS, ADAMW_WD = 1e-8, 0.1
ATTN_REPLACES = "src/repro/kernels/flash_attention.py:31"
ATTN_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
RMS_REPLACES = "src/repro/kernels/rmsnorm.py:19"
RMS_SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
BF16_OPS_PER_S = 989e12          # dense bfloat16 on the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
ATTN_REL_TOL = 1e-2              # ||kernel - plain|| / ||plain||, bfloat16 attention
RMS_ROTATE = 4                   # timed RMSNorm calls cycle 4 x 50 MB of x, past the 50 MB L2
RMS_BURST = 48                   # RMSNorm calls per timing
RMS_ROUNDS = 5                   # interleaved rounds of the RMSNorm timings (medians)
GEMMA_ATTN = (4, 16, 2048, 256)  # gemma-7b prefill: batch 4, 16 heads, 2048, 256
RMS_SHAPES = ((8, 128), (3, 512), (2, 5, 256), (300, 1024), (8192, 3072), (65536, 3072),
              (2, 20000))   # the last: w wider than the kernel's shared-memory copy
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_REQUESTS, SERVE_MAX_LEN, PARITY_REQUESTS = 12, 2112, 3
STEP_ROUNDS = 12                 # interleaved jit/mozart decode steps timed in the serve phase
REWRITE_N, REWRITE_DEAD_ROWS = 1 << 26, 8   # smoke/rewrite: 8 x 2**26 dead matrix (2 GiB)
CHAOS_TTL = 3                    # QUARANTINE_TTL in the chaos phase
CHAOS_PROMPTS, CHAOS_NEW, CHAOS_MAX_LEN = (256, 200, 240, 256), 8, 512
ARCHS = ("internlm2-20b", "granite-34b", "gemma3-4b",   # the archs phase, one at a time
         "olmoe-1b-7b", "deepseek-moe-16b", "hymba-1.5b", "rwkv6-1.6b",
         "qwen2-vl-2b", "seamless-m4t-large-v2")
ARCH_BATCH, ARCH_PROMPT, ARCH_DECODE = 4, 2048, 4        # greedy prefill + decode steps
ARCH_SERVE = {"gemma3-4b": ("mozart",),                  # Server runs: 2 slots, 4 requests
              "deepseek-moe-16b": ("jit", "mozart"),      # on these drivers in turn
              "hymba-1.5b": ("jit", "mozart"),
              "rwkv6-1.6b": ("mozart",),
              "qwen2-vl-2b": ("mozart",)}
#: padded families whose mozart Server leg also warm-starts a second batcher
#: from its plan file (the pad-free ones always do)
ARCH_WARM_START = ("qwen2-vl-2b",)
#: qwen2-vl's prompt as Qwen2-VL lays out one image (M-RoPE, arXiv:2409.12191):
#: a text prefix, an image of rows x cols merged patches, a text tail
VL_PREFIX, VL_IMAGE, VL_TAIL = 64, (48, 32), 448
ARCH_ENC_FRAMES = 2048           # seamless: enc_embeds frames per row
ARCH_HANDOFF = 16                # recurrent models: prompt tokens forced through decode_step
RECURRENT_REPS = 3               # CUDA-event timings of one layer's recurrence
ARCH_SERVE_PROMPTS, ARCH_SERVE_NEW, ARCH_SERVE_MAX_LEN = (900, 130, 513, 1024), (12, 6, 9, 7), 1040
ARCH_MARGIN = 3 << 30            # device bytes left free when sizing a model's depth
#: the recurrent models' depth in the archs phase (of 32 and 24): their step
#: loops launch per token and layer, and at full depth the two took 180 s of
#: the script's time limit; hymba's 16 keep one of its two global-attention
#: layers (layer 15)
ARCH_RECURRENT_LAYERS = {"hymba-1.5b": 16, "rwkv6-1.6b": 8}
ARCH_FLOOR_FACTOR = 1.5          # kernel vs plain logits against plain vs plain (arch_run)
#: the band phase: gemma-7b's widths, n_layers cut to 8; a 1024-key window
#: banded over 4 x 4096 (S > 2w), then Gemma 2's published attention logit
#: softcap (``attn_logit_softcapping`` 50.0 in its HF config) over 4 x 2048
BAND_LAYERS, BAND_BATCH, BAND_PROMPT, BAND_WINDOW = 8, 4, 4096, 1024
SOFTCAP, SOFTCAP_PROMPT, SOFTCAP_DECODE = 50.0, 2048, 4
#: wq and wk are each scaled by this for the softcap half, so that random
#: weights' scores (std ~1 at gemma's widths) reach the cap (std ~16)
SOFTCAP_QK_SCALE = 4
#: the libs phase's sizes: fig4's tables at 2**24 rows (movielens: 2**24
#: ratings of 4,000 movies), its images at 4000 x 3000 x 3 float32, and a
#: corpus of 2**17 documents x 64 tokens tagged by a (50,000 x 128) embedding
#: and a 17-tag head
LIBS_ROWS, LIBS_MOVIES, LIBS_IMAGE = 1 << 24, 4000, (4000, 3000)
LIBS_DOCS, LIBS_TOKENS, LIBS_VOCAB, LIBS_DIM, LIBS_TAGS = 1 << 17, 64, 50_000, 128, 17
LIBS_EXECUTORS = ("eager", "pipelined", "cuda")
#: stages per library workload: the CPU tests' counts (tests/test_torch_table.py,
#: _image.py, _nlp.py); on ``cuda`` every one of them falls back to ``fused``
LIBS_STAGES = {"crime_index": 2, "data_cleaning": 1, "birth_analysis": 1, "movielens": 1,
               "nashville": 1, "gotham": 1, "tagger": 1}
#: process-wide resilience counters no phase but chaos may move
RESILIENCE_KEYS = ("MZ401", "MZ402", "MZ403", "MZ404", "MZ405", "MZ406", "swallowed_errors")
DEVICE = "cuda"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 5
HANDOFF_EVALS = 3                # evaluations of the smoke/handoff chain
HANDOFF_ROUNDS = 10              # timed rounds of each, on and off in turns
PLAN_CALLS = 10                  # warm pipeline calls per workload in the plans phase
PLAN_ROUNDS = 10                 # timed rounds of cold, warm and pipeline evaluations
PROFILE_SENTINELS = 64           # spin kernels opening each profiled window
CHUNK = 1 << 25                  # elements per comparison slice
SHARDED_BATCH = 1 << 22          # batch_elements of the sharded phase's fused and sharded runs
SHARDED_REDUCE_N = 1 << 24       # elements per reduction input in the sharded phase
SHARDED_ROUNDS = 10              # turns of the sharded phase's host-time comparison
ZERO1_STEPS = 3                  # train() steps of the zero1 phase
#: its depth: train() keeps the reference's jnp AdamW path, whose update at
#: the train phase's 8 layers peaks at 78.1 GB (of 85.0 on an H100) and
#: ran out of memory in the whole script after the earlier phases
ZERO1_LAYERS = 6
ZERO1_LOSS_RTOL = 1e-3           # kernel-path losses against the jnp path's
C13_N = 1 << 24                  # elements of the zero1 phase's uint16/uint32 checks


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def compare(what: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol_scale: float = 2e-5, atol: float = 0.0) -> float:
    """Assert ``got`` matches ``want`` (NaN positions equal); returns the
    largest absolute difference over entries finite in both."""
    g, w = got.detach().double(), want.detach().double()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if got.dtype == torch.bool or want.dtype == torch.bool:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{what}: bool outputs differ")
        return 0.0
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"{what}: NaN positions differ")
    fin = torch.isfinite(w) & torch.isfinite(g)
    if not torch.equal(torch.isinf(g), torch.isinf(w)) or \
            not torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]):
        raise AssertionError(f"{what}: infinities differ")
    if not bool(fin.any()):
        return 0.0
    gf, wf = g[fin], w[fin]
    tol = max(atol, atol_scale * float(wf.abs().max())) + rtol * wf.abs()
    diff = (gf - wf).abs()
    if bool((diff > tol).any()):
        i = int(torch.argmax(diff - tol))
        raise AssertionError(f"{what}: |{float(gf[i])} - {float(wf[i])}| "
                             f"exceeds rtol {rtol} / atol")
    return float(diff.max())


#: (phase, seconds since the previous check) per ``resilience_clean`` call;
#: the first lap starts when the script is imported
LAPS: list = []
_LAP_START = [time.perf_counter()]


def resilience_clean(phase: str) -> dict:
    """Every phase but chaos: no fault fired and no demotion, quarantine
    skip, halving or swallowed error since the last check (the process-wide
    ``resilience.stats``); prints the phase's MZ4xx counts and the seconds
    since the last check (``LAPS``), and starts the next phase's count
    from 0."""
    from repro_torch.core import resilience
    now = time.perf_counter()
    LAPS.append((phase, round(now - _LAP_START[0], 1)))
    _LAP_START[0] = now
    counts = {k: int(resilience.stats.get(k, 0)) for k in RESILIENCE_KEYS}
    log(f"[resilience] {phase}: {counts}; {LAPS[-1][1]} s since the last check")
    if any(counts.values()):
        raise AssertionError(f"{phase}: resilience events outside the chaos phase: "
                             f"{counts}; last events {resilience.events()[-5:]}")
    resilience.clear_events()
    return counts


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median host-clock milliseconds of ``fn`` ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------


def phase_build(sources) -> None:
    from repro_torch.kernels import build
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(build.build, sources))
    for path, secs, compiler_log in builds:
        log(f"[build] {path} built in {secs:.2f} s")
        for line in compiler_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] ptxas: {line.strip()}")
    log(card_line())


#: workload function name -> the §5.2 batch the card's L2 gives its stage
#: (filled by ``lowered``; the times phase prints it beside the pinned ones).
L2_ESTIMATE: dict[str, int] = {}

#: workload function name -> for each of its outputs, the index of that
#: output among the kernel launch's outputs (filled by ``lowered``).  The
#: launch writes no more than these (ROADMAP C6: a node the rewrite pass
#: retired keeps nothing escaping).
LAUNCH_OUTPUTS: dict[str, list] = {}


def lowered(fn, data, rewrite: bool = True):
    """The kernel launch (program, split inputs, broadcasts, out kinds) that
    a ``mozart.session(executor="cuda")`` evaluation of ``fn`` on ``data``
    makes, recorded at the wrapper as the session launches it: the program
    the runtime planned and pinned (the rewrite pass included, or not with
    ``rewrite=False``), not a copy re-planned here.  The tuner is off so the
    one launch is the stage's own."""
    from repro_torch.core import cuda_exec, mozart
    from repro_torch.core.stage_exec import get_executor, stage_num_elements
    from repro_torch.kernels import split_pipeline as spm
    seen = []
    real_try, real_launch = cuda_exec.try_execute_stage_cuda, spm._launch

    def try_stage(stage, concrete, ctx, executor=None):
        seen.append({"stage": stage, "concrete": dict(concrete), "ctx": ctx})
        return real_try(stage, concrete, ctx, executor)

    def launch(program, split_inputs, bcasts, kinds, geom=None):
        seen[-1]["launch"] = (program, list(split_inputs), list(bcasts), list(kinds))
        return real_launch(program, split_inputs, bcasts, kinds, geom=geom)

    cuda_exec.try_execute_stage_cuda, spm._launch = try_stage, launch
    try:
        with mozart.session(executor="cuda", rewrite=rewrite, autotune=False):
            outs = as_list(fn(**data))
            for o in outs:
                o.value
    finally:
        cuda_exec.try_execute_stage_cuda, spm._launch = real_try, real_launch
    torch.cuda.synchronize()
    if len(seen) != 1 or "launch" not in seen[0]:
        raise AssertionError(f"{fn.__name__}: {len(seen)} stage(s) went to the kernel, "
                             f"expected 1 launch")
    stage, concrete, ctx = seen[0]["stage"], seen[0]["concrete"], seen[0]["ctx"]
    if rewrite:
        L2_ESTIMATE[fn.__name__] = get_executor("fused").estimate_batch(
            stage, concrete, ctx, stage_num_elements(stage, concrete, False))
        escaping = sorted(stage.escaping)
        LAUNCH_OUTPUTS[fn.__name__] = [escaping.index(o._node.id) for o in outs]
    return seen[0]["launch"]


def kernel_case(sp, ref, what: str, program, ins, bcast, kinds) -> float:
    """One launch against the plain version on the same inputs; logs the
    geometry and the tiles each load path took."""
    before = dict(sp.split_pipeline.tile_paths)
    got = sp.split_pipeline(program, ins, bcast, kinds)
    want = ref.split_pipeline_ref(program, ins, bcast, kinds)
    torch.cuda.synchronize()
    err = 0.0
    for i, ((kind, _op), gv, wv) in enumerate(zip(kinds, got, want)):
        err = max(err, compare(f"{what} output {i}", gv, wv,
                               1e-4 if kind == "reduce" else 2e-5))
    paths = {k: v - before[k] for k, v in sp.split_pipeline.tile_paths.items()}
    geo = sp.program_geometry(program, kinds, torch.cuda.current_device())
    log(f"[kernel] {what}: n={ins[0].numel()}, tile {geo.tile}, {geo.stages} stages, "
        f"{program.stored_slots} stored slots, {program.forwarded} of {len(program.code)} "
        f"results forwarded; tiles by load path {paths}; max |kernel - plain| = {err:.3e}")
    return err


def edge_programs():
    """Programs at the kernel's limits, built with ``program.assemble``."""
    from repro_torch.kernels import program as P
    # 16 inputs + 40 stored slots = the 56-row limit: 40 products all live
    # until a chain of adds (forwarded) consumes them
    code = [(P.OP["MUL"], [("in", i % 16), ("sc", i % 4)]) for i in range(40)]
    acc = ("v", 0)
    for i in range(1, 40):
        code.append((P.OP["ADD"], [acc, ("v", i)]))
        acc = ("v", len(code) - 1)
    rows = P.assemble(code, [(acc, False)], n_split=16, n_bcast=4, imms=())
    # 16 inputs, 12 outputs (the first a sum), as the Mozart AdamW stage
    code, outs = [], []
    for j in range(12):
        code.append((P.OP["MUL"], [("in", j), ("sc", 0)]))
        code.append((P.OP["ADD"], [("v", len(code) - 1), ("in", j + 4)]))
        outs.append((("v", len(code) - 1), False))
    wide = P.assemble(code, outs, n_split=16, n_bcast=1, imms=())
    # bool inputs and outputs
    code = [(P.OP["GT"], [("in", 0), ("sc", 0)]),
            (P.OP["AND"], [("v", 0), ("in", 1)]),
            (P.OP["WHERE"], [("in", 2), ("in", 0), ("sc", 1)]),
            (P.OP["OR"], [("in", 1), ("in", 2)])]
    bools = P.assemble(code, [(("v", 1), True), (("v", 2), False), (("v", 3), True)],
                       n_split=3, n_bcast=2, imms=())
    return rows, wide, bools


def phase_kernel_edges(sp, ref, hv_program) -> float:
    """Lengths around the tile and the kernel's limits, views off the
    16-byte grid, bool inputs and outputs, the row limit and 16 inputs."""
    rows, wide, bools = edge_programs()
    assert rows.n_split + rows.stored_slots == sp.MAX_ROWS, rows.stored_slots
    gen = torch.Generator(device="cuda").manual_seed(4)
    bc = [0.70984286, 1.23892197, 0.5, math.cos(0.70984286), 2.0, 3959.0]
    worst = 0.0
    for n in (1, 15, 16, 1023, 1024, 1025, 100_003, N_MAIN + 3):
        x = [torch.rand(n, generator=gen, device="cuda") * 3.0 - 1.5 for _ in range(2)]
        worst = max(worst, kernel_case(sp, ref, f"haversine program n={n}", hv_program,
                                       x, bc, [("concat", "")]))
        del x
    x = [torch.rand(100_004, generator=gen, device="cuda")[1:] * 3.0 - 1.5 for _ in range(2)]
    worst = max(worst, kernel_case(sp, ref, "haversine program, views one element off",
                                   hv_program, x, bc, [("concat", "")]))
    for n in (1025, 100_003):
        base = torch.rand(n, generator=gen, device="cuda")
        for off in (0, 1):
            ins = [base * 2.0 - 1.0,
                   torch.rand(n + off, generator=gen, device="cuda")[off:] > 0.5,
                   torch.rand(n, generator=gen, device="cuda") > 0.3]
            worst = max(worst, kernel_case(sp, ref, f"bool inputs and outputs, bool view "
                                           f"offset {off}", bools, ins, [0.1, -2.0],
                                           [("concat", "")] * 3))
    for n in (511, 513, 100_003):
        ins = [torch.randn(n, generator=gen, device="cuda") for _ in range(16)]
        worst = max(worst, kernel_case(sp, ref, "56-row program (16 inputs, 40 slots)", rows,
                                       ins, [0.5, -1.5, 0.25, 2.0], [("concat", "")]))
        worst = max(worst, kernel_case(sp, ref, "16 inputs, 12 outputs (one summed)", wide,
                                       ins, [0.5], [("reduce", "add")] + [("concat", "")] * 11))
    return worst


def phase_kernel(sp, ref, workloads_data) -> dict:
    from repro_torch.kernels import program as P
    errs = {}
    for name, (fn, data) in workloads_data.items():
        launch = lowered(fn, data)
        got = sp.split_pipeline(*launch)
        want = ref.split_pipeline_ref(*launch)
        torch.cuda.synchronize()
        err = 0.0
        for i, ((kind, _op), g, w) in enumerate(zip(launch[3], got, want)):
            rtol = 1e-4 if kind == "reduce" else 2e-5
            err = max(err, compare(f"{name} output {i}", g, w, rtol))
        errs[name] = (err, launch)
        log(f"[kernel] {name}: program of {len(launch[0].code)} ops, "
            f"{launch[0].stored_slots} stored slots, {launch[0].forwarded} results "
            f"forwarded, n={launch[1][0].numel()}: max |kernel - plain| = {err:.3e}")

    # every opcode, with split and broadcast operands, on a ragged length
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 100_003
    a = (torch.randn(n, generator=g) * 2.0)
    a[:6] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.0])
    b = torch.randn(n, generator=g) * 2.0 + 0.25
    c = (torch.rand(n, generator=g) > 0.5).to(torch.float32)
    ins = [t.cuda() for t in (a, b, c)]
    worst = 0.0
    for name, arity in P.OPCODES:
        for scalar in ((False, True) if arity >= 2 else (False,)):
            srcs = [P.operand(P.KIND_INPUT, i) for i in range(3)][:arity]
            bcast = []
            if scalar:
                srcs[1] = P.operand(P.KIND_SCALAR, 0)
                bcast = [0.75]
            prog = P.Program(
                code=((P.OP[name], 0, *srcs, *([0] * (3 - arity))),), n_split=3,
                n_bcast=len(bcast), n_slots=1, imms=(),
                outputs=((P.operand(P.KIND_SLOT, 0), name in P.BOOL_RESULT),))
            kinds = [("concat", "")]
            for marked in (prog, P.forward(prog)):     # stored and forwarded result
                got = sp.split_pipeline(marked, ins, bcast, kinds)[0]
                want = ref.split_pipeline_ref(marked, ins, bcast, kinds)[0]
                worst = max(worst, compare(f"opcode {name} scalar={scalar}",
                                           got, want, 2e-5))
    # bool inputs load as 1.0/0.0
    bool_in = [x.cuda() for x in (a > 0, b > 0)]
    prog = P.Program(code=((P.OP["AND"], 0, P.operand(P.KIND_INPUT, 0),
                            P.operand(P.KIND_INPUT, 1), 0),),
                     n_split=2, n_bcast=0, n_slots=1, imms=(),
                     outputs=((P.operand(P.KIND_SLOT, 0), True),))
    compare("bool inputs", sp.split_pipeline(prog, bool_in, [], [("concat", "")])[0],
            (bool_in[0] & bool_in[1]), 0.0)
    log(f"[kernel] {len(P.OPCODES)} opcodes (split and broadcast operands, result "
        f"stored and forwarded): max |kernel - plain| = {worst:.3e}")
    phase_kernel_edges(sp, ref, errs["haversine"][1][0])

    # reductions over ragged lengths
    red = P.Program(code=(), n_split=1, n_bcast=0, n_slots=0, imms=(),
                    outputs=((P.operand(P.KIND_INPUT, 0), False),))
    for op, sizes in (("add", (1, 1500, 1_000_003, N_MAIN)),
                      ("max", (1, 1500, 1_000_003, N_MAIN)),
                      ("min", (1, 1500, 1_000_003, N_MAIN)),
                      ("mul", (1, 1500, 4096))):
        for m in sizes:
            if op == "mul":
                x = 1.0 + 1e-3 * torch.randn(m, generator=g)
            else:
                x = torch.rand(m, generator=g) - 0.25
            x = x.cuda()
            got = sp.split_pipeline(red, [x], [], [("reduce", op)])[0]
            want = ref.split_pipeline_ref(red, [x], [], [("reduce", op)])[0]
            rtol = {"add": 1e-4, "mul": 1e-3}.get(op, 0.0)
            compare(f"reduce {op} n={m}", got, want, rtol, atol_scale=0.0)
            del x
    log("[kernel] reductions add/max/min at n in {1, 1500, 1000003, 2**27}, "
        "mul at n in {1, 1500, 4096}: agree")
    return errs


def phase_main(sp, workloads_data, oracles) -> dict:
    from repro_torch.core import mozart
    launches = {}
    for name, (fn, data) in workloads_data.items():
        sp.split_pipeline.launches = 0
        with mozart.session(executor="cuda") as ctx:
            outs = fn(**data)
            outs = outs if isinstance(outs, tuple) else (outs,)
            got = [o.value for o in outs]
        torch.cuda.synchronize()
        launched = sp.split_pipeline.launches
        stats = dict(ctx.stats)
        if not (stats.get("stages", 0) > 0
                and stats.get("cuda_stages", 0) == stats["stages"]
                and stats.get("cuda_fallback_stages", 0) == 0
                and launched == stats["cuda_stages"]):
            raise AssertionError(f"{name}: not every stage on the kernel: "
                                 f"{stats}, launches {launched}")
        launches[name] = launched
        with mozart.session(executor="eager") as ectx:
            eouts = fn(**data)
            eouts = eouts if isinstance(eouts, tuple) else (eouts,)
            want = [o.value for o in eouts]
        torch.cuda.synchronize()
        for i, (gv, wv) in enumerate(zip(got, want)):
            if gv.shape != wv.shape or gv.dtype != wv.dtype:
                raise AssertionError(f"{name} output {i}: {gv.shape}/{gv.dtype} "
                                     f"vs eager {wv.shape}/{wv.dtype}")
            if not bool(torch.isfinite(gv).all()):
                raise AssertionError(f"{name} output {i}: non-finite values")
            if name == "quickstart":
                compare(f"{name} vs eager", gv, wv, 1e-4)
            else:
                compare(f"{name} output {i} vs eager", gv, wv, 2e-5,
                        atol=1e-2 if name == "haversine" else 0.0)
        for i, (gv, (ref64, rtol, atol)) in enumerate(zip(got, oracles[name])):
            part = gv if gv.dim() == 0 else gv[:ref64.shape[0]]
            ok = np.allclose(part.double().cpu().numpy(), ref64, rtol=rtol, atol=atol)
            if not ok:
                raise AssertionError(f"{name} output {i}: float64 oracle mismatch")
        if name != "quickstart":
            with mozart.session(executor="scan") as sctx:
                souts = fn(**data)
                souts = souts if isinstance(souts, tuple) else (souts,)
                sgot = [o.value for o in souts]
            torch.cuda.synchronize()
            for i, (gv, wv) in enumerate(zip(sgot, want)):
                if gv.shape != wv.shape or gv.dtype != wv.dtype \
                        or not bool(torch.isfinite(gv).all()):
                    raise AssertionError(f"{name} output {i} on scan: {gv.shape}/{gv.dtype}")
                compare(f"{name} output {i} on scan vs eager", gv, wv, 2e-5,
                        atol=1e-2 if name == "haversine" else 0.0)
            for i, (gv, (ref64, rtol, atol)) in enumerate(zip(sgot, oracles[name])):
                if not np.allclose(gv[:ref64.shape[0]].double().cpu().numpy(), ref64,
                                   rtol=rtol, atol=atol):
                    raise AssertionError(f"{name} output {i} on scan: float64 oracle mismatch")
            log(f"[main] {name} on scan: {dict(sctx.stats)}; matches eager and the "
                f"float64 oracle")
            del sgot, souts
        del got, want, outs, eouts
        log(f"[main] {name}: {stats} launches={launched}; "
            f"eager stats {dict(ectx.stats)}; matches eager and the float64 oracle")
    return launches


def as_list(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


# ---------------------------------------------------------------------------
# dtypes: the split pipeline at every dtype the Pallas kernel takes (B1, C9)
# ---------------------------------------------------------------------------

#: bf16/f16 outputs against ``eager`` and the float64 oracle: this fraction
#: of max|ref| (rtol and atol); the kernel against its plain version: one
#: ulp of the dtype (both round the same float32 results).
HALF_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3}
HALF_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
#: Haversine's asin(sqrt(a)) is ill-conditioned as a -> 1 (antipodal
#: points): one rounding of ``a`` at unit roundoff u moves the output by up
#: to R u / sqrt(1 - a).  Near there a half-precision result is held to
#: ``HV_ROUNDINGS`` such roundings beyond the bound above.
HALF_U = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
HV_ROUNDINGS = 4
NARROW_SIZES = (1, 1000, 70001, (1 << 27) + 3)
#: float32 kernel device times the typed kernel must stay within: the
#: float32-only kernel's times on an H100 (2.2336 / 1.4038 ms, PERF.md) plus
#: the +-6% cards differ by.
F32_LIMIT_MS = {"black_scholes": 2.37, "haversine": 1.49}


def hash_buckets(ids):
    """The bucketing step of a hash partition: a multiplicative hash of the
    ids into 1024 buckets, how many land in bucket 7, the largest bucket."""
    from repro_torch.core import annotated_numpy as anp
    b = anp.mod(anp.add(anp.multiply(ids, 40503), 12345), 1024)
    return b, anp.sum(anp.equal(b, 7)), anp.max(b)


def narrow_chains(u8, i16):
    """A uint8 and an int16 chain that wrap, and their sums (uint32, int32)."""
    from repro_torch.core import annotated_numpy as anp
    c = anp.add(anp.multiply(u8, 7), 13)
    d = anp.subtract(anp.multiply(i16, 300), 1234)
    return c, anp.sum(c), d, anp.sum(d)


def same_ints(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Integer or bool tensors equal, compared on the host in int64 (the
    card's torch has no comparison for every unsigned dtype)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.cpu().to(torch.int64), b.cpu().to(torch.int64))


def as_int(t: torch.Tensor) -> int:
    return int(t.cpu().to(torch.int64))


def half_check(what: str, got: torch.Tensor, want: torch.Tensor, tol: float,
               slack: torch.Tensor | None = None) -> float:
    """Every element of ``got`` within ``tol`` x max|want| of ``want`` (plus
    ``slack`` where given); logs the largest difference over max|want| and
    how many elements the slack admitted; returns the former."""
    g, wv = got.double(), want.double()
    diff = (g - wv).abs()
    bound = tol * float(wv.abs().max())
    worst = float(diff.max()) / float(wv.abs().max())
    over = int((diff > bound).sum())
    allow = bound if slack is None else bound + slack
    if not bool(torch.isfinite(g).all()) or bool((diff > allow).any()):
        i = int(torch.argmax(diff - allow))
        raise AssertionError(f"{what}: |{float(g[i])} - {float(wv[i])}| exceeds "
                             f"{tol} x max|ref| = {bound}"
                             + ("" if slack is None else f" + {float(slack[i])}"))
    log(f"[dtypes] {what}: max |diff| {worst:.3e} of max|ref| (bound {tol}); "
        f"{over} of {g.numel()} elements past the bound"
        + ("" if slack is None else " within the conditioning slack"))
    return worst


def hv_slack(data: dict, dtype: torch.dtype) -> torch.Tensor:
    """``HV_ROUNDINGS`` x R u / sqrt(max(1 - a, u)) per element, with ``a``
    in float64 from the half-rounded inputs."""
    lat1, lon1, miles = 0.70984286, 1.23892197, 3959.0
    lat2, lon2 = data["lat2"].double(), data["lon2"].double()
    a = torch.sin((lat2 - lat1) / 2) ** 2 + \
        torch.cos(lat2) * math.cos(lat1) * torch.sin((lon2 - lon1) / 2) ** 2
    u = HALF_U[dtype]
    return HV_ROUNDINGS * miles * u / torch.sqrt(torch.clamp(1 - a, min=u))


def typed_case(sp, ref, what: str, launch) -> float:
    """One launch against the plain version on the same inputs: integers
    and bools equal, halves within one ulp, float32 as ``kernel_case``;
    returns max |kernel - plain|."""
    program, ins, bcast, kinds = launch
    got = sp.split_pipeline(program, ins, bcast, kinds)
    want = ref.split_pipeline_ref(program, ins, bcast, kinds)
    torch.cuda.synchronize()
    err = 0.0
    for i, ((kind, _op), gv, wv) in enumerate(zip(kinds, got, want)):
        if gv.dtype != wv.dtype:
            raise AssertionError(f"{what} output {i}: {gv.dtype} vs plain {wv.dtype}")
        if not gv.dtype.is_floating_point:
            if not same_ints(gv, wv):
                raise AssertionError(f"{what} output {i}: kernel and plain version differ")
            continue
        tol = HALF_ULP.get(gv.dtype, 2e-5)
        err = max(err, compare(f"{what} output {i}", gv, wv,
                               max(tol, 1e-4) if kind == "reduce" else tol, atol_scale=tol))
    return err


def launch_bytes(launch) -> int:
    """Bytes a launch must move: each input read once, each output written
    once at its dtype's width (a reduction: its partials, left out)."""
    from repro_torch.kernels import program as P
    program, ins, _bcast, kinds = launch
    n = ins[0].numel()
    return sum(x.element_size() * n for x in ins) + sum(
        P.ITEMSIZE[c] * n for (kind, _op), c in zip(kinds, program.output_types)
        if kind == "concat")


def typed_row(sp, ref, name: str, launch, launches: int, err: float) -> dict:
    """A ``kernels`` row: device time (``torch.profiler``), plain version
    (CUDA events) and the bound of one launch at its dtypes."""
    program, ins, _b, _k = launch
    n = ins[0].numel()
    bytes_ms = launch_bytes(launch) / HBM_BYTES_PER_S * 1e3
    ops_ms = len(program.code) * n / F32_OPS_PER_S * 1e3
    kernel_ms = kernel_device_ms(lambda: sp.split_pipeline(*launch), 10)
    plain_ms = cuda_ms(lambda: ref.split_pipeline_ref(*launch), 3)
    row = {"name": f"split_pipeline[{name}]", "route": "cuda", "source": SOURCE,
           "replaces": REPLACES, "launches": launches, "max_abs_err": err,
           "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None, "n": n, "bytes_per_element": launch_bytes(launch) / n,
           "program_ops": len(program.code), "dtypes": sorted({str(x.dtype) for x in ins})}
    log(f"[dtypes] {name}: kernel {kernel_ms:.4f} ms device (bound {row['bound_ms']:.4f} ms "
        f"by {row['bound_by']}, {row['bytes_per_element']:.0f} B/element, "
        f"{row['bound_ms'] / kernel_ms:.1%} of it), plain {plain_ms:.3f} ms, "
        f"{len(program.code)} instructions, max |kernel - plain| {err:.3e}")
    return row


def run_session(fn, data, executor: str):
    from repro_torch.core import mozart
    with mozart.session(executor=executor) as ctx:
        outs = as_list(fn(**data))
        vals = [o.value for o in outs]
    torch.cuda.synchronize()
    return vals, dict(ctx.stats)


def kernel_path(sp, fn, data, what: str):
    """``fn`` on the ``cuda`` executor with the launch count set to 0 just
    before and read just after: every stage on the kernel, one launch each,
    no fallback.  Returns (outputs, stats, launches)."""
    sp.split_pipeline.launches = 0
    vals, stats = run_session(fn, data, "cuda")
    launched = sp.split_pipeline.launches
    if not (stats.get("stages", 0) > 0 and stats.get("cuda_stages", 0) == stats["stages"]
            and stats.get("cuda_fallback_stages", 0) == 0 and launched == stats["cuda_stages"]):
        raise AssertionError(f"{what}: not every stage on the kernel: {stats}, "
                             f"launches {launched}")
    return vals, stats, launched


def phase_dtypes(sp, ref, w, workloads_data, erf, errs) -> list:
    """Black-Scholes and Haversine in bfloat16 and float16, the hash
    bucketing chain from int64 ids (int32 after C9), narrow-integer chains
    that wrap, Black-Scholes from float64 inputs, and the float32 programs
    re-timed; returns the ``kernels`` rows."""
    from repro_torch.kernels import program as P
    saved = dict(L2_ESTIMATE), dict(LAUNCH_OUTPUTS)     # the float32 rows' own
    rows = []
    for dtype in (torch.bfloat16, torch.float16):
        tol, short = HALF_TOL[dtype], str(dtype).replace("torch.", "")
        for name in ("black_scholes", "haversine"):
            fn, data32 = workloads_data[name]
            data = {k: v.to(dtype) for k, v in data32.items()}
            got, stats, launched = kernel_path(sp, fn, data, f"{name} {short}")
            want, _e = run_session(fn, data, "eager")
            pre = {k: v[:PREFIX].float() for k, v in data.items()}
            oracle = (w.black_scholes_np(pre, erf=erf) if name == "black_scholes"
                      else (w.haversine_np(**pre),))
            slack = hv_slack(data, dtype) if name == "haversine" else None
            for i, (g, e, o) in enumerate(zip(got, want, oracle)):
                if g.dtype != dtype or e.dtype != dtype:
                    raise AssertionError(f"{name} {short} output {i}: {g.dtype}")
                half_check(f"{name} {short} output {i} vs eager", g, e, tol, slack)
                half_check(f"{name} {short} output {i} vs the float64 oracle (2**20 prefix)",
                           g[:PREFIX].cpu(), torch.from_numpy(np.asarray(o, np.float64)), tol,
                           None if slack is None else slack[:PREFIX].cpu())
            del slack
            launch = lowered(fn, data)
            err = typed_case(sp, ref, f"{name} {short}", launch)
            log(f"[dtypes] {name} {short} n={N_MAIN}: {stats}, launches {launched}; within "
                f"{tol} of max|ref| of eager and the float64 oracle (2**20 prefix)")
            rows.append(typed_row(sp, ref, f"{name}_{short}", launch, launched, err))
            del got, want, data, launch

    # the hash bucketing chain: int64 ids (torch's default), int32 after C9
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, 2**31 - 1, (N_MAIN,), device="cuda", generator=g)
    got, stats, launched = kernel_path(sp, hash_buckets, {"ids": ids}, "hash buckets")
    want, _e = run_session(hash_buckets, {"ids": ids}, "eager")
    for i, (gv, wv) in enumerate(zip(got, want)):
        if gv.dtype != torch.int32 or not same_ints(gv, wv):
            raise AssertionError(f"hash buckets output {i}: {gv.dtype}, equal "
                                 f"{same_ints(gv, wv)}")
    ids32 = ids.to(torch.int32)
    b_ref = torch.remainder(ids32 * 40503 + 12345, 1024)
    if not (torch.equal(got[0], b_ref) and as_int(got[1]) == int((b_ref == 7).sum())
            and as_int(got[2]) == int(b_ref.max())):
        raise AssertionError("hash buckets: outputs differ from torch's int32 arithmetic")
    launch = lowered(hash_buckets, {"ids": ids})
    if launch[0].in_dtypes != (P.I32,) or launch[1][0].dtype != torch.int32:
        raise AssertionError(f"hash buckets: the ids reach the kernel as "
                             f"{launch[1][0].dtype} ({launch[0].in_dtypes})")
    err = typed_case(sp, ref, "hash buckets", launch)
    log(f"[dtypes] hash buckets n={N_MAIN}: int64 ids reach the kernel as int32; {stats}, "
        f"launches {launched}; equal to eager; bucket 7 holds {as_int(got[1])}, the "
        f"largest bucket is {as_int(got[2])}")
    rows.append(typed_row(sp, ref, "hash_buckets_int32", launch, launched, err))
    del ids, ids32, b_ref, got, want, launch

    # narrow integers that wrap, at the kernel's edge sizes
    for n in NARROW_SIZES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        data = {"u8": torch.randint(0, 256, (n,), device="cuda", generator=gen,
                                    dtype=torch.uint8),
                "i16": torch.randint(-32768, 32768, (n,), device="cuda", generator=gen,
                                     dtype=torch.int16)}
        got, stats, launched = kernel_path(sp, narrow_chains, data, f"narrow n={n}")
        want, _e = run_session(narrow_chains, data, "eager")
        dts = [gv.dtype for gv in got]
        if dts != [torch.uint8, torch.uint32, torch.int16, torch.int32]:
            raise AssertionError(f"narrow n={n}: dtypes {dts}")
        for i, (gv, wv) in enumerate(zip(got, want)):
            if not same_ints(gv, wv):
                raise AssertionError(f"narrow n={n} output {i}: kernel path and eager differ")
        typed_case(sp, ref, f"narrow n={n}", lowered(narrow_chains, data))
        log(f"[dtypes] narrow uint8/int16 chains n={n}: {stats}, launches {launched}; equal "
            f"to eager and the plain version; sums {as_int(got[1])} (uint32), "
            f"{as_int(got[3])} (int32)")
        del got, want, data

    # C9: Black-Scholes from float64 inputs is the float32 run, bit for bit
    fn, data32 = workloads_data["black_scholes"]
    got32, _s, _l = kernel_path(sp, fn, data32, "black_scholes float32")
    got64, stats, launched = kernel_path(sp, fn, {k: v.double() for k, v in data32.items()},
                                         "black_scholes from float64")
    for i, (a, b) in enumerate(zip(got64, got32)):
        if a.dtype != torch.float32 or not torch.equal(a, b):
            raise AssertionError(f"black_scholes from float64 output {i}: {a.dtype}, "
                                 "not the float32 run")
    log(f"[dtypes] black_scholes from float64 inputs: {stats}, launches {launched}; float32 "
        "outputs bit-equal to the float32 run")
    del got32, got64

    # the float32 programs on the typed kernel, re-timed
    for name, limit in F32_LIMIT_MS.items():
        launch = errs[name][1]
        ms = kernel_device_ms(lambda launch=launch: sp.split_pipeline(*launch), 10)
        log(f"[dtypes] float32 {name} re-timed on the typed kernel: {ms:.4f} ms device "
            f"(limit {limit} ms: {'within' if ms <= limit else 'OVER'})")
        rows[0].setdefault("float32_retime_ms", {})[name] = ms
    L2_ESTIMATE.clear(), L2_ESTIMATE.update(saved[0])
    LAUNCH_OUTPUTS.clear(), LAUNCH_OUTPUTS.update(saved[1])
    return rows


#: the rewrite records the CPU tests hold both packages to (rewrite on)
REWRITE_RECORDS = {
    "black_scholes": [("MZ502", "cse", "multiply#26"), ("MZ505", "declined", "31-node graph")],
    "haversine": [("MZ505", "declined", "16-node graph")],
}
#: the rewrite pass's own counters: analyses, replays of a script, and the
#: planner simulations MZ504 runs
REWRITE_COUNTERS = ("rewrite_passes", "rewrite_replays", "rewrite_simulations")
#: lowered instruction counts with the pass on and off
REWRITE_OPS = {"black_scholes": (31, 32), "haversine": (16, 16)}
#: (outputs, bytes per element) of the lowered program, pass on or off: the
#: node the pass retired keeps nothing escaping (ROADMAP C6)
REWRITE_IO = {"black_scholes": (2, 28), "haversine": (1, 12)}


def program_io(program) -> tuple:
    """(outputs, bytes per element through the kernel) of a float32 program."""
    return len(program.outputs), 4 * (program.n_split + len(program.outputs))


def rewrite_chain(executor: str, on: bool, x, dead_mat, mask):
    """The reference's ``smoke/rewrite`` chain (``benchmarks/run.py``): one
    dead branch with its own stage, one repeated call and one pushdown
    opportunity; handoff off, fixed chunking (n / 4), no tuner."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    def chain():                         # its intermediates die on return
        a = anp.exp(x)
        anp.matvec(dead_mat, a)
        b1 = anp.exp(x)
        b2 = anp.exp(x)
        s = anp.add(b1, b2)
        m = anp.multiply(x, 3.0)
        return s, anp.compress(mask, m)

    with mozart.session(executor=executor, rewrite=on, handoff=False, autotune=False,
                        batch_elements=x.numel() // 4) as ctx:
        s, f = chain()
        out = (s.value, f.value)
    torch.cuda.synchronize()
    return out, ctx


def phase_rewrite(sp, ref, workloads_data, oracles) -> dict:
    """The static rewrite pass on the card (any failed check raises):
    (a) Black-Scholes and Haversine at n = 2**27 on ``cuda``, the pass on
    (the default) against off: outputs bit-equal, equal to ``eager`` and the
    float64 oracle, the records the CPU tests find, the lowered programs'
    sizes, and the kernel's device time on both programs; (b) the
    ``smoke/rewrite`` chain at n = 2**26 on ``cuda`` and ``fused``."""
    from repro_torch.core import mozart, plan_cache, stage_exec
    result = {}
    for name in ("black_scholes", "haversine"):
        fn, data = workloads_data[name]
        atol = 1e-2 if name == "haversine" else 0.0
        with mozart.session(executor="eager"):
            want = [o.value for o in as_list(fn(**data))]
        got, recs = {}, {}
        for on in (True, False):
            sp.reset_counts()
            with mozart.session(executor="cuda", rewrite=on) as ctx:
                got[on] = [o.value for o in as_list(fn(**data))]
            torch.cuda.synchronize()
            recs[on] = [(r.code, r.kind, r.subject) for r in ctx._last_rewrites]
            st = ctx.stats
            if (st.get("cuda_stages", 0) != 1 or st.get("cuda_fallback_stages", 0)
                    or sp.split_pipeline.launches != 1):
                raise AssertionError(f"rewrite/{name} on={on}: {dict(st)}, launches "
                                     f"{sp.split_pipeline.launches}")
        if recs[True] != REWRITE_RECORDS[name] or recs[False] != []:
            raise AssertionError(f"rewrite/{name}: records {recs}")
        if not all(torch.equal(a, b) for a, b in zip(got[True], got[False])):
            raise AssertionError(f"rewrite/{name}: outputs differ with the pass on and off")
        check_outputs(f"rewrite/{name} on", got[True], want, oracles[name], atol)
        launches = {on: lowered(fn, data, on) for on in (True, False)}
        ops = tuple(len(launches[on][0].code) for on in (True, False))
        if ops != REWRITE_OPS[name]:
            raise AssertionError(f"rewrite/{name}: lowered {ops} instructions, expected "
                                 f"{REWRITE_OPS[name]}")
        io = tuple(program_io(launches[on][0]) for on in (True, False))
        if io != (REWRITE_IO[name],) * 2:
            raise AssertionError(f"rewrite/{name}: (outputs, B/element) on/off {io}, expected "
                                 f"{REWRITE_IO[name]} both (C6)")
        kinds = launches[False][3]
        err_off = 0.0
        for i, (kind, g, w) in enumerate(zip(kinds, sp.split_pipeline(*launches[False]),
                                             ref.split_pipeline_ref(*launches[False]))):
            err_off = max(err_off, compare(f"rewrite/{name} off-program output {i}", g, w,
                                           1e-4 if kind[0] == "reduce" else 2e-5))
        dev = {True: [], False: []}
        for order in ((True, False), (False, True)):          # in turns: a, b, b, a
            for on in order:
                dev[on].append(kernel_device_ms(
                    lambda on=on: sp.split_pipeline(*launches[on]), 10))
        dev = {on: statistics.median(v) for on, v in dev.items()}
        geo = {on: sp.program_geometry(launches[on][0], launches[on][3],
                                       torch.cuda.current_device()) for on in (True, False)}
        result[name] = {
            "rewrite_records": [list(r) for r in recs[True]],
            "program_ops_off": ops[1], "forwarded_off": launches[False][0].forwarded,
            "stored_slots_off": launches[False][0].stored_slots,
            "tile_off": geo[False].tile, "stages_off": geo[False].stages,
            "rewrite_on_ms": dev[True], "rewrite_off_ms": dev[False],
            "outputs_on": io[0][0], "bytes_per_element_on": io[0][1],
            "max_abs_err_off": err_off}
        log(f"[rewrite] {name} at n={N_MAIN} on cuda: records {recs[True]} (off: none); "
            f"outputs bit-equal on and off, equal to eager and the float64 oracle; program "
            f"on {ops[0]} ops ({launches[True][0].forwarded} forwarded, "
            f"{launches[True][0].stored_slots} stored slots, tile {geo[True].tile} x "
            f"{geo[True].stages}), off {ops[1]} ops ({launches[False][0].forwarded} "
            f"forwarded, {launches[False][0].stored_slots} stored slots, tile "
            f"{geo[False].tile} x {geo[False].stages}); (outputs, B/element) on {io[0]}, off "
            f"{io[1]}; kernel device ms on {dev[True]:.4f}, off {dev[False]:.4f} (on/off "
            f"{dev[True] / dev[False]:.4f}; medians of two rounds in turns)")
        del got, want, launches

    # (b) the smoke/rewrite chain on the card
    n = REWRITE_N
    x = torch.linspace(0.1, 1.0, n, device=DEVICE)
    dead_mat = torch.ones((REWRITE_DEAD_ROWS, n), device=DEVICE)
    mask = torch.arange(n, device=DEVICE) % 2 == 0
    chain = {}
    for ex in ("cuda", "fused"):
        plan_cache.clear()
        (on_s, on_f), on_ctx = rewrite_chain(ex, True, x, dead_mat, mask)
        (off_s, off_f), off_ctx = rewrite_chain(ex, False, x, dead_mat, mask)
        if not (torch.equal(on_s, off_s) and torch.equal(on_f, off_f)):
            raise AssertionError(f"rewrite/smoke {ex}: outputs differ on and off")
        compare(f"rewrite/smoke {ex} sum", on_s, 2.0 * torch.exp(x), 2e-5)
        compare(f"rewrite/smoke {ex} compress", on_f, (x * 3.0)[mask], 2e-5)
        codes = sorted({r["code"] for e in plan_cache.entries() for r in e.rewrites})
        if not {"MZ501", "MZ502", "MZ503"} <= set(codes):
            raise AssertionError(f"rewrite/smoke {ex}: records {codes}")
        bytes_on, bytes_off = (c.counters.bytes_interior() for c in (on_ctx, off_ctx))
        calls_on, calls_off = (c.stats.get("calls", 0) for c in (on_ctx, off_ctx))
        # The reference gates fused; on cuda the kernel's whole outputs merge
        # nothing, and the pushdown's filtered map reads a merged compress
        # output either way, so the interior bytes only may not rise.
        if not calls_on < calls_off or bytes_on > bytes_off \
                or (ex == "fused" and not bytes_on < bytes_off):
            raise AssertionError(f"rewrite/smoke {ex}: interior bytes on {bytes_on} off "
                                 f"{bytes_off}, calls on {calls_on} off {calls_off}")
        rewrite_chain(ex, True, x, dead_mat, mask)            # the second hit
        t0 = stage_exec.trace_count()
        (w_s, _w_f), warm = rewrite_chain(ex, True, x, dead_mat, mask)
        if (warm.stats.get("planner_calls", 0) or stage_exec.trace_count() != t0
                or warm.stats.get("exec_builds", 0) or not torch.equal(w_s, on_s)):
            raise AssertionError(f"rewrite/smoke {ex} warm: {dict(warm.stats)}, traces "
                                 f"{stage_exec.trace_count() - t0}")
        ms = {on: host_ms(lambda on=on: rewrite_chain(ex, on, x, dead_mat, mask), 3)
              for on in (True, False)}
        chain[ex] = {"interior_on": bytes_on, "interior_off": bytes_off, "calls_on": calls_on,
                     "calls_off": calls_off, "ms_on": ms[True], "ms_off": ms[False],
                     "cuda_fallback_stages_on": on_ctx.stats.get("cuda_fallback_stages", 0),
                     "cuda_fallback_stages_off": off_ctx.stats.get("cuda_fallback_stages", 0),
                     "stages_on": on_ctx.stats.get("stages", 0),
                     "stages_off": off_ctx.stats.get("stages", 0)}
        log(f"[rewrite] smoke/rewrite chain at n={n} (dead matvec {REWRITE_DEAD_ROWS} x {n}) "
            f"on {ex}: records {codes}; interior bytes on {bytes_on} off {bytes_off}; calls on "
            f"{calls_on} off {calls_off}; stages on {chain[ex]['stages_on']} off "
            f"{chain[ex]['stages_off']}; cuda_fallback_stages on "
            f"{chain[ex]['cuda_fallback_stages_on']} off {chain[ex]['cuda_fallback_stages_off']} "
            f"(compress is dynamic: its stage stays off the kernel); outputs bit-equal; the "
            f"warm third call: 0 planner calls, 0 traces or lowerings, 0 builds; host clock "
            f"(medians of 3 warm runs) on {ms[True]:.3f} ms, off {ms[False]:.3f} ms")
        del on_s, on_f, off_s, off_f, w_s
    result["smoke_rewrite"] = chain
    del x, dead_mat, mask
    torch.cuda.empty_cache()
    return result


def handoff_chain(x, executor: str, handoff: bool, first: str | None = None, **session):
    """The reference's ``smoke/handoff`` chain: three evaluations of
    ``multiply(add(x, 1.0), 0.5)``; the first runs on ``first`` (a ``cuda``
    row's on ``fused`` by default: a kernel stage merges its own outputs),
    the others on ``executor``; ``session`` adds session options."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    first = first or ("fused" if executor == "cuda" else executor)
    with mozart.session(executor=first, handoff=handoff, device=x.device, **session) as ctx:
        cur = x
        for i in range(HANDOFF_EVALS):
            cur = anp.multiply(anp.add(cur, 1.0), 0.5)
            mozart.evaluate()
            if i == 0 and first != executor:
                mozart.configure(executor=executor)
        out = cur.value
    torch.cuda.synchronize()
    return out, ctx


def pinned(ctx) -> list:
    """(executor, tuned batches, tiles) of every plan entry ``ctx`` used."""
    from repro_torch.core import plan_cache
    return [(e.key[0], dict(e.tuned_batch), dict(e.block_shape))
            for e in plan_cache.entries() if e.key in ctx._entry_keys]


def handoff_times(x, executor: str) -> dict:
    """Host-clock times (ms) of the chain with handoff on and off, in turns
    (on, off, off, on, ...) after one warm-up of each: per setting the
    median and the quartiles."""
    times = {True: [], False: []}
    for ho in (True, False):
        handoff_chain(x, executor, ho)
    for r in range(HANDOFF_ROUNDS):
        for ho in ((True, False) if r % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            handoff_chain(x, executor, ho)
            times[ho].append((time.perf_counter() - t0) * 1e3)
    return {ho: (statistics.median(v), *statistics.quantiles(v, n=4)[::2])
            for ho, v in times.items()}


def phase_handoff(sp, ref) -> dict:
    """Handoff on and off on the ``fused``, ``scan`` and ``cuda`` rows at
    n = 2**27; any failed check raises.  Returns the ``kernels`` row of the
    split pipeline on the chain's stage."""
    from repro_torch import hardware
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    x = torch.linspace(0.0, 1.0, N_MAIN, device=DEVICE)
    chip = hardware.chip_for(x.device)
    log(f"[handoff] chip from the card's properties: {chip.name}, L2 {chip.l2_bytes} B, "
        f"{chip.num_sms} SMs, {chip.hbm_bytes} B memory, {chip.vmem_bytes} B shared "
        f"memory per block; batch for the chain's 12 B/element stage "
        f"{hardware.mozart_batch_elements(12, chip)} elements")
    launches = 0
    for ex in ("fused", "scan", "cuda"):
        runs = {}
        for ho in (True, False):
            for _warm in range(2):      # plan (miss), then the first hit tunes
                handoff_chain(x, ex, ho)
            sp.reset_counts()
            out, ctx = handoff_chain(x, ex, ho)
            runs[ho] = (out, ctx, sp.split_pipeline.launches)
        (on, on_ctx, on_launches), (off, off_ctx, _l) = runs[True], runs[False]
        compare(f"handoff/{ex} on vs off", on, off, 2e-5)
        st = on_ctx.stats
        interior = on_ctx.counters.bytes_interior()
        on_bytes = interior + on_ctx.counters.bytes_terminal()
        off_bytes = off_ctx.counters.bytes_materialized()
        if interior != 0:
            events = [e for e in on_ctx.counters.materialize_events()
                      if e[0].startswith("interior:")]
            raise AssertionError(f"handoff/{ex}: {interior} interior bytes: {events}")
        if st.get("streamed_outputs", 0) == 0 or st.get("stream_ingests", 0) == 0:
            raise AssertionError(f"handoff/{ex}: no streaming: {dict(st)}")
        if st.get("planner_calls", 0) != 0:
            raise AssertionError(f"handoff/{ex}: a warm chain planned: {dict(st)}")
        if not on_bytes < off_bytes:
            raise AssertionError(f"handoff/{ex}: {on_bytes} boundary bytes on, "
                                 f"{off_bytes} off")
        if ex == "cuda":
            if st.get("cuda_fallback_stages", 0) or st.get("cuda_stages", 0) != 2 \
                    or on_launches != st["cuda_stages"]:
                raise AssertionError(f"handoff/cuda: {dict(st)}, launches {on_launches}")
            launches = on_launches
        ms = handoff_times(x, ex)
        paths = {k: v for k, v in st.items() if k.startswith("cuda_ingest_")}
        log(f"[handoff] {ex}: on {ms[True][0]:.3f} ms (quartiles {ms[True][1]:.3f}-"
            f"{ms[True][2]:.3f}), off {ms[False][0]:.3f} ms ({ms[False][1]:.3f}-"
            f"{ms[False][2]:.3f}) (host clock, medians of {HANDOFF_ROUNDS} rounds in "
            f"turns); boundary bytes on {on_bytes} (interior 0), off {off_bytes}; "
            f"streamed {st['streamed_outputs']}, ingests {st['stream_ingests']}, "
            f"donated {st.get('donated_chunks', 0)}, chunks {st.get('chunks', 0)}, "
            f"ingest paths {paths}, launches {on_launches}; pinned (executor, batches, "
            f"tiles) {pinned(on_ctx)}; stats {dict(st)}")
        del on, off, runs
    # The kernel on the chain's stage, against its plain version.
    with mozart.session(executor="cuda", device=x.device) as ctx:
        y = anp.multiply(anp.add(x, 1.0), 0.5)
        stage = ctx.last_plan()[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        from repro_torch.core import cuda_exec
        launch = cuda_exec.prepare_launch(stage, concrete, ctx)
        del y
    err = compare("handoff stage kernel vs plain", sp.split_pipeline(*launch)[0],
                  ref.split_pipeline_ref(*launch)[0], 2e-5)
    kernel = lambda: sp.split_pipeline(*launch)
    kernel_ms = kernel_device_ms(kernel, 10)
    plain_ms = cuda_ms(lambda: ref.split_pipeline_ref(*launch), 5)
    bytes_ms = 2 * 4 * N_MAIN / HBM_BYTES_PER_S * 1e3
    ops_ms = len(launch[0].code) * N_MAIN / F32_OPS_PER_S * 1e3
    row = {"name": "split_pipeline[handoff]", "route": "cuda", "source": SOURCE,
           "replaces": REPLACES, "launches": launches, "max_abs_err": err,
           "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None, "n": N_MAIN, "program_ops": len(launch[0].code)}
    log(f"[handoff] kernel on the chain's stage: {kernel_ms:.4f} ms device (bound "
        f"{row['bound_ms']:.4f} ms, {row['bound_ms'] / kernel_ms:.1%} of it), plain "
        f"{plain_ms:.3f} ms")
    return row


def check_outputs(what: str, got, want, oracle, atol: float) -> None:
    """Outputs equal to ``eager``'s (rtol 2e-5) and the float64 oracle on the
    2**20 prefix (the JAX benchmark's tolerances)."""
    for i, (gv, wv) in enumerate(zip(got, want)):
        if gv.shape != wv.shape or gv.dtype != wv.dtype or not bool(torch.isfinite(gv).all()):
            raise AssertionError(f"{what} output {i}: {gv.shape}/{gv.dtype}")
        compare(f"{what} output {i} vs eager", gv, wv, 2e-5, atol=atol)
    for i, (gv, (ref64, rtol, oatol)) in enumerate(zip(got, oracle)):
        if not np.allclose(gv[:ref64.shape[0]].double().cpu().numpy(), ref64,
                           rtol=rtol, atol=oatol):
            raise AssertionError(f"{what} output {i}: float64 oracle mismatch")


def quartiles(times: list) -> tuple:
    """(median, first quartile, third quartile) of ``times``."""
    q = statistics.quantiles(times, n=4)
    return statistics.median(times), q[0], q[2]


def timed_ms(fn) -> float:
    """Host-clock milliseconds of one call of ``fn`` ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_plans(sp, workloads_data, oracles, rewrites) -> dict:
    """The plan cache, the cost model and ``mozart.pipeline`` on the card;
    any failed check raises.  Returns, per workload, what the kernels rows
    carry: the pipeline's launches, the cold/warm/pipeline host times and
    the ``auto`` picks.  The host shares subtract the kernel's device time
    on the pass-on and pass-off programs that the rewrite phase measured
    (``rewrites``)."""
    import tempfile

    from repro_torch.core import mozart, plan_cache

    # 1. The smoke/handoff chain a second time: every evaluation replays.
    x = torch.linspace(0.0, 1.0, N_MAIN, device=DEVICE)
    for ex in ("fused", "scan", "cuda"):
        out, ctx = handoff_chain(x, ex, True)
        st = ctx.stats
        interior = ctx.counters.bytes_interior()
        if st.get("planner_calls", 0) != 0 or interior != 0 \
                or st.get("plan_cache_hits", 0) != HANDOFF_EVALS:
            raise AssertionError(f"plans/handoff/{ex}: planner calls "
                                 f"{st.get('planner_calls', 0)}, interior bytes {interior}: "
                                 f"{dict(st)}")
        log(f"[plans] handoff chain on {ex}, warm: {HANDOFF_EVALS} evaluations, "
            f"{st['plan_cache_hits']} plan-cache hits, 0 planner calls, 0 interior bytes, "
            f"terminal {ctx.counters.bytes_terminal()} B; pinned {pinned(ctx)}")
        del out
    del x

    result = {}
    for name in ("black_scholes", "haversine"):
        fn, data = workloads_data[name]
        atol = 1e-2 if name == "haversine" else 0.0
        with mozart.session(executor="eager"):
            want = [o.value for o in as_list(fn(**data))]

        # 2. mozart.pipeline(fn, executor="cuda"): lower, compile, 10 warm calls.
        p = mozart.pipeline(fn, executor="cuda")
        p.lower(**data)
        p.compile()
        stages = len(p.plan_entry.stage_templates)
        programs = [v[0] for k, v in p.plan_entry.exec_table().items()
                    if k[1] == "cuda" and isinstance(v, tuple)]
        io = [program_io(pr) for pr in programs]
        if io != [REWRITE_IO[name]]:
            raise AssertionError(f"plans/{name}: pinned programs' (outputs, B/element) {io}, "
                                 f"expected [{REWRITE_IO[name]}] (C6)")
        log(f"[plans] {name}: {p.describe()}; compile's last pass {p.last_call_stats}; the "
            f"pinned program writes {io[0][0]} output(s), {io[0][1]} B/element")
        sp.reset_counts()
        for call in range(PLAN_CALLS):
            before = sp.split_pipeline.launches
            got = as_list(p(**data))
            torch.cuda.synchronize()
            st = p.last_call_stats
            moved = sp.split_pipeline.launches - before
            if (st.get("planner_calls", 0) or st["jit_traces"] or st.get("exec_builds", 0)
                    or st.get("cuda_fallback_stages", 0) or moved != stages
                    or st.get("cuda_stages", 0) != stages or not p.warm()):
                raise AssertionError(f"plans/{name} call {call}: {st}, launches {moved} "
                                     f"for {stages} stages")
            check_outputs(f"plans/{name} call {call}", got, want, oracles[name], atol)
            del got
        launches = sp.split_pipeline.launches
        log(f"[plans] {name}: {PLAN_CALLS} warm pipeline calls, each with 0 planner calls, "
            f"0 traces or lowerings, 0 builds, {stages} launch(es) and no fallback stage "
            f"({launches} launches in all); outputs equal eager's and the float64 oracle")

        # 3. Host clock: cold session, warm session, pipeline call; the warm
        # ones also with the rewrite pass off (``rewrite=False``).
        def session_eval(rewrite=True):
            with mozart.session(executor="cuda", rewrite=rewrite):
                vals = [o.value for o in as_list(fn(**data))]
            return vals

        cold = []
        for _r in range(PLAN_ROUNDS):
            plan_cache.clear()
            cold.append(timed_ms(session_eval))
        p.compile()                              # the cache was cleared: pin again
        session_eval()                           # the session's first hit (the tuner)
        # The bound-arguments replay (arg_transparent): no capture, no lookup.
        fast = mozart.pipeline(fn, executor="cuda", arg_transparent=True)
        fast.lower(**data).compile()
        for call in range(3):                    # call 0 builds the retained replay
            before = sp.split_pipeline.launches
            got = as_list(fast(**data))
            torch.cuda.synchronize()
            st = fast.last_call_stats
            if (st.get("fast_path_calls", 0) != (call > 0) or st.get("planner_calls", 0)
                    or st["jit_traces"] or st.get("exec_builds", 0)
                    or sp.split_pipeline.launches - before != stages):
                raise AssertionError(f"plans/{name} arg_transparent call {call}: {st}")
            check_outputs(f"plans/{name} arg_transparent call {call}", got, want,
                          oracles[name], atol)
            del got
        p_off = mozart.pipeline(fn, executor="cuda", rewrite=False)
        p_off.lower(**data).compile()
        session_eval(False)
        session_eval(False)                      # the off session's first hit (the tuner)
        for f in (lambda: session_eval(False), lambda: p_off(**data)):
            before = sp.split_pipeline.launches
            check_outputs(f"plans/{name} rewrite off", as_list(f()), want, oracles[name], atol)
            if sp.split_pipeline.launches - before != stages:
                raise AssertionError(f"plans/{name} rewrite off: not on the kernel")
        if not p_off.warm():
            raise AssertionError(f"plans/{name} rewrite off pipeline: {p_off.last_call_stats}")
        warm, call, replay, warm_off, call_off = [], [], [], [], []
        legs = ((warm, session_eval), (call, lambda: p(**data)),
                (replay, lambda: fast(**data)), (warm_off, lambda: session_eval(False)),
                (call_off, lambda: p_off(**data)))
        for r in range(PLAN_ROUNDS):
            k = r % len(legs)
            for times, f in legs[k:] + legs[:k]:
                times.append(timed_ms(f))
        # The pass on warm calls: its script replayed, the analysis (and
        # MZ504's planner simulations) never re-run.
        with mozart.session(executor="cuda") as wctx:
            [o.value for o in as_list(fn(**data))]
        p(**data)
        rw_counts = {what: {k: st.get(k, 0) for k in REWRITE_COUNTERS}
                     for what, st in (("warm_session", wctx.stats),
                                      ("pipeline_call", p.last_call_stats))}
        if any(c["rewrite_passes"] or c["rewrite_simulations"] or c["rewrite_replays"] != 1
               for c in rw_counts.values()):
            raise AssertionError(f"plans/{name}: the pass ran on a warm call: {rw_counts}")
        log(f"[plans] {name} rewrite pass on warm calls (passes, replays, MZ504 planner "
            f"simulations): {rw_counts}")
        # device ms per call: one launch each, timed by the rewrite phase
        kernel_ms = rewrites[name]["rewrite_on_ms"]
        kernel_off_ms = rewrites[name]["rewrite_off_ms"]
        times = {"cold_ms": quartiles(cold), "warm_ms": quartiles(warm),
                 "pipeline_ms": quartiles(call), "fast_ms": quartiles(replay)}
        off_times = {"warm_off_ms": quartiles(warm_off),
                     "pipeline_off_ms": quartiles(call_off)}
        log(f"[plans] {name} host clock, medians of {PLAN_ROUNDS} rounds [quartiles] (cold: "
            f"plan cache cleared, so planning and lowering; the fx traces of the library "
            f"functions stay cached in the process; fast: arg_transparent, the retained "
            f"replay): "
            + "; ".join(f"{k[:-3]} {m:.3f} ms [{lo:.3f}-{hi:.3f}], host share "
                        f"{m - kernel_ms:.3f} ms" for k, (m, lo, hi) in times.items())
            + f"; kernel {kernel_ms:.4f} ms device (the rewrite phase's)")
        log(f"[plans] {name} rewrite pass off (rewrite=False), same rounds in turns: "
            + "; ".join(f"{k[:-3]} {m:.3f} ms [{lo:.3f}-{hi:.3f}], host share "
                        f"{m - kernel_off_ms:.3f} ms" for k, (m, lo, hi) in off_times.items())
            + f"; kernel {kernel_off_ms:.4f} ms device; pass on minus off, host share: warm "
            f"{(times['warm_ms'][0] - kernel_ms) - (off_times['warm_off_ms'][0] - kernel_off_ms):+.3f}"
            f" ms, pipeline call "
            f"{(times['pipeline_ms'][0] - kernel_ms) - (off_times['pipeline_off_ms'][0] - kernel_off_ms):+.3f} ms")
        for what, f in (("warm session", session_eval), ("pipeline call", lambda: p(**data))):
            log(f"[plans] {name} host profile of a {what}: " + host_profile(f, PLAN_ROUNDS))

        # 4. executor="auto": the first hit measures and pins cuda.
        def auto_eval():
            with mozart.session(executor="auto") as actx:
                vals = [o.value for o in as_list(fn(**data))]
            return vals, actx

        plan_cache.clear()
        _v, a_miss = auto_eval()
        vals, a_hit = auto_eval()
        torch.cuda.synchronize()
        (entry,) = [e for e in plan_cache.entries() if e.key in a_hit._entry_keys]
        picks, timings = dict(entry.chosen_exec), dict(entry.exec_timings)
        if a_hit.stats.get("auto_measured_stages", 0) != len(entry.stage_templates) \
                or set(picks.values()) != {"cuda"}:
            raise AssertionError(f"plans/{name} auto: picks {picks}, timings {timings}, "
                                 f"{dict(a_hit.stats)}")
        check_outputs(f"plans/{name} auto", vals, want, oracles[name], atol)
        for _r in range(3):
            vals, a_warm = auto_eval()
            st = a_warm.stats
            if st.get("auto_measured_stages", 0) or st.get("planner_calls", 0) \
                    or st.get("auto_pick_cuda", 0) != len(entry.stage_templates) \
                    or st.get("cuda_fallback_stages", 0):
                raise AssertionError(f"plans/{name} auto warm: {dict(st)}")
        miss_picks = {k: v for k, v in a_miss.stats.items() if k.startswith("auto_pick")}
        log(f"[plans] {name} auto: the miss picked {miss_picks} (analytic); the first "
            f"hit measured {a_hit.stats['auto_measured_stages']} stage(s) "
            f"and pinned {picks}; measured seconds {timings}; warm calls: 0 measurements, "
            f"0 planner calls, every stage on cuda")

        # 5. Persistence: save, clear, load, one auto session.
        with tempfile.TemporaryDirectory() as td:
            path = f"{td}/plans.json"
            saved = plan_cache.save(path)
            plan_cache.clear()
            loaded = plan_cache.load(path)
            vals, w_ctx = auto_eval()
            st = w_ctx.stats
            if not (loaded > 0 and st.get("planner_calls", 0) == 0
                    and st.get("autotuned_stages", 0) == 0
                    and st.get("auto_measured_stages", 0) == 0
                    and st.get("auto_pick_cuda", 0) == len(entry.stage_templates)):
                raise AssertionError(f"plans/{name} warm start: saved {saved}, loaded "
                                     f"{loaded}, {dict(st)}")
        check_outputs(f"plans/{name} warm start", vals, want, oracles[name], atol)
        log(f"[plans] {name} warm start: saved {saved}, loaded {loaded}; one auto session "
            f"with 0 planner calls, 0 tuning runs, 0 measurements: {dict(st)}")
        result[name] = {"plans_launches": launches, "pipeline_calls": PLAN_CALLS,
                        **times, **off_times, "rewrite_counts": rw_counts,
                        "auto_picks": {str(k): v for k, v in picks.items()},
                        "auto_timings_s": {str(k): v for k, v in timings.items()}}
        del p, p_off, fast, vals, want
        torch.cuda.empty_cache()
    return result


def phase_chaos(sp, ref, workloads_data, errs) -> dict:
    """The reference's ``smoke/chaos`` on the card, scenarios 1 and 2 (the
    serving wave runs in the serve phase, ``serve_chaos_wave``); any failed
    check raises.  (1) ``compile:fail:1`` on Black-Scholes at n = 2**27
    through ``mozart.pipeline(executor="cuda")``: the reference's walk
    ``cuda -> sharded -> scan`` (no mesh: ``sharded`` raises), ``cuda`` and
    ``sharded`` quarantined on the entry, then ``CHAOS_TTL - 1`` warm calls
    on ``scan`` with no launch and the next on the kernel again, equal to its
    plain version; (2) ``chunk:oom:1`` on the handoff chain at 2**27 on
    ``fused``: bounded halvings, the fault-free answer.  The same
    ``compile:fail:1`` with the card mesh runs in ``phase_sharded``, which
    owns the process group (``sharded_chaos``)."""
    from repro_torch.core import mozart, plan_cache, resilience
    fn, data = workloads_data["black_scholes"]
    _err, launch = errs["black_scholes"]
    plain_all = ref.split_pipeline_ref(*launch)
    plain = [plain_all[j] for j in LAUNCH_OUTPUTS[fn.__name__]]
    del plain_all
    with mozart.session(executor="cuda"):
        want = [o.value for o in as_list(fn(**data))]
    torch.cuda.synchronize()
    resilience.clear_events()
    plan_cache.clear()
    ttl = resilience.QUARANTINE_TTL
    resilience.QUARANTINE_TTL = CHAOS_TTL
    try:
        p = mozart.pipeline(fn, executor="cuda")
        sp.reset_counts()
        with mozart.inject_faults("compile:fail:1") as plan:
            got = as_list(p(**data))
        torch.cuda.synchronize()
        st = p.last_call_stats
        (entry,) = plan_cache.entries()
        quarantined = {k: dict(v) for k, v in entry.quarantined.items()}
        if (plan.fired != [("compile", "stage 0 cuda")] or st.get("exec_demotions", 0) != 2
                or st.get("exec_demoted_to_sharded", 0) != 1
                or st.get("exec_demoted_to_scan", 0) != 1 or sp.split_pipeline.launches
                or quarantined != {0: {"cuda": 0, "sharded": 0}}):
            raise AssertionError(f"chaos/compile: fired {plan.fired}, {st}, launches "
                                 f"{sp.split_pipeline.launches}, quarantined {quarantined}")
        for i, (g, w) in enumerate(zip(got, want)):
            compare(f"chaos/compile demoted call output {i} vs fault-free", g, w, 2e-5)
        trail = []
        for _call in range(CHAOS_TTL):
            before = sp.split_pipeline.launches
            got = as_list(p(**data))
            torch.cuda.synchronize()
            st = p.last_call_stats
            trail.append((st.get("exec_quarantine_skips", 0),
                          sp.split_pipeline.launches - before, st.get("cuda_stages", 0)))
        if trail != [(1, 0, 0)] * (CHAOS_TTL - 1) + [(0, 1, 1)] or entry.quarantined:
            raise AssertionError(f"chaos/compile: (skips, launches, cuda stages) per warm call "
                                 f"{trail}; quarantined {entry.quarantined}")
        err = max(compare(f"chaos/compile relaunched output {i} vs plain", g, w, 2e-5)
                  for i, (g, w) in enumerate(zip(got, plain)))
    finally:
        resilience.QUARANTINE_TTL = ttl
    compile_counts = {k: int(resilience.stats.get(k, 0)) for k in RESILIENCE_KEYS}
    log(f"[chaos] compile:fail:1 on black_scholes n={N_MAIN}, mozart.pipeline(cuda): "
        f"fired {plan.fired}; 2 demotions cuda -> sharded -> scan, quarantined "
        f"{quarantined}; output "
        f"equal to the fault-free run; QUARANTINE_TTL {CHAOS_TTL}: (skips, launches, cuda "
        f"stages) per warm call {trail}; the relaunch agrees with the plain version (max "
        f"|kernel - plain| {err:.3e}); MZ4xx {compile_counts}")
    del got, want, plain
    resilience.clear_events()

    x = torch.linspace(0.0, 1.0, N_MAIN, device=DEVICE)
    plan_cache.clear()
    want, _ctx = handoff_chain(x, "fused", True)
    plan_cache.clear()
    with mozart.inject_faults("chunk:oom:1") as plan:
        got, ctx = handoff_chain(x, "fused", True)
    halvings = ctx.stats.get("chunk_oom_halvings", 0)
    if (not plan.fired or not 1 <= halvings <= resilience.MAX_OOM_HALVINGS
            or ctx.stats.get("exec_demotions", 0)):
        raise AssertionError(f"chaos/oom: fired {plan.fired}, {dict(ctx.stats)}")
    compare("chaos/oom chain vs fault-free", got, want, 2e-5)
    pins = pinned(ctx)
    oom_counts = {k: int(resilience.stats.get(k, 0)) for k in RESILIENCE_KEYS}
    log(f"[chaos] chunk:oom:1 on the handoff chain n={N_MAIN}, fused: fired {plan.fired}; "
        f"{halvings} halving(s) (at most {resilience.MAX_OOM_HALVINGS}), 0 demotions, output "
        f"equal to the fault-free run; pinned (executor, batches, tiles) {pins}; MZ4xx "
        f"{oom_counts}")
    resilience.clear_events()
    del x, got, want
    torch.cuda.empty_cache()
    return {"compile": {"trail": trail, "quarantined": {str(k): v for k, v in
                                                         quarantined.items()},
                        "mz": compile_counts, "max_abs_err": err},
            "oom": {"halvings": halvings, "mz": oom_counts}}


def host_profile(fn, reps: int, top: int = 8) -> str:
    """Where a warm call's host time goes: ``cProfile`` over ``reps`` calls,
    the ``top`` functions by own time, in ms per call (cProfile's hooks
    inflate every figure; the shares are what it is for), and the total."""
    import cProfile
    import pstats
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:top]
    total = st.total_tt / reps * 1e3
    return (f"{total:.3f} ms per call under cProfile; by own time: " + "; ".join(
        f"{Path(f).name}:{line} {func} {tt / reps * 1e3:.3f} ms "
        f"(cumulative {ct / reps * 1e3:.3f})"
        for (f, line, func), (_cc, _nc, tt, ct, _callers) in rows))


class _OldInstr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint8), ("dst", ctypes.c_uint8),
                ("a", ctypes.c_uint16), ("b", ctypes.c_uint16), ("c", ctypes.c_uint16)]


class _OldParams(ctypes.Structure):
    """The parameter block of the split-pipeline kernel before persistent
    CTAs (one 1024-element tile per CTA, every result in a slot)."""
    _fields_ = [("n", ctypes.c_int64), ("inp", ctypes.c_void_p * 16),
                ("out", ctypes.c_void_p * 16), ("n_in", ctypes.c_int),
                ("n_slots", ctypes.c_int), ("n_scalars", ctypes.c_int),
                ("n_instr", ctypes.c_int), ("n_out", ctypes.c_int), ("pad_", ctypes.c_int),
                ("in_bool", ctypes.c_uint8 * 16), ("out_kind", ctypes.c_uint8 * 16),
                ("out_src", ctypes.c_uint16 * 16), ("scalars", ctypes.c_float * 64),
                ("code", _OldInstr * 256)]


def load_old_split_pipeline(source: str):
    """Build and load another version of ``csrc/split_pipeline.cu`` with the
    older parameter block (``_OldParams``)."""
    from repro_torch.kernels import build as kernel_build
    path = Path(source).resolve()
    _lib_path, secs, compiler_log = kernel_build.build(path)
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[times] {source} ptxas: {line.strip()}")

    def configure(lib):
        lib.split_pipeline_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.split_pipeline_launch.restype = ctypes.c_int
        lib.split_pipeline_params_size.argtypes = []
        lib.split_pipeline_params_size.restype = ctypes.c_int
        if lib.split_pipeline_params_size() != ctypes.sizeof(_OldParams):
            raise RuntimeError(f"{source}: not the older parameter block")
    return kernel_build.load(path, configure)


def old_split_pipeline(lib, launch):
    """A launch of the older kernel on ``launch``'s inputs with the program
    before forwarding (``program.unmarked``): returns (run, result), where
    ``result()`` gives the outputs as the wrapper would.  No launch count."""
    from repro_torch.kernels import program as P
    from repro_torch.kernels import split_pipeline as sp
    program, split_inputs, bcasts, kinds = launch
    prog = P.unmarked(program)
    n = split_inputs[0].numel()
    grid = -(-n // 1024)
    p = _OldParams(n=n, n_in=prog.n_split, n_slots=prog.n_slots, n_scalars=prog.n_scalars,
                   n_instr=len(prog.code), n_out=len(kinds))
    for i, (op, dst, a, b, c) in enumerate(prog.code):
        p.code[i] = _OldInstr(op, dst, a, b, c)
    for i, v in enumerate([*(float(x) for x in bcasts), *prog.imms]):
        p.scalars[i] = v
    for i, x in enumerate(split_inputs):
        p.inp[i], p.in_bool[i] = x.data_ptr(), x.dtype == torch.bool
    bufs = []
    for j, ((kind, op), (src, is_bool)) in enumerate(zip(kinds, prog.outputs)):
        if kind == "reduce":
            bufs.append(torch.empty(grid, dtype=torch.float32, device="cuda"))
        else:
            bufs.append(torch.empty(n, dtype=torch.bool if is_bool else torch.float32,
                                    device="cuda"))
        p.out_kind[j] = sp._OUT_KIND[(kind, op) if kind == "reduce" else (kind, bool(is_bool))]
        p.out[j], p.out_src[j] = bufs[-1].data_ptr(), src
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.split_pipeline_launch(ctypes.addressof(p), torch.cuda.current_device(), stream)
        if rc:
            raise RuntimeError(f"older split_pipeline launch failed ({rc})")

    def result():
        return [sp._COMBINE[op](b) if kind == "reduce" else b
                for (kind, op), b in zip(kinds, bufs)]
    return run, result


def phase_times(sp, ref, workloads_data, errs, launches, compare_sources=()) -> list:
    """Per workload: the kernel's device time (``torch.profiler``) and
    CUDA-event time beside its bound, each geometry of the rule's list, the
    builds of ``compare_sources`` (older versions of the kernel), the plain
    version, and the ``eager``, ``fused`` and ``cuda`` executors."""
    from repro_torch.core import mozart
    olds = {src: load_old_split_pipeline(src) for src in compare_sources}
    rows = []
    for name, (fn, data) in workloads_data.items():
        err, launch = errs[name]
        program, split_inputs, _bcasts, kinds = launch
        n = split_inputs[0].numel()
        bytes_ms = launch_bytes(launch) / HBM_BYTES_PER_S * 1e3
        ops_ms = len(program.code) * n / F32_OPS_PER_S * 1e3
        kernel = lambda launch=launch: sp.split_pipeline(*launch)
        fns = {"kernel": kernel}
        for src, lib in olds.items():
            run, result = old_split_pipeline(lib, launch)
            run()
            for i, (gv, wv) in enumerate(zip(result(), kernel())):
                compare(f"{name} output {i}: {src} vs kernel", gv, wv,
                        1e-4 if kinds[i][0] == "reduce" else 2e-5)
            fns[src] = run
        geo = sp.program_geometry(program, kinds, torch.cuda.current_device())
        for tile, stages in itertools.product(sp.TILES, sp.STAGES):
            if (tile, stages) != (geo.tile, geo.stages) and \
                    sp.sized(program, kinds, tile, stages).smem <= sp.SMEM_PER_BLOCK:
                g = sp.sized(program, kinds, tile, stages)
                fns[f"{tile}x{stages}"] = lambda launch=launch, g=g: sp._launch(*launch, geom=g)
        dev = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):      # in turns: a, b, b, a
            for k in order:
                dev[k].append(kernel_device_ms(fns[k], 10))
        dev = {k: statistics.median(v) for k, v in dev.items()}
        kernel_ms = dev["kernel"]
        event_ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(lambda launch=launch: ref.split_pipeline_ref(*launch), 5)

        def executor_run(ex, fn=fn, data=data):
            with mozart.session(executor=ex) as ctx:
                outs = fn(**data)
                outs = outs if isinstance(outs, tuple) else (outs,)
                vals = [o.value for o in outs]
            return vals, ctx

        e2e, pins = {}, {}
        for ex in ("eager", "fused", "scan", "cuda"):
            _v, ectx = executor_run(ex)     # a miss or the first hit (the tuner)
            e2e[ex] = host_ms(lambda ex=ex: executor_run(ex), 3)   # warm hits
            pins[ex] = pinned(ectx)         # the entry as the tuner left it
        _v, fctx = executor_run("fused")
        row = {
            "name": f"split_pipeline[{name}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "n": n, "program_ops": len(program.code),
            "outputs": len(program.outputs),
            "forwarded": program.forwarded, "stored_slots": program.stored_slots,
            "tile": geo.tile, "stages": geo.stages, "smem": geo.smem, "event_ms": event_ms,
            "compare_ms": {k: v for k, v in dev.items() if k != "kernel"},
            "eager_ms": e2e["eager"], "fused_ms": e2e["fused"], "scan_ms": e2e["scan"],
            "cuda_executor_ms": e2e["cuda"], "fused_chunks": fctx.stats["chunks"],
            "pinned": {ex: p[0][1:] if p else None for ex, p in pins.items()},
        }
        rows.append(row)
        log(f"[times] {name} n={n}: kernel {kernel_ms:.4f} ms device, {event_ms:.4f} ms "
            f"CUDA events (bound {row['bound_ms']:.3f} ms by {row['bound_by']}, "
            f"{row['bound_ms'] / kernel_ms:.1%} of it; {len(program.outputs)} outputs; tile "
            f"{geo.tile}, {geo.stages} stages, "
            f"{geo.smem} B shared memory), plain {plain_ms:.3f} ms, "
            f"eager executor {e2e['eager']:.3f} ms, fused executor "
            f"{e2e['fused']:.3f} ms ({fctx.stats['chunks']} chunks), scan executor "
            f"{e2e['scan']:.3f} ms, cuda executor {e2e['cuda']:.3f} ms (warm evaluations, "
            f"host clock); pinned (batches, tiles) {row['pinned']} against the L2 "
            f"estimate of {L2_ESTIMATE[fn.__name__]} elements per chunk")
        log(f"[times] {name} device ms, medians of two rounds in turns: "
            + ", ".join(f"{k} {v:.4f}" for k, v in dev.items()))
    return rows

# ---------------------------------------------------------------------------
# fused AdamW
# ---------------------------------------------------------------------------


def compare_big(what: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float) -> float:
    """``compare`` slice by slice (bounded memory at a leaf's full size)."""
    g, w = got.reshape(-1), want.reshape(-1)
    return max(compare(f"{what}[{i}:]", g[i:i + CHUNK], w[i:i + CHUNK], rtol)
               for i in range(0, w.numel(), CHUNK))


def bf16_within_one_ulp(what: str, got: torch.Tensor, want: torch.Tensor,
                        scale: torch.Tensor) -> float:
    """Assert every bfloat16 ``got`` lies within one bfloat16 ulp of
    ``want``, the ulp taken at the larger of |want| and |scale| (the
    parameter before the step: where ``p - lr * u`` cancels, float32
    results an ulp of p apart round to bfloat16 values many ulps of the
    tiny result apart).  Returns the largest absolute difference."""
    g, w, s = got.reshape(-1), want.reshape(-1), scale.reshape(-1)
    worst = 0.0
    for i in range(0, w.numel(), CHUNK):
        gf, wf = g[i:i + CHUNK].float(), w[i:i + CHUNK].float()
        mag = torch.maximum(wf.abs(), s[i:i + CHUNK].float().abs())
        _m, e = torch.frexp(mag)
        ulp = torch.where(mag == 0, torch.finfo(torch.bfloat16).smallest_normal,
                          torch.ldexp(torch.ones_like(mag), e - 8))
        diff = (gf - wf).abs()
        if bool((diff > ulp).any()):
            j = int(torch.argmax(diff - ulp))
            raise AssertionError(f"{what}: {float(gf[j])} vs {float(wf[j])} is "
                                 "more than one bfloat16 ulp apart")
        worst = max(worst, float(diff.max()))
    return worst


def check_adamw_outputs(what: str, got, want, p_in: torch.Tensor, rtol: float) -> float:
    """New (p, m, v) against a reference: float32 within ``rtol`` (atol
    2e-5 * max|ref|), bfloat16 p within one bfloat16 ulp at the scale of
    the result and of ``p_in``, the parameter before the step."""
    (gp, gm, gv), (wp, wm, wv) = got, want
    if gp.dtype == torch.bfloat16:
        err = bf16_within_one_ulp(f"{what} p", gp, wp, p_in)
    else:
        err = compare_big(f"{what} p", gp, wp, rtol)
    return max(err, compare_big(f"{what} m", gm, wm, rtol),
               compare_big(f"{what} v", gv, wv, rtol))


def adamw_inputs(n: int, dtype: torch.dtype, gen: torch.Generator):
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    g = torch.randn(n, generator=gen, device="cuda").to(dtype)
    m = torch.randn(n, generator=gen, device="cuda") * 0.01
    v = (torch.randn(n, generator=gen, device="cuda") * 0.01).abs()
    return p, g, m, v


def train_config():
    from repro_torch.configs.registry import get_config
    return get_config("gemma-7b").with_runtime(n_layers=TRAIN_LAYERS)


def library_adamw_ms(p, g, m, v, lr: float, step: int, gscale: float) -> float:
    """``torch._fused_adamw_`` (in place, on copies) for the same step:
    the op folds the weight decay into p and divides g by ``grad_scale``."""
    ps, gs, ms, vs = p.clone(), g.clone(), m.clone(), v.clone()
    steps = torch.full((), float(step), dtype=torch.float32, device=p.device)
    inv = torch.full((), 1.0 / gscale, dtype=torch.float32, device=p.device)

    def run():
        torch._fused_adamw_([ps], [gs], [ms], [vs], [], [steps], lr=lr,
                            beta1=0.9, beta2=0.95, weight_decay=ADAMW_WD,
                            eps=ADAMW_EPS, amsgrad=False, maximize=False,
                            grad_scale=inv, found_inf=None)

    return cuda_ms(run, 10)


def phase_adamw_kernel(fa, ref) -> dict:
    """The kernel against its plain version, then every train-phase leaf at
    its real size, timed beside its plain version and the library call."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for n in ADAMW_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            p, g, m, v = adamw_inputs(n, dtype, gen)
            for step in (1, 7):
                for gscale in (1.0, 0.5):
                    sc = fa.scalar_row(1e-3, 0.9, 0.95,
                                       torch.tensor(step, dtype=torch.int32, device="cuda"),
                                       gscale)
                    got = fa.fused_adamw(p, g, m, v, sc, eps=ADAMW_EPS, wd=ADAMW_WD)
                    want = ref.adamw_ref(p, g, m, v, sc, eps=ADAMW_EPS, wd=ADAMW_WD)
                    torch.cuda.synchronize()
                    worst = max(worst, check_adamw_outputs(
                        f"fused_adamw n={n} {dtype} step={step} gscale={gscale}",
                        got, want, p, 2e-5))
                    del got, want
            del p, g, m, v
    log(f"[adamw] n in {ADAMW_SIZES}, float32 and bfloat16, steps 1 and 7, "
        f"gscale 1 and 0.5: max |kernel - plain| = {worst:.3e}")
    # a view off the 16-byte grid takes the scalar loop
    p, g, m, v = adamw_inputs(70002, torch.float32, gen)
    sc = fa.scalar_row(1e-3, 0.9, 0.95, torch.tensor(3, dtype=torch.int32, device="cuda"), 0.5)
    views = [x[1:] for x in (p, g, m, v)]
    check_adamw_outputs("fused_adamw misaligned",
                        fa.fused_adamw(*views, sc, eps=ADAMW_EPS, wd=ADAMW_WD),
                        ref.adamw_ref(*views, sc, eps=ADAMW_EPS, wd=ADAMW_WD),
                        views[0], 2e-5)
    del p, g, m, v, views

    leaves = weights.flatten(tfm.init_model(train_config(), None, "meta").tree())
    lr, step, gscale = 3e-4, 1, 0.5
    sc = fa.scalar_row(lr, 0.9, 0.95, torch.tensor(step, dtype=torch.int32, device="cuda"),
                       gscale)
    rows, real_worst = {}, 0.0
    for name, meta in leaves.items():
        n = meta.numel()
        p, g, m, v = adamw_inputs(n, meta.dtype, gen)
        run = lambda: fa.fused_adamw(p, g, m, v, sc, eps=ADAMW_EPS, wd=ADAMW_WD)
        plain = lambda: ref.adamw_ref(p, g, m, v, sc, eps=ADAMW_EPS, wd=ADAMW_WD)
        err = check_adamw_outputs(f"fused_adamw leaf {name}", run(), plain(), p, 2e-5)
        real_worst = max(real_worst, err)
        row = {"n": n, "dtype": str(meta.dtype).split(".")[-1],
               # p, g read and p written in p's dtype; m, v read and written
               # in float32; the scalar row read once
               "bytes": n * (3 * p.element_size() + 16) + 32,
               "ms": cuda_ms(run, 10), "plain_ms": cuda_ms(plain, 3),
               "library_ms": None, "max_abs_err": err}
        try:
            row["library_ms"] = library_adamw_ms(p, g, m, v, lr, step, gscale)
        except RuntimeError as e:          # the library op refuses this dtype mix
            row["library_refused"] = str(e).splitlines()[0][:120]
        rows[name] = row
        log(f"[adamw] leaf {name} n={n} {row['dtype']}: kernel {row['ms']:.3f} ms, "
            f"plain {row['plain_ms']:.3f} ms, torch._fused_adamw_ "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 3)} ms, "
            f"max |kernel - plain| {err:.3e}")
        del p, g, m, v, run, plain
        torch.cuda.empty_cache()
    return {"leaves": rows, "max_abs_err": max(worst, real_worst)}


MOZART_GROUPS = (  # leaves per Mozart session; equal-size leaves share a stage
    ("embed", "final_norm", "layers.ln1", "layers.ln2"),
    ("layers.attn.wk", "layers.attn.wo", "layers.attn.wq", "layers.attn.wv"),
    ("layers.mlp.w_gate",), ("layers.mlp.w_in",), ("layers.mlp.w_out",))


@torch.no_grad()
def step1_paths(fa, ref, params, grads, state, opt_cfg) -> dict:
    """On step 1's gradients: the kernel path against the ``jnp`` path and
    the plain version, leaf by leaf under the step's one scalar row, then
    ``mozart_adamw_update(executor="cuda")`` against the kernel path, each
    group's split-pipeline kernels and fused AdamW kernels timed by
    ``torch.profiler`` (returned per group).  One leaf (or one Mozart group)
    at a time: three full copies of the new state would not fit beside the
    training state.  Launches made here compare paths and are not counted
    as the main path's."""
    from repro_torch.optim import adamw
    from repro_torch.optim.mozart_adamw import mozart_adamw_update
    counted = fa.fused_adamw.launches
    sc, _lr, _gn = adamw.step_scalars(opt_cfg, state.step + 1, grads)
    vs_jnp = vs_plain = 0.0
    for name, p in params.items():
        g, m, v = grads[name], state.m[name], state.v[name]
        kernel = adamw.update_leaf(p, g, m, v, sc, opt_cfg, "kernel")
        jnp_path = adamw.update_leaf(p, g, m, v, sc, opt_cfg, "jnp")
        vs_jnp = max(vs_jnp, check_adamw_outputs(f"step 1 {name} kernel vs jnp path",
                                                 kernel, jnp_path, p, 3e-5))
        del jnp_path
        plain = ref.adamw_ref(p.reshape(-1), g.reshape(-1), m.reshape(-1),
                              v.reshape(-1), sc, eps=opt_cfg.eps, wd=opt_cfg.weight_decay)
        vs_plain = max(vs_plain, check_adamw_outputs(
            f"step 1 {name} kernel vs plain", [t.reshape(-1) for t in kernel], plain, p,
            2e-5))
        del kernel, plain
    torch.cuda.synchronize()
    log(f"[train] step 1, 11 leaves: max |kernel path - jnp path| = {vs_jnp:.3e} "
        f"(rtol 3e-5; bfloat16 p within one ulp), max |kernel - plain| = {vs_plain:.3e}")

    assert sorted(n for grp in MOZART_GROUPS for n in grp) == sorted(params)
    totals: dict = {}
    groups: dict = {}
    for grp in MOZART_GROUPS:
        sub = lambda d, grp=grp: {n: d[n] for n in grp}
        sstate = adamw.AdamWState(state.step, sub(state.m), sub(state.v))
        # one split-pipeline launch per Mozart stage: leaves of one size share one
        stages = len({params[n].numel() for n in grp})
        sp_ms, sp_launches, (mp, ms, metrics) = profiled_kernels(
            lambda: mozart_adamw_update(sub(params), sub(grads), sstate, opt_cfg,
                                        executor="cuda"), "split_pipeline", expect=stages)
        fa_ms, fa_launches, (kp, ks, _) = profiled_kernels(
            lambda: adamw.update(sub(params), sub(grads), sstate, opt_cfg, path="kernel"),
            "fused_adamw", expect=len(grp))
        torch.cuda.synchronize()
        # the split-pipeline kernel reads p, g (as float32), m and v and
        # writes p, m and v: 28 bytes per element
        n_group = sum(params[n].numel() for n in grp)
        bound_ms = 28 * n_group / HBM_BYTES_PER_S * 1e3
        st = metrics["stats"]
        if st.get("cuda_fallback_stages", 0) or st.get("cuda_stages", 0) != st["stages"]:
            raise AssertionError(f"mozart {grp}: not every stage on the kernel: {st}")
        err = max(check_adamw_outputs(f"mozart vs kernel path {n}",
                                      (mp[n], ms.m[n], ms.v[n]),
                                      (kp[n], ks.m[n], ks.v[n]), params[n], 3e-5)
                  for n in grp)
        for k in ("stages", "cuda_stages", "cuda_fallback_stages"):
            totals[k] = totals.get(k, 0) + st.get(k, 0)
        log(f"[train] mozart_adamw_update(executor=\"cuda\") on {', '.join(grp)}: "
            f"stages {st['stages']}, cuda_stages {st.get('cuda_stages', 0)}, "
            f"cuda_fallback_stages {st.get('cuda_fallback_stages', 0)}; "
            f"max |mozart - kernel path| = {err:.3e}; device time: split_pipeline "
            f"{sp_ms:.3f} ms over {sp_launches:.0f} launches (bound {bound_ms:.3f} ms by "
            f"bytes, {bound_ms / sp_ms:.1%} of it, {n_group} elements), fused_adamw path "
            f"{fa_ms:.3f} ms over {fa_launches:.0f} launches")
        groups[", ".join(grp)] = {"elements": n_group, "split_pipeline_ms": sp_ms,
                                  "split_pipeline_launches": sp_launches,
                                  "bound_ms": bound_ms, "fused_adamw_ms": fa_ms,
                                  "max_abs_diff": err}
        del mp, ms, kp, ks
    log(f"[train] mozart totals: {totals}")
    fa.fused_adamw.launches = counted
    return groups


def phase_train(fa, sp, ref) -> dict:
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import lm, weights
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import param_count
    from repro_torch.optim import adamw

    cfg = train_config()
    a = cfg.attn
    log(f"[train] {cfg.name} at its published widths: d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, {a.n_heads}x{a.head_dim} heads (kv {a.n_kv_heads}), "
        f"vocab {cfg.vocab_size}, {cfg.activation} gated MLP, {cfg.dtype}; "
        f"n_layers {cfg.n_layers} (cut from 28: the only reduction), "
        f"{param_count(cfg) / 1e9:.3f} B parameters; batch {TRAIN_BATCH}, "
        f"seq {TRAIN_SEQ}, random weights (seed 0)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    log(f"[train] {opt_cfg}")
    state = adamw.init(weights.leaves(model))
    batch = DataPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cuda").batch_for_step(0)
    n_leaves = len(state.m)

    fa.fused_adamw.launches = 0
    sp.split_pipeline.launches = 0
    losses, step_ms, opt_ms = [], [], []
    for step in range(TRAIN_STEPS):       # overfit one batch (tests/test_system.py)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        loss = lm.loss_fn(model, batch, cfg)
        loss.backward()
        torch.cuda.synchronize()
        fwd_bwd = time.perf_counter() - t0
        params = weights.leaves(model)
        grads = {n: p.grad for n, p in params.items()}
        if step == 0:
            groups = step1_paths(fa, ref, params, grads, state, opt_cfg)
        before = fa.fused_adamw.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new_p, state, metrics = adamw.update(params, grads, state, opt_cfg, path="kernel")
        del grads, params
        model.zero_grad(set_to_none=True)
        weights.assign(model, new_p)
        del new_p
        torch.cuda.synchronize()
        opt = time.perf_counter() - t1
        launched = fa.fused_adamw.launches - before
        losses.append(loss.item())
        step_ms.append((fwd_bwd + opt) * 1e3)
        opt_ms.append(opt * 1e3)
        log(f"[train] step {step + 1}: loss {losses[-1]:.4f}, fused_adamw launches "
            f"{launched}, step {step_ms[-1]:.1f} ms (forward+backward "
            f"{fwd_bwd * 1e3:.1f} ms, optimizer {opt_ms[-1]:.2f} ms), "
            f"lr {float(metrics['lr']):.3e}, grad_norm {float(metrics['grad_norm']):.4f}")
        if launched != n_leaves:
            raise AssertionError(f"step {step + 1}: {launched} launches for {n_leaves} leaves")
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"step {step + 1}: loss {losses[-1]}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] launches over {TRAIN_STEPS} steps: fused_adamw "
        f"{fa.fused_adamw.launches}, split_pipeline {sp.split_pipeline.launches} "
        f"(the Mozart AdamW stages); peak device memory {peak / 1e9:.2f} GB")
    if losses[-1] >= losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if peak >= 80e9:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB")
    out = {"launches": fa.fused_adamw.launches, "losses": losses,
           "step_ms": step_ms, "opt_ms": opt_ms, "peak_bytes": peak,
           "split_pipeline_launches": sp.split_pipeline.launches, "mozart_groups": groups}
    del model, state, batch
    torch.cuda.empty_cache()
    return out


def adamw_row(kern: dict, train: dict) -> dict:
    leaves = kern["leaves"].values()
    total_bytes = sum(r["bytes"] for r in leaves)
    n_total = sum(r["n"] for r in leaves)
    bytes_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ADAMW_OPS * n_total / F32_OPS_PER_S * 1e3
    lib = [r for r in leaves if r["library_ms"] is not None]
    return {
        "name": "fused_adamw", "route": "cuda", "source": ADAMW_SOURCE,
        "replaces": ADAMW_REPLACES, "launches": train["launches"],
        "launches_per_step": train["launches"] // TRAIN_STEPS,
        "max_abs_err": kern["max_abs_err"],
        "ms": sum(r["ms"] for r in leaves),
        "plain_ms": sum(r["plain_ms"] for r in leaves),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": sum(r["library_ms"] for r in lib) if lib else None,
        "library_leaves": [n for n, r in kern["leaves"].items() if r["library_ms"] is not None],
        "ms_on_library_leaves": sum(r["ms"] for r in lib),
        "per_step": f"{len(kern['leaves'])} leaves of gemma-7b at {TRAIN_LAYERS} layers",
        "bytes_per_step": total_bytes, "elements_per_step": n_total,
        "train_step_ms": train["step_ms"], "train_opt_ms": train["opt_ms"],
        "train_losses": train["losses"], "train_peak_bytes": train["peak_bytes"],
        "mozart_adamw_groups": train["mozart_groups"],
    }


# ---------------------------------------------------------------------------
# flash attention and RMSNorm
# ---------------------------------------------------------------------------

ATTN_CASES = (  # (B, Hq, Hkv, Sq, Sk, D, causal, window)
    (1, 2, 2, 128, 128, 64, True, None),        # MHA
    (2, 4, 2, 256, 256, 64, True, None),        # GQA group 2
    (1, 8, 1, 128, 128, 128, True, None),       # MQA
    (1, 2, 2, 256, 256, 256, True, None),       # gemma's head dim
    (1, 2, 2, 128, 128, 64, False, None),       # non-causal
    (1, 2, 2, 256, 256, 64, True, 32),          # sliding windows
    (1, 2, 2, 256, 256, 64, True, 128),
    (1, 2, 2, 64, 256, 64, False, None),        # Sk > Sq
    (2, 4, 2, 100, 77, 64, True, None),         # ragged Sq and Sk
    (1, 2, 2, 77, 200, 128, False, 50),
    (1, 2, 2, 128, 128, 64, True, 1 << 30),     # the transformer's global window
)


def attn_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen):
    q = torch.randn(B, Hq, Sq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda").to(dtype)
    return q, k, v


def attn_bound(B, Hq, Hkv, Sq, Sk, D, causal, elem, window=None) -> dict:
    """Bytes: q, k, v read once and the output written once.  Operations:
    2 * D for q.k and 2 * D for p.v per (query, visible key) pair (causal
    and window: the pairs this run's mask leaves), over the dense bfloat16
    rate."""
    span = Sk if window is None else min(window, Sk)
    pairs = sum(min(i + 1, span) for i in range(Sq)) if causal else Sq * Sk
    flops = 4 * B * Hq * pairs * D
    nbytes = elem * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "flops": flops, "bytes": nbytes}


#: the greedy prefills of the archs phase, bfloat16 on the model's
#: head-split views: (name, B, Hq, Hkv, S, D, window[, causal]), causal but
#: for seamless's encoder
ARCH_ATTN = (
    ("internlm2-20b", 4, 48, 8, 2048, 128, None),      # GQA group 6
    ("granite-34b", 4, 48, 1, 2048, 128, None),        # MQA, group 48
    ("gemma3-4b local", 4, 8, 4, 2048, 256, 1024),     # the 1024-key window
    ("gemma3-4b global", 4, 8, 4, 2048, 256, None),
    ("olmoe-1b-7b / deepseek-moe-16b", 4, 16, 16, 2048, 128, None),   # MHA
    ("hymba-1.5b local", 4, 25, 5, 2048, 64, 1024),   # GQA group 5, head dim 64
    ("hymba-1.5b global", 4, 25, 5, 2048, 64, None),
    ("qwen2-vl-2b", 4, 12, 2, 2048, 128, None),        # GQA group 6, M-RoPE'd q/k
    ("seamless-m4t-large-v2 decoder", 4, 16, 16, 2048, 64, None),
    ("seamless-m4t-large-v2 encoder", 4, 16, 16, 2048, 64, None, False),   # non-causal
)

ATTN_EDGES = (  # bfloat16: (B, Hq, Hkv, Sq, Sk, D, causal, window, head-split views)
    (2, 4, 4, 300, 300, 256, True, None, True),     # the model's head-split views, ragged
    (1, 4, 2, 190, 190, 128, True, None, True),     # GQA head-split views
    (2, 4, 2, 100, 77, 64, True, None, False),      # D 64, ragged Sq and Sk
    (1, 2, 2, 200, 333, 128, False, None, False),   # D 128, ragged, Sk > Sq
    (1, 2, 2, 333, 333, 256, True, None, False),    # D 256, ragged
    (1, 2, 2, 333, 333, 256, True, 40, False),      # a window shorter than one tile
    (1, 2, 2, 70, 70, 64, True, 5, True),
    (1, 2, 2, 100, 100, 40, True, None, False),     # D 40: the rule sends it to simt
)


def _profile_window(fn, reps: int, match: str = ""):
    """(kernel launches recorded, their device microseconds, the last
    result) of ``reps`` calls of ``fn`` under ``torch.profiler``, counting
    kernels whose name contains ``match``.  After many launches in the
    process the profiler on the card drops the first kernel records of a
    window (seen on H100s: one to two after the ``fused`` executor's
    ~50,000 launches, and enough to exhaust 8 sentinels once after the
    rewrite and chaos phases were added); ``PROFILE_SENTINELS`` short spin
    kernels open the window and are left out of the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_SENTINELS):
            torch.cuda._sleep(1)
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and match in e.key
              and "spin_kernel" not in e.key]
    return (sum(e.count for e in events),
            sum(getattr(e, "self_device_time_total", 0.0) for e in events), out)


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: the ``torch.profiler`` kernel
    time of ``reps`` calls (after one warm-up) over ``reps``.  Unlike
    ``cuda_ms`` it leaves out the host's launch time, which is longer than a
    short kernel.  The profiler on the card sometimes drops kernel records,
    which only lowers a window's count, so windows are measured until two
    record the most launches seen."""
    fn()
    seen = []
    for _attempt in range(6):
        launches, us, _out = _profile_window(fn, reps)
        if launches and seen and launches == max(seen):
            return us / 1e3 / reps
        seen.append(launches)
        if len(seen) > 1:
            log(f"[profile] windows recorded {seen} kernel launches; again")
    raise AssertionError(f"torch.profiler kept dropping kernel records: {seen}")


class ProfilerDropped(AssertionError):
    """``torch.profiler`` kept dropping a window's kernel records."""


def kernel_device_ms(fn, reps: int, match: str = "split_pipeline") -> float:
    """Device milliseconds of one launch of the kernel named ``*match*``
    that ``fn`` makes once per call, and nothing else (``torch.profiler``,
    after one warm-up call).  Where the profiler keeps dropping the
    window's records (seen on an H100 after the earlier phases' launches:
    0 of 10 recorded in four windows running), CUDA events around ``reps``
    back-to-back calls time it instead: the host enqueues the launches
    faster than they run, so they queue behind each other and the events
    hold the device's time (and the first enqueue)."""
    try:
        ms, _launches, _out = profiled_kernels(fn, match, expect=1, reps=reps, warm=True)
        return ms
    except ProfilerDropped:
        pass
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    log(f"[profile] {match!r}: timed with CUDA events over {reps} back-to-back calls "
        f"instead: {ms:.4f} ms")
    return ms


def profiled_kernels(fn, match: str, expect: int, reps: int = 1, warm: bool = False):
    """(device ms per call in kernels named ``*match*``, their launches per
    call, the last call's result) of ``reps`` calls of ``fn`` under
    ``torch.profiler``, each call making ``expect`` such launches; a window
    that recorded fewer (the profiler dropped records) is measured again."""
    if warm:
        fn()
    for _attempt in range(4):
        launches, us, out = _profile_window(fn, reps, match)
        if launches == expect * reps:
            return us / 1e3 / reps, expect, out
        log(f"[profile] {match!r}: recorded {launches} of {expect * reps} launches; again")
    raise ProfilerDropped(f"torch.profiler kept dropping {match!r} kernel records")


def attn_case(fl, ref, what, q, k, v, causal, window, variant) -> float:
    """One kernel launch against the plain version; it must take ``variant``."""
    before = dict(fl.flash_attention.variant_launches)
    got = fl.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    counts = fl.flash_attention.variant_launches
    ran = [name for name in counts if counts[name] != before[name]]
    if ran != [variant]:
        raise AssertionError(f"flash_attention {what}: ran {ran}, expected [{variant!r}]")
    err = compare(f"flash_attention {what}", got, want, TOL[q.dtype], atol_scale=0.0,
                  atol=TOL[q.dtype])
    # The elementwise bound is about half a typical |out| at long Sk; a lost
    # key tile or a mis-scaled p moves the whole output by more than this.
    rel = float((got.double() - want.double()).norm() / want.double().norm())
    if q.dtype == torch.bfloat16 and not rel <= ATTN_REL_TOL:
        raise AssertionError(f"flash_attention {what}: ||kernel - plain|| / ||plain|| = "
                             f"{rel:.3e} > {ATTN_REL_TOL}")
    log(f"[attn] {what}: variant {variant}, max |kernel - plain| {err:.3e}, "
        f"||kernel - plain|| / ||plain|| {rel:.3e}; launches {counts}")
    return err


def rms_raw(lib, xs, w, ys, nxt):
    """A launch of ``lib``'s RMSNorm kernel (any build of ``rmsnorm.cu``'s C
    interface) on the next of ``xs`` into the same of ``ys``: no wrapper,
    no launch count."""
    n, d = xs[0].shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        i = nxt()
        rc = lib.rmsnorm_launch(1, 0, xs[i].data_ptr(), w.data_ptr(), ys[i].data_ptr(), n, d,
                                1e-6, 0, stream)
        if rc:
            raise RuntimeError(f"rmsnorm launch failed ({rc})")
    return run


def rms_times(fns: dict) -> dict:
    """name -> (device ms per call, CUDA-event ms per call around
    ``RMS_BURST`` back-to-back calls, (least, most) device ms of a round) of
    each of ``fns``: medians of ``RMS_ROUNDS`` rounds, each round timing
    every function in turn, so that a drift of the card's clock falls on all
    alike."""
    rounds = {name: ([], []) for name in fns}
    for _ in range(RMS_ROUNDS):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(RMS_BURST):
                fn()
            end.record()
            end.synchronize()
            rounds[name][0].append(device_ms(fn, RMS_BURST))
            rounds[name][1].append(start.elapsed_time(end) / RMS_BURST)
    return {name: (statistics.median(dev), statistics.median(burst), (min(dev), max(dev)))
            for name, (dev, burst) in rounds.items()}


def phase_attn_kernels(fl, rn, ref, rms_compare=()) -> dict:
    """Both kernels against their plain versions, then timed at gemma's
    shapes beside the library calls (and the RMSNorm kernel beside the
    builds of ``rms_compare``, other versions of its source)."""
    import torch.nn.functional as F
    from repro_torch.kernels import build as kernel_build
    gen = torch.Generator(device="cuda").manual_seed(2)
    fl.reset_counts()
    worst = 0.0
    for case in ATTN_CASES:
        B, Hq, Hkv, Sq, Sk, D, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen)
            worst = max(worst, attn_case(fl, ref, f"{case} {dtype}", q, k, v, causal, window,
                                         "tc" if dtype == torch.bfloat16 else "simt"))
    for case in ATTN_EDGES:
        B, Hq, Hkv, Sq, Sk, D, causal, window, split = case
        if split:   # (B, S, H, D) storage seen as (B, H, S, D), as attention.py splits heads
            q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                       .to(torch.bfloat16).transpose(1, 2)
                       for H, S in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
        else:
            q, k, v = attn_inputs(B, Hq, Hkv, Sq, Sk, D, torch.bfloat16, gen)
        worst = max(worst, attn_case(fl, ref, f"{case} torch.bfloat16", q, k, v, causal,
                                     window, "tc" if D % 16 == 0 else "simt"))
    log(f"[attn] flash_attention: {len(ATTN_CASES)} cases (MHA, GQA, MQA, D 64/128/256, "
        f"non-causal, windows, Sk > Sq, ragged) in float32 (simt) and bfloat16 (tc), "
        f"{len(ATTN_EDGES)} bfloat16 edges (head-split views, ragged D 64/128/256, a "
        f"5- and a 40-key window, D 40 on simt): max |kernel - plain| = {worst:.3e} "
        f"(rtol/atol 2e-5 float32, 2e-2 bfloat16); launches {fl.flash_attention.variant_launches}")
    B, H, S, D = GEMMA_ATTN
    q, k, v = attn_inputs(B, H, H, S, S, D, torch.bfloat16, gen)
    gemma_err = attn_case(fl, ref, f"gemma prefill {GEMMA_ATTN} causal", q, k, v, True, None,
                          "tc")
    kernel = lambda: fl.flash_attention(q, k, v, causal=True)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    attn = {"max_abs_err": max(worst, gemma_err), "shape": list(GEMMA_ATTN),
            "ms": device_ms(kernel, 20), "event_ms": cuda_ms(kernel, 10),
            "simt_ms": device_ms(lambda: fl._attention(q, k, v, causal=True, variant="simt"),
                                 3),
            "plain_ms": cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), 3),
            "library_ms": device_ms(sdpa, 20), "library_event_ms": cuda_ms(sdpa, 20),
            **attn_bound(B, H, H, S, S, D, True, 2)}
    log(f"[attn] flash_attention {GEMMA_ATTN} causal bfloat16, device times: tc kernel "
        f"{attn['ms']:.4f} ms (bound {attn['bound_ms']:.4f} ms by {attn['bound_by']}, "
        f"{attn['bound_ms'] / attn['ms']:.1%} of it), simt variant on the same inputs "
        f"{attn['simt_ms']:.3f} ms, F.scaled_dot_product_attention {attn['library_ms']:.4f} "
        f"ms; CUDA-event times of one call: kernel {attn['event_ms']:.4f} ms, SDPA "
        f"{attn['library_event_ms']:.4f} ms, plain {attn['plain_ms']:.3f} ms; max |kernel - "
        f"plain| {gemma_err:.3e}")
    del q, k, v
    shapes = [attn_shape_times(fl, ref, F, gen, *case) for case in ARCH_ATTN]

    worst = 0.0
    for shape in RMS_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
            worst = max(worst, compare(f"rmsnorm {shape} {dtype}", rn.rmsnorm(x, w),
                                       ref.rmsnorm_ref(x, w), TOL[dtype], atol_scale=0.0,
                                       atol=TOL[dtype]))
    # one element into its storage: no row is 16-byte aligned (the scalar loop)
    x = torch.randn(8192 * 3072 + 1, generator=gen, device="cuda").to(torch.bfloat16)
    x = x[1:].view(8192, 3072)
    w = torch.rand(3072, generator=gen, device="cuda") + 0.5
    worst = max(worst, compare("rmsnorm offset view (8192, 3072)", rn.rmsnorm(x, w),
                               ref.rmsnorm_ref(x, w), 2e-2, atol_scale=0.0, atol=2e-2))
    log(f"[attn] rmsnorm at {RMS_SHAPES}, float32 and bfloat16, and an offset (8192, 3072) "
        f"bfloat16 view: max |kernel - plain| = {worst:.3e}")
    n, d = 8192, 3072
    xs = [torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(RMS_ROTATE)]
    ys = [torch.empty_like(x) for x in xs]
    w = torch.rand(d, generator=gen, device="cuda") + 0.5
    wl = w.to(torch.bfloat16)
    nbytes = 2 * xs[0].numel() * xs[0].element_size() + w.numel() * w.element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * xs[0].numel() / F32_OPS_PER_S * 1e3     # square-add, scale, weight
    nxt = itertools.cycle(range(RMS_ROTATE)).__next__
    library = lambda: F.rms_norm(xs[nxt()], (d,), wl, 1e-6)
    fns = {"F.rms_norm": library}   # each call on the next x (and y)
    for source in (rn.SOURCE, *rms_compare):
        if source != rn.SOURCE:
            _path, _secs, compiler_log = kernel_build.build(Path(source).resolve())
            for line in compiler_log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[attn] {source} ptxas: {line.strip()}")
        lib = kernel_build.load(Path(source).resolve(), rn._configure)
        fns[str(source)] = rms_raw(lib, xs, w, ys, nxt)
    times = rms_times(fns)
    lib_ms, lib_burst, lib_span = times["F.rms_norm"]
    ms, burst, span = times[str(rn.SOURCE)]
    rms = {"max_abs_err": worst, "shape": [n, d], "ms": ms, "burst_ms": burst,
           "event_ms": cuda_ms(lambda: rn.rmsnorm(xs[0], w), 20),
           "plain_ms": cuda_ms(lambda: ref.rmsnorm_ref(xs[0], w), 10),
           "library_ms": lib_ms, "library_burst_ms": lib_burst,
           "library_event_ms": cuda_ms(lambda: F.rms_norm(xs[0], (d,), wl, 1e-6), 20),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes}
    log(f"[attn] rmsnorm ({n}, {d}) bfloat16, each timed call on the next of {RMS_ROTATE} "
        f"x and y buffers (cold L2), medians of {RMS_ROUNDS} interleaved rounds: device time "
        f"kernel {ms:.5f} ms (rounds {span[0]:.5f}-{span[1]:.5f}; bound "
        f"{rms['bound_ms']:.5f} ms by {rms['bound_by']}, {rms['bound_ms'] / ms:.1%} of it), "
        f"F.rms_norm {lib_ms:.5f} ms ({lib_span[0]:.5f}-{lib_span[1]:.5f}); CUDA events around {RMS_BURST} back-to-back calls, "
        f"per call: kernel {burst:.5f} ms, F.rms_norm {lib_burst:.5f} ms; CUDA-event time of "
        f"one call (host launch included): kernel {rms['event_ms']:.4f} ms, F.rms_norm "
        f"{rms['library_event_ms']:.4f} ms, plain {rms['plain_ms']:.4f} ms")
    for source in rms_compare:
        c_ms, c_burst, c_span = times[str(source)]
        log(f"[attn] rmsnorm ({n}, {d}) bfloat16, {source} timed the same way: device time "
            f"{c_ms:.5f} ms ({c_span[0]:.5f}-{c_span[1]:.5f}; {rms['bound_ms'] / c_ms:.1%} "
            f"of the bound), {RMS_BURST} "
            f"back-to-back calls {c_burst:.5f} ms per call")
    del xs, ys, w, wl
    torch.cuda.empty_cache()
    return {"attn": attn, "rms": rms, "attn_shapes": shapes}


def attn_shape_times(fl, ref, F, gen, name, B, Hq, Hkv, S, D, window,
                     causal: bool = True) -> dict:
    """The tc kernel at one model's prefill shape (head-split views, as
    ``attention.py`` makes them) against the plain version, with device
    times of the kernel and of ``F.scaled_dot_product_attention`` on the
    same inputs (``enable_gqa``; with a window, SDPA takes k and v expanded
    to every query head beforehand and a boolean mask) beside the bound.
    ``causal=False`` (an encoder) goes to the kernel, the plain version and
    SDPA alike."""
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for H in (Hq, Hkv, Hkv))
    err = attn_case(fl, ref, f"{name} prefill {(B, Hq, Hkv, S, D)} window {window} causal "
                    f"{causal}", q, k, v, causal, window, "tc")
    kernel = lambda: fl.flash_attention(q, k, v, causal=causal, window=window)
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=Hq != Hkv)
    else:
        group = Hq // Hkv
        ke, ve = (t.repeat_interleave(group, dim=1) for t in (k, v))
        i = torch.arange(S, device="cuda")
        mask = (i[:, None] >= i[None, :]) & (i[None, :] > i[:, None] - window)
        sdpa = lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
    lib = sdpa()
    compare(f"{name} SDPA vs plain", lib, ref.attention_ref(q, k, v, causal=causal,
                                                           window=window), 2e-2,
            atol_scale=0.0, atol=2e-2)
    plain = lambda: ref.attention_ref(q, k, v, causal=causal, window=window)
    row = {"name": name, "shape": [B, Hq, Hkv, S, D], "window": window, "causal": causal,
           "max_abs_err": err, "ms": device_ms(kernel, 10), "library_ms": device_ms(sdpa, 10),
           "plain_ms": cuda_ms(plain, 3), **attn_bound(B, Hq, Hkv, S, S, D, causal, 2, window)}
    log(f"[attn] flash_attention at {name}'s prefill {(B, Hq, Hkv, S, D)} "
        f"{'causal' if causal else 'non-causal'} bfloat16 "
        f"window {window}, device times: tc kernel {row['ms']:.4f} ms (bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of "
        f"it), F.scaled_dot_product_attention {row['library_ms']:.4f} ms; the plain version "
        f"{row['plain_ms']:.3f} ms (CUDA events); max |kernel - plain| {err:.3e}")
    del q, k, v, lib
    torch.cuda.empty_cache()
    return row


def phase_ops(rn, ref) -> int:
    """The RMSNorm kernel's path: ``kernels.ops.rmsnorm`` at gemma's
    hidden-state shapes (prefill: 4 x 2048 rows; 32 x 2048 rows)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = [(torch.randn(n, 3072, generator=gen, device="cuda").to(torch.bfloat16),
               torch.rand(3072, generator=gen, device="cuda") + 0.5) for n in (8192, 65536)]
    rn.rmsnorm.launches = 0
    outs = [ops.rmsnorm(x, w, row_block=256) for x, w in inputs]
    torch.cuda.synchronize()
    launched = rn.rmsnorm.launches
    if launched != len(inputs):
        raise AssertionError(f"ops.rmsnorm: {launched} kernel launches for {len(inputs)} calls")
    for (x, w), out in zip(inputs, outs):
        if out.shape != x.shape or out.dtype != x.dtype or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"ops.rmsnorm {tuple(x.shape)}: bad output")
        compare(f"ops.rmsnorm {tuple(x.shape)}", out, ref.rmsnorm_ref(x, w), 2e-2,
                atol_scale=0.0, atol=2e-2)
    log(f"[ops] kernels.ops.rmsnorm at (8192, 3072) and (65536, 3072) bfloat16: "
        f"{launched} rmsnorm launches; agrees with the plain version")
    return launched


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def serve_config():
    from repro_torch.configs.registry import get_config
    return get_config("gemma-7b")


def serve_requests(vocab: int):
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(0)
    plens = rng.integers(256, SERVE_PROMPT + 1, SERVE_REQUESTS)
    news = rng.integers(8, 49, SERVE_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new=int(m)) for i, (n, m) in enumerate(zip(plens, news))]


def parity(model, cfg, req) -> str:
    """``req``'s served tokens against sequential batch-1 ``prefill`` and
    ``decode_step``.  Where they differ, the top-2 logit margin of the
    sequential run at the first differing step decides: above 0.5 fails,
    below is a bfloat16 near-tie."""
    from repro_torch.models import transformer as tfm
    caches = tfm.init_caches(cfg, 1, SERVE_MAX_LEN, device=DEVICE)
    logits, caches = tfm.prefill(model, cfg, torch.as_tensor(req.prompt[None], device=DEVICE),
                                 caches=caches)
    seq, margins = [], []
    for step in range(req.max_new):
        if step:
            tok = torch.tensor([[seq[-1]]], dtype=torch.int32, device=DEVICE)
            logits, caches = tfm.decode_step(model, cfg, tok, caches)
        top = torch.topk(logits[0, -1].float(), 2)
        seq.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1]))
    if seq == req.out:
        return "equal"
    i = next(j for j, (a, b) in enumerate(zip(seq, req.out)) if a != b)
    if margins[i] > 0.5:
        raise AssertionError(f"request {req.rid}: served token {req.out[i]} != sequential "
                             f"{seq[i]} at step {i}, top-2 margin {margins[i]:.3f} > 0.5")
    return f"bfloat16 near-tie at step {i} (top-2 margin {margins[i]:.4f})"


def profiled(fn, top: int = 6) -> dict:
    """``fn`` under ``torch.profiler``: device time summed over kernels,
    the host-clock window, the device's busy share of it and the kernels
    with the most device time.  The profiler's own overhead lengthens the
    window, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = lambda e: getattr(e, "self_device_time_total", 0.0)
    # kernels only: the CPU ops that launched them carry the same device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy_us = sum(dev(e) for e in events)
    return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us if busy_us else None,
            "launches": sum(e.count for e in events),
            "top": [(e.key[:60], round(dev(e) / 1e3, 3), e.count)
                    for e in sorted(events, key=dev, reverse=True)[:top]]}


def log_profile(what: str, prof: dict, phase: str = "serve") -> None:
    if prof["busy_share"] is None:
        log(f"[{phase}] profile {what}: device time not measured (no device events)")
        return
    log(f"[{phase}] profile {what}: window {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_ms']:.1f} ms ({prof['busy_share']:.1%}), {prof['launches']} kernels; "
        f"top (kernel, ms, count): {prof['top']}")


@torch.inference_mode(False)
def serve_chaos_wave(cfg, model, driver: str) -> dict:
    """The reference's ``smoke/chaos`` serving scenario in the continuous
    batcher: under ``serve_step:fail:1`` the first wave's requests end with
    the ``InjectedFault``, the step failure is counted and recorded (MZ405)
    and the driver thread survives to serve the next wave, whose tokens equal
    the same requests served fault-free.  Outside ``inference_mode``: the
    driver thread updates the KV caches in place, which an inference tensor
    allows only inside it."""
    from repro_torch.core import mozart, resilience
    from repro_torch.core.serving import AsyncServer, ContinuousBatcher
    model.requires_grad_(False)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in CHAOS_PROMPTS]

    def batcher():
        return ContinuousBatcher(cfg, model, batch=2, max_len=CHAOS_MAX_LEN, driver=driver,
                                 device=DEVICE)

    b = batcher()
    wave1 = [b.submit(b.make_request(p, CHAOS_NEW)) for p in prompts[:2]]
    srv = AsyncServer(b, idle_poll_s=1e-4)
    t0 = time.perf_counter()
    try:
        with mozart.inject_faults("serve_step:fail:1") as plan:
            srv.start()
            for r in wave1:
                r.done.wait(300)
            wave2 = [b.submit(b.make_request(p, CHAOS_NEW)) for p in prompts[2:]]
            for r in wave2:
                r.done.wait(300)
        alive = srv._thread.is_alive()
    finally:
        srv.close()
    wall_s = time.perf_counter() - t0
    fresh = batcher()
    want = [fresh.make_request(p, CHAOS_NEW) for p in prompts[2:]]
    fresh.run(want)
    counts = {k: int(resilience.stats.get(k, 0)) for k in RESILIENCE_KEYS}
    ok = (plan.fired == [("serve_step", "")] and alive
          and all(r.finished and isinstance(r.error, resilience.InjectedFault) for r in wave1)
          and all(r.finished and r.error is None and len(r.out) == CHAOS_NEW for r in wave2)
          and [r.out for r in wave2] == [r.out for r in want]
          and b.stats["step_failures"] == 1 and b.stats["failed_requests"] == 2
          and counts["MZ405"] == 1)
    log(f"[chaos] serve_step:fail:1 in the continuous batcher (driver {driver}, {cfg.name}, "
        f"{cfg.n_layers} layers, 2 slots, prompts {list(CHAOS_PROMPTS)}, {CHAOS_NEW} new "
        f"tokens): wave 1 "
        f"errors {[type(r.error).__name__ for r in wave1]}, step_failures "
        f"{b.stats['step_failures']}, failed_requests {b.stats['failed_requests']}, driver "
        f"thread alive {alive}; wave 2 tokens equal to the fault-free run: "
        f"{[r.out for r in wave2] == [r.out for r in want]}; {wall_s:.2f} s; MZ4xx {counts}")
    if not ok:
        raise AssertionError(f"chaos/serve ({driver}): fired {plan.fired}, wave 1 "
                             f"{[(r.finished, r.error) for r in wave1]}, wave 2 "
                             f"{[(r.error, r.out) for r in wave2]} vs {[r.out for r in want]}, "
                             f"{dict(b.stats)}, {counts}")
    resilience.clear_events()
    return {"driver": driver, "step_failures": int(b.stats["step_failures"]),
            "failed_requests": int(b.stats["failed_requests"]), "mz": counts,
            "wall_s": wall_s}


def decode_step_turns(cfg, model, batcher) -> dict:
    """One decode step (batch ``SERVE_BATCH`` on a cache filled to 1024
    positions, through the host read) by each driver in turns, jit, mozart,
    mozart, jit, ``STEP_ROUNDS`` times: medians and quartiles of each, and
    of the difference within a round, the mozart driver's per-step host
    cost (capture, fingerprint, plan-cache hit, rewrite replay)."""
    from repro_torch.models import transformer as tfm
    caches = batcher._init_caches(SERVE_BATCH)
    caches.length.fill_(1024)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device=DEVICE)
    steps = {"jit": lambda: tfm.decode_step(model, cfg, tok, caches),
             "mozart": lambda: batcher._decode(model, tok, caches)}

    def one(name):
        t0 = time.perf_counter()
        logits, _c = steps[name]()
        torch.argmax(logits[:, -1], -1).cpu()
        return (time.perf_counter() - t0) * 1e3

    for name in steps:
        one(name)
    got = {"jit": [], "mozart": []}
    for r in range(STEP_ROUNDS):
        for name in (("jit", "mozart") if r % 2 == 0 else ("mozart", "jit")):
            got[name].append(one(name))
    delta = [m - j for m, j in zip(got["mozart"], got["jit"])]
    out = {name: {"median": statistics.median(v), "quartiles": quartiles(v)[1:]}
           for name, v in got.items()}
    out["mozart_minus_jit"] = {"median": statistics.median(delta),
                               "quartiles": quartiles(delta)[1:]}
    q = lambda k: "[{:.2f}-{:.2f}]".format(*out[k]["quartiles"])
    log(f"[serve] one decode step through the host read, {STEP_ROUNDS} rounds in turns: jit "
        f"{out['jit']['median']:.2f} ms {q('jit')}, mozart {out['mozart']['median']:.2f} ms "
        f"{q('mozart')}; mozart - jit per round {out['mozart_minus_jit']['median']:.3f} ms "
        f"{q('mozart_minus_jit')}")
    if not batcher._decode.warm():
        raise AssertionError(f"serve/mozart decode turns: {batcher._decode.last_call_stats}")
    return out


class StepCalls:
    """Real (non-``meta``) calls of the model's prefill and decode steps while
    installed: a warm ``mozart`` step must call its function exactly once
    (the K/V writes are in place).  Abstract evaluation runs the steps on
    ``meta`` tensors and is not counted."""

    def __init__(self):
        from repro_torch.models import transformer as tfm
        self.tfm, self.calls = tfm, {"prefill": 0, "decode_step": 0}
        self.real = {name: getattr(tfm, name) for name in self.calls}

    def __enter__(self):
        for name, real in self.real.items():
            def counted(params, cfg, tokens, *a, _name=name, _real=real, **kw):
                if tokens.device.type != "meta":
                    self.calls[_name] += 1
                return _real(params, cfg, tokens, *a, **kw)
            setattr(self.tfm, name, counted)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.tfm, name, real)


def serve_mozart_leg(cfg, model, jit_reqs, jit_stats, prompt_buckets) -> dict:
    """``Server(driver="mozart")`` on the continuous run the ``jit`` leg just
    served: the same requests must give the same tokens; after ``warmup``
    every step is warm (0 planner calls, 0 traces), calls its step function
    exactly once, and each bucket is labelled; then a second batcher started
    from the saved plan file serves 4 requests with 0 planner calls and no
    warmup.  Decode p50/p99 and tokens/s print beside the ``jit`` leg's."""
    from repro_torch.core import plan_cache
    from repro_torch.core.serving import ContinuousBatcher
    from repro_torch.launch.serve import Server
    path = ROOT / "build" / "serve_plans.json"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    plan_cache.clear()
    srv = Server(cfg, model, SERVE_BATCH, SERVE_MAX_LEN, driver="mozart",
                 plan_cache_path=str(path), mode="continuous", device=DEVICE)
    t0 = time.perf_counter()
    srv.warmup(SERVE_PROMPT)
    warm_s = time.perf_counter() - t0
    reqs = serve_requests(cfg.vocab_size)
    with StepCalls() as steps:
        stats = srv.run(reqs)
    same = [r.out for r in reqs] == [r.out for r in jit_reqs]
    buckets = stats["buckets"]
    log(f"[serve] Server(continuous, driver mozart) on the same {len(reqs)} requests, "
        f"warmup {warm_s:.1f} s (buckets {buckets}): {stats['tokens']} tokens in "
        f"{stats['wall_s']:.2f} s ({stats['tokens_per_s']:.1f} tokens/s; jit "
        f"{jit_stats['tokens_per_s']:.1f}), decode p50 {stats['decode_p50_us'] / 1e3:.2f} ms "
        f"p99 {stats['decode_p99_us'] / 1e3:.2f} ms (jit {jit_stats['decode_p50_us'] / 1e3:.2f}"
        f" / {jit_stats['decode_p99_us'] / 1e3:.2f}), request p50 "
        f"{stats['request_p50_ms']:.0f} ms p99 {stats['request_p99_ms']:.0f} ms (jit "
        f"{jit_stats['request_p50_ms']:.0f} / {jit_stats['request_p99_ms']:.0f}); planner "
        f"calls {stats['planner_calls']}, traces {stats['jit_traces']}, warm {stats['warm']}, "
        f"decode_warm {stats['decode_warm']}; step-function calls {steps.calls} for "
        f"{stats['prefill_calls']} prefills and {stats['decode_steps']} decode steps; tokens "
        f"equal to the jit leg's: {same}")
    if not (same and stats["warm"] and stats["planner_calls"] == 0
            and stats["jit_traces"] == 0 and stats["decode_warm"]
            and ("decode", SERVE_BATCH) in buckets
            and len(buckets) == 1 + len(srv._batcher.batch_buckets) * len(
                srv._batcher.prompt_buckets)
            and steps.calls == {"prefill": stats["prefill_calls"],
                                "decode_step": stats["decode_steps"]}):
        raise AssertionError(f"serve/mozart: tokens equal {same}, {stats}, steps {steps.calls}")
    steps_ms = decode_step_turns(cfg, model, srv._batcher)
    saved = json.load(open(path))
    plan_cache.clear()                          # a restarted replica
    again = ContinuousBatcher(cfg, model, SERVE_BATCH, SERVE_MAX_LEN, driver="mozart",
                              plan_cache_path=str(path), prompt_buckets=prompt_buckets,
                              device=DEVICE)
    loaded = plan_cache.cache_info().get("persist_loaded", 0)
    restart = [again.make_request(r.prompt, r.max_new) for r in reqs[:4]]
    rstats = again.run(restart)
    log(f"[serve] warm start from the plan file ({len(saved['entries'])} entries saved, "
        f"{loaded} loaded): 4 requests, {rstats['tokens']} tokens, planner calls "
        f"{rstats['planner_calls']}, traces {rstats['jit_traces']}, warm {rstats['warm']}")
    if (rstats["planner_calls"] or not rstats["warm"] or rstats["completed"] != 4
            or loaded != len(buckets)):
        raise AssertionError(f"serve/mozart warm start: loaded {loaded}, {rstats}")
    del srv, again
    path.unlink(missing_ok=True)
    plan_cache.clear()
    return {**{k: v for k, v in stats.items() if k != "decode_last_call"},
            "buckets": [list(b) for b in buckets], "warmup_s": warm_s,
            "tokens_equal_jit": same, "step_calls": steps.calls, "decode_turns_ms": steps_ms,
            "warm_start": {"entries_loaded": loaded, "planner_calls": rstats["planner_calls"],
                           "tokens": rstats["tokens"], "warm": rstats["warm"]}}


@torch.inference_mode()
def phase_serve(counters, flash) -> dict:
    from repro_torch.launch.serve import Server
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import param_count

    cfg = serve_config()
    a = cfg.attn
    log(f"[serve] {cfg.name} at its published widths and full depth: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, {a.n_heads}x{a.head_dim} heads (kv "
        f"{a.n_kv_heads}), vocab {cfg.vocab_size}, {cfg.dtype}; "
        f"{param_count(cfg) / 1e9:.3f} B parameters, random weights (seed 0)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = tfm.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    rng = np.random.default_rng(0)
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32,
                             device=DEVICE)
    lm.greedy_generate(model, cfg, prompt, 2)            # library and allocator warm-up

    # the main path: counts set to 0 just before, read just after
    for c in counters:
        c.launches = 0
    flash.variant_launches = {name: 0 for name in flash.variant_launches}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = lm.greedy_generate(model, cfg, prompt, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    variants = dict(flash.variant_launches)
    log(f"[serve] lm.greedy_generate batch {B}, prompt {S}, {new} new tokens: "
        f"{gen_s * 1e3:.1f} ms, {B * new / gen_s:.1f} tokens/s; launches {launches}, "
        f"flash_attention by variant {variants}")
    if launches["flash_attention"] != cfg.n_layers or variants["tc"] != cfg.n_layers:
        raise AssertionError(f"{launches['flash_attention']} flash_attention launches "
                             f"({variants}) for one prefill of {cfg.n_layers} layers; "
                             f"expected {cfg.n_layers} of the tc variant")
    if tuple(tokens.shape) != (B, new) or not bool(((tokens >= 0) &
                                                   (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"greedy tokens: shape {tuple(tokens.shape)} or out of range")

    def prefill(use_kernel):
        caches = tfm.init_caches(cfg, B, S + new, device=DEVICE)
        return tfm.prefill(model, cfg, prompt, caches=caches, use_kernel=use_kernel)

    prefill_ms = host_ms(lambda: prefill(None), 3)
    plain_prefill_ms = host_ms(lambda: prefill(False), 3)
    lk, caches = prefill(None)
    lp, _ = prefill(False)
    diff = float((lk.float() - lp.float()).abs().max())
    scale = float(lp.float().abs().max())
    first_k, first_p = torch.argmax(lk[:, -1], -1), torch.argmax(lp[:, -1], -1)
    log(f"[serve] prefill: kernel path {prefill_ms:.1f} ms, plain attention path "
        f"{plain_prefill_ms:.1f} ms; last-position logits max |kernel - plain| {diff:.4f} "
        f"(max |logit| {scale:.2f}); first tokens {first_k.tolist()} / {first_p.tolist()}")
    if diff > 2e-2 * scale:
        raise AssertionError(f"prefill logits: {diff} > 2e-2 * {scale}")
    if not torch.equal(first_k, first_p) or not torch.equal(first_k.to(tokens.dtype),
                                                            tokens[:, 0]):
        raise AssertionError("first tokens differ between the kernel and plain prefills")
    del lp
    tok = first_k[:, None].to(torch.int32)
    step_ms, decoded = [], [first_k.cpu()]
    for _ in range(new - 1):
        t1 = time.perf_counter()
        logits, caches = tfm.decode_step(model, cfg, tok, caches)
        host = torch.argmax(logits[:, -1], -1).cpu()           # through the host read
        step_ms.append((time.perf_counter() - t1) * 1e3)
        decoded.append(host)
        tok = host[:, None].to(device=DEVICE, dtype=torch.int32)
    same = torch.equal(torch.stack(decoded, 1).to(tokens.dtype), tokens.cpu())

    def decode3():
        t, c = tok, caches
        for _ in range(3):
            out, c = tfm.decode_step(model, cfg, t, c)
            t = torch.argmax(out[:, -1], -1).cpu()[:, None].to(device=DEVICE, dtype=torch.int32)

    prof_decode = profiled(decode3)
    del caches, logits, lk
    prof_prefill = profiled(lambda: prefill(None))
    log_profile("3 decode steps", prof_decode)
    log_profile("1 prefill (kernel path)", prof_prefill)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] decode step (batch {B}, through the host read): median "
        f"{statistics.median(step_ms):.2f} ms, min {min(step_ms):.2f}, max {max(step_ms):.2f}; "
        f"tokens equal to greedy_generate's: {same}; peak device memory {peak / 1e9:.2f} GB")

    reqs = serve_requests(cfg.vocab_size)
    srv = Server(cfg, model, SERVE_BATCH, SERVE_MAX_LEN, driver="jit", mode="continuous",
                 device=DEVICE)
    t0 = time.perf_counter()
    srv.warmup(SERVE_PROMPT)
    warm_s = time.perf_counter() - t0
    stats = srv.run(reqs)
    bad = [r.rid for r in reqs if not r.done or len(r.out) != r.max_new]
    log(f"[serve] Server(continuous) {SERVE_BATCH} slots, {len(reqs)} requests (prompts "
        f"{sorted(len(r.prompt) for r in reqs)}, max_new {[r.max_new for r in reqs]}), warmup "
        f"{warm_s:.1f} s: {stats['tokens']} tokens in {stats['wall_s']:.2f} s "
        f"({stats['tokens_per_s']:.1f} tokens/s), decode p50 {stats['decode_p50_us'] / 1e3:.2f} "
        f"ms p99 {stats['decode_p99_us'] / 1e3:.2f} ms, request p50 "
        f"{stats['request_p50_ms']:.0f} ms p99 {stats['request_p99_ms']:.0f} ms, occupancy "
        f"{stats['mean_occupancy']:.2f}, prefill calls {stats['prefill_calls']}")
    if bad or stats["completed"] != len(reqs):
        raise AssertionError(f"requests {bad} did not finish with their max_new tokens")
    checks = [parity(model, cfg, r) for r in reqs[:PARITY_REQUESTS]]
    log(f"[serve] requests {[r.rid for r in reqs[:PARITY_REQUESTS]]} against sequential "
        f"batch-1 prefill/decode_step: {checks}")
    prompt_buckets = srv._batcher.prompt_buckets
    del srv
    mozart_leg = serve_mozart_leg(cfg, model, reqs, stats, prompt_buckets)
    peak = torch.cuda.max_memory_allocated()
    resilience_clean("serve")
    chaos = [serve_chaos_wave(cfg, model, driver) for driver in ("jit", "mozart")]
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "flash_variant_launches": variants, "greedy_s": gen_s, "greedy_tokens_per_s": B * new / gen_s,
            "prefill_ms": prefill_ms, "plain_prefill_ms": plain_prefill_ms,
            "decode_ms": statistics.median(step_ms), "peak_bytes": peak,
            "prefill_logit_diff": diff, "server": stats, "parity": checks,
            "server_mozart": mozart_leg,
            "profile_decode": prof_decode, "profile_prefill": prof_prefill,
            "chaos": chaos}


# ---------------------------------------------------------------------------
# the new dense configs at their published widths
# ---------------------------------------------------------------------------


def moe_work(cfg, T: int) -> int:
    """Bytes of one MoE layer's dispatch on ``T`` tokens: the (E·C, D)
    buffer and its expert output, three (E·C, F) intermediates, the
    (T·k, D) gather and its weighted copy, and the float32 (T, E) router
    logits and probabilities (E·C = T·k·capacity_factor)."""
    m, D, elem = cfg.moe, cfg.d_model, cfg.dtype.itemsize
    rows = m.n_experts * int(max(1, (T * m.top_k * m.capacity_factor) // m.n_experts))
    return (elem * (2 * rows * D + 3 * rows * m.d_expert + 2 * T * m.top_k * D)
            + 2 * 4 * T * m.n_experts)


def scan_work(cfg, T: int) -> int:
    """Bytes of one recurrent layer's float32 tensors made ahead of its step
    loop and by it, on ``T`` tokens: Hymba's SSM heads dA and dBx (T, d_in,
    N), the list of h_t and its stack; RWKV's outer products k_t^T v_t
    (T, H, hd, hd), r, k, v, w and the step outputs (T, D).  0 for a stack
    without a recurrence."""
    if cfg.family == "hybrid":
        return 4 * 4 * T * cfg.ssm.expand * cfg.d_model * cfg.ssm.state_dim
    if cfg.family == "ssm":
        return 4 * T * cfg.d_model * (cfg.rwkv.head_dim + 6)
    return 0


def arch_depth(cfg) -> dict:
    """The most layers (up to the published depth) whose weights, KV cache
    for a batch-4 prompt of 2048 + the decode steps, and a 4 x 2048 prefill's
    largest working set fit the card's free memory less ``ARCH_MARGIN``, at
    most the recurrent models' ``ARCH_RECURRENT_LAYERS``.
    The working set is the plain path's float32 scores (four alive at once:
    scores, masked, softmax, the probabilities cast for p.v), the MLP's, the
    MoE dispatch's (``moe_work``) or the recurrence's (``scan_work``).
    DeepSeekMoE's dense pre-layers and their KV count as fixed, and so does
    an encoder-decoder's encoder stack (``enc_layers``); each decoder layer
    of one also holds its (B, Hkv, S_enc, D) cross K and V
    (``_cross_kv_per_layer``), and its dense cross-attention scores join the
    working set.  Where the dense plain path (the config's own switch at 2048 keys) would
    cut the depth and the blocked one (1024-key blocks) would not, the plain
    side of the comparison takes the blocked path: the same function."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    meta = weights.leaves(tfm.init_model(cfg, None, "meta"))
    nbytes = lambda ps: sum(p.numel() * p.element_size() for p in ps)
    layers = nbytes(p for n, p in meta.items() if n.startswith("layers."))
    a, B, S = cfg.attn, ARCH_BATCH, ARCH_PROMPT
    kd = tfm.first_dense(cfg)
    kv = (0 if a is None
          else 2 * B * (S + ARCH_DECODE) * a.n_kv_heads * a.head_dim * cfg.dtype.itemsize)
    cross_kv = (2 * B * ARCH_ENC_FRAMES * a.n_kv_heads * a.head_dim * cfg.dtype.itemsize
                if cfg.encdec else 0)
    fixed = nbytes(meta.values()) - layers + kd * kv
    per_layer = layers / (cfg.n_layers - kd) + kv + cross_kv
    mlp = max(6 * B * S * cfg.d_ff * cfg.dtype.itemsize, scan_work(cfg, B * S))
    if cfg.moe is not None:
        mlp = max(mlp, moe_work(cfg, B * S))
    scores = lambda keys: 0 if a is None else 4 * B * a.n_heads * S * keys * 4
    if cfg.encdec:                       # cross-attention: always the dense path
        mlp = max(mlp, scores(ARCH_ENC_FRAMES))
    work = {"dense": max(scores(S), mlp),
            "blocked": max(scores(min(S, cfg.attn_block_k)), mlp)}
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    fit = {k: int((free - ARCH_MARGIN - fixed - w) // per_layer) for k, w in work.items()}
    plain = "dense" if fit["dense"] >= cfg.n_layers or fit["blocked"] < cfg.n_layers \
        else "blocked"
    layers = max(1, min(cfg.n_layers, fit[plain]))
    timed = layers > ARCH_RECURRENT_LAYERS.get(cfg.name, layers)
    return {"published": cfg.n_layers,
            "layers": ARCH_RECURRENT_LAYERS[cfg.name] if timed else layers,
            "cut": "the script's time" if timed else "the card holds no more",
            "plain": plain, "free": free, "fixed": fixed, "per_layer": per_layer,
            "work": work[plain]}


def arch_window_calls(ref, held: int | None = None):
    """Wrap the model's switch to the kernel: record each call's window and
    causality (``seen``: (window, causal) pairs) and hold each call's output
    (the first ``held`` calls' where given) against the kernel's plain
    version on the same q, k, v (||kernel - plain|| / ||plain||, in the
    model's head order)."""
    from repro_torch.models import attention
    real, seen, rel = attention._kernel_attention, [], []

    def recording(q, k, v, *, causal, window):
        out = real(q, k, v, causal=causal, window=window)
        if held is not None and len(rel) >= held:
            return out
        group = q.shape[1] // k.shape[1]
        B, Hq, S, D = q.shape
        qk = q.reshape(B, group, Hq // group, S, D).transpose(1, 2).reshape(B, Hq, S, D)
        want = ref.attention_ref(qk, k, v, causal=causal, window=window)
        want = want.reshape(B, Hq // group, group, S, D).transpose(1, 2).reshape(B, Hq, S, D)
        rel.append(float((out.double() - want.double()).norm() / want.double().norm()))
        seen.append((window, causal))
        del want
        return out
    attention._kernel_attention = recording
    return seen, rel, lambda: setattr(attention, "_kernel_attention", real)


class RoutingReplay:
    """Record an MoE model's expert choices (each ``moe_block`` call's top-k
    indices, in call order) in one run, and give later runs the same
    choices, with gates from their own router probabilities.  Capacity
    ranks depend on the choices alone, so a replayed run makes every
    dispatch and drop decision of the recorded one and differs from it
    only continuously.  Free, a bfloat16 rounding difference anywhere
    before a router can flip a choice, and with capacity that reorders the
    ranks of every later assignment to the expert: the outputs then differ
    by the routing, not by the arithmetic under comparison."""

    def __init__(self, mlp):
        self.mlp, self.real, self.choices, self.at = mlp, mlp.route, [], None

    def _route(self, p, xt, cfg, dg=None):
        gate_vals, expert_idx, aux = self.real(p, xt, cfg, dg)
        if self.at is None:
            self.choices.append(expert_idx)
            return gate_vals, expert_idx, aux
        expert_idx = self.choices[self.at]
        self.at += 1
        probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
        gate_vals = torch.gather(probs, 1, expert_idx)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
        return gate_vals, expert_idx, aux

    def run(self, fn, replay: bool):
        """``fn()`` recording (``replay=False``, the first run) or replaying
        every recorded choice, in order."""
        self.at = 0 if replay else None
        self.mlp.route = self._route
        try:
            out = fn()
        finally:
            self.mlp.route = self.real
        if replay and self.at != len(self.choices):
            raise AssertionError(f"routing replay: {self.at} of {len(self.choices)} calls")
        return out


def moe_line(cfg) -> str:
    m = cfg.moe
    if m is None:
        return ""
    return (f"; MoE {m.n_experts} experts top-{m.top_k} (d_expert {m.d_expert}), "
            f"{m.n_shared} shared, {m.first_k_dense} dense pre-layer(s), capacity factor "
            f"{m.capacity_factor}")


def drops_line(cfg, drops: dict) -> str:
    """The assignments the capacity dropped (MoE): a token's output depends
    on its batch, the reason batch-1 decoding is no oracle for MoE serving."""
    if cfg.moe is None:
        return ""
    (pr, pd), (dr, dd) = drops["prefill"], drops["decode_step"]
    return (f"; capacity dropped {pd} of {pr} assignments in the prefill ({pd / pr:.2%}) "
            f"and {dd} of {dr} in decode step 1 ({dd / dr:.2%})")


def attn_line(cfg) -> str:
    a = cfg.attn
    if a is None:
        return "no attention"
    return (f"{a.n_heads}x{a.head_dim} heads over {a.n_kv_heads} kv (group "
            f"{a.n_heads // a.n_kv_heads}), qk-norm {a.qk_norm}, window {a.window} every "
            f"{a.pattern_period or '-'}")


def recurrence_line(cfg) -> str:
    if cfg.family == "hybrid":
        s = cfg.ssm
        return (f"; parallel SSM heads (d_inner {s.expand * cfg.d_model}, state {s.state_dim}, "
                f"conv {s.conv_width}), outputs averaged with attention's")
    if cfg.family == "ssm":
        return f"; RWKV-6 time mix ({cfg.d_model // cfg.rwkv.head_dim} heads of {cfg.rwkv.head_dim}) and channel mix"
    return ""


def tokens_agree(want_logits: torch.Tensor, got: torch.Tensor, noise: float) -> list:
    """Greedy tokens of two computations of one function: per row equal, or
    a near-tie, where the reference's top-2 logit margin is at most twice
    ``noise`` (a logit distance two computations of the same function
    showed in the same run: a flip within it says nothing about either).
    Returns the near-tie rows as (row, margin); raises on any other row."""
    top = torch.topk(want_logits[:, -1].float(), 2, dim=-1)
    want = top.indices[:, 0]
    ties = []
    for row in torch.nonzero(want != got).flatten().tolist():
        margin = float(top.values[row, 0] - top.values[row, 1])
        if margin > 2 * noise:
            raise AssertionError(f"row {row}: token {int(got[row])} != {int(want[row])}, "
                                 f"top-2 margin {margin:.4f} > 2 x {noise:.4f}")
        ties.append((row, round(margin, 4)))
    return ties


def state_handoff(cfg, model, prompt, lk, enc=None) -> dict:
    """The decode state across prefill and decode: prefill the first
    S - ``ARCH_HANDOFF`` tokens, then force the last ``ARCH_HANDOFF``
    through ``decode_step`` one at a time; the last logits against the full
    prefill's (``lk``), next tokens equal or a near-tie (``tokens_agree``).
    This carries the conv window, the SSM or WKV state, the token shifts and
    the KV cache across the two modes.  The bound is max(``tol``,
    ``ARCH_FLOOR_FACTOR`` x the floor) max|logit|, the floor being the
    distance of the same full prefill made one row at a time (only the
    GEMMs' shapes change).  An encoder-decoder model (``enc``: its
    ``enc_embeds``) prefills with them and decodes with
    ``enc_out=encode(...)``: its self-attention cache and the cross K/V
    recomputed at every step, together.  Twice: in the model's dtype (``tol`` 2e-2;
    random weights make a deep bfloat16 stack chaotic: hymba-1.5b's floor
    measured 3.3% of max|logit| on an H100, PERF.md §6), and on a float32
    copy of the same weights (``tol`` 2e-5, ``TOL``'s float32), which holds
    the handoff itself to float32 rounding."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    B, S = prompt.shape
    cut = S - ARCH_HANDOFF

    def prefill(m, c, tokens, rows=slice(None)):
        caches = tfm.init_caches(c, tokens.shape[0], S + ARCH_DECODE, device=DEVICE)
        kw = {} if enc is None else {"enc_embeds": enc[rows]}
        return tfm.prefill(m, c, tokens, caches=caches, **kw)

    out = {}
    for dtype, tol in ((cfg.dtype, 2e-2), (torch.float32, TOL[torch.float32])):
        c = cfg.with_runtime(dtype=dtype)
        m = model if dtype == cfg.dtype else weights.ParamTree(weights.unflatten(
            {n: p.detach().float() for n, p in model.named_parameters()}))
        full = lk if dtype == cfg.dtype else prefill(m, c, prompt)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(m, c, prompt[:, :cut])
        dkw = {} if enc is None else {"enc_out": tfm.encode(m, enc, c)}
        for t in range(cut, S):
            logits, caches = tfm.decode_step(m, c, prompt[:, t:t + 1], caches, **dkw)
        nxt = torch.argmax(logits[:, -1], -1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows = torch.cat([prefill(m, c, prompt[i:i + 1], slice(i, i + 1))[0]
                          for i in range(B)])
        scale = float(full.float().abs().max())
        dist = lambda x: float((x[:, -1].float() - full[:, -1].float()).abs().max())
        diff, floor = dist(logits), dist(rows)
        bound = max(tol * scale, ARCH_FLOOR_FACTOR * floor)
        name = str(dtype).split(".")[-1]
        log(f"[archs] {cfg.name}: state handoff in {name}, prefill {cut} tokens then "
            f"{ARCH_HANDOFF} forced decode steps ({ms:.1f} ms): last logits max |handoff - "
            f"full prefill| {diff:.3e} = {diff / scale:.3e} max|logit|; the full prefill one "
            f"row at a time {floor:.3e} = {floor / scale:.3e} (bound max({tol:g}, "
            f"{ARCH_FLOOR_FACTOR} x that) = {bound / scale:.3e} max|logit|); next tokens "
            f"{nxt.tolist()} / {torch.argmax(full[:, -1], -1).tolist()}")
        ties = tokens_agree(full, nxt, floor)
        if diff > bound:
            raise AssertionError(f"archs/{cfg.name} state handoff ({name}): {diff} vs "
                                 f"max({tol} * {scale}, {ARCH_FLOOR_FACTOR} * {floor})")
        out[name] = {"ms": ms, "logit_diff": diff, "rows_floor": floor, "max_logit": scale,
                     "bound": bound, "near_ties": ties}
        del m, full, logits, caches, rows, dkw
    torch.cuda.empty_cache()
    return {"prefill_tokens": cut, "decode_steps": ARCH_HANDOFF, **out}


def recurrence_times(cfg, model, prompt, prefill_ms: float) -> dict:
    """Layer 0's recurrent sub-layer (Hymba's ``ssm_block``, RWKV's
    ``time_mix``) and its step loop alone (``ssm._scan``, ``rwkv._wkv``) on
    this prompt's own inputs, captured from one prefill: CUDA-event medians
    of ``RECURRENT_REPS`` calls, the loop's share of a prefill (n_layers x
    its time over the prefill's) and a profile of one sub-layer call (a
    whole prefill would pass the profiler's ~50,000 records)."""
    from repro_torch.models import rwkv, ssm
    from repro_torch.models import transformer as tfm
    mod, names = ((ssm, ("ssm_block", "_scan")) if cfg.family == "hybrid"
                  else (rwkv, ("time_mix", "_wkv")))
    real = {n: getattr(mod, n) for n in names}
    seen = {}

    def capture(name):
        def call(*args, **kw):
            seen.setdefault(name, (args, kw))
            return real[name](*args, **kw)
        return call
    for n in names:
        setattr(mod, n, capture(n))
    try:
        tfm.prefill(model, cfg, prompt, caches=tfm.init_caches(
            cfg, prompt.shape[0], prompt.shape[1] + ARCH_DECODE, device=DEVICE))
    finally:
        for n in names:
            setattr(mod, n, real[n])
    (block_args, block_kw), (loop_args, loop_kw) = (seen[n] for n in names)
    block = lambda: real[names[0]](*block_args, **block_kw)
    loop = lambda: real[names[1]](*loop_args, **loop_kw)
    out = {"layer": names[0], "loop": names[1], "layer_ms": cuda_ms(block, RECURRENT_REPS),
           "loop_ms": cuda_ms(loop, RECURRENT_REPS), "profile": profiled(block, top=6)}
    out["loop_share"] = cfg.n_layers * out["loop_ms"] / prefill_ms
    out["layer_share"] = cfg.n_layers * out["layer_ms"] / prefill_ms
    log(f"[archs] {cfg.name}: layer 0's {names[0]} on the prefill's inputs "
        f"{out['layer_ms']:.2f} ms, its step loop {names[1]} ({prompt.shape[1]} steps) "
        f"{out['loop_ms']:.2f} ms (CUDA events, medians of {RECURRENT_REPS}); x "
        f"{cfg.n_layers} layers = {out['layer_share']:.1%} / {out['loop_share']:.1%} of the "
        f"{prefill_ms:.1f} ms prefill")
    log_profile(f"{cfg.name} layer 0 {names[0]}", out["profile"], "archs")
    del seen, block_args, loop_args
    return out


def vl_positions(B: int) -> torch.Tensor:
    """qwen2-vl's (3, B, S) t/h/w position streams for one image between two
    text spans (``VL_PREFIX``, ``VL_IMAGE``, ``VL_TAIL``): the prefix at
    t = h = w = 0..63, the 48 x 32 merged patches at t = 64, h = 64 + row,
    w = 64 + col, the tail from 64 + 48 = 112 upward on all three."""
    rows, cols = VL_IMAGE
    r, c = np.divmod(np.arange(rows * cols), cols)
    text = np.stack([np.arange(VL_PREFIX)] * 3)
    image = np.stack([np.full(rows * cols, VL_PREFIX), VL_PREFIX + r, VL_PREFIX + c])
    tail = np.stack([VL_PREFIX + max(rows, cols) + np.arange(VL_TAIL)] * 3)
    pos = np.concatenate([text, image, tail], axis=1)
    assert pos.shape[1] == ARCH_PROMPT, pos.shape
    return torch.as_tensor(pos, dtype=torch.int32, device=DEVICE)[:, None].expand(
        3, B, ARCH_PROMPT).contiguous()


def arch_inputs(cfg, model, prompt) -> tuple:
    """(the prefill's inputs, the decode steps' extra inputs, a line saying
    what they are).  Tokens for most models.  qwen2-vl (the stub vision
    frontend, as the reference's): ``input_embeds`` whose text rows are the
    embedding table's rows of ``prompt`` and whose image rows are a seeded
    normal x 0.02, with ``vl_positions``; decode steps take positions from
    the cache length.  seamless: the tokens and ``enc_embeds``, a seeded
    normal (B, ``ARCH_ENC_FRAMES``, d), decode steps against its encoder
    output (``enc_out``, made here)."""
    from repro_torch.models import transformer as tfm
    B = prompt.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    if cfg.family == "vlm":
        rows, cols = VL_IMAGE
        emb = tfm._inputs_to_embeds(model, cfg, tokens=prompt)
        emb[:, VL_PREFIX:VL_PREFIX + rows * cols] = (torch.randn(
            (B, rows * cols, cfg.d_model), generator=gen, device=DEVICE) * 0.02).to(cfg.dtype)
        return ({"input_embeds": emb, "positions": vl_positions(B)}, {},
                f"; input_embeds: {VL_PREFIX} text tokens, a {rows} x {cols} image at "
                f"t = {VL_PREFIX}, a {VL_TAIL}-token tail from {VL_PREFIX + max(rows, cols)} "
                f"(M-RoPE sections {cfg.attn.mrope_sections})")
    if cfg.encdec:
        enc = torch.randn((B, ARCH_ENC_FRAMES, cfg.d_model), generator=gen,
                          device=DEVICE).to(cfg.dtype)
        return ({"tokens": prompt, "enc_embeds": enc}, {"enc_out": tfm.encode(model, enc, cfg)},
                f"; encoder {cfg.n_encoder_layers} layers over enc_embeds "
                f"{tuple(enc.shape)}, a cross-attention per decoder layer")
    return {"tokens": prompt}, {}, ""


def mrope_checks(cfg, model, pk, lk, floor: float, prefill) -> dict:
    """qwen2-vl: on layer 0's q and k of this prompt (float32), M-RoPE with
    three equal streams against RoPE (within ``TOL``'s float32 2e-5 of
    max|RoPE|); and the prefill's last logits with the image layout against
    those with 1-D positions, which must differ by more than the two plain
    paths' distance (``floor``): the sections are in use."""
    from repro_torch.models import attention, layers
    a, B, S = cfg.attn, ARCH_BATCH, ARCH_PROMPT
    lp = model["layers"]
    h = layers.rms_norm(pk["input_embeds"], lp["ln1"][0], cfg.norm_eps).float()
    pos = torch.arange(S, device=DEVICE)[None].expand(B, S)
    worst = 0.0
    for name, heads in (("wq", a.n_heads), ("wk", a.n_kv_heads)):
        x = attention._split_heads(h @ lp["attn"][name][0].float(), heads, a.head_dim)
        want = layers.apply_rope(x, pos, a.rope_theta)
        got = layers.apply_mrope(x, pos.expand(3, B, S), a.rope_theta, a.mrope_sections)
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        if rel > TOL[torch.float32]:
            raise AssertionError(f"archs/{cfg.name}: M-RoPE of three equal streams vs RoPE "
                                 f"({name}): {rel:.3e} > {TOL[torch.float32]}")
    l1, _ = prefill(None, positions=None)
    moved = float((l1.float() - lk.float()).abs().max())
    log(f"[archs] {cfg.name}: M-RoPE with three equal streams vs RoPE on layer 0's q and k "
        f"(float32): max {worst:.3e} of max|RoPE| (bound {TOL[torch.float32]:g}); the "
        f"image layout's last logits against 1-D positions' {moved:.4f} (must exceed the "
        f"two plain paths' {floor:.4f})")
    if not moved > floor:
        raise AssertionError(f"archs/{cfg.name}: image positions moved the logits by {moved}, "
                             f"not past the plain paths' {floor}")
    return {"mrope_vs_rope_rel": worst, "image_vs_1d_logit_diff": moved}


def cross_kv_share(cfg, model, tok, caches, dk) -> dict:
    """seamless: one decode step (on a copy of the cache) and its cross K/V
    recomputation alone (``_cross_kv_per_layer`` of ``enc_out``, every
    layer's): device times (``device_ms``: profiler windows measured again
    until they record every launch; late in the script the profiler drops
    records) and CUDA-event times (3 reps), the recomputation's share of
    the step by both, and a profile of the step (its top kernels)."""
    from repro_torch.models import transformer as tfm
    spare = pytree.tree_map(torch.clone, caches)
    step = lambda: tfm.decode_step(model, cfg, tok, spare, **dk)
    cross = lambda: tfm._cross_kv_per_layer(model, dk["enc_out"], cfg)
    out = {"step_profile": profiled(step, top=8), "step_device_ms": device_ms(step, 3),
           "cross_device_ms": device_ms(cross, 3), "step_ms": cuda_ms(step, 3),
           "cross_ms": cuda_ms(cross, 3)}
    out["device_share"] = out["cross_device_ms"] / out["step_device_ms"]
    out["time_share"] = out["cross_ms"] / out["step_ms"]
    log_profile(f"{cfg.name} decode step", out["step_profile"], "archs")
    log(f"[archs] {cfg.name}: cross K/V recomputation per decode step ({cfg.n_layers} layers' "
        f"K and V of the {ARCH_ENC_FRAMES}-frame encoder output): "
        f"{out['cross_device_ms']:.3f} ms device of the step's {out['step_device_ms']:.3f} "
        f"({out['device_share']:.1%}); CUDA events {out['cross_ms']:.3f} of {out['step_ms']:.3f} "
        f"ms ({out['time_share']:.1%})")
    del spare
    return out


@torch.inference_mode()
def arch_run(arch: str, counters, flash, ref) -> dict:
    """One model at its published widths (depth as ``arch_depth`` allows),
    random weights from seed 0: a greedy prefill (batch 4 x 2048) with the
    kernel, its flash-attention launches (one per attention layer, all tc;
    window calls apart from global ones; none for RWKV), each launch held in
    place against the kernel's plain version on its own q, k, v
    (``ATTN_REL_TOL``); the prefill held against the plain attention path:
    first tokens equal or a near-tie within the two plain paths' distance
    (``tokens_agree``; hymba-1.5b's bfloat16 stack flips a near-tie),
    and last-position logits within 2e-2 max|logit| or,
    where two plain paths (the chosen one and the blocked path with 512-key
    blocks) are themselves nearly that far apart, within
    ``ARCH_FLOOR_FACTOR`` times their distance in the same run: random
    weights make a deep bfloat16 stack chaotic, and at internlm2-20b's 48
    layers the two plain paths already differ by 1.95% of max|logit| on an
    H100 (PERF.md §6); then ``ARCH_DECODE`` decode steps.  For an MoE model
    both plain paths replay the kernel path's expert choices
    (``RoutingReplay``), so all three make the same dispatch and drop
    decisions; the distance with free routing is printed beside it, with
    the assignments the capacity dropped and profiles of a prefill and a
    decode step.  A recurrent model (hybrid, RWKV) also hands its state from
    a prefill to forced decode steps (``state_handoff``) and times one
    layer's recurrence (``recurrence_times``); an attention-free model's
    plain path is its kernel path, so it has no plain comparison.  The
    embedding-input models take ``arch_inputs``: qwen2-vl prefills from
    ``input_embeds`` with an image's M-RoPE positions (``mrope_checks``);
    seamless encodes ``enc_embeds`` in the prefill (one non-causal launch
    per encoder layer before the decoder's causal ones; cross-attention
    never launches), decodes against the encoder output, hands its cache
    over as the recurrent models do, and gives the cross K/V recomputation's
    share of a decode step (``cross_kv_share``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mlp
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import param_count
    cfg = get_config(arch)
    depth = arch_depth(cfg)
    if depth["layers"] < cfg.n_layers:
        cfg = cfg.with_runtime(n_layers=depth["layers"])
    a = cfg.attn
    windows = tfm.layer_windows(cfg) if a is not None else []
    # the kernel calls of one prefill, in order: (window, causal)
    want_calls = ([(tfm.BIG_WINDOW, False)] * cfg.n_encoder_layers if cfg.encdec else []) + [
        (w, True) for w in windows]
    recurrent = tfm.layer_kind(cfg) in ("hybrid", "rwkv")
    cut = ("full depth" if cfg.n_layers == depth["published"]
           else f"depth cut: {depth['cut']}")
    log(f"[archs] {arch} at its published widths: d_model {cfg.d_model}, d_ff {cfg.d_ff} "
        f"({'gated ' if cfg.gated_mlp else 'plain '}{cfg.activation}), {attn_line(cfg)}, vocab "
        f"{cfg.vocab_size}{moe_line(cfg)}{recurrence_line(cfg)}; layers {cfg.n_layers} of "
        f"{depth['published']} "
        f"({cut}; free {depth['free'] / 1e9:.2f} GB, fixed "
        f"{depth['fixed'] / 1e9:.2f} GB, {depth['per_layer'] / 1e9:.3f} GB per layer with its "
        f"KV, working set {depth['work'] / 1e9:.2f} GB with the {depth['plain']} plain "
        f"attention path); {param_count(cfg) / 1e9:.3f} B "
        f"parameters, random weights (seed 0)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tfm.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    B, S = ARCH_BATCH, ARCH_PROMPT
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32,
                             device=DEVICE)

    plain_cfg = (cfg if depth["plain"] == "dense"
                 else cfg.with_runtime(dense_attn_threshold=cfg.attn_block_k))
    pk, dk, inputs_line = arch_inputs(cfg, model, prompt)

    def prefill(use_kernel, c=None, **over):
        c = c or (cfg if use_kernel is None else plain_cfg)
        caches = tfm.init_caches(cfg, B, S + ARCH_DECODE, device=DEVICE)
        return tfm.prefill(model, c, caches=caches, use_kernel=use_kernel, **{**pk, **over})

    prefill(None)                                          # library and allocator warm-up
    # this path's run: counts set to 0 just before, read just after
    for c in counters:
        c.launches = 0
    flash.variant_launches = {name: 0 for name in flash.variant_launches}
    pin = RoutingReplay(mlp) if cfg.moe is not None else None
    pinned = (lambda fn: pin.run(fn, replay=True)) if pin else (lambda fn: fn())
    seen, rel, restore = arch_window_calls(ref)
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mlp.count_drops() as prefill_drops:
            lk, caches = (pin.run(lambda: prefill(None), replay=False) if pin
                          else prefill(None))
        first_k = torch.argmax(lk[:, -1], -1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
    finally:
        restore()
    launches = {c.__name__: c.launches for c in counters}
    variants = dict(flash.variant_launches)
    by_window = {"window": sum(w != tfm.BIG_WINDOW for w, _ in seen),
                 "global": sum(w == tfm.BIG_WINDOW for w, _ in seen)}
    by_causal = {"causal": sum(c for _, c in seen), "non-causal": sum(not c for _, c in seen)}
    want_window = sum(w != tfm.BIG_WINDOW for w in windows)
    # cross-attention takes the plain path: every launch is a self-attention's
    cross_launches = launches["flash_attention"] - len(want_calls)
    if (launches["flash_attention"] != len(want_calls) or variants["tc"] != len(want_calls)
            or by_window["window"] != want_window or seen != want_calls):
        raise AssertionError(f"archs/{arch}: flash_attention {launches['flash_attention']} "
                             f"launches ({variants}, windows {by_window}, {by_causal}) for "
                             f"{len(want_calls)} self-attention layers ({want_window} windowed, "
                             f"{cfg.n_encoder_layers if cfg.encdec else 0} non-causal)")
    rel_max = max(rel, default=0.0)
    scale = float(lk.float().abs().max())
    plain_ms = diff = floor = diff_other = free = None
    first_p, ties = first_k, []
    if a is not None:
        plain_ms = host_ms(lambda: prefill(False), 1)
        if pin:             # MoE, free routing: how far the routing alone moves it
            lf, _ = prefill(False)
            free = {"logit_diff": float((lk.float() - lf.float()).abs().max()),
                    "first_tokens_equal": bool(torch.equal(torch.argmax(lf[:, -1], -1),
                                                           first_k))}
            del lf
        lp, _ = pinned(lambda: prefill(False))
        diff = float((lk.float() - lp.float()).abs().max())
        scale = float(lp.float().abs().max())
        first_p = torch.argmax(lp[:, -1], -1)
        other = cfg.with_runtime(dense_attn_threshold=512, attn_block_k=512)
        lb, _ = pinned(lambda: prefill(False, other))
        floor = float((lb.float() - lp.float()).abs().max())
        diff_other = float((lk.float() - lb.float()).abs().max())
        ties = tokens_agree(lp, first_k, floor)
        del lp, lb
    vl = mrope_checks(cfg, model, pk, lk, floor, prefill) if cfg.family == "vlm" else None
    kernel_ms = host_ms(lambda: prefill(None), 2)
    prof = profiled(lambda: prefill(None), top=8) if pin else None
    tok = first_k[:, None].to(torch.int32)
    step_ms = []
    for i in range(ARCH_DECODE):
        t1 = time.perf_counter()
        with mlp.count_drops() as step_drops:
            logits, caches = tfm.decode_step(model, cfg, tok, caches, **dk)
        host = torch.argmax(logits[:, -1], -1).cpu()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        tok = host[:, None].to(device=DEVICE, dtype=torch.int32)
        if i == 0:
            decode_drops = (step_drops.routed, step_drops.dropped)
    drops = {"prefill": (prefill_drops.routed, prefill_drops.dropped),
             "decode_step": decode_drops}
    if pin:                             # one more step, on a copy of the cache
        spare = pytree.tree_map(torch.clone, caches)
        decode_prof = profiled(lambda: tfm.decode_step(model, cfg, tok, spare), top=8)
        del spare
    cross = cross_kv_share(cfg, model, tok, caches, dk) if cfg.encdec else None
    finite = bool(torch.isfinite(logits.float()).all())
    peak = torch.cuda.max_memory_allocated()
    handoff = (state_handoff(cfg, model, prompt, lk, enc=pk.get("enc_embeds"))
               if recurrent or cfg.encdec else None)
    recurrence = recurrence_times(cfg, model, prompt, kernel_ms) if recurrent else None
    if a is None:
        bound = None
        against = ("no attention: the kernel path is the plain path (no flash launch), no "
                   "plain comparison")
    else:
        bound = max(2e-2 * scale, ARCH_FLOOR_FACTOR * floor)
        against = (f"plain ({depth['plain']}) attention path {plain_ms:.1f} ms; each launch "
                   f"against the plain version on its q, k, v: ||kernel - plain|| / ||plain|| "
                   f"max {rel_max:.3e}; last-position logits max |kernel - plain| {diff:.4f} = "
                   f"{diff / scale:.4f} max|logit| (max |logit| {scale:.2f}), against the "
                   f"blocked-512 plain path {diff_other:.4f}; the two plain paths apart "
                   f"{floor:.4f} = {floor / scale:.4f} max|logit| (bound max(2e-2, "
                   f"{ARCH_FLOOR_FACTOR} x that) = {bound / scale:.4f} max|logit|)")
    log(f"[archs] {arch}: init {init_s:.1f} s{inputs_line}; prefill batch {B} x {S}: kernel "
        f"path {kernel_ms:.1f} ms (the counted run, each launch checked in place: "
        f"{prefill_ms:.1f} ms); launches {launches}, flash_attention by variant {variants}, by "
        f"window {by_window}, by causality {by_causal}, from cross-attention "
        f"{cross_launches}; {against}; first tokens "
        f"{first_k.tolist()} / {first_p.tolist()} (near-ties (row, top-2 margin): {ties}); "
        f"{ARCH_DECODE} decode steps median {statistics.median(step_ms):.2f} ms, logits finite "
        f"{finite}; peak device memory {peak / 1e9:.2f} GB{drops_line(cfg, drops)}")
    if pin:
        log(f"[archs] {arch}: the plain paths replayed the kernel path's routing (each "
            f"moe_block call's top-k experts; gates from their own router); with free "
            f"routing the dense plain path sits {free['logit_diff']:.4f} = "
            f"{free['logit_diff'] / scale:.4f} max|logit| from the kernel path, first tokens "
            f"equal {free['first_tokens_equal']} (capacity makes the routing discontinuous)")
        log_profile(f"{arch} prefill (kernel path)", prof, "archs")
        log_profile(f"{arch} decode step", decode_prof, "archs")
    if (bound is not None and diff > bound) or not finite or rel_max > ATTN_REL_TOL:
        raise AssertionError(f"archs/{arch}: logits {diff} vs max(2e-2 * {scale}, "
                             f"{ARCH_FLOOR_FACTOR} * {floor}), finite {finite}, "
                             f"in-place kernel error {rel_max}")
    served = arch_serve(cfg, model, ARCH_SERVE[arch]) if arch in ARCH_SERVE else None
    del model, caches, logits, lk, pk, dk
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "published_layers": depth["published"],
            "plain_path": depth["plain"] if a is not None else None,
            "launches": launches, "flash_variant_launches": variants,
            "flash_by_window": by_window, "flash_by_causal": by_causal,
            "flash_cross_launches": cross_launches, "prefill_ms": kernel_ms,
            "plain_prefill_ms": plain_ms,
            "prefill_logit_diff": diff, "max_logit": scale, "plain_paths_diff": floor,
            "launch_rel_err_max": rel_max, "first_token_near_ties": ties,
            "decode_ms": statistics.median(step_ms), "peak_bytes": peak, "init_s": init_s,
            "moe_drops": drops if pin else None, "moe_free_routing": free,
            "moe_prefill_profile": prof, "moe_decode_profile": decode_prof if pin else None,
            "state_handoff": handoff, "recurrence": recurrence, "mrope": vl,
            "cross_kv": cross, "server": served}


def arch_serve(cfg, model, drivers: tuple) -> dict:
    """The same 4 requests through ``Server(continuous)`` on each of
    ``drivers`` in turn: 2 slots, buckets from ``warmup`` (a pad-free model,
    hybrid or RWKV: one bucket per exact prompt length, ``prompt_lens``),
    every step warm.  With both drivers the mozart tokens must equal the
    jit tokens; without capacity routing (no MoE model: there capacity makes
    a token depend on its batch) every request is also held against
    sequential batch-1 prefill/decode_step.  A pad-free model's mozart leg
    (and that of a model in ``ARCH_WARM_START``) saves its plans, and a
    second batcher started from the file (on the first one's prompt
    buckets) serves the same requests with 0 planner calls and no warmup."""
    from repro_torch.core import plan_cache
    from repro_torch.core.serving import ContinuousBatcher
    from repro_torch.launch.serve import Request, Server
    rng = np.random.default_rng(3)
    specs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in zip(ARCH_SERVE_PROMPTS, ARCH_SERVE_NEW)]
    path = ROOT / "build" / "arch_serve_plans.json"
    path.parent.mkdir(exist_ok=True)
    legs, outs = {}, {}
    for driver in drivers:
        reqs = [Request(rid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(specs)]
        path.unlink(missing_ok=True)
        plan_cache.clear()
        srv = Server(cfg, model, 2, ARCH_SERVE_MAX_LEN, driver=driver, mode="continuous",
                     device=DEVICE, plan_cache_path=str(path) if driver == "mozart" else None)
        pad_free = srv._batcher.pad_free
        t0 = time.perf_counter()
        srv.warmup(max(ARCH_SERVE_PROMPTS), prompt_lens=list(ARCH_SERVE_PROMPTS))
        warm_s = time.perf_counter() - t0
        stats = srv.run(reqs)
        buckets = srv._batcher.prompt_buckets
        del srv
        log(f"[archs] {cfg.name}: Server(continuous, driver {driver}) 2 slots, {len(reqs)} "
            f"requests (prompts {list(ARCH_SERVE_PROMPTS)}{', pad-free: exact-length buckets' if pad_free else ''}), "
            f"warmup {warm_s:.1f} s: "
            f"{stats['tokens']} tokens in {stats['wall_s']:.2f} s ({stats['tokens_per_s']:.1f} "
            f"tokens/s), decode p50 {stats['decode_p50_us'] / 1e3:.2f} ms p99 "
            f"{stats['decode_p99_us'] / 1e3:.2f} ms; planner calls {stats['planner_calls']}, "
            f"traces {stats['jit_traces']}, warm {stats['warm']}")
        if (stats["completed"] != len(reqs) or not stats["warm"] or stats["planner_calls"]
                or any(len(r.out) != r.max_new for r in reqs)):
            raise AssertionError(f"archs/{cfg.name} serve ({driver}): {stats}")
        outs[driver] = reqs
        legs[driver] = {k: stats[k] for k in (
            "tokens", "wall_s", "tokens_per_s", "decode_p50_us", "decode_p99_us",
            "planner_calls", "jit_traces", "warm")} | {"warmup_s": warm_s}
        if driver == "mozart" and (pad_free or cfg.name in ARCH_WARM_START):
            plan_cache.clear()                          # a restarted replica
            again = ContinuousBatcher(cfg, model, 2, ARCH_SERVE_MAX_LEN, driver="mozart",
                                      plan_cache_path=str(path), device=DEVICE,
                                      prompt_buckets=buckets)
            loaded = plan_cache.cache_info().get("persist_loaded", 0)
            restart = [again.make_request(p, m) for p, m in specs]
            rstats = again.run(restart)
            same = [r.out for r in restart] == [r.out for r in reqs]
            log(f"[archs] {cfg.name}: warm start from the plan file ({loaded} entries "
                f"loaded): {rstats['tokens']} tokens, planner calls {rstats['planner_calls']}, "
                f"traces {rstats['jit_traces']}, warm {rstats['warm']}, tokens equal {same}")
            if rstats["planner_calls"] or not rstats["warm"] or not same or not loaded:
                raise AssertionError(f"archs/{cfg.name} warm start: loaded {loaded}, {rstats}")
            legs[driver]["warm_start"] = {"entries_loaded": loaded,
                                          "planner_calls": rstats["planner_calls"],
                                          "warm": rstats["warm"]}
            del again
    path.unlink(missing_ok=True)
    plan_cache.clear()
    checks = []
    if "jit" in outs:
        equal = [r.out for r in outs["mozart"]] == [r.out for r in outs["jit"]]
        checks.append(f"mozart tokens equal to jit tokens: {equal}")
        if not equal:
            raise AssertionError(f"archs/{cfg.name} serve: {checks[-1]}")
    if cfg.moe is None:
        checks.append("requests against sequential batch-1 decoding: "
                      f"{[parity(model, cfg, r) for r in outs['mozart']]}")
    log(f"[archs] {cfg.name}: {'; '.join(checks)}")
    return legs | {"check": "; ".join(checks)}


def phase_archs(counters, flash, ref) -> list:
    out = []
    for arch in ARCHS:
        out.append(arch_run(arch, counters, flash, ref))
        resilience_clean(f"archs/{arch}")
    return out


# ---------------------------------------------------------------------------
# band: logit softcap and the banded sliding-window path (ROADMAP A7.5)
# ---------------------------------------------------------------------------


def band_launch_checks():
    """Wrap the model's switch to the kernel: each call's window and
    causality (``seen``) and its output held in place against the port's
    banded plain path and its dense windowed plain path on the same q, k, v
    (||kernel - plain|| / ||plain||, both in the model's head order)."""
    from repro_torch.models import attention
    real, seen, rel = attention._kernel_attention, [], {"banded": [], "dense": []}

    def recording(q, k, v, *, causal, window):
        out = real(q, k, v, causal=causal, window=window)
        for name, plain in (("banded", lambda: attention._banded_attention(q, k, v,
                                                                          window=window)),
                            ("dense", lambda: attention._dense_attention(
                                q, k, v, causal=causal, window=window))):
            want = plain().double()
            rel[name].append(float((out.double() - want).norm() / want.norm()))
            del want
        seen.append((window, causal))
        return out
    attention._kernel_attention = recording
    return seen, rel, lambda: setattr(attention, "_kernel_attention", real)


@torch.inference_mode()
def phase_band(counters, flash, fl, ref) -> dict:
    """gemma-7b at its published widths, n_layers cut to ``BAND_LAYERS``,
    random weights from seed 0.  Banded: window 1024 with
    ``banded_attention``, a 4 x 4096 prefill: one tc window launch per
    layer (counted from 0 just before the run), each held in place against
    the banded and the dense windowed plain paths (``ATTN_REL_TOL``); the
    last-position logits against both plain prefills within max(2e-2, 1.5
    x their distance) x max|logit|, first tokens equal or a near-tie; the
    kernel timed at the shape beside SDPA with a mask.  Softcap: the same
    weights, wq and wk scaled by ``SOFTCAP_QK_SCALE`` so that scores reach
    the cap, with Gemma 2's cap of 50 over 4 x 2048: 0 flash-attention
    launches (a softcap layer stays off the kernel), ``SOFTCAP_DECODE``
    greedy decode steps, each step's logits against teacher forcing at its
    position (a prefill of the prompt and the tokens so far) within
    max(2e-2, 1.5 x floor) x max|logit|, the floor the distance between
    teacher forcing on the dense and on the blocked path; the same teacher
    forcing uncapped must move the logits by more than that bound (a path
    that dropped the cap would fail the decode check); the softcap prefill
    timed beside the uncapped one on the kernel."""
    import dataclasses
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import param_count
    t_phase = time.perf_counter()
    base = serve_config().with_runtime(n_layers=BAND_LAYERS)
    band = base.with_runtime(attn=dataclasses.replace(base.attn, window=BAND_WINDOW),
                             banded_attention=True)
    windowed = band.with_runtime(banded_attention=False)      # the dense windowed path
    cap = base.with_runtime(attn=dataclasses.replace(base.attn, logit_softcap=SOFTCAP))
    a = base.attn
    log(f"[band] {base.name} at its published widths: d_model {base.d_model}, "
        f"{a.n_heads}x{a.head_dim} heads (kv {a.n_kv_heads}), d_ff {base.d_ff}, vocab "
        f"{base.vocab_size}; layers {BAND_LAYERS} of 28 (depth cut: the phase's time), "
        f"{param_count(base) / 1e9:.3f} B parameters, random weights (seed 0)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = tfm.init_model(base, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    rng = np.random.default_rng(0)
    B, S = BAND_BATCH, BAND_PROMPT
    prompt = torch.as_tensor(rng.integers(0, base.vocab_size, (B, S)), dtype=torch.int32,
                             device=DEVICE)

    def prefill(cfg, tokens, use_kernel, extra=0):
        caches = tfm.init_caches(cfg, tokens.shape[0], tokens.shape[1] + extra, device=DEVICE)
        return tfm.prefill(model, cfg, tokens, caches=caches, use_kernel=use_kernel)

    prefill(band, prompt, None)                            # allocator and library warm-up
    for c in counters:
        c.launches = 0
    flash.variant_launches = {name: 0 for name in flash.variant_launches}
    seen, rel, restore = band_launch_checks()
    try:
        lk, _ = prefill(band, prompt, None)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = {c.__name__: c.launches for c in counters}
    variants = dict(flash.variant_launches)
    if (launches["flash_attention"] != BAND_LAYERS or variants["tc"] != BAND_LAYERS
            or seen != [(BAND_WINDOW, True)] * BAND_LAYERS):
        raise AssertionError(f"band: flash_attention {launches} ({variants}), calls {seen} "
                             f"for {BAND_LAYERS} banded layers of window {BAND_WINDOW}")
    rel_max = {k: max(v) for k, v in rel.items()}
    if not all(r <= ATTN_REL_TOL for r in rel_max.values()):
        raise AssertionError(f"band: kernel launches against the plain paths {rel_max}")
    lb, _ = prefill(band, prompt, False)
    lw, _ = prefill(windowed, prompt, False)
    scale = float(lb.float().abs().max())
    floor = float((lb.float() - lw.float()).abs().max())
    diffs = {"banded": float((lk.float() - lb.float()).abs().max()),
             "dense": float((lk.float() - lw.float()).abs().max())}
    bound = max(2e-2 * scale, ARCH_FLOOR_FACTOR * floor)
    if not all(d <= bound for d in diffs.values()):
        raise AssertionError(f"band: last-position logits {diffs} beyond {bound:.4f} "
                             f"(max|logit| {scale:.3f}, plain paths {floor:.4f} apart)")
    ties = tokens_agree(lb, torch.argmax(lk[:, -1], -1), floor)
    times = {"kernel": host_ms(lambda: prefill(band, prompt, None), 2),
             "banded": host_ms(lambda: prefill(band, prompt, False), 1),
             "dense": host_ms(lambda: prefill(windowed, prompt, False), 1)}
    log(f"[band] banded prefill {B} x {S}, window {BAND_WINDOW}: flash_attention launches "
        f"{launches['flash_attention']} ({variants}), all window {BAND_WINDOW} causal; "
        f"in place: max ||kernel - banded plain|| / ||plain|| {rel_max['banded']:.3e}, "
        f"dense windowed {rel_max['dense']:.3e}; last-position logits: kernel vs banded "
        f"{diffs['banded']:.4f}, vs dense windowed {diffs['dense']:.4f}, banded vs dense "
        f"windowed {floor:.4f} (bound {bound:.4f}, max|logit| {scale:.3f}); first tokens "
        f"near-ties {ties}; prefill ms: kernel {times['kernel']:.1f}, banded plain "
        f"{times['banded']:.1f}, dense windowed plain {times['dense']:.1f}")
    del lk, lb, lw
    torch.cuda.empty_cache()
    shape = attn_shape_times(fl, ref, torch.nn.functional, torch.Generator(device=DEVICE)
                             .manual_seed(7), "gemma-7b banded", B, a.n_heads, a.n_kv_heads,
                             S, a.head_dim, BAND_WINDOW)

    # softcap: no kernel launch; decode against teacher forcing
    Sc = SOFTCAP_PROMPT
    if a.qk_norm:
        raise AssertionError("band: scaling wq and wk reaches the cap only without qk-norm")
    for name in ("wq", "wk"):
        model["layers"]["attn"][name].mul_(SOFTCAP_QK_SCALE)
    for c in counters:
        c.launches = 0
    lc, caches = prefill(cap, prompt[:, :Sc], None, SOFTCAP_DECODE)
    tokens = [torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)]
    steps = []
    for _ in range(SOFTCAP_DECODE):
        t1 = time.perf_counter()
        logits, caches = tfm.decode_step(model, cap, tokens[-1], caches)
        tokens.append(torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32))
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t1) * 1e3, logits))
    cap_launches = {c.__name__: c.launches for c in counters}
    if cap_launches["flash_attention"]:
        raise AssertionError(f"band: softcap layers launched flash_attention "
                             f"{cap_launches['flash_attention']} times")
    seq = torch.cat([prompt[:, :Sc]] + tokens[:-1], dim=1)
    errs = []
    for i, (_ms, logits) in enumerate(steps):
        tf, _ = prefill(cap, seq[:, :Sc + i + 1], False)
        errs.append(float((logits.float() - tf.float()).abs().max()))
    blocked = cap.with_runtime(dense_attn_threshold=512, attn_block_k=512)
    tfb, _ = prefill(blocked, seq, False)
    cap_floor = float((tf.float() - tfb.float()).abs().max())
    cap_scale = float(tf.float().abs().max())
    cap_bound = max(2e-2 * cap_scale, ARCH_FLOOR_FACTOR * cap_floor)
    if not max(errs) <= cap_bound:
        raise AssertionError(f"band: softcap decode vs teacher forcing {errs} beyond "
                             f"{cap_bound:.4f} (max|logit| {cap_scale:.3f})")
    plain_logits, _ = prefill(base, seq, False)
    moved = float((tf.float() - plain_logits.float()).abs().max())
    if not moved > cap_bound:
        raise AssertionError(f"band: the cap moves the logits by {moved:.4f}, inside the "
                             f"decode bound {cap_bound:.4f}: the check cannot see a lost cap")
    del tfb, plain_logits
    cap_ms = {"softcap_plain": host_ms(lambda: prefill(cap, prompt[:, :Sc], None), 1),
              "uncapped_kernel": host_ms(lambda: prefill(base, prompt[:, :Sc], None), 1)}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[band] softcap {SOFTCAP} prefill {B} x {Sc} + {SOFTCAP_DECODE} decode steps: "
        f"flash_attention launches {cap_launches['flash_attention']} (softcap layers stay off "
        f"the kernel); decode vs teacher forcing max |diff| per step "
        f"{[round(e, 4) for e in errs]} (bound {cap_bound:.4f}: max|logit| {cap_scale:.3f}, "
        f"dense vs blocked teacher forcing {cap_floor:.4f}); wq, wk x {SOFTCAP_QK_SCALE}: "
        f"the cap moves the logits by {moved:.4f} (must exceed that bound); prefill "
        f"{B} x {Sc} ms: softcap (dense plain, off the kernel) {cap_ms['softcap_plain']:.1f}, "
        f"uncapped on the kernel {cap_ms['uncapped_kernel']:.1f}; decode ms "
        f"{[round(m, 2) for m, _ in steps]}; peak {peak:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del model, caches, steps, tf
    torch.cuda.empty_cache()
    return {"layers": BAND_LAYERS, "launches_per_prefill": launches["flash_attention"],
            "variant_launches": variants, "rel_err": rel_max, "logit_diff": diffs,
            "plain_floor": floor, "prefill_ms": times, "shape": shape,
            "softcap": {"launches": cap_launches["flash_attention"], "decode_vs_tf": errs,
                        "bound": cap_bound, "cap_moves": moved, "prefill_ms": cap_ms}}


# ---------------------------------------------------------------------------
# libs: the Table, Image and NLP integrations on the card (ROADMAP A9)
# ---------------------------------------------------------------------------


def on_card(what: str, value) -> list:
    """Every tensor leaf of a result (a Table's columns, a Corpus) on the
    card; returns the leaves' (dtype, device)."""
    leaves = [l for l in pytree.tree_leaves(value) if isinstance(l, torch.Tensor)]
    if not leaves or any(l.device.type != "cuda" for l in leaves):
        raise AssertionError(f"libs: {what} off the card: {[l.device for l in leaves]}")
    return sorted({(str(l.dtype).replace("torch.", ""), str(l.device)) for l in leaves})


def libs_cases(w, nlp):
    """(name, pipeline, args) of each library workload, data drawn from
    seeded numpy generators (fig4's) and moved to the card."""
    r = np.random.RandomState(0)
    corpus = nlp.make_corpus(LIBS_DOCS, LIBS_TOKENS, LIBS_VOCAB, seed=0, device=DEVICE)
    emb = torch.from_numpy(r.randn(LIBS_VOCAB, LIBS_DIM).astype(np.float32)).to(DEVICE)
    head = torch.from_numpy(r.randn(LIBS_DIM, LIBS_TAGS).astype(np.float32)).to(DEVICE)

    def tagger(c, emb, head):
        folded = nlp.normalize_case(c, LIBS_VOCAB)
        return nlp.pos_tag(folded, emb, head), nlp.token_counts(folded)

    im = w.image(*LIBS_IMAGE, seed=0, device=DEVICE)
    return [("crime_index", w.crime_index, (w.crime_table(LIBS_ROWS, device=DEVICE),)),
            ("data_cleaning", w.data_cleaning, (w.cleaning_table(LIBS_ROWS, device=DEVICE),)),
            ("birth_analysis", w.birth_analysis, (w.birth_table(LIBS_ROWS, device=DEVICE),)),
            ("movielens", w.movielens,
             w.movielens_tables(LIBS_ROWS, LIBS_MOVIES, device=DEVICE)),
            ("nashville", w.nashville, (im,)), ("gotham", w.gotham, (im,)),
            ("tagger", tagger, (corpus, emb, head))]


def libs_check(name: str, got: list, eager: list, args, w, tb, nlp) -> str:
    """A library workload's results against its oracle: the numpy oracles
    (crime_index_np, data_cleaning_np), ``_group_reduce`` of the whole
    table on the card and a float64 ``np.bincount`` (birth_analysis,
    movielens), the ``eager`` run (images; tags, where a mismatch must be a
    near-tie of the tag logits); returns what was checked."""
    if name == "crime_index":
        want = w.crime_index_np(args[0])
        if not math.isclose(float(got[0]), want, rel_tol=1e-5):
            raise AssertionError(f"libs/crime_index: {float(got[0])} vs oracle {want}")
        return f"{float(got[0]):.6g} vs numpy {want:.6g}"
    if name == "data_cleaning":
        want = w.data_cleaning_np(args[0])
        if float(got[0]) != want[0] or not math.isclose(float(got[1]), want[1], rel_tol=1e-5):
            raise AssertionError(f"libs/data_cleaning: {[float(g) for g in got]} vs {want}")
        return f"valid {float(got[0]):.0f}, total {float(got[1]):.6g} vs numpy {want[1]:.6g}"
    if name in ("birth_analysis", "movielens"):
        res = got[0]
        if name == "movielens":
            res = tb.finalize_mean(res, "movie")
            key, col, vals, t = "movie", "mean", "rating", args[0]
        else:
            key, col, vals, t = "year", "sum", "births", args[0]
        keys = t.cols[key].cpu().numpy()
        uniq, inv = np.unique(keys, return_inverse=True)
        sums = np.bincount(inv, weights=t.cols[vals].cpu().numpy())
        want = sums / np.bincount(inv) if name == "movielens" else sums
        if not (np.array_equal(res.cols[key].cpu().numpy(), uniq)
                and np.allclose(res.cols[col].cpu().numpy(), want, rtol=1e-9, atol=0)):
            raise AssertionError(f"libs/{name}: groups differ from the float64 oracle")
        whole = tb._group_reduce(t if name == "birth_analysis" else tb._join_inner(
            args[0], args[1], "movie"), key, vals, "sum" if name == "birth_analysis" else "mean")
        if name == "movielens":
            whole = tb.finalize_mean(whole, "movie")
        compare(f"libs/{name} vs _group_reduce", res.cols[col], whole.cols[col], 1e-9,
                atol_scale=0.0)
        return f"{len(uniq)} groups equal to np.bincount (float64) and _group_reduce"
    if name in ("nashville", "gotham"):
        compare(f"libs/{name} vs eager", got[0], eager[0], TOL[torch.float32])
        return "equal to eager"
    tags, count = got
    c, emb, head = args
    if int(count) != int(eager[1]) or int(count) != int(c.lengths.sum()):
        raise AssertionError(f"libs/tagger: token count {int(count)} vs {int(eager[1])}")
    bad = torch.nonzero(tags != eager[0])
    if len(bad):
        folded = nlp._normalize_case(c, LIBS_VOCAB).tokens[bad[:, 0], bad[:, 1]]
        logits = emb[folded] @ head
        top = torch.topk(logits, 2, dim=-1).values
        margin = float((top[:, 0] - top[:, 1]).max())
        if margin > 1e-4 * float(logits.abs().max()):
            raise AssertionError(f"libs/tagger: {len(bad)} tags differ from eager, top-2 "
                                 f"margin up to {margin}")
    return f"tags equal to eager but {len(bad)} near-ties; {int(count)} tokens"


def phase_libs() -> dict:
    """The Table, Image and NLP integrations on the card: each workload on
    ``eager``, ``pipelined`` and ``cuda`` (plan cache on, tuner off: a cold
    then a warm session, host clock), every result on the card and equal to
    its oracle (``libs_check``); ``cuda`` runs every stage on ``fused``
    (``cuda_fallback_stages`` = ``LIBS_STAGES``, as the CPU tests hold: the
    reference's ``pallas`` lowering refuses every such stage)."""
    from repro_torch import workloads as w
    from repro_torch.core import annotated_nlp as nlp
    from repro_torch.core import annotated_table as tb
    from repro_torch.core import mozart
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cases = libs_cases(w, nlp)
    torch.cuda.synchronize()
    log(f"[libs] data: tables of {LIBS_ROWS} rows (int64/float64 columns, movielens "
        f"{LIBS_MOVIES} movies), images {LIBS_IMAGE[0]} x {LIBS_IMAGE[1]} x 3 float32, a corpus "
        f"of {LIBS_DOCS} x {LIBS_TOKENS} tokens (vocab {LIBS_VOCAB}, d {LIBS_DIM}, "
        f"{LIBS_TAGS} tags), made in {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, fn, args in cases:
        row, eager = {}, None
        for ex in LIBS_EXECUTORS:
            ms = []
            for _ in range(2):                              # cold, then a plan-cache hit
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with mozart.session(executor=ex, autotune=False) as ctx:
                    res = fn(*args)
                    res = res if isinstance(res, tuple) else (res,)
                    got = [r.value for r in res]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            st = {k: int(ctx.stats.get(k, 0)) for k in ("stages", "chunks",
                                                         "cuda_fallback_stages",
                                                         "cuda_stages", "rewrites_applied")}
            want_fb = LIBS_STAGES[name] if ex == "cuda" else 0
            if st["stages"] != LIBS_STAGES[name] or st["cuda_fallback_stages"] != want_fb \
                    or st["cuda_stages"]:
                raise AssertionError(f"libs/{name} on {ex}: {st}; the CPU tests hold "
                                     f"{LIBS_STAGES[name]} stages, all of them falling back "
                                     f"on cuda")
            leaves = [on_card(f"{name} on {ex} output {i}", g) for i, g in enumerate(got)]
            if ex == "eager":
                eager = got
            checked = libs_check(name, got, eager, args, w, tb, nlp)
            row[ex] = {"cold_ms": ms[0], "warm_ms": ms[1], **st}
            log(f"[libs] {name} on {ex}: cold {ms[0]:.1f} ms, warm {ms[1]:.1f} ms; stages "
                f"{st['stages']}, chunks {st['chunks']}, cuda_fallback_stages "
                f"{st['cuda_fallback_stages']}, rewrites_applied {st['rewrites_applied']}; "
                f"results {leaves}; {checked}")
        out[name] = row
        resilience_clean(f"libs/{name}")
    del cases
    torch.cuda.empty_cache()
    log(f"[libs] phase {time.perf_counter() - t_phase:.1f} s")
    return out



# ---------------------------------------------------------------------------
# verify: the annotation linter and dataflow analyzer on the card (A10.1),
# and the NaN-key and out-of-range-id repairs (C11, C12)
# ---------------------------------------------------------------------------

#: the verify phase: the sweep's probe size (the reference's default); five
#: calls of each warm ``Pipeline.verify``; a table of 2**22 float64 keys
#: 0-9,999 (-0.0 beside 0.0, 10% NaN) for C11; 2**12 documents of 64 ids
#: around the libs phase's vocabulary for C12
VERIFY_N, VERIFY_WARM_CALLS = 12, 5
VERIFY_ROWS, VERIFY_KEYS, VERIFY_DOCS = 1 << 22, 10_000, 1 << 12
#: (pipeline options, ``verify_handoff_reused`` per warm call), in this
#: order: an entry's decisions describe the verifier's unrewritten plan only
#: where the entry is keyed by that graph (Haversine: MZ505 declines only;
#: Black-Scholes' MZ502 rewrites its graph, so the verifier re-analyzes, as
#: the reference does, until a ``rewrite=False`` pipeline caches the
#: unrewritten graph)
VERIFY_WARM = {"black_scholes": (({}, 0), ({"rewrite": False}, 1)),
               "haversine": (({}, 1),)}
GROUP_OPS = ("sum", "count", "mean", "max", "min")


def tensor_devices(value) -> list:
    return [l.device.type for l in pytree.tree_leaves(value) if isinstance(l, torch.Tensor)]


def diag_multiset(rep) -> collections.Counter:
    return collections.Counter((d.code, d.severity, d.subject) for d in rep.diagnostics)


@contextlib.contextmanager
def watched_devices():
    """Count the device of every tensor of every probe the sweep builds
    (``analysis.builtin_probes``) and of every annotated op's output it
    computes (``AnnotatedFn.call_raw``, the bare calls MZ108 makes)."""
    from repro_torch.core import analysis
    from repro_torch.core.annotation import AnnotatedFn
    seen = {"probes": collections.Counter(), "outputs": collections.Counter(), "calls": 0}
    probes, raw = analysis.builtin_probes, AnnotatedFn.call_raw

    def watched_probes(*a, **k):
        out = probes(*a, **k)
        for p in out:
            seen["probes"].update(tensor_devices([p.value, p.pieces, p.reference]))
        return out

    def watched_raw(self, bound):
        out = raw(self, bound)
        seen["calls"] += 1
        seen["outputs"].update(tensor_devices(out) or ["no tensor"])
        return out

    analysis.builtin_probes, AnnotatedFn.call_raw = watched_probes, watched_raw
    try:
        yield seen
    finally:
        analysis.builtin_probes, AnnotatedFn.call_raw = probes, raw


def verify_sweep() -> dict:
    """(a) ``mozart.verify()`` on the card against the same sweep on the CPU,
    plan cache emptied first (its entries are subjects of MZ205)."""
    from repro_torch.core import mozart, plan_cache
    dropped = plan_cache.cache_info()["entries"]
    plan_cache.clear()
    with watched_devices() as seen:
        t0 = time.perf_counter()
        card = mozart.verify(n=VERIFY_N, device=DEVICE)
        card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = mozart.verify(n=VERIFY_N, device="cpu")
    host_s = time.perf_counter() - t0
    dev = torch.device(DEVICE).type
    if not card.ok or card.warnings:
        raise AssertionError(f"verify sweep on {DEVICE}:\n{card.render()}")
    if set(seen["probes"]) != {dev} or set(seen["outputs"]) != {dev}:
        raise AssertionError(f"verify sweep: probes on {dict(seen['probes'])}, op outputs "
                             f"on {dict(seen['outputs'])}, not all on {dev}")
    if card.checked != host.checked or diag_multiset(card) != diag_multiset(host):
        raise AssertionError(f"verify sweep: {card.checked} checked on {DEVICE} "
                             f"{sorted(diag_multiset(card).items())} vs {host.checked} on the "
                             f"CPU {sorted(diag_multiset(host).items())}")
    codes = collections.Counter(f"{d.code} {d.severity}" for d in card.diagnostics)
    log(f"[verify] sweep on {DEVICE} (n = {VERIFY_N}, {dropped} plan-cache entries dropped "
        f"first): {card.checked} checked, ok, {dict(codes)}; "
        f"{sum(seen['probes'].values())} probe tensors and {seen['calls']} op calls "
        f"({sum(seen['outputs'].values())} output tensors) all on {dev}; checked and "
        f"(code, severity, subject) multiset equal to the CPU sweep; {card_s:.2f} s on the "
        f"card, {host_s:.2f} s on the CPU")
    return {"checked": card.checked, "codes": dict(codes), "probe_tensors":
            sum(seen["probes"].values()), "op_calls": seen["calls"], "card_s": card_s,
            "cpu_s": host_s}


def verify_workload(sp, name: str, fn, args: tuple, oracle) -> dict:
    """(b) ``mozart.verify(fn, *args, executor="cuda")`` on the main path's
    data: no launch, no plan-cache entry, no device memory left; a ``cuda``
    session then launches once per stage the verifier walked, its rewrite
    records the verifier's MZ5xx codes, its outputs equal to the float64
    oracle on a prefix.  (c) a warm ``Pipeline.verify``: reuses the recorded
    handoff where ``VERIFY_WARM`` says, launches nothing."""
    from repro_torch.core import mozart, plan_cache
    torch.cuda.synchronize()
    before = (sp.split_pipeline.launches, plan_cache.cache_info()["entries"],
              torch.cuda.memory_allocated())
    t0 = time.perf_counter()
    rep = mozart.verify(fn, *args, executor="cuda", device=DEVICE)
    verify_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    after = (sp.split_pipeline.launches, plan_cache.cache_info()["entries"],
             torch.cuda.memory_allocated())
    if not rep.ok or after != before:
        raise AssertionError(f"verify {name}: ok {rep.ok}, (launches, plan-cache entries, "
                             f"bytes allocated) {before} -> {after}\n{rep.render(True)}")
    mz5 = sorted(d.code for d in rep.diagnostics if d.code.startswith("MZ5"))
    with mozart.session(executor="cuda", device=DEVICE) as ctx:
        got = [o.value for o in as_list(fn(*args))]
    torch.cuda.synchronize()
    launched = sp.split_pipeline.launches - before[0]
    stats = {k: int(ctx.stats.get(k, 0)) for k in ("stages", "cuda_stages",
                                                  "cuda_fallback_stages")}
    records = sorted(r.code for r in ctx._last_rewrites)
    if not (launched == stats["stages"] == stats["cuda_stages"] == rep.checked
            and stats["cuda_fallback_stages"] == 0 and records == mz5):
        raise AssertionError(f"verify {name}: {launched} launches, {stats}, {rep.checked} "
                             f"stages walked; records {records} vs reported {mz5}")
    for i, (g, (ref64, rtol, atol)) in enumerate(zip(got, oracle)):
        if not np.allclose(g[:ref64.shape[0]].double().cpu().numpy(), ref64, rtol=rtol,
                           atol=atol):
            raise AssertionError(f"verify {name}: session output {i} vs the float64 oracle")
    del got
    row = {"verify_ms": verify_ms, "stages": rep.checked, "codes": sorted(rep.codes()),
           "launches_after": launched}
    log(f"[verify] {name} at n = {args[0].numel()}: verify {verify_ms:.1f} ms, ok, codes "
        f"{sorted(rep.codes())}, {rep.checked} stage walked; launches, plan-cache entries and "
        f"bytes allocated unchanged {before}; then a cuda session: {launched} launch for "
        f"{stats['stages']} stage, rewrite records {records} = the reported MZ5xx, outputs "
        f"equal to the float64 oracle")
    for cfg, per_call in VERIFY_WARM[name]:
        p = mozart.pipeline(fn, executor="cuda", device=DEVICE, **cfg)
        p(*args)
        torch.cuda.synchronize()
        launches, entries = sp.split_pipeline.launches, plan_cache.cache_info()["entries"]
        reused = plan_cache.stats["verify_handoff_reused"]
        times = []
        for _ in range(VERIFY_WARM_CALLS):
            t0 = time.perf_counter()
            warm = p.verify(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        got_reused = plan_cache.stats["verify_handoff_reused"] - reused
        if not (warm.ok and got_reused == per_call * VERIFY_WARM_CALLS
                and sp.split_pipeline.launches == launches
                and plan_cache.cache_info()["entries"] == entries):
            raise AssertionError(f"warm Pipeline.verify on {name} {cfg}: ok {warm.ok}, "
                                 f"reused {got_reused}, launches {launches} -> "
                                 f"{sp.split_pipeline.launches}")
        label = "rewrite off" if cfg.get("rewrite") is False else "rewrite on"
        row[f"warm_verify_ms ({label})"] = statistics.median(times)
        row[f"handoff_reused ({label})"] = got_reused
        log(f"[verify] warm Pipeline.verify on {name} ({label}): median "
            f"{statistics.median(times):.2f} ms host over {VERIFY_WARM_CALLS} calls "
            f"({', '.join(f'{t:.2f}' for t in times)}), verify_handoff_reused "
            f"+{got_reused}, no launch, no new plan-cache entry, codes {sorted(warm.codes())}")
        del p, warm
    return row


def group_oracle(keys: np.ndarray, vals: np.ndarray, op: str) -> tuple:
    """numpy per group, every NaN key one group, last: (keys, values, counts)."""
    nan = np.isnan(keys)
    uniq, inv = np.unique(keys[~nan], return_inverse=True)
    v = vals[~nan]
    counts = np.bincount(inv, minlength=len(uniq))
    if op in ("sum", "mean", "count"):
        got = np.bincount(inv, weights=v, minlength=len(uniq)) if op != "count" else counts
        tail = vals[nan].sum() if op != "count" else nan.sum()
    else:
        got = np.full(len(uniq), -np.inf if op == "max" else np.inf)
        (np.maximum if op == "max" else np.minimum).at(got, inv, v)
        tail = vals[nan].max() if op == "max" else vals[nan].min()
    return (np.append(uniq, np.nan), np.append(got, tail).astype(np.float64),
            np.append(counts, nan.sum()))


def tags_agree(what: str, got: torch.Tensor, want: torch.Tensor, rows: np.ndarray,
               emb: torch.Tensor, head: torch.Tensor) -> int:
    """Tags equal but where the two best logits tie within 1e-4 of the
    largest (float32 sums in another order); returns the near-ties."""
    bad = torch.nonzero(got.cpu() != want.cpu())
    if len(bad):
        ids = torch.from_numpy(rows[bad[:, 0].numpy(), bad[:, 1].numpy()])
        logits = emb.cpu()[ids] @ head.cpu()
        top = torch.topk(logits, 2, dim=-1).values
        if float((top[:, 0] - top[:, 1]).max()) > 1e-4 * float(logits.abs().max()):
            raise AssertionError(f"{what}: {len(bad)} tags differ beyond near-ties")
    return len(bad)


def verify_repairs() -> dict:
    """(d) C11: ``groupby_agg`` of float64 keys with NaNs on the card (every
    op, ``cuda`` sessions: the stage runs on ``fused``) equal to the same on
    the CPU and to the numpy oracle: one NaN group, last.  C12: ``pos_tag``
    on ids [0, V-1, V, V+2, -1, -V-1] and random ids in [-2V, 2V) on the
    card, synchronised (no device assert), equal to the CPU and to the rows
    JAX's gather reads (a negative id wraps once, then every id clamps)."""
    from repro_torch.core import annotated_nlp as nlp
    from repro_torch.core import annotated_table as tb
    from repro_torch.core import mozart
    r = np.random.RandomState(0)
    keys = r.randint(0, VERIFY_KEYS, VERIFY_ROWS).astype(np.float64)
    keys[(keys == 0) & (r.rand(VERIFY_ROWS) < 0.5)] = -0.0
    keys[r.rand(VERIFY_ROWS) < 0.1] = np.nan
    vals = r.rand(VERIFY_ROWS)
    tables = {dev: tb.Table({"k": torch.from_numpy(keys).to(dev),
                             "v": torch.from_numpy(vals).to(dev)}) for dev in (DEVICE, "cpu")}
    out = {"groups": {}}
    for op in GROUP_OPS:
        res, ms = {}, {}
        for dev, t in tables.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mozart.session(executor="cuda", device=dev, autotune=False) as ctx:
                res[dev] = tb.groupby_agg(t, key="k", val="v", op=op).value
            torch.cuda.synchronize()
            ms[dev] = (time.perf_counter() - t0) * 1e3
            if not ctx.stats["cuda_fallback_stages"] == ctx.stats["stages"] == 1:
                raise AssertionError(f"C11 {op} on {dev}: {dict(ctx.stats)}")
        card, host = res[DEVICE], res["cpu"]
        on_card(f"C11 groupby_agg {op}", card)
        want_keys, want_vals, want_counts = group_oracle(keys, vals, op)
        got_keys = card.cols["k"].cpu().numpy()
        np.testing.assert_array_equal(got_keys, host.cols["k"].numpy())
        np.testing.assert_array_equal(got_keys, want_keys)
        got = card.cols[op].cpu().numpy()
        exact = op in ("count", "max", "min")
        np.testing.assert_allclose(got, host.cols[op].numpy(), rtol=0 if exact else 1e-9)
        np.testing.assert_allclose(got, want_vals, rtol=0 if exact else 1e-9)
        if op == "mean":
            np.testing.assert_array_equal(card.cols["_cnt"].cpu().numpy(), want_counts)
        out["groups"][op] = {"groups": int(len(got_keys)), "nan_rows": int(want_counts[-1]),
                             "card_ms": ms[DEVICE], "cpu_ms": ms["cpu"]}
        log(f"[verify] C11 groupby_agg {op} over {VERIFY_ROWS} float64 keys: "
            f"{len(got_keys)} groups, the NaN group last ({int(want_counts[-1])} rows), equal "
            f"to the CPU and to numpy; {ms[DEVICE]:.1f} ms on {DEVICE}, {ms['cpu']:.1f} ms "
            f"on the CPU")
    del tables, res, card, host
    v = LIBS_VOCAB
    edge = np.array([0, v - 1, v, v + 2, -1, -v - 1], np.int64)
    toks = r.randint(-2 * v, 2 * v, (VERIFY_DOCS, LIBS_TOKENS))
    toks[:, :len(edge)] = edge
    lengths = r.randint(len(edge), LIBS_TOKENS + 1, VERIFY_DOCS)
    emb = torch.from_numpy(r.randn(v, LIBS_DIM).astype(np.float32))
    head = torch.from_numpy(r.randn(LIBS_DIM, LIBS_TAGS).astype(np.float32))
    rows = np.clip(np.where(toks < 0, toks + v, toks), 0, v - 1)
    tags = {}
    for dev in (DEVICE, "cpu"):
        corpus = nlp.Corpus(torch.from_numpy(toks.astype(np.int32)).to(dev),
                            torch.from_numpy(lengths.astype(np.int32)).to(dev))
        with mozart.session(executor="cuda", device=dev, autotune=False):
            tags[dev] = nlp.pos_tag(corpus, emb.to(dev), head.to(dev)).value
        torch.cuda.synchronize()                 # a device assert would surface here
    on_card("C12 pos_tag", tags[DEVICE])
    want = torch.argmax(emb[torch.from_numpy(rows)] @ head, dim=-1).to(torch.int32)
    want = torch.where(torch.arange(LIBS_TOKENS)[None] < torch.from_numpy(lengths)[:, None],
                       want, -1)
    ties = tags_agree("C12 card vs CPU", tags[DEVICE], tags["cpu"], rows, emb, head)
    oracle_ties = tags_agree("C12 card vs the gathered rows", tags[DEVICE], want, rows, emb,
                             head)
    out["pos_tag"] = {"tokens": int(toks.size), "out_of_range": int(((toks < 0) | (toks >= v))
                                                                     .sum()),
                      "near_ties_vs_cpu": ties, "near_ties_vs_rows": oracle_ties}
    log(f"[verify] C12 pos_tag over {VERIFY_DOCS} x {LIBS_TOKENS} ids (vocab {v}, "
        f"{out['pos_tag']['out_of_range']} out of range, {edge.tolist()} in every document) "
        f"on {DEVICE}: no device assert, tags equal to the CPU ({ties} near-ties) and to the "
        f"rows JAX's gather reads ({oracle_ties} near-ties)")
    return out


def phase_verify(sp) -> dict:
    """The annotation linter and dataflow analyzer on the card (ROADMAP
    A10.1): the sweep (``verify_sweep``), ``mozart.verify`` and a warm
    ``Pipeline.verify`` on the main path's Black-Scholes and Haversine at
    n = 2**27 (``verify_workload``), then the C11 and C12 repairs
    (``verify_repairs``)."""
    from scipy.special import erf
    from repro_torch import workloads as w
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"sweep": verify_sweep()}
    for name, fn, make in (("black_scholes", w.black_scholes, w.black_scholes_data),
                           ("haversine", w.haversine, w.haversine_data)):
        data = make(N_MAIN, seed=0, device=DEVICE)
        pre = {k: v[:PREFIX] for k, v in data.items()}
        oracle = ([(a, 2e-3, 1e-3) for a in w.black_scholes_np(pre, erf=erf)]
                  if name == "black_scholes" else [(w.haversine_np(**pre), 2e-3, 1e-2)])
        out[name] = verify_workload(sp, name, fn, tuple(data.values()), oracle)
        del data, pre
        torch.cuda.empty_cache()
    out.update(verify_repairs())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[verify] phase {out['seconds']:.1f} s")
    return out

LINT_ROUNDS = 10                 # timed Black-Scholes evaluations per sanitizer setting
SANITIZE_BATCH = 1 << 20         # the MZ301 case: a scan carry of 128 rows, no tail


@contextlib.contextmanager
def sanitizer(on: bool):
    """``MOZART_SANITIZE`` set to 1 or 0 for the block, then restored."""
    prev = os.environ.get("MOZART_SANITIZE")
    os.environ["MOZART_SANITIZE"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MOZART_SANITIZE", None)
        else:
            os.environ["MOZART_SANITIZE"] = prev


@contextlib.contextmanager
def expect_trip(code: str, what: str):
    """The block must raise a ``SanitizerError`` carrying ``code``."""
    from repro_torch.core.stage_exec import SanitizerError
    try:
        yield
    except SanitizerError as e:
        if f"[{code}]" not in str(e):
            raise AssertionError(f"{what}: {code} expected, got {e}") from e
        log(f"[lint] {what}: {code} raised on {DEVICE}: {str(e)[:160]}")
        return
    raise AssertionError(f"{what}: no {code} raised")


def lint_runs() -> dict:
    """(a) ``python -m repro_torch.launch.lint`` on the card (exit 0, every
    probe and op output on the card) against ``--device cpu`` in the same
    process: the same checked count and (code, severity, subject)
    multiset."""
    from repro_torch.core import plan_cache
    from repro_torch.launch import lint
    plan_cache.clear()                  # live entries are subjects of MZ205
    out = {}
    paths = {d: ROOT / "build" / f"lint_{d}.json" for d in (DEVICE, "cpu")}
    paths[DEVICE].parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device(DEVICE).type
    for device in (DEVICE, "cpu"):
        argv = ["--json", str(paths[device])] + (["--device", device] if device != DEVICE else [])
        with watched_devices() as seen, contextlib.redirect_stdout(None):
            t0 = time.perf_counter()
            rc = lint.main(argv)
            secs = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"lint {argv} exited {rc}: {paths[device].read_text()}")
        if device == DEVICE and (set(seen["probes"]) != {dev} or set(seen["outputs"]) != {dev}):
            raise AssertionError(f"lint: probes on {dict(seen['probes'])}, op outputs on "
                                 f"{dict(seen['outputs'])}, not all on {dev}")
        rep = json.loads(paths[device].read_text())
        out[device] = {"checked": rep["checked"], "seconds": secs,
                       "codes": collections.Counter(f"{d['code']} {d['severity']}"
                                                    for d in rep["diagnostics"]),
                       "subjects": collections.Counter((d["code"], d["severity"], d["subject"])
                                                       for d in rep["diagnostics"])}
    card, host = out[DEVICE], out["cpu"]
    if card["checked"] != host["checked"] or card["subjects"] != host["subjects"]:
        raise AssertionError(f"lint on {DEVICE}: {card['checked']} checked "
                             f"{sorted(card['subjects'].items())} vs the CPU's {host['checked']} "
                             f"{sorted(host['subjects'].items())}")
    log(f"[lint] python -m repro_torch.launch.lint on {DEVICE}: exit 0, {card['checked']} "
        f"checked, {dict(card['codes'])}, every probe and op output on {dev}; equal to "
        f"--device cpu ({host['checked']} checked, the same (code, severity, subject) "
        f"multiset); {card['seconds']:.2f} s on the card, {host['seconds']:.2f} s on the CPU "
        f"({card_line()})")
    return {"checked": card["checked"], "codes": dict(card["codes"]),
            "card_s": card["seconds"], "cpu_s": host["seconds"]}


def sanitized_chains(sp) -> dict:
    """(b) The handoff chain at n = 2**27, handoff on, on ``fused``,
    ``scan`` and ``cuda`` with ``MOZART_SANITIZE=1``: outputs bit-equal to
    the unsanitized run, the same counters and the same split-pipeline
    launches, every released stream poisoned (one zero-byte donate event
    each), no trip."""
    x = torch.linspace(0.0, 1.0, N_MAIN, device=DEVICE)
    out = {}
    for ex in ("fused", "scan", "cuda"):
        with sanitizer(False):
            for _warm in range(2):      # plan (miss), then the first hit tunes
                handoff_chain(x, ex, True)
        runs = {}
        for on in (False, True):
            with sanitizer(on):
                before = sp.split_pipeline.launches
                got, ctx = handoff_chain(x, ex, True)
                runs[on] = (got, dict(ctx.stats), sp.split_pipeline.launches - before,
                            [e for e in ctx.counters.materialize_events()
                             if e[0] == "interior:donate"])
        (off_v, off_st, off_l, off_d), (on_v, on_st, on_l, on_d) = runs[False], runs[True]
        if not torch.equal(on_v, off_v):
            raise AssertionError(f"sanitized {ex}: outputs differ from the unsanitized run")
        if on_st != off_st or on_l != off_l:
            raise AssertionError(f"sanitized {ex}: stats {on_st} launches {on_l} vs "
                                 f"{off_st} / {off_l}")
        if ex == "cuda" and on_l != 2:
            raise AssertionError(f"sanitized cuda: {on_l} split-pipeline launches, not 2")
        if on_st.get("stream_ingests", 0) == 0 or \
                (ex != "cuda" and on_st.get("streams_released", 0) == 0):
            raise AssertionError(f"sanitized {ex}: no stream checked or released: {on_st}")
        if off_d or len(on_d) != on_st.get("streams_released", 0):
            raise AssertionError(f"sanitized {ex}: donate events {on_d} / {off_d} for "
                                 f"{on_st.get('streams_released', 0)} released streams")
        out[ex] = {"launches": on_l, "streams_released": on_st.get("streams_released", 0),
                   "stream_ingests": on_st.get("stream_ingests", 0)}
        log(f"[lint] sanitized handoff chain on {ex} (n = {N_MAIN}): outputs bit-equal to "
            f"the unsanitized run, stats equal, split-pipeline launches {on_l} (unsanitized "
            f"{off_l}), {on_st.get('stream_ingests', 0)} stream ingests checked (MZ302), "
            f"{len(on_d)} released streams poisoned (MZ301), no trip")
        del off_v, on_v, runs
    del x
    torch.cuda.empty_cache()
    return out


def sanitizer_trips(sp) -> dict:
    """(c) Each code raised with card tensors, none demoted: MZ301 on a scan
    carry a real ``cuda`` launch released, read again; MZ302 on a holed
    stream at a ``cuda`` stage's ingest (under the degradation ladder: no
    demotion, no MZ402, no launch); MZ303 on a session's corrupted counter
    scope."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import executor as ex_mod
    from repro_torch.core import mozart, resilience
    from repro_torch.core import stage_exec as se
    x = torch.linspace(0.0, 1.0, N_MAIN, device=DEVICE)
    out = {}
    with sanitizer(True):
        before = sp.split_pipeline.launches
        with mozart.session(executor="scan", batch_elements=SANITIZE_BATCH,
                            device=DEVICE) as ctx:
            a = anp.multiply(anp.add(x, 1.0), 0.5)
            mozart.evaluate()
            stream = a._node.result
            mozart.configure(executor="cuda")
            b = anp.add(a, 1.0)
            del a
            mozart.evaluate()
            launched = sp.split_pipeline.launches - before
            if launched != 1 or ctx.stats.get("cuda_ingest_carry", 0) != 1 \
                    or not stream.consumed:
                raise AssertionError(f"MZ301 case: {launched} launches, {dict(ctx.stats)}")
            with expect_trip("MZ301", "a scan carry released by a cuda launch, read again"):
                stream.materialize()
            compare("MZ301 case: the consumer's output", b.value[:PREFIX],
                    x[:PREFIX] * 0.5 + 1.5, 2e-5)
            del b, stream
        out["MZ301"] = {"launches": launched, "released": ctx.stats["streams_released"]}

        real = se.finish_stage

        def holed(stage, partials, ranges=None, ctx=None):
            real(stage, partials, ranges, ctx)
            for node in stage.nodes:
                if isinstance(node.result, se.ChunkStream):
                    s1, e1 = node.result.ranges[1]
                    node.result.ranges[1] = (s1 + 1, e1)
        ex_mod.finish_stage = holed
        before = sp.split_pipeline.launches
        try:
            with expect_trip("MZ302", "a holed stream at a cuda stage's ingest"):
                with mozart.session(executor="fused", batch_elements=SANITIZE_BATCH,
                                    device=DEVICE) as ctx:
                    a = anp.multiply(anp.add(x, 1.0), 0.5)
                    mozart.evaluate()
                    mozart.configure(executor="cuda")
                    b = anp.add(a, 1.0)
                    del a
                    b.value
        finally:
            ex_mod.finish_stage = real
        demoted = ctx.stats.get("exec_demotions", 0), int(resilience.stats.get("MZ402", 0))
        if demoted != (0, 0) or sp.split_pipeline.launches != before:
            raise AssertionError(f"MZ302 case: (demotions, MZ402) {demoted}, launches "
                                 f"{sp.split_pipeline.launches - before}")
        out["MZ302"] = {"demotions": demoted[0], "MZ402": demoted[1]}

        with mozart.session(executor="cuda", device=DEVICE) as ctx:
            y = anp.multiply(x, 2.0)
            with expect_trip("MZ303", "a session's counter scope bumped with no event"):
                with se.counter_scope(ctx.counters):
                    ctx.counters.interior += int(x.nbytes)
            y.value
        out["MZ303"] = {"scope_interior": ctx.counters.interior}
    del x
    torch.cuda.empty_cache()
    return out


def sanitizer_cost(w) -> dict:
    """(d) Host ms of a warm ``cuda`` Black-Scholes evaluation at 2**27 with
    the sanitizer on and off, in turns (off, on, on, off, ...)."""
    from repro_torch.core import mozart
    data = w.black_scholes_data(N_MAIN, seed=0, device=DEVICE)

    def once():
        with mozart.session(executor="cuda", device=DEVICE):
            call, put = w.black_scholes(**data)
            call.value, put.value

    for on in (False, True):
        with sanitizer(on):
            once(), once()
    times = {False: [], True: []}
    for r in range(LINT_ROUNDS):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            with sanitizer(on):
                times[on].append(timed_ms(once))
    (off, off_q1, off_q3), (on, on_q1, on_q3) = quartiles(times[False]), quartiles(times[True])
    log(f"[lint] warm cuda Black-Scholes at n = {N_MAIN}: sanitizer off {off:.3f} ms "
        f"(quartiles {off_q1:.3f}-{off_q3:.3f}), on {on:.3f} ms ({on_q1:.3f}-{on_q3:.3f}) "
        f"(host clock, medians of {LINT_ROUNDS} in turns; {card_line()})")
    del data
    torch.cuda.empty_cache()
    return {"off_ms": off, "on_ms": on, "off_quartiles": [off_q1, off_q3],
            "on_quartiles": [on_q1, on_q3]}


def roofline_lines(train: dict, serve: dict) -> dict:
    """(e) ``model_flops`` of the train phase's gemma-7b step (8 layers,
    2 x 2048) and of the serve phase's 28-layer 4 x 2048 prefill, with
    ``roofline_terms`` on ``chip_for("cuda")`` (memory term: the weights read
    once) beside the times those phases measured.  Printed, not gated."""
    from repro_torch import hardware
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import roofline
    from repro_torch.models.config import active_param_count, param_count
    chip = hardware.chip_for(DEVICE)
    cells = (("train step", train_config(), ShapeSpec("gemma_train", "train", TRAIN_SEQ,
                                                      TRAIN_BATCH),
              statistics.median(train["step_ms"][1:])),
             ("prefill", serve_config(), ShapeSpec("gemma_prefill", "prefill", SERVE_PROMPT,
                                                   SERVE_BATCH), serve["prefill_ms"]))
    out = {}
    for what, cfg, shape, measured in cells:
        flops = roofline.model_flops(cfg, shape, 1)
        weight_bytes = param_count(cfg) * cfg.dtype.itemsize
        terms = roofline.roofline_terms(flops, weight_bytes, 0.0, chip)
        out[what] = {"n_layers": cfg.n_layers, "batch": shape.global_batch,
                     "seq": shape.seq_len, "active_params": active_param_count(cfg),
                     "model_flops": flops, "weight_bytes": weight_bytes,
                     **{k: v * 1e3 for k, v in terms.items()}, "measured_ms": measured,
                     "model_flops_share": terms["compute_s"] * 1e3 / measured}
        log(f"[lint] roofline {cfg.name} {what} ({cfg.n_layers} layers, {shape.global_batch} x "
            f"{shape.seq_len}): model_flops {flops:.4e} ({'6' if shape.kind == 'train' else '2'}"
            f" x {active_param_count(cfg)} active parameters x {shape.global_batch * shape.seq_len}"
            f" tokens); on {chip.name}: compute {terms['compute_s'] * 1e3:.3f} ms, memory "
            f"(weights once) {terms['memory_s'] * 1e3:.3f} ms, collective "
            f"{terms['collective_s'] * 1e3:.3f} ms; measured {measured:.1f} ms, so "
            f"{out[what]['model_flops_share']:.1%} of the bf16 peak ({card_line()})")
    return out


def phase_lint(sp, train: dict, serve: dict) -> dict:
    """The checking layer's runtime half (ROADMAP A10.2) and the analytic
    roofline (A11) on the card: ``launch/lint.py`` (``lint_runs``), a clean
    sanitized run (``sanitized_chains``), each MZ30x code raised
    (``sanitizer_trips``), the sanitizer's host cost (``sanitizer_cost``) and
    the roofline lines (``roofline_lines``)."""
    from repro_torch import workloads as w
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"lint": lint_runs(), "sanitized": sanitized_chains(sp),
           "trips": sanitizer_trips(sp), "cost": sanitizer_cost(w),
           "roofline": roofline_lines(train, serve)}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[lint] phase {out['seconds']:.1f} s")
    return out


def run_observed(fn, data, executor: str, **kw):
    """One session evaluation: (each output's result before observation,
    the observed values, the context)."""
    from repro_torch.core import mozart
    with mozart.session(executor=executor, **kw) as ctx:
        outs = as_list(fn(**data))
        mozart.evaluate()
        raw = [o._node.result for o in outs]
        got = [o.value for o in outs]
    torch.cuda.synchronize()
    return raw, got, ctx


def sharded_workloads(w, erf, mesh) -> dict:
    """(a) Black-Scholes and Haversine at n = 2**27 on ``sharded``: card
    DTensors laid out Shard(0) with the whole (2**27,) local, equal to
    ``fused`` at the same batch and to the float64 oracle on the prefix."""
    from torch.distributed.tensor import DTensor, Shard
    out = {}
    for name, fn, data in (("black_scholes", w.black_scholes,
                            w.black_scholes_data(N_MAIN, seed=0, device="cuda")),
                           ("haversine", w.haversine,
                            w.haversine_data(N_MAIN, seed=0, device="cuda"))):
        pre = {k: v[:PREFIX] for k, v in data.items()}
        oracle = ([(o, 2e-3, 1e-3) for o in w.black_scholes_np(pre, erf=erf)]
                  if name == "black_scholes" else [(w.haversine_np(**pre), 2e-3, 1e-2)])
        raw, got, ctx = run_observed(fn, data, "sharded", mesh=mesh,
                                     batch_elements=SHARDED_BATCH)
        _r, want, fctx = run_observed(fn, data, "fused", batch_elements=SHARDED_BATCH)
        st = dict(ctx.stats)
        if st.get("sharded_stages", 0) != st.get("stages", -1) or not st["stages"]:
            raise AssertionError(f"sharded/{name}: not every stage sharded: {st}")
        errs = []
        for i, (r, g, wv, (ref64, rtol, atol)) in enumerate(zip(raw, got, want, oracle)):
            if not (isinstance(r, DTensor) and r.placements[0] == Shard(0)
                    and r.device_mesh == mesh and r.to_local().is_cuda
                    and tuple(r.to_local().shape) == (N_MAIN,)):
                raise AssertionError(f"sharded/{name} output {i}: {type(r).__name__} "
                                     f"{getattr(r, 'placements', None)}")
            if g.shape != wv.shape or g.dtype != wv.dtype \
                    or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"sharded/{name} output {i}: {g.shape}/{g.dtype}")
            errs.append(compare(f"sharded/{name} output {i} vs fused", g, wv, 2e-5,
                                atol=1e-2 if name == "haversine" else 0.0))
            if not np.allclose(g[:PREFIX].double().cpu().numpy(), ref64, rtol=rtol,
                               atol=atol):
                raise AssertionError(f"sharded/{name} output {i}: float64 oracle mismatch")
        out[name] = {"stats": st, "max_abs_err_vs_fused": max(errs)}
        log(f"[sharded] {name} n={N_MAIN} on a one-rank NCCL mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names}: every output a card DTensor "
            f"{[str(p) for p in raw[0].placements]}, local {(N_MAIN,)}; max |sharded - "
            f"fused| {max(errs):.3e} (batch {SHARDED_BATCH} on both); matches the float64 "
            f"oracle; stats {st}; fused stats {dict(fctx.stats)}")
        del raw, got, want, data, pre
    return out


#: the sharded phase's reductions: every (op, input dtype) pair of the CPU
#: tests (``tests/sharded_scenarios.py`` ``REDUCE_CASES``), uint16 and
#: uint32 max and min included (ROADMAP C13)
SHARDED_REDUCE_DTYPES = (torch.float32, torch.int32, torch.bool, torch.bfloat16, torch.int8,
                         torch.int16, torch.uint8, torch.uint16, torch.uint32, torch.float16)
SHARDED_REDUCE_CASES = tuple((name, dtype) for dtype in SHARDED_REDUCE_DTYPES
                             for name in ("sum", "max", "min", "prod"))


def reduce_case(dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    """Seeded card inputs whose products stay finite and exact (within 32
    bits unsigned), as the CPU tests' ``reduce_input``: float32 and
    bfloat16 near 1, signed integers and float16 in {-1, 1} with five 2s
    (float16 also five halves), unsigned ones 1 with twenty 2s and five 3s,
    random bools."""
    n = SHARDED_REDUCE_N
    if dtype == torch.bool:
        return torch.rand(n, generator=gen, device="cuda") < 0.5
    if dtype in (torch.int8, torch.int16, torch.int32, torch.float16):
        x = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, -1, 1)
        x = x.to(dtype)
        x[torch.randint(0, n, (5,), generator=gen, device="cuda")] = 2
        if dtype == torch.float16:
            x[torch.randint(0, n, (5,), generator=gen, device="cuda")] = 0.5
        return x
    if dtype in (torch.uint8, torch.uint16, torch.uint32):
        x = torch.ones(n, dtype=torch.int32, device="cuda")
        x[torch.randint(0, n, (20,), generator=gen, device="cuda")] = 2
        x[torch.randint(0, n, (5,), generator=gen, device="cuda")] = 3
        return x.to(dtype)
    x = 1.0 + (torch.rand(n, generator=gen, device="cuda") - 0.5) * 1e-3
    return x.to(dtype)


def sharded_reductions(mesh) -> dict:
    """(b) sum, max, min and prod (ReduceSplit add, max, min, mul) of every
    input dtype of the CPU tests: each partial combined by the NCCL group's
    collective (all-reduce; all-gather then a fold for mul; int16, uint16
    and uint32 partials widened on the wire, bools as bytes), equal to
    ``fused`` (integers, bools and the exact float16 cases exactly)."""
    import torch.distributed as dist
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core.sharded import data_group
    group, _order = data_group(mesh, (0,))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    out = {}
    inputs = {}
    for name, dtype in SHARDED_REDUCE_CASES:
        if dtype not in inputs:
            inputs = {dtype: reduce_case(dtype, gen)}
        x = inputs[dtype]
        fn = lambda x: getattr(anp, name)(x)
        _r, (got,), ctx = run_observed(fn, {"x": x}, "sharded", mesh=mesh,
                                       batch_elements=SHARDED_REDUCE_N // 8)
        _r, (want,), _c = run_observed(fn, {"x": x}, "fused",
                                       batch_elements=SHARDED_REDUCE_N // 8)
        what = f"sharded/{name}({str(dtype)[6:]})"
        if got.dtype != want.dtype or not got.is_cuda or ctx.stats["sharded_stages"] != 1:
            raise AssertionError(f"{what}: {got.dtype} vs {want.dtype}, {dict(ctx.stats)}")
        if not got.dtype.is_floating_point or dtype == torch.float16:
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: {got.item()} != fused {want.item()}")
            err = 0.0
        else:
            err = compare(what, got.float(), want.float(),
                          2e-2 if dtype == torch.bfloat16 else 2e-5)
        out[f"{name}/{str(dtype)[6:]}"] = {"value": float(got.double()), "err": err,
                                          "dtype": str(got.dtype)[6:]}
    log(f"[sharded] reductions over the {dist.get_backend(group)} group (all-reduce, mul "
        f"all-gather + fold), n={SHARDED_REDUCE_N}, 8 chunks: equal to fused: "
        f"{json.dumps(out)}")
    return out


def sharded_handoff(sp, mesh) -> dict:
    """(c) the handoff chain at n = 2**27: sharded -> sharded moves no
    interior byte and gathers nothing; sharded -> cuda runs the consumer's
    stages on the split-pipeline kernel (launches counted from 0 around the
    run).  On one rank a sharded stage's output is a DTensor, never a
    sharded stream (a stream needs two shards, as in the reference), so the
    consumer reads the rank's local tensor: ``shard_passthrough`` and the
    ``gather`` events stay 0 here; the CPU tests hold them on 2-8 gloo
    ranks."""
    from repro_torch.core import plan_cache
    x = torch.linspace(0.0, 1.0, N_MAIN, device=DEVICE)
    want, _ctx = handoff_chain(x, "fused", True)
    out = {}
    for consumer in ("sharded", "cuda"):
        plan_cache.clear()
        chain = lambda: handoff_chain(x, consumer, True, first="sharded", mesh=mesh,
                                      batch_elements=SHARDED_BATCH)
        for _warm in range(2):
            chain()
        sp.reset_counts()
        got, ctx = chain()
        launched = sp.split_pipeline.launches
        st = dict(ctx.stats)
        events = ctx.counters.materialize_events()
        gathers = [e for e in events if e[0].startswith("interior:gather")]
        err = compare(f"sharded -> {consumer} chain vs fused", got, want, 2e-5)
        interior = ctx.counters.bytes_interior()
        if consumer == "sharded" and (interior or gathers
                                      or st.get("sharded_stages", 0) != HANDOFF_EVALS
                                      or launched):
            raise AssertionError(f"sharded -> sharded: interior {interior}, gathers "
                                 f"{gathers}, {st}, launches {launched}")
        if consumer == "cuda" and (st.get("cuda_stages", 0) != HANDOFF_EVALS - 1
                                   or launched != st["cuda_stages"]
                                   or st.get("cuda_fallback_stages", 0)
                                   or st.get("sharded_stages", 0) != 1):
            raise AssertionError(f"sharded -> cuda: {st}, launches {launched}")
        out[consumer] = {"interior": interior, "gathers": len(gathers),
                         "shard_passthrough": st.get("shard_passthrough", 0),
                         "stream_materialized": st.get("stream_materialized", 0),
                         "launches": launched, "max_abs_err": err}
        log(f"[sharded] chain n={N_MAIN} sharded -> {consumer} (handoff on, warm): "
            f"interior bytes {interior}, gather events {len(gathers)}, shard_passthrough "
            f"{st.get('shard_passthrough', 0)} (one rank: no sharded stream), "
            f"split_pipeline launches {launched}; equal to the fused chain "
            f"(max |diff| {err:.3e}); stats {st}")
        del got
    del x, want
    return out


def sharded_auto(w, mesh) -> dict:
    """(d) ``executor="auto"`` with the mesh on Black-Scholes at 2**27: the
    miss, the first hit (measures every candidate on one sample and pins),
    a warm replay; the pick and measured seconds per stage."""
    from repro_torch.core import plan_cache
    data = w.black_scholes_data(N_MAIN, seed=0, device="cuda")
    _r, want, _c = run_observed(w.black_scholes, data, "fused")
    plan_cache.clear()
    picks = []
    for call in range(3):
        _r, got, ctx = run_observed(w.black_scholes, data, "auto", mesh=mesh)
        for i, (g, wv) in enumerate(zip(got, want)):
            compare(f"sharded/auto call {call} output {i} vs fused", g, wv, 2e-5)
        picks.append({k: v for k, v in ctx.stats.items() if k.startswith("auto_")})
    (entry,) = [e for e in plan_cache.entries() if e.key in ctx._entry_keys]
    out = {"chosen": {str(k): v for k, v in entry.chosen_exec.items()},
           "timings_s": {str(k): dict(v) for k, v in entry.exec_timings.items()},
           "stats_per_call": picks}
    log(f"[sharded] auto with the mesh on black_scholes n={N_MAIN}: picks per stage "
        f"{out['chosen']}; measured seconds {out['timings_s']}; auto stats per call "
        f"{picks}")
    return out


def sharded_restore(mesh) -> dict:
    """(e) elastic restore: a tree saved from the CPU comes back as card
    DTensors on the mesh (rows sharded, a vector replicated), equal."""
    import tempfile
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.ckpt import checkpoint as ckpt
    gen = torch.Generator().manual_seed(5)
    tree = {"w": torch.randn(4096, 1024, generator=gen), "b": torch.arange(1024.0)}
    sh = {"w": (mesh, (Shard(0), Replicate())), "b": (mesh, (Replicate(), Replicate()))}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, tree)
        t0 = time.perf_counter()
        r = ckpt.restore(d, 3, {k: v.to("meta") for k, v in tree.items()}, sh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    for k, v in r.items():
        if not (isinstance(v, DTensor) and v.to_local().is_cuda
                and tuple(v.placements) == sh[k][1]
                and torch.equal(v.full_tensor().cpu(), tree[k])):
            raise AssertionError(f"sharded/restore {k}: {type(v).__name__}")
    log(f"[sharded] elastic restore of {{w: (4096, 1024), b: (1024,)}} saved from the CPU "
        f"onto the card mesh: DTensors {[str(p) for p in r['w'].placements]} / "
        f"{[str(p) for p in r['b'].placements]}, values equal; {ms:.1f} ms host clock")
    return {"ms": ms}


def sharded_host_ms(w, mesh) -> dict:
    """(f) host milliseconds of a warm Black-Scholes evaluation at 2**27 on
    ``sharded``, ``fused`` and ``cuda`` (plan cache warm, each run twice
    first), in rotating turns; medians and quartiles."""
    from repro_torch.core import plan_cache
    data = w.black_scholes_data(N_MAIN, seed=0, device="cuda")
    runs = {"sharded": {"mesh": mesh}, "fused": {}, "cuda": {}}
    plan_cache.clear()
    for ex, kw in runs.items():
        for _warm in range(2):
            run_observed(w.black_scholes, data, ex, **kw)
    times = {ex: [] for ex in runs}
    order = list(runs)
    for r in range(SHARDED_ROUNDS):
        for ex in order[r % 3:] + order[:r % 3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_observed(w.black_scholes, data, ex, **runs[ex])
            times[ex].append((time.perf_counter() - t0) * 1e3)
    out = {ex: {"median_ms": statistics.median(v),
                "quartiles_ms": statistics.quantiles(v, n=4)[::2]} for ex, v in times.items()}
    log(f"[sharded] warm black_scholes n={N_MAIN}, host clock ending in a synchronise, "
        f"{SHARDED_ROUNDS} rotating turns: " + "; ".join(
            f"{ex} {v['median_ms']:.3f} ms ({v['quartiles_ms'][0]:.3f}-"
            f"{v['quartiles_ms'][1]:.3f})" for ex, v in out.items()) + f" ({card_line()})")
    return out


def sharded_chaos(sp, w, mesh) -> dict:
    """(g) ``compile:fail:1`` on Black-Scholes at n = 2**27 through
    ``mozart.pipeline(executor="cuda", mesh=...)``: one demotion, to a
    ``sharded`` stage that runs, no launch, equal to the fault-free run.
    Its MZ4xx events are cleared after it, as the chaos phase's."""
    from repro_torch.core import mozart, plan_cache, resilience
    fn = w.black_scholes
    data = w.black_scholes_data(N_MAIN, seed=0, device="cuda")
    resilience.clear_events()
    plan_cache.clear()
    with mozart.session(executor="cuda"):
        want = [o.value for o in as_list(fn(**data))]
    p = mozart.pipeline(fn, executor="cuda", mesh=mesh)
    sp.reset_counts()
    with mozart.inject_faults("compile:fail:1") as plan:
        got = as_list(p(**data))
    torch.cuda.synchronize()
    st = p.last_call_stats
    if (plan.fired != [("compile", "stage 0 cuda")] or st.get("exec_demotions", 0) != 1
            or st.get("exec_demoted_to_sharded", 0) != 1 or st.get("sharded_stages", 0) != 1
            or sp.split_pipeline.launches):
        raise AssertionError(f"sharded/chaos: fired {plan.fired}, {st}, launches "
                             f"{sp.split_pipeline.launches}")
    for i, (g, wv) in enumerate(zip(got, want)):
        compare(f"sharded/chaos demoted call output {i} vs fault-free", g, wv, 2e-5)
    counts = {k: int(resilience.stats.get(k, 0)) for k in RESILIENCE_KEYS}
    log(f"[sharded] chaos: compile:fail:1 on black_scholes n={N_MAIN}, mozart.pipeline(cuda) "
        f"with the one-rank card mesh: fired {plan.fired}; 1 demotion cuda -> sharded, which "
        f"ran the stage (sharded_stages {st.get('sharded_stages', 0)}); output equal to "
        f"the fault-free run; MZ4xx {counts}")
    resilience.clear_events()
    plan_cache.clear()
    del got, want, p, data
    torch.cuda.empty_cache()
    return {"mz": counts}


def phase_sharded(sp, w, erf) -> dict:
    """The ``sharded`` executor (ROADMAP A8.1) on a one-rank NCCL mesh
    (``make_host_mesh()``; one H100 gives one rank, so the multi-rank
    collectives, streams, re-layouts and the ranks' agreement on ``auto``
    and the ladder are held on the CPU by ``gloo`` worlds of 2-8 ranks in
    ``tests/test_torch_sharded*.py``): (g) ``sharded_chaos`` first (its
    MZ4xx events cleared, so the phase's check after it reads the rest),
    then (a) ``sharded_workloads``, (b) ``sharded_reductions``, (c)
    ``sharded_handoff``, (d) ``sharded_auto``, (e) ``sharded_restore``, (f)
    ``sharded_host_ms``.  The process group lives within this phase: made
    here, ended here."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = make_host_mesh()
    try:
        log(f"[sharded] mesh {mesh} over {dist.get_world_size()} rank(s), backend "
            f"{dist.get_backend()} ({card_line()})")
        out = {"chaos": sharded_chaos(sp, w, mesh),
               "workloads": sharded_workloads(w, erf, mesh),
               "reductions": sharded_reductions(mesh),
               "handoff": sharded_handoff(sp, mesh),
               "auto": sharded_auto(w, mesh),
               "restore": sharded_restore(mesh),
               "host_ms": sharded_host_ms(w, mesh)}
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[sharded] phase {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# zero1: ZeRO-1 data-parallel training on a one-rank NCCL mesh (A8.2a, C13)
# ---------------------------------------------------------------------------


def zero1_config():
    return train_config().with_runtime(n_layers=ZERO1_LAYERS)


def zero1_train(mesh) -> dict:
    """(a) ``train(mesh=...)`` against the mesh-free ``train()``: same seed,
    batches and AdamW; on one rank every collective is a copy, so the
    losses and parameters are expected bit-equal.  A difference is printed
    by step and by leaf, and fails beyond ``ZERO1_LOSS_RTOL``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.train import train
    cfg = zero1_config()
    kw = dict(steps=ZERO1_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, device="cuda")
    t0 = time.perf_counter()
    plain = train(cfg, **kw)
    want_losses = plain["losses"]
    want = {n: p.detach().cpu() for n, p in sorted(plain["params"].named_parameters())}
    del plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    got = train(cfg, mesh=mesh, **kw)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    moments = got["opt_state"].m
    if not all(isinstance(t, DTensor) and t.to_local().is_cuda for t in moments.values()):
        raise AssertionError("zero1: the moments are not card DTensors")
    differ = {}
    for n, p in sorted(got["params"].named_parameters()):
        d = (p.detach().cpu().float() - want[n].float()).abs().max().item()
        if d:
            differ[n] = d
    losses = got["losses"]
    del got, moments
    torch.cuda.empty_cache()
    steps_differ = [i + 1 for i, (a, b) in enumerate(zip(losses, want_losses)) if a != b]
    log(f"[zero1] (a) train(mesh=one-rank {dist.get_backend()} mesh) of {cfg.name}, "
        f"{cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ}, {ZERO1_STEPS} steps: losses "
        f"{losses} against the mesh-free train()'s {want_losses}: "
        + ("bit-equal, parameters bit-equal" if not steps_differ and not differ else
           f"steps {steps_differ} differ, leaves {differ} (first difference at step "
           f"{steps_differ[0] if steps_differ else '-'})")
        + f"; the mesh run {mesh_s:.1f} s, both {time.perf_counter() - t0:.1f} s; peak "
        f"device memory of the mesh run {peak / 1e9:.2f} GB")
    for a, b in zip(losses, want_losses):
        if not math.isfinite(a) or abs(a - b) > ZERO1_LOSS_RTOL * abs(b):
            raise AssertionError(f"zero1 (a): losses {losses} against {want_losses}")
    return {"losses": losses, "plain_losses": want_losses, "bit_equal": not steps_differ
            and not differ, "leaves_differ": differ, "peak_bytes": peak, "mesh_s": mesh_s}


def zero1_kernel(fa, ref, mesh, losses_jnp: list) -> dict:
    """(b) ``ZERO1_STEPS`` steps of the port's ``make_zero1_step(...,
    path="kernel")``, each profiled whole: the fused AdamW kernel once per
    leaf per step, by the wrapper's count (from 0 before the steps) and by
    ``torch.profiler``; the losses against (a)'s ``jnp`` path.  Before
    them, one unprofiled step on step 1's batch whose ``update_sharded`` is
    wrapped: on the arguments the step hands it, each leaf's local shard is
    updated by both paths (rtol 3e-5, bfloat16 within one ulp: the train
    phase's check), and the gradient shards are copied to the host for (d)
    (``compress_sample``); that step's results and launches are dropped.
    Returns the host copies with the step's gradient bytes and their
    ``compressed_bytes``."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as T
    from repro_torch.models import weights
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, compress
    cfg = zero1_config()
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    zero = T.zero1_layout(mesh, model)
    state = adamw.init_sharded(weights.leaves(model), zero)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=max(ZERO1_STEPS, 2),
                                warmup_steps=max(ZERO1_STEPS // 20, 1))   # train()'s
    step_fn = T.make_zero1_step(cfg, opt_cfg, zero, "kernel")
    pipe = DataPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cuda")
    n_leaves = len(state.m)
    seen = {}
    real_update = adamw.update_sharded

    def compared(params, shards, st, ocfg, z, path):
        sc, _lr, _gn = adamw.step_scalars(ocfg, st.step + 1, shards, z.norm(shards))
        err = 0.0
        for name, p in params.items():
            args = (z.local(p, name), shards[name], st.m[name].to_local(),
                    st.v[name].to_local(), sc, ocfg)
            kernel = adamw.update_leaf(*args, "kernel")
            plain = adamw.update_leaf(*args, "jnp")
            err = max(err, check_adamw_outputs(
                f"zero1 step 1 {name} kernel vs jnp path", kernel, plain, args[0], 3e-5))
            del kernel, plain
        seen["vs_jnp"] = err
        seen["grads_host"] = {n: g.detach().cpu() for n, g in compress_sample(shards).items()}
        seen["step_bytes"] = (sum(g.numel() * g.element_size() for g in shards.values()),
                              compress.compressed_bytes(shards))
        return real_update(params, shards, st, ocfg, z, path)

    adamw.update_sharded = compared
    try:
        dropped = step_fn(model, state, pipe.batch_for_step(0))
    finally:
        adamw.update_sharded = real_update
    del dropped
    torch.cuda.empty_cache()
    if "vs_jnp" not in seen:
        raise AssertionError("zero1 (b): make_zero1_step did not call update_sharded")
    losses, per_step, profiled, update_ms = [], [], [], []
    fa.fused_adamw.launches = 0
    for step in range(ZERO1_STEPS):
        batch = pipe.batch_for_step(step)
        before = fa.fused_adamw.launches
        n_prof, us, (new_p, state, metrics) = _profile_window(
            lambda: step_fn(model, state, batch), 1, "fused_adamw")
        launched = fa.fused_adamw.launches - before
        per_step.append(launched)
        profiled.append(n_prof)
        update_ms.append(us / 1e3)
        weights.assign(model, new_p)
        del new_p
        losses.append(float(metrics["loss"]))
        if launched != n_leaves:
            raise AssertionError(f"zero1 (b) step {step + 1}: {launched} fused_adamw "
                                 f"launches for {n_leaves} leaves")
    torch.cuda.synchronize()
    total = fa.fused_adamw.launches
    log(f"[zero1] (b) make_zero1_step(path=\"kernel\"), {ZERO1_STEPS} steps: fused_adamw "
        f"launches per step {per_step} (wrapper), {profiled} (torch.profiler), "
        f"{total} in all; its device ms per step {[round(t, 3) for t in update_ms]}; step 1 "
        f"max |kernel path - jnp path| {seen['vs_jnp']:.3e} (rtol 3e-5, bfloat16 p within "
        f"one ulp); losses {losses} against (a)'s jnp path {losses_jnp}")
    for a, b in zip(losses, losses_jnp):
        if abs(a - b) > ZERO1_LOSS_RTOL * abs(b):
            raise AssertionError(f"zero1 (b): kernel-path losses {losses} vs {losses_jnp}")
    del model, state
    torch.cuda.empty_cache()
    return {"launches": total, "launches_per_step": per_step, "profiled_per_step": profiled,
            "update_device_ms": update_ms, "max_abs_err_vs_jnp": seen["vs_jnp"],
            "losses": losses}, (seen["grads_host"], seen["step_bytes"])


def zero1_resume(mesh) -> dict:
    """(c) ``train(mesh=...)`` of gemma-7b's smoke config (2 layers, d 64,
    vocab 256: a checkpoint at published widths is 12.8 GB for one layer,
    and two runs of it took 105.3 s on an H100) for ``ZERO1_STEPS`` steps
    with a checkpoint at step 2; the step-3 checkpoint removed, the run
    again from the same directory resumes at step 2: its loss and the final
    parameters equal the uninterrupted run's, bit for bit."""
    import shutil
    import tempfile
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.train import train
    cfg = get_smoke_config("gemma-7b")
    kw = dict(steps=ZERO1_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, device="cuda",
              mesh=mesh, ckpt_every=2)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        full = train(cfg, ckpt_dir=d, **kw)
        want = {n: p.detach().clone() for n, p in full["params"].named_parameters()}
        want_loss = full["losses"][-1]
        del full
        steps = ckpt.all_steps(d)
        shutil.rmtree(Path(d) / f"step_{ZERO1_STEPS:08d}")
        t1 = time.perf_counter()
        again = train(cfg, ckpt_dir=d, **kw)
        resume_s = time.perf_counter() - t1
        equal = all(torch.equal(p.detach(), want[n])
                    for n, p in again["params"].named_parameters())
        got_losses = again["losses"]
        nbytes = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        del again
    torch.cuda.empty_cache()
    log(f"[zero1] (c) {cfg.name}, {cfg.n_layers} layers, checkpoints at steps {steps} "
        f"({nbytes / 1e9:.2f} GB on disk after the resumed run; moments gathered on the "
        f"main thread, written by the checkpointer's): resumed losses {got_losses} against "
        f"step {ZERO1_STEPS}'s {want_loss}; parameters "
        f"{'bit-equal' if equal else 'DIFFER'}; both runs {time.perf_counter() - t0:.1f} s, "
        f"the resumed {resume_s:.1f} s")
    if got_losses != [want_loss] or not equal or steps != [2, ZERO1_STEPS]:
        raise AssertionError(f"zero1 (c): resumed {got_losses} vs {want_loss}, params "
                             f"equal {equal}, checkpoints {steps}")
    return {"losses": got_losses, "checkpoint_steps": steps, "resume_s": resume_s}


def compress_sample(grads: dict) -> dict:
    """The leaves of step 1's gradients that (d) compresses on the CPU too:
    every leaf but the 786M-element embedding, layer 0's slice of the
    stacked ones (the CPU takes seconds per 10^8 elements)."""
    return {n: (g[0] if n.startswith("layers.") else g) for n, g in grads.items()
            if n != "embed"}


def zero1_compress(sample: dict, step_bytes: tuple) -> dict:
    """(d) ``compress.apply`` and the int8 codes on the card against the CPU
    on the same values (``sample``, host copies): bit-equal;
    ``compressed_bytes`` of the step (``step_bytes``: as they are, packed)."""
    from repro_torch.optim import compress
    n = sum(g.numel() for g in sample.values())
    t0 = time.perf_counter()
    want, want_state = compress.apply(sample, compress.init(sample))
    cpu_s = time.perf_counter() - t0
    card = {k: v.to("cuda") for k, v in sample.items()}
    got, got_state = compress.apply(card, compress.init(card))
    torch.cuda.synchronize()
    for k, g in sample.items():
        flat = g.to(torch.float32).reshape(-1)
        codes_cpu, scale_cpu = compress._quantize(flat)
        codes, scale = compress._quantize(flat.to("cuda"))
        for what, a, b in (("codes", codes, codes_cpu), ("scales", scale, scale_cpu),
                           ("decompressed", got[k], want[k]),
                           ("residual", got_state.residual[k], want_state.residual[k])):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"zero1 (d) {k} {what}: card != CPU")
    total, packed = step_bytes
    log(f"[zero1] (d) compress.apply on step 1's gradients ({len(sample)} leaves, {n} "
        f"elements: all but the embedding, layer 0 of the stacked ones): codes, scales, "
        f"decompressed values and residuals bit-equal to the CPU's ({cpu_s:.1f} s there); "
        f"compressed_bytes of the whole step {packed} against {total} bytes as they are "
        f"({total / packed:.2f}x)")
    return {"elements": n, "compressed_bytes": packed, "bytes": total}


def zero1_c13(sp, mesh) -> dict:
    """(e) ROADMAP C13 on the card: uint16 and uint32 (values past 2**31
    included) ``max``/``min`` reductions and ``maximum``/``minimum``,
    ``greater``/``less`` and ``where`` on a ``greater``, at n = 2**24, on
    ``cuda`` (the split-pipeline kernel) and ``sharded`` (the one-rank
    mesh), against the same ops on int64 copies; ``fused`` too."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import plan_cache
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for dtype, hi in ((torch.uint16, 1 << 16), (torch.uint32, 1 << 32)):
        x64 = torch.randint(0, hi, (C13_N,), generator=gen, device="cuda", dtype=torch.int64)
        y64 = torch.randint(0, hi, (C13_N,), generator=gen, device="cuda", dtype=torch.int64)
        x, y = x64.to(dtype), y64.to(dtype)
        want = {"max": x64.amax(), "min": x64.amin(), "maximum": torch.maximum(x64, y64),
                "minimum": torch.minimum(x64, y64), "greater": x64 > y64, "less": x64 < y64,
                "where": torch.where(x64 > y64, x64, y64)}
        calls = {"max": lambda x, y: anp.max(x), "min": lambda x, y: anp.min(x),
                 "maximum": anp.maximum, "minimum": anp.minimum, "greater": anp.greater,
                 "less": anp.less, "where": lambda x, y: anp.where(anp.greater(x, y), x, y)}
        for ex, kw in (("cuda", {}), ("sharded", {"mesh": mesh}), ("fused", {})):
            plan_cache.clear()
            sp.reset_counts()
            for op, fn in calls.items():
                _r, (got,), ctx = run_observed(lambda x, y: fn(x, y), {"x": x, "y": y}, ex,
                                               batch_elements=C13_N // 8, **kw)
                w = want[op]
                if got.dtype != (torch.bool if w.dtype == torch.bool else dtype) or \
                        not torch.equal(got.to(w.dtype), w):
                    raise AssertionError(f"zero1 (e) {ex} {op}({str(dtype)[6:]}): {got.dtype}")
                if ex == "cuda" and (ctx.stats.get("cuda_fallback_stages", 0)
                                     or not ctx.stats.get("cuda_stages", 0)):
                    raise AssertionError(f"zero1 (e) cuda {op}: {dict(ctx.stats)}")
            if ex == "cuda" and sp.split_pipeline.launches != len(calls):
                raise AssertionError(f"zero1 (e) cuda {str(dtype)[6:]}: "
                                     f"{sp.split_pipeline.launches} launches for {len(calls)}")
            out[f"{ex}/{str(dtype)[6:]}"] = {"ops": len(calls),
                                            "split_pipeline_launches":
                                                sp.split_pipeline.launches}
    plan_cache.clear()
    log(f"[zero1] (e) C13 at n={C13_N}: uint16 and uint32 max, min, maximum, minimum, "
        f"greater, less and where(greater) equal to int64 on cuda (every stage on the "
        f"kernel), sharded and fused: {json.dumps(out)}")
    return out


def phase_zero1(fa, sp, ref, train_peak: int | None = None) -> dict:
    """ZeRO-1 data-parallel training (ROADMAP A8.2a) and C13 on a one-rank
    NCCL mesh (one H100 is one rank: the moments' shards are whole, so the
    collectives are an all-reduce per gradient and no all-gather; the
    reduce-scatter, the gathers and the ranks' agreement on retries are held
    on 2 and 4 ``gloo`` ranks by ``tests/test_torch_zero1.py``).  The
    process group lives within this phase."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = make_host_mesh()
    try:
        log(f"[zero1] mesh {mesh} over {dist.get_world_size()} rank(s), backend "
            f"{dist.get_backend()} ({card_line()})")
        out = {"train": zero1_train(mesh)}
        out["kernel"], (sample, step_bytes) = zero1_kernel(fa, ref, mesh,
                                                           out["train"]["losses"])
        out["compress"] = zero1_compress(sample, step_bytes)
        del sample
        out["resume"] = zero1_resume(mesh)
        out["c13"] = zero1_c13(sp, mesh)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    beside = ("" if train_peak is None else
              f" beside the train phase's {train_peak / 1e9:.2f} GB (8 layers, kernel path)")
    log(f"[zero1] phase {out['seconds']:.1f} s; peak device memory of train(mesh=...) "
        f"{out['train']['peak_bytes'] / 1e9:.2f} GB{beside}; {card_line()}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# tp: tensor parallelism over "model" (ROADMAP A8.2b), C14 and C15
# ---------------------------------------------------------------------------

TP_LAYERS = 4                    # gemma-7b's depth in (a) and (b)
TP_MOE_LAYERS = 2                # olmoe-1b-7b's depth in (c) and (d)
TP_STEPS = 3
#: step 1's loss against the mesh-free run's; steps 2 and 3 in bfloat16
#: within TP_LOSS_RTOL, above the 1.7% the reference's own bfloat16 (1, 2)
#: runs move from its (1, 1) run by step 3 on the CPU
TP_LOSS1_RTOL, TP_LOSS_RTOL = 1e-3, 2e-2
TP_TIMEOUT_S = 600               # the ranks' gloo collectives
C15_BYTES = 8 << 30              # the failed attempt's allocation
EP_GROUPS = 2                    # (g): one dispatch group per device of (1, 2)
EP_CAPACITY = 8.0                # (g2): n_experts / top_k, where nothing drops
#: (g2) step 1's loss against the mesh-free run's (the (c) leg's olmoe comes
#: within 2.6e-4 on its later steps); steps 2-3 within TP_LOSS_RTOL
EP_LOSS1_RTOL = 5e-4
EP_FLOOR_FACTOR = 1.5            # (g1): the serving rule, max(2e-2, 1.5 x floor)
#: (g1): the expert leaves split over "model" (F) and their dim
EP_MODEL_DIMS = {"w_in": 2, "w_gate": 2, "w_out": 1}
#: (h) tensor-parallel serving: (batch, prompt, decode steps) of (h1)
#: gemma-7b at 28 layers in bfloat16 and (h2) olmoe-1b-7b at
#: ``TP_MOE_LAYERS`` layers in float32, each rank holding one of
#: ``TP_SERVE_BLOCKS`` sequence blocks of the KV cache
TP_SERVE = {"h1": (4, 2048, 16), "h2": (2, 1024, 8)}
TP_SERVE_BLOCKS = 2
TP_SERVE_GREEDY = 2               # (h): tokens of lm.greedy_generate under the groups
#: (h3) the continuous batcher's masked bucket on (h1)'s slices: the
#: right-padded prompt lengths in (h1)'s bucket of 2048, and per-slot decode
#: steps; row 1's writes cross from rank 0's block (positions 0-1027) into
#: rank 1's at step 4
TP_MASKED_PLENS = (2048, 1025, 700, 1)
TP_MASKED_STEPS = 8


def tp_gemma_config():
    from repro_torch.configs.registry import get_config
    return get_config("gemma-7b").with_runtime(n_layers=TP_LAYERS)


def tp_olmoe_config():
    from repro_torch.configs.registry import get_config
    return get_config("olmoe-1b-7b").with_runtime(n_layers=TP_MOE_LAYERS, moe_groups=1)


def tp_init_config():
    """(f): gemma-7b at its published widths and depth."""
    from repro_torch.configs.registry import get_config
    return get_config("gemma-7b")


def tp_ep_config(capacity_factor: float | None = None):
    """(g): olmoe-1b-7b at published widths, ``TP_MOE_LAYERS`` layers, one
    dispatch group per device of the (1, 2) mesh."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config("olmoe-1b-7b").with_runtime(n_layers=TP_MOE_LAYERS, moe_groups=EP_GROUPS)
    if capacity_factor is None:
        return cfg
    return cfg.with_runtime(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


def tp_serve_config(leg: str):
    """(h1) gemma-7b at published widths and depth, bfloat16; (h2)
    olmoe-1b-7b at published widths, ``TP_MOE_LAYERS`` layers, float32 (so
    that routing near-ties do not flip between the two computations), one
    dispatch group; both with the KV cache in ``TP_SERVE_BLOCKS`` blocks,
    one per rank of the (1, 2) mesh."""
    from repro_torch.configs.registry import get_config
    if leg == "h1":
        return get_config("gemma-7b").with_runtime(kv_cache_blocks=TP_SERVE_BLOCKS)
    return get_config("olmoe-1b-7b").with_runtime(
        n_layers=TP_MOE_LAYERS, moe_groups=1, dtype=torch.float32,
        kv_cache_blocks=TP_SERVE_BLOCKS)


def ep_install(mesh, cfg, batch: int) -> None:
    """``models.shard_ctx`` as the reference's ``launch/dryrun.py``
    (``:168-183``) installs it, in the port's ``(mesh, placements)`` pairs:
    the residual's batch over the data axes (where it divides) and sequence
    over "model", the MoE groups over every axis, the logits' vocabulary
    over "model"."""
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import data_axes_of, dp_extent, tp_extent
    from repro_torch.models import shard_ctx
    dpa = data_axes_of(mesh)
    dp_spec = dpa if len(dpa) > 1 else (dpa[0] if dpa else None)
    bspec = dp_spec if batch % dp_extent(mesh) == 0 else None
    shard_ctx.set_residual((mesh, shd.placements(
        (bspec, "model" if cfg.seq_shard_residual else None, None), mesh)))
    shard_ctx.set_moe_groups((mesh, shd.placements((tuple(mesh.mesh_dim_names),), mesh)))
    if cfg.padded_vocab % tp_extent(mesh) == 0:
        shard_ctx.set_logits((mesh, shd.placements((bspec, None, "model"), mesh)))


def bit_sums(t: torch.Tensor) -> tuple[int, int]:
    """A checksum of ``t``'s bits without a second copy of it: the wrapping
    int64 sums of its elements' bit patterns, plain and weighted by
    position, ``CHUNK`` elements at a time."""
    ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
    flat = t.detach().contiguous().reshape(-1).view(ints)
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    s2 = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), CHUNK):
        c = flat[i:i + CHUNK].to(torch.int64)
        s1 += c.sum()
        s2 += (c * torch.arange(i + 1, i + 1 + c.numel(), device=t.device)).sum()
        del c
    return int(s1), int(s2)


def tp_init_plain(cfg) -> dict:
    """(f)'s reference, in this process: the mesh-free init of ``cfg`` from
    seed 0 and, as a rank of the (1, 2) mesh held it before C16, rank 0's
    slices cut from it (``weights.model_slices``): that path's peak device
    memory and seconds, the whole model's and the largest leaf's bytes, and
    per rank the bit sums of each leaf's slice.  The whole model is freed
    before the ranks start."""
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    gc.collect()
    torch.cuda.empty_cache()
    dims = shd.model_dims(tfm.init_model(cfg, None, "meta"),
                          AbstractMesh((1, 2), ("data", "model")))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rank0 = weights.model_slices(whole, dims, 0, 2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    del rank0
    leaves = weights.leaves(whole)
    nbytes = {n: p.numel() * p.element_size() for n, p in leaves.items()}
    largest = max(nbytes, key=nbytes.get)
    sums = [{n: bit_sums(p if dims[n] is None else torch.chunk(p, 2, dims[n])[i])
             for n, p in leaves.items()} for i in range(2)]
    del whole, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return {"sums": sums, "whole_then_slice_peak_bytes": peak, "whole_then_slice_s": seconds,
            "whole_bytes": sum(nbytes.values()), "largest_leaf": largest,
            "largest_leaf_bytes": nbytes[largest],
            "slice_bytes": sum(b // (1 if dims[n] is None else 2) for n, b in nbytes.items())}


@contextlib.contextmanager
def step_seconds(out: list):
    """``train()``'s step times as its ``StepTimer`` records them."""
    from repro_torch.core import resilience
    real = resilience.StepTimer.record

    def record(self, step, seconds):
        out.append(seconds)
        return real(self, step, seconds)
    resilience.StepTimer.record = record
    try:
        yield out
    finally:
        resilience.StepTimer.record = real


@contextlib.contextmanager
def collective_bytes(out: collections.Counter):
    """The tensor bytes this process hands ``torch.distributed``'s
    all-reduce, all-gather, reduce-scatter and all-to-all (per call: the
    input of an all-reduce, the output of an all-gather, the inputs of a
    reduce-scatter, the input of an all-to-all)."""
    import torch.distributed as dist
    nb = lambda t: t.numel() * t.element_size()
    real = {k: getattr(dist, k) for k in ("all_reduce", "all_gather", "reduce_scatter",
                                          "all_to_all_single")}

    def all_reduce(t, *a, **kw):
        out["all_reduce"] += nb(t)
        return real["all_reduce"](t, *a, **kw)

    def all_gather(parts, t, *a, **kw):
        out["all_gather"] += sum(nb(p) for p in parts)
        return real["all_gather"](parts, t, *a, **kw)

    def reduce_scatter(o, parts, *a, **kw):
        out["reduce_scatter"] += sum(nb(p) for p in parts)
        return real["reduce_scatter"](o, parts, *a, **kw)

    def all_to_all_single(o, t, *a, **kw):
        out["all_to_all"] += nb(t)
        return real["all_to_all_single"](o, t, *a, **kw)
    for k, f in (("all_reduce", all_reduce), ("all_gather", all_gather),
                 ("reduce_scatter", reduce_scatter), ("all_to_all_single", all_to_all_single)):
        setattr(dist, k, f)
    try:
        yield out
    finally:
        for k, f in real.items():
            setattr(dist, k, f)


@contextlib.contextmanager
def moe_spy(calls: list):
    """Every ``route`` and expert FFN (``_dispatch_one_group``) call: on the
    main thread or not, and whether it saw the model group."""
    import threading
    from repro_torch.models import mlp, tensor_parallel
    real_route, real_ffn = mlp.route, mlp._dispatch_one_group

    def seen(kind):
        calls.append((kind, threading.current_thread() is threading.main_thread(),
                      tensor_parallel.current() is not None))

    def route(*a, **kw):
        seen("route")
        return real_route(*a, **kw)

    def ffn(*a, **kw):
        seen("ffn")
        return real_ffn(*a, **kw)
    mlp.route, mlp._dispatch_one_group = route, ffn
    try:
        yield calls
    finally:
        mlp.route, mlp._dispatch_one_group = real_route, real_ffn


@contextlib.contextmanager
def checkpoint_seconds(out: collections.defaultdict):
    """Seconds this process spends in a checkpoint's parts: gathering the
    whole leaves to the writer (``train._whole_state``/``_whole_params``),
    copying them for the writer thread (``checkpoint._flatten``), writing
    the file (``checkpoint._write``, on that thread) and restoring
    (``checkpoint.restore``)."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import train as T
    real = {(T, "_whole_state"): T._whole_state, (T, "_whole_params"): T._whole_params,
            (ckpt, "_flatten"): ckpt._flatten, (ckpt, "_write"): ckpt._write,
            (ckpt, "restore"): ckpt.restore}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                out[key] += time.perf_counter() - t0
        return run
    for (mod, name), fn in real.items():
        setattr(mod, name, timed(name.lstrip("_"), fn))
    try:
        yield out
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def tp_plain(cfg) -> tuple[dict, dict]:
    """The mesh-free ``train()`` on the card: its losses, step seconds and
    peak memory, and its final parameters, kept on the card for the ranks
    (shared with them through CUDA IPC)."""
    from repro_torch.launch.train import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times: list = []
    with step_seconds(times):
        out = train(cfg, steps=TP_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
                    device="cuda")
    params = {n: p.detach() for n, p in out["params"].named_parameters()}
    res = {"losses": out["losses"], "step_s": times,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res, params


def tp_slices_against(model, cfg, mesh, plain: dict) -> dict:
    """Each of this rank's ``"model"`` slices against the same slice of the
    mesh-free run's leaf: the largest difference, at which leaf, and one
    bfloat16 ulp of that leaf's largest element."""
    from repro_torch.launch import train as T
    from repro_torch.models import transformer as tfm
    zero = T.zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
    worst = (0.0, "", 0.0)
    for n, p in model.named_parameters():
        d, want = zero.mdims[n], plain[n]
        if d is not None:
            want = torch.chunk(want, zero.mg.size, dim=d)[zero.mg.index]
        diff = float((p.detach().float() - want.float()).abs().max())
        if diff >= worst[0]:
            big = float(want.float().abs().max())
            ulp = math.ldexp(1.0, math.frexp(big)[1] - 8) if big else 0.0
            worst = (diff, n, ulp)
    return {"max_param_diff": worst[0], "at": worst[1], "bf16_ulp_of_largest": worst[2]}


def tp_train(mesh, cfg, plain: dict, spy: bool = False, ckpt_dir: str | None = None):
    """``train(cfg, mesh=mesh)`` on this rank (with ``ckpt_dir``: a
    checkpoint at step 2 and at the end): losses, step seconds, peak
    memory, collective bytes, this rank's slices against the mesh-free
    run's (and, with ``spy``, every MoE route and expert FFN call).
    Returns the summary and the final slices."""
    from repro_torch.launch.train import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, sent, calls = [], collections.Counter(), []
    with step_seconds(times), collective_bytes(sent), \
            (moe_spy(calls) if spy else contextlib.nullcontext()):
        out = train(cfg, steps=TP_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
                    device="cuda", mesh=mesh, ckpt_dir=ckpt_dir, ckpt_every=2)
    torch.cuda.synchronize()
    res = {"losses": out["losses"], "step_s": times,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "collective_bytes": dict(sent), "calls": calls,
           "slices": {n: list(p.shape) for n, p in out["params"].named_parameters()},
           **tp_slices_against(out["params"], cfg, mesh, plain)}
    final = {n: p.detach() for n, p in out["params"].named_parameters()}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res, final


def tp_kernel(fa, mesh, cfg) -> dict:
    """(b) ``make_zero1_step(..., path="kernel")`` on this rank's model
    slices from (a)'s seed, ``TP_STEPS`` steps each profiled whole: the
    fused AdamW kernel once per leaf per step (the wrapper's count from 0
    before the steps, and ``torch.profiler``'s), its device time.  Before
    them, on step 1's arguments, every leaf's local shard updated by both
    paths (bfloat16 p within one ulp, as the zero1 phase's (b))."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as T
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    from repro_torch.optim import adamw
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    zero = T.zero1_layout(mesh, model)
    model = weights.model_slices(model, zero.mdims, zero.mg.index, zero.mg.size)
    gc.collect()
    torch.cuda.empty_cache()
    state = adamw.init_sharded(weights.leaves(model), zero)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=max(TP_STEPS, 2),
                                warmup_steps=max(TP_STEPS // 20, 1))   # train()'s
    step_fn = T.make_zero1_step(cfg, opt_cfg, zero, "kernel")
    pipe = DataPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cuda")
    real_update, seen = adamw.update_sharded, {}

    def compared(params, shards, st, ocfg, z, path):
        sc, _lr, _gn = adamw.step_scalars(ocfg, st.step + 1, shards, z.norm(shards))
        err, nbytes = 0.0, 0
        for name, p in params.items():
            args = (z.local(p, name), shards[name], st.m[name].to_local(),
                    st.v[name].to_local(), sc, ocfg)
            kernel = adamw.update_leaf(*args, "kernel")
            plain = adamw.update_leaf(*args, "jnp")
            err = max(err, check_adamw_outputs(
                f"tp step 1 {name} kernel vs jnp path", kernel, plain, args[0], 3e-5))
            nbytes += args[0].numel() * (2 * args[0].element_size()
                                         + args[1].element_size() + 16)
            del kernel, plain
        seen["vs_jnp"], seen["bytes"] = err, nbytes
        seen["elements"] = sum(z.local(p, n).numel() for n, p in params.items())
        return real_update(params, shards, st, ocfg, z, path)

    # step 1 once, unprofiled and dropped (the step is functional): each
    # leaf's local shard updated by both paths on the arguments the step
    # hands the update; those launches compare, and do not count
    adamw.update_sharded = compared
    try:
        dropped = step_fn(model, state, pipe.batch_for_step(0))
    finally:
        adamw.update_sharded = real_update
    del dropped
    gc.collect()
    torch.cuda.empty_cache()
    losses, per_step, profiled, update_ms = [], [], [], []
    n_leaves = len(state.m)
    fa.fused_adamw.launches = 0
    for step in range(TP_STEPS):
        batch = pipe.batch_for_step(step)
        before = fa.fused_adamw.launches
        n_prof, us, (new_p, state, metrics) = _profile_window(
            lambda: step_fn(model, state, batch), 1, "fused_adamw")
        per_step.append(fa.fused_adamw.launches - before)
        profiled.append(n_prof)
        update_ms.append(us / 1e3)
        weights.assign(model, new_p)
        del new_p
        losses.append(float(metrics["loss"]))
    pipe.stop()
    launches = fa.fused_adamw.launches
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": launches, "launches_per_step": per_step,
            "profiled_per_step": profiled, "update_device_ms": update_ms,
            "leaves": n_leaves, "max_abs_err_vs_jnp": seen["vs_jnp"],
            "bytes_per_step": seen["bytes"], "elements_per_step": seen["elements"]}


def tp_resume(mesh, cfg, ckpt_dir: str, want_loss: float, want: dict) -> dict:
    """(d) (c)'s checkpoints with the step-3 one removed, and ``train(cfg,
    mesh=mesh)`` again from the same directory: it resumes at step 2, and
    step 3's loss and this rank's slices equal the uninterrupted run's
    (``want_loss``, ``want``) bit for bit."""
    import shutil
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.train import train
    steps = ckpt.all_steps(ckpt_dir)
    nbytes = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(Path(ckpt_dir) / f"step_{TP_STEPS:08d}")
    dist.barrier()
    t0 = time.perf_counter()
    again = train(cfg, steps=TP_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, device="cuda",
                  mesh=mesh, ckpt_dir=ckpt_dir, ckpt_every=2)
    resume_s = time.perf_counter() - t0
    equal = all(torch.equal(p.detach(), want[n]) for n, p in again["params"].named_parameters())
    got = again["losses"]
    del again
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": got, "want": want_loss, "params_equal": equal, "steps": steps,
            "checkpoint_bytes": nbytes, "resume_s": resume_s}


def tp_init(mesh, cfg, plain: dict) -> dict:
    """(f) ROADMAP C16: this rank's parameters as ``train(mesh=...)`` makes
    them (``train.rank_params``: drawn straight into the rank's slices),
    the peak device memory across that init (reset before it), the bytes of
    the slices, and every leaf's bit sums against the mesh-free init's
    slice (``plain``, from ``tp_init_plain``)."""
    from repro_torch.launch import train as T
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    gc.collect()
    torch.cuda.empty_cache()
    zero = T.zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.rank_params(cfg, zero, torch.Generator(device="cuda").manual_seed(0),
                          torch.device("cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    leaves = weights.leaves(model)
    want = plain["sums"][zero.mg.index]
    differ = [n for n, p in leaves.items() if bit_sums(p) != want[n]]
    out = {"peak_bytes": peak, "seconds": seconds, "leaves": len(leaves), "differ": differ,
           "slice_bytes": sum(p.numel() * p.element_size() for p in leaves.values())}
    del model, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ep_params(cfg, seed: int) -> dict:
    """Layer 0's MoE leaves of ``cfg`` drawn on the card, flat, whole."""
    from repro_torch.models import mlp, weights
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {n: t[0] for n, t in weights.flatten(mlp.init_moe(cfg, gen, "cuda", 1)).items()}


def _ep_block(p: dict, x: torch.Tensor, w: torch.Tensor, cfg, groups=(None, None),
              sent=None) -> dict:
    """``moe_block`` of the flat leaves ``p`` on x under the data and model
    groups, and the backward of ``sum(out * w) + aux``: the output, the aux
    loss, the gradients of x and of every leaf, the collective bytes of the
    forward and of the backward (into ``sent``'s keys) and the host
    seconds of each, synchronised."""
    from repro_torch.models import data_parallel, mlp, tensor_parallel, weights
    leaves = {n: t.detach().clone().requires_grad_() for n, t in p.items()}
    x = x.detach().clone().requires_grad_()
    dg, mg = groups
    res = {}
    with data_parallel.use(dg), tensor_parallel.use(mg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_bytes(sent if sent is not None else collections.Counter()) as c:
            out, aux = mlp.moe_block(weights.unflatten(leaves), x, cfg)
            torch.cuda.synchronize()
            res["forward_bytes"] = sum(c.values())
        res["forward_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with collective_bytes(collections.Counter()) as c:
            ((out.float() * w.float()).sum() + aux).backward()
            torch.cuda.synchronize()
            res["backward_bytes"] = sum(c.values())
        res["backward_s"] = time.perf_counter() - t0
    res.update(out=out.detach(), aux=float(aux.detach()), grads={"x": x.grad, **{
        n: t.grad for n, t in leaves.items()}})
    return res


def _ep_oracle(p: dict, x: torch.Tensor, w: torch.Tensor, cfg, dtype) -> dict:
    """The mesh-free block with ``EP_GROUPS`` groups on x permuted so that
    each device's (batch block, sequence block) of the (1, 2) mesh is one
    group, then un-permuted, in ``dtype``: the expert-parallel result."""
    B, S, D = x.shape
    perm = lambda t: t.reshape(B, EP_GROUPS, S // EP_GROUPS, -1).transpose(0, 1).reshape(
        B * EP_GROUPS, S // EP_GROUPS, -1)
    unperm = lambda t: t.reshape(EP_GROUPS, B, S // EP_GROUPS, -1).transpose(0, 1).reshape(
        B, S, -1)
    from repro_torch.models import mlp, weights
    leaves = {n: t.detach().to(t.dtype if t.dtype == torch.float32 else dtype)
              .clone().requires_grad_() for n, t in p.items()}
    xx = x.detach().to(dtype).clone().requires_grad_()
    out, aux = mlp.moe_block(weights.unflatten(leaves), perm(xx), cfg.with_runtime(dtype=dtype))
    out = unperm(out)
    ((out.float() * w.float()).sum() + aux).backward()
    return {"out": out.detach(), "aux": float(aux.detach()),
            "grads": {"x": xx.grad, **{n: t.grad for n, t in leaves.items()}}}


def tp_ep_block(mesh, cfg) -> dict:
    """(g1) one MoE block of ``cfg`` (layer 0's leaves from seed 0) on x of
    (``TRAIN_BATCH``, ``TRAIN_SEQ``, d_model) bfloat16 with a component
    every token shares (so the default capacity drops), with
    ``models.shard_ctx`` installed: this rank's F slices, forward and
    backward, against the mesh-free block on the permuted tokens
    (``_ep_oracle``) within max(2e-2, 1.5 x floor) of each tensor's
    largest element, the floor being the oracle's own bfloat16 against
    float32; then the same block without the context (the
    reduce-before-combine path of tensor parallelism, ``out_buf``
    all-reduced per group) for its collective bytes and seconds."""
    from repro_torch.launch import train as T
    from repro_torch.models import mlp, shard_ctx
    p = _ep_params(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    D = cfg.d_model
    x = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, D), generator=gen, device="cuda")
         + torch.randn((D,), generator=gen, device="cuda")).to(cfg.dtype)
    w = torch.randn((TRAIN_BATCH, TRAIN_SEQ, D), generator=gen, device="cuda").to(cfg.dtype)
    dg, mg = T.data_group(mesh), T.tp_group(mesh)
    mine = {n: (t if n not in EP_MODEL_DIMS else
                torch.chunk(t, mg.size, EP_MODEL_DIMS[n])[mg.index].contiguous())
            for n, t in p.items()}
    ep_install(mesh, cfg, TRAIN_BATCH)
    real, taken = mlp._expert_parallel, []
    mlp._expert_parallel = lambda *a, **k: taken.append(1) or real(*a, **k)
    try:
        with mlp.count_drops() as drops:
            got = _ep_block(mine, x, w, cfg, (dg, mg))
            dropped, routed = drops.dropped, drops.routed
    finally:
        shard_ctx.clear()
        mlp._expert_parallel = real
    want = _ep_oracle(p, x, w, cfg, cfg.dtype)
    f32 = _ep_oracle(p, x, w, cfg, torch.float32)
    worst = {}
    for key in ("out", *want["grads"]):
        a = got["out"] if key == "out" else got["grads"][key]
        b = want["out"] if key == "out" else want["grads"][key]
        c = f32["out"] if key == "out" else f32["grads"][key]
        if key in EP_MODEL_DIMS:          # this rank's slice of the whole gradient
            b = torch.chunk(b, mg.size, EP_MODEL_DIMS[key])[mg.index]
            c = torch.chunk(c, mg.size, EP_MODEL_DIMS[key])[mg.index]
        big = float(c.float().abs().max())
        floor = float((b.float() - c.float()).abs().max()) / big
        err = float((a.float() - b.float()).abs().max()) / big
        worst[key] = {"rel_err": err, "floor": floor,
                      "tol": max(TOL[torch.bfloat16], EP_FLOOR_FACTOR * floor)}
    aux_oracle = want["aux"]
    del got["out"], got["grads"], want, f32
    megatron = _ep_block(mine, x, w, cfg, (dg, mg))
    return {"aux": got["aux"], "aux_oracle": aux_oracle,
            "ep_calls": len(taken), "dropped": dropped, "routed": routed, "errors": worst,
            **{k: got[k] for k in ("forward_bytes", "backward_bytes", "forward_s",
                                   "backward_s")},
            "megatron": {k: megatron[k] for k in ("forward_bytes", "backward_bytes",
                                                  "forward_s", "backward_s")}}


def tp_ep_train(fa, mesh, cfg) -> dict:
    """(g2) ``train(cfg, mesh=mesh)`` with ``models.shard_ctx`` installed
    and its step built on the kernel path (``make_zero1_step(...,
    "kernel")``): losses, every step profiled (the fused AdamW kernel's
    launches by the wrapper, counted from 0, and by ``torch.profiler``, its
    device time), step seconds (profiled), peak memory and collective
    bytes, and how often the expert-parallel branch ran."""
    from repro_torch.launch import train as T
    from repro_torch.launch.train import train
    from repro_torch.models import mlp, shard_ctx
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    real_make, real_ep = T.make_zero1_step, mlp._expert_parallel
    per_step, profiled, update_ms, taken = [], [], [], []

    def kernel_step(cfg_, opt_cfg, zero, path="jnp"):
        inner = real_make(cfg_, opt_cfg, zero, "kernel")

        def step(model, state, batch):
            before = fa.fused_adamw.launches
            n_prof, us, out = _profile_window(lambda: inner(model, state, batch), 1,
                                              "fused_adamw")
            per_step.append(fa.fused_adamw.launches - before)
            profiled.append(n_prof)
            update_ms.append(us / 1e3)
            return out
        return step
    times, sent = [], collections.Counter()
    T.make_zero1_step = kernel_step
    mlp._expert_parallel = lambda *a, **k: taken.append(1) or real_ep(*a, **k)
    ep_install(mesh, cfg, TRAIN_BATCH)
    fa.fused_adamw.launches = 0
    try:
        with step_seconds(times), collective_bytes(sent):
            out = train(cfg, steps=TP_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
                        device="cuda", mesh=mesh)
        torch.cuda.synchronize()
    finally:
        shard_ctx.clear()
        T.make_zero1_step, mlp._expert_parallel = real_make, real_ep
    res = {"losses": out["losses"], "step_s": times, "launches": fa.fused_adamw.launches,
           "launches_per_step": per_step, "profiled_per_step": profiled,
           "update_device_ms": update_ms, "ep_calls": len(taken),
           "leaves": len(out["opt_state"].m), "peak_bytes": torch.cuda.max_memory_allocated(),
           "collective_bytes": dict(sent)}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_probe() -> dict:
    """Which collectives ``gloo`` takes on card tensors, per dtype (every
    rank calls it; "ok" or the error), and the milliseconds of an
    all-reduce and an all-gather of 50 MB of float32 (5 calls each)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        x = torch.ones(8, dtype=dtype, device="cuda")
        cases = {
            "all_reduce_sum": lambda: dist.all_reduce(x),
            "all_reduce_max": lambda: dist.all_reduce(x, op=dist.ReduceOp.MAX),
            "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x),
            "reduce_scatter": lambda: dist.reduce_scatter(
                torch.empty(8 // world, dtype=dtype, device="cuda"),
                [c.contiguous() for c in torch.chunk(x, world)]),
            "gather": lambda: dist.gather(x, [torch.empty_like(x) for _ in range(world)]
                                          if dist.get_rank() == 0 else None, dst=0),
            "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
            "broadcast": lambda: dist.broadcast(x, 0)}
        for name, call in cases.items():
            try:
                call()
                torch.cuda.synchronize()
                out[f"{name}/{str(dtype)[6:]}"] = "ok"
            except Exception as e:        # a collective gloo lacks: recorded, not hidden
                out[f"{name}/{str(dtype)[6:]}"] = f"{type(e).__name__}: {str(e)[:80]}"
            dist.barrier()
    x = torch.ones(50 * (1 << 20) // 4, device="cuda")
    parts = [torch.empty_like(x) for _ in range(world)]
    for name, call in (("all_reduce_50MB_ms", lambda: dist.all_reduce(x)),
                       ("all_gather_50MB_ms", lambda: dist.all_gather(parts, x))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 5 * 1e3
    return out


def tp_rank(rank: int, store: str, plain: dict, out_dir: str) -> None:
    """One of the two ranks of the tp phase, on ``cuda:0``, in a ``gloo``
    group of its own making: (f), (a), (b), (c), (d), (g1), (g2), (h1) and
    (h2) on the (1, 2) mesh, (h3) after (h1), its results pickled to
    ``out_dir``."""
    import pickle
    from datetime import timedelta
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=timedelta(seconds=TP_TIMEOUT_S))
    try:
        from repro_torch.kernels import fused_adamw as fa
        from repro_torch.launch.mesh import make_host_mesh
        res = {"probe": tp_probe()}
        mesh = make_host_mesh(1, 2)
        res.update(mesh=str(mesh), backend=dist.get_backend())
        res["f"] = tp_init(mesh, tp_init_config(), {"sums": plain["init_sums"]})
        t0 = time.perf_counter()
        res["a"], _final = tp_train(mesh, tp_gemma_config(), plain["gemma"])
        del _final
        res["a"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["b"] = tp_kernel(fa, mesh, tp_gemma_config())
        res["b"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt_dir = os.path.join(out_dir, "ckpt")
        parts = collections.defaultdict(float)
        with checkpoint_seconds(parts):
            res["c"], final = tp_train(mesh, tp_olmoe_config(), plain["olmoe"], spy=True,
                                       ckpt_dir=ckpt_dir)
            res["c"]["seconds"] = time.perf_counter() - t0
            res["c"]["checkpoint_s"] = dict(parts)
            parts.clear()
            res["d"] = tp_resume(mesh, tp_olmoe_config(), ckpt_dir, res["c"]["losses"][-1],
                                 final)
            res["d"]["checkpoint_s"] = dict(parts)
        del final
        t0 = time.perf_counter()
        res["g1"] = tp_ep_block(mesh, tp_ep_config())
        res["g1"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["g2"] = tp_ep_train(fa, mesh, tp_ep_config(EP_CAPACITY))
        res["g2"]["seconds"] = time.perf_counter() - t0
        for leg in ("h1", "h2"):
            t0 = time.perf_counter()
            res[leg] = tp_serve(mesh, tp_serve_config(leg), leg, plain["serve"][leg],
                                keep=leg == "h1")
            res[leg]["seconds"] = time.perf_counter() - t0
            if leg == "h1":              # (h3) on (h1)'s slices, then they go
                t0 = time.perf_counter()
                res["h3"] = tp_masked(mesh, tp_serve_config(leg), res[leg].pop("model"),
                                      plain["masked"])
                res["h3"]["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def tp_check_losses(what: str, got: list, want: list) -> None:
    if not all(math.isfinite(x) for x in got) or len(got) != len(want):
        raise AssertionError(f"tp {what}: losses {got} against {want}")
    for i, (a, b) in enumerate(zip(got, want)):
        tol = TP_LOSS1_RTOL if i == 0 else TP_LOSS_RTOL
        if abs(a - b) > tol * abs(b):
            raise AssertionError(f"tp {what}: step {i + 1} loss {a} against the mesh-free "
                                 f"{b} (rtol {tol})")


def tp_c14(sp, mesh) -> dict:
    """(e) ROADMAP C14 on the card: uint16 and uint32 ``add``,
    ``subtract``, ``multiply``, ``mod`` (zero divisors give 0), ``square``,
    ``abs``, ``sign`` and ``negative`` at n = 2**24, values near the top of
    the width so that they wrap, on ``cuda`` (the split-pipeline kernel),
    ``sharded`` (the one-rank mesh) and ``fused``, against the same ops on
    int64 masked to the width."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import plan_cache
    gen = torch.Generator(device="cuda").manual_seed(14)
    n, out = C13_N, {}
    for dtype, bits in ((torch.uint16, 16), (torch.uint32, 32)):
        hi = 1 << bits
        x64 = torch.cat([torch.randint(hi - 4096, hi, (n // 2,), generator=gen, device="cuda"),
                         torch.randint(0, 4096, (n - n // 2,), generator=gen, device="cuda")])
        y64 = torch.randint(0, hi, (n,), generator=gen, device="cuda")
        y64[::5] = 0
        x, y, mask = x64.to(dtype), y64.to(dtype), hi - 1
        want = {"add": (x64 + y64) & mask, "subtract": (x64 - y64) & mask,
                "multiply": (x64 * y64) & mask,
                "mod": torch.where(y64 == 0, 0, torch.remainder(x64, torch.where(
                    y64 == 0, 1, y64))),
                "square": (x64 * x64) & mask, "abs": x64, "sign": (x64 != 0).to(torch.int64),
                "negative": (-x64) & mask}
        unary = ("square", "abs", "sign", "negative")
        calls = {op: (lambda x, y, op=op: getattr(anp, op)(x)) if op in unary
                 else (lambda x, y, op=op: getattr(anp, op)(x, y)) for op in want}
        for ex, kw in (("cuda", {}), ("sharded", {"mesh": mesh}), ("fused", {})):
            plan_cache.clear()
            sp.reset_counts()
            for op, fn in calls.items():
                _r, (got,), ctx = run_observed(fn, {"x": x, "y": y}, ex,
                                               batch_elements=n // 8, **kw)
                if got.dtype != dtype or not torch.equal(got.to(torch.int64), want[op]):
                    raise AssertionError(f"tp (e) {ex} {op}({str(dtype)[6:]}): {got.dtype}")
                if ex == "cuda" and (ctx.stats.get("cuda_fallback_stages", 0)
                                     or not ctx.stats.get("cuda_stages", 0)):
                    raise AssertionError(f"tp (e) cuda {op}: {dict(ctx.stats)}")
            if ex == "cuda" and sp.split_pipeline.launches != len(calls):
                raise AssertionError(f"tp (e) cuda {str(dtype)[6:]}: "
                                     f"{sp.split_pipeline.launches} launches for {len(calls)}")
            out[f"{ex}/{str(dtype)[6:]}"] = {"ops": len(calls), "split_pipeline_launches":
                                            sp.split_pipeline.launches}
    plan_cache.clear()
    return out


def tp_c15() -> dict:
    """(e) ROADMAP C15 on the card: a step that allocates ``C15_BYTES`` and
    raises an injected ``torch.OutOfMemoryError`` is retried by
    ``with_retries``, and at the retry's start ``memory_allocated`` is back
    to its value before the failed attempt."""
    from repro_torch.core.resilience import with_retries
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    seen: list = []

    def step():
        if seen:
            seen.append(torch.cuda.memory_allocated())
            return "retried"
        held = torch.ones(C15_BYTES // 4, device="cuda")
        seen.append(torch.cuda.memory_allocated())
        raise torch.OutOfMemoryError(f"injected: out of memory with {held.numel() * 4} "
                                     "bytes held by the attempt")
    result = with_retries(step, retries=1)
    during, at_retry = seen
    if result != "retried" or at_retry != before or during - before < C15_BYTES:
        raise AssertionError(f"tp (e) C15: allocated {before} before, {during} in the failed "
                             f"attempt, {at_retry} at the retry's start")
    return {"before": before, "during": during, "at_retry": at_retry}


def tp_check_ep(res: list, plain: dict, init: dict, card: str) -> None:
    """(f), (g1) and (g2) from both ranks' results: checked, then printed."""
    gb = lambda b: round(b / 1e9, 2)
    for r, rr in enumerate(res):
        f = rr["f"]
        if f["differ"] or f["slice_bytes"] != init["slice_bytes"] or \
                f["peak_bytes"] > f["slice_bytes"] + init["largest_leaf_bytes"]:
            raise AssertionError(f"tp (f) rank {r}: {f} against {init}")
    f0 = res[0]["f"]
    log(f"[tp] (f) C16: {tp_init_config().name} at published widths and depth "
        f"({tp_init_config().n_layers} layers) on a (1, 2) mesh: each rank drew its slices "
        f"straight from the seed (train.rank_params) in {[round(rr['f']['seconds'], 2) for rr in res]} s; "
        f"peak device memory across the init per rank {[gb(rr['f']['peak_bytes']) for rr in res]} GB "
        f"for {gb(f0['slice_bytes'])} GB of slices (the bound: slices + the largest leaf, "
        f"{init['largest_leaf']} {gb(init['largest_leaf_bytes'])} GB); all {f0['leaves']} "
        f"leaves bit-equal (checksums) to the slices of the mesh-free init; that init, "
        f"{gb(init['whole_bytes'])} GB whole, then rank 0's slices cut from it (the path "
        f"before C16) peaked at {gb(init['whole_then_slice_peak_bytes'])} GB in "
        f"{init['whole_then_slice_s']:.2f} s")
    cfg = tp_ep_config()
    for r, rr in enumerate(res):
        g = rr["g1"]
        bad = {k: v for k, v in g["errors"].items() if not v["rel_err"] <= v["tol"]}
        if bad or g["ep_calls"] != 1 or not 0 < g["dropped"] < g["routed"] or \
                abs(g["aux"] - g["aux_oracle"]) > 1e-4 * abs(g["aux_oracle"]):
            raise AssertionError(f"tp (g1) rank {r}: {g}")
    g = res[0]["g1"]
    log(f"[tp] (g1) one {cfg.name} MoE block at published widths (D {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens bfloat16, moe_groups {EP_GROUPS}, capacity factor "
        f"{cfg.moe.capacity_factor} ({g['dropped']} of {g['routed']} assignments dropped), "
        f"shard_ctx installed: the expert-parallel branch on both ranks; max |err| / max|ref| "
        f"against the mesh-free block on the permuted tokens "
        f"{json.dumps({k: round(v['rel_err'], 5) for k, v in g['errors'].items()})} within "
        f"max(2e-2, 1.5 x floor), floors (bfloat16 against float32) "
        f"{json.dumps({k: round(v['floor'], 5) for k, v in g['errors'].items()})}; aux "
        f"{g['aux']:.6f} against {g['aux_oracle']:.6f}; collective bytes forward / backward "
        f"{g['forward_bytes']} / {g['backward_bytes']} (combine, then reduce) against "
        f"{g['megatron']['forward_bytes']} / {g['megatron']['backward_bytes']} without the "
        f"context (out_buf reduced per group); host ms forward / backward "
        f"{1e3 * g['forward_s']:.1f} / {1e3 * g['backward_s']:.1f} against "
        f"{1e3 * g['megatron']['forward_s']:.1f} / {1e3 * g['megatron']['backward_s']:.1f}; "
        f"{g['seconds']:.1f} s")
    cfg = tp_ep_config(EP_CAPACITY)
    want = plain["ep"]
    calls = TP_MOE_LAYERS * TP_STEPS * (2 if cfg.remat else 1)
    for r, rr in enumerate(res):
        g = rr["g2"]
        if g["losses"] != res[0]["g2"]["losses"] or g["ep_calls"] != calls or \
                g["launches_per_step"] != [g["leaves"]] * TP_STEPS or \
                g["profiled_per_step"] != [g["leaves"]] * TP_STEPS or \
                g["launches"] != g["leaves"] * TP_STEPS:
            raise AssertionError(f"tp (g2) rank {r}: {g}")
    g = res[0]["g2"]
    if not all(math.isfinite(x) for x in g["losses"]) or len(g["losses"]) != TP_STEPS:
        raise AssertionError(f"tp (g2): losses {g['losses']}")
    for i, (a, b) in enumerate(zip(g["losses"], want["losses"])):
        tol = EP_LOSS1_RTOL if i == 0 else TP_LOSS_RTOL
        if abs(a - b) > tol * abs(b):
            raise AssertionError(f"tp (g2): step {i + 1} loss {a} against the mesh-free {b} "
                                 f"(rtol {tol})")
    per_step = {k: v // TP_STEPS for k, v in g["collective_bytes"].items()}
    log(f"[tp] (g2) train(mesh=make_host_mesh(1, 2)) of {cfg.name} at published widths, "
        f"{cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ}, capacity factor "
        f"{cfg.moe.capacity_factor} (nothing drops), shard_ctx installed, the step on the "
        f"kernel path: losses {g['losses']} against the mesh-free train()'s {want['losses']} "
        f"(step 1 within rtol {EP_LOSS1_RTOL}, steps 2-3 within {TP_LOSS_RTOL}); the "
        f"expert-parallel branch {g['ep_calls']} times per rank (forward and remat); "
        f"fused_adamw launches per step {g['launches_per_step']} (wrapper), "
        f"{g['profiled_per_step']} (torch.profiler) on each rank, {g['leaves']} leaves, device "
        f"ms per step {[round(t, 3) for t in g['update_device_ms']]} on rank 0; step ms "
        f"(profiled) {[round(1e3 * t, 1) for t in g['step_s']]} against "
        f"{[round(1e3 * t, 1) for t in want['step_s']]} mesh-free; peak device memory per rank "
        f"{[gb(rr['g2']['peak_bytes']) for rr in res]} GB against {gb(want['peak_bytes'])} GB "
        f"mesh-free; collective bytes per step on rank 0 {per_step}; {g['seconds']:.1f} s; "
        f"{card}")


def tp_serve_plain(cfg, leg: str) -> dict:
    """(h)'s reference, in this process before the ranks start: ``cfg``'s
    mesh-free model from seed 0 on the card, a prompt of ``TP_SERVE[leg]``
    random tokens (seed 1), prefill on the kernel and then greedy decode
    steps, with the KV cache in ``TP_SERVE_BLOCKS`` blocks.  Kept on the
    host: the prompt, the tokens, each step's last logits, the first and
    last layers' K and V after the last step, the floors (the prefill's
    logit distance to the same prefill on the plain path, over its
    max|logit|, and the same for those layers' K and V), the KV cache's
    bytes and the times.  The model is freed before the ranks start."""
    from repro_torch.models import transformer as tfm
    B, S, steps = TP_SERVE[leg]
    gc.collect()
    torch.cuda.empty_cache()
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    caches = tfm.init_caches(cfg, B, S + steps, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = tfm.prefill(model, cfg, tokens=prompt, caches=caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    last = (0, cfg.n_layers - 1)
    dist = lambda a, b: float((a.float() - b.float()).abs().max() / b.float().abs().max())
    plain, other = tfm.prefill(model, cfg, tokens=prompt, use_kernel=False,
                               caches=tfm.init_caches(cfg, B, S + steps, device="cuda"))
    floor = dist(plain, logits)
    cache_floor = {i: max(dist(other.k[i], caches.k[i]), dist(other.v[i], caches.v[i]))
                   for i in last}
    del plain, other
    outs, step_s = [logits[:, -1].float().cpu()], []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    tokens = [tok]
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = tfm.decode_step(model, cfg, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        outs.append(logits[:, -1].float().cpu())
        tokens.append(tok)
    layers = {i: (caches.k[i].cpu(), caches.v[i].cpu()) for i in last}
    out = {"prompt": prompt.cpu(), "tokens": torch.cat(tokens, 1).cpu(), "logits": outs,
           "layers": layers, "floor": floor, "cache_floor": cache_floor,
           "prefill_s": prefill_s, "step_s": step_s,
           "kv_bytes": 2 * caches.k.numel() * caches.k.element_size()}
    del caches, logits
    if leg == "h1":
        out["masked"] = tp_masked_plain(cfg, model, prompt)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_masked_plain(cfg, model, prompt: torch.Tensor) -> dict:
    """(h3)'s reference, mesh-free on the card, on (h1)'s model: (h1)'s
    prompt right-padded to ``TP_MASKED_PLENS`` (pad positions 0) through
    the continuous batcher's bucket, ``serving._make_prefill_bucket(cfg,
    True)``, into a per-slot cache of ``S + TP_MASKED_STEPS`` positions in
    ``TP_SERVE_BLOCKS`` blocks, then per-slot greedy decode steps, each
    timed.  Kept on the host as ``tp_serve_plain`` keeps them, with every
    layer's ``length`` and ``start`` and the prefill's flash launches (a
    masked prefill stays off the kernel)."""
    from repro_torch.core import serving
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models import transformer as tfm
    B, S, _ = TP_SERVE["h1"]
    plens = torch.tensor(TP_MASKED_PLENS, dtype=torch.int32, device="cuda")
    prompt = torch.where(torch.arange(S, device="cuda")[None] < plens[:, None], prompt, 0)
    caches = tfm.init_caches(cfg, B, S + TP_MASKED_STEPS, per_slot=True, device="cuda")
    fl.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = serving._make_prefill_bucket(cfg, True)(model, prompt, plens, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = fl.flash_attention.launches
    outs, step_s = [logits[:, -1].float().cpu()], []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    tokens = [tok]
    for _ in range(TP_MASKED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = tfm.decode_step(model, cfg, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        outs.append(logits[:, -1].float().cpu())
        tokens.append(tok)
    out = {"prompt": prompt.cpu(), "plens": plens.cpu(), "tokens": torch.cat(tokens, 1).cpu(),
           "logits": outs, "layers": {i: (caches.k[i].cpu(), caches.v[i].cpu())
                                      for i in (0, cfg.n_layers - 1)},
           "length": caches.length.cpu(), "start": caches.start.cpu(), "launches": launches,
           "prefill_s": prefill_s, "step_s": step_s,
           "kv_bytes": 2 * caches.k.numel() * caches.k.element_size()}
    del caches, logits
    return out


def tp_masked(mesh, cfg, model, plain: dict) -> dict:
    """(h3) the continuous batcher's masked bucket under the groups on this
    rank's slices of (h1) (``model``, freed here):
    ``serving._make_prefill_bucket(cfg, True)`` on the rank's rows of the
    right-padded prompt and ``plens`` into its per-slot cache block
    (``init_caches(per_slot=True)``), timed, its flash launches by the
    wrapper's counter (set to 0 just before), its collective bytes; then
    the per-slot decode steps fed the mesh-free run's tokens, the first
    counted and not timed, the later ones timed, as (h1)'s; each step's
    last logits, the first and last layers' cache block, every layer's
    ``length`` and ``start``, peak device memory (the slices included) and
    the KV cache's bytes."""
    from repro_torch.core import serving
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.launch import train as T
    from repro_torch.models import data_parallel, tensor_parallel
    from repro_torch.models import transformer as tfm
    B, S, _ = TP_SERVE["h1"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dg, mg = T.data_group(mesh), T.tp_group(mesh)
    prompt, plens, tokens = (dg.local_rows(plain[k].cuda()) for k in ("prompt", "plens", "tokens"))
    res = {}
    with data_parallel.use(dg), tensor_parallel.use(mg):
        params = tensor_parallel.serving_view(model, cfg)
        caches = tfm.init_caches(cfg, B, S + TP_MASKED_STEPS, per_slot=True, device="cuda")
        res["kv_shape"] = tuple(caches.k.shape)
        res["kv_bytes"] = 2 * caches.k.numel() * caches.k.element_size()
        fl.reset_counts()
        tensor_parallel.reset_serving_bytes()
        sent = collections.Counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_bytes(sent):
            logits, caches = serving._make_prefill_bucket(cfg, True)(params, prompt, plens,
                                                                     caches)
            torch.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        res["launches"] = fl.flash_attention.launches
        res["prefill_bytes"], res["prefill_serving_bytes"] = dict(sent), dict(
            tensor_parallel.serving_bytes)
        outs, step_s = [logits[:, -1].float().cpu()], []
        sent = collections.Counter()
        tensor_parallel.reset_serving_bytes()
        with collective_bytes(sent):     # step 1: its bytes counted, not timed
            logits, caches = tfm.decode_step(params, cfg, tokens[:, :1], caches)
        outs.append(logits[:, -1].float().cpu())
        res["decode_bytes"] = dict(sent)
        res["decode_serving_bytes"] = dict(tensor_parallel.serving_bytes)
        for i in range(1, TP_MASKED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = tfm.decode_step(params, cfg, tokens[:, i:i + 1], caches)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            outs.append(logits[:, -1].float().cpu())
        res["step_s"], res["logits"] = step_s, outs
        res["layers"] = {i: (caches.k[i].cpu(), caches.v[i].cpu())
                         for i in (0, cfg.n_layers - 1)}
        res["length"], res["start"] = caches.length.cpu(), caches.start.cpu()
        torch.cuda.synchronize()
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["index"] = mg.index
    del model, params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_serve(mesh, cfg, leg: str, plain: dict, keep: bool = False) -> dict:
    """(h) tensor-parallel serving on this rank of the (1, 2) mesh, under
    the groups ``train(mesh=...)`` installs: the rank's slices drawn from
    seed 0 (``weights.init_slices``), its KV cache block
    (``transformer.init_caches``), the mesh-free prompt prefilled twice
    (timed, then under ``torch.profiler`` with the first flash launch held
    in place against its plain version, ``arch_window_calls``), and the
    decode steps fed the mesh-free run's tokens.  Each prefill's flash
    launches by the wrappers' counters (set to 0 just before), the second's
    also by the profiler; each step's last logits; the first and last
    layers' cache block; collective bytes per prefill and of the first
    step (which is not timed: the later steps are, as ``tp_serve_plain``
    times them, the logits copied to the host after the clock stops); peak
    device memory; the KV cache's bytes.  Then ``lm.greedy_generate`` of
    ``TP_SERVE_GREEDY`` tokens from the same prompt under the groups.
    ``keep`` leaves the slices in the result, under ``"model"``."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ref
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import train as T
    from repro_torch.models import data_parallel, lm, tensor_parallel, weights
    from repro_torch.models import transformer as tfm
    B, S, steps = TP_SERVE[leg]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dg, mg = T.data_group(mesh), T.tp_group(mesh)
    dims = shd.model_dims(tfm.init_model(cfg, None, "meta"), mesh)
    model = weights.init_slices(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                                dims, mg.index, mg.size)
    prompt, tokens = plain["prompt"].cuda(), plain["tokens"].cuda()
    res = {"slice_bytes": sum(p.numel() * p.element_size()
                              for p in weights.leaves(model).values())}
    with data_parallel.use(dg), tensor_parallel.use(mg):
        params = tensor_parallel.serving_view(model, cfg)
        caches = tfm.init_caches(cfg, B, S + steps, device="cuda")
        res["kv_shape"] = tuple(caches.k.shape)
        res["kv_bytes"] = 2 * caches.k.numel() * caches.k.element_size()
        run = lambda: tfm.prefill(params, cfg, tokens=prompt, caches=caches)
        fl.reset_counts()
        tensor_parallel.reset_serving_bytes()
        sent = collections.Counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_bytes(sent):
            logits, caches = run()
            torch.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        res["launches"] = [fl.flash_attention.launches]
        res["variants"] = [dict(fl.flash_attention.variant_launches)]
        res["prefill_bytes"], res["prefill_serving_bytes"] = dict(sent), dict(
            tensor_parallel.serving_bytes)
        fl.reset_counts()
        _seen, held, undo = arch_window_calls(ref, held=1)
        try:
            n_prof, _us, (logits, caches) = _profile_window(run, 1, "flash_attention")
        finally:
            undo()
        res["launches"].append(fl.flash_attention.launches)
        res["variants"].append(dict(fl.flash_attention.variant_launches))
        res["profiled"], res["held"] = n_prof, held
        outs, step_s = [logits[:, -1].float().cpu()], []
        sent = collections.Counter()
        tensor_parallel.reset_serving_bytes()
        with collective_bytes(sent):     # step 1: its bytes counted, not timed
            logits, caches = tfm.decode_step(params, cfg, tokens[:, :1], caches)
        outs.append(logits[:, -1].float().cpu())
        res["decode_bytes"] = dict(sent)
        res["decode_serving_bytes"] = dict(tensor_parallel.serving_bytes)
        for i in range(1, steps):        # timed as tp_serve_plain times its steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = tfm.decode_step(params, cfg, tokens[:, i:i + 1], caches)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            outs.append(logits[:, -1].float().cpu())
        res["step_s"], res["logits"] = step_s, outs
        res["layers"] = {i: (caches.k[i].cpu(), caches.v[i].cpu())
                         for i in (0, cfg.n_layers - 1)}
        torch.cuda.synchronize()
        res["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        del caches
        res["greedy"] = lm.greedy_generate(params, cfg, prompt, TP_SERVE_GREEDY).cpu()
    res["index"] = mg.index
    if keep:
        res["model"] = model
    del model, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_check_masked(res: list, plain: dict, want: dict, h1: dict, card: str) -> dict:
    """(h3) from both ranks' results: printed, then checked against the
    mesh-free run ``want`` (both off the kernel): 0 flash launches per
    masked prefill on every rank and mesh-free; logits of every step by
    (h1)'s serving rule, max(2e-2, ``EP_FLOOR_FACTOR`` x (h1)'s floor) of
    max|ref| (the bf16 distance of two attention orders of this model's
    prefill), the first and last layers' cache block by (h1)'s cache rule,
    greedy tokens equal or a near-tie (``tokens_agree``); every layer's
    per-slot ``length`` (the prompt lengths plus the steps) and ``start``
    equal; each rank's KV cache one block of the per-slot cache."""
    cfg = tp_serve_config("h1")
    B, S, _ = TP_SERVE["h1"]
    L, steps = cfg.n_layers, TP_MASKED_STEPS
    pct = lambda xs, q: sorted(xs)[min(len(xs) - 1, int(q * len(xs)))]
    rule = max(TOL[cfg.dtype], EP_FLOOR_FACTOR * plain["floor"])
    cache_rule = {i: max(TOL[cfg.dtype], EP_FLOOR_FACTOR * f)
                  for i, f in plain["cache_floor"].items()}
    blk = -(-(S + steps) // TP_SERVE_BLOCKS)
    lengths = torch.tensor(TP_MASKED_PLENS, dtype=torch.int32) + steps
    failed, ties = [], []
    worst = {"logits": 0.0, "cache": {i: 0.0 for i in cache_rule}}
    if want["launches"] != 0:
        failed.append(f"(h3) mesh-free: {want['launches']} flash launches in a masked prefill")
    if not (torch.equal(want["length"], lengths.expand(L, B)) and not want["start"].any()):
        failed.append(f"(h3) mesh-free: length {want['length'][0].tolist()}, start "
                      f"{want['start'][0].tolist()}")
    for r, rr in enumerate(res):
        got = rr["h3"]
        if got["launches"] != 0:
            failed.append(f"(h3) rank {r}: {got['launches']} flash launches in a masked prefill")
        if got["kv_shape"] != (L, 1, blk, B, cfg.attn.n_kv_heads, cfg.attn.head_dim):
            failed.append(f"(h3) rank {r}: KV cache {got['kv_shape']}")
        if not (torch.equal(got["length"], want["length"])
                and torch.equal(got["start"], want["start"])):
            failed.append(f"(h3) rank {r}: length {got['length'][0].tolist()}, start "
                          f"{got['start'][0].tolist()} against {want['length'][0].tolist()}, "
                          f"{want['start'][0].tolist()}")
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            scale = float(w.abs().max())
            d = float((g - w).abs().max()) / scale
            worst["logits"] = max(worst["logits"], d)
            if not d <= rule:
                failed.append(f"(h3) rank {r} step {i}: logits {d:.3e} of max|ref| > {rule:.3e}")
            try:
                ties += tokens_agree(w[:, None], torch.argmax(g, -1),
                                     max(plain["floor"], d) * scale)
            except AssertionError as e:
                failed.append(f"(h3) rank {r} step {i}: {e}")
        m = got["index"]
        for layer, kv in got["layers"].items():
            for g, w in zip(kv, want["layers"][layer]):
                w = w[m:m + 1].float()
                d = float((g.float() - w).abs().max() / w.abs().max())
                worst["cache"][layer] = max(worst["cache"][layer], d)
                if not d <= cache_rule[layer]:
                    failed.append(f"(h3) rank {r}: layer {layer}'s cache block {d:.3e} of "
                                  f"max|ref| > {cache_rule[layer]:.3e}")
    g0 = res[0]["h3"]
    steps_ms = [1e3 * t for t in g0["step_s"]]
    ref_ms = [1e3 * t for t in want["step_s"][1:]]
    line = {"prefill_ms": 1e3 * g0["prefill_s"], "prefill_ms_mesh_free": 1e3 * want["prefill_s"],
            "decode_ms_p50": pct(steps_ms, 0.5), "decode_ms_p99": pct(steps_ms, 0.99),
            "decode_ms": steps_ms, "decode_ms_mesh_free_p50": pct(ref_ms, 0.5),
            "h1_decode_ms_p50": h1["decode_ms_p50"], "h1_decode_ms_p99": h1["decode_ms_p99"],
            "h1_prefill_ms": h1["prefill_ms"],
            "prefill_bytes": g0["prefill_bytes"], "decode_bytes": g0["decode_bytes"],
            "prefill_serving_bytes": g0["prefill_serving_bytes"],
            "decode_serving_bytes": g0["decode_serving_bytes"],
            "peak_bytes": [rr["h3"]["peak_bytes"] for rr in res], "kv_bytes": g0["kv_bytes"],
            "kv_bytes_mesh_free": want["kv_bytes"], "rule": rule, "cache_rule": cache_rule,
            "worst": worst, "near_ties": ties, "launches_per_rank_per_prefill":
            [rr["h3"]["launches"] for rr in res], "length": g0["length"][0].tolist(),
            "seconds": [rr["h3"]["seconds"] for rr in res]}
    gb = lambda b: round(b / 1e9, 3)
    log(f"[tp] (h3) the continuous batcher's masked bucket (serving._make_prefill_bucket(cfg, "
        f"True)) under the groups on (h1)'s slices of {cfg.name}, {L} layers, bfloat16: "
        f"{B} rows right-padded to {S} (plens {list(TP_MASKED_PLENS)}), a per-slot cache of "
        f"{S + steps} positions in {TP_SERVE_BLOCKS} blocks ({g0['kv_shape']} per rank); "
        f"masked prefill {line['prefill_ms']:.1f} ms (mesh-free "
        f"{line['prefill_ms_mesh_free']:.1f}; (h1) unmasked {h1['prefill_ms']:.1f}); flash "
        f"launches per rank per masked prefill {line['launches_per_rank_per_prefill']} "
        f"(mesh-free {want['launches']}); {steps} per-slot decode steps, the last "
        f"{steps - 1} timed: p50 / p99 {line['decode_ms_p50']:.1f} / "
        f"{line['decode_ms_p99']:.1f} ms ((h1) {h1['decode_ms_p50']:.1f} / "
        f"{h1['decode_ms_p99']:.1f}; mesh-free p50 {line['decode_ms_mesh_free_p50']:.1f}); "
        f"logits of every step within {rule:.3e} of max|ref|: worst {worst['logits']:.3e}; "
        f"cache blocks of layers {list(cache_rule)} worst "
        f"{[round(v, 6) for v in worst['cache'].values()]} within "
        f"{[round(v, 6) for v in cache_rule.values()]}; greedy tokens equal but near-ties "
        f"{ties}; length {line['length']} and start equal on both ranks and mesh-free; "
        f"collective bytes on rank 0 per masked prefill {line['prefill_bytes']} "
        f"({line['prefill_serving_bytes']}), per decode step {line['decode_bytes']} "
        f"({line['decode_serving_bytes']}); peak device memory per rank (slices included) "
        f"{[gb(b) for b in line['peak_bytes']]} GB; KV cache per rank {gb(g0['kv_bytes'])} GB "
        f"against {gb(want['kv_bytes'])} mesh-free; "
        f"{[round(x, 1) for x in line['seconds']]} s; {card}")
    if failed:
        raise AssertionError("tp (h3): " + "; ".join(failed))
    return line


def tp_check_serve(res: list, plain: dict, card: str) -> dict:
    """(h1) and (h2) from both ranks' results: printed, then checked.
    Logits of every step against the mesh-free run by the serving rule,
    max(tol, ``EP_FLOOR_FACTOR`` x floor) of max|ref| (tol 2e-2 in
    bfloat16, 2e-5 in float32), and the first and last layers' cache block
    by the same rule with those layers' cache floors; greedy tokens of the
    decode steps and of ``lm.greedy_generate`` under the groups equal or a
    near-tie (``tokens_agree``); one flash launch per layer per
    prefill on every rank, by the wrappers and the profiler, of the
    dtype's variant, the first held in place within the kernel's
    tolerance."""
    gb = lambda b: round(b / 1e9, 3)
    pct = lambda xs, q: sorted(xs)[min(len(xs) - 1, int(q * len(xs)))]
    entry, failed = {}, []
    for leg in ("h1", "h2"):
        cfg = tp_serve_config(leg)
        want = plain[leg]
        B, S, steps = TP_SERVE[leg]
        L = cfg.n_layers
        bf16 = cfg.dtype == torch.bfloat16
        rule = max(TOL[cfg.dtype], EP_FLOOR_FACTOR * want["floor"])
        cache_rule = {i: max(TOL[cfg.dtype], EP_FLOOR_FACTOR * f)
                      for i, f in want["cache_floor"].items()}
        variant = "tc" if bf16 else "simt"
        blk = -(-(S + steps) // TP_SERVE_BLOCKS)
        worst, ties, greedy_ties = {"logits": 0.0, "cache": {i: 0.0 for i in cache_rule}}, [], []
        for r, rr in enumerate(res):
            got = rr[leg]
            if got["launches"] != [L, L] or got["profiled"] != L or \
                    any(v[variant] != L for v in got["variants"]):
                failed.append(f"({leg}) rank {r}: flash launches {got['launches']}, variants "
                              f"{got['variants']}, profiled {got['profiled']} for {L} layers")
            if len(got["held"]) != 1 or \
                    not got["held"][0] <= (ATTN_REL_TOL if bf16 else TOL[torch.float32]):
                failed.append(f"({leg}) rank {r}: the first launch against the plain version "
                              f"{got['held']}")
            if got["kv_shape"] != (L, 1, blk, B, cfg.attn.n_kv_heads, cfg.attn.head_dim):
                failed.append(f"({leg}) rank {r}: KV cache {got['kv_shape']}")
            for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
                scale = float(w.abs().max())
                d = float((g - w).abs().max()) / scale
                worst["logits"] = max(worst["logits"], d)
                if not d <= rule:
                    failed.append(f"({leg}) rank {r} step {i}: logits {d:.3e} of max|ref| > "
                                  f"{rule:.3e}")
                try:
                    ties += tokens_agree(w[:, None], torch.argmax(g, -1),
                                         max(want["floor"], d) * scale)
                except AssertionError as e:
                    failed.append(f"({leg}) rank {r} step {i}: {e}")
            for i in range(TP_SERVE_GREEDY):     # lm.greedy_generate under the groups
                w = want["logits"][i]
                try:
                    flipped = tokens_agree(w[:, None], got["greedy"][:, i],
                                           max(want["floor"], worst["logits"]) *
                                           float(w.abs().max()))
                except AssertionError as e:
                    failed.append(f"({leg}) rank {r} greedy_generate token {i}: {e}")
                    break
                greedy_ties += flipped
                if flipped:                      # later tokens follow another prefix
                    break
            m = got["index"]
            for layer, kv in got["layers"].items():
                for g, w in zip(kv, want["layers"][layer]):
                    w = w[m:m + 1].float()
                    d = float((g.float() - w).abs().max() / w.abs().max())
                    worst["cache"][layer] = max(worst["cache"][layer], d)
                    if not d <= cache_rule[layer]:
                        failed.append(f"({leg}) rank {r}: layer {layer}'s cache block {d:.3e} "
                                      f"of max|ref| > {cache_rule[layer]:.3e}")
        g0 = res[0][leg]
        steps_ms = [1e3 * t for t in g0["step_s"]]
        ref_ms = [1e3 * t for t in want["step_s"][1:]]   # the steps tp_serve times
        line = {"prefill_ms": 1e3 * g0["prefill_s"],
                "prefill_ms_mesh_free": 1e3 * want["prefill_s"],
                "decode_ms_p50": pct(steps_ms, 0.5), "decode_ms_p99": pct(steps_ms, 0.99),
                "decode_ms": steps_ms, "decode_ms_mesh_free_p50": pct(ref_ms, 0.5),
                "prefill_bytes": g0["prefill_bytes"], "decode_bytes": g0["decode_bytes"],
                "prefill_serving_bytes": g0["prefill_serving_bytes"],
                "decode_serving_bytes": g0["decode_serving_bytes"],
                "peak_bytes": [rr[leg]["peak_bytes"] for rr in res],
                "slice_bytes": g0["slice_bytes"], "kv_bytes": g0["kv_bytes"],
                "kv_bytes_mesh_free": want["kv_bytes"], "floor": want["floor"],
                "cache_floor": want["cache_floor"], "rule": rule, "cache_rule": cache_rule,
                "worst": worst, "near_ties": ties, "held": g0["held"][0],
                "greedy": g0["greedy"].tolist(), "greedy_near_ties": greedy_ties,
                "launches_per_rank_per_prefill": g0["launches"][0], "variant": variant,
                "seconds": [rr[leg]["seconds"] for rr in res]}
        entry[leg] = line
        log(f"[tp] ({leg}) tensor-parallel serving of {cfg.name} at published widths, "
            f"{L} layers, {str(cfg.dtype)[6:]}, on two gloo ranks of one card, the KV "
            f"cache in {TP_SERVE_BLOCKS} sequence blocks (one per rank, {g0['kv_shape']}): "
            f"prefill {B} x {S} {line['prefill_ms']:.1f} ms (mesh-free "
            f"{line['prefill_ms_mesh_free']:.1f}), {steps} decode steps, the last "
            f"{steps - 1} timed: p50 / p99 "
            f"{line['decode_ms_p50']:.1f} / {line['decode_ms_p99']:.1f} ms (mesh-free p50 "
            f"{line['decode_ms_mesh_free_p50']:.1f}); flash launches per rank per prefill "
            f"{g0['launches']} ({variant}; profiler {g0['profiled']}), the profiled prefill's "
            f"first held in place: ||kernel - plain|| / ||plain|| {line['held']:.3e}; logits of "
            f"every step within {rule:.3e} of max|ref| (floor {want['floor']:.3e}): worst "
            f"{worst['logits']:.3e}; "
            f"cache blocks of layers {list(cache_rule)} worst "
            f"{[round(v, 6) for v in worst['cache'].values()]} within "
            f"{[round(v, 6) for v in cache_rule.values()]} (floors "
            f"{[round(v, 6) for v in want['cache_floor'].values()]}); greedy tokens equal but "
            f"near-ties {ties}; lm.greedy_generate under the groups: {TP_SERVE_GREEDY} "
            f"tokens per row equal to the mesh-free run's but near-ties {greedy_ties}; "
            f"collective bytes on rank 0 per prefill "
            f"{line['prefill_bytes']} ({line['prefill_serving_bytes']}), per decode step "
            f"{line['decode_bytes']} ({line['decode_serving_bytes']}); peak device memory per "
            f"rank {[gb(b) for b in line['peak_bytes']]} GB for {gb(g0['slice_bytes'])} GB of "
            f"slices; KV cache per rank {gb(g0['kv_bytes'])} GB against "
            f"{gb(want['kv_bytes'])} mesh-free; {[round(x, 1) for x in line['seconds']]} s; "
            f"{card}")
    if failed:
        raise AssertionError("tp (h): " + "; ".join(failed))
    return entry


def tp_adamw_entry(tp: dict) -> dict:
    """The fused AdamW row's ``tp`` entry: (b)'s launches on both ranks, and
    rank 0's device time per step beside the bound of its slices' bytes
    and operations (the two ranks share the card)."""
    b = tp["ranks"][0]["b"]
    bytes_ms = b["bytes_per_step"] / HBM_BYTES_PER_S * 1e3
    ops_ms = ADAMW_OPS * b["elements_per_step"] / F32_OPS_PER_S * 1e3
    return {"launches": sum(rr["b"]["launches"] for rr in tp["ranks"]),
            "launches_per_step_per_rank": b["launches_per_step"],
            "profiled_per_step_per_rank": b["profiled_per_step"],
            "update_device_ms_rank0": b["update_device_ms"],
            "bound_ms_rank0": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err_vs_jnp": max(rr["b"]["max_abs_err_vs_jnp"] for rr in tp["ranks"]),
            "per_step": f"{b['leaves']} leaves, each rank's model slices of gemma-7b at "
                        f"{TP_LAYERS} layers on a (1, 2) mesh"}


def phase_tp(fa, sp) -> dict:
    """Tensor parallelism over "model" (ROADMAP A8.2b) on two ranks of one
    card, then C14 and C15.  NCCL takes one rank per GPU, so two spawned
    processes share ``cuda:0`` in a ``gloo`` group (every collective on
    card tensors; ``tp_probe`` prints which collectives ``gloo`` takes there
    and fails if the step's need one it lacks).  The mesh-free references
    run first in this process and keep their final parameters on the card,
    shared with the ranks through CUDA IPC."""
    import pickle
    import shutil
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    plain, params = {}, {}
    plain["gemma"], params["gemma"] = tp_plain(tp_gemma_config())
    plain["olmoe"], params["olmoe"] = tp_plain(tp_olmoe_config())
    plain["ep"], ep_params = tp_plain(tp_ep_config(EP_CAPACITY))
    del ep_params
    init = tp_init_plain(tp_init_config())
    params["init_sums"] = init.pop("sums")
    plain["serve"] = {leg: tp_serve_plain(tp_serve_config(leg), leg) for leg in TP_SERVE}
    plain["masked"] = plain["serve"]["h1"].pop("masked")
    params["serve"] = {leg: {k: v[k] for k in ("prompt", "tokens")}
                       for leg, v in plain["serve"].items()}
    params["masked"] = {k: plain["masked"][k] for k in ("prompt", "plens", "tokens")}
    t_plain = time.perf_counter() - t_phase
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        mp.start_processes(tp_rank, args=(os.path.join(tmp, "store"), params, tmp),
                           nprocs=2, start_method="spawn")
        ranks_s = time.perf_counter() - t0
        res = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    probe = res[0]["probe"]
    log(f"[tp] gloo on card tensors, two ranks on cuda:0: "
        f"{json.dumps({k: v for k, v in probe.items() if not k.endswith('_ms')})}; "
        f"50 MB float32: all-reduce {probe['all_reduce_50MB_ms']:.1f} ms, all-gather "
        f"{probe['all_gather_50MB_ms']:.1f} ms")
    missing = [k for k, v in probe.items() if not k.endswith("_ms") and v != "ok"]
    if missing:
        raise AssertionError(f"tp: gloo lacks {missing} on card tensors; the group helpers "
                             "must compose them")
    a0, c0 = res[0]["a"], res[0]["c"]
    for r, rr in enumerate(res):
        if rr["a"]["losses"] != a0["losses"] or rr["c"]["losses"] != c0["losses"]:
            raise AssertionError(f"tp: rank {r}'s losses differ from rank 0's")
    steps_ms = lambda xs: [round(1e3 * x, 1) for x in xs]
    for what, got, want, cfg in (("(a)", a0, plain["gemma"], tp_gemma_config()),
                                 ("(c)", c0, plain["olmoe"], tp_olmoe_config())):
        worst = max((rr[what[1]] for rr in res), key=lambda x: x["max_param_diff"])
        per_step = {k: v // TP_STEPS for k, v in got["collective_bytes"].items()}
        log(f"[tp] {what} train(mesh={res[0]['mesh']}, {res[0]['backend']}) of {cfg.name} at "
            f"published widths, {cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ}, "
            f"{TP_STEPS} steps, bfloat16: losses {got['losses']} against the mesh-free "
            f"train()'s {want['losses']} (step 1 within rtol {TP_LOSS1_RTOL}, steps 2-3 "
            f"within {TP_LOSS_RTOL}: the reference's own bfloat16 (1, 2) runs move up to "
            f"1.7% from (1, 1) by step 3); largest parameter difference after step "
            f"{TP_STEPS} {worst['max_param_diff']:.4e} at {worst['at']} (one bfloat16 ulp of "
            f"its largest element {worst['bf16_ulp_of_largest']:.4e}); step ms "
            f"{steps_ms(got['step_s'])} on rank 0 against {steps_ms(want['step_s'])} "
            f"mesh-free; peak device memory per rank "
            f"{[round(rr[what[1]]['peak_bytes'] / 1e9, 2) for rr in res]} GB against "
            f"{want['peak_bytes'] / 1e9:.2f} GB mesh-free; collective bytes per step on "
            f"rank 0 {per_step}; {got['seconds']:.1f} s")
        tp_check_losses(what, got["losses"], want["losses"])
    moe_layers = tp_olmoe_config().n_layers
    for r, rr in enumerate(res):
        calls = rr["c"]["calls"]
        for kind in ("route", "ffn"):
            mine = [c for c in calls if c[0] == kind]
            off_main = sum(1 for c in mine if not c[1])
            if len(mine) != 2 * moe_layers * TP_STEPS or off_main != moe_layers * TP_STEPS \
                    or not all(c[2] for c in mine):
                raise AssertionError(f"tp (c) rank {r}: {kind} calls {mine}")
    log(f"[tp] (c) every route and expert FFN call saw the model group: per rank and step "
        f"{moe_layers} in the forward on the main thread and {moe_layers} in the "
        f"backward's recompute on autograd's device thread")
    b = res[0]["b"]
    for r, rr in enumerate(res):
        bb = rr["b"]
        if bb["launches_per_step"] != [bb["leaves"]] * TP_STEPS or \
                bb["profiled_per_step"] != [bb["leaves"]] * TP_STEPS:
            raise AssertionError(f"tp (b) rank {r}: fused_adamw launches "
                                 f"{bb['launches_per_step']} (profiler "
                                 f"{bb['profiled_per_step']}) for {bb['leaves']} leaves")
        tp_check_losses("(b)", bb["losses"], a0["losses"])
    log(f"[tp] (b) make_zero1_step(path=\"kernel\") on each rank's model slices, {TP_STEPS} "
        f"steps: fused_adamw launches per step {b['launches_per_step']} (wrapper), "
        f"{b['profiled_per_step']} (torch.profiler) on each rank, {b['leaves']} leaves; "
        f"device ms per step {[round(t, 3) for t in b['update_device_ms']]} on rank 0's "
        f"{b['elements_per_step']} elements ({b['bytes_per_step']} bytes); step 1 max "
        f"|kernel path - jnp path| {max(rr['b']['max_abs_err_vs_jnp'] for rr in res):.3e} "
        f"(bfloat16 p within one ulp); losses {b['losses']} against (a)'s jnp path "
        f"{a0['losses']}; {b['seconds']:.1f} s")
    d = res[0]["d"]
    for r, rr in enumerate(res):
        dd = rr["d"]
        if dd["losses"] != [dd["want"]] or not dd["params_equal"] or \
                dd["steps"] != [2, TP_STEPS]:
            raise AssertionError(f"tp (d) rank {r}: {dd}")
    log(f"[tp] (d) (c)'s run saved checkpoints at steps {d['steps']} "
        f"({d['checkpoint_bytes'] / 1e9:.2f} GB on disk: parameters and moments whole, "
        f"gathered to the writer's host on the main thread); the step-{TP_STEPS} one "
        f"removed, train() again resumed at step 2: step {TP_STEPS} loss {d['losses']} "
        f"equal to the uninterrupted run's {d['want']}, every rank's slices bit-equal; "
        f"the resumed run {d['resume_s']:.1f} s; seconds in the checkpoints' parts on rank "
        f"0, (c) {json.dumps({k: round(v, 1) for k, v in c0['checkpoint_s'].items()})}, "
        f"(d) {json.dumps({k: round(v, 1) for k, v in d['checkpoint_s'].items()})}")
    tp_check_ep(res, plain, init, card)
    serve = tp_check_serve(res, plain["serve"], card)
    serve["h3"] = tp_check_masked(res, plain["serve"]["h1"], plain["masked"], serve["h1"], card)
    torch.cuda.empty_cache()
    mesh = make_host_mesh()
    try:
        t0 = time.perf_counter()
        c14 = tp_c14(sp, mesh)
        c14_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    log(f"[tp] (e) C14 at n={C13_N}: uint16 and uint32 add, subtract, multiply, mod, square, "
        f"abs, sign and negative wrap as int64 masked to the width, on cuda (every stage on "
        f"the kernel), sharded and fused: {json.dumps(c14)}; {c14_s:.1f} s")
    c15 = tp_c15()
    log(f"[tp] (e) C15: a step holding {C15_BYTES} bytes raised an injected "
        f"torch.OutOfMemoryError and was retried; memory_allocated {c15['before']} before, "
        f"{c15['during']} in the failed attempt, {c15['at_retry']} at the retry's start")
    del plain["serve"], plain["masked"]
    out = {"plain": plain, "ranks": [{k: {kk: vv for kk, vv in v.items() if kk != "calls"}
                                      if isinstance(v, dict) else v for k, v in rr.items()
                                      if k not in TP_SERVE and k != "h3"}
                                     for rr in res],
           "init": init, "c14": c14, "c15": c15, "plain_s": t_plain, "ranks_s": ranks_s,
           "serve": serve}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tp] phase {out['seconds']:.1f} s (mesh-free runs {t_plain:.1f} s, the two ranks "
        f"{ranks_s:.1f} s); {card}")
    return out


# ---------------------------------------------------------------------------
# dryrun: the production dry run (ROADMAP A11)
# ---------------------------------------------------------------------------

#: (a): the cells ``python -m repro_torch.launch.dryrun`` traces at published
#: widths, (arch, shape, multi_pod)
DRYRUN_CELLS = (("gemma-7b", "train_4k", False), ("gemma-7b", "decode_32k", False),
                ("olmoe-1b-7b", "prefill_32k", False), ("gemma-7b", "decode_32k", True))
#: the cell ``roofline.main`` analyzes and whose step (b) runs on the card
DRYRUN_CARD = ("gemma-7b", "decode_32k")
#: a record's keys: the reference's (src/repro/launch/dryrun.py:260-290) and
#: the port's ``moe_flops_traced``
DRYRUN_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s", "flops", "hlo_bytes",
               "collective", "memory", "n_devices", "params", "active_params",
               "moe_flops_traced"}
DRYRUN_PEAK_TOL = 0.20           # (b): the card's peak against the record's peak_bytes
DRYRUN_TIMEOUT_S = 600           # each process of the phase


def dryrun_tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"


def dryrun_cells(out: Path, stop: threading.Event, running: list) -> dict:
    """(a): ``python -m repro_torch.launch.dryrun`` on every cell of
    ``DRYRUN_CELLS``, all at once (a process each), and ``python -m
    repro_torch.launch.roofline`` on ``DRYRUN_CARD`` with the chip of
    ``cuda`` once that cell's record is written.  Each process is put in
    ``running``; none starts once ``stop`` is set, and where one fails the
    others are killed.  Returns each process's seconds and output lines;
    raises where one fails."""
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmds = {dryrun_tag(*c): ["-m", "repro_torch.launch.dryrun", "--arch", c[0], "--shape", c[1],
                             "--out", str(out / "dryrun")] + (["--multi-pod"] if c[2] else [])
            for c in DRYRUN_CELLS}
    cmds["roofline"] = ["-m", "repro_torch.launch.roofline", "--dryrun-dir", str(out / "dryrun"),
                        "--variants-dir", str(out / "variants"), "--out", str(out / "roofline"),
                        "--arch", DRYRUN_CARD[0], "--shape", DRYRUN_CARD[1]]
    chains = [[tag] + (["roofline"] if tag == dryrun_tag(*DRYRUN_CARD, False) else [])
              for tag in cmds if tag != "roofline"]

    def chain(names: list) -> dict:
        runs = {}
        for name in names:
            if stop.is_set():
                raise AssertionError(f"dryrun (a): stopped before {name}")
            t0 = time.perf_counter()
            proc = subprocess.Popen([sys.executable, *cmds[name]], env=env, cwd=str(ROOT),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running.append(proc)
            if stop.is_set():
                proc.kill()
            try:
                stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"dryrun (a) {name}: exit {proc.returncode}\n"
                                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "said": stdout.strip().splitlines()}
        return runs

    runs = {}
    with ThreadPoolExecutor(len(chains)) as pool:
        try:
            for fut in [pool.submit(chain, c) for c in chains]:
                runs.update(fut.result())
        finally:
            _stop(stop, running)
    return runs


def _stop(stop: threading.Event, running: list) -> None:
    stop.set()
    for proc in running:
        if proc.poll() is None:
            proc.kill()


@contextlib.contextmanager
def dryrun_background(out: Path):
    """(a) (``dryrun_cells``) in a thread while the block runs; yields its
    future.  However the block is left, the processes (a) is running are
    killed and the thread joined, so a failing phase fails at once and
    leaves no process behind."""
    stop, running = threading.Event(), []
    pool = ThreadPoolExecutor(1)
    try:
        yield pool.submit(dryrun_cells, out, stop, running)
    finally:
        _stop(stop, running)
        pool.shutdown(wait=True)


def dryrun_card(out_path: str) -> None:
    """(b), in a spawned process: rank 0's ``DRYRUN_CARD`` step of the fake
    512-rank world run for real on ``cuda:0`` with the dry run's builders
    (the rank's parameter slices drawn from a seed, its cache pieces, a
    token per row), the peak statistics reset once the inputs are built,
    under ``FlopCounterMode``.  Writes the resident and peak bytes, the
    FLOPs, the seconds and the step's output shape to ``out_path``."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES, input_specs
    from repro_torch.launch import dryrun, train
    from repro_torch.models import data_parallel, shard_ctx, tensor_parallel
    from repro_torch.models import transformer as tfm
    dryrun.init_world()
    dev = torch.device("cuda", 0)
    arch, shape_name = DRYRUN_CARD
    shape = SHAPES[shape_name]
    mesh = dryrun.make_production_mesh(device="cpu")
    cfg = dryrun.runtime_config(get_config(arch), mesh, shape)
    zero = train.zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
    gen = torch.Generator(device=dev).manual_seed(0)
    dryrun.install_placements(cfg, mesh, shape.global_batch)
    try:
        with data_parallel.use(zero.dg), tensor_parallel.use(zero.mg), torch.no_grad():
            params = train.rank_params(cfg, zero, gen, dev)
            caches = tfm.init_caches(cfg, shape.global_batch, shape.seq_len, device=dev)
            local, _ = train.local_batch(input_specs(cfg, shape), mesh, zero.dg)
            token = torch.randint(0, cfg.vocab_size, tuple(local["token"].shape),
                                  generator=gen, device=dev, dtype=torch.int32)
            view = tensor_parallel.serving_view(params, cfg)
            step = dryrun.build_serve_step(cfg)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with FlopCounterMode(display=False) as fc:
                tok, caches = step(view, token, caches)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
    finally:
        shard_ctx.clear()
    out = {"resident": int(resident), "peak": int(peak), "flops": int(fc.get_total_flops()),
           "seconds": seconds, "token_shape": list(tok.shape), "token_dtype": str(tok.dtype),
           "tokens_in_range": bool(((tok >= 0) & (tok < cfg.padded_vocab)).all())}
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_dryrun(out: Path) -> dict:
    """The production dry run (ROADMAP A11), after the tp phase, so that
    no trace shares the host with its gloo-paced times.  (a)
    (``dryrun_cells``) runs on the host while (b) runs on the card.  Each
    record of (a) is ``ok`` with the reference's keys and
    ``models.config``'s parameter counts, and its FLOPs (with the routed
    experts') cover ``model_flops``; ``roofline.main``'s terms of
    ``DRYRUN_CARD`` on the card's constants and ``report.py``'s tables are
    printed.  (b) runs ``DRYRUN_CARD``'s step for real on ``cuda:0``
    (``dryrun_card``, a spawned process): its peak device memory against
    the record's ``peak_bytes`` (a difference past ``DRYRUN_PEAK_TOL`` is
    printed for ROADMAP C, not gated), its resident bytes against
    ``argument_bytes``, and its ``FlopCounterMode`` count equal to the
    record's ``flops``."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import report, roofline
    from repro_torch.models.config import active_param_count, param_count
    t_phase = time.perf_counter()
    card = card_line()
    with dryrun_background(out) as cells:
        # (b): DRYRUN_CARD's step for real on the card, beside (a)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            child = mp.get_context("spawn").Process(target=dryrun_card, args=(path,))
            child.start()
            child.join(DRYRUN_TIMEOUT_S)
            if child.exitcode != 0:
                child.kill()
                raise AssertionError(f"dryrun (b): the card's step exited {child.exitcode}")
            b = json.loads(Path(path).read_text())
        finally:
            os.unlink(path)
        b_s = time.perf_counter() - t_phase
        runs = cells.result(timeout=2 * DRYRUN_TIMEOUT_S)
    waited = time.perf_counter() - t_phase - b_s
    recs = {}
    for arch, shape, multi_pod in DRYRUN_CELLS:
        tag = dryrun_tag(arch, shape, multi_pod)
        rec = json.loads((out / "dryrun" / f"{tag}.json").read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun (a) {tag}: {rec.get('error')}\n{rec.get('trace')}")
        cfg = get_config(arch)
        mf = roofline.model_flops(cfg, SHAPES[shape], rec["n_devices"])
        if set(rec) != DRYRUN_KEYS or rec["n_devices"] != (512 if multi_pod else 256) or \
                rec["params"] != param_count(cfg) or \
                rec["active_params"] != active_param_count(cfg) or \
                not rec["flops"] + rec["moe_flops_traced"] >= mf > 0:
            raise AssertionError(f"dryrun (a) {tag}: {json.dumps(rec)}")
        m = rec["memory"]
        log(f"[dryrun] (a) {arch} x {shape} x {rec['mesh']}: {rec['status']}, params "
            f"{rec['params']} (active {rec['active_params']}), lower {rec['lower_s']} s, trace "
            f"{rec['compile_s']} s, process {runs[tag]['seconds']:.1f} s; flops "
            f"{rec['flops']:.6e} (+ routed experts {rec['moe_flops_traced']:.6e}; model_flops "
            f"{mf:.6e}), hlo_bytes {rec['hlo_bytes']:.6e}, collective "
            f"{json.dumps(rec['collective']['bytes_by_op'])} in "
            f"{json.dumps(rec['collective']['counts_by_op'])}; memory argument "
            f"{m['argument_bytes']} output {m['output_bytes']} alias {m['alias_bytes']} temp "
            f"{m['temp_bytes']} peak {m['peak_bytes']} ({m['peak_bytes'] / 1e9:.3f} GB); {card}")
        recs[tag] = rec
    roof = json.loads((out / "roofline" / f"{DRYRUN_CARD[0]}__{DRYRUN_CARD[1]}.json").read_text())
    if "compute_s" not in roof:
        raise AssertionError(f"dryrun roofline.main: {json.dumps(roof)}")
    log(f"[dryrun] (a) roofline.main {DRYRUN_CARD[0]} x {DRYRUN_CARD[1]} on the card's "
        f"constants ({runs['roofline']['seconds']:.1f} s): "
        + ", ".join(f"{k} {roof[k]:.6g}" for k in (
            "compute_s", "memory_s", "memory_flash_s", "collective_s", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "model_flops_per_device",
            "useful_flops_ratio", "roofline_fraction", "memory_peak_gib"))
        + f", dominant {roof['dominant']}; {card}")
    for line in (report.dryrun_table(out / "dryrun") + "\n\n" + report.roofline_table(
            out / "roofline") + "\n\n" + report.collective_detail(out / "roofline")).splitlines():
        if "—" not in line or "ok" in line:            # the rows of the cells that ran
            log(f"[dryrun] report: {line}")

    # (b) against DRYRUN_CARD's record
    rec = recs[dryrun_tag(*DRYRUN_CARD, False)]
    m = rec["memory"]
    diff = (b["peak"] - m["peak_bytes"]) / m["peak_bytes"]
    if b["flops"] != rec["flops"] or b["token_shape"] != [8, 1] or not b["tokens_in_range"]:
        raise AssertionError(f"dryrun (b): {json.dumps(b)} against the record's flops "
                             f"{rec['flops']}")
    log(f"[dryrun] (b) {DRYRUN_CARD[0]} x {DRYRUN_CARD[1]}: rank 0's step of the fake 512-rank "
        f"world run for real on cuda:0 ({b['seconds'] * 1e3:.1f} ms, process {b_s:.1f} s): "
        f"resident {b['resident']} bytes against argument_bytes {m['argument_bytes']} "
        f"({(b['resident'] - m['argument_bytes']) / m['argument_bytes']:+.4%}); "
        f"max_memory_allocated {b['peak']} ({b['peak'] / 1e9:.3f} GB) against peak_bytes "
        f"{m['peak_bytes']} ({m['peak_bytes'] / 1e9:.3f} GB): {diff:+.2%}"
        + (f", outside {DRYRUN_PEAK_TOL:.0%} (ROADMAP C)" if abs(diff) > DRYRUN_PEAK_TOL
           else "")
        + f"; FlopCounterMode {b['flops']} = the record's flops {rec['flops']:.0f}; "
        f"tokens {b['token_shape']} {b['token_dtype']}; {card}")
    out_rec = {"cells": {tag: {"status": r["status"], "lower_s": r["lower_s"],
                               "compile_s": r["compile_s"], "seconds": runs[tag]["seconds"],
                               "flops": r["flops"], "moe_flops_traced": r["moe_flops_traced"],
                               "hlo_bytes": r["hlo_bytes"],
                               "collective": r["collective"]["bytes_by_op"],
                               "memory": r["memory"]} for tag, r in recs.items()},
               "roofline": {k: roof[k] for k in ("compute_s", "memory_s", "collective_s",
                                                  "dominant", "useful_flops_ratio",
                                                  "roofline_fraction")},
               "card": {**b, "peak_bytes": m["peak_bytes"], "peak_diff": diff},
               "waited_s": waited, "card_s": b_s, "card_line": card,
               "processes_s": sum(r["seconds"] for r in runs.values())}
    out_rec["seconds"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase {out_rec['seconds']:.1f} s: (b) {b_s:.1f} s, then {waited:.1f} s "
        f"waiting for (a), whose {len(runs)} processes ran at once ({len(DRYRUN_CELLS)} "
        f"chains) and took {out_rec['processes_s']:.1f} s in all; {card}")
    return out_rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--rmsnorm-compare", action="append", default=[], metavar="CU",
                        help="another version of csrc/rmsnorm.cu (same C interface) to "
                             "build and time beside the kernel at (8192, 3072); repeatable")
    parser.add_argument("--split-pipeline-compare", action="append", default=[],
                        metavar="CU",
                        help="an older version of csrc/split_pipeline.cu (the parameter "
                             "block before persistent CTAs) to build, check and time "
                             "beside the kernel on the main path's programs; repeatable")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
            "this check runs on the card only")
        return 1
    os.environ.pop("MOZART_FAULTS", None)        # the chaos phase arms its own plans
    sys.path.insert(0, str(ROOT / "src"))
    from scipy.special import erf
    from repro_torch import workloads as w
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import fused_adamw as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import split_pipeline as sp
    from repro_torch.core import resilience
    resilience.clear_faults()
    resilience.clear_events()

    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    phase_build([sp.SOURCE, fa.SOURCE, fl.SOURCE, rn.SOURCE])
    resilience_clean("build")

    t0 = time.perf_counter()
    bs = w.black_scholes_data(N_MAIN, seed=0, device="cuda")
    hv = w.haversine_data(N_MAIN, seed=0, device="cuda")
    qs = w.quickstart_data(N_QUICKSTART, device="cuda")
    torch.cuda.synchronize()
    log(f"[data] generated in {time.perf_counter() - t0:.1f} s")
    workloads_data = {"black_scholes": (w.black_scholes, bs),
                      "haversine": (w.haversine, hv),
                      "quickstart": (w.quickstart, qs)}
    bs_pre = {k: v[:PREFIX] for k, v in bs.items()}
    hv_pre = {k: v[:PREFIX] for k, v in hv.items()}
    call64, put64 = w.black_scholes_np(bs_pre, erf=erf)
    oracles = {
        "black_scholes": [(call64, 2e-3, 1e-3), (put64, 2e-3, 1e-3)],
        "haversine": [(w.haversine_np(**hv_pre), 2e-3, 1e-2)],
        "quickstart": [(np.float64(w.quickstart_np(**qs)), 1e-4, 0.0)],
    }

    errs = phase_kernel(sp, ref, workloads_data)
    resilience_clean("kernel")
    launches = phase_main(sp, workloads_data, oracles)
    resilience_clean("main")
    dtype_rows = phase_dtypes(sp, ref, w, workloads_data, erf, errs)
    resilience_clean("dtypes")
    rewrites = phase_rewrite(sp, ref, workloads_data, oracles)
    resilience_clean("rewrite")
    handoff_row = phase_handoff(sp, ref)
    resilience_clean("handoff")
    torch.cuda.empty_cache()
    plans = phase_plans(sp, workloads_data, oracles, rewrites)
    resilience_clean("plans")
    chaos = phase_chaos(sp, ref, workloads_data, errs)
    rows = phase_times(sp, ref, workloads_data, errs, launches,
                       args.split_pipeline_compare)
    resilience_clean("times")
    for row in rows:
        name = row["name"][len("split_pipeline["):-1]
        row.update(plans.get(name, {}))
        row.update(rewrites.get(name, {}))
    rows[0]["chaos"] = chaos
    rows[0]["smoke_rewrite"] = rewrites["smoke_rewrite"]
    rows.append(handoff_row)
    rows.extend(dtype_rows)
    del workloads_data, errs, bs, hv, qs, bs_pre, hv_pre
    torch.cuda.empty_cache()

    adamw_kernel = phase_adamw_kernel(fa, ref)
    resilience_clean("adamw")
    fl.flash_attention.launches = 0
    train = phase_train(fa, sp, ref)
    resilience_clean("train")
    if fl.flash_attention.launches:                  # autograd records: no kernel
        raise AssertionError(f"training launched flash_attention "
                             f"{fl.flash_attention.launches} times")
    rows.append(adamw_row(adamw_kernel, train))
    adamw_at = len(rows) - 1
    log(f"[times] fused_adamw per step ({rows[-1]['per_step']}): kernel "
        f"{rows[-1]['ms']:.3f} ms over {rows[-1]['launches_per_step']} launches, "
        f"bound {rows[-1]['bound_ms']:.3f} ms by {rows[-1]['bound_by']} "
        f"({rows[-1]['bound_ms'] / rows[-1]['ms']:.1%} of it), plain "
        f"{rows[-1]['plain_ms']:.3f} ms, torch._fused_adamw_ {rows[-1]['library_ms']} ms "
        f"on {rows[-1]['library_leaves']} (kernel {rows[-1]['ms_on_library_leaves']:.3f} ms "
        f"there)")

    kern = phase_attn_kernels(fl, rn, ref, args.rmsnorm_compare)
    resilience_clean("attn")
    rms_launches = phase_ops(rn, ref)
    resilience_clean("ops")
    serve = phase_serve((sp.split_pipeline, fa.fused_adamw, fl.flash_attention, rn.rmsnorm),
                        fl.flash_attention)
    resilience_clean("serve (after the chaos waves)")
    archs = phase_archs((sp.split_pipeline, fa.fused_adamw, fl.flash_attention, rn.rmsnorm),
                        fl.flash_attention, ref)
    band = phase_band((sp.split_pipeline, fa.fused_adamw, fl.flash_attention, rn.rmsnorm),
                      fl.flash_attention, fl, ref)
    resilience_clean("band")
    libs = phase_libs()
    log(json.dumps({"libs": libs}))
    verify = phase_verify(sp)
    resilience_clean("verify")
    log(json.dumps({"verify": verify}))
    lint = phase_lint(sp, train, serve)
    resilience_clean("lint")
    log(json.dumps({"lint": lint}))
    sharded = phase_sharded(sp, w, erf)
    resilience_clean("sharded")
    log(json.dumps({"sharded": sharded}))
    zero1 = phase_zero1(fa, sp, ref, train["peak_bytes"])
    resilience_clean("zero1")
    log(json.dumps({"zero1": zero1}))
    rows[adamw_at]["zero1"] = {k: zero1["kernel"][k] for k in
                               ("launches", "launches_per_step", "profiled_per_step",
                                "update_device_ms", "max_abs_err_vs_jnp")}
    tp = phase_tp(fa, sp)
    resilience_clean("tp")
    log(json.dumps({"tp": tp}))
    dryrun = phase_dryrun(ROOT / "build" / "dryrun")
    resilience_clean("dryrun")
    log(json.dumps({"dryrun": dryrun}))
    rows[adamw_at]["tp"] = tp_adamw_entry(tp)
    rows[adamw_at]["ep"] = {k: tp["ranks"][0]["g2"][k] for k in
                            ("launches", "launches_per_step", "profiled_per_step",
                             "update_device_ms", "leaves")}
    rows[adamw_at]["ep"]["per_step"] = (f"each rank's model slices of olmoe-1b-7b at "
                                        f"{TP_MOE_LAYERS} layers, expert-parallel, on a "
                                        f"(1, 2) mesh")
    log(f"[phases] seconds per check (chaos counts in times, data in kernel): "
        f"{json.dumps(LAPS)}; {sum(s for _, s in LAPS):.1f} s to the last")
    rows.append({"name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
                 "replaces": ATTN_REPLACES,
                 "launches": serve["launches"]["flash_attention"],
                 "variant_launches": serve["flash_variant_launches"],
                 **{k: kern["attn"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "shape", "event_ms",
                                                 "simt_ms", "library_event_ms")},
                 "serve": {k: v for k, v in serve.items()
                           if k not in ("launches", "flash_variant_launches")},
                 "shapes": kern["attn_shapes"] + [band["shape"]], "archs": archs,
                 "band": {k: v for k, v in band.items() if k != "shape"},
                 "tp": {leg: {k: tp["serve"][leg][k] for k in
                              ("launches_per_rank_per_prefill", "variant", "held", "prefill_ms")}
                        for leg in TP_SERVE}})
    rows.append({"name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
                 "replaces": RMS_REPLACES, "launches": rms_launches,
                 "path": "kernels.ops.rmsnorm",
                 **{k: kern["rms"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "shape", "event_ms",
                                                "burst_ms", "library_event_ms",
                                                "library_burst_ms")}})

    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"{row['name']}: {key} = {row[key]}")
    log(card_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
