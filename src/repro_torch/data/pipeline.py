"""Token data pipeline with SA-annotated preprocessing: the counterpart of
``src/repro/data/pipeline.py``.

Sources: synthetic (seeded Zipfian tokens — deterministic across restarts,
indexable by step for exact resume) or a binary token file (memory-mapped
uint16).  The preprocessing transforms (vocab wrap, int32 cast) are
ANNOTATED functions run by a Mozart ``fused`` session on the pipeline's
device.  A background prefetch thread keeps ``prefetch`` batches ahead of
the training loop.

Tokens equal the JAX pipeline's bit for bit: the raw int64 draws are cast
to int32 first (wrapping the ~0.1% of Zipf draws beyond int32, as
``jnp.asarray`` does with 64-bit types off) and then taken modulo the
vocabulary.  So do the stub frontends' inputs: an encoder-decoder batch
adds ``enc_embeds`` (B, 64, d), a vision-language batch ``input_embeds``
(B, seq + 1, d) x 0.02 and M-RoPE's ``positions`` (3, B, seq + 1), the
floats drawn from ``np.random.default_rng(step)`` in float64 and rounded
through float32 to ``cfg.dtype``, as the reference's ``jnp.asarray`` does.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import mozart
from repro_torch.core import split_types as st
from repro_torch.core.annotation import annotate
from repro_torch.core.runtime import resolve_device
from repro_torch.models.config import ModelConfig


# -- annotated preprocessing ops (the "library") ------------------------------

def _mod_vocab(x, vocab):
    return torch.remainder(x, vocab)


def _to_i32(x):
    return x.to(torch.int32)


mod_vocab = annotate(_mod_vocab, name="mod_vocab", elementwise=True,
                     x=st.Generic("S"), vocab=st._, ret=st.Generic("S"))
to_i32 = annotate(_to_i32, name="to_i32", elementwise=True,
                  x=st.Generic("S"), ret=st.Generic("S"))


class TokenSource:
    """Deterministic, step-indexable token source."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 token_file: str | None = None):
        self.vocab_size = vocab_size
        self.seed = seed
        self._tokens = (np.memmap(token_file, dtype=np.uint16, mode="r")
                        if token_file else None)

    def batch_at(self, step: int, batch: int, seq: int) -> np.ndarray:
        """The (batch, seq+1) int64 token window for one global step."""
        n = batch * (seq + 1)
        if self._tokens is not None:
            start = (step * n) % max(len(self._tokens) - n, 1)
            flat = np.asarray(self._tokens[start:start + n], np.int64)
        else:
            rng = np.random.default_rng(self.seed + step)
            # Zipf-ish distribution bounded to vocab
            flat = rng.zipf(1.3, size=n).astype(np.int64)
        return flat.reshape(batch, seq + 1)


class DataPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, token_file: str | None = None,
                 prefetch: int = 2, use_mozart: bool = True,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.device = resolve_device(device)
        self.source = TokenSource(cfg.vocab_size, seed, token_file)
        self.prefetch = prefetch
        self.use_mozart = use_mozart
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- single-batch path (exact resume: call with any step) ---------------
    def batch_for_step(self, step: int) -> dict:
        raw = self.source.batch_at(step, self.batch, self.seq)
        if self.use_mozart:
            x = torch.from_numpy(raw.astype(np.int32)).to(self.device)
            with mozart.session(executor="fused", device=self.device):
                tokens = to_i32(mod_vocab(x, self.cfg.vocab_size)).value
        else:
            tokens = torch.from_numpy(
                (raw % self.cfg.vocab_size).astype(np.int32)).to(self.device)
        batch = {"tokens": tokens}
        cfg, B, S = self.cfg, self.batch, self.seq + 1
        rng = np.random.default_rng(step)
        floats = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.device, cfg.dtype)
        if cfg.encdec:
            batch["enc_embeds"] = floats(rng.standard_normal((B, 64, cfg.d_model)))
        elif cfg.family == "vlm":
            batch["input_embeds"] = floats(rng.standard_normal((B, S, cfg.d_model)) * 0.02)
            batch["positions"] = torch.arange(S, dtype=torch.int32, device=self.device)[
                None, None].expand(3, B, S).contiguous()
        return batch

    # -- prefetching iterator -------------------------------------------------
    def _worker(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            b = self.batch_for_step(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def iterate(self, start_step: int = 0) -> Iterator[tuple[int, dict]]:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, args=(start_step,), daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self.stop()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            while not self._q.empty():
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=2)
            self._thread = None
