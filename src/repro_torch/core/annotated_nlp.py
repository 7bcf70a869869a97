"""The "spaCy" integration (paper §7): NLP pipeline over token minibatches,
over torch.

The counterpart of ``src/repro/core/annotated_nlp.py``.  The paper's spaCy
split type uses the library's own minibatch tokenizer to split a corpus;
any function over text pipelines/parallelizes through it.  Our analogue: a
corpus is a (docs, max_len) padded int32 token-id matrix + int32 length
vector; ``CorpusSplit`` splits by documents (the minibatch dimension), and
the "library" ops are per-token taggers / feature extractors — unmodified
functions, SAs only.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import split_types as st
from repro_torch.core.annotation import annotate


class Corpus:
    """Padded token-id matrix (docs, max_len) + per-doc lengths."""

    def __init__(self, tokens, lengths):
        self.tokens = tokens          # (D, L) int32
        self.lengths = lengths        # (D,) int32

    @property
    def n_docs(self) -> int:
        return int(self.tokens.shape[0])

    def mozart_fingerprint(self) -> tuple:
        """Plan-cache identity: token matrix geometry, never values."""
        return ("corpus", tuple(self.tokens.shape), str(self.tokens.dtype),
                tuple(self.lengths.shape), str(self.lengths.dtype))


pytree.register_pytree_node(
    Corpus, lambda c: ([c.tokens, c.lengths], None), lambda xs, _: Corpus(*xs),
    serialized_type_name=f"{__name__}.Corpus")


class CorpusSplit(st.SplitType):
    """Split a corpus by documents (the paper's minibatch split)."""

    name = "CorpusSplit"

    def __init__(self, n_docs: int):
        super().__init__(int(n_docs))
        self.n_docs = int(n_docs)

    def info(self, value: Corpus) -> st.RuntimeInfo:
        eb = int(value.tokens.shape[1]) * 4 + 4
        return st.RuntimeInfo(num_elements=self.n_docs, elem_bytes=eb)

    def split(self, value: Corpus, start: int, end: int) -> Corpus:
        return Corpus(value.tokens[start:end], value.lengths[start:end])

    def merge(self, pieces: Sequence[Corpus]) -> Corpus:
        st._require_pieces(pieces, self.name)
        if len(pieces) == 1:
            return pieces[0]
        return Corpus(torch.cat([p.tokens for p in pieces]),
                      torch.cat([p.lengths for p in pieces]))


st.register_default_split(Corpus, lambda c: CorpusSplit(c.n_docs))


class CorpusRows(st.SplitSpec):
    def construct(self, value, bound, generics):
        if value is None:
            return st.UnknownSplit()
        n = value.n_docs if isinstance(value, Corpus) else int(
            pytree.tree_leaves(value)[0].shape[0])
        return CorpusSplit(n)


__all_ops__: dict[str, Any] = {}


def _reg(name, fn):
    __all_ops__[name] = fn
    globals()[name] = fn
    return fn


def _valid(corpus: Corpus):
    """(D, L) bool: positions before each document's length."""
    pos = torch.arange(corpus.tokens.shape[1], device=corpus.tokens.device)
    return pos[None] < corpus.lengths[:, None]


# -- the "library": unmodified NLP functions ------------------------------------

def _pos_tag(corpus: Corpus, emb, head):
    """Per-token classification with a preloaded model (emb (V, d), head
    (d, T)): the first maximal tag per token, -1 past each length.  An id
    outside ``[0, V)`` reads the row JAX's gather reads: a negative id
    wraps once (``id + V``), then every id clamps into range."""
    toks = corpus.tokens
    v = emb.shape[0]
    ids = torch.where(toks < 0, toks + v, toks).clamp(0, v - 1)
    x = emb.index_select(0, ids.reshape(-1)).reshape(*toks.shape, emb.shape[1])
    logits = torch.einsum("dlk,kt->dlt", x, head)
    tags = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(_valid(corpus), tags, -1)


_reg("pos_tag", annotate(_pos_tag, name="pos_tag",
                         corpus=CorpusRows(), emb=st._, head=st._,
                         ret=st.Along(0)))


def _token_counts(corpus: Corpus):
    """Corpus-level statistics: valid-token count (an int32 reduction)."""
    return torch.sum(_valid(corpus), dtype=torch.int32)


_reg("token_counts", annotate(_token_counts, name="token_counts",
                              corpus=CorpusRows(), ret=st.Reduce("add")))


def _normalize_case(corpus: Corpus, vocab_size: int):
    """Stub lemmatizer: fold the 'uppercase' half of the vocab down."""
    half = vocab_size // 2
    toks = torch.where(corpus.tokens >= half, corpus.tokens - half, corpus.tokens)
    return Corpus(toks, corpus.lengths)


class _SameCorpus(st.SplitSpec):
    def construct(self, value, bound, generics):
        if "S" not in generics:
            generics["S"] = st.GenericVar("S")
        return generics["S"]


_reg("normalize_case", annotate(_normalize_case, name="normalize_case",
                                static=("vocab_size",),
                                corpus=_SameCorpus(), ret=_SameCorpus()))


def make_corpus(n_docs: int, max_len: int = 64, vocab: int = 1000,
                seed: int = 0, device: torch.device | str = "cuda") -> Corpus:
    """The reference's corpus: the same ``RandomState(seed)`` draws."""
    r = np.random.RandomState(seed)
    lengths = r.randint(4, max_len, n_docs).astype(np.int32)
    toks = r.randint(0, vocab, (n_docs, max_len)).astype(np.int32)
    return Corpus(torch.from_numpy(toks).to(device), torch.from_numpy(lengths).to(device))


def __probe_examples__(n: int = 12, device: torch.device | str = "cuda") -> dict[str, Any]:
    """Tiny concrete inputs per op for the annotation contract checker."""
    vocab, d, tags = 50, 4, 5
    corpus = make_corpus(n, max_len=8, vocab=vocab, seed=0, device=device)
    r = np.random.RandomState(1)
    emb = torch.from_numpy(r.standard_normal((vocab, d)).astype(np.float32)).to(device)
    head = torch.from_numpy(r.standard_normal((d, tags)).astype(np.float32)).to(device)
    return {
        "pos_tag": {"corpus": corpus, "emb": emb, "head": head},
        "token_counts": {"corpus": corpus},
        "normalize_case": {"corpus": corpus, "vocab_size": vocab},
    }
