"""The NLP integration (``repro_torch.core.annotated_nlp``) against the JAX
package's, on the CPU.

The same corpora (``make_corpus`` draws the reference's
``RandomState(seed)`` numbers) and numpy-seeded embedding and head matrices
through both packages, on every port executor against the reference's
executor of the same name (``pallas`` for ``cuda``) and its ``eager``, with
``tests/test_torch_table.py``'s harness: plan, counters and rewrite
records exact, ``cuda_fallback_stages`` equal to the stage count, tags and
counts exactly, with their dtypes (int32).

Ported: ``tests/test_integrations.py::TestNLP`` and the nlp surface of
``tests/test_differential.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annotated_nlp as jnlp
from repro.core import mozart as jm
from repro_torch.core import annotated_nlp as tnlp
from repro_torch.core import mozart as tm
from repro_torch.core import plan_cache as tplan_cache
from test_torch_table import EXECUTORS, PORT_CFG, check_pair, same_values, to_np


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    tplan_cache.clear()
    yield


def _corpora(n_docs, max_len, vocab, seed):
    return (tnlp.make_corpus(n_docs, max_len=max_len, vocab=vocab, seed=seed, device="cpu"),
            jnlp.make_corpus(n_docs, max_len=max_len, vocab=vocab, seed=seed))


def test_make_corpus_draws_the_reference_numbers():
    c, jc = _corpora(33, 16, 200, 3)
    same_values(to_np(c), to_np(jc))
    assert c.tokens.dtype == c.lengths.dtype == torch.int32


def _tagger(nlp, vocab):
    def pipe(corpus, emb, head):
        normalized = nlp.normalize_case(corpus, vocab)
        return nlp.pos_tag(normalized, emb, head), nlp.token_counts(corpus)
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
def test_speech_tag_pipeline(executor):
    """normalize -> tag pipelines in one stage (the same CorpusSplit);
    the reference's emb/head (``jax.random.normal``) carried across."""
    c, jc = _corpora(50, 32, 200, 0)
    emb = jax.random.normal(jax.random.PRNGKey(0), (200, 16))
    head = jax.random.normal(jax.random.PRNGKey(1), (16, 8))
    targs = (c, torch.from_numpy(np.array(emb)), torch.from_numpy(np.array(head)))
    (tags, count), ctx = check_pair(_tagger(tnlp, 200), targs, _tagger(jnlp, 200),
                                    (jc, emb, head), executor, 7)
    assert tags.dtype == np.int32 and count.dtype == np.int32
    assert int(count) == int(c.lengths.sum())
    assert ((tags == -1) == (np.arange(32)[None] >= c.lengths.numpy()[:, None])).all()
    with tm.session(executor=executor, batch_elements=7, **PORT_CFG) as ctx:
        kept = (tnlp.pos_tag(tnlp.normalize_case(c, 200), *targs[1:]),
                tnlp.token_counts(c))
        names = [[n.fn.name for n in s.nodes] for s in ctx.last_plan()]
    assert any("normalize_case" in s and "pos_tag" in s for s in names), names
    same_values(to_np(kept[0].value), tags)
    if executor != "eager":
        assert ctx.stats["chunks"] > 2


def test_argmax_takes_the_first_maximal_tag():
    """Tied logits (a zero head column twice the largest): the first tag
    wins, as ``jnp.argmax``."""
    c, jc = _corpora(5, 8, 20, 1)
    emb = np.abs(np.random.RandomState(2).randn(20, 4)).astype(np.float32)
    head = np.zeros((4, 3), np.float32)
    head[:, 1] = head[:, 2] = 1.0
    got = tnlp._pos_tag(c, torch.from_numpy(emb), torch.from_numpy(head))
    want = jnlp._pos_tag(jc, jnp.asarray(emb), jnp.asarray(head))
    same_values(to_np(got), to_np(want))
    assert set(np.unique(got.numpy())) <= {-1, 1}


#: token ids outside [0, V) for V = 10 (ROADMAP C12): JAX's gather reads
#: rows [0, 9, 9, 9, 9, 0] (a negative id wraps once, then every id clamps).
OOB_IDS = [0, 9, 10, 12, -1, -11]
OOB_ROWS = [0, 9, 9, 9, 9, 0]


def _oob_corpora():
    """Six documents, each a rotation of ``OOB_IDS``, lengths 6, 6, 5, 4, 6, 3."""
    toks = np.stack([np.roll(OOB_IDS, i) for i in range(6)]).astype(np.int32)
    lengths = np.array([6, 6, 5, 4, 6, 3], np.int32)
    return (tnlp.Corpus(torch.from_numpy(toks), torch.from_numpy(lengths)),
            jnlp.Corpus(jnp.asarray(toks), jnp.asarray(lengths)))


def _oob_model():
    r = np.random.RandomState(7)
    return r.randn(10, 4).astype(np.float32), r.randn(4, 6).astype(np.float32)


def _tag(nlp):
    return lambda corpus, emb, head: nlp.pos_tag(corpus, emb, head)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_out_of_range_ids_read_the_rows_jax_reads(executor):
    c, jc = _oob_corpora()
    emb, head = _oob_model()
    (tags,), _ = check_pair(_tag(tnlp), (c, torch.from_numpy(emb), torch.from_numpy(head)),
                            _tag(jnlp), (jc, jnp.asarray(emb), jnp.asarray(head)),
                            executor, 2)
    rows = dict(zip(OOB_IDS, OOB_ROWS))
    want = np.argmax(emb[np.vectorize(rows.get)(c.tokens.numpy())] @ head, axis=-1)
    valid = np.arange(6)[None] < c.lengths.numpy()[:, None]
    np.testing.assert_array_equal(tags, np.where(valid, want, -1))
    same_values(to_np(tnlp._pos_tag(c, torch.from_numpy(emb), torch.from_numpy(head))),
                to_np(jnlp._pos_tag(jc, jnp.asarray(emb), jnp.asarray(head))))


def test_corpus_split_roundtrip():
    c, jc = _corpora(17, 8, 50, 0)
    t, jt = tnlp.CorpusSplit(17), jnlp.CorpusSplit(17)
    assert t.name == jt.name == "CorpusSplit"
    assert t.info(c).elem_bytes == jt.info(jc).elem_bytes == 8 * 4 + 4
    pieces = [t.split(c, s, min(s + 5, 17)) for s in range(0, 17, 5)]
    same_values(to_np(t.merge(pieces)), to_np(jc))


SIZES = [0, 1, 7, 257]


def _surface(nlp, vocab):
    def pipe(corpus, emb, head):
        folded = nlp.normalize_case(corpus, vocab)
        return nlp.pos_tag(folded, emb, head), nlp.token_counts(folded)
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("docs", SIZES)
def test_nlp_surface(executor, docs):
    vocab, dim, tags = 50, 8, 5
    r = np.random.RandomState(docs + 4)
    c, jc = _corpora(docs, 12, vocab, docs)
    emb = r.randn(vocab, dim).astype(np.float32)
    head = r.randn(dim, tags).astype(np.float32)
    check_pair(_surface(tnlp, vocab), (c, torch.from_numpy(emb), torch.from_numpy(head)),
               _surface(jnlp, vocab), (jc, jnp.asarray(emb), jnp.asarray(head)),
               executor, 32)


def test_ops_and_probe_examples_match_the_reference():
    assert set(tnlp.__all_ops__) == set(jnlp.__all_ops__)
    texs, jexs = tnlp.__probe_examples__(device="cpu"), jnlp.__probe_examples__()
    assert set(texs) == set(jexs)
    for name, jkw in jexs.items():
        fn, jfn = tnlp.__all_ops__[name], jnlp.__all_ops__[name]
        assert fn.name == jfn.name and fn.sa.static == jfn.sa.static
        with jm.session(executor="eager", plan_cache=False, autotune=False):
            want = to_np(jfn(**jkw).value)
        with tm.session(executor="eager", **PORT_CFG):
            got = to_np(fn(**texs[name]).value)
        same_values(got, want, name)
