"""Synthetic ad-hoc-retrieval world, a copy of ``repro.data.synthetic_ir``
(numpy only): the same seed gives the same docs, queries and qrels, bit
for bit.  It stands in for ClueWeb09-B / TREC disks, which are licensed
corpora.

Construction: ``n_topics`` latent topics, each a Zipf-reweighted slice of
the vocab.  A document mixes 1-2 topics; a query is 2-3 tokens drawn from
one topic (matching Table 2's query-length stats).  Graded relevance of
(q, d) = quantized topic affinity + noise, giving qrels with the same
*shape* as TREC judgments so P@20 / nDCG@20 / ERR@20 sweeps are meaningful.

The generator also emits CAR-style (heading, paragraph) pairs for compressor
pre-training: half matching (same topic), half random — mirroring §5.3.

Seeding contract (audited for the CI quality gate): every random draw in
this module flows from one explicit seed.  ``__post_init__`` derives
*independent per-stage generators* (topics / docs / queries / labels) from
``np.random.SeedSequence(seed).spawn``, so each stage's stream is a pure
function of ``(seed, stage)`` — changing ``n_docs`` regenerates documents
without silently reshuffling the queries or the relevance labels, which is
what lets the quality harness sweep corpus sizes while the labels for the
surviving (query, doc) pairs stay put.  ``candidates()`` seeds per
``(seed, qi)`` via ``SeedSequence`` keying (plain ``seed + qi`` collides:
(0, 1) and (1, 0) would share a stream).  Training-time samplers
(``pair_batch`` / ``car_pairs``) take the caller's ``Generator`` so step
order stays under the training loop's control.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.tokenizer import CLS, PAD, SEP, N_SPECIAL


# -- model-input packing (shared by serve / index-build / examples) ----------


def pack_query(q_ids, max_query_len: int):
    """``[CLS] q [SEP]`` padded to ``max_query_len`` ->
    (tokens [Lq] int32, valid [Lq] bool)."""
    q = np.full(max_query_len, PAD, np.int32)
    packed = np.concatenate([[CLS], np.asarray(q_ids), [SEP]])[:max_query_len]
    q[: len(packed)] = packed
    valid = np.arange(max_query_len) < len(packed)
    return q, valid


def pack_query_batch(query_token_lists, max_query_len: int):
    """Fixed-shape query batch (retrieval / cascade evaluation) ->
    (tokens [B, Lq] int32, valid [B, Lq] bool)."""
    tokens = np.full((len(query_token_lists), max_query_len), PAD, np.int32)
    valid = np.zeros((len(query_token_lists), max_query_len), bool)
    for i, q in enumerate(query_token_lists):
        tokens[i], valid[i] = pack_query(q, max_query_len)
    return tokens, valid


def pack_doc(d_ids, max_doc_len: int):
    """``d [SEP]`` (truncated, [SEP]-terminated) padded to ``max_doc_len``
    -> (tokens [Ld] int32, n_tokens)."""
    d = np.full(max_doc_len, PAD, np.int32)
    packed = np.concatenate([np.asarray(d_ids)[: max_doc_len - 1], [SEP]])
    d[: len(packed)] = packed
    return d, len(packed)


def pack_doc_batch(doc_token_lists, max_doc_len: int):
    """Fixed-shape doc batch for ``precompute_docs`` ->
    (tokens [N, Ld] int32, lengths [N] int64, valid [N, Ld] bool)."""
    tokens = np.full((len(doc_token_lists), max_doc_len), PAD, np.int32)
    lengths = np.zeros(len(doc_token_lists), np.int64)
    for i, d in enumerate(doc_token_lists):
        tokens[i], lengths[i] = pack_doc(d, max_doc_len)
    valid = np.arange(max_doc_len)[None] < lengths[:, None]
    return tokens, lengths, valid


@dataclasses.dataclass
class SyntheticIRWorld:
    vocab_size: int = 8192
    n_topics: int = 64
    n_docs: int = 2048
    n_queries: int = 64
    doc_len: int = 128
    query_len: tuple[int, int] = (2, 3)
    seed: int = 0

    def __post_init__(self):
        # one explicit seed, four independent stage streams (see module
        # docstring): corpus edits can't perturb queries or labels
        topic_rng, doc_rng, query_rng, label_rng = (
            np.random.default_rng(s)
            for s in np.random.SeedSequence(self.seed).spawn(4))
        v = self.vocab_size - N_SPECIAL
        # per-topic token distributions: Zipf base reordered per topic
        base = 1.0 / np.arange(1, v + 1) ** 1.1
        self.topic_token_logits = np.stack([
            np.log(base[topic_rng.permutation(v)])
            for _ in range(self.n_topics)])
        # documents
        self.doc_topics = doc_rng.integers(0, self.n_topics,
                                           size=(self.n_docs, 2))
        self.doc_topic_w = doc_rng.dirichlet([1.0, 0.5], size=self.n_docs)
        self.docs = np.stack([self._sample_doc(doc_rng, i)
                              for i in range(self.n_docs)])
        # queries: 2-3 tokens from one topic's head
        self.query_topics = query_rng.integers(0, self.n_topics,
                                               size=self.n_queries)
        self.queries = [self._sample_query(query_rng, t)
                        for t in self.query_topics]
        self.qrels = self._label(label_rng)

    def _label(self, rng: np.random.Generator) -> np.ndarray:
        """Graded relevance labels [n_queries, n_docs] in {0, 1, 2}:
        quantized topic affinity + seeded judge noise (TREC-shaped
        qrels — most docs unjudged-equivalent 0, a thin graded tail)."""
        aff = np.zeros((self.n_queries, self.n_docs))
        for qi, qt in enumerate(self.query_topics):
            m = (self.doc_topics == qt)
            aff[qi] = (m * self.doc_topic_w).sum(-1)
        a = aff + rng.normal(0, 0.05, size=aff.shape)
        return np.where(a > 0.6, 2,
                        np.where(a > 0.25, 1, 0)).astype(np.int32)

    # -- relevance-label accessors (cascade evaluation) -----------------------
    def n_relevant(self, min_grade: int = 1) -> np.ndarray:
        """Per-query count of corpus-wide relevant docs ([n_queries]
        int64) — the denominator for recall@k / mean percentile-rank."""
        return (self.qrels >= min_grade).sum(-1).astype(np.int64)

    def relevant_docs(self, qi: int, min_grade: int = 1) -> np.ndarray:
        """Doc ids judged >= ``min_grade`` for query ``qi``."""
        return np.flatnonzero(self.qrels[qi] >= min_grade)

    # -- sampling helpers ---------------------------------------------------
    def _topic_probs(self, topics, weights):
        logits = (self.topic_token_logits[topics] * np.asarray(weights)[:, None]).sum(0)
        p = np.exp(logits - logits.max())
        return p / p.sum()

    def _sample_doc(self, rng, i):
        p = self._topic_probs(self.doc_topics[i], self.doc_topic_w[i])
        return rng.choice(len(p), size=self.doc_len, p=p) + N_SPECIAL

    def _sample_query(self, rng, topic):
        n = rng.integers(self.query_len[0], self.query_len[1] + 1)
        p = self._topic_probs([topic], [1.0])
        # queries draw from the topic head (most characteristic tokens)
        head = np.argsort(p)[::-1][:64]
        ph = p[head] / p[head].sum()
        return rng.choice(head, size=n, p=ph) + N_SPECIAL

    # -- model inputs ---------------------------------------------------------
    def pack_pair(self, q_ids, d_ids, max_query_len, max_doc_len):
        q = np.concatenate([[CLS], q_ids, [SEP]])[:max_query_len]
        d = np.concatenate([d_ids[: max_doc_len - 1], [SEP]])
        tokens = np.full(max_query_len + max_doc_len, PAD, np.int32)
        valid = np.zeros(max_query_len + max_doc_len, bool)
        tokens[: len(q)] = q
        valid[: len(q)] = True
        tokens[max_query_len: max_query_len + len(d)] = d
        valid[max_query_len: max_query_len + len(d)] = True
        segs = np.concatenate([np.zeros(max_query_len, np.int32),
                               np.ones(max_doc_len, np.int32)])
        return tokens, segs, valid

    def pair_batch(self, rng: np.random.Generator, batch: int,
                   max_query_len: int, max_doc_len: int):
        """Pairwise training batch (pos, neg), paper §5.3: positives are
        judged-relevant docs, negatives other top-ranked (here: judged-0)."""
        pos, neg = [], []
        for _ in range(batch):
            qi = rng.integers(self.n_queries)
            rel = np.flatnonzero(self.qrels[qi] >= 1)
            irr = np.flatnonzero(self.qrels[qi] == 0)
            if len(rel) == 0:
                rel = irr
            pos.append(self.pack_pair(self.queries[qi],
                                      self.docs[rng.choice(rel)],
                                      max_query_len, max_doc_len))
            neg.append(self.pack_pair(self.queries[qi],
                                      self.docs[rng.choice(irr)],
                                      max_query_len, max_doc_len))

        def stack(rows):
            t, s, v = zip(*rows)
            return {"tokens": np.stack(t), "segs": np.stack(s),
                    "valid": np.stack(v)}
        return stack(pos), stack(neg)

    def car_pairs(self, rng: np.random.Generator, batch: int,
                  max_query_len: int, max_doc_len: int):
        """CAR-style heading/paragraph pairs for compressor pre-training."""
        rows = []
        for _ in range(batch):
            di = rng.integers(self.n_docs)
            topic = self.doc_topics[di][0]
            if rng.random() < 0.5:
                heading = self._sample_query(rng, topic)
            else:
                heading = self._sample_query(rng, rng.integers(self.n_topics))
            rows.append(self.pack_pair(heading, self.docs[di],
                                       max_query_len, max_doc_len))
        t, s, v = zip(*rows)
        return {"tokens": np.stack(t), "segs": np.stack(s), "valid": np.stack(v)}

    # -- evaluation -----------------------------------------------------------
    def candidates(self, qi: int, k: int = 100, seed: int = 0):
        """First-stage candidate pool: top-k by noisy affinity (BM25
        stand-in; ``repro_torch.retrieval.FirstStageRetriever`` is the real
        first stage over an index's stored reps)."""
        rng = np.random.default_rng(np.random.SeedSequence((seed, qi)))
        score = self.qrels[qi] + rng.normal(0, 0.8, size=self.n_docs)
        return np.argsort(score)[::-1][:k]


def precision_at_k(ranked_rels: np.ndarray, k: int = 20) -> float:
    return float((ranked_rels[:k] >= 1).mean())


def ndcg_at_k(ranked_rels: np.ndarray, k: int = 20) -> float:
    gains = (2.0 ** ranked_rels[:k] - 1) / np.log2(np.arange(2, k + 2))
    ideal = np.sort(ranked_rels)[::-1][:k]
    ideal_g = (2.0 ** ideal - 1) / np.log2(np.arange(2, k + 2))
    denom = ideal_g.sum()
    return float(gains.sum() / denom) if denom > 0 else 0.0


def err_at_k(ranked_rels: np.ndarray, k: int = 20, max_grade: int = 2) -> float:
    r = (2.0 ** ranked_rels[:k] - 1) / (2.0 ** max_grade)
    err, p_stop = 0.0, 1.0
    for i, ri in enumerate(r):
        err += p_stop * ri / (i + 1)
        p_stop *= (1 - ri)
    return float(err)
