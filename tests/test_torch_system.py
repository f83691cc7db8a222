"""End-to-end behaviour of the port on the CPU, as tests/test_system.py
asserts it of the JAX package: fine-tune PreTTR with the split mask ->
precompute + index -> re-rank -> evaluate.  (a) the pairwise loss falls
over 60 steps (windowed means), (b) a checkpoint taken mid-run restores
with the optimizer's step count, (c) the trained re-ranker beats a random
ordering on P@20 / nDCG@20."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.prettr import PreTTRConfig, init_prettr, make_backbone
from repro_torch.data.synthetic_ir import (SyntheticIRWorld, ndcg_at_k,
                                           precision_at_k)
from repro_torch.index import IndexBuilder, TermRepIndex
from repro_torch.launch.train import batch_tensors, prettr_train_step
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.serving import Reranker

MAX_Q, MAX_D = 8, 32


@pytest.fixture(scope="module")
def world():
    return SyntheticIRWorld(n_docs=192, n_queries=12, vocab_size=512,
                            doc_len=24, seed=3)


@pytest.fixture(scope="module")
def cfg():
    bb = make_backbone(n_layers=3, d_model=48, n_heads=4, d_ff=96,
                       vocab_size=512, l=1, max_len=MAX_Q + MAX_D,
                       compute_dtype=torch.float32)
    return PreTTRConfig(backbone=bb, l=1, max_query_len=MAX_Q,
                        max_doc_len=MAX_D, compress_dim=12)


@pytest.fixture(scope="module")
def trained(world, cfg, tmp_path_factory):
    ckdir = str(tmp_path_factory.mktemp("ck"))
    params = init_prettr(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptimizerConfig(lr=3e-3, grad_clip=1.0)
    opt = init_opt_state(params, opt_cfg)
    rng = np.random.default_rng(0)
    losses = []
    for i in range(60):
        pos, neg = world.pair_batch(rng, 16, MAX_Q, MAX_D)
        params, opt, loss, _ = prettr_train_step(
            params, opt, cfg, opt_cfg, batch_tensors(pos, "cpu"),
            batch_tensors(neg, "cpu"))
        losses.append(float(loss))
        if i == 14:   # mid-run checkpoint (restart tested separately)
            save_checkpoint(ckdir, i, {"params": params, "opt": opt})
    return params, losses, ckdir, opt_cfg


def test_training_reduces_loss(trained):
    _, losses, _, _ = trained
    assert all(np.isfinite(losses))
    # windowed means: single-batch pairwise losses are noisy on the tiny
    # synthetic world, but the trend over 60 steps is unambiguous
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses


def test_checkpoint_restart_resumes(trained, cfg):
    _, _, ckdir, opt_cfg = trained
    fresh = init_prettr(cfg, torch.Generator().manual_seed(0), device="cpu")
    target = {"params": fresh, "opt": init_opt_state(fresh, opt_cfg)}
    restored, step = restore_checkpoint(ckdir, target)
    assert step == 14
    assert int(restored["opt"]["step"]) == 15   # 15 AdamW updates happened


def test_index_and_rerank_beats_random(trained, world, cfg, tmp_path):
    params, _, _, _ = trained
    IndexBuilder(str(tmp_path / "idx"), cfg, params, codec="fp16",
                 batch_size=64, device="cpu").build(list(world.docs))
    idx = TermRepIndex.open(str(tmp_path / "idx"))
    rr = Reranker(params, cfg, idx, micro_batch=32, device="cpu")
    rng = np.random.default_rng(1)
    p20_model, p20_rand, ndcg_model = [], [], []
    for qi in range(world.n_queries):
        cands = world.candidates(qi, k=48, seed=7)
        q = np.zeros(MAX_Q, np.int32)
        packed = np.concatenate([[1], world.queries[qi], [2]])[:MAX_Q]
        q[: len(packed)] = packed
        qv = np.arange(MAX_Q) < len(packed)
        ranked, _, _ = rr.rerank(q, qv, list(cands))
        rels = world.qrels[qi][np.asarray(ranked)]
        p20_model.append(precision_at_k(rels, 20))
        ndcg_model.append(ndcg_at_k(rels, 20))
        p20_rand.append(precision_at_k(world.qrels[qi][rng.permutation(cands)],
                                       20))
    assert np.mean(p20_model) > np.mean(p20_rand), \
        (np.mean(p20_model), np.mean(p20_rand))
    assert np.mean(ndcg_model) > 0
