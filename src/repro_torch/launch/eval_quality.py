"""Quality-evaluation CLI of the port, the twin of
``repro.launch.eval_quality``: train the ranker briefly, then run the
whole retrieval cascade (synthetic corpus -> codec-encoded index build
-> pooled first-stage top-k -> packed-service re-rank) and report IR
metrics for both stages::

    PYTHONPATH=src python -m repro_torch.launch.eval_quality \\
        --codec int8 --l 2 --k 32 --steps 40

``--sweep`` evaluates every codec at the given ``l`` with one trained
ranker; ``--json PATH`` dumps each stage's metrics and the run's
metadata.  Beside the two stages it prints ``chance``: the re-rank
stage's own pools in a seeded random order (with P@20 for the re-rank
and for chance), the baseline a trained re-ranker has to beat.  Training
steps run the plain backend (``launch.train.prettr_train_step``); the
cascade runs ``--backend`` (default the config's, the kernels) on
``--device`` (default the card).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _train(params, cfg, world, *, steps: int, batch: int, lr: float,
           seed: int, device):
    """``steps`` AdamW steps of the pairwise loss on ``world.pair_batch``
    draws from one generator seeded by ``seed``.  Returns ``(params, last
    loss)``."""
    from repro_torch.launch.train import batch_tensors, prettr_train_step
    from repro_torch.optim import OptimizerConfig, init_opt_state

    opt_cfg = OptimizerConfig(lr=lr)
    opt = init_opt_state(params, opt_cfg)
    rng = np.random.default_rng(seed)
    loss = float("nan")
    for _ in range(steps):
        pos, neg = world.pair_batch(rng, batch, cfg.max_query_len,
                                    cfg.max_doc_len)
        params, opt, loss, _ = prettr_train_step(
            params, opt, cfg, opt_cfg, batch_tensors(pos, device),
            batch_tensors(neg, device))
    return params, float(loss)


def _precision_at_20(world, ids, scores) -> float:
    from repro_torch.data.synthetic_ir import precision_at_k

    return float(np.mean([
        precision_at_k(world.qrels[qi][ids[qi][np.argsort(-scores[qi],
                                                          kind="stable")]],
                       20) for qi in range(len(ids))]))


def chance(world, res, k_metric: int, seed: int = 0) -> dict:
    """The re-rank stage's candidate pools in a seeded random order,
    scored as a stage: the metrics of a re-ranker that carries no
    signal, with ``p@20``."""
    from repro_torch.eval import cascade_metrics

    ids = res.stages["rerank"][0]
    rng = np.random.default_rng(seed)
    scores = np.stack([rng.permutation(ids.shape[1]) for _ in ids]) \
        .astype(np.float32)
    rels = np.stack([world.qrels[qi][ids[qi]] for qi in range(len(ids))])
    out = dict(cascade_metrics(scores, rels, k=k_metric,
                               n_relevant=world.n_relevant(),
                               ideal_rels=world.qrels))
    out["p@20"] = _precision_at_20(world, ids, scores)
    return out


def main(argv=None) -> list[dict]:
    import torch

    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.data.synthetic_ir import SyntheticIRWorld
    from repro_torch.device import resolve_device
    from repro_torch.eval.cascade import run_cascade
    from repro_torch.index import available_codecs
    from repro_torch.models.backend import BACKENDS

    ap = argparse.ArgumentParser(
        description="end-to-end cascade quality evaluation")
    ap.add_argument("--l", type=int, default=2, help="join layer")
    ap.add_argument("--codec", default="fp16", choices=available_codecs())
    ap.add_argument("--sweep", action="store_true",
                    help="evaluate every codec at this --l (one training)")
    ap.add_argument("--k", type=int, default=32,
                    help="first-stage candidate pool depth")
    ap.add_argument("--k-metric", type=int, default=10,
                    help="metric cutoff (mrr@k, ndcg@k, ...)")
    ap.add_argument("--n-docs", type=int, default=256)
    ap.add_argument("--n-queries", type=int, default=16)
    ap.add_argument("--seed", type=int, default=3, help="world seed")
    ap.add_argument("--train-seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=40,
                    help="ranker training steps (0 = untrained params)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress-dim", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--store-layer-kv", action="store_true",
                    help="store + serve the join layer's doc-side K/V "
                         "streams")
    ap.add_argument("--kv-codec", default=None,
                    help="codec of the stored layer-l K/V streams "
                         "(requires --store-layer-kv)")
    ap.add_argument("--keep-frac", type=float, default=1.0,
                    help="index-time token pruning: keep this fraction of "
                         "each doc's most salient tokens (1.0 = off)")
    ap.add_argument("--max-kept-tokens", type=int, default=0,
                    help="cap on kept tokens a doc (0 = no cap)")
    ap.add_argument("--pool", default="mean", choices=["mean", "cls"],
                    help="first-stage doc pooling over stored term reps")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="backend of every cascade stage (default: the "
                         "config's, the kernels)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump metrics + metadata as JSON")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(l=args.l, compress_dim=args.compress_dim)
    world = SyntheticIRWorld(n_docs=args.n_docs, n_queries=args.n_queries,
                             vocab_size=cfg.backbone.vocab_size,
                             doc_len=cfg.max_doc_len - 4, seed=args.seed)
    params = init_prettr(cfg, torch.Generator().manual_seed(args.train_seed),
                         device=device)
    if args.steps:
        t0 = time.time()
        params, loss = _train(params, cfg, world, steps=args.steps,
                              batch=args.batch, lr=args.lr,
                              seed=args.train_seed, device=device)
        print(f"[eval_quality] trained {args.steps} steps in "
              f"{time.time()-t0:.1f}s, final loss {loss:.4f}")

    codecs = available_codecs() if args.sweep else [args.codec]
    dump = []
    for codec in codecs:
        t0 = time.time()
        res = run_cascade(params, cfg, world, codec=codec, k=args.k,
                          k_metric=args.k_metric, n_shards=args.shards,
                          pool=args.pool, backend=args.backend,
                          store_layer_kv=args.store_layer_kv,
                          kv_codec=args.kv_codec, keep_frac=args.keep_frac,
                          max_kept_tokens=args.max_kept_tokens,
                          device=device)
        dt = time.time() - t0
        rerank = dict(res.rerank)
        rerank["p@20"] = _precision_at_20(world, *res.stages["rerank"])
        base = chance(world, res, args.k_metric, seed=args.seed)
        print(f"[eval_quality] codec={codec} l={args.l} k={args.k} "
              f"({dt:.1f}s incl. index build)")
        for stage, metrics in (("first_stage", res.first_stage),
                               ("rerank", rerank), ("chance", base)):
            line = " ".join(f"{m}={v:.4f}" for m, v in metrics.items())
            print(f"  {stage:>11}: {line}")
        dump.append({"first_stage": dict(res.first_stage),
                     "rerank": rerank, "chance": base,
                     "meta": dict(res.meta)})

    if args.json:
        with open(args.json, "w") as f:
            json.dump(dump if args.sweep else dump[0], f, indent=1)
            f.write("\n")
        print(f"[eval_quality] wrote {args.json}")
    return dump


if __name__ == "__main__":
    main()
