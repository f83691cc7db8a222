"""Serving CLI of the port: build (or load) a PreTTR index and serve
re-ranking queries, the twin of ``repro.launch.serve``.

1. index: :class:`~repro_torch.index.IndexBuilder` (``--codec
   fp16|fp32|int8|pq``, ``--shards``), or
   ``--load-index`` serves an index built by ``build_index`` (of either
   package; a pruned one at its pruned ``max_doc_len``).
2. serve: per query, encode once, load the candidates, join, rank, with
   Table 5's Query / load / Combine split; ``--service`` serves through
   :class:`~repro_torch.serving.RankingService` instead (``--concurrency``
   queries admitted at a time, packed into shared micro-batches) and
   reports requests/s with p50 / p99 latency.

It runs on the card (``--device cpu`` runs the plain versions on the
CPU).  Not ported: the scale-out router (``--serving-shards`` > 0;
ROADMAP.md Queue 1 item 5): it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def main(argv=None) -> None:
    import torch

    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.data.synthetic_ir import (SyntheticIRWorld, pack_query,
                                               precision_at_k)
    from repro_torch.index import (IndexBuilder, TermRepIndex,
                                   available_codecs)
    from repro_torch.models.backend import BACKENDS, impls_for
    from repro_torch.serving import (RankingService, RankRequest, Reranker,
                                     ServiceOverloadError)

    ap = argparse.ArgumentParser()
    ap.add_argument("--l", type=int, default=2)
    ap.add_argument("--compress-dim", type=int, default=16)
    ap.add_argument("--n-docs", type=int, default=512)
    ap.add_argument("--n-queries", type=int, default=16)
    ap.add_argument("--candidates", type=int, default=64)
    ap.add_argument("--micro-batch", type=int, default=32)
    ap.add_argument("--index-dir", default="results/prettr_index_torch")
    ap.add_argument("--index-batch", type=int, default=64)
    ap.add_argument("--codec", default="fp16", choices=available_codecs())
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--load-index", default=None,
                    help="serve this index directory instead of building "
                         "one (corpus and config flags must match)")
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--service", action="store_true",
                    help="serve through RankingService (cross-query "
                         "packing, prefetch) instead of the Reranker loop")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--serving-shards", type=int, default=0,
                    help="scale-out router shard workers (not ported)")
    ap.add_argument("--store-layer-kv", action="store_true")
    ap.add_argument("--kv-codec", default=None)
    ap.add_argument("--doc-cache-mb", type=float, default=0.0)
    ap.add_argument("--doc-cache-page", type=int, default=None)
    ap.add_argument("--doc-cache-bucket", action="store_true")
    ap.add_argument("--legacy-join", action="store_true")
    ap.add_argument("--max-queue", type=int, default=0)
    ap.add_argument("--verify-reads", action="store_true")
    args = ap.parse_args(argv)
    if args.serving_shards > 0:
        raise SystemExit("--serving-shards is not ported (ROADMAP.md Queue 1 "
                         "item 5, sharded serving)")

    attn_impl, compress_impl = impls_for(args.backend)
    cfg = smoke_config(l=args.l, compress_dim=args.compress_dim,
                       attn_impl=attn_impl, compress_impl=compress_impl)
    world = SyntheticIRWorld(n_docs=args.n_docs, n_queries=args.n_queries,
                             vocab_size=cfg.backbone.vocab_size,
                             doc_len=cfg.max_doc_len - 2, seed=0)
    params = init_prettr(cfg, torch.Generator().manual_seed(0),
                         device=args.device)

    # ---- phase 1: index ----------------------------------------------------
    if args.load_index:
        idx = TermRepIndex.open(args.load_index,
                                verify_reads=args.verify_reads)
        prune_note = (f", pruned keep_frac={idx.prune_policy['keep_frac']}"
                      if idx.prune_policy else "")
        print(f"[index] loaded {len(idx)} docs from {args.load_index} "
              f"(v{idx.version}, {idx.n_shards} shards, "
              f"codec={idx.codec.name}, "
              f"{idx.storage_bytes() / 2**20:.1f} MiB{prune_note})")
    else:
        report = IndexBuilder(
            args.index_dir, cfg, params, codec=args.codec,
            n_shards=args.shards, batch_size=args.index_batch,
            store_layer_kv=args.store_layer_kv, kv_codec=args.kv_codec,
            device=args.device,
        ).build(list(world.docs))
        idx = TermRepIndex.open(args.index_dir,
                                verify_reads=args.verify_reads)
        raw = report.n_tokens * cfg.backbone.d_model * 4
        print(f"[index] {report.n_docs} docs in {report.wall_s:.1f}s "
              f"({report.n_shards} shards, codec={report.codec}, "
              f"fit={report.fit_s:.1f}s encode={report.encode_s:.1f}s "
              f"write={report.write_s:.1f}s), "
              f"{report.storage_bytes / 2**20:.2f} MiB (raw d="
              f"{cfg.backbone.d_model} fp32 would be {raw / 2**20:.1f} MiB)")
    if 0 < idx.max_doc_len < cfg.max_doc_len:
        # a pruned index: serve at its shorter padded doc shape
        cfg = dataclasses.replace(cfg, max_doc_len=idx.max_doc_len)

    def p20(qi, doc_ids):
        return precision_at_k(world.qrels[qi][np.asarray(doc_ids)], 20)

    # ---- phase 2: serve ----------------------------------------------------
    if args.service:
        svc = RankingService(params, cfg, idx, micro_batch=args.micro_batch,
                             fused=not args.legacy_join,
                             doc_cache_mb=args.doc_cache_mb,
                             page_tokens=args.doc_cache_page,
                             page_bucket=args.doc_cache_bucket,
                             max_queue=args.max_queue or None,
                             device=args.device)
        q0, qv0 = pack_query(world.queries[0], cfg.max_query_len)
        svc.rank(q0, qv0, list(world.candidates(0, k=args.candidates)),
                 request_id="warmup")
        svc.reset_stats()
        lat_s, prec, n_degraded = [], [], 0

        def collect():
            nonlocal n_degraded
            for resp in svc.drain():
                lat_s.append(resp.latency_s)
                n_degraded += resp.degraded
                prec.append(p20(int(resp.request_id), resp.doc_ids))

        t0 = time.perf_counter()
        for lo in range(0, world.n_queries, args.concurrency):
            for qi in range(lo, min(lo + args.concurrency, world.n_queries)):
                q, qv = pack_query(world.queries[qi], cfg.max_query_len)
                req = RankRequest(
                    q, qv, list(world.candidates(qi, k=args.candidates)),
                    request_id=str(qi))
                try:
                    svc.submit(req)
                except ServiceOverloadError:
                    collect()                # drain the backlog, resubmit
                    svc.submit(req)
            collect()
        wall = time.perf_counter() - t0
        p50, p99 = np.percentile(lat_s, [50, 99])
        s = svc.stats
        cache_note = (f" doc_cache_hit={s.doc_cache_hit_rate:.2f} "
                      f"resident_docs={s.resident_docs}"
                      if svc.doc_cache is not None else "")
        fault_note = (f" shed={s.n_shed} degraded={n_degraded}"
                      if s.n_shed or n_degraded else "")
        print(f"[serve] service mode: {len(lat_s)} queries x "
              f"{args.candidates} candidates, concurrency={args.concurrency}"
              f" | QPS={len(lat_s) / wall:.2f} p50={p50 * 1e3:.1f}ms "
              f"p99={p99 * 1e3:.1f}ms | batches={s.n_batches} "
              f"pack_fill={s.pack_fill:.2f} "
              f"join_dispatch={s.n_join_dispatch} "
              f"decode_dispatch={s.n_decode_dispatch} "
              f"h2d={s.h2d_bytes / 2**20:.2f}MiB "
              f"doc_hbm={s.doc_hbm_bytes / 2**20:.2f}MiB{cache_note}"
              f"{fault_note} | P@20={np.mean(prec):.3f}")
        return

    rr = Reranker(params, cfg, idx, micro_batch=args.micro_batch,
                  device=args.device)
    stats, prec = [], []
    for qi in range(world.n_queries):
        q, qv = pack_query(world.queries[qi], cfg.max_query_len)
        ranked, _, st = rr.rerank(q, qv,
                                  list(world.candidates(qi, k=args.candidates)))
        stats.append(st)
        prec.append(p20(qi, ranked))
    stats = stats[1:] if len(stats) > 1 else stats     # drop the warm-up
    qenc, load, comb = (np.mean([getattr(s, f) for s in stats]) for f in
                        ("query_encode_s", "load_s", "combine_s"))
    print(f"[serve] {len(stats)} queries x {args.candidates} candidates | "
          f"query={qenc * 1e3:.1f}ms load={load * 1e3:.1f}ms "
          f"combine={comb * 1e3:.1f}ms "
          f"total={(qenc + load + comb) * 1e3:.1f}ms | "
          f"P@20={np.mean(prec):.3f}")


if __name__ == "__main__":
    main()
