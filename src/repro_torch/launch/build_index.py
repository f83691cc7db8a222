"""Offline index-build CLI of the port: corpus -> encode -> sharded
codec write -> verify, the twin of ``repro.launch.build_index``::

    PYTHONPATH=src python -m repro_torch.launch.build_index \\
        --out results/prettr_index_torch --n-docs 512 --codec pq --verify

then serve it without rebuilding::

    PYTHONPATH=src python -m repro_torch.launch.serve --service \\
        --load-index results/prettr_index_torch --n-docs 512

It runs on the card (``--device cpu`` runs the plain versions on the
CPU).  The corpus and config seeds match ``repro_torch.launch.serve``, so
an index built here matches the one ``serve`` builds inline (pass the
same ``--l`` / ``--compress-dim`` / ``--n-docs``).  ``--distill-steps``
pre-trains the compressor with the paper's attention-MSE loss (Eq. 2) on
CAR-style heading / paragraph pairs before encoding
(:func:`distill_compressor`).  ``--data-parallel`` splits each encode
batch over a ``("data",)`` mesh of every visible card.
"""
from __future__ import annotations

import argparse

import numpy as np


def distill_compressor(params, cfg, world, steps: int, seed: int = 0,
                       batch: int = 8):
    """Paper section 4.2, stage 1: distil the attention maps into the
    compressor (Eq. 2) on unlabeled CAR-style pairs with AdamW at 3e-3,
    on the params' device; the backbone stays frozen (only the
    compressor's leaves require grad).  Returns ``(compressor params,
    [loss a step])``."""
    import torch

    from repro_torch.core.compression import attention_mse_loss
    from repro_torch.optim import (OptimizerConfig, adam_update,
                                   init_opt_state, value_and_grad)

    comp = params["compressor"]
    dev = comp["w_comp"].device
    opt_cfg = OptimizerConfig(lr=3e-3)
    opt = init_opt_state(comp, opt_cfg)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        pairs = world.car_pairs(rng, batch, cfg.max_query_len,
                                cfg.max_doc_len)
        tokens = torch.from_numpy(pairs["tokens"]).long().to(dev)
        loss, g = value_and_grad(
            lambda c: attention_mse_loss(params["backbone"], c,
                                         cfg.backbone, tokens, l=cfg.l),
            comp)
        comp, opt, _ = adam_update(g, opt, comp, opt_cfg, lr=opt_cfg.lr)
        losses.append(float(loss))
    if losses:
        print(f"[build_index] distilled compressor {steps} steps: "
              f"attn-MSE {losses[0]:.3e} -> {losses[-1]:.3e}")
    return comp, losses


def main(argv=None) -> None:
    import torch

    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.data.synthetic_ir import SyntheticIRWorld
    from repro_torch.index import (IndexBuilder, TermRepIndex,
                                   available_codecs, verify_index)
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.backend import BACKENDS, impls_for

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/prettr_index_torch",
                    help="index directory to create")
    ap.add_argument("--l", type=int, default=2)
    ap.add_argument("--compress-dim", type=int, default=16)
    ap.add_argument("--n-docs", type=int, default=512)
    ap.add_argument("--codec", default="fp16", choices=available_codecs())
    ap.add_argument("--shards", type=int, default=1,
                    help="number of shard-NNNNN/ output directories")
    ap.add_argument("--batch", type=int, default=64,
                    help="fixed encode batch shape")
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--store-layer-kv", action="store_true",
                    help="also store the join layer's doc-side K/V streams")
    ap.add_argument("--kv-codec", default=None,
                    help="codec of the stored layer-l K/V streams (requires "
                         "--store-layer-kv)")
    ap.add_argument("--keep-frac", type=float, default=1.0,
                    help="index-time token pruning: keep this fraction of "
                         "each doc's most salient tokens (1.0 keeps all)")
    ap.add_argument("--max-kept-tokens", type=int, default=0,
                    help="cap on kept tokens a doc (0: no cap)")
    ap.add_argument("--distill-steps", type=int, default=0,
                    help="attention-MSE compressor distillation steps "
                         "before encoding (0 = keep the init compressor)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="split encode batches over every visible card")
    ap.add_argument("--writer-depth", type=int, default=2,
                    help="encoded batches the writer thread may lag (0: "
                         "synchronous writes)")
    ap.add_argument("--verify", action="store_true",
                    help="re-encode a doc sample and compare the stored "
                         "streams byte for byte")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    attn_impl, compress_impl = impls_for(args.backend)
    cfg = smoke_config(l=args.l, compress_dim=args.compress_dim,
                       attn_impl=attn_impl, compress_impl=compress_impl)
    world = SyntheticIRWorld(n_docs=args.n_docs,
                             vocab_size=cfg.backbone.vocab_size,
                             doc_len=cfg.max_doc_len - 2, seed=args.seed)
    params = init_prettr(cfg, torch.Generator().manual_seed(0),
                         device=args.device)
    if args.distill_steps and cfg.compress_dim:
        params["compressor"], _ = distill_compressor(
            params, cfg, world, args.distill_steps, seed=args.seed)
    mesh = None
    if args.data_parallel:
        ndev = torch.cuda.device_count()
        if ndev > 1:
            mesh = make_device_mesh("data")
            print(f"[build_index] data-parallel over {ndev} devices")
        else:
            print("[build_index] --data-parallel: one device visible, "
                  "running single-host")
    builder = IndexBuilder(args.out, cfg, params, codec=args.codec,
                           n_shards=args.shards, batch_size=args.batch,
                           writer_depth=args.writer_depth,
                           store_layer_kv=args.store_layer_kv,
                           kv_codec=args.kv_codec, keep_frac=args.keep_frac,
                           max_kept_tokens=args.max_kept_tokens,
                           device=args.device, mesh=mesh)
    report = builder.build(list(world.docs))
    prune_note = ""
    if builder.prune:
        prune_note = (f" | pruned keep_frac={args.keep_frac} "
                      f"cap={builder.pruned_max_doc_len} tokens/doc")
    print(f"[build_index] {report.n_docs} docs / {report.n_tokens} tokens "
          f"-> {args.out} ({report.n_shards} shards, codec={report.codec}) | "
          f"{report.storage_bytes / 2**20:.2f} MiB "
          f"({report.bytes_per_doc:.0f} B/doc) | fit={report.fit_s:.1f}s "
          f"encode={report.encode_s:.1f}s write={report.write_s:.1f}s "
          f"wall={report.wall_s:.1f}s{prune_note}")
    index = TermRepIndex.open(args.out)
    assert len(index) == report.n_docs
    if args.verify:
        n = verify_index(index, cfg, params, list(world.docs), sample=16,
                         seed=args.seed, device=args.device)
        print(f"[build_index] verify: {n} docs re-encoded, stored streams "
              f"byte-identical; {index.verify_integrity()} chunk checksums "
              f"hold")


if __name__ == "__main__":
    main()
