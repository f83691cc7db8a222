"""Training CLI of the port, the twin of ``repro.launch.train``.

Two modes:

* ``--arch prettr-bert`` (default): fine-tune the PreTTR ranker on the
  synthetic IR world with the split attention mask (the paper's training
  phase), validating P@20 every ``--eval-every`` steps and keeping the
  best (the paper's validation protocol, section 5.3).
* ``--arch gemma3-4b``: causal-LM training of the architecture's *smoke*
  config on synthetic tokens.

Every training step runs autograd through the plain backend
(``apply_backend(cfg, "plain")``): the kernel wrappers refuse inputs that
require grad, and the JAX package, too, trains through its plain paths.
Validation runs ``rank_forward`` on ``--backend`` under
``torch.inference_mode()``, so on the card it launches the split
attention, compress / decompress and Sq = 1 kernels.

Fault tolerance: async checkpoints every ``--ckpt-every`` steps in the
JAX store's format, restart from the newest valid one (``--resume``),
corrupt checkpoints skipped.  Each step's batch is drawn from a
generator seeded by ``(--seed, step)``, so a resumed run sees the batches
the uninterrupted run would have seen.  It runs on the card
(``--device cpu`` runs on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def batch_tensors(batch: dict, device) -> dict:
    """A numpy batch (``tokens`` / ``segs`` / ``valid`` and the like) as
    tensors on ``device``: integers as int64, booleans as bool."""
    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not (t.dtype.is_floating_point or t.dtype == torch.bool):
            t = t.long()
        return t.to(device)
    return {k: conv(v) for k, v in batch.items()}


def prettr_train_step(params, opt, cfg, opt_cfg, pos, neg):
    """One AdamW step of the pairwise loss (``rank_pairs_loss``) on a
    (pos, neg) batch of tensors, through the plain backend whatever
    ``cfg``'s, so no kernel is launched.  Returns ``(params, opt, loss,
    grad_norm)``; the inputs are not modified."""
    from repro_torch.core.prettr import rank_pairs_loss
    from repro_torch.models.backend import apply_backend
    from repro_torch.optim import adam_update, value_and_grad

    plain = apply_backend(cfg, "plain")
    loss, grads = value_and_grad(
        lambda p: rank_pairs_loss(p, plain, pos, neg), params)
    params, opt, gn = adam_update(grads, opt, params, opt_cfg,
                                  lr=opt_cfg.lr)
    return params, opt, loss, gn


def step_batch(world, cfg, seed: int, step: int, pairs: int, device):
    """Step ``step``'s (pos, neg) pair batch as tensors on ``device``,
    drawn from a generator seeded by ``(seed, step)``: a resumed run
    draws the batches the uninterrupted run drew."""
    pos, neg = world.pair_batch(np.random.default_rng([seed, step]), pairs,
                                cfg.max_query_len, cfg.max_doc_len)
    return batch_tensors(pos, device), batch_tensors(neg, device)


def validation_scores(params, cfg, world, device, n_queries: int = 8,
                      k: int = 32):
    """``rank_forward`` scores (on ``cfg``'s backend, no gradient) of the
    first ``n_queries`` queries' ``k`` first-stage candidates, [n_queries,
    k] float32 numpy, and their mean P@20."""
    from repro_torch.core.prettr import rank_forward
    from repro_torch.data.synthetic_ir import precision_at_k

    scores, p20 = [], []
    with torch.inference_mode():
        for qi in range(n_queries):
            cands = world.candidates(qi, k=k)
            rows = [world.pack_pair(world.queries[qi], world.docs[d],
                                    cfg.max_query_len, cfg.max_doc_len)
                    for d in cands]
            t, s, v = (np.stack(x) for x in zip(*rows))
            b = batch_tensors({"tokens": t, "segs": s, "valid": v}, device)
            sc = rank_forward(params, cfg, b["tokens"], b["segs"],
                              b["valid"]).float().cpu().numpy()
            scores.append(sc)
            order = np.argsort(-sc, kind="stable")
            p20.append(precision_at_k(world.qrels[qi][cands[order]], 20))
    return np.stack(scores), float(np.mean(p20))


def _restore(args, state):
    from repro_torch.checkpoint import restore_checkpoint

    state, step = restore_checkpoint(args.ckpt_dir, state)
    print(f"[train] resumed from step {step}")
    return state, 0 if step is None else step + 1


def train_prettr(args) -> dict:
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs.prettr_bert import smoke_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.data.synthetic_ir import SyntheticIRWorld
    from repro_torch.device import resolve_device
    from repro_torch.models.backend import impls_for
    from repro_torch.optim import OptimizerConfig, init_opt_state

    device = resolve_device(args.device)
    attn_impl, compress_impl = impls_for(args.backend)
    cfg = smoke_config(l=args.l, compress_dim=args.compress_dim,
                       attn_impl=attn_impl, compress_impl=compress_impl)
    world = SyntheticIRWorld(n_docs=args.n_docs, n_queries=24,
                             vocab_size=cfg.backbone.vocab_size,
                             doc_len=cfg.max_doc_len - 2, seed=0)
    params = init_prettr(cfg, torch.Generator().manual_seed(args.seed),
                         device=device)
    opt_cfg = OptimizerConfig(lr=args.lr)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    start = 0
    if args.resume:
        state, start = _restore(args, state)
    ckpt = AsyncCheckpointer(args.ckpt_dir)

    best = (-1.0, None)
    t0 = time.time()
    history = []
    for step in range(start, args.steps):
        p, o, loss, _ = prettr_train_step(
            state["params"], state["opt"], cfg, opt_cfg,
            *step_batch(world, cfg, args.seed, step, args.batch, device))
        state = {"params": p, "opt": o}
        history.append(float(loss))
        if (step + 1) % args.eval_every == 0:
            _, p20 = validation_scores(state["params"], cfg, world, device)
            if p20 > best[0]:
                best = (p20, step)
            print(f"[train] step {step+1} loss={history[-1]:.4f} "
                  f"P@20={p20:.3f} best={best[0]:.3f}@{best[1]}")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, state)
    ckpt.wait()
    dt = time.time() - t0
    n = args.steps - start
    print(f"[train] done: {n} steps in {dt:.1f}s ({n / max(dt, 1e-9):.2f} "
          f"it/s), final loss "
          f"{history[-1] if history else float('nan'):.4f}, best P@20 "
          f"{best[0]:.3f}")
    return {"loss_first": history[0] if history else None,
            "loss_last": history[-1] if history else None,
            "best_p20": best[0], "start": start, "state": state}


def train_lm(args) -> dict:
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.backend import apply_backend
    from repro_torch.models.transformer import causal_lm_loss, init_params
    from repro_torch.optim import (OptimizerConfig, adam_update,
                                   init_opt_state, value_and_grad)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"--arch {args.arch}: this driver trains the "
                         f"PreTTR ranker and causal LMs, not {spec.family} "
                         f"models")
    device = resolve_device(args.device)
    cfg = apply_backend(spec.smoke, "plain")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device=device)
    opt_cfg = OptimizerConfig(lr=args.lr)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    start = 0
    if args.resume:
        state, start = _restore(args, state)
    ckpt = AsyncCheckpointer(args.ckpt_dir)

    history = []
    for step in range(start, args.steps):
        rng = np.random.default_rng([args.seed, step])
        toks = torch.from_numpy(rng.integers(4, cfg.vocab_size,
                                             (args.batch, 65))).to(device)
        loss, grads = value_and_grad(
            lambda p: causal_lm_loss(p, cfg, toks[:, :-1], toks[:, 1:]),
            state["params"])
        p, o, _ = adam_update(grads, state["opt"], state["params"], opt_cfg,
                              lr=opt_cfg.lr)
        state = {"params": p, "opt": o}
        history.append(float(loss))
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, state)
        if (step + 1) % args.eval_every == 0:
            print(f"[train:{args.arch}] step {step+1} "
                  f"loss={history[-1]:.4f}")
    ckpt.wait()
    if history:
        print(f"[train:{args.arch}] loss {history[0]:.3f} -> "
              f"{history[-1]:.3f}")
    return {"loss_first": history[0] if history else None,
            "loss_last": history[-1] if history else None,
            "start": start, "state": state}


def parse_args(argv=None):
    from repro_torch.models.backend import BACKENDS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="prettr-bert")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--l", type=int, default=2)
    ap.add_argument("--compress-dim", type=int, default=16)
    ap.add_argument("--n-docs", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="results/ckpt_torch")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS),
                    help="backend of validation (training steps always "
                         "run the plain one)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.arch == "prettr-bert":
        return train_prettr(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
