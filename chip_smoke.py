#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main path at the paper's full width
(``repro_torch.configs.prettr_bert.full_config``: 12 layers, d=768, split
at l=6, e=256 fp16 storage, bf16 compute) with seeded random weights:

1. device  -- the card's name and power limit, the kernel build time;
2. kernels -- each hand-written kernel at its main-path shape against its
   plain PyTorch version on the same inputs, with times (CUDA events,
   median of 20 after warm-up) beside the plain version, one library call
   that computes the same function, and the least time the card could take;
3. index   -- ``IndexBuilder`` writes a 512-document fp16 index, reopened
   with ``TermRepIndex``;
4. serve   -- ``RankingService`` answers 8 requests x 64 candidates in
   micro-batches of 32, through the kernels and through the plain impl, in
   bf16 and in float32;
   then one drain of the kernel path under ``torch.profiler``: the
   device's busy share and its kernels by time;
5. soundness -- ``rank_forward == join_and_score(encode_query,
   precompute_docs)`` on 4 pairs, float32 over fp16 storage.

Kernel launches are counted per path: every counter is set to 0 just
before the index build, each timed serving drain and the soundness check,
and read just after.  A path that misses a kernel it must run, or a plain
run that launches any, fails the script.  The ``kernels`` line's
``launches`` is the main path's (index build plus the bf16 drain),
``launches_by_path`` each path's own.

Every phase that fails raises and the script exits non-zero.  It prints
one JSON object per line; the second to last is the ``kernels`` line, the
last ``{"ok": true, "device": ...}``.  Run from the repository root::

    python3 chip_smoke.py
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_DOCS, N_REQUESTS, N_CANDIDATES, MICRO_BATCH = 512, 8, 64, 32
INDEX_BATCH = 64
N_SOUNDNESS = 4
CLS, SEP = 1, 2
# published H100 SXM peaks (NVIDIA data sheet, dense), at 700 W
PEAK_BF16_FLOPS = 989e12          # tensor cores, dense
PEAK_F32_FLOPS = 67e12            # CUDA cores
PEAK_BYTES = 3.35e12              # HBM3
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
# rank_forward against the split path, float32 over fp16 storage: both
# round the doc reps through the same fp16 cast, so only summation order
# differs (about 1e-6 at full width)
SOUND_TOL = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, n=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kv_bytes(lengths, heads, dh, elt):
    """Bytes of one K and one V operand up to each batch row's last valid
    key: what an attention over these masks needs to read."""
    return 2 * int(lengths.sum()) * heads * dh * elt


def bound(flops, n_bytes, flops_peak):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / flops_peak * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _prefix_mask(torch, gen, b, n, lo):
    lengths = torch.randint(lo, n + 1, (b, 1), generator=gen, device="cuda")
    return torch.arange(n, device="cuda")[None] < lengths


def check_kernels(torch, cfg):
    """Every kernel at its main-path shapes against its plain version;
    returns the kernels-line rows (launches filled in later)."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_compress import (compress_ref,
                                                    decompress_ref,
                                                    fused_compress,
                                                    fused_decompress)
    from repro_torch.kernels.join_attention import (join_attention_ref,
                                                    join_flash_attention)
    from repro_torch.kernels.masking import last_valid_lengths
    from repro_torch.kernels.split_attention import (split_attention_ref,
                                                     split_flash_attention)

    bb = cfg.backbone
    h, dh, d, e = bb.n_heads, bb.dh, bb.d_model, cfg.compress_dim
    lq, ld = cfg.max_query_len, cfg.max_doc_len
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def compare(name, got, want, dtype_name, shape):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = TOL[dtype_name]
        ok = bool(torch.all(err <= tol + tol * want.float().abs()))
        emit({"phase": "kernel_check", "kernel": name, "shape": shape,
              "dtype": dtype_name, "max_abs_err": err.max().item(),
              "tol": {"rtol": tol, "atol": tol}, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} {shape} {dtype_name}: kernel "
                                 f"disagrees with its plain version")
        return err.max().item()

    rows = []

    def record(name, source, replaces, err, kernel_fn, plain_fn, library_fn,
               flops, n_bytes, peak, peak_name):
        ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
        library_ms = time_ms(library_fn)
        bound_ms, bound_by = bound(flops, n_bytes, peak)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        emit({"phase": "kernel_time", **row, "peak": peak_name,
              "flops": flops, "bytes": n_bytes})
        rows.append(row)

    # -- split attention: encode_query, rank_forward's seg_boundary form
    #    and precompute_docs in float32 and bf16; the last, the bf16
    #    index-time shape, is the timed one
    for dtype, dname in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
        for b, s, sb in ((1, lq, -1), (N_SOUNDNESS, lq + ld, lq),
                         (INDEX_BATCH, ld, -1)):
            q, k, v = (rand(b, h, s, dh, dtype=dtype) for _ in range(3))
            valid = _prefix_mask(torch, gen, b, s, s // 4)
            if sb >= 0:                    # two prefixes: query and doc
                valid = torch.cat([_prefix_mask(torch, gen, b, sb, 3),
                                   _prefix_mask(torch, gen, b, s - sb, 8)], 1)
            lengths = last_valid_lengths(valid)
            err = compare("split_attention",
                          split_flash_attention(q, k, v, lengths,
                                                k_valid=valid,
                                                seg_boundary=sb),
                          split_attention_ref(q, k, v, lengths, valid,
                                              seg_boundary=sb),
                          dname, [b, h, s, dh])
    mask = valid[:, None, None, :].expand(b, 1, s, s)
    record("split_attention", "src/repro_torch/csrc/split_attention.cu",
           "src/repro/kernels/split_attention/kernel.py:109", err,
           lambda: split_flash_attention(q, k, v, lengths, k_valid=valid),
           lambda: split_attention_ref(q, k, v, lengths, valid),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
           4 * dh * h * s * valid.sum().item(),
           2 * nbytes(q) + kv_bytes(lengths, h, dh, q.element_size())
           + nbytes(valid, lengths), PEAK_BF16_FLOPS, "bf16 tensor cores")

    # -- join attention: the join layers (Sq = Lq + Ld) and the CLS row
    b = MICRO_BATCH
    kq, vq = (rand(b, h, lq, dh) for _ in range(2))
    kd, vd = (rand(b, h, ld, dh) for _ in range(2))
    kqv = _prefix_mask(torch, gen, b, lq, 3)
    kdv = _prefix_mask(torch, gen, b, ld, ld // 4)
    k_cat, v_cat = torch.cat([kq, kd], 2), torch.cat([vq, vd], 2)
    n_keys = kqv.sum().item() + kdv.sum().item()
    kv_needed = kv_bytes(last_valid_lengths(kqv) + last_valid_lengths(kdv),
                         h, dh, kq.element_size())
    fn = join_flash_attention       # Sq = 1 launches the row kernel
    for name, sq in (("join_attention", lq + ld), ("join_attention_row", 1)):
        q = rand(b, h, sq, dh)
        f32 = [t.float() for t in (q, kq, vq, kd, vd)]
        compare(name, fn(*f32, kqv, kdv), join_attention_ref(*f32, kqv, kdv),
                "float32", [b, h, sq, dh])
        err = compare(name, fn(q, kq, vq, kd, vd, kqv, kdv),
                      join_attention_ref(q, kq, vq, kd, vd, kqv, kdv),
                      "bfloat16", [b, h, sq, dh])
        mask = torch.cat([kqv, kdv], 1)[:, None, None, :].expand(b, 1, sq,
                                                                 lq + ld)
        record(name, "src/repro_torch/csrc/join_attention.cu",
               "src/repro/kernels/join_attention/kernel.py:130", err,
               lambda: fn(q, kq, vq, kd, vd, kqv, kdv),
               lambda: join_attention_ref(q, kq, vq, kd, vd, kqv, kdv),
               lambda: F.scaled_dot_product_attention(q, k_cat, v_cat,
                                                      attn_mask=mask),
               4 * dh * h * sq * n_keys,
               2 * nbytes(q) + kv_needed + nbytes(kqv, kdv), PEAK_BF16_FLOPS,
               "bf16 tensor cores")

    # -- compress (index time) and decompress (every micro-batch); their
    #    weights stay float32, so the products are float32 operations
    w_c = rand(d, e, dtype=torch.float32, scale=d ** -0.5)
    b_c = rand(e, dtype=torch.float32, scale=0.1)
    t_c = INDEX_BATCH * ld
    x = rand(t_c, d)
    compare("compress", fused_compress(x.float(), w_c, b_c),
            compress_ref(x.float(), w_c, b_c), "float16", [t_c, d, e])
    out = fused_compress(x, w_c, b_c)
    err = compare("compress", out, compress_ref(x, w_c, b_c), "float16",
                  [t_c, d, e])
    w16, b16 = w_c.to(x.dtype), b_c.to(x.dtype)
    record("compress", "src/repro_torch/csrc/fused_compress.cu",
           "src/repro/kernels/fused_compress/kernel.py:45", err,
           lambda: fused_compress(x, w_c, b_c),
           lambda: compress_ref(x, w_c, b_c),
           lambda: F.gelu(torch.addmm(b16, x, w16), approximate="tanh"),
           2 * t_c * d * e, nbytes(x, w_c, b_c, out), PEAK_F32_FLOPS,
           "f32 CUDA cores")

    dargs = (rand(e, d, dtype=torch.float32, scale=e ** -0.5),
             rand(d, dtype=torch.float32, scale=0.1),
             1 + rand(d, dtype=torch.float32, scale=0.1),
             rand(d, dtype=torch.float32, scale=0.1))
    t_d = MICRO_BATCH * ld
    r = rand(t_d, e, dtype=torch.float16)
    compare("decompress", fused_decompress(r, *dargs, out_dtype=torch.float32),
            decompress_ref(r, *dargs, out_dtype=torch.float32), "float32",
            [t_d, e, d])
    out = fused_decompress(r, *dargs)
    err = compare("decompress", out,
                  decompress_ref(r, *dargs, out_dtype=torch.bfloat16),
                  "bfloat16", [t_d, e, d])
    lib = [t.to(torch.float16) for t in dargs]
    record("decompress", "src/repro_torch/csrc/fused_compress.cu",
           "src/repro/kernels/fused_compress/kernel.py:64", err,
           lambda: fused_decompress(r, *dargs),
           lambda: decompress_ref(r, *dargs, out_dtype=torch.bfloat16),
           lambda: F.layer_norm(torch.addmm(lib[1], r, lib[0]), (d,),
                                lib[2], lib[3], eps=1e-6),
           2 * t_d * e * d + 8 * t_d * d, nbytes(r, *dargs, out),
           PEAK_F32_FLOPS, "f32 CUDA cores")
    return rows


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------


def make_docs(rng, cfg):
    """Seeded random docs: three in four fill max_doc_len, the rest are
    shorter, so the kernels meet ragged doc lengths."""
    import numpy as np
    vocab = cfg.backbone.vocab_size
    lens = np.where(rng.random(N_DOCS) < 0.75, cfg.max_doc_len - 1,
                    rng.integers(16, cfg.max_doc_len - 1, N_DOCS))
    return [rng.integers(4, vocab, int(n)) for n in lens]


def make_requests(rng, cfg):
    import numpy as np
    reqs = []
    for _ in range(N_REQUESTS):
        n_q = int(rng.integers(2, cfg.max_query_len - 2))
        q = np.zeros(cfg.max_query_len, np.int64)
        q[: n_q + 2] = [CLS, *rng.integers(4, cfg.backbone.vocab_size, n_q),
                        SEP]
        reqs.append((q, q != 0, [int(i) for i in
                                 rng.choice(N_DOCS, N_CANDIDATES, False)]))
    return reqs


def launch_counters():
    """Each kernel's launch counter, as (wrapper, attribute)."""
    from repro_torch.kernels.fused_compress import (fused_compress,
                                                    fused_decompress)
    from repro_torch.kernels.join_attention import join_flash_attention
    from repro_torch.kernels.split_attention import split_flash_attention
    return {"split_attention": (split_flash_attention, "launches"),
            "join_attention": (join_flash_attention, "launches"),
            "join_attention_row": (join_flash_attention, "row_launches"),
            "compress": (fused_compress, "launches"),
            "decompress": (fused_decompress, "launches")}


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before it;
    returns its result and the launches it made, by kernel."""
    counters = launch_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    result = fn()
    return result, {k: getattr(w, a) for k, (w, a) in counters.items()}


# the kernels each path must launch; a plain-impl run must launch none
PATH_KERNELS = {
    "index": ("split_attention", "compress"),
    "serve": ("split_attention", "join_attention", "join_attention_row",
              "decompress"),
    "serve_f32": ("split_attention", "join_attention", "join_attention_row",
                  "decompress"),
    "soundness": ("split_attention", "join_attention", "join_attention_row",
                  "compress", "decompress"),
    "plain_bf16": (), "plain_f32": (),
}


def serve(torch, params, cfg, index, requests, label, name):
    """Serve ``requests`` after a one-request warm-up; returns the scores
    and the launches of the timed drain alone."""
    from repro_torch.serving import RankingService, RankRequest
    svc = RankingService(params, cfg, index, micro_batch=MICRO_BATCH)
    q, qv, ids = requests[0]                 # warm-up: one request
    svc.rank(q, qv, ids[:MICRO_BATCH])
    svc._qcache.clear()
    torch.cuda.synchronize()
    svc.stats = type(svc.stats)()

    def drain():
        for i, (q, qv, ids) in enumerate(requests):
            svc.submit(RankRequest(q, qv, ids, request_id=f"r{i}"))
        return svc.drain()

    t0 = time.perf_counter()
    resp, launches = counted(drain)
    wall = time.perf_counter() - t0
    scores = {}
    for r in resp:
        assert list(r.scores) == sorted(r.scores, reverse=True), r.request_id
        for doc, sc in zip(r.doc_ids, r.scores):
            scores[(r.request_id, doc)] = float(sc)
    finite = all(math.isfinite(s) for s in scores.values())
    st = svc.stats
    emit({"phase": "serve", "run": label, "device": name,
          "requests": len(requests), "rows": st.n_rows,
          "batches": st.n_batches, "wall_s": wall,
          "qps": len(requests) / wall, "docs_per_s": st.n_rows / wall,
          "pad_rows": st.n_pad_rows, "h2d_bytes": st.h2d_bytes,
          "query_encode_s": st.query_encode_s, "load_s": st.load_s,
          "combine_s": st.combine_s, "finite": finite,
          "launches": launches})
    if not finite or len(scores) != N_REQUESTS * N_CANDIDATES:
        raise AssertionError(f"serve {label}: non-finite or missing scores")
    return scores, launches


def profile_serve(torch, params, cfg, index, requests, name):
    """Where a drain's device time goes: one drain of two requests (four
    micro-batches) under torch.profiler, the device's busy share of the
    wall time and its kernels by total time."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import RankingService, RankRequest
    svc = RankingService(params, cfg, index, micro_batch=MICRO_BATCH)
    q, qv, ids = requests[0]
    svc.rank(q, qv, ids[:MICRO_BATCH])         # warm-up
    svc._qcache.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, (q, qv, ids) in enumerate(requests[:2]):
            svc.submit(RankRequest(q, qv, ids, request_id=f"p{i}"))
        svc.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        ours = re.search(r"(\w+_kernel)\b", e.key)
        key = ours.group(1) if ours else e.key[:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + e.count, t + us / 1e3)
    busy_ms = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit({"phase": "profile", "run": "cuda_bf16", "device": name,
          "micro_batches": 2 * N_CANDIDATES // MICRO_BATCH,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms if busy_ms else None,
          "top": [{"name": k, "count": n, "device_ms": t}
                  for k, (n, t) in top]})


def max_diff(a, b):
    return max(abs(a[k] - b[k]) for k in a)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    import numpy as np
    from repro_torch.configs.prettr_bert import full_config
    from repro_torch.core import prettr as P
    from repro_torch.index import IndexBuilder, TermRepIndex
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": time.perf_counter() - t0})

    cfg = full_config()
    cfg32 = full_config(compute_dtype=torch.float32)

    # 2. kernels
    rows = check_kernels(torch, cfg)

    params = P.init_prettr(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    docs = make_docs(rng, cfg)
    requests = make_requests(rng, cfg)

    launches = {}                  # path -> kernel -> launches
    # 3. index
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        report, launches["index"] = counted(
            lambda: IndexBuilder(tmp, cfg, params, codec="fp16",
                                 batch_size=INDEX_BATCH).build(docs))
        index = TermRepIndex.open(tmp)
        emit({"phase": "index", "device": name, "n_docs": len(index),
              "n_tokens": report.n_tokens,
              "storage_bytes": report.storage_bytes,
              "encode_s": report.encode_s, "write_s": report.write_s,
              "wall_s": report.wall_s,
              "docs_per_s": report.n_docs / report.wall_s,
              "launches": launches["index"]})
        if len(index) != N_DOCS or int(index.doc_lengths.sum()) \
                != report.n_tokens:
            raise AssertionError("reopened index does not hold the build")

        # 4. serve: kernels against the plain impl, bf16 and float32
        plain = lambda c: dataclasses.replace(c, backbone=dataclasses.replace(
            c.backbone, attn_impl="plain", compress_impl="plain"))
        s_bf16, launches["serve"] = serve(torch, params, cfg, index,
                                          requests, "cuda_bf16", name)
        p_bf16, launches["plain_bf16"] = serve(torch, params, plain(cfg),
                                               index, requests, "plain_bf16",
                                               name)
        s_f32, launches["serve_f32"] = serve(torch, params, cfg32, index,
                                             requests, "cuda_f32", name)
        p_f32, launches["plain_f32"] = serve(torch, params, plain(cfg32),
                                             index, requests, "plain_f32",
                                             name)
        # bf16 rounds at other places in the kernels (f32 softmax and P.V)
        # than in the plain impl (probabilities cast to bf16), so the bf16
        # tolerance is twice what bf16 rounding alone moves the plain
        # impl's scores (plain bf16 against plain float32)
        bf16_noise = max_diff(p_bf16, p_f32)
        tol_bf16 = 2 * bf16_noise
        agree = {"phase": "serve_agreement", "device": name,
                 "f32_max_abs_diff": max_diff(s_f32, p_f32), "f32_tol": 1e-3,
                 "bf16_max_abs_diff": max_diff(s_bf16, p_bf16),
                 "bf16_tol": tol_bf16, "bf16_rounding_of_plain": bf16_noise,
                 "bf16_kernels_vs_plain_f32": max_diff(s_bf16, p_f32)}
        emit(agree)
        if agree["f32_max_abs_diff"] > 1e-3 or \
                agree["bf16_max_abs_diff"] > tol_bf16:
            raise AssertionError("served scores disagree with the plain impl")
        profile_serve(torch, params, cfg, index, requests, name)
        del index

    # 5. soundness: rank_forward == join_and_score(encode_query,
    #    precompute_docs), float32 compute over fp16 storage
    q_tok = np.stack([requests[i][0] for i in range(N_SOUNDNESS)])
    q_val = q_tok != 0
    d_tok = np.zeros((N_SOUNDNESS, cfg.max_doc_len), np.int64)
    for i in range(N_SOUNDNESS):
        d = np.concatenate([docs[i][: cfg.max_doc_len - 1], [SEP]])
        d_tok[i, : len(d)] = d
    d_val = d_tok != 0
    to = lambda a: torch.from_numpy(a).cuda()
    def soundness():
        with torch.inference_mode():
            joint = P.rank_forward(
                params, cfg32, to(np.concatenate([q_tok, d_tok], 1)),
                to(np.concatenate([np.zeros_like(q_tok),
                                   np.ones_like(d_tok)], 1)),
                to(np.concatenate([q_val, d_val], 1)))
            split = P.join_and_score(
                params, cfg32,
                P.encode_query(params, cfg32, to(q_tok), to(q_val)),
                to(q_val),
                P.precompute_docs(params, cfg32, to(d_tok), to(d_val)),
                to(d_val))
        return joint, split

    (joint, split), launches["soundness"] = counted(soundness)
    err = (joint - split).abs().max().item()
    emit({"phase": "soundness", "pairs": N_SOUNDNESS, "max_abs_err": err,
          "tol": SOUND_TOL, "joint": joint.tolist(), "split": split.tolist(),
          "launches": launches["soundness"]})
    if not (err <= SOUND_TOL and torch.isfinite(joint).all()):
        raise AssertionError("rank_forward != join_and_score(encode_query, "
                             "precompute_docs)")

    # 6. kernels line: `launches` counts the main path (index build and the
    #    bf16 serving drain); `launches_by_path` each counted path alone
    for row in rows:
        k = row["name"]
        row["launches"] = launches["index"][k] + launches["serve"][k]
        row["launches_by_path"] = {p: n[k] for p, n in launches.items()}
    emit({"kernels": rows})
    missing = [f"{p}: {k}" for p, kernels in PATH_KERNELS.items()
               for k in kernels if launches[p][k] == 0]
    stray = [f"{p}: {k}" for p, n in launches.items() for k in n
             if n[k] and k not in PATH_KERNELS[p]]
    if missing or stray:
        raise AssertionError(f"kernels not launched: {missing}; launched "
                             f"where none should be: {stray}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
