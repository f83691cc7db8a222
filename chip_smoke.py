#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main paths at full width with seeded random weights:
PreTTR at the paper's (``repro_torch.configs.prettr_bert.full_config``:
12 layers, d=768, split at l=6, e=256, bf16 compute), the transformer LM
at gemma3-4b's, then the recsys models at their published configs:

1. device  -- the card's name and power limit, the kernel build time;
2. kernels -- each hand-written kernel form at its main-path shape against
   its plain PyTorch version on the same inputs, with times (CUDA events,
   median of 20 after warm-up) beside the plain version, one library call
   that computes the same function, and the least time the card could
   take (``device_ms``: the kernel's call queued behind a spin kernel, so
   that the wrapper's host work is not counted): split attention (PreTTR's validity + seg_boundary form, gemma3's
   causal and causal + window forms at [4, 8, 2048, 256], raw int8 K/V),
   join attention (dense float, raw int8 K/V, paged over int8 and fp16
   pools, the CLS row), flash decode (the CLS-only layer's shape, and
   gemma3's decode shape with and without its window), compress and
   decompress (fp16 and float32 storage; their library call is the same
   function in float32 with TF32 off; every form must run the
   tensor-core kernel, split TF32, and its bound counts its passes at
   TF32's rate).  Flash decode and the CLS row run
   one split-KV kernel; their rows also give the ``n_splits`` their
   timed call launched with (as its wrapper recorded it), the merges it
   launched, their device times with the L2 flushed before each call
   (``cold_device_ms``, ``cold_library_ms``) and the bytes a second
   achieved, warm and cold; gemma3's window form is also
   checked at ``lengths`` = 1 (a cache's first step).  bf16 split and
   join attention run on the tensor-core kernels, float32 on the
   CUDA-core ones; each
   attention row names the kernel its timed call ran (``kernels_run``),
   and each bf16 one is held to twice the distance of its plain
   version's bf16 output from its float32 output on the same inputs;
3. index   -- ``IndexBuilder`` writes a 512-document fp16 index, reopened
   with ``TermRepIndex`` (verified on open, the default; the line gives
   ``open_s`` and the chunks checked, which must be above 0: every build
   carries CRC-32C chunk checksums);
4. serve   -- ``RankingService`` (prefetch thread on, its default)
   answers 8 requests x 64 candidates in micro-batches of 32, through the
   kernels and through the plain impl, in bf16 and in float32; the same
   through the legacy concat join (``fused=False``: split attention over
   [B, 512] and the flash-decode CLS layer), held against the plain impl
   and, in float32, against the fused join; the bf16 kernel run again
   with ``prefetch_depth=0`` (scores must be bit-equal); one injected
   staging fault (only its micro-batch's rows fail, every other score is
   bit-equal) and ``max_queue`` shedding; then one drain of the kernel
   path under ``torch.profiler``: the device's busy share and its kernels
   by time;
4b. int8   -- ``index_int8``: the same documents as int8 reps with int8
   layer-l K/V (``codec="int8", store_layer_kv=True, kv_codec="int8"``);
   ``serve_int8_kv``: the 8 requests with ``use_layer_kv=True``, kernels
   and plain, bf16 and float32; ``serve_cached``: 16 requests of 64
   candidates drawn with probability 1 / rank^1.1 (a hot-document
   stream), served twice (cold, then warm) through a 160 MB paged doc
   cache at 64-token pages, kernels and plain, bf16 and float32; warm
   scores must equal cold ones bit for bit, and float32 scores must agree
   with the uncached service on the same stream within 1e-4;
4c. pq and pruning -- ``index_pq``: the same documents as PQ codes
   (``codec="pq"``: 64 uint8 codes a token, 0.25 byte a dim; the line
   gives the host k-means ``fit_s`` and ``bytes_per_token``);
   ``serve_pq``: the 8 requests, kernels and plain, bf16 and float32 (the
   codebook gather on the card feeds the float32-input decompress
   kernel), then ``pq_h2d``: the fp16, int8 + K/V and PQ drains'
   ``h2d_bytes``; ``serve_pq_cached``: the zipf stream twice through a
   doc cache of about 200 documents' pages (warm = cold bit for bit,
   float32 within 1e-4 of the uncached PQ service); ``index_pruned``:
   fp16 reps pruned to half their tokens by layer-l salience
   (``keep_frac=0.5``; ``pruned_tokens`` gives the kept tokens against
   the unpruned build's and the pruned ``max_doc_len``, 240) and
   ``serve_pruned`` at that shape;
4d. cascade -- ``run_cascade`` over a seeded ``SyntheticIRWorld`` at the
   config's vocabulary (2048 docs of 479 tokens, 64 queries, 64
   candidates, metrics at depth 10) for fp16, int8, PQ and pruned
   indexes: each index's first-stage and re-rank metrics and storage
   bytes; over the PQ index also through the kernels in float32 and the
   plain backend in bf16 and float32 (``cascade_agreement``: float32
   within 1e-3, bf16 within twice the plain backend's own bf16
   rounding);
5. soundness -- ``rank_forward == join_and_score(encode_query,
   precompute_docs)`` on 4 pairs, float32 over fp16 storage
   (``rank_forward`` ends in the flash-decode CLS layer, the split path in
   the join kernel's CLS row);
6. lm -- gemma3-4b at full width (``gemma3_4b.full_config``, bf16
   weights from ``init_params``, depth not cut): ``lm_prefill``, 4 seeded
   prompts of 2048 tokens through ``forward(collect_cache=True)`` and
   ``logits`` (split attention's causal and window forms);
   ``lm_decode``, the K/V copied into ``init_decode_cache(cfg, 4, 2080)``
   and 32 greedy ``decode_step``s (both window forms of flash decode);
   ``lm_agreement``, the same through the plain impl in bf16 and float32
   and through the kernels in float32, fed the timed run's tokens;
   ``lm_soundness``, prefill + one ``decode_step`` against ``forward``
   over 2049 tokens, float32 through the kernels; then a profile of one
   prefill and 4 decode steps;
7. recsys -- once the LM's state is freed, every lookup through the
   embedding-bag kernel and, on the same inputs, through its plain
   version (each pair within a limit scaled to the data, ``REC_REL``;
   each line gives both times, the limit, the card's free memory and the
   peak allocated): DLRM-MLPerf
   (``dlrm_mlperf.full_config`` with ``param_dtype=torch.bfloat16``: the
   whole Criteo-1TB vocabulary, 187,767,808 rows, a 48.1 GB table drawn
   in chunks on the card; the phase fails if the card cannot hold it)
   ``dlrm_forward`` on ``click_batch`` ids at serve_p99 (B = 512) and
   serve_bulk (B = 262,144), ``retrieval_scores`` of one user against
   1,000,192 seeded float32 item vectors, ``item_tower`` over 1,000,192
   items; DeepFM (``deepfm.full_config``: 39 x 1M rows of 10, float32)
   ``deepfm_forward`` at both batches, ``item_vectors`` over 1,000,192
   items and ``retrieval_scores`` for one user; xDeepFM at serve_p99 only
   (its line says why not serve_bulk); a profile of each serve_bulk
   forward; then the kernel's sum, mean and cast forms at their
   main-path shapes beside the plain version and ``F.embedding_bag``,
   each on a routed kernel (wide or narrow, not the generic one), with
   ``l2_bound_ms`` (the bytes that must pass the L2 over its peak rate,
   which ``tools/gather_rate.cu`` measured on an H100: ``L2_PEAK_RATE``)
   beside the HBM ``bound_ms``.

Kernel launches are counted per path: every counter is set to 0 just
before each index build, each timed serving run, the soundness check,
each LM run and each recsys run, and read just after.  A path that
misses a kernel it must run (``PATH_KERNELS``: the tensor-core split and
join kernels on the bf16 paths, the CUDA-core ones on the float32
paths; the tensor-core compress and decompress kernels on every path
that runs them; the split-KV merge where the path's Sq = 1 calls split
their keys: gemma3's decode and the 4-pair soundness check; the wide
embedding-bag kernel on DLRM's paths, the narrow one on DeepFM's and
xDeepFM's), a path that launches one it must not (the generic
embedding-bag kernel on a recsys path among them), or a plain run that
launches any, fails the script.
The ``kernels`` line's ``launches`` sums the main paths (``MAIN_PATHS``:
the index builds, the bf16 kernel runs of each serving form, the LM's
bf16 prefill and decode, and the recsys serve_bulk forwards, retrieval
runs and towers),
``launches_by_path`` gives each path's own.

Every phase that fails raises and the script exits non-zero.  It prints
one JSON object per line; each but the last two carries ``card``, the
card's name and power limit as ``nvidia-smi`` gives them; the second to
last is the ``kernels`` line, the last ``{"ok": true, "device": ...}``.  Run from the repository root::

    python3 chip_smoke.py
"""
import functools
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
# the doc-cache run: 16 requests of 64 distinct candidates drawn with
# probability 1 / rank^1.1 over the corpus, served twice (cold, warm)
# through a cache of about 200 of the 512 documents at 64-token pages
N_CACHED_REQUESTS, ZIPF_S, CACHE_MB, PAGE_TOKENS = 16, 1.1, 160, 64
# stored int8 K/V in both runs, so the cached scores differ from the
# uncached ones by summation order only
CACHED_TOL = 1e-4
# the PQ index's doc cache holds about as many documents as the int8 one
# (its pages are 28x smaller), so the zipf stream still evicts
PQ_CACHED_DOCS = 200
# index-time pruning of the pruned index and the cascade's pruned one
KEEP_FRAC = 0.5
# the quality cascade: SyntheticIRWorld at the config's vocabulary, 2048
# docs of 479 tokens (480 with [SEP], the config's max_doc_len), 64
# queries, 64 candidates a query, metrics at depth 10; one index each of
# fp16, int8, pq and fp16 pruned to half its tokens
CASCADE_DOCS, CASCADE_QUERIES, CASCADE_K, CASCADE_K_METRIC = 2048, 64, 64, 10
CASCADE_INDEXES = {"fp16": {"codec": "fp16"}, "int8": {"codec": "int8"},
                   "pq": {"codec": "pq"},
                   "pruned": {"codec": "fp16", "keep_frac": KEEP_FRAC}}
# the cascade over the PQ index through the kernels against the plain
# backend: float32 within the served-score limit, bf16 within twice the
# plain backend's own bf16 rounding (plain bf16 against plain float32)
CASCADE_F32_TOL = 1e-3
N_SOUNDNESS = 4
CLS, SEP = 1, 2
# published H100 SXM peaks (NVIDIA data sheet, dense), at 700 W
PEAK_BF16_FLOPS = 989e12          # tensor cores, dense
PEAK_F32_FLOPS = 67e12            # CUDA cores
PEAK_TF32_FLOPS = 495e12          # tensor cores, dense
PEAK_BYTES = 3.35e12              # HBM3
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
# rank_forward against the split path, float32 over fp16 storage: both
# round the doc reps through the same fp16 cast, so only summation order
# differs (about 1e-6 at full width)
SOUND_TOL = 1e-4
# the legacy concat join against the fused join, both through the kernels
# in float32: the same function summed in other orders
LEGACY_TOL = 1e-4
# the injected staging fault: the 4th micro-batch of the fp16 drain
FAULT_AFTER = 3
# gemma3-4b at full width (bf16 weights, depth not cut): 4 prompts of 2048
# seeded tokens (above the 1024-key window, so the local layers skip
# tiles), then 32 greedy decode steps into a 2080-token cache
LM_B, LM_S, LM_STEPS, LM_WINDOW = 4, 2048, 32, 1024
# kernels against the plain impl in float32: the same function summed in
# other orders, as the serving limit
LM_F32_TOL = 1e-3
# prefill + decode_step against forward over 2049 tokens, float32 through
# the kernels: the two differ in summation order only (the decode kernel
# against the split kernel, and cuBLAS products of 4 rows against 8196).
# float32 rounds at 6e-8 relative; a dot of up to 10240 terms summed in
# another order moves by ~sqrt(10240) * 6e-8 = 6e-6 relative, and 34
# post-normed layers of 7 products add such errors to the residual
# (~sqrt(34 * 7) * 6e-6 = 1e-4 relative).  The logits are ~1 (unit-RMS
# hidden states against 0.02-scaled tied embeddings over d = 2560), so
# 1e-3 leaves a factor of ~10 over that estimate.
LM_SOUND_TOL = 1e-3
# the JAX package's recsys shapes (src/repro/configs/__init__.py
# RECSYS_SHAPES): serve_p99 B = 512, serve_bulk B = 262,144, and
# retrieval_cand's 1,000,000 candidates padded to a multiple of 256 as
# src/repro/launch/steps.py (_pad_mult) feeds them
REC_P99, REC_BULK, REC_CANDIDATES = 512, 262_144, 1_000_192
# the port's kernels by symbol (csrc/*.cu), held against the launch
# counters in each profile
OUR_KERNELS = ("split_attention_kernel", "split_attention_tc_kernel",
               "join_tiled_kernel", "join_tc_kernel", "sq1_attention_kernel",
               "sq1_merge_kernel", "compress_kernel", "decompress_kernel",
               "compress_tc_kernel", "decompress_tc_kernel",
               "embedding_bag_kernel", "embedding_bag_wide_kernel",
               "embedding_bag_narrow_kernel")
# the counters of which attention or compressor kernel a call was routed
# to (the tensor-core or the CUDA-core one), and which embedding-bag
# kernel (wide, narrow or generic); every launch also counts in its form's
# counter, so a profile's launch total leaves these out
ROUTE_COUNTERS = ("split_attention_tensor_core", "split_attention_cuda_core",
                  "join_attention_tensor_core", "join_attention_cuda_core",
                  "join_attention_paged_tensor_core",
                  "join_attention_paged_cuda_core",
                  "compress_tensor_core", "compress_cuda_core",
                  "decompress_tensor_core", "decompress_cuda_core",
                  "embedding_bag_wide", "embedding_bag_narrow",
                  "embedding_bag_generic")
# the split-KV kernel's merge launches, one counter per Sq = 1 form: a
# call whose keys were split launches the merge kernel after it
MERGE_COUNTERS = ("decode_attention_merge", "decode_attention_window_merge",
                  "join_attention_row_merge")
# recsys limits, scaled to the data (the tables are N(0, 0.01^2), so a
# fixed 2e-2 would pass a kernel that returned zeros).  The kernel and its
# plain version sum the same float32 terms in other orders and round once:
# - "bits": a bag of one slot of weight 1 has nothing to reorder, and
#   DLRM's forward has no other bag, so these must be bit-equal;
# - "bfloat16": a reordered sum that rounds to bf16 can land on the other
#   side of a tie, one bf16 ulp of the value, at most 2^-7 of it: the
#   limit is 2^-7 * max|plain|, no relative term;
# - "float32": float32 sums of up to 39 terms in another order differ by
#   a few float32 ulps (2^-23); 2^-16 * max|plain| is 128 ulps of the
#   largest value.
REC_REL = {"bits": 0.0, "bfloat16": 2.0 ** -7, "float32": 2.0 ** -16}
# the spin kernel ahead of each call timed for ``device_ms``: ~2 ms at
# the H100's 1.98 GHz, longer than any timed call's host work
SPIN_CYCLES = 4_000_000
# bytes written between calls timed cold: more than the H100's 50 MB L2
FLUSH_BYTES = 128 << 20
# the L2's peak rate, bytes a second: the highest of
# src/repro_torch/tools/gather_rate.cu's cases (stream_read, 7854.9 and
# 7848.9 GB/s in two runs; random 64- and 256-byte gathers 4014-4023,
# stream_write 4078-4092) on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, 2026-10-17.  The embedding bag's l2_bound_ms divides the bytes
# that must pass the L2 by it
L2_PEAK_RATE = 7854.9e9


# the card's name and power limit as nvidia-smi gives them; every line but
# the kernels line and the last carries it
CARD = None


def emit(obj):
    if CARD is not None and "kernels" not in obj \
            and set(obj) != {"ok", "device"}:
        obj = {**obj, "card": CARD}
    print(json.dumps(obj), flush=True)


def time_ms(fn, n=20, warmup=3, spin=False, cold=False):
    """Median time of ``fn`` in ms: CUDA events around each call, which
    take in the host's enqueue time when that is the longer.  With
    ``spin`` each call is queued behind a spin kernel of SPIN_CYCLES, so
    the host enqueues it while the device is busy and the events bracket
    the device's work alone.  With ``cold`` FLUSH_BYTES are written before
    each call (outside the events), so its operands come from HBM and not
    from the L2, as a real decode step or micro-batch finds them."""
    import torch
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            flush.fill_(n)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
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


def compare(name, got, want, dtype_name, shape, want_f32=None):
    """A kernel's output against its plain version's, within TOL of the
    type (relative and absolute); returns the max abs error.  With
    ``want_f32``, the plain version's float32 output on the same inputs,
    the kernel is also held to twice the distance of ``want`` (the plain
    version rounded to the 16-bit type) from it: the tensor-core kernels
    round P before P.V and the output once, the plain version only the
    output."""
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    ok = bool(torch.all(err <= tol + tol * want.float().abs()))
    line = {"phase": "kernel_check", "kernel": name, "shape": shape,
            "dtype": dtype_name, "max_abs_err": err.max().item(),
            "tol": {"rtol": tol, "atol": tol}}
    if want_f32 is not None:
        rounding = (want.float() - want_f32).abs().max().item()
        line.update(err_vs_plain_f32=(got.float() - want_f32).abs().max()
                    .item(), plain_rounding=rounding, limit=2 * rounding)
        ok = ok and line["err_vs_plain_f32"] <= line["limit"]
    emit({**line, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {shape} {dtype_name}: kernel "
                             f"disagrees with its plain version")
    return err.max().item()


def record_kernel(rows, name, source, replaces, err, kernel_fn, plain_fn,
                  library_fn, flops, n_bytes, peak, peak_name, row=True,
                  split_kv=None, **extra):
    """Time a kernel beside its plain version and library call and return
    its kernels-line row; with ``row`` False (a second form of a kernel
    already in the line) only the kernel_time line is printed.  ``extra``
    goes on that line.  An
    attention row names the kernel its call was routed to
    (``kernels_run``).  An Sq = 1 row (``split_kv``: the wrapper and the
    attribute where it records the split count it launched with) also
    gives that ``n_splits``, its device times with the L2 flushed before
    each call (``cold_device_ms``, ``cold_library_ms``), the merge kernels
    its call launched and the bytes a second it achieved, warm and
    cold."""
    if split_kv is not None:
        setattr(*split_kv, None)
    _, launched = counted(kernel_fn)
    n_splits = None if split_kv is None else getattr(*split_kv)
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
    library_ms = time_ms(library_fn)
    bound_ms, bound_by = bound(flops, n_bytes, peak)
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "device_ms": time_ms(kernel_fn, spin=True)}
    routes = [k for k in ROUTE_COUNTERS if launched[k]]
    if routes:
        out["kernels_run"] = routes
    if split_kv is not None:
        if n_splits is None:
            raise AssertionError(f"{name}: the call recorded no n_splits")
        out.update(n_splits=n_splits,
                   merges_run=sum(launched[k] for k in MERGE_COUNTERS),
                   cold_device_ms=time_ms(kernel_fn, spin=True, cold=True),
                   cold_library_ms=time_ms(library_fn, spin=True, cold=True))
        out.update(gb_per_s=n_bytes / out["device_ms"] / 1e6,
                   cold_gb_per_s=n_bytes / out["cold_device_ms"] / 1e6)
    emit({"phase": "kernel_time", **out, "peak": peak_name,
          "flops": flops, "bytes": n_bytes, **extra})
    if row:
        rows.append(out)
    return out


def _decode_f32(q, k, v, lengths, **kw):
    """Flash decode's plain version in float32 on 16-bit inputs: the
    ``want_f32`` of a 16-bit decode check."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    return decode_attention_ref(q.float(), k.float(), v.float(), lengths,
                                **kw)


def _prefix_mask(torch, gen, b, n, lo):
    lengths = torch.randint(lo, n + 1, (b, 1), generator=gen, device="cuda")
    return torch.arange(n, device="cuda")[None] < lengths


def check_kernels(torch, cfg):
    """Every kernel at its main-path shapes against its plain version;
    returns the kernels-line rows (launches filled in later)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      flash_decode_attention)
    from repro_torch.kernels.fused_compress import (compress_ref,
                                                    decompress_ref,
                                                    fused_compress,
                                                    fused_decompress)
    from repro_torch.kernels.join_attention import (join_attention_ref,
                                                    join_attention_ref_paged,
                                                    join_attention_ref_quant,
                                                    join_flash_attention,
                                                    join_flash_attention_paged,
                                                    pages_to_dense)
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

    rows = []
    record = functools.partial(record_kernel, rows)

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
            f32 = (None if dtype == torch.float32 else split_attention_ref(
                q.float(), k.float(), v.float(), lengths, valid,
                seg_boundary=sb).float())
            err = compare("split_attention",
                          split_flash_attention(q, k, v, lengths,
                                                k_valid=valid,
                                                seg_boundary=sb),
                          split_attention_ref(q, k, v, lengths, valid,
                                              seg_boundary=sb),
                          dname, [b, h, s, dh], f32)
    mask = valid[:, None, None, :].expand(b, 1, s, s)
    record("split_attention", "src/repro_torch/csrc/split_attention.cu",
           "src/repro/kernels/split_attention/kernel.py:109", err,
           lambda: split_flash_attention(q, k, v, lengths, k_valid=valid),
           lambda: split_attention_ref(q, k, v, lengths, valid),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
           4 * dh * h * s * valid.sum().item(),
           2 * nbytes(q) + kv_bytes(lengths, h, dh, q.element_size())
           + nbytes(valid, lengths), PEAK_BF16_FLOPS, "bf16 tensor cores")

    # -- split attention's LM forms at gemma3's prefill shape (q [4, 8,
    #    2048, 256] against GQA K/V [4, 4, 2048, 256]): causal (the global
    #    layers) and causal + 1024-key window (the local layers), float32
    #    and bf16; the bf16 one is timed.  Every key is visible to some
    #    row, so the K/V bytes are the whole operands
    lb, lhq, lhkv, ls, ldh = LM_B, 8, 4, LM_S, 256
    full = torch.full((lb,), ls, dtype=torch.int32, device="cuda")
    pos = torch.arange(ls, device="cuda")
    for name, window in (("split_attention_causal", -1),
                         ("split_attention_window", LM_WINDOW)):
        for dtype, dname in ((torch.float32, "float32"),
                             (torch.bfloat16, "bfloat16")):
            q = rand(lb, lhq, ls, ldh, dtype=dtype)
            k, v = (rand(lb, lhkv, ls, ldh, dtype=dtype) for _ in range(2))
            kw = dict(causal=True, window=window)
            f32 = (None if dtype == torch.float32 else split_attention_ref(
                q.float(), k.float(), v.float(), full, **kw).float())
            err = compare(name, split_flash_attention(q, k, v, **kw),
                          split_attention_ref(q, k, v, full, **kw), dname,
                          [lb, lhq, ls, ldh, window], f32)
            del f32
        visible = pos[None] <= pos[:, None]
        if window > 0:
            visible = visible & (pos[:, None] - pos[None] < window)
        library = (
            (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True))
            if window < 0 else
            (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=visible, enable_gqa=True)))
        record(name, "src/repro_torch/csrc/split_attention.cu",
               "src/repro/kernels/split_attention/kernel.py:109", err,
               lambda: split_flash_attention(q, k, v, **kw),
               lambda: split_attention_ref(q, k, v, full, **kw), library,
               4 * ldh * lhq * lb * int(visible.sum()),
               2 * nbytes(q) + nbytes(k, v), PEAK_BF16_FLOPS,
               "bf16 tensor cores")
    del q, k, v, visible

    # -- split attention over raw int8 K/V + per-token scales (no path
    #    reaches it in either package; held at PreTTR's join-layer shape
    #    [32, 12, 512, 64], keys in two prefixes)
    b, s = MICRO_BATCH, lq + ld
    q = rand(b, h, s, dh)
    k8, v8 = (torch.randint(-127, 128, (b, h, s, dh), generator=gen,
                            device="cuda", dtype=torch.int32)
              .to(torch.int8) for _ in range(2))
    ks8, vs8 = (1e-3 + 0.05 * torch.rand((b, s), generator=gen,
                                         device="cuda") for _ in range(2))
    valid = torch.cat([_prefix_mask(torch, gen, b, lq, 3),
                       _prefix_mask(torch, gen, b, ld, ld // 4)], 1)
    lengths = last_valid_lengths(valid)
    f32 = split_attention_ref(q.float(), k8, v8, lengths, valid, ks8, vs8)
    compare("split_attention_int8",
            split_flash_attention(q.float(), k8, v8, lengths, valid, ks8, vs8),
            f32, "float32", [b, h, s, dh])
    err = compare("split_attention_int8",
                  split_flash_attention(q, k8, v8, lengths, valid, ks8, vs8),
                  split_attention_ref(q, k8, v8, lengths, valid, ks8, vs8),
                  "bfloat16", [b, h, s, dh], f32)
    mask = valid[:, None, None, :].expand(b, 1, s, s)
    record("split_attention_int8", "src/repro_torch/csrc/split_attention.cu",
           "src/repro/kernels/split_attention/kernel.py:109", err,
           lambda: split_flash_attention(q, k8, v8, lengths, valid, ks8,
                                         vs8),
           lambda: split_attention_ref(q, k8, v8, lengths, valid, ks8, vs8),
           lambda: F.scaled_dot_product_attention(
               q, (k8.float() * ks8[:, None, :, None]).to(q.dtype),
               (v8.float() * vs8[:, None, :, None]).to(q.dtype),
               attn_mask=mask),
           4 * dh * h * s * valid.sum().item(),
           2 * nbytes(q) + kv_bytes(lengths, h, dh, 1)
           + 2 * 4 * int(lengths.sum()) + nbytes(valid, lengths),
           PEAK_BF16_FLOPS, "bf16 tensor cores")

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
        want_f32 = join_attention_ref(*f32, kqv, kdv)
        compare(name, fn(*f32, kqv, kdv), want_f32, "float32",
                [b, h, sq, dh])
        err = compare(name, fn(q, kq, vq, kd, vd, kqv, kdv),
                      join_attention_ref(q, kq, vq, kd, vd, kqv, kdv),
                      "bfloat16", [b, h, sq, dh], want_f32)
        mask = torch.cat([kqv, kdv], 1)[:, None, None, :].expand(b, 1, sq,
                                                                 lq + ld)
        record(name, "src/repro_torch/csrc/join_attention.cu" if sq > 1
               else "src/repro_torch/csrc/join_attention_row.cu",
               "src/repro/kernels/join_attention/kernel.py:130", err,
               lambda: fn(q, kq, vq, kd, vd, kqv, kdv),
               lambda: join_attention_ref(q, kq, vq, kd, vd, kqv, kdv),
               lambda: F.scaled_dot_product_attention(q, k_cat, v_cat,
                                                      attn_mask=mask),
               4 * dh * h * sq * n_keys,
               2 * nbytes(q) + kv_needed + nbytes(kqv, kdv), PEAK_BF16_FLOPS,
               "bf16 tensor cores",
               split_kv=((join_flash_attention, "last_row_n_splits")
                         if sq == 1 else None))

    # -- the join layer l over stored int8 K/V: dense (no doc cache) and
    #    paged out of the doc cache's pools (page 64: 480 -> 8 pages); the
    #    K/V bytes count 1 byte a value up to each row's last valid key,
    #    plus the float32 scales
    sq = lq + ld
    q = rand(b, h, sq, dh)
    kd8, vd8 = (torch.randint(-127, 128, (b, h, ld, dh), generator=gen,
                              device="cuda", dtype=torch.int32)
                .to(torch.int8) for _ in range(2))
    ks, vs = (1e-3 + 0.05 * torch.rand((b, ld), generator=gen,
                                       device="cuda") for _ in range(2))
    qlen, dlen = last_valid_lengths(kqv), last_valid_lengths(kdv)
    int8_bytes = (2 * nbytes(q) + kv_bytes(qlen, h, dh, 2)
                  + kv_bytes(dlen, h, dh, 1) + 2 * 4 * int(dlen.sum())
                  + nbytes(kqv, kdv))
    join_flops = 4 * dh * h * sq * n_keys
    mask = torch.cat([kqv, kdv], 1)[:, None, None, :].expand(b, 1, sq,
                                                             lq + ld)

    def dequant_sdpa(kd_f, vd_f):
        return F.scaled_dot_product_attention(
            q, torch.cat([kq, kd_f.to(q.dtype)], 2),
            torch.cat([vq, vd_f.to(q.dtype)], 2), attn_mask=mask)

    f32 = [t.float() for t in (q, kq, vq)]
    want_f32 = join_attention_ref_quant(*f32, kd8, vd8, ks, vs, kqv, kdv)
    compare("join_attention_int8",
            join_flash_attention(*f32, kd8, vd8, kqv, kdv, ks, vs),
            want_f32, "float32", [b, h, sq, dh])
    err = compare("join_attention_int8",
                  join_flash_attention(q, kq, vq, kd8, vd8, kqv, kdv, ks, vs),
                  join_attention_ref_quant(q, kq, vq, kd8, vd8, ks, vs, kqv,
                                           kdv),
                  "bfloat16", [b, h, sq, dh], want_f32)
    record("join_attention_int8", "src/repro_torch/csrc/join_attention.cu",
           "src/repro/kernels/join_attention/kernel.py:130", err,
           lambda: join_flash_attention(q, kq, vq, kd8, vd8, kqv, kdv, ks,
                                        vs),
           lambda: join_attention_ref_quant(q, kq, vq, kd8, vd8, ks, vs, kqv,
                                            kdv),
           lambda: dequant_sdpa(kd8.float() * ks[:, None, :, None],
                                vd8.float() * vs[:, None, :, None]),
           join_flops, int8_bytes, PEAK_BF16_FLOPS, "bf16 tensor cores")

    n_pages = -(-ld // PAGE_TOKENS)
    table = (2 + torch.arange(b * n_pages, device="cuda",
                              dtype=torch.int32)).reshape(b, n_pages)

    def pool(x):
        """[B, Hkv, Ld, ...] or [B, Ld] rows -> [P, page, ...] pool with
        two zero pages in front, as the doc cache lays them out."""
        if x.dim() == 4:
            x = x.transpose(1, 2)
        x = F.pad(x, [0, 0] * (x.dim() - 2) + [0, n_pages * PAGE_TOKENS - ld])
        x = x.reshape(b * n_pages, PAGE_TOKENS, *x.shape[2:])
        return torch.cat([torch.zeros_like(x[:2]), x]).contiguous()

    dval = pool(kdv.to(torch.int8))
    table_bytes = nbytes(table) + b * n_pages * PAGE_TOKENS
    for form, kd_p, vd_p, scales in (
            ("int8", pool(kd8), pool(vd8),
             dict(kd_scale_pages=pool(ks)[..., None],
                  vd_scale_pages=pool(vs)[..., None])),
            ("float16", pool(kd8.half() * 0.01), pool(vd8.half() * 0.01),
             {})):
        args = (kd_p, vd_p, table, dval)
        want_f32 = join_attention_ref_paged(*f32, *args, kqv, **scales)
        compare("join_attention_paged",
                join_flash_attention_paged(*f32, *args, kqv, **scales),
                want_f32, "float32", [b, h, sq, dh, PAGE_TOKENS, form])
        err = compare("join_attention_paged",
                      join_flash_attention_paged(q, kq, vq, *args, kqv,
                                                 **scales),
                      join_attention_ref_paged(q, kq, vq, *args, kqv,
                                               **scales),
                      "bfloat16", [b, h, sq, dh, PAGE_TOKENS, form],
                      want_f32)

        def paged_sdpa(kd_p=kd_p, vd_p=vd_p, scales=scales):
            kd_f, vd_f = (pages_to_dense(p, table).transpose(1, 2).float()
                          for p in (kd_p, vd_p))
            if scales:                        # [B, L, 1] -> [B, 1, L, 1]
                kd_f = kd_f * pages_to_dense(scales["kd_scale_pages"],
                                             table)[:, None]
                vd_f = vd_f * pages_to_dense(scales["vd_scale_pages"],
                                             table)[:, None]
            return F.scaled_dot_product_attention(
                q, torch.cat([kq, kd_f.to(q.dtype)], 2),
                torch.cat([vq, vd_f.to(q.dtype)], 2),
                attn_mask=torch.cat([kqv, pages_to_dense(dval, table)
                                     .bool()], 1)[:, None, None, :])

        elt = kd_p.element_size()
        record("join_attention_paged" if form == "int8"
               else "join_attention_paged_fp16",
               "src/repro_torch/csrc/join_attention_paged.cu",
               "src/repro/kernels/join_attention/kernel.py:195", err,
               lambda: join_flash_attention_paged(q, kq, vq, *args, kqv,
                                                  **scales),
               lambda: join_attention_ref_paged(q, kq, vq, *args, kqv,
                                                **scales),
               paged_sdpa, join_flops,
               2 * nbytes(q) + kv_bytes(qlen, h, dh, 2)
               + kv_bytes(dlen, h, dh, elt)
               + (2 * 4 * int(dlen.sum()) if scales else 0)
               + nbytes(kqv) + table_bytes, PEAK_BF16_FLOPS,
               "bf16 tensor cores", row=form == "int8")

    # -- flash decode: the CLS-only layer of the concat join and of
    #    rank_forward (q [32, 12, 1, 64] against the two-prefix 32 + 480
    #    keys), float32 and bf16; then GQA 8/4 at gemma3's head dim:
    #    ragged lengths over 4096 keys with a 1024-key window (checked
    #    only), and the LM decode's shape, a 2080-key cache at position
    #    2063 (mid-decode), global and with the window
    s = lq + ld
    k, v = (rand(b, h, s, dh) for _ in range(2))
    q = rand(b, h, 1, dh)
    cls_valid = torch.cat([_prefix_mask(torch, gen, b, lq, 3),
                           _prefix_mask(torch, gen, b, ld, ld // 4)], 1)
    lengths = last_valid_lengths(cls_valid)
    f32 = [t.float() for t in (q, k, v)]
    want_f32 = decode_attention_ref(*f32, lengths, cls_valid)
    compare("decode_attention",
            flash_decode_attention(*f32, lengths, cls_valid), want_f32,
            "float32", [b, h, 1, dh, s])
    err = compare("decode_attention",
                  flash_decode_attention(q, k, v, lengths, cls_valid),
                  decode_attention_ref(q, k, v, lengths, cls_valid),
                  "bfloat16", [b, h, 1, dh, s], want_f32)
    record("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
           "src/repro/kernels/decode_attention/kernel.py:75", err,
           lambda: flash_decode_attention(q, k, v, lengths, cls_valid),
           lambda: decode_attention_ref(q, k, v, lengths, cls_valid),
           lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=cls_valid[:, None, None, :]),
           4 * dh * h * cls_valid.sum().item(),
           # K/V bytes of the valid keys only: the padding between the two
           # prefixes is masked, and the kernel skips those tiles
           2 * nbytes(q) + 2 * int(cls_valid.sum()) * h * dh * q.element_size()
           + nbytes(cls_valid, lengths), PEAK_BF16_FLOPS,
           "bf16 tensor cores",
           split_kv=(flash_decode_attention, "last_n_splits"))
    gb, ghq, ghkv, gd = LM_B, 8, 4, 256
    q = rand(gb, ghq, 1, gd)
    k, v = (rand(gb, ghkv, 4096, gd) for _ in range(2))
    lengths = torch.tensor([4096, 2048, 4089, 1000], device="cuda",
                           dtype=torch.int32)
    compare("decode_attention_window",
            flash_decode_attention(q, k, v, lengths, window=LM_WINDOW),
            decode_attention_ref(q, k, v, lengths, window=LM_WINDOW),
            "bfloat16", [gb, ghq, 1, gd, 4096, LM_WINDOW],
            _decode_f32(q, k, v, lengths, window=LM_WINDOW))
    gs = LM_S + LM_STEPS
    k, v = (rand(gb, ghkv, gs, gd) for _ in range(2))
    # the first decode step of a cache: one key, every window split empty
    # but the first
    first = torch.ones((gb,), device="cuda", dtype=torch.int32)
    compare("decode_attention_window",
            flash_decode_attention(q, k, v, first, window=LM_WINDOW),
            decode_attention_ref(q, k, v, first, window=LM_WINDOW),
            "bfloat16", [gb, ghq, 1, gd, gs, LM_WINDOW, "lengths=1"],
            _decode_f32(q, k, v, first, window=LM_WINDOW))
    lengths = torch.full((gb,), LM_S + LM_STEPS // 2, device="cuda",
                         dtype=torch.int32)
    pos = torch.arange(gs, device="cuda")[None]
    for name, window in (("decode_attention_lm_global", -1),
                         ("decode_attention_window", LM_WINDOW)):
        err = compare(name.replace("_lm_global", ""),
                      flash_decode_attention(q, k, v, lengths, window=window),
                      decode_attention_ref(q, k, v, lengths, window=window),
                      "bfloat16", [gb, ghq, 1, gd, gs, window],
                      _decode_f32(q, k, v, lengths, window=window))
        keys = pos < lengths[:, None]
        if window > 0:
            keys = keys & (pos >= lengths[:, None] - window)
        n_keys = int(keys.sum())
        record(name, "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:75", err,
               lambda: flash_decode_attention(q, k, v, lengths,
                                              window=window),
               lambda: decode_attention_ref(q, k, v, lengths, window=window),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=keys[:, None, None, :],
                   enable_gqa=True),
               4 * gd * ghq * n_keys,
               2 * nbytes(q) + 2 * n_keys * ghkv * gd * q.element_size()
               + nbytes(lengths), PEAK_BF16_FLOPS, "bf16 tensor cores",
               row=window > 0,
               split_kv=(flash_decode_attention, "last_n_splits"))

    # -- compress (index time) and decompress (every micro-batch); their
    #    weights stay float32, so the same-function library call is a
    #    float32 addmm (TF32 off).  The kernels run split TF32 on the tensor
    #    cores: the bound counts 2 passes of 2 T d e (3 for a float32 input)
    #    over TF32's peak; each line also gives the float32 CUDA-core bound
    #    of earlier PRs, and each form must have run the tensor-core kernel
    def gemm_bound(t, k, n, passes, n_bytes, ln=0):
        """record's operation count, peak and its name, and the float32
        CUDA-core bound, for a [t, k] x [k, n] product (+ ln operations
        a row of the LayerNorm epilogue)."""
        f32 = bound(2 * t * k * n + ln * t * n, n_bytes, PEAK_F32_FLOPS)[0]
        return (passes * 2 * t * k * n + ln * t * n, n_bytes,
                PEAK_TF32_FLOPS, f"tf32 tensor cores, {passes} passes"), \
            {"f32_cuda_core_bound_ms": f32}

    def on_tensor_cores(kind):
        if rows[-1].get("kernels_run") != [f"{kind}_tensor_core"]:
            raise AssertionError(f"{rows[-1]['name']} ran "
                                 f"{rows[-1].get('kernels_run')}, not the "
                                 f"tensor-core {kind} kernel")

    w_c = rand(d, e, dtype=torch.float32, scale=d ** -0.5)
    b_c = rand(e, dtype=torch.float32, scale=0.1)
    t_c = INDEX_BATCH * ld
    x = rand(t_c, d)
    compare("compress", fused_compress(x.float(), w_c, b_c),
            compress_ref(x.float(), w_c, b_c), "float16", [t_c, d, e])
    out = fused_compress(x, w_c, b_c)
    err = compare("compress", out, compress_ref(x, w_c, b_c), "float16",
                  [t_c, d, e])
    work, f32_bound = gemm_bound(t_c, d, e, 2, nbytes(x, w_c, b_c, out))
    record("compress", "src/repro_torch/csrc/fused_compress.cu",
           "src/repro/kernels/fused_compress/kernel.py:45", err,
           lambda: fused_compress(x, w_c, b_c),
           lambda: compress_ref(x, w_c, b_c),
           lambda: F.gelu(torch.addmm(b_c, x.float(), w_c),
                          approximate="tanh").to(torch.float16),
           *work, **f32_bound)
    on_tensor_cores("compress")

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
    work, f32_bound = gemm_bound(t_d, e, d, 2, nbytes(r, *dargs, out), ln=8)
    record("decompress", "src/repro_torch/csrc/fused_compress.cu",
           "src/repro/kernels/fused_compress/kernel.py:64", err,
           lambda: fused_decompress(r, *dargs),
           lambda: decompress_ref(r, *dargs, out_dtype=torch.bfloat16),
           lambda: F.layer_norm(torch.addmm(dargs[1], r.float(), dargs[0]),
                                (d,), dargs[2], dargs[3], eps=1e-6)
           .to(torch.bfloat16),
           *work, **f32_bound)
    on_tensor_cores("decompress")

    # -- their float32 forms: an int8 index compresses to float32 before
    #    the codec quantises it, and its decoded reps are float32
    out = fused_compress(x, w_c, b_c, out_dtype=torch.float32)
    err = compare("compress_f32", out,
                  compress_ref(x, w_c, b_c, out_dtype=torch.float32),
                  "float32", [t_c, d, e])
    work, f32_bound = gemm_bound(t_c, d, e, 2, nbytes(x, w_c, b_c, out))
    record("compress_f32", "src/repro_torch/csrc/fused_compress.cu",
           "src/repro/kernels/fused_compress/kernel.py:45", err,
           lambda: fused_compress(x, w_c, b_c, out_dtype=torch.float32),
           lambda: compress_ref(x, w_c, b_c, out_dtype=torch.float32),
           lambda: F.gelu(torch.addmm(b_c, x.float(), w_c),
                          approximate="tanh"),
           *work, **f32_bound)
    on_tensor_cores("compress")
    r32 = r.float()
    compare("decompress_f32", fused_decompress(r32, *dargs,
                                               out_dtype=torch.float32),
            decompress_ref(r32, *dargs, out_dtype=torch.float32), "float32",
            [t_d, e, d])
    out = fused_decompress(r32, *dargs)
    err = compare("decompress_f32", out,
                  decompress_ref(r32, *dargs, out_dtype=torch.bfloat16),
                  "bfloat16", [t_d, e, d])
    work, f32_bound = gemm_bound(t_d, e, d, 3, nbytes(r32, *dargs, out),
                                 ln=8)
    record("decompress_f32", "src/repro_torch/csrc/fused_compress.cu",
           "src/repro/kernels/fused_compress/kernel.py:64", err,
           lambda: fused_decompress(r32, *dargs),
           lambda: decompress_ref(r32, *dargs, out_dtype=torch.bfloat16),
           lambda: F.layer_norm(torch.addmm(dargs[1], r32, dargs[0]), (d,),
                                dargs[2], dargs[3], eps=1e-6)
           .to(torch.bfloat16),
           *work, **f32_bound)
    on_tensor_cores("decompress")
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


def make_zipf_requests(rng, cfg):
    """The hot-document stream the doc cache exists for: candidates drawn
    without replacement with probability 1 / rank^ZIPF_S."""
    import numpy as np
    p = 1.0 / np.arange(1, N_DOCS + 1) ** ZIPF_S
    hot = rng.permutation(N_DOCS)            # which docs are hot
    reqs = []
    for q, qv, _ in make_requests(rng, cfg) + make_requests(rng, cfg):
        ids = hot[rng.choice(N_DOCS, N_CANDIDATES, False, p=p / p.sum())]
        reqs.append((q, qv, [int(i) for i in ids]))
    return reqs[:N_CACHED_REQUESTS]


def launch_counters():
    """Each kernel's launch counter, as (wrapper, attribute)."""
    from repro_torch.kernels.decode_attention import flash_decode_attention
    from repro_torch.kernels.embedding_bag import embedding_bag_op
    from repro_torch.kernels.fused_compress import (fused_compress,
                                                    fused_decompress)
    from repro_torch.kernels.join_attention import (join_flash_attention,
                                                    join_flash_attention_paged)
    from repro_torch.kernels.split_attention import split_flash_attention
    return {"split_attention": (split_flash_attention, "launches"),
            "split_attention_causal": (split_flash_attention,
                                       "causal_launches"),
            "split_attention_window": (split_flash_attention,
                                       "window_launches"),
            "split_attention_int8": (split_flash_attention, "int8_launches"),
            "decode_attention": (flash_decode_attention, "launches"),
            "decode_attention_window": (flash_decode_attention,
                                        "window_launches"),
            "decode_attention_merge": (flash_decode_attention,
                                       "merge_launches"),
            "decode_attention_window_merge": (flash_decode_attention,
                                              "window_merge_launches"),
            "join_attention": (join_flash_attention, "launches"),
            "join_attention_row": (join_flash_attention, "row_launches"),
            "join_attention_row_merge": (join_flash_attention,
                                         "row_merge_launches"),
            "join_attention_int8": (join_flash_attention, "int8_launches"),
            "join_attention_paged": (join_flash_attention_paged, "launches"),
            "compress": (fused_compress, "launches"),
            "compress_f32": (fused_compress, "f32_launches"),
            "decompress": (fused_decompress, "launches"),
            "decompress_f32": (fused_decompress, "f32_launches"),
            "embedding_bag": (embedding_bag_op, "launches"),
            "embedding_bag_mean": (embedding_bag_op, "mean_launches"),
            "embedding_bag_cast": (embedding_bag_op, "cast_launches"),
            "embedding_bag_wide": (embedding_bag_op, "wide_launches"),
            "embedding_bag_narrow": (embedding_bag_op, "narrow_launches"),
            "embedding_bag_generic": (embedding_bag_op, "generic_launches"),
            "split_attention_tensor_core": (split_flash_attention,
                                            "tensor_core_launches"),
            "split_attention_cuda_core": (split_flash_attention,
                                          "cuda_core_launches"),
            "join_attention_tensor_core": (join_flash_attention,
                                           "tensor_core_launches"),
            "join_attention_cuda_core": (join_flash_attention,
                                         "cuda_core_launches"),
            "join_attention_paged_tensor_core": (join_flash_attention_paged,
                                                 "tensor_core_launches"),
            "join_attention_paged_cuda_core": (join_flash_attention_paged,
                                               "cuda_core_launches"),
            "compress_tensor_core": (fused_compress, "tensor_core_launches"),
            "compress_cuda_core": (fused_compress, "cuda_core_launches"),
            "decompress_tensor_core": (fused_decompress,
                                       "tensor_core_launches"),
            "decompress_cuda_core": (fused_decompress,
                                     "cuda_core_launches")}


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before it;
    returns its result and the launches it made, by kernel."""
    counters = launch_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    result = fn()
    return result, {k: getattr(w, a) for k, (w, a) in counters.items()}


# the kernels each path must launch; a plain-impl run must launch none.
# The bf16 paths route every split and join call to the tensor-core
# kernels, the float32 ones to the CUDA-core kernels; every compress and
# decompress call, in every type, to the tensor-core ones (a CUDA-core
# launch on any path fails the script)
_SPLIT_TC, _SPLIT_CC = ("split_attention_tensor_core",), \
    ("split_attention_cuda_core",)
_JOIN_TC = ("split_attention_tensor_core", "join_attention_tensor_core")
_JOIN_CC = ("split_attention_cuda_core", "join_attention_cuda_core")
_COMPRESS_TC, _DECOMPRESS_TC = ("compress_tensor_core",), \
    ("decompress_tensor_core",)
_FP16_SERVE = ("split_attention", "join_attention", "join_attention_row",
               "decompress", *_DECOMPRESS_TC)
_INT8_SERVE = ("split_attention", "join_attention", "join_attention_int8",
               "join_attention_row", "decompress_f32", *_DECOMPRESS_TC)
_CACHED_SERVE = ("split_attention", "join_attention", "join_attention_paged",
                 "join_attention_row", "decompress_f32", *_DECOMPRESS_TC)
# the concat join: split attention over [B, 512], no join kernel, and the
# flash-decode CLS-only layer
_LEGACY_SERVE = ("split_attention", "decompress", "decode_attention",
                 *_DECOMPRESS_TC)
_LM_PREFILL = ("split_attention_causal", "split_attention_window")
# gemma3's decode splits its 2064 (global) and 1024 (window) keys across
# blocks and merges them; PreTTR's CLS rows at a micro-batch of 32 fill
# the card with one split, at rank_forward's 4 pairs they split
_LM_DECODE = ("decode_attention", "decode_attention_window",
              "decode_attention_merge", "decode_attention_window_merge")
# PQ reps decode by a codebook gather (plain torch) to float32, which the
# float32-input decompress kernel widens; a PQ index stores no layer-l
# K/V, so its cached drain assembles dense reps from the pools and joins
# them with the dense join kernel (the paged one walks stored K/V only)
_PQ_SERVE = ("split_attention", "join_attention", "join_attention_row",
             "decompress_f32", *_DECOMPRESS_TC)
# the cascade's first stage decodes every doc (fp16 and pruned indexes
# through the fp16-input decompress, int8 and pq through the float32
# one), its re-rank serves as the drains do
_CASCADE = ("split_attention", "join_attention", "join_attention_row",
            "decompress", "decompress_f32", *_DECOMPRESS_TC)
_INDEX_F16 = ("split_attention", "compress", *_SPLIT_TC, *_COMPRESS_TC)
_INDEX_F32 = ("split_attention", "compress_f32", *_SPLIT_TC, *_COMPRESS_TC)
# a pruned build scores salience on the decompressed fp16 store
_INDEX_PRUNED = _INDEX_F16 + ("decompress", *_DECOMPRESS_TC)
PATH_KERNELS = {
    "index": _INDEX_F16, "index_pq": _INDEX_F32, "index_pruned": _INDEX_PRUNED,
    "serve_pq": _PQ_SERVE + _JOIN_TC, "serve_pq_f32": _PQ_SERVE + _JOIN_CC,
    "serve_pq_zipf_f32": _PQ_SERVE + _JOIN_CC,
    "serve_pq_cached": _PQ_SERVE + _JOIN_TC,
    "serve_pq_cached_f32": _PQ_SERVE + _JOIN_CC,
    "serve_pruned": _FP16_SERVE + _JOIN_TC,
    "serve_pruned_f32": _FP16_SERVE + _JOIN_CC,
    "cascade_index_fp16": _INDEX_F16, "cascade_index_int8": _INDEX_F32,
    "cascade_index_pq": _INDEX_F32, "cascade_index_pruned": _INDEX_PRUNED,
    "cascade": _CASCADE + _JOIN_TC,
    "cascade_pq_f32": _PQ_SERVE + _JOIN_CC,
    **{f"plain_{p}": () for p in (
        "pq_bf16", "pq_f32", "pq_cached_bf16", "pq_cached_f32",
        "pruned_bf16", "pruned_f32", "cascade_pq_bf16", "cascade_pq_f32")},
    "serve": _FP16_SERVE + _JOIN_TC, "serve_f32": _FP16_SERVE + _JOIN_CC,
    "serve_sync": _FP16_SERVE + _JOIN_TC,
    "serve_legacy": _LEGACY_SERVE + _SPLIT_TC,
    "serve_legacy_f32": _LEGACY_SERVE + _SPLIT_CC,
    # rank_forward ends in the decode layer, join_and_score in the row
    "soundness": ("split_attention", "join_attention", "join_attention_row",
                  "join_attention_row_merge", "decode_attention",
                  "decode_attention_merge", "compress", "decompress",
                  *_JOIN_CC, *_COMPRESS_TC, *_DECOMPRESS_TC),
    "index_int8": ("split_attention", "compress_f32", "decompress_f32",
                   *_SPLIT_TC, *_COMPRESS_TC, *_DECOMPRESS_TC),
    "serve_int8_kv": _INT8_SERVE + _JOIN_TC,
    "serve_int8_kv_f32": _INT8_SERVE + _JOIN_CC,
    "serve_int8_kv_zipf_f32": _INT8_SERVE + _JOIN_CC,
    "serve_cached": _CACHED_SERVE + _JOIN_TC
    + ("join_attention_paged_tensor_core",),
    "serve_cached_f32": _CACHED_SERVE + _JOIN_CC
    + ("join_attention_paged_cuda_core",),
    "plain_bf16": (), "plain_f32": (),
    "plain_legacy_bf16": (), "plain_legacy_f32": (),
    "plain_int8_kv_bf16": (), "plain_int8_kv_f32": (),
    "plain_cached_bf16": (), "plain_cached_f32": (),
    # gemma3-4b: prefill through the causal (global) and window (local)
    # forms, decode through both window forms of flash decode
    "lm_prefill": _LM_PREFILL + _SPLIT_TC, "lm_decode": _LM_DECODE,
    "lm_cuda_f32": _LM_PREFILL + _LM_DECODE + _SPLIT_CC,
    "lm_soundness": _LM_PREFILL + _SPLIT_CC,
    "lm_plain_bf16": (), "lm_plain_f32": (),
    # recsys: DLRM's single-hot gather is the sum form over a bf16 table,
    # its towers mean bags, all on the wide kernel (256-byte rows); DeepFM's
    # gather rounds float32 rows to bf16 (the cast form) and its
    # first-order term, item vectors and retrieval are sum bags, all on the
    # narrow kernel (40- and 4-byte rows).  The generic kernel on any of
    # them fails the run
    "dlrm_serve_p99": ("embedding_bag", "embedding_bag_wide"),
    "dlrm_serve_bulk": ("embedding_bag", "embedding_bag_wide"),
    "dlrm_retrieval": ("embedding_bag_mean", "embedding_bag_wide"),
    "dlrm_item_tower": ("embedding_bag_mean", "embedding_bag_wide"),
    "deepfm_serve_p99": ("embedding_bag", "embedding_bag_cast",
                         "embedding_bag_narrow"),
    "deepfm_serve_bulk": ("embedding_bag", "embedding_bag_cast",
                          "embedding_bag_narrow"),
    "deepfm_item_vectors": ("embedding_bag", "embedding_bag_narrow"),
    "deepfm_retrieval": ("embedding_bag", "embedding_bag_narrow"),
    "xdeepfm_serve_p99": ("embedding_bag", "embedding_bag_cast",
                          "embedding_bag_narrow"),
    **{f"plain_{p}": () for p in (
        "dlrm_serve_p99", "dlrm_serve_bulk", "dlrm_retrieval",
        "dlrm_item_tower", "deepfm_serve_p99", "deepfm_serve_bulk",
        "deepfm_item_vectors", "deepfm_retrieval", "xdeepfm_serve_p99")},
}
# the paths whose launches make the kernels line's `launches`: the index
# builds, the bf16 drains of each serving form, the cascade's bf16 run,
# the LM's bf16 prefill and decode, and the recsys serve_bulk forwards,
# retrieval and towers
MAIN_PATHS = ("index", "serve", "serve_legacy", "index_int8",
              "serve_int8_kv", "serve_cached", "index_pq", "serve_pq",
              "serve_pq_cached", "index_pruned", "serve_pruned",
              "cascade_index_fp16", "cascade_index_int8", "cascade_index_pq",
              "cascade_index_pruned", "cascade", "lm_prefill", "lm_decode",
              "dlrm_serve_bulk", "dlrm_retrieval", "dlrm_item_tower",
              "deepfm_serve_bulk", "deepfm_item_vectors", "deepfm_retrieval",
              "xdeepfm_serve_p99")


def serve(torch, params, cfg, index, requests, label, name, passes=1,
          **svc_kw):
    """Serve ``requests`` ``passes`` times on one service, after a
    one-request warm-up on another; returns each pass's scores, the
    launches of the timed passes and the printed line."""
    from repro_torch.serving import RankingService, RankRequest
    warm = RankingService(params, cfg, index, micro_batch=MICRO_BATCH,
                          use_layer_kv=svc_kw.get("use_layer_kv"),
                          fused=svc_kw.get("fused", True))
    q, qv, ids = requests[0]
    warm.rank(q, qv, ids[:MICRO_BATCH])
    del warm
    svc = RankingService(params, cfg, index, micro_batch=MICRO_BATCH,
                         **svc_kw)
    torch.cuda.synchronize()
    walls = []

    def drain():
        out = []
        for _ in range(passes):
            t0 = time.perf_counter()
            for i, (q, qv, ids) in enumerate(requests):
                svc.submit(RankRequest(q, qv, ids, request_id=f"r{i}"))
            out.append(svc.drain())
            walls.append(time.perf_counter() - t0)
        return out

    resps, launches = counted(drain)
    runs = []
    for resp in resps:
        scores = {}
        for r in resp:
            assert list(r.scores) == sorted(r.scores, reverse=True), \
                r.request_id
            for doc, sc in zip(r.doc_ids, r.scores):
                scores[(r.request_id, doc)] = float(sc)
        runs.append(scores)
    finite = all(math.isfinite(s) for sc in runs for s in sc.values())
    st = svc.stats
    wall = sum(walls)
    line = {"phase": "serve", "run": label, "device": name,
            "requests": len(requests) * passes, "rows": st.n_rows,
            "batches": st.n_batches, "wall_s": wall,
            "qps": len(requests) * passes / wall,
            "docs_per_s": st.n_rows / wall, "pad_rows": st.n_pad_rows,
            "h2d_bytes": st.h2d_bytes, "query_encode_s": st.query_encode_s,
            "load_s": st.load_s, "combine_s": st.combine_s,
            "prefetch_depth": svc.engine.prefetch_depth,
            "fused": svc.engine.fused,
            "join_dispatch": st.n_join_dispatch,
            "decode_dispatch": st.n_decode_dispatch, "finite": finite,
            "launches": launches}
    cache = svc.doc_cache
    if cache is not None:
        line.update(pass_wall_s=walls,
                    pass_qps=[len(requests) / w for w in walls],
                    doc_cache_hit=st.n_doc_cache_hit,
                    doc_cache_miss=st.n_doc_cache_miss,
                    doc_cache_hit_rate=st.doc_cache_hit_rate,
                    evictions=cache.evictions,
                    resident_docs=st.resident_docs,
                    doc_hbm_bytes=st.doc_hbm_bytes,
                    cache_pages=cache.capacity_pages,
                    page_bytes=cache.page_bytes)
    emit(line)
    if not finite or any(len(sc) != len(requests) * N_CANDIDATES
                         for sc in runs):
        raise AssertionError(f"serve {label}: non-finite or missing scores")
    if cache is not None and not (st.n_doc_cache_hit and st.n_doc_cache_miss
                                  and cache.evictions):
        raise AssertionError(f"serve {label}: the doc cache saw no hit, miss "
                             f"or eviction")
    if st.n_decode_dispatch or st.n_join_dispatch != st.n_batches:
        raise AssertionError(f"serve {label}: {st.n_decode_dispatch} decode "
                             f"dispatches, {st.n_join_dispatch} joins for "
                             f"{st.n_batches} micro-batches")
    return runs, launches, line


def profile_serve(torch, params, cfg, index, requests, name):
    """Where a drain's device time goes: one drain of two requests (four
    micro-batches) under torch.profiler, the device's busy share of the
    wall time and its kernels by total time."""
    from repro_torch.serving import RankingService, RankRequest
    svc = RankingService(params, cfg, index, micro_batch=MICRO_BATCH)
    q, qv, ids = requests[0]
    svc.rank(q, qv, ids[:MICRO_BATCH])         # warm-up

    def drain():
        svc._qcache.clear()
        for i, (q, qv, ids) in enumerate(requests[:2]):
            svc.submit(RankRequest(q, qv, ids, request_id=f"p{i}"))
        svc.drain()

    profile_run(torch, name, "cuda_bf16", drain,
                micro_batches=2 * N_CANDIDATES // MICRO_BATCH)


def max_diff(a, b):
    return max(abs(a[k] - b[k]) for k in a)


def serve_faults(torch, params, cfg, index, requests, name, clean):
    """One seeded staging error in the kernel bf16 service: only that
    micro-batch's rows fail (-inf, responses degraded) and every other
    score is bit-equal to the clean run; then ``max_queue=2`` sheds the
    third submit."""
    from repro_torch.serving import (FaultPlan, FaultSpec, RankingService,
                                     RankRequest, ServiceOverloadError)
    svc = RankingService(params, cfg, index, micro_batch=MICRO_BATCH)
    spec = FaultSpec("engine.stage", "error", after=FAULT_AFTER)
    with FaultPlan([spec], seed=SEED) as plan:
        for i, (q, qv, ids) in enumerate(requests):
            svc.submit(RankRequest(q, qv, ids, request_id=f"r{i}"))
        resps = svc.drain()
    failed = {(r.request_id, d) for r in resps for d in r.failed_doc_ids}
    want = lambda key: -math.inf if key in failed else clean[key]
    wrong = [(r.request_id, d) for r in resps
             for d, sc in zip(r.doc_ids, r.scores)
             if sc != want((r.request_id, d))]
    degraded = sorted(r.request_id for r in resps if r.degraded)
    shed = RankingService(params, cfg, index, micro_batch=MICRO_BATCH,
                          max_queue=2)
    q, qv, ids = requests[0]
    for i in range(2):
        shed.submit(RankRequest(q, qv, ids, request_id=f"s{i}"))
    try:
        shed.submit(RankRequest(q, qv, ids, request_id="s2"))
        shed_error = None
    except ServiceOverloadError as e:
        shed_error = type(e).__name__
    n_served = len(shed.drain())
    line = {"phase": "serve_faults", "device": name,
            "fired": plan.n_fired(), "failed_rows": len(failed),
            "n_failed_rows": svc.stats.n_failed_rows,
            "degraded_requests": degraded,
            "n_degraded": svc.stats.n_degraded,
            "wrong_scores": len(wrong), "shed_error": shed_error,
            "n_shed": shed.stats.n_shed, "served_after_shed": n_served}
    emit(line)
    if not (plan.n_fired() == 1 and len(failed) == MICRO_BATCH
            and svc.stats.n_failed_rows == MICRO_BATCH and degraded
            and svc.stats.n_degraded == len(degraded) and not wrong
            and shed_error and shed.stats.n_shed == 1 and n_served == 2):
        raise AssertionError(f"serve_faults: {line}")


def _stage_diff(a, b, stage):
    """Two cascades' ``stage`` outputs: the largest score difference
    (first stage: rank by rank, since both hold the top-k of two nearby
    score vectors; re-rank: over the (query, doc) pairs both hold) and
    the share of candidates both hold."""
    (ids_a, sc_a), (ids_b, sc_b) = a.stages[stage], b.stages[stage]
    common = sum(len(set(x) & set(y)) for x, y in zip(ids_a, ids_b))
    if stage == "first_stage":
        diff = float(abs(sc_a - sc_b).max())
    else:
        diff = 0.0
        for xa, sa, xb, sb in zip(ids_a, sc_a, ids_b, sc_b):
            other = dict(zip(xb.tolist(), sb.tolist()))
            diff = max([diff] + [abs(s - other[d])
                                 for d, s in zip(xa.tolist(), sa.tolist())
                                 if d in other])
    return diff, common / ids_a.size


def cascade_phases(torch, name, params, cfg, cfg32, plain, launches, build):
    """The quality cascade (``run_cascade``) at full width over a
    SyntheticIRWorld of CASCADE_DOCS docs: one index each of
    CASCADE_INDEXES, each searched by the first stage and re-ranked
    through the kernels in bf16 (the ``cascade`` path), with its metrics
    and storage; then over the PQ index through the kernels in float32
    and through the plain backend in bf16 and float32, held to
    CASCADE_F32_TOL (float32) and twice the plain backend's own bf16
    rounding (bf16)."""
    from repro_torch.data.synthetic_ir import SyntheticIRWorld
    from repro_torch.eval import run_cascade
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    world = SyntheticIRWorld(vocab_size=cfg.backbone.vocab_size,
                             n_docs=CASCADE_DOCS, n_queries=CASCADE_QUERIES,
                             doc_len=cfg.max_doc_len - 1, seed=SEED)
    emit({"phase": "cascade_world", "device": name, "n_docs": world.n_docs,
          "doc_len": world.doc_len, "n_queries": world.n_queries,
          "vocab_size": world.vocab_size,
          "relevant_per_query": float(world.n_relevant().mean()),
          "world_s": time.perf_counter() - t0})
    cascade = lambda c, index: run_cascade(
        params, c, world, k=CASCADE_K, k_metric=CASCADE_K_METRIC,
        micro_batch=MICRO_BATCH, index=index)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as root:
        indexes = {kind: build(os.path.join(root, kind),
                               f"cascade_index_{kind}",
                               corpus=list(world.docs), **kw)[0]
                   for kind, kw in CASCADE_INDEXES.items()}
        walls = {}

        def run_all():
            out = {}
            for kind, index in indexes.items():
                t1 = time.perf_counter()
                out[kind] = cascade(cfg, index)
                walls[kind] = time.perf_counter() - t1
            return out

        results, launches["cascade"] = counted(run_all)
        for kind, res in results.items():
            index = indexes[kind]
            emit({"phase": "cascade", "index": kind, "device": name,
                  "first_stage": res.first_stage, "rerank": res.rerank,
                  "storage_bytes": index.storage_bytes(),
                  "bytes_per_token": index.bytes_per_token(),
                  "n_tokens": int(index.doc_lengths.sum()),
                  "max_doc_len": index.max_doc_len, "wall_s": walls[kind],
                  "meta": res.meta})
        runs = {"cascade": results["pq"]}
        for path, c in (("cascade_pq_f32", cfg32),
                        ("plain_cascade_pq_bf16", plain(cfg)),
                        ("plain_cascade_pq_f32", plain(cfg32))):
            runs[path], launches[path] = counted(
                lambda c=c: cascade(c, indexes["pq"]))
        del indexes
    line = {"phase": "cascade_agreement", "index": "pq", "device": name}
    ok = True
    for stage in ("first_stage", "rerank"):
        f32, f32_common = _stage_diff(runs["cascade_pq_f32"],
                                      runs["plain_cascade_pq_f32"], stage)
        bf16, bf16_common = _stage_diff(runs["cascade"],
                                        runs["plain_cascade_pq_bf16"], stage)
        noise, _ = _stage_diff(runs["plain_cascade_pq_bf16"],
                               runs["plain_cascade_pq_f32"], stage)
        line[stage] = {"f32_max_abs_diff": f32, "f32_tol": CASCADE_F32_TOL,
                       "f32_common": f32_common,
                       "bf16_max_abs_diff": bf16, "bf16_tol": 2 * noise,
                       "bf16_rounding_of_plain": noise,
                       "bf16_common": bf16_common}
        ok = ok and f32 <= CASCADE_F32_TOL and bf16 <= 2 * noise
    line["metrics"] = {p: r.flat() for p, r in runs.items()}
    emit({**line, "ok": ok})
    if not ok:
        raise AssertionError("the cascade through the kernels disagrees "
                             "with the plain backend's")


# ---------------------------------------------------------------------------
# Phase 6: gemma3-4b prefill and decode
# ---------------------------------------------------------------------------


def lm_prefill(torch, T, params, cfg, prompts):
    """``forward(collect_cache=True)`` then the last position's logits;
    returns (logits [B, 1, V] float32, the collected (k, v), seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        hidden, kv, _ = T.forward(params, cfg, prompts, collect_cache=True)
        lg = T.logits(params, cfg, hidden[:, -1:])
    torch.cuda.synchronize()
    return lg, kv, time.perf_counter() - t0


def lm_decode(torch, T, params, cfg, kv, first, forced=None):
    """The collected K/V (S keys) copied into ``init_decode_cache(cfg, B,
    S + LM_STEPS)``, then LM_STEPS ``decode_step``s from position S:
    greedy from ``first`` [B, 1], or fed ``forced`` [B, LM_STEPS]
    (teacher forcing).  Returns (each step's logits, the tokens fed
    [B, LM_STEPS], seconds of the steps alone)."""
    b, s = kv[0].shape[1], kv[0].shape[2]
    with torch.inference_mode():
        cache = T.init_decode_cache(cfg, b, s + LM_STEPS)
        cache[0][:, :, :s] = kv[0]
        cache[1][:, :, :s] = kv[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, fed, out = first, [], []
        for i in range(LM_STEPS):
            if forced is not None:
                tok = forced[:, i:i + 1]
            fed.append(tok)
            lg, cache = T.decode_step(params, cfg, tok, cache, s + i)
            out.append(lg)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
    return out, torch.cat(fed, 1), time.perf_counter() - t0


def lm_max_diff(a, b):
    """Max |a - b| over the last-position logits and every step's."""
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def profile_lm(torch, T, params, cfg, prompts, fed, name):
    """Where the LM's device time goes: one prefill of 4 x 2048 tokens,
    then 4 decode steps, each under torch.profiler: the device's busy
    time beside the wall time, and its kernels by total time."""
    _, kv, _ = lm_prefill(torch, T, params, cfg, prompts)     # warm
    with torch.inference_mode():
        cache = T.init_decode_cache(cfg, LM_B, LM_S + LM_STEPS)
        cache[0][:, :, :LM_S] = kv[0]
        cache[1][:, :, :LM_S] = kv[1]
    del kv

    def steps():
        with torch.inference_mode():
            for i in range(4):
                T.decode_step(params, cfg, fed[:, i:i + 1], cache, LM_S + i)

    profile_run(torch, name, "lm_prefill",
                lambda: lm_prefill(torch, T, params, cfg, prompts))
    profile_run(torch, name, "lm_decode_4_steps", steps)


def profile_run(torch, name, label, fn, **extra):
    """One call of ``fn`` under torch.profiler: the wall time, the
    device's busy time and its kernels by total time.

    Late in this script's run on an H100 the profiler has dropped the
    first device events of a window (DeepFM's forward lost its first 2 ms,
    both embedding-bag launches among them), so a first call of ``fn``
    is traced and discarded (the profiler's warm-up step) before the one
    read; and the port's kernels in the profile are held against the
    launch counters.  Where they differ the line says ``complete:
    false`` and gives no busy time or share."""
    from torch.profiler import ProfilerActivity, profile, schedule
    read = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: read.append(p.key_averages())) \
            as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        _, launched = counted(fn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    emit({"phase": "profile", "run": label, "device": name, **extra,
          "wall_ms": wall_ms,
          **_device_time(read[0], wall_ms, sum(
              n for k, n in launched.items() if k not in ROUTE_COUNTERS))})


def _device_time(events, wall_ms, launched):
    """The device's busy time, its share of ``wall_ms`` and its kernels by
    total time, from a profile's ``key_averages()``; ``launched`` kernels
    of the port's must all be in it, else the busy time is not
    reported."""
    import re

    from torch.autograd import DeviceType
    by_name = {}
    for e in events:
        # ProfilerStep* sums the step's kernels: not a kernel of its own
        if e.device_type != DeviceType.CUDA \
                or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        ours = re.search(r"(\w+_kernel)\b", e.key)
        key = ours.group(1) if ours else e.key[:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + e.count, t + us / 1e3)
    profiled = sum(n for k, (n, _) in by_name.items() if k in OUR_KERNELS)
    complete = profiled == launched
    busy_ms = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"complete": complete, "launched": launched,
            "profiled": profiled,
            "device_busy_ms": busy_ms if complete else None,
            "device_busy_share": busy_ms / wall_ms if complete else None,
            "top": [{"name": k, "count": n, "device_ms": t}
                    for k, (n, t) in top]}


def lm_phases(torch, name, launches):
    """gemma3-4b at full width on the card: the timed bf16 prefill and
    greedy decode through the kernels, the same through the plain impl
    and in float32 (fed the kernel run's tokens), the soundness of
    prefill + decode against a longer forward, and a profile."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.gemma3_4b import full_config
    from repro_torch.models import transformer as T

    cfg = full_config(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_B, LM_S))).cuda()
    impl = lambda c, attn, dt: dataclasses.replace(c, attn_impl=attn,
                                                   compute_dtype=dt)
    cfg32 = impl(cfg, "cuda", torch.float32)
    emit({"phase": "lm_model", "device": name, "config": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": cfg.num_params(),
          "param_bytes": sum(t.numel() * t.element_size() for t in
                             _leaves(params)),
          "layer_windows": cfg.layer_windows(), "init_s": init_s})

    # warm-up (cuBLAS handles, the kernel library), not counted
    lg, kv, _ = lm_prefill(torch, T, params, cfg, prompts[:, :64])
    lm_decode(torch, T, params, cfg, kv, lg.argmax(-1))
    del lg, kv

    # the main path: bf16 prefill, then greedy decode, through the kernels
    (lg0, kv, prefill_s), launches["lm_prefill"] = counted(
        lambda: lm_prefill(torch, T, params, cfg, prompts))
    flops = 2 * cfg.num_active_params() * LM_B * LM_S
    emit({"phase": "lm_prefill", "device": name, "batch": LM_B,
          "prompt": LM_S, "ms": prefill_s * 1e3,
          "tokens_per_s": LM_B * LM_S / prefill_s, "model_flops": flops,
          "model_flops_share_of_bf16_peak":
              flops / prefill_s / PEAK_BF16_FLOPS,
          "finite": bool(torch.isfinite(lg0).all()),
          "launches": launches["lm_prefill"]})
    (steps, fed, decode_s), launches["lm_decode"] = counted(
        lambda: lm_decode(torch, T, params, cfg, kv, lg0.argmax(-1)))
    del kv
    emit({"phase": "lm_decode", "device": name, "batch": LM_B,
          "steps": LM_STEPS, "cache": LM_S + LM_STEPS,
          "ms_per_step": decode_s / LM_STEPS * 1e3,
          "tokens_per_s": LM_B * LM_STEPS / decode_s,
          "finite": all(bool(torch.isfinite(x).all()) for x in steps),
          "launches": launches["lm_decode"]})
    cuda_bf16 = [lg0, *steps]
    if not all(bool(torch.isfinite(x).all()) for x in cuda_bf16) \
            or lg0.shape != (LM_B, 1, cfg.vocab_size):
        raise AssertionError("lm: non-finite or misshapen logits")

    # agreement: the plain impl in bf16 and float32 and the kernels in
    # float32, all fed the kernel run's tokens
    runs = {}
    for path, c in (("lm_plain_bf16", impl(cfg, "plain", torch.bfloat16)),
                    ("lm_plain_f32", impl(cfg, "plain", torch.float32)),
                    ("lm_cuda_f32", cfg32)):
        def run(c=c):
            lg, kv, _ = lm_prefill(torch, T, params, c, prompts)
            out, _, _ = lm_decode(torch, T, params, c, kv, None, forced=fed)
            return [lg, *out]
        runs[path], launches[path] = counted(run)
    bf16_noise = lm_max_diff(runs["lm_plain_bf16"],
                             runs["lm_plain_f32"])
    agree = {"phase": "lm_agreement", "device": name,
             "f32_max_abs_diff": lm_max_diff(runs["lm_cuda_f32"],
                                             runs["lm_plain_f32"]),
             "f32_tol": LM_F32_TOL,
             "bf16_max_abs_diff": lm_max_diff(cuda_bf16,
                                              runs["lm_plain_bf16"]),
             "bf16_tol": 2 * bf16_noise, "bf16_rounding_of_plain": bf16_noise,
             "bf16_kernels_vs_plain_f32": lm_max_diff(
                 cuda_bf16, runs["lm_plain_f32"]),
             "logit_abs_max": runs["lm_plain_f32"][0].abs().max().item(),
             "same_greedy_tokens_plain_bf16": int(sum(
                 (a.argmax(-1) == b.argmax(-1)).sum().item()
                 for a, b in zip(cuda_bf16, runs["lm_plain_bf16"]))),
             "of": LM_B * (LM_STEPS + 1),
             "launches": {p: launches[p] for p in runs}}
    emit(agree)
    if agree["f32_max_abs_diff"] > LM_F32_TOL \
            or agree["bf16_max_abs_diff"] > agree["bf16_tol"]:
        raise AssertionError("lm: the kernels disagree with the plain impl")

    # soundness: prefill over 2048 + one decode step == forward over 2049
    def sound():
        with torch.inference_mode():
            h, _, _ = T.forward(params, cfg32,
                                torch.cat([prompts, fed[:, :1]], 1))
            return T.logits(params, cfg32, h[:, -1:])
    longer, launches["lm_soundness"] = counted(sound)
    err = (longer - runs["lm_cuda_f32"][1]).abs().max().item()
    emit({"phase": "lm_soundness", "device": name, "max_abs_err": err,
          "tol": LM_SOUND_TOL, "launches": launches["lm_soundness"]})
    if not err <= LM_SOUND_TOL:
        raise AssertionError("lm: prefill + decode_step != forward")
    del runs, longer
    profile_lm(torch, T, params, cfg, prompts, fed, name)


# ---------------------------------------------------------------------------
# Phase 7: the recsys models (DLRM-MLPerf, DeepFM, xDeepFM)
# ---------------------------------------------------------------------------


def memory(torch):
    free, total = torch.cuda.mem_get_info()
    return {"free_bytes": free, "total_bytes": total,
            "max_allocated_bytes": torch.cuda.max_memory_allocated()}


def wall_ms(torch, fn, n=5):
    """Median wall time of ``fn`` in ms, each call ended by a synchronize
    (a request's latency as its caller sees it), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def held(torch, got, want, kind):
    """``got`` against ``want`` within REC_REL[kind] * max|want| (``kind``
    "bits": bit-equal): (max_abs_diff, atol, ok); non-finite output fails."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol = REC_REL[kind] * want.float().abs().max().item()
    ok = (torch.equal(got, want) if kind == "bits" else err <= atol) \
        and bool(torch.isfinite(got).all())
    return err, atol, ok


def rec_paths(torch, name, launches, model, run, path, fn, plain_fn, kind,
              **extra):
    """``fn`` (through the kernel) and ``plain_fn`` once each with the
    counters zeroed (paths ``path`` and ``plain_<path>``), held against
    each other by :func:`held` (``kind`` for every output), then timed;
    prints the line and returns the kernel run's output (a tensor or a
    tuple of them)."""
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    got, launches[path] = counted(fn)
    want, launches["plain_" + path] = counted(plain_fn)
    checks = [held(torch, g, w, kind)
              for g, w in zip(as_tuple(got), as_tuple(want))]
    ok = all(c[2] for c in checks) and all(
        e.get("ok", True) for e in extra.values() if isinstance(e, dict))
    ms, plain_ms = wall_ms(torch, fn), wall_ms(torch, plain_fn)
    line = {"phase": "recsys", "model": model, "run": run, "device": name,
            **extra, "ms": ms, "plain_ms": plain_ms,
            "shapes": [list(g.shape) for g in as_tuple(got)],
            "max_abs_diff": [c[0] for c in checks],
            "limit": {"kind": kind, "atol": [c[1] for c in checks]},
            "bit_equal": all(torch.equal(g, w) for g, w in
                             zip(as_tuple(got), as_tuple(want))),
            "ok": ok, "launches": launches[path], **memory(torch)}
    emit(line)
    if not ok:
        raise AssertionError(f"{model} {run}: the kernel path disagrees with "
                             f"the plain path or is not finite")
    return got


def bag_row(torch, rows, name, table, ids, *, mode="sum", out_dtype=None,
            row=True, library=None, **extra):
    """The embedding-bag kernel at a main-path shape against its plain
    version, timed beside them and ``F.embedding_bag``.  Bound: bytes,
    each distinct table row read once (what these ids need), the ids and
    the output once; 2 FLOPs an element of a slot.  Beside it
    ``l2_bound_ms``, the L2's floor: the same bytes, each distinct row as
    the 32-byte sectors it touches, all of which pass the L2, over its peak
    rate (``L2_PEAK_RATE``).  ``slot_sectors`` counts the sectors of every
    slot's row, what a kernel taking the bags in order asks of the L1 and
    L2.  The call must run a routed kernel (wide or narrow), not the
    generic one."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import (embedding_bag_op,
                                                   embedding_bag_ref)
    out_dtype = table.dtype if out_dtype is None else out_dtype
    got = embedding_bag_op(table, ids, mode=mode, out_dtype=out_dtype)
    want = embedding_bag_ref(table, ids, mode=mode, out_dtype=out_dtype)
    kind = "bits" if ids.shape[1] == 1 else \
        "float32" if out_dtype == torch.float32 else "bfloat16"
    err, atol, ok = held(torch, got, want, kind)
    shape = [*table.shape, *ids.shape, mode, str(table.dtype),
             str(out_dtype)]
    emit({"phase": "kernel_check", "kernel": name, "shape": shape,
          "max_abs_err": err, "limit": {"kind": kind, "atol": atol},
          "bit_equal": torch.equal(got, want), "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version ({kind}, atol {atol})")
    del want
    row_bytes = table.shape[1] * table.element_size()
    distinct_ids = torch.unique(ids)
    distinct = distinct_ids.numel()
    n_bytes = distinct * row_bytes + nbytes(ids, got)

    def sector_spans(i):
        start = table.data_ptr() + i * row_bytes
        return start // 32, (start + row_bytes - 1) // 32

    first, last = sector_spans(ids)
    slot_sectors = int((last - first + 1).sum())
    first, last = sector_spans(distinct_ids)
    span = torch.arange(int((last - first).max()) + 1, device=ids.device)
    touched = first[:, None] + span
    distinct_sectors = torch.unique(touched[touched <= last[:, None]]).numel()
    l2_bytes = distinct_sectors * 32 + nbytes(ids, got)
    if library is None:
        library = lambda: F.embedding_bag(ids, table, mode=mode)
    line = record_kernel(
        rows, name, "src/repro_torch/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag/kernel.py:45", err,
        lambda: embedding_bag_op(table, ids, mode=mode, out_dtype=out_dtype),
        lambda: embedding_bag_ref(table, ids, mode=mode, out_dtype=out_dtype),
        library, 2 * ids.numel() * table.shape[1], n_bytes, PEAK_F32_FLOPS,
        "f32 CUDA cores", row=row, distinct_rows=distinct,
        slot_row_bytes=ids.numel() * row_bytes, slot_sectors=slot_sectors,
        distinct_sectors=distinct_sectors, l2_bytes=l2_bytes,
        l2_bound_ms=l2_bytes / L2_PEAK_RATE * 1e3, l2_peak_rate=L2_PEAK_RATE,
        **extra)
    routed = line.get("kernels_run")
    if routed not in (["embedding_bag_wide"], ["embedding_bag_narrow"]):
        raise AssertionError(f"{name} {shape}: ran {routed}, not a routed "
                             f"embedding-bag kernel")


def click_ids(torch, rng, batch, vocab_sizes, n_dense=0):
    """``click_batch`` dense features and ids on the card."""
    from repro_torch.data.recsys import click_batch
    b = click_batch(rng, batch, n_dense=n_dense, vocab_sizes=vocab_sizes)
    return (torch.from_numpy(b["dense"]).cuda(),
            torch.from_numpy(b["sparse"]).cuda())


def recsys_phases(torch, name, launches, rows):
    """DLRM-MLPerf at full vocabulary (bf16 table, 48.1 GB), DeepFM at its
    full config and xDeepFM at serve_p99 on the card, each path through
    the embedding-bag kernel and through the plain version; then the
    kernel's three forms at their main-path shapes."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import deepfm, dlrm_mlperf, xdeepfm
    from repro_torch.models.recsys import deepfm as TF
    from repro_torch.models.recsys import dlrm as TD
    from repro_torch.models.recsys import embedding as E

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = lambda c: dataclasses.replace(c, bag_impl="plain")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    # -- DLRM-MLPerf: the whole Criteo-1TB vocabulary in bf16 (dlrm_forward
    #    casts every parameter to bf16 first, so bf16 storage gives float32
    #    storage's numbers)
    cfg = dataclasses.replace(dlrm_mlperf.full_config(),
                              param_dtype=torch.bfloat16)
    n_rows = -(-sum(cfg.vocab_sizes) // 512) * 512
    table_bytes = n_rows * cfg.embed_dim * 2
    free = torch.cuda.mem_get_info()[0]
    if free < table_bytes + (8 << 30):
        raise AssertionError(f"dlrm-mlperf: the card has {free} bytes free, "
                             f"the full table needs {table_bytes} and ~8 GB "
                             f"beside it; the vocabulary is not cut")
    t0 = time.perf_counter()
    params = TD.init_dlrm(cfg, gen)
    torch.cuda.synchronize()
    emit({"phase": "recsys_model", "model": cfg.name, "device": name,
          "table_rows": params["table"].shape[0], "embed_dim": cfg.embed_dim,
          "table_dtype": str(params["table"].dtype),
          "table_bytes": nbytes(params["table"]),
          "param_bytes": sum(nbytes(t) for t in _leaves(params)),
          "init_s": time.perf_counter() - t0, **memory(torch)})
    dense, sparse = click_ids(torch, rng, REC_BULK, cfg.vocab_sizes, 13)
    for run, b in (("serve_p99", REC_P99), ("serve_bulk", REC_BULK)):
        rec_paths(torch, name, launches, cfg.name, run, f"dlrm_{run}",
                  lambda: TD.dlrm_forward(params, cfg, dense[:b], sparse[:b]),
                  lambda: TD.dlrm_forward(params, plain(cfg), dense[:b],
                                          sparse[:b]), "bits", batch=b)
    profile_run(torch, name, "dlrm_serve_bulk",
                lambda: TD.dlrm_forward(params, cfg, dense, sparse))
    offsets = E.fused_table_offsets(cfg.vocab_sizes)
    u_dense, u_ids = click_ids(torch, rng, 1, cfg.vocab_sizes, 13)
    u_ids = u_ids[:, cfg.user_fields]
    item_vecs = torch.randn((REC_CANDIDATES, cfg.embed_dim), generator=gen,
                            device="cuda")
    # the user's mean bag is ~0.003 an element beside the bottom MLP's ~1,
    # so the scores alone cannot show a wrong bag: the line holds the bag
    # itself too
    u_bag = lambda c: E.padded_bag(
        params["table"], E.field_ids(u_ids, offsets[cfg.user_fields]),
        mode="mean", out_dtype=c.compute_dtype, impl=c.bag_impl)
    err, atol, ok = held(torch, u_bag(cfg), u_bag(plain(cfg)), "bfloat16")
    rec_paths(torch, name, launches, cfg.name, "retrieval_cand",
              "dlrm_retrieval",
              lambda: TD.retrieval_scores(params, cfg, u_dense, u_ids,
                                          item_vecs),
              lambda: TD.retrieval_scores(params, plain(cfg), u_dense, u_ids,
                                          item_vecs), "bfloat16", batch=1,
              candidates=REC_CANDIDATES,
              user_bag={"max_abs_diff": err,
                        "limit": {"kind": "bfloat16", "atol": atol},
                        "ok": ok})
    del item_vecs
    item_vocab = [cfg.vocab_sizes[f] for f in cfg.item_fields]
    _, items = click_ids(torch, rng, REC_CANDIDATES, item_vocab)
    rec_paths(torch, name, launches, cfg.name, "item_tower", "dlrm_item_tower",
              lambda: TD.item_tower(params, cfg, items),
              lambda: TD.item_tower(params, plain(cfg), items), "bfloat16",
              items=REC_CANDIDATES)
    bag_row(torch, rows, "embedding_bag", params["table"],
            E.field_ids(sparse, offsets).reshape(-1, 1), path="dlrm serve_bulk")
    bag_row(torch, rows, "embedding_bag_mean", params["table"],
            E.field_ids(items, offsets[list(cfg.item_fields)]), mode="mean",
            path="dlrm item_tower")
    del params, dense, sparse, items
    torch.cuda.empty_cache()

    # -- DeepFM (float32 table, bf16 compute: the forward's gather is the
    #    cast form) and xDeepFM at serve_p99
    cfg = deepfm.full_config()
    params = TF.init_deepfm(cfg, gen)
    emit({"phase": "recsys_model", "model": cfg.name, "device": name,
          "table_rows": params["table"].shape[0], "embed_dim": cfg.embed_dim,
          "table_bytes": nbytes(params["table"]),
          "w1_bytes": nbytes(params["w1"]),
          "param_bytes": sum(nbytes(t) for t in _leaves(params)),
          **memory(torch)})
    _, sparse = click_ids(torch, rng, REC_BULK, cfg.vocab_sizes)
    for run, b in (("serve_p99", REC_P99), ("serve_bulk", REC_BULK)):
        rec_paths(torch, name, launches, cfg.name, run, f"deepfm_{run}",
                  lambda: TF.deepfm_forward(params, cfg, sparse[:b]),
                  lambda: TF.deepfm_forward(params, plain(cfg), sparse[:b]),
                  "float32", batch=b)
    profile_run(torch, name, "deepfm_serve_bulk",
                lambda: TF.deepfm_forward(params, cfg, sparse))
    item_vocab = [cfg.vocab_sizes[f] for f in cfg.item_fields]
    _, items = click_ids(torch, rng, REC_CANDIDATES, item_vocab)
    vecs, first = rec_paths(
        torch, name, launches, cfg.name, "item_vectors",
        "deepfm_item_vectors", lambda: TF.item_vectors(params, cfg, items),
        lambda: TF.item_vectors(params, plain(cfg), items), "float32",
        items=REC_CANDIDATES)
    _, u_ids = click_ids(torch, rng, 1, cfg.vocab_sizes)
    u_ids = u_ids[:, cfg.user_fields]
    rec_paths(torch, name, launches, cfg.name, "retrieval_cand",
              "deepfm_retrieval",
              lambda: TF.retrieval_scores(params, cfg, u_ids, vecs, first),
              lambda: TF.retrieval_scores(params, plain(cfg), u_ids, vecs,
                                          first), "float32", batch=1,
              candidates=REC_CANDIDATES)
    flat = E.field_ids(sparse, E.fused_table_offsets(cfg.vocab_sizes))
    single = flat.reshape(-1, 1)
    bag_row(torch, rows, "embedding_bag_cast", params["table"], single,
            out_dtype=torch.bfloat16,
            library=lambda: F.embedding_bag(single, params["table"])
            .to(torch.bfloat16), path="deepfm serve_bulk")
    bag_row(torch, rows, "embedding_bag", params["w1"], flat, row=False,
            path="deepfm serve_bulk first-order (w1)")
    item_flat = E.field_ids(items, E.fused_table_offsets(cfg.vocab_sizes)[
        list(cfg.item_fields)])
    bag_row(torch, rows, "embedding_bag", params["table"], item_flat,
            row=False, path="deepfm item_vectors")
    del params, sparse, items, vecs, first, flat, single, item_flat
    torch.cuda.empty_cache()

    cfg = xdeepfm.full_config()
    params = TF.init_deepfm(cfg, gen)
    _, sparse = click_ids(torch, rng, REC_P99, cfg.vocab_sizes)
    h = max(cfg.cin_layers)
    rec_paths(torch, name, launches, cfg.name, "serve_p99",
              "xdeepfm_serve_p99",
              lambda: TF.deepfm_forward(params, cfg, sparse),
              lambda: TF.deepfm_forward(params, plain(cfg), sparse),
              "float32", batch=REC_P99,
              serve_bulk=f"not run: CIN's [B, {h}, {cfg.n_fields}, "
              f"{cfg.embed_dim}] bf16 outer product is "
              f"{REC_BULK * h * cfg.n_fields * cfg.embed_dim * 2 / 1e9:.1f} "
              f"GB at B = {REC_BULK}")
    del params, sparse
    torch.cuda.empty_cache()


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


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
    global CARD
    CARD = smi
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
    lines = {}                     # path -> its serve line
    plain = lambda c: dataclasses.replace(c, backbone=dataclasses.replace(
        c.backbone, attn_impl="plain", compress_impl="plain"))

    def build(tmp, label, corpus=None, **kw):
        """Build ``corpus`` (the seeded docs by default) into ``tmp``,
        reopen it verified and print its line; every build carries chunk
        checksums, and a build the reopening verified none of fails."""
        corpus = docs if corpus is None else corpus
        report, launches[label] = counted(
            lambda: IndexBuilder(tmp, cfg, params, batch_size=INDEX_BATCH,
                                 **kw).build(corpus))
        t0 = time.perf_counter()
        # the pass open(verify=True), the default, runs, with its count
        index = TermRepIndex.open(tmp, verify=False)
        verified = index.verify_integrity()
        open_s = time.perf_counter() - t0
        line = {"phase": label, "device": name, "n_docs": len(index),
                "open_s": open_s, "open_verify": True,
                "verified_chunks": verified,
                "n_tokens": report.n_tokens, "codec": report.codec,
                "max_doc_len": index.max_doc_len,
                "prune": index.prune_policy,
                "streams": sorted(index.streams_spec()),
                "bytes_per_token": index.bytes_per_token(),
                "storage_bytes": report.storage_bytes,
                "fit_s": report.fit_s, "encode_s": report.encode_s,
                "write_s": report.write_s, "wall_s": report.wall_s,
                "docs_per_s": report.n_docs / report.wall_s,
                "launches": launches[label]}
        emit(line)
        if len(index) != len(corpus) or int(index.doc_lengths.sum()) \
                != report.n_tokens:
            raise AssertionError(f"{label}: reopened index does not hold "
                                 f"the build")
        if line["verified_chunks"] <= 0:
            raise AssertionError(f"{label}: the build carries no chunk "
                                 f"checksums")
        return index, line

    def serve_both(index, reqs, paths, labels, passes=1, **kw):
        """The kernels and the plain impl, bf16 and float32, at the index's
        (pruned) max_doc_len; checks their agreement and returns each
        run's per-pass scores by path."""
        runs = {}
        shape = lambda c: dataclasses.replace(c, max_doc_len=min(
            c.max_doc_len, index.max_doc_len or c.max_doc_len))
        for path, label, c in zip(paths, labels,
                                  map(shape, (cfg, plain(cfg), cfg32,
                                              plain(cfg32)))):
            runs[path], launches[path], lines[path] = serve(
                torch, params, c, index, reqs, label, name, passes=passes,
                **kw)
        s_bf16, p_bf16, s_f32, p_f32 = (runs[p][0] for p in paths)
        # bf16 rounds at other places in the kernels (f32 softmax and P.V)
        # than in the plain impl (probabilities cast to bf16), so the bf16
        # tolerance is twice what bf16 rounding alone moves the plain
        # impl's scores (plain bf16 against plain float32)
        bf16_noise = max_diff(p_bf16, p_f32)
        tol_bf16 = 2 * bf16_noise
        agree = {"phase": "serve_agreement", "runs": paths[0],
                 "device": name,
                 "f32_max_abs_diff": max_diff(s_f32, p_f32), "f32_tol": 1e-3,
                 "bf16_max_abs_diff": max_diff(s_bf16, p_bf16),
                 "bf16_tol": tol_bf16, "bf16_rounding_of_plain": bf16_noise,
                 "bf16_kernels_vs_plain_f32": max_diff(s_bf16, p_f32)}
        emit(agree)
        if agree["f32_max_abs_diff"] > 1e-3 or \
                agree["bf16_max_abs_diff"] > tol_bf16:
            raise AssertionError(f"{paths[0]}: served scores disagree with "
                                 f"the plain impl")
        return runs

    # 3. index, fp16 streams
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        index, fp16_line = build(tmp, "index", codec="fp16")
        # 4. serve: kernels against the plain impl, bf16 and float32,
        #    through the fused join and the legacy concat join
        fused_runs = serve_both(
            index, requests, ("serve", "plain_bf16", "serve_f32",
                              "plain_f32"),
            ("cuda_bf16", "plain_bf16", "cuda_f32", "plain_f32"))
        legacy_runs = serve_both(
            index, requests, ("serve_legacy", "plain_legacy_bf16",
                              "serve_legacy_f32", "plain_legacy_f32"),
            ("cuda_legacy_bf16", "plain_legacy_bf16", "cuda_legacy_f32",
             "plain_legacy_f32"), fused=False)
        legacy = {"phase": "legacy_vs_fused", "device": name,
                  "f32_max_abs_diff": max_diff(
                      legacy_runs["serve_legacy_f32"][0],
                      fused_runs["serve_f32"][0]),
                  "tol": LEGACY_TOL,
                  "qps_legacy_bf16": lines["serve_legacy"]["qps"],
                  "qps_fused_bf16": lines["serve"]["qps"]}
        emit(legacy)
        if legacy["f32_max_abs_diff"] > LEGACY_TOL:
            raise AssertionError("the legacy concat join disagrees with "
                                 "the fused join")
        # the prefetch thread against staging and scoring in turn, then
        # the prefetched run once more, in this order in one call
        sync_runs, launches["serve_sync"], lines["serve_sync"] = serve(
            torch, params, cfg, index, requests, "cuda_bf16_sync", name,
            prefetch_depth=0)
        again, _, again_line = serve(torch, params, cfg, index, requests,
                                     "cuda_bf16_prefetch", name)
        sync = {"phase": "serve_sync", "device": name,
                "max_abs_diff": max_diff(sync_runs[0],
                                         fused_runs["serve"][0]),
                "max_abs_diff_second_prefetched": max_diff(
                    sync_runs[0], again[0]),
                "qps_prefetch": [lines["serve"]["qps"], again_line["qps"]],
                "qps_sync": lines["serve_sync"]["qps"],
                "load_s_prefetch": [lines["serve"]["load_s"],
                                    again_line["load_s"]],
                "load_s_sync": lines["serve_sync"]["load_s"]}
        emit(sync)
        if sync["max_abs_diff"] or sync["max_abs_diff_second_prefetched"]:
            raise AssertionError("prefetched scores differ from the "
                                 "synchronous drain's")
        serve_faults(torch, params, cfg, index, requests, name,
                     fused_runs["serve"][0])
        profile_serve(torch, params, cfg, index, requests, name)
        del index

    # 4b. int8 reps with int8 layer-l K/V: the index, then the service
    #     with stored K/V and no cache, then through the paged doc cache
    #     over a hot-document stream, cold then warm
    zipf = make_zipf_requests(rng, cfg)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        index, _ = build(tmp, "index_int8", codec="int8",
                         store_layer_kv=True, kv_codec="int8")
        serve_both(index, requests,
                   ("serve_int8_kv", "plain_int8_kv_bf16",
                    "serve_int8_kv_f32", "plain_int8_kv_f32"),
                   ("cuda_int8_kv_bf16", "plain_int8_kv_bf16",
                    "cuda_int8_kv_f32", "plain_int8_kv_f32"),
                   use_layer_kv=True)
        uncached, launches["serve_int8_kv_zipf_f32"], _ = serve(
            torch, params, cfg32, index, zipf, "cuda_int8_kv_zipf_f32", name,
            use_layer_kv=True)
        paths = ("serve_cached", "plain_cached_bf16", "serve_cached_f32",
                 "plain_cached_f32")
        runs = serve_both(index, zipf, paths,
                          ("cuda_cached_bf16", "plain_cached_bf16",
                           "cuda_cached_f32", "plain_cached_f32"),
                          passes=2, use_layer_kv=True, doc_cache_mb=CACHE_MB,
                          page_tokens=PAGE_TOKENS)
        del index
    cold_warm = {p: max_diff(runs[p][0], runs[p][1]) for p in paths}
    cached = {"phase": "serve_cached_checks", "device": name,
              "warm_vs_cold_max_abs_diff": cold_warm,
              "f32_vs_uncached_max_abs_diff":
                  max_diff(runs["serve_cached_f32"][0], uncached[0]),
              "tol": CACHED_TOL}
    emit(cached)
    if any(cold_warm.values()):
        raise AssertionError("warm scores are not bit-equal to cold ones")
    if cached["f32_vs_uncached_max_abs_diff"] > CACHED_TOL:
        raise AssertionError("cached scores disagree with the uncached "
                             "service")

    # 4c. PQ reps (64 uint8 codes a token): the index (its k-means fit
    #     on the host), the service, then the paged doc cache over the
    #     hot-document stream; then fp16 reps pruned to half their tokens
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        index, pq_line = build(tmp, "index_pq", codec="pq")
        serve_both(index, requests, ("serve_pq", "plain_pq_bf16",
                                     "serve_pq_f32", "plain_pq_f32"),
                   ("cuda_pq_bf16", "plain_pq_bf16", "cuda_pq_f32",
                    "plain_pq_f32"))
        emit({"phase": "pq_h2d", "device": name,
              "h2d_bytes": {p: lines[p]["h2d_bytes"] for p in
                            ("serve", "serve_int8_kv", "serve_pq")},
              "bytes_per_token": {"fp16": fp16_line["bytes_per_token"],
                                  "pq": pq_line["bytes_per_token"]},
              "fit_s": pq_line["fit_s"]})
        uncached, launches["serve_pq_zipf_f32"], _ = serve(
            torch, params, cfg32, index, zipf, "cuda_pq_zipf_f32", name)
        pages = -(-cfg.max_doc_len // PAGE_TOKENS)
        pq_cache_mb = PQ_CACHED_DOCS * pages * PAGE_TOKENS \
            * (index.bytes_per_token() + 1) / 2**20
        paths = ("serve_pq_cached", "plain_pq_cached_bf16",
                 "serve_pq_cached_f32", "plain_pq_cached_f32")
        runs = serve_both(index, zipf, paths,
                          ("cuda_pq_cached_bf16", "plain_pq_cached_bf16",
                           "cuda_pq_cached_f32", "plain_pq_cached_f32"),
                          passes=2, doc_cache_mb=pq_cache_mb,
                          page_tokens=PAGE_TOKENS)
        del index
    cold_warm = {p: max_diff(runs[p][0], runs[p][1]) for p in paths}
    cached = {"phase": "serve_pq_cached_checks", "device": name,
              "cache_mb": pq_cache_mb,
              "warm_vs_cold_max_abs_diff": cold_warm,
              "f32_vs_uncached_max_abs_diff":
                  max_diff(runs["serve_pq_cached_f32"][0], uncached[0]),
              "tol": CACHED_TOL}
    emit(cached)
    if any(cold_warm.values()) or \
            cached["f32_vs_uncached_max_abs_diff"] > CACHED_TOL:
        raise AssertionError(f"serve_pq_cached: {cached}")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        index, pruned_line = build(tmp, "index_pruned", codec="fp16",
                                   keep_frac=KEEP_FRAC)
        serve_both(index, requests, ("serve_pruned", "plain_pruned_bf16",
                                     "serve_pruned_f32", "plain_pruned_f32"),
                   ("cuda_pruned_bf16", "plain_pruned_bf16",
                    "cuda_pruned_f32", "plain_pruned_f32"))
        pruned = {"phase": "pruned_tokens", "device": name,
                  "keep_frac": KEEP_FRAC,
                  "n_tokens": pruned_line["n_tokens"],
                  "n_tokens_unpruned": fp16_line["n_tokens"],
                  "orig_tokens": int(index.orig_doc_lengths.sum()),
                  "max_doc_len": index.max_doc_len,
                  "max_doc_len_unpruned": cfg.max_doc_len,
                  "storage_bytes": pruned_line["storage_bytes"],
                  "storage_bytes_unpruned": fp16_line["storage_bytes"]}
        emit(pruned)
        want = int(np.maximum(1, np.ceil(
            KEEP_FRAC * index.orig_doc_lengths)).sum())
        if pruned["orig_tokens"] != fp16_line["n_tokens"] \
                or pruned["n_tokens"] != want \
                or index.max_doc_len != math.ceil(KEEP_FRAC
                                                  * cfg.max_doc_len):
            raise AssertionError(f"index_pruned: {pruned}")
        del index

    # 4d. the quality cascade: first stage over the index's own reps, then
    #     the re-rank, for the fp16, int8, pq and pruned indexes
    cascade_phases(torch, name, params, cfg, cfg32, plain, launches, build)

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

    # 6. gemma3-4b prefill and decode
    lm_phases(torch, name, launches)

    # 7. the recsys models, once the LM's state is freed
    recsys_phases(torch, name, launches, rows)

    # 8. kernels line: `launches` counts the main paths (the index builds,
    #    the bf16 drains, the LM's bf16 prefill and decode and the recsys
    #    paths of MAIN_PATHS); `launches_by_path` each counted path alone
    for row in rows:
        k = row["name"]
        row["launches"] = sum(launches[p][k] for p in MAIN_PATHS)
        row["launches_by_path"] = {p: n[k] for p, n in launches.items()}
        if k + "_merge" in MERGE_COUNTERS:
            row["merge_launches"] = sum(launches[p][k + "_merge"]
                                        for p in MAIN_PATHS)
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
