#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main paths at full width with seeded random weights:
PreTTR at the paper's (``repro_torch.configs.prettr_bert.full_config``:
12 layers, d=768, split at l=6, e=256, bf16 compute), the transformer LMs
(gemma3-4b, granite-moe-3b-a800m, chatglm3-6b, qwen3-moe-235b-a22b,
mistral-large-123b), then the recsys models at their published configs
and DimeNet at three of its cells:

1. device  -- the card's name and power limit, the kernel build time and
   each source's ``nvcc`` seconds (``nvcc_s``, all started together);
2. kernels -- each hand-written kernel form at its main-path shape against
   its plain PyTorch version on the same inputs, with times (CUDA events,
   median of 20 after warm-up) beside the plain version, one library call
   that computes the same function, and the least time the card could
   take (``device_ms``: the kernel's call queued behind a spin kernel, so
   that the wrapper's host work is not counted): split attention (PreTTR's validity + seg_boundary form, gemma3's
   causal and causal + window forms at [4, 8, 2048, 256], the causal form
   at granite-moe's [4, 24 / 8, 2048, 64] and chatglm3's [4, 32 / 2,
   2048, 128], raw int8 K/V),
   join attention (dense float, raw int8 K/V, paged over int8 and fp16
   pools, the CLS row), flash decode (the CLS-only layer's shape,
   gemma3's decode shape with and without its window, and the later
   LMs' GQA groups of 3, 16 and 12 query heads a KV head: granite-moe's,
   chatglm3's and qwen3-moe's, mistral-large's, in row groups of up to
   8), compress and
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
4f. sharded -- ``RankingRouter`` over the same 512-doc indexes, its
   workers sharing the card: ``serve_sharded`` at 1, 2 and 4 workers
   (fp16) and 2 and 4 (int8 + K/V, PQ) over the 8 requests, every score
   bit-equal to the single-process bf16 run of the same index and
   requests, with requests/s beside two single-process runs made just
   before and after (``serve_sharded_scaling``), the merged and
   per-worker stats and the
   router's overhead (``admit_s``, ``query_encode_s``, ``merge_s``);
   ``serve_sharded_cached``: 2 workers with a paged doc cache of CACHE_MB
   each over the zipf stream twice, each pass bit-equal to the cached
   service's (warm = cold), the paged join launched;
   ``serve_sharded_faults``: a transient ``engine.score`` fault on shard
   1 retried, a persistent ``worker.drain`` fault on shard 0 failed over,
   a stall past ``SHARD_TIMEOUT_S`` marking shard 1 dead with the
   fallback serving its rows within the timeout plus one fault-free
   2-worker drain, all bit-equal;
4g. mesh -- (a) the fp16 index built again data-parallel
   (``IndexBuilder(mesh=)`` over a ``("data",)`` mesh of every visible
   card): ``mesh_build`` gives its docs/s beside the
   one-device build's, whether its stream files equal the one-device
   index's byte for byte, and its float32 service's distance from the
   one-device index's (0.0 where the bytes are equal, else within 1e-3);
   (b) ``RankingRouter(mesh=)`` over a ``("shard",)`` mesh of every
   visible card (its workers where ``devices=serving_shard_devices(mesh)``
   puts them) over the fp16 and int8 + K/V indexes and the zipf stream
   through the doc cache, each pass bit-equal to the single-process
   service, as 4f holds the router on ``devices=`` (``mesh_router``);
4d. cascade -- ``run_cascade`` over a seeded ``SyntheticIRWorld`` at the
   config's vocabulary (2048 docs of 479 tokens, 64 queries, 64
   candidates, metrics at depth 10) for fp16, int8, PQ and pruned
   indexes: each index's first-stage and re-rank metrics and storage
   bytes; over the PQ index also through the kernels in float32 and the
   plain backend in bf16 and float32 (``cascade_agreement``: float32
   within 1e-3, bf16 within twice the plain backend's own bf16
   rounding);
4e. training -- at the same width on the cascade world: ``train``,
   TRAIN_STEPS of ``launch.train.prettr_train_step`` (16 pairs x 512
   tokens a step, constant TRAIN_LR; the steps run the plain backend and
   must launch no kernel, and every kernel wrapper must refuse an input
   that requires grad): the loss of the first and last 16 steps (the
   last 16 must average below the first 16, every loss finite), the
   gradient norm, ms a step (CUDA events, median after TRAIN_WARMUP),
   tokens/s, ``mfu`` (6 x non-embedding params x tokens/s over the bf16
   peak) and the peak allocated memory, then a profile of one more step
   (``profile`` line ``train_step``); ``train_validate``, the trained
   weights' P@20 validation (``rank_forward`` over 8 queries x 32
   candidates) through the kernels, within twice the plain backend's own
   bf16 rounding; ``checkpoint``, the state after CKPT_STEP through
   ``AsyncCheckpointer``, restored bit for bit, a newer torn step skipped,
   and RESUME_STEPS steps from the restored state bit-equal to as many
   from the state in memory (both under
   ``torch.use_deterministic_algorithms``); ``distill``,
   ``launch.build_index.distill_compressor`` (Eq. 2, 60 steps of 8
   car_pairs; the held-out attention MSE must fall), then the fp16 index
   with the distilled compressor; ``cascade_trained``, ``run_cascade``
   with the trained, distilled weights over the fp16, int8, PQ and pruned
   indexes beside the untrained run's metrics; ``train_smoke``, the
   drivers in their own processes at their smoke configs
   (``launch.train`` for prettr-bert and gemma3-4b,
   ``launch.eval_quality --steps 40``, whose trained re-rank must beat
   its pools in a random order on P@20 or hit@10, and
   ``launch.build_index --distill-steps 4``);
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
   prefill and 4 decode steps; then the same phases, their paths
   suffixed ``_<key>``, for each model of ``LM_MORE``: granite-moe-3b-a800m
   (``_granite``, 32 layers, uncut: the slice's main path) and chatglm3-6b
   (``_chatglm3``, 28, uncut), qwen3-moe-235b-a22b (``_qwen3``) and
   mistral-large-123b (``_mistral``) at full width with 2 of their 94 and
   88 layers (``lm_model`` gives ``reduced``); prefill runs split
   attention's causal form, decode flash decode and its merge.  An MoE
   model's agreement line reports its routing: the share of prompt
   tokens whose top-k experts differ between two runs, layer by layer,
   and the compared rows routed apart; its bf16 and float32 limits
   compare runs whose experts are pinned to one routing (``routed``), and
   its soundness runs at capacity factor E / k, where no slot can drop
   (at 1.25 the 2049-token forward drops other slots than the 2048-token
   prefill did, in the JAX package as well), pinned to the prefill's
   routing, while the forward's own routing may tip no more than
   ``LM_ROUTED_APART`` of its tokens a layer;
   an ``lm_wall`` line gives each model's seconds;
6b. blocked_grad -- the "cuda" attention op (``models/backend.py``: the
   split kernel forward, the blocked version's gradient backward at
   ``block_kv``) at gemma3-4b's global layer, full width (q [2, S, 8,
   256], K/V 4 heads, bf16, causal): at S = 2048 its dq / dk / dv
   against the plain gradient in float32, each within CELLS_BF16_FACTOR
   x the plain bf16 gradient's distance from it, and the float32 op's
   within LM_SPMD_GRAD_LEAF_REL of each gradient's largest value; at S
   = 8192 the peak bytes and ms of one bf16 backward, blocked against
   the plain gradient the op took before (each twice, in turns), the
   blocked peak below the plain one; the forward's launches of the
   causal form (``row3_launches``);
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
   beside the HBM ``bound_ms``;
8. bert4rec -- ``configs.bert4rec.full_config`` (2^20 items, 200 slots,
   2 heads of 32, split after layer 1 of 2, bf16) at serve_p99: PreTTR's
   split (``precompute_history``, ``serve_scores_from_reps``) through the
   kernels and the plain impl, bf16 and float32 (bf16 within twice the
   plain impl's own bf16 rounding, float32 within 1e-3), top-100 of the
   [512, 2^20] scores, ``serve_topk`` timed on the plain impl, and
   ``forward_hidden`` refused on the kernel impl before any launch; then
   a line with the sharded and BERT4Rec phases' wall times.  Phase 2
   also holds split attention at head dim 32 (BERT4Rec's shapes, the
   CUDA-core kernel) against its plain version (``split_attention_d32``);
9. dimenet -- ``configs.dimenet.full_config`` (6 blocks, d 128, float32
   compute) at three of GNN_SHAPES' cells at their published sizes:
   ``full_graph_sm`` (Cora's 2708 nodes, 10556 edges, 1433 features),
   ``molecule`` (128 molecules of 30 atoms and 64 edges, the energy task)
   and ``minibatch_lg`` (Reddit's 232,965-node, 114,615,892-edge graph
   built on the host, one ``NeighborSampler`` batch of 1024 seeds at
   fanout (15, 10), 8 triplets an edge at most, the loss over the seeds).
   Each ``dimenet_<cell>`` line gives the host build, the sizes, the
   forward's ms, DIMENET_STEPS of ``launch.steps.gnn_train_step`` (ms a
   step, losses that must fall, ``mfu`` over the float32 peak, peak
   memory), the card against the port on the CPU on the same inputs and
   weights (forward, loss, every gradient leaf, within ``DIMENET_*_REL``;
   the gradients also against the card's float64 run, which tells the
   card's rounding from the CPU's) and the card's run-to-run distance
   (its index_add atomics), then a
   ``profile`` of one step; ``dimenet_bf16``: Cora's forward in bf16 on
   the card within twice the CPU port's own bf16 rounding;
   ``dimenet_wall``.  DimeNet reaches no ``pl.pallas_call`` in the JAX
   package (gathers, segment sums, small dense products), so its paths
   launch no kernel of the port: ``PATH_KERNELS`` gives them none, and a
   launch fails the run.

9b. spmd -- one rank a visible card over NCCL
   (``launch.mesh.run_spmd``, a ``("data", "model")`` mesh; one card is
   a world of 1, where every collective is the identity; every line
   gives ``world``): ``spmd_lookup``, the row-sharded lookup of a bf16
   table of MESH_LOOKUP_ROWS x 128 (DLRM's width) over serve_bulk's
   262,144 x 26 ids, uniform at capacity factor 4 and Zipf at 1, equal to
   ``take * keep`` bit for bit, its owner-local gather on the
   embedding-bag kernel; ``spmd_moe``, the MoE FFN at granite-moe's and
   qwen3-moe's layer widths over 4 x 2048 tokens in float32 under rules
   against ``n_groups=G`` in one process (MESH_MOE_REL of the largest
   output, the aux loss within 1e-5); ``spmd_psum``,
   ``compressed_psum`` over PreTTR-BERT's full gradient tree, its mean
   within its int8 bound of the float32 all-reduce mean
   (``err_over_bound`` at most 1: each rank's rounding and the ranks'
   mean scale, ``mesh_check.psum_error``); ``spmd_lm_gemma3`` and
   ``spmd_lm_granite``, the sharded transformer (FSDP over ``data``,
   tensor parallelism over ``model``: ``models/transformer_spmd.py``)
   at full width under ``default_rules`` over 2 x 2048 tokens against
   one process on the same card: gemma3-4b's ``causal_lm_loss`` in
   float32 through the kernels (the split kernel's causal and window
   forms on each rank's local heads; rtol LM_SPMD_RTOL), its loss and
   every gradient leaf through the plain impl (each leaf's largest error
   within LM_SPMD_GRAD_LEAF_REL of its largest value, and rtol = atol =
   LM_SPMD_RTOL element by element; beside it the same gradient with
   TF32 products as the control) and the bf16 loss, timed (rtol
   LM_SPMD_BF16_RTOL; beside it one process's bf16 loss against its
   float32 loss as the control); granite-moe's float32 loss through the kernels
   (MoE at capacity factor E / k); each line gives its tolerance and
   the split kernel's launches, and the phase fails unless they launched;
   each with its ms a call (``repro_torch.tools.mesh_check``);
   ``spmd_gnn``, DimeNet's edge-sharded route
   (``models/gnn/dimenet_spmd.py``: each rank a contiguous block of the
   edges and triplets, the messages all-gathered, the node sums
   all-reduced) at ``ogb_products`` cut by GNN_SPMD's graph_cut (the
   full config, bf16 messages as the cell picks them; ``reduced`` gives
   the cut), built by ``build_cell`` and taken by ``cell.local``: the
   float32 loss and every gradient leaf against one process on the same
   card within DIMENET_LOSS_REL / DIMENET_GRAD_REL (one process against
   itself run again as the control), GNN_SPMD's steps of the cell's
   bf16 train step (the loss must fall, the first within
   CELLS_BF16_FACTOR x one process's bf16-vs-float32 distance of its
   float32 loss), ms a step, peak bytes, the host build's seconds; no
   kernel may launch.
9c. cells -- the cells of ``launch.steps`` (``tools/cell_check.py``),
   one rank a visible card over NCCL as in 9b, each built with
   ``build_cell(..., backend="cuda")`` at full width under
   ``default_rules`` and run on the rank's part of seeded inputs
   (``cell.inputs``, ``cell.local``), against the same cell through the
   plain impls in one process on the same card (CELLS): PreTTR-BERT's
   ``index_docs`` (512 docs) and ``serve_join`` (512 pairs) under
   ``replicated_serving_rules``, ``rank_train`` (32 pairs, one AdamW
   step); gemma3-4b's ``prefill_32k`` at 2 x 2048 tokens (the logits and
   the collected cache) and ``decode_32k`` at batch 2 against its seeded
   32,768-key cache (four teacher-forced steps); granite-moe's
   ``train_4k`` at 4 of its 32 layers, two micro-batches of 2 x 2048
   tokens, one step; the recsys cells: DLRM's ``train_batch`` (65,536
   rows) and ``retrieval_cand`` (1,000,192 candidates) at 2^20 table rows
   a field, DeepFM's ``serve_bulk`` (262,144 rows, its 39 M-row table),
   xDeepFM's ``train_batch`` at 8,192 rows, BERT4Rec's ``serve_p99``
   (the top-100 of its 2^20 items) and ``train_batch`` at 1,024 rows.
   The train cells run at float32 compute (the
   kernels forward; backward the blocked attention's gradient and the
   other ops' plain versions'), their
   configured bf16 step held by no check; a recsys cell's control takes
   the plain embedding bag (``bag_impl="plain"``), and BERT4Rec's top-k
   ids must equal the plain run's wherever the values are not tied
   (``ids_mismatch``).  Each ``cells_<key>`` line
   gives ``reduced`` (each cut beside its published size, the train
   cells' compute dtype among them), the limits (a bf16 output's
   distance from the plain impls at float32 compute, ``kernel_vs_f32``,
   within CELLS_BF16_FACTOR of the plain bf16 run's own,
   ``plain_bf16_vs_f32``; a train cell's loss and grad_norm within
   LM_SPMD_RTOL, its clipped gradient, read from AdamW's first moment
   after the step, and its updated parameters within rtol = atol =
   LM_SPMD_RTOL element by element, and each gradient leaf within
   LM_SPMD_GRAD_LEAF_REL of its largest value, rank_train's within
   CELLS_FP16_LEAF_REL; the last two over what lies above rounding,
   ``held``), every rank's differences, times and
   peak memory, and the launches; ``cells_wall`` the phase's seconds.
   Off one card (``overrides`` on each rank's result) granite-moe runs
   at capacity factor E / k, so that one process's limits hold.

Kernel launches are counted per path: every counter is set to 0 just
before each index build, each timed serving run, the training steps, the
validation and distillation runs, the soundness check, each LM run,
each recsys run, each DimeNet cell and each cell's run, and read just
after.  A path that
misses a kernel it must run (``PATH_KERNELS``: the tensor-core split and
join kernels on the bf16 paths, the CUDA-core ones on the float32
paths; the tensor-core compress and decompress kernels on every path
that runs them; the split-KV merge where the path's Sq = 1 calls split
their keys: gemma3's decode and the 4-pair soundness check; the wide
embedding-bag kernel on DLRM's paths, the narrow one on DeepFM's and
xDeepFM's; the CUDA-core split kernel and the head-dim-32 count on
BERT4Rec's), a path that launches one it must not (the generic
embedding-bag kernel on a recsys path among them), or a plain run that
launches any, fails the script.
The ``kernels`` line's ``launches`` sums the main paths (``MAIN_PATHS``:
the index builds, the bf16 kernel runs of each serving form, the
cascades, the training paths, the LMs' bf16 prefill and decode, the
recsys serve_bulk forwards, retrieval runs and towers, the router's bf16
drains, BERT4Rec's bf16 history and join, the DimeNet cells, the
data-parallel build, the router's bf16 drains on a mesh, the SPMD
checks and the cells), each launch under one
row: the later LMs' under the rows that hold their shapes;
``launches_by_path`` gives each path's own.

Every phase that fails raises and the script exits non-zero.  It prints
one JSON object per line; each but the last two carries ``card``, the
card's name and power limit as ``nvidia-smi`` gives them; the second to
last is the ``kernels`` line, the last ``{"ok": true, "device": ...}``.  Run from the repository root::

    python3 chip_smoke.py
"""
import contextlib
import functools
import io
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
# sharded serving: RankingRouter at these worker counts over each index,
# the workers sharing the one card; the fault phase's drain timeout and
# the stall injected past it
SHARD_COUNTS = {"fp16": (1, 2, 4), "int8_kv": (2, 4), "pq": (2, 4)}
SHARD_TIMEOUT_S, SHARD_STALL_S = 2.0, 4.0
# the mesh phase's SPMD checks (one rank a card over NCCL): the
# row-sharded lookup's bf16 table rows (4.3 GB), the MoE FFN's tokens (4 x
# 2048), its float32 limit over the largest output (the expert products'
# batch count changes with the groups a rank runs, and with it cuBLAS's
# blocking), the ranks' time limit
MESH_LOOKUP_ROWS, MESH_TOKENS, MESH_MOE_REL = 1 << 24, 4 * 2048, 1e-4
MESH_TIMEOUT_S = 600
# the sharded transformer's checks: [batch, seq] tokens, its float32 and
# bf16 limits against one process (losses relative; gradient elements
# rtol = atol = LM_SPMD_RTOL, and each leaf's largest error over its
# largest value, which sound gradients keep near 2e-5 and TF32 products
# take to 4.5e-3; the bf16 loss at three times its largest sound reading,
# 3.2e-5 on four cards: PERF.md)
LM_SPMD_TOKENS, LM_SPMD_RTOL, LM_SPMD_BF16_RTOL = (2, 2048), 1e-5, 1e-4
LM_SPMD_GRAD_LEAF_REL = 1e-4
# DimeNet's edge-sharded check (tools.mesh_check.gnn_check's keywords):
# the cell and its graph_cut (51,021 nodes, 1,288,732 edges padded to
# 1,288,960: bf16 messages, as the published cell's), the cell's train
# steps
GNN_SPMD = {"shape": "ogb_products", "graph_cut": 48, "steps": 6}
# the cells phase (launch.steps' cells, one rank a card): (key, arch,
# shape, cuts); full width, the batch and depth cut so that the phase
# adds about two minutes.  Each is held against the same cell through the
# plain impls in one process.  A bf16 output (all but the train cells'),
# as a largest error over the largest value from the plain impls at
# float32 compute on the same inputs (tools/cell_check.py's control):
# the kernels' within CELLS_BF16_FACTOR of the plain bf16 run's own, as
# both round the same operands to bf16 and sum in float32.  A train cell
# (float32) at the sharded LM's limits: loss and grad_norm within
# LM_SPMD_RTOL, its clipped gradient (from AdamW's first moment after the
# step) and its updated parameters element by element within rtol = atol
# = LM_SPMD_RTOL, each gradient leaf within LM_SPMD_GRAD_LEAF_REL of its
# largest value; leaves and elements below rounding (cell_check.
# ROUNDING_FLOOR: PreTTR's key-bias gradients, zero in exact arithmetic)
# are left out of the last two.  rank_train's leaves within one fp16 step
# (CELLS_FP16_LEAF_REL) instead: its reps pass layer l through the
# compressor's fp16 store, where a value on a rounding boundary moves by
# a step either way (H100 80GB HBM3, 700.00 W: the compressor's bias
# 1.9e-4, every leaf 1.2e-5 at most with a float32 store; PERF.md)
CELLS_BF16_FACTOR = 1.5
CELLS_FP16_LEAF_REL = 2 ** -10
CELLS = (("index_docs", "prettr-bert", "index_docs", {"batch": 512}),
         ("serve_join", "prettr-bert", "serve_join", {"batch": 512}),
         ("rank_train", "prettr-bert", "rank_train", {"batch": 32}),
         ("prefill", "gemma3-4b", "prefill_32k", {"batch": 2, "seq": 2048}),
         ("decode", "gemma3-4b", "decode_32k", {"batch": 2}),
         ("train_granite", "granite-moe-3b-a800m", "train_4k",
          {"batch": 4, "seq": 2048, "n_layers": 4}),
         # the recsys cells: DLRM's table at 2^20 rows a field (7,401,902
         # rows, 3.8 GB in float32; the published 96.1 GB would need 385 GB
         # with its gradient and two moments), xDeepFM's batch at 8,192
         # (CIN's [B, 200, 39, 10] float32 is 20 GB a layer at 65,536),
         # BERT4Rec's training batch at 1,024 (plain attention's scores at
         # 65,536 x 2 x 200^2); DeepFM's 39 M x 10 table and BERT4Rec's
         # 2^20-item head as published
         ("dlrm_train", "dlrm-mlperf", "train_batch",
          {"rows_per_field": 2 ** 20}),
         ("dlrm_retrieval", "dlrm-mlperf", "retrieval_cand",
          {"rows_per_field": 2 ** 20}),
         ("deepfm_serve_bulk", "deepfm", "serve_bulk", {}),
         ("xdeepfm_train", "xdeepfm", "train_batch", {"batch": 8192}),
         ("bert4rec_serve_p99", "bert4rec", "serve_p99", {}),
         ("bert4rec_train", "bert4rec", "train_batch", {"batch": 1024}))
# the blocked gradient (phase 6b): gemma3-4b's global layer at full width
# (q [2, S, 8, 256], K/V 4 heads, causal, its block_kv of 512) through
# the "cuda" attention op, the split kernel forward and the blocked
# version's gradient backward.  At BLOCKED_GRAD_SEQ its bf16 dq / dk / dv
# against the plain gradient in float32, each within CELLS_BF16_FACTOR x
# the plain bf16 gradient's own distance (the float32 op's within
# LM_SPMD_GRAD_LEAF_REL of each gradient's largest value); at
# BLOCKED_MEMORY_SEQ the peak bytes of one bf16 backward, which must sit
# below the plain gradient's ([2, 8, 8192, 8192] float32, 4.3 GB a
# tensor)
BLOCKED_GRAD = {"batch": 2, "heads": 8, "kv_heads": 4, "head_dim": 256}
BLOCKED_GRAD_SEQ, BLOCKED_MEMORY_SEQ = 2048, 8192
# BERT4Rec's paths: (history precompute, online join) of each run
BERT4REC_PATHS = {
    "cuda_bf16": ("bert4rec_history", "bert4rec_join"),
    "plain_bf16": ("plain_bert4rec_history_bf16", "plain_bert4rec_join_bf16"),
    "cuda_f32": ("bert4rec_history_f32", "bert4rec_join_f32"),
    "plain_f32": ("plain_bert4rec_history_f32", "plain_bert4rec_join_f32")}
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
# training at full width (prettr_bert.full_config: bf16 compute, float32
# params and master) on the cascade world: TRAIN_STEPS AdamW steps of 16
# pairs x 512 tokens (16,384 tokens a step) at a constant TRAIN_LR, step
# times the median after TRAIN_WARMUP; the state after CKPT_STEP is
# checkpointed, and RESUME_STEPS steps from it replayed; P@20 over
# VALIDATE_QUERIES queries' 32 candidates, as launch.train validates
TRAIN_STEPS, TRAIN_PAIRS, TRAIN_LR, TRAIN_WARMUP = 200, 16, 1e-4, 10
CKPT_STEP, RESUME_STEPS, VALIDATE_QUERIES = 100, 4, 8
# the compressor's distillation (Eq. 2) at full width: car_pairs of 8
DISTILL_STEPS, DISTILL_BATCH = 60, 8
# each driver run of train_smoke in its own process
SMOKE_TIMEOUT_S = 600
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
# the LMs after gemma3-4b, at full width with bf16 weights from
# init_params: (path key, config module, layers kept of the published
# depth, None keeping all).  qwen3-moe (94 layers, ~470 GB in bf16) and
# mistral-large (88, ~246 GB) cannot live on one card: they keep 2
# layers, every width as published
LM_MORE = (("granite", "granite_moe_3b", None),
           ("chatglm3", "chatglm3_6b", None),
           ("qwen3", "qwen3_moe_235b", 2),
           ("mistral", "mistral_large_123b", 2))
LM_MOE = ("granite", "qwen3")
# an MoE soundness run's forward over 2049 tokens at its own routing
# against the prefill + decode step's: the share of its tokens a layer
# whose experts may differ.  Float32 sums in another order tip only exact
# near-ties: 0 of 8196 a layer over granite-moe's 32 layers, 1 and 2 over
# qwen3-moe's 2 (H100, 700 W), where bf16 rounding alone tips 2-21 % a
# layer.  1e-3 (8 tokens a layer) is 4x the most float32 tipped and far
# below what a path that routes apart would move.  A tipped token moves
# the step's logits by the model's own scale (0.0067 at qwen3-moe's 2
# tokens), so that distance is reported with no limit
LM_ROUTED_APART = 1e-3
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
# counters of a launch's shape, on top of its form's and its kernel's:
# split attention at head dim 32 (BERT4Rec's)
SHAPE_COUNTERS = ("split_attention_d32",)
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
# DimeNet (configs.dimenet.full_config: 6 blocks, d 128) at three of
# GNN_SHAPES' cells at their published sizes, in float32 as
# launch.steps.gnn_cell_config picks below 1 M padded edges: Cora's graph
# (full_graph_sm), 128 molecules (molecule) and one neighbour-sampled
# batch of Reddit's graph (minibatch_lg: 1024 seed nodes at fanout (15,
# 10), its triplets capped at 8 an edge, the loss over the seeds);
# ogb_products (495 M triplet slots) runs cut on the mesh phase's
# spmd_gnn check (GNN_SPMD); its whole graph needs several cards and a
# host build of ~23 minutes (PERF.md).  DIMENET_STEPS
# AdamW steps at OptimizerConfig()'s defaults, times the median after
# DIMENET_WARMUP; the mean of the last DIMENET_LOSS_WINDOW losses must
# fall below the first's
DIMENET_CELLS = ("full_graph_sm", "molecule", "minibatch_lg")
DIMENET_STEPS, DIMENET_WARMUP, DIMENET_LOSS_WINDOW = 30, 5, 5
# the card against the port on the CPU, same inputs and weights, float32:
# index_add and the gathers' backward accumulate in another order on the
# card (atomics), so these are summation-order limits, scaled to the data
# (random weights drive energies to ~5e5 through the envelope's 1/d): the
# forward within 1e-4 of max|cpu|, the loss 1e-5 relative.  Gradients:
# each leaf of the card's within 1e-4 of that leaf's max|.| of the same
# gradient in float64 (on the card), and of the CPU's within 1e-4 plus
# the CPU's own distance from float64: the energy task's sums cancel, and
# an H100 machine's CPU put its float32 gradient 1.2e-4 from float64
# there (the card 4.3e-5)
DIMENET_FWD_REL, DIMENET_LOSS_REL, DIMENET_GRAD_REL = 1e-4, 1e-5, 1e-4
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
                  split_kv=None, counter=None, paths=None, **extra):
    """Time a kernel beside its plain version and library call and return
    its kernels-line row; with ``row`` False (a second form of a kernel
    already in the line) only the kernel_time line is printed.  ``extra``
    goes on that line.  A row's launches are its name's counter summed
    over MAIN_PATHS but LM_MORE_MAIN, or (a shape of a form another row
    counts) the ``counter`` summed over the main ``paths`` that run that
    shape.  An
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
    if counter is not None:
        out.update(counter=counter, paths=list(paths))
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

    # -- split attention at BERT4Rec's head dim 32 (full_config at
    #    serve_p99): the online join [512, 2, 201, 32] (the [MASK] slot,
    #    then the history) and the history precompute [512, 2, 200, 32],
    #    histories of 100-200 items, float32 and bf16; the bf16 history
    #    shape is timed.  Head dim 32 takes the CUDA-core kernel
    from repro_torch.configs.bert4rec import full_config as bert4rec_full
    b4 = bert4rec_full()
    b, h4, d4 = REC_P99, b4.n_heads, b4.backbone().dh
    for dtype, dname in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
        for s in (b4.seq_len + 1, b4.seq_len):
            q, k, v = (rand(b, h4, s, d4, dtype=dtype) for _ in range(3))
            valid = _prefix_mask(torch, gen, b, s, s // 2)
            lengths = last_valid_lengths(valid)
            f32 = (None if dtype == torch.float32 else split_attention_ref(
                q.float(), k.float(), v.float(), lengths, valid).float())
            err = compare("split_attention_d32",
                          split_flash_attention(q, k, v, lengths,
                                                k_valid=valid),
                          split_attention_ref(q, k, v, lengths, valid),
                          dname, [b, h4, s, d4], f32)
    mask = valid[:, None, None, :].expand(b, 1, s, s)
    record("split_attention_d32", "src/repro_torch/csrc/split_attention.cu",
           "src/repro/kernels/split_attention/kernel.py:109", err,
           lambda: split_flash_attention(q, k, v, lengths, k_valid=valid),
           lambda: split_attention_ref(q, k, v, lengths, valid),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
           4 * d4 * h4 * s * valid.sum().item(),
           2 * nbytes(q) + kv_bytes(lengths, h4, d4, q.element_size())
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

    # -- the causal form at the later LMs' prefill shapes, float32 and
    #    bf16: granite-moe's (q [4, 24, 2048, 64], GQA 24/8) for the
    #    head-dim-64 row; qwen3-moe's (64/4), mistral-large's (96/8) and
    #    chatglm3's (32/2) at head dim 128 for the row that counts those
    #    three prefills.  The last shape of each row, in bf16, is timed
    for name, ldh, groups, paths in (
            ("split_attention_causal_d64", 64, ((24, 8),),
             ("lm_prefill_granite", "spmd_lm_granite")),
            ("split_attention_causal_d128", 128,
             ((64, 4), (96, 8), (32, 2)),
             ("lm_prefill_chatglm3", "lm_prefill_qwen3",
              "lm_prefill_mistral"))):
        for lhq, lhkv in groups:
            for dtype, dname in ((torch.float32, "float32"),
                                 (torch.bfloat16, "bfloat16")):
                q = rand(lb, lhq, ls, ldh, dtype=dtype)
                k, v = (rand(lb, lhkv, ls, ldh, dtype=dtype)
                        for _ in range(2))
                f32 = (None if dtype == torch.float32
                       else split_attention_ref(q.float(), k.float(),
                                                v.float(), full,
                                                causal=True).float())
                err = compare(name,
                              split_flash_attention(q, k, v, causal=True),
                              split_attention_ref(q, k, v, full, causal=True),
                              dname, [lb, lhq, lhkv, ls, ldh], f32)
                del f32
        record(name, "src/repro_torch/csrc/split_attention.cu",
               "src/repro/kernels/split_attention/kernel.py:109", err,
               lambda: split_flash_attention(q, k, v, causal=True),
               lambda: split_attention_ref(q, k, v, full, causal=True),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True),
               4 * ldh * lhq * lb * ls * (ls + 1) // 2,
               2 * nbytes(q) + nbytes(k, v), PEAK_BF16_FLOPS,
               "bf16 tensor cores", counter="split_attention_causal",
               paths=paths)
    del q, k, v

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

    # -- flash decode at the later LMs' GQA groups, against the same
    #    2080-key cache at position 2063: R = 3 (granite-moe, q [4, 24, 1,
    #    64], Hkv 8: blocks of 4 rows, 3 used), 16 (chatglm3, [4, 32, 1,
    #    128], Hkv 2: two row groups of 8; qwen3-moe's [4, 64, 1, 128],
    #    Hkv 4, held first) and 12 (mistral-large, [4, 96, 1, 128], Hkv 8:
    #    a row group of 8 and a partial one of 4), float32 and bf16; the
    #    last shape of each row, in bf16, is timed
    keys = pos < lengths[:, None]
    n_keys = int(keys.sum())
    for name, gd, groups, paths in (
            ("decode_attention_r3", 64, ((24, 8),), ("lm_decode_granite",)),
            ("decode_attention_r16", 128, ((64, 4), (32, 2)),
             ("lm_decode_chatglm3", "lm_decode_qwen3")),
            ("decode_attention_r12", 128, ((96, 8),),
             ("lm_decode_mistral",))):
        for ghq, ghkv in groups:
            q = rand(gb, ghq, 1, gd)
            k, v = (rand(gb, ghkv, gs, gd) for _ in range(2))
            shape = [gb, ghq, ghkv, 1, gd, gs]
            f32 = [t.float() for t in (q, k, v)]
            compare(name, flash_decode_attention(*f32, lengths),
                    decode_attention_ref(*f32, lengths), "float32", shape)
            err = compare(name, flash_decode_attention(q, k, v, lengths),
                          decode_attention_ref(q, k, v, lengths), "bfloat16",
                          shape, _decode_f32(q, k, v, lengths))
        record(name, "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:75", err,
               lambda: flash_decode_attention(q, k, v, lengths),
               lambda: decode_attention_ref(q, k, v, lengths),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=keys[:, None, None, :],
                   enable_gqa=True),
               4 * gd * ghq * n_keys,
               2 * nbytes(q) + 2 * n_keys * ghkv * gd * q.element_size()
               + nbytes(lengths), PEAK_BF16_FLOPS, "bf16 tensor cores",
               split_kv=(flash_decode_attention, "last_n_splits"),
               counter="decode_attention", paths=paths)
    del q, k, v, f32

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
            "split_attention_d32": (split_flash_attention, "d32_launches"),
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
_LM_CAUSAL = ("split_attention_causal",)
_LM_GLOBAL_DECODE = ("decode_attention", "decode_attention_merge")
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
    # training: the steps run the plain backend and launch nothing; the
    # validation of the trained weights (rank_forward) runs the split
    # kernel, the compressor round trip and the CLS-only layer's flash
    # decode (one split at 32 rows); the distillation's frozen trunk runs
    # the split kernel; the trained cascade builds and serves as above
    "train": (),
    "train_validate": ("split_attention", "compress", "decompress",
                       "decode_attention", *_SPLIT_TC, *_COMPRESS_TC,
                       *_DECOMPRESS_TC),
    "plain_train_validate_bf16": (), "plain_train_validate_f32": (),
    "distill": ("split_attention", *_SPLIT_TC),
    "index_distilled": _INDEX_F16,
    "cascade_trained_index_int8": _INDEX_F32,
    "cascade_trained_index_pq": _INDEX_F32,
    "cascade_trained_index_pruned": _INDEX_PRUNED,
    "cascade_trained": _CASCADE + _JOIN_TC,
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
    # the router's workers serve each index as the single-process service
    # does; the cached run walks the paged join
    **{f"serve_sharded_fp16_{n}": _FP16_SERVE + _JOIN_TC
       for n in SHARD_COUNTS["fp16"]},
    **{f"serve_sharded_int8_kv_{n}": _INT8_SERVE + _JOIN_TC
       for n in SHARD_COUNTS["int8_kv"]},
    **{f"serve_sharded_pq_{n}": _PQ_SERVE + _JOIN_TC
       for n in SHARD_COUNTS["pq"]},
    "serve_sharded_cached": _CACHED_SERVE + _JOIN_TC
    + ("join_attention_paged_tensor_core",),
    # the mesh: the data-parallel build encodes as the one-device one does,
    # its float32 service serves as the uncached one; the router on a
    # mesh as the router does
    "index_dp": _INDEX_F16, "serve_index_dp_f32": _FP16_SERVE + _JOIN_CC,
    "serve_mesh_fp16": _FP16_SERVE + _JOIN_TC,
    "serve_mesh_int8_kv": _INT8_SERVE + _JOIN_TC,
    "serve_mesh_cached": _CACHED_SERVE + _JOIN_TC
    + ("join_attention_paged_tensor_core",),
    # the SPMD checks: the owner-local gather is a bag of one a row, on
    # the wide kernel (256-byte bf16 rows); the MoE FFN and the gradient
    # all-reduce run no kernel of the port
    "spmd_lookup": ("embedding_bag", "embedding_bag_wide"),
    "spmd_moe": (), "spmd_psum": (),
    # DimeNet's edge-sharded train cell: gathers, index_add and dense
    # products, no kernel of the port
    "spmd_gnn": (),
    # the sharded transformer: float32 on the CUDA-core split kernel,
    # gemma3's bf16 loss on the tensor-core one
    "spmd_lm_gemma3": ("split_attention_causal", "split_attention_window",
                       "split_attention_cuda_core",
                       "split_attention_tensor_core"),
    "spmd_lm_granite": ("split_attention_causal",
                        "split_attention_cuda_core"),
    # the cells: index_docs encodes the docs (split attention with the
    # segment mask, compress), serve_join decodes the stored reps
    # (decompress) and joins them (the dense join and its CLS row),
    # prefill runs gemma3's causal and window split forms, decode flash
    # decode's two forms and their merges over the 32,768-key cache; the
    # train cells (float32) launch the kernels forward: rank_train the
    # split form on the CUDA cores, compress and decompress on the tensor
    # cores and the CLS row's decode (one split on one card; a (2, 2)
    # mesh's 8 pairs a rank split it and merge), granite-moe the causal
    # form
    "cells_index_docs": _INDEX_F16,
    "cells_serve_join": ("join_attention", "join_attention_row",
                         "decompress", *_DECOMPRESS_TC,
                         "join_attention_tensor_core"),
    "cells_rank_train": ("split_attention", *_SPLIT_CC, "compress",
                         *_COMPRESS_TC, "decompress", *_DECOMPRESS_TC,
                         "decode_attention"),
    "cells_train_granite": _LM_CAUSAL + _SPLIT_CC,
    # the blocked gradient's op: the causal form forward, bf16 on the
    # tensor cores, float32 on the CUDA cores; the backward launches none
    "blocked_grad": _LM_CAUSAL + _SPLIT_TC,
    "blocked_grad_f32": _LM_CAUSAL + _SPLIT_CC,
    "cells_prefill": _LM_PREFILL + _SPLIT_TC, "cells_decode": _LM_DECODE,
    # the recsys cells, float32 tables: DLRM's train step (float32
    # compute) gathers on the wide kernel in the sum form, its retrieval
    # user tower takes a bf16 mean bag from the float32 table (the cast
    # form, wide); DeepFM's serve rounds its rows to bf16 (cast) and sums
    # w1 (sum), xDeepFM's train step sums both in float32, all on the
    # narrow kernel (40- and 4-byte rows); BERT4Rec's cells run the
    # blocked attention, as the reference's do, and launch none
    "cells_dlrm_train": ("embedding_bag", "embedding_bag_wide"),
    "cells_dlrm_retrieval": ("embedding_bag_cast", "embedding_bag_wide"),
    "cells_deepfm_serve_bulk": ("embedding_bag", "embedding_bag_cast",
                                "embedding_bag_narrow"),
    "cells_xdeepfm_train": ("embedding_bag", "embedding_bag_narrow"),
    "cells_bert4rec_serve_p99": (), "cells_bert4rec_train": (),
    # BERT4Rec: head dim 32, so every split call takes the CUDA-core
    # kernel (the tensor-core one takes 64, 128 and 256), bf16 and float32
    **{p: ("split_attention", "split_attention_cuda_core",
           "split_attention_d32")
       for run in ("cuda_bf16", "cuda_f32") for p in BERT4REC_PATHS[run]},
    **{p: () for run in ("plain_bf16", "plain_f32")
       for p in BERT4REC_PATHS[run]},
    "plain_legacy_bf16": (), "plain_legacy_f32": (),
    # DimeNet: gathers, index_add and dense products, no kernel of the
    # port (the reference reaches no pl.pallas_call on this path)
    **{f"dimenet_{c}": () for c in (*DIMENET_CELLS, "bf16")},
    "plain_int8_kv_bf16": (), "plain_int8_kv_f32": (),
    "plain_cached_bf16": (), "plain_cached_f32": (),
    # gemma3-4b: prefill through the causal (global) and window (local)
    # forms, decode through both window forms of flash decode
    "lm_prefill": _LM_PREFILL + _SPLIT_TC, "lm_decode": _LM_DECODE,
    "lm_cuda_f32": _LM_PREFILL + _LM_DECODE + _SPLIT_CC,
    "lm_soundness": _LM_PREFILL + _SPLIT_CC,
    "lm_plain_bf16": (), "lm_plain_f32": (),
    # the later LMs: pure causal attention, so prefill runs the causal
    # form alone and decode flash decode without a window, its merge too
    # (the planner splits the 2080-key rows at each model's groups); an
    # MoE model's soundness runs its own prefill and decode step
    **{p: kernels for key, *_ in LM_MORE for p, kernels in (
        (f"lm_prefill_{key}", _LM_CAUSAL + _SPLIT_TC),
        (f"lm_decode_{key}", _LM_GLOBAL_DECODE),
        (f"lm_cuda_f32_{key}", _LM_CAUSAL + _LM_GLOBAL_DECODE + _SPLIT_CC),
        (f"lm_soundness_{key}", _LM_CAUSAL + _SPLIT_CC
         + (_LM_GLOBAL_DECODE if key in LM_MOE else ())),
        (f"lm_plain_bf16_{key}", ()), (f"lm_plain_f32_{key}", ()))},
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
# the later LMs' bf16 prefill and decode and granite-moe's sharded loss:
# their launches count under the rows that hold their shapes (each row's
# ``paths``), every other row's under the main paths but these, so a
# launch counts under one row
LM_MORE_MAIN = tuple(f"lm_{kind}_{key}" for key, *_ in LM_MORE
                     for kind in ("prefill", "decode")) + ("spmd_lm_granite",)
# the paths whose launches make the kernels line's `launches`: the index
# builds, the bf16 drains of each serving form, the cascade's bf16 runs
# (untrained and trained), the training paths,
# each LM's bf16 prefill and decode, the recsys serve_bulk forwards,
# retrieval and towers, the router's bf16 drains, BERT4Rec's bf16
# history and join and the DimeNet cells
MAIN_PATHS = ("index", "serve", "serve_legacy", "index_int8",
              "serve_int8_kv", "serve_cached", "index_pq", "serve_pq",
              "serve_pq_cached", "index_pruned", "serve_pruned",
              "cascade_index_fp16", "cascade_index_int8", "cascade_index_pq",
              "cascade_index_pruned", "cascade", "train", "train_validate",
              "distill", "index_distilled", "cascade_trained_index_int8",
              "cascade_trained_index_pq", "cascade_trained_index_pruned",
              "cascade_trained", "lm_prefill", "lm_decode", *LM_MORE_MAIN,
              "blocked_grad",
              "dlrm_serve_bulk", "dlrm_retrieval", "dlrm_item_tower",
              "deepfm_serve_bulk", "deepfm_item_vectors", "deepfm_retrieval",
              "xdeepfm_serve_p99",
              *(f"serve_sharded_{i}_{n}" for i, ns in SHARD_COUNTS.items()
                for n in ns), "serve_sharded_cached",
              *BERT4REC_PATHS["cuda_bf16"],
              *(f"dimenet_{c}" for c in DIMENET_CELLS),
              "index_dp", "serve_mesh_fp16",
              "serve_mesh_int8_kv", "serve_mesh_cached", "spmd_lookup",
              "spmd_moe", "spmd_psum", "spmd_lm_gemma3", "spmd_gnn",
              *(f"cells_{key}" for key, *_ in CELLS))


def _scores(resps):
    """{(request id, doc id): score} of a drain's responses, each checked
    sorted."""
    out = {}
    for r in resps:
        assert list(r.scores) == sorted(r.scores, reverse=True), \
            r.request_id
        for doc, sc in zip(r.doc_ids, r.scores):
            out[(r.request_id, doc)] = float(sc)
    return out


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
    runs = [_scores(resp) for resp in resps]
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


# ---------------------------------------------------------------------------
# Phase 4f: sharded serving (RankingRouter over shard workers)
# ---------------------------------------------------------------------------


def _join_new_threads(before):
    """Wait for the threads started since ``before`` (a timed-out drain's
    runs on after the router gives up on it), so that none outlives its
    phase."""
    import threading
    for th in set(threading.enumerate()) - before:
        th.join(timeout=120.0)


def serve_router(torch, params, cfg, index, requests, label, name, n_shards,
                 want, passes=1, **kw):
    """Serve ``requests`` ``passes`` times through a RankingRouter of
    ``n_shards`` workers sharing the card, after a one-request warm-up on
    another router; every pass's scores must equal ``want`` (a
    single-process run's, per pass) bit for bit.  Prints the merged and
    per-worker stats and the router's overhead: ``admit_s`` (the submits,
    query encodes among them), ``query_encode_s`` and ``merge_s`` (the
    router's drain wall less its slowest worker's: threads, waits, the
    scatter of scores); returns each pass's scores, the launches and the
    line."""
    from repro_torch.serving import RankingRouter, RankRequest
    warm = RankingRouter(params, cfg, index, n_shards=n_shards,
                         micro_batch=MICRO_BATCH,
                         use_layer_kv=kw.get("use_layer_kv"))
    q, qv, ids = requests[0]
    warm.rank(q, qv, ids[:MICRO_BATCH])
    del warm
    router = RankingRouter(params, cfg, index, n_shards=n_shards,
                           micro_batch=MICRO_BATCH, **kw)
    torch.cuda.synchronize()
    walls, admits = [], []

    def drain():
        out = []
        for _ in range(passes):
            t0 = time.perf_counter()
            for i, (q, qv, ids) in enumerate(requests):
                router.submit(RankRequest(q, qv, ids, request_id=f"r{i}"))
            admits.append(time.perf_counter() - t0)
            out.append(router.drain())
            walls.append(time.perf_counter() - t0)
        return out

    resps, launches = counted(drain)
    runs = [_scores(r) for r in resps]
    diffs = [max_diff(run, w) for run, w in zip(runs, want)]
    unequal = [sum(run[k] != w[k] for k in w) for run, w in zip(runs, want)]
    st, per = router.stats, router.worker_stats
    wall = sum(walls)
    worker_keys = ("n_rows", "n_batches", "n_pad_rows", "h2d_bytes",
                   "load_s", "combine_s", "wall_s", "n_doc_cache_hit",
                   "n_doc_cache_miss", "resident_docs")
    line = {"phase": "serve_sharded", "run": label, "device": name,
            "n_shards": n_shards, "owned_docs": [w.n_owned
                                                 for w in router.workers],
            "requests": len(requests) * passes, "wall_s": wall,
            "pass_wall_s": walls, "qps": len(requests) * passes / wall,
            "docs_per_s": st.n_rows / wall, "admit_s": sum(admits),
            "query_encode_s": st.query_encode_s,
            "merge_s": st.wall_s - max(w.wall_s for w in per),
            "merged": {k: getattr(st, k) for k in worker_keys + (
                "n_requests", "n_join_dispatch", "n_decode_dispatch",
                "n_retries", "n_failovers", "n_degraded")},
            "workers": [{k: getattr(w, k) for k in worker_keys}
                        for w in per],
            "max_abs_diff_vs_service": diffs,
            "unequal_vs_service": unequal, "launches": launches}
    emit(line)
    if any(unequal) or any(len(run) != len(w) for run, w in zip(runs, want)):
        raise AssertionError(f"serve_sharded {label}: router scores are not "
                             f"bit-equal to the single-process service's")
    if st.n_rows != len(requests) * N_CANDIDATES * passes \
            or st.n_decode_dispatch or st.n_degraded:
        raise AssertionError(f"serve_sharded {label}: {line['merged']}")
    return runs, launches, line


def sharded_faults(torch, params, cfg, index, requests, name, clean,
                   drain_wall_s):
    """The router's recovery ladder on the card, 2 workers: a transient
    ``engine.score`` fault on shard 1 is retried; a persistent
    ``worker.drain`` fault on shard 0 is failed over; a ``latency`` fault
    past ``drain_timeout_s`` marks shard 1 dead and the fallback serves
    its rows within the timeout plus one drain (``drain_wall_s``: the
    fault-free 2-worker router's pass over the same requests; ``wall_s``
    is the router's drain, the submits before it apart).  Every score
    bit-equal to ``clean``."""
    import threading

    from repro_torch.serving import (FaultPlan, FaultSpec, RankingRouter,
                                     RankRequest, WorkerHealth)
    cases = {
        "retry": (dict(), [FaultSpec("engine.score", "error", tag=1,
                                     count=1)]),
        "failover": (dict(retry_backoff_s=0.0),
                     [FaultSpec("worker.drain", "error", tag=0,
                                count=None)]),
        "timeout": (dict(drain_timeout_s=SHARD_TIMEOUT_S, max_retries=0),
                    [FaultSpec("worker.drain", "latency", tag=1,
                               latency_s=SHARD_STALL_S)]),
    }
    out = {}
    for case, (kw, specs) in cases.items():
        before = set(threading.enumerate())
        router = RankingRouter(params, cfg, index, n_shards=2,
                               micro_batch=MICRO_BATCH, **kw)
        with FaultPlan(specs, seed=SEED) as plan:
            for i, (q, qv, ids) in enumerate(requests):
                router.submit(RankRequest(q, qv, ids, request_id=f"r{i}"))
            t0 = time.perf_counter()
            resps = router.drain()
            wall = time.perf_counter() - t0
        got = _scores(resps)
        st = router.stats
        out[case] = {
            "fired": plan.n_fired(), "wall_s": wall,
            "n_retries": st.n_retries, "n_failovers": st.n_failovers,
            "n_degraded": st.n_degraded,
            "health": [h.state for h in router.health],
            "timeouts": [h.n_timeouts for h in router.health],
            "unequal": sum(got.get(k) != v for k, v in clean.items())}
        _join_new_threads(before)
        del router
    limit = SHARD_TIMEOUT_S + drain_wall_s
    line = {"phase": "serve_sharded_faults", "device": name, **out,
            "timeout_s": SHARD_TIMEOUT_S, "stall_s": SHARD_STALL_S,
            "timeout_wall_limit_s": limit}
    emit(line)
    r, f, t = out["retry"], out["failover"], out["timeout"]
    if not (r["fired"] == 1 and r["n_retries"] > 0 and not r["n_failovers"]
            and f["n_failovers"] > 0 and t["n_failovers"] > 0
            and t["health"][1] == WorkerHealth.DEAD
            and t["timeouts"][1] == 1 and t["wall_s"] <= limit
            and not any(c["unequal"] or c["n_degraded"]
                        for c in out.values())):
        raise AssertionError(f"serve_sharded_faults: {line}")


def sharded_phases(torch, params, cfg, index, requests, name, launches,
                   index_name, want, shard_counts, **kw):
    """``serve_sharded`` over one index: the router at each of
    ``shard_counts`` workers against the single-process bf16 run
    ``want``, between two more single-process runs of the same requests
    (serving walls drift between phases, so the scaling line compares
    runs made in turn); returns the router lines by worker count."""
    lines, qps = {}, {}
    service = lambda label: serve(torch, params, cfg, index, requests,
                                  f"cuda_{index_name}_{label}", name,
                                  **kw)[2]["qps"]
    before = service("service_before")
    for n in shard_counts:
        path = f"serve_sharded_{index_name}_{n}"
        _, launches[path], lines[n] = serve_router(
            torch, params, cfg, index, requests, f"cuda_{index_name}_{n}",
            name, n, [want], **kw)
        qps[n] = lines[n]["qps"]
    emit({"phase": "serve_sharded_scaling", "index": index_name,
          "device": name, "service_qps": [before, service("service_after")],
          "router_qps": qps})
    return lines


def _same_streams(a, b):
    """Whether two single-shard index directories hold the same stream
    files, byte for byte."""
    import filecmp
    sa, sb = (os.path.join(p, "shard-00000") for p in (a, b))
    names = sorted(n for n in os.listdir(sa) if n.endswith(".bin"))
    return names == sorted(n for n in os.listdir(sb) if n.endswith(".bin")) \
        and all(filecmp.cmp(os.path.join(sa, n), os.path.join(sb, n),
                            shallow=False) for n in names)


def mesh_build_phase(torch, name, launches, params, cfg, cfg32, docs,
                     requests, one_dir, one_line, want_f32, label, **kw):
    """(a) The same documents built data-parallel over a ``("data",)``
    mesh of every visible card (``IndexBuilder(mesh=)``): docs/s beside
    the one-device build's, the stream files against the one-device
    index's, and the float32 service over both (bit-equal where the bytes
    are equal, else within the float32 score limit)."""
    from repro_torch.index import IndexBuilder, TermRepIndex
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_device_mesh
    mesh = make_device_mesh("data")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        report, launches[label] = counted(
            lambda: IndexBuilder(tmp, cfg, params, batch_size=INDEX_BATCH,
                                 mesh=mesh, **kw).build(docs))
        # one CRC-32C pass, with its count (open(verify=True) runs the same)
        index = TermRepIndex.open(tmp, verify=False)
        verified = index.verify_integrity()
        same = _same_streams(one_dir, tmp)
        runs, launches[f"serve_{label}_f32"], _ = serve(
            torch, params, cfg32, index, requests, f"cuda_{label}_f32", name)
        line = {"phase": "mesh_build", "index": label, "device": name,
                "world": mesh.size, "devices": [str(d) for d in
                                                mesh.devices.reshape(-1)],
                "n_docs": len(index), "codec": report.codec,
                "encode_batch": index.encode_batch,
                "verified_chunks": verified,
                "docs_per_s": report.n_docs / report.wall_s,
                "docs_per_s_one_device": one_line["docs_per_s"],
                "encode_s": report.encode_s, "wall_s": report.wall_s,
                "bytes_equal_one_device": same,
                "f32_max_abs_diff_vs_one_device": max_diff(runs[0],
                                                           want_f32),
                "f32_tol": 1e-3, "launches": launches[label]}
        emit(line)
        del index
    if line["verified_chunks"] <= 0 or len(runs[0]) != len(want_f32) \
            or line["f32_max_abs_diff_vs_one_device"] > (0.0 if same
                                                         else 1e-3):
        raise AssertionError(f"mesh_build {label}: {line}")
    return line


def mesh_router_phase(torch, name, launches, params, cfg, index, requests,
                      want, label, passes=1, **kw):
    """(b) ``RankingRouter(mesh=)`` over a ``("shard",)`` mesh of every
    visible card, every pass bit-equal to the single-process run
    ``want`` and no task retried or failed over."""
    from repro_torch.dist import serving_shard_devices
    from repro_torch.launch.mesh import make_device_mesh
    mesh = make_device_mesh("shard")
    path = f"serve_mesh_{label}"
    runs, launches[path], line = serve_router(
        torch, params, cfg, index, requests, f"mesh_{label}", name,
        mesh.size, want, passes=passes, mesh=mesh, **kw)
    out = {"phase": "mesh_router", "run": label, "device": name,
           "world": mesh.size,
           "workers": [str(d) for d in serving_shard_devices(mesh)],
           "unequal_vs_service": line["unequal_vs_service"],
           "n_retries": line["merged"]["n_retries"],
           "n_failovers": line["merged"]["n_failovers"],
           "worker_rows": [w["n_rows"] for w in line["workers"]],
           "qps": line["qps"], "launches": launches[path]}
    emit(out)
    # a worker that fails on its card is failed over to the fallback
    # engine, bit-equal: only the counts show it
    if out["n_retries"] or out["n_failovers"]:
        raise AssertionError(f"mesh_router {label}: workers failed on "
                             f"their cards: {out}")
    return runs


def spmd_rank(mesh, spec):
    """One rank of the mesh phase's SPMD checks, its launches counted."""
    from repro_torch.tools.mesh_check import spmd_checks
    return spmd_checks(mesh, spec, count=counted)


def mesh_spec():
    """The SPMD checks' sizes: DLRM's width (bf16) over serve_bulk's ids,
    granite-moe's and qwen3-moe's MoE layer widths at 4 x 2048 tokens,
    PreTTR-BERT's gradient tree, gemma3-4b and granite-moe at full width
    over LM_SPMD_TOKENS, DimeNet's GNN_SPMD cell."""
    from repro_torch.configs import dlrm_mlperf, gemma3_4b, granite_moe_3b, \
        qwen3_moe_235b
    from repro_torch.configs import RECSYS_SHAPES
    dlrm = dlrm_mlperf.full_config()
    moe = {}
    for key, mod in (("granite", granite_moe_3b), ("qwen3", qwen3_moe_235b)):
        c = mod.full_config()
        moe[key] = {"n_experts": c.n_experts, "d_model": c.d_model,
                    "d_ff": c.d_ff, "top_k": c.top_k,
                    "capacity_factor": c.capacity_factor,
                    "n_tokens": MESH_TOKENS}
    b, s = LM_SPMD_TOKENS
    return {"lookup": {"rows": MESH_LOOKUP_ROWS, "dim": dlrm.embed_dim,
                       "n_ids": RECSYS_SHAPES["serve_bulk"]["batch"]
                       * dlrm.n_sparse},
            "moe": moe, "psum": {"axis": ("data", "model")},
            "lm": {"gemma3": {"config": gemma3_4b.full_config(),
                              "batch": b, "seq": s, "grad": True,
                              "bf16": True},
                   "granite": {"config": granite_moe_3b.full_config(),
                               "batch": b, "seq": s, "grad": False,
                               "bf16": False}},
            "gnn": GNN_SPMD}


def spmd_phase(torch, name, launches):
    """(c) One rank a visible card over NCCL (``run_spmd``) on a
    ``("data", "model")`` mesh: the row-sharded lookup, the MoE FFN and
    ``compressed_psum`` (``repro_torch.tools.mesh_check``), each rank's
    results and launches; one card is a world of 1, where the
    collectives are the identity."""
    from repro_torch.launch.mesh import card_mesh_shape, run_spmd
    world = torch.cuda.device_count()
    shape = card_mesh_shape(world)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_spmd(spmd_rank, shape, ("data", "model"),
                       args=(mesh_spec(),), timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    bad = []
    for key in ("lookup", "moe_granite", "moe_qwen3", "psum"):
        path = "spmd_moe" if key.startswith("moe") else f"spmd_{key}"
        per_rank = [r[key] for r in results]
        counts = {}
        for r in per_rank:
            for sub in ([r[c] for c in ("uniform_cf4", "zipf_cf1")]
                        if key == "lookup" else [r]):
                for k, n in sub["launches"].items():
                    counts[k] = counts.get(k, 0) + n
        launches.setdefault(path, {})
        for k, n in counts.items():
            launches[path][k] = launches[path].get(k, 0) + n
        emit({"phase": f"spmd_{key}", "device": name, "world": world,
              "mesh": results[0]["mesh"], "ranks": per_rank})
        for r in per_rank:
            if key == "lookup":
                bad += [f"lookup {c} rank {r}" for c in ("uniform_cf4",
                                                         "zipf_cf1")
                        if not r[c]["equal"]]
            elif key == "psum":
                if not r["finite"] or not r["err_over_bound"] <= 1.0:
                    bad.append(f"psum: finite {r['finite']}, error "
                               f"{r['err_over_bound']} of its int8 bound")
            elif r["max_abs_diff"] > MESH_MOE_REL * r["max_abs"] or \
                    abs(r["aux"] - r["aux_one_process"]) \
                    > 1e-5 * abs(r["aux_one_process"]):
                bad.append(f"{key}: {r['max_abs_diff']} / {r['max_abs']}, "
                           f"aux {r['aux']} vs {r['aux_one_process']}")
    for key in ("lm_gemma3", "lm_granite"):
        path = f"spmd_{key}"
        per_rank = [r[key] for r in results]
        launches.setdefault(path, {})
        for r in per_rank:
            for sub in ("loss", "bf16"):
                for k, n in r.get(sub, {}).get("launches", {}).items():
                    launches[path][k] = launches[path].get(k, 0) + n
        row3 = sum(launches[path].get(k, 0) for k in
                   ("split_attention_causal", "split_attention_window"))
        emit({"phase": path, "device": name, "world": world,
              "mesh": results[0]["mesh"], "row3_launches": row3,
              "loss_rtol": LM_SPMD_RTOL, "grad_rtol": LM_SPMD_RTOL,
              "grad_leaf_rel": LM_SPMD_GRAD_LEAF_REL,
              "bf16_rtol": LM_SPMD_BF16_RTOL, "ranks": per_rank})
        if not row3:
            bad.append(f"{key}: the split-attention kernel never launched")
        for r in per_rank:
            if not r["loss"]["rel"] <= LM_SPMD_RTOL:
                bad.append(f"{key} loss: {r['loss']}")
            g = r.get("grad")
            if g is not None and not (
                    g["loss_rel"] <= LM_SPMD_RTOL and g["leaves_apart"] == 0
                    and g["max_leaf_rel"] <= LM_SPMD_GRAD_LEAF_REL):
                bad.append(f"{key} grad: {g}")
            h = r.get("bf16")
            if h is not None and not h["rel"] <= LM_SPMD_BF16_RTOL:
                bad.append(f"{key} bf16: {h}")
    bad += gnn_line(name, world, results, launches)
    emit({"phase": "spmd_wall", "device": name, "world": world,
          "seconds": wall})
    if bad:
        raise AssertionError(f"spmd checks: {bad}")


def gnn_line(name, world, results, launches):
    """The ``spmd_gnn`` line from every rank's DimeNet check; its
    failures."""
    per_rank = [r["gnn"] for r in results]
    path = "spmd_gnn"
    launches[path] = {}
    for r in per_rank:
        for k, n in r["launches"].items():
            launches[path][k] = launches[path].get(k, 0) + n
    limits = {"f32_loss_rel": DIMENET_LOSS_REL,
              "f32_max_leaf_rel": DIMENET_GRAD_REL,
              "bf16_apart": f"{CELLS_BF16_FACTOR} x control",
              "bf16_losses": "last below first"}
    emit({"phase": path, "device": name, "world": world,
          "mesh": results[0]["mesh"], "reduced": per_rank[0]["reduced"],
          "limits": limits, "launches": {k: n for k, n in
                                         launches[path].items() if n},
          "ranks": per_rank})
    bad = []
    for i, r in enumerate(per_rank):
        f, h = r["f32"], r["bf16"]
        if not (f["loss_rel"] <= DIMENET_LOSS_REL
                and f["max_leaf_rel"] <= DIMENET_GRAD_REL):
            bad.append(f"{path} rank {i} float32: {f}")
        finite = all(math.isfinite(x) for x in h["losses"])
        if not (finite and h["losses"][-1] < h["losses"][0]
                and h["apart"] <= CELLS_BF16_FACTOR * h["control"]):
            bad.append(f"{path} rank {i} bf16: {h}")
    return bad


def cells_rank(mesh, spec):
    """One rank of the cells phase, its launches counted."""
    from repro_torch.tools.cell_check import cell_checks
    return cell_checks(mesh, spec, count=counted)


def _published(arch, shape):
    """A cell's published batch, sequence and depth."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import PRETTR_SHAPES
    spec = get_arch(arch)
    if arch == "prettr-bert":
        info = PRETTR_SHAPES[shape]
        return {"batch": info.get("batch", info.get("global_batch"))}
    info = spec.shapes[shape]
    if spec.family == "recsys":
        vocab = getattr(spec.config, "vocab_sizes", None)
        return {"batch": info["batch"],
                **({"rows_per_field": max(vocab)} if vocab else {})}
    return {"batch": info["global_batch"], "seq": info["seq_len"],
            "n_layers": spec.config.n_layers}


def cells_phase(torch, name, launches):
    """(d) The cells of ``launch.steps`` (``tools/cell_check.py``): one
    rank a visible card over NCCL on a ``("data", "model")`` mesh, each
    cell of CELLS built with ``backend="cuda"`` under ``default_rules``
    and held against the same cell through the plain impls in one process
    on the same card; each line gives the cell's cuts of its published
    sizes (``reduced``), its limits, its differences and launches."""
    from repro_torch.launch.mesh import card_mesh_shape, run_spmd
    world = torch.cuda.device_count()
    shape = card_mesh_shape(world)
    spec = {key: (arch, sh, cuts) for key, arch, sh, cuts in CELLS}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_spmd(cells_rank, shape, ("data", "model"), args=(spec,),
                       timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    bad = []
    for key, arch, sh, cuts in CELLS:
        path = f"cells_{key}"
        per_rank = [r[key] for r in results]
        launches[path] = {}
        for r in per_rank:
            for k, n in r["launches"].items():
                launches[path][k] = launches[path].get(k, 0) + n
        published = _published(arch, sh)
        train = per_rank[0]["kind"] in ("train", "prettr_train",
                                        "rec_train")
        tol = {"loss": LM_SPMD_RTOL, "grad_norm": LM_SPMD_RTOL,
               "grad_apart": 1.0, "params_apart": 1.0,
               "grad_leaf_rel": CELLS_FP16_LEAF_REL if key == "rank_train"
               else LM_SPMD_GRAD_LEAF_REL} if train else \
            {"kernel_vs_f32": f"{CELLS_BF16_FACTOR} x plain_bf16_vs_f32",
             "ids_mismatch": 0}
        emit({"phase": path, "device": name, "world": world,
              "mesh": results[0]["mesh"], "arch": arch, "shape": sh,
              "reduced": {**{k: {"run": v, "published": published[k]}
                             for k, v in cuts.items()},
                          **per_rank[0]["overrides"]},
              "tol": tol, "elem_rtol_atol": LM_SPMD_RTOL if train else None,
              "launches": {k: n for k, n in launches[path].items() if n},
              "ranks": per_rank})
        for r in per_rank:
            if train:
                bad += [f"{path} {what}: {d} (limit {tol[what]})"
                        for what, d in r["diff"].items()
                        if not d <= tol[what]]
                continue
            bad += [f"{path} {what}: kernel_vs_f32 {d}, plain_bf16_vs_f32 "
                    f"{r['plain_bf16_vs_f32'][what]}"
                    for what, d in r["kernel_vs_f32"].items()
                    if not d <= CELLS_BF16_FACTOR
                    * r["plain_bf16_vs_f32"][what]]
            if r.get("ids_mismatch"):
                bad.append(f"{path}: {r['ids_mismatch']} top-k ids apart "
                           f"from the plain run's where the values are not "
                           f"tied")
        missing = [k for k in PATH_KERNELS[path] if not launches[path][k]]
        if missing:
            bad.append(f"{path}: {missing} never launched")
    emit({"phase": "cells_wall", "device": name, "world": world,
          "seconds": wall})
    if bad:
        raise AssertionError(f"cells checks: {bad}")


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
    rounding (bf16).  Returns the world and each index's result."""
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
    return world, results


# ---------------------------------------------------------------------------
# Phase 4e: training at full width, checkpoints, distillation and the
# trained cascade
# ---------------------------------------------------------------------------


def _refusals(torch):
    """Each kernel wrapper called with grad enabled on a CUDA input that
    requires grad: every one must raise before it launches anything."""
    from repro_torch.kernels.decode_attention import flash_decode_attention
    from repro_torch.kernels.embedding_bag import embedding_bag_op
    from repro_torch.kernels.fused_compress import (fused_compress,
                                                    fused_decompress)
    from repro_torch.kernels.join_attention import (join_flash_attention,
                                                    join_flash_attention_paged)
    from repro_torch.kernels.split_attention import split_flash_attention
    x = torch.randn(2, 2, 16, 64, device="cuda", requires_grad=True)
    y = torch.randn(2, 2, 16, 64, device="cuda")
    calls = {
        "split_flash_attention": lambda: split_flash_attention(x, y, y),
        "flash_decode_attention": lambda: flash_decode_attention(
            x[:, :, :1], y, y),
        "join_flash_attention": lambda: join_flash_attention(y, y, y, x, y),
        "join_flash_attention_paged": lambda: join_flash_attention_paged(
            y, y, y, x, x, torch.zeros((2, 1), dtype=torch.int32,
                                       device="cuda"),
            torch.ones((2, 2), dtype=torch.int8, device="cuda")),
        "fused_compress": lambda: fused_compress(y[0, 0], x[0, 0, :, :8],
                                                 y[0, 0, 0, :8]),
        "fused_decompress": lambda: fused_decompress(
            y[0, 0, :, :8].half(), y[0, 0, :8], x[0, 0, 0], y[0, 0, 1],
            y[0, 0, 2]),
        "embedding_bag_op": lambda: embedding_bag_op(
            x.reshape(-1, 64), torch.zeros((2, 1), dtype=torch.int64,
                                           device="cuda")),
    }
    out = {}

    def run_all():
        for k, call in calls.items():
            try:
                call()
                out[k] = False
            except RuntimeError as e:
                out[k] = "plain backend" in str(e)
    _, launched = counted(run_all)
    if not all(out.values()) or any(launched.values()):
        raise AssertionError(f"a kernel wrapper took an input that requires "
                             f"grad: {out}, launches {launched}")
    return out


def train_phase(torch, name, params, cfg, world, launches):
    """TRAIN_STEPS of ``prettr_train_step`` at full width (bf16 compute,
    float32 params and master) on the cascade world's pair batches,
    counted: the steps must launch no kernel.  Returns the trained state,
    the state after CKPT_STEP and the losses."""
    from repro_torch.launch.train import prettr_train_step, step_batch
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.tree import leaves_with_paths

    opt_cfg = OptimizerConfig(lr=TRAIN_LR)
    opt = init_opt_state(params, opt_cfg)
    refusals = _refusals(torch)
    n_params = sum(p.numel() for k, p in leaves_with_paths(params)
                   if not k.startswith("backbone/embed/"))
    tokens = 2 * TRAIN_PAIRS * (cfg.max_query_len + cfg.max_doc_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def loop():
        nonlocal params, opt
        kept = None
        losses, norms, events = [], [], []
        for step in range(TRAIN_STEPS):
            pos, neg = step_batch(world, cfg, SEED, step, TRAIN_PAIRS,
                                  "cuda")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, loss, gn = prettr_train_step(params, opt, cfg,
                                                      opt_cfg, pos, neg)
            end.record()
            losses.append(loss)
            norms.append(gn)
            events.append((start, end))
            if step == CKPT_STEP:
                kept = {"params": params, "opt": opt}
        torch.cuda.synchronize()
        return kept, losses, norms, events

    t0 = time.perf_counter()
    (kept, losses, norms, events), launches["train"] = counted(loop)
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    step_ms = statistics.median(a.elapsed_time(b)
                                for a, b in events[TRAIN_WARMUP:])
    tokens_per_s = tokens / step_ms * 1e3
    first, last = losses[:16], losses[-16:]
    line = {"phase": "train", "device": name, "steps": TRAIN_STEPS,
            "pairs": TRAIN_PAIRS, "tokens_per_step": tokens,
            "lr": TRAIN_LR, "grad_clip": opt_cfg.grad_clip,
            "loss_first_16": first, "loss_last_16": last,
            "loss_first_16_mean": statistics.fmean(first),
            "loss_last_16_mean": statistics.fmean(last),
            "grad_norm_first": norms[0], "grad_norm_last": norms[-1],
            "grad_norm_median": statistics.median(norms),
            "ms_per_step": step_ms, "tokens_per_s": tokens_per_s,
            "non_embedding_params": n_params,
            "model_flops_per_step": 6 * n_params * tokens,
            "mfu": 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS,
            "wall_s": wall, "refusals": refusals,
            "launches": launches["train"], **memory(torch)}
    emit(line)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("train: a loss or gradient norm is not finite")
    if not line["loss_last_16_mean"] < line["loss_first_16_mean"]:
        raise AssertionError("train: the loss did not fall")
    # where a step's time goes: one more step (its result dropped) traced
    batch = step_batch(world, cfg, SEED, TRAIN_STEPS, TRAIN_PAIRS, "cuda")
    profile_run(torch, name, "train_step", lambda: prettr_train_step(
        params, opt, cfg, opt_cfg, *batch))
    return {"params": params, "opt": opt}, kept, losses, opt_cfg


def train_validate_phase(torch, name, params, cfg, cfg32, plain, world,
                         launches, untrained):
    """P@20 validation of the trained weights through the kernels (bf16)
    and the plain backend (bf16, float32): the kernels' scores within
    twice the plain backend's own bf16 rounding."""
    from repro_torch.launch.train import validation_scores

    runs = {}
    for path, c in (("train_validate", cfg),
                    ("plain_train_validate_bf16", plain(cfg)),
                    ("plain_train_validate_f32", plain(cfg32))):
        runs[path], launches[path] = counted(
            lambda c=c: validation_scores(params, c, world, "cuda",
                                          n_queries=VALIDATE_QUERIES))
    (s, p20), (pb, pb20), (pf, pf20) = (runs[p] for p in runs)
    noise = float(abs(pb - pf).max())
    line = {"phase": "train_validate", "device": name,
            "queries": VALIDATE_QUERIES, "candidates": 32,
            "p20_kernels_bf16": p20, "p20_plain_bf16": pb20,
            "p20_plain_f32": pf20, "p20_untrained": untrained,
            "bf16_max_abs_diff": float(abs(s - pb).max()),
            "bf16_tol": 2 * noise, "bf16_rounding_of_plain": noise,
            "launches": launches["train_validate"]}
    ok = line["bf16_max_abs_diff"] <= 2 * noise
    emit({**line, "ok": ok})
    if not ok:
        raise AssertionError("train_validate: the kernels' scores disagree "
                             "with the plain backend's")
    return p20


def checkpoint_phase(torch, name, cfg, world, kept, opt_cfg, train_losses):
    """The train state after CKPT_STEP through ``AsyncCheckpointer`` (the
    time ``save`` holds the caller: its host snapshot); restored bit for
    bit; a newer step with a corrupted leaf skipped; then RESUME_STEPS
    steps from the restored state against as many from the state kept in
    memory, both under ``torch.use_deterministic_algorithms``: the losses
    and every leaf bit-equal."""
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        restore_checkpoint)
    from repro_torch.kernels import _build
    from repro_torch.launch.train import prettr_train_step, step_batch
    from repro_torch.tree import leaves_with_paths

    keyed = dict(leaves_with_paths(kept))
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as d:
        ck = AsyncCheckpointer(d, keep=3)
        t0 = time.perf_counter()
        ck.save(CKPT_STEP, kept)
        snapshot_s = time.perf_counter() - t0
        ck.wait()
        save_s = time.perf_counter() - t0
        nbytes_ = sum(os.path.getsize(os.path.join(d, n, f))
                      for n in os.listdir(d)
                      for f in os.listdir(os.path.join(d, n)))
        t0 = time.perf_counter()
        restored, step = restore_checkpoint(d, kept)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = dict(leaves_with_paths(restored))
        bit_equal = step == CKPT_STEP and sorted(got) == sorted(keyed) \
            and all(got[k].dtype == keyed[k].dtype
                    and got[k].device == keyed[k].device
                    and torch.equal(got[k], keyed[k]) for k in keyed)
        # a newer step whose first leaf is torn: restore falls back
        ck.save(CKPT_STEP + 1, kept)
        ck.wait()
        newer = os.path.join(d, f"step_{CKPT_STEP + 1:08d}")
        with open(os.path.join(newer, "leaf_00000.bin"), "r+b") as f:
            f.write(b"\xde\xad\xbe\xef")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            _, fell_back_to = restore_checkpoint(d, kept)
        latest = latest_step(d)

    def run(state):
        losses = []
        for step in range(CKPT_STEP + 1, CKPT_STEP + 1 + RESUME_STEPS):
            p, o, loss, _ = prettr_train_step(
                state["params"], state["opt"], cfg, opt_cfg,
                *step_batch(world, cfg, SEED, step, TRAIN_PAIRS, "cuda"))
            state = {"params": p, "opt": o}
            losses.append(loss)
        return state, [float(x) for x in losses]

    torch.use_deterministic_algorithms(True)
    try:
        cont, cont_losses = run(kept)
        resumed, resumed_losses = run(restored)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = dict(leaves_with_paths(cont)), dict(leaves_with_paths(resumed))
    resume_bit_equal = cont_losses == resumed_losses \
        and all(torch.equal(a[k], b[k]) for k in a)
    line = {"phase": "checkpoint", "device": name, "step": CKPT_STEP,
            "leaves": len(keyed), "bytes": nbytes_,
            "snapshot_s": snapshot_s, "save_s": save_s,
            "restore_s": restore_s, "restore_bit_equal": bit_equal,
            "corrupt_step": CKPT_STEP + 1, "latest_step": latest,
            "fell_back_to": fell_back_to, "restore_said": said.getvalue(),
            "resume_steps": RESUME_STEPS,
            "deterministic": True,
            "losses_uninterrupted": cont_losses,
            "losses_resumed": resumed_losses,
            "resume_bit_equal": resume_bit_equal,
            "losses_train_phase": train_losses[
                CKPT_STEP + 1:CKPT_STEP + 1 + RESUME_STEPS]}
    ok = bit_equal and fell_back_to == CKPT_STEP and resume_bit_equal
    emit({**line, "ok": ok})
    if not ok:
        raise AssertionError(f"checkpoint: {line}")


def distill_phase(torch, name, params, cfg, world, launches, build, root):
    """``distill_compressor`` at full width (l = 6, e = 256) on car_pairs
    batches of DISTILL_BATCH for DISTILL_STEPS (the frozen trunk below l
    through the kernels, no gradient there), then the fp16 index of the
    cascade world with the distilled compressor (the trained cascade's
    fp16 index).  The attention MSE (Eq. 2) of one held-out batch must
    fall from the compressor it starts from to the distilled one (the
    training curve's first and last steps are other batches).  Returns
    the distilled params and that index."""
    import numpy as np
    from repro_torch.core.compression import attention_mse_loss
    from repro_torch.launch.build_index import distill_compressor

    held_out = torch.from_numpy(world.car_pairs(
        np.random.default_rng([SEED, DISTILL_STEPS]), DISTILL_BATCH,
        cfg.max_query_len, cfg.max_doc_len)["tokens"]).long().cuda()

    def mse(comp):
        with torch.no_grad():
            return float(attention_mse_loss(params["backbone"], comp,
                                            cfg.backbone, held_out, l=cfg.l))

    def run():
        before = mse(params["compressor"])
        comp, losses = distill_compressor(params, cfg, world, DISTILL_STEPS,
                                          seed=SEED, batch=DISTILL_BATCH)
        return comp, losses, before, mse(comp)

    t0 = time.perf_counter()
    (comp, losses, before, after), launches["distill"] = counted(run)
    wall = time.perf_counter() - t0
    distilled = {**params, "compressor": comp}
    index, line = build(os.path.join(root, "trained_fp16"), "index_distilled",
                        corpus=list(world.docs), p=distilled,
                        **CASCADE_INDEXES["fp16"])
    out = {"phase": "distill", "device": name, "steps": DISTILL_STEPS,
           "batch": DISTILL_BATCH, "lr": 3e-3, "l": cfg.l,
           "compress_dim": cfg.compress_dim, "attn_mse": losses,
           "attn_mse_first": losses[0], "attn_mse_last": losses[-1],
           "held_out_attn_mse_before": before,
           "held_out_attn_mse_after": after,
           "wall_s": wall, "launches": launches["distill"],
           "index_docs": line["n_docs"]}
    ok = all(math.isfinite(x) for x in losses + [before, after]) \
        and after < before
    emit({**out, "ok": ok})
    if not ok:
        raise AssertionError("distill: the attention MSE did not fall")
    return distilled, index


def cascade_trained_phase(torch, name, params, cfg, world, launches, build,
                          untrained, root, fp16_index):
    """``run_cascade`` with the trained, distilled weights over the
    untrained run's world, one index each of CASCADE_INDEXES (the fp16 one
    the distill phase built): each line gives both runs' metrics and
    storage bytes (the paper's Table 4)."""
    from repro_torch.eval import run_cascade

    indexes = {kind: fp16_index if kind == "fp16" else
               build(os.path.join(root, f"trained_{kind}"),
                     f"cascade_trained_index_{kind}",
                     corpus=list(world.docs), p=params, **kw)[0]
               for kind, kw in CASCADE_INDEXES.items()}
    walls = {}

    def run_all():
        out = {}
        for kind, index in indexes.items():
            t1 = time.perf_counter()
            out[kind] = run_cascade(params, cfg, world, k=CASCADE_K,
                                    k_metric=CASCADE_K_METRIC,
                                    micro_batch=MICRO_BATCH, index=index)
            walls[kind] = time.perf_counter() - t1
        return out

    results, launches["cascade_trained"] = counted(run_all)
    for kind, res in results.items():
        before = untrained[kind]
        # what the codec moved against fp16: the largest score difference
        # over the candidates both hold, and the share they both hold
        moved = {stage: dict(zip(("max_abs_diff", "common"), _stage_diff(
            res, results["fp16"], stage)))
            for stage in ("first_stage", "rerank")}
        emit({"phase": "cascade_trained", "index": kind, "device": name,
              "first_stage": res.first_stage, "rerank": res.rerank,
              "untrained_first_stage": before.first_stage,
              "untrained_rerank": before.rerank, "vs_fp16": moved,
              "storage_bytes": indexes[kind].storage_bytes(),
              "bytes_per_token": indexes[kind].bytes_per_token(),
              "wall_s": walls[kind], "meta": res.meta})
        values = list(res.first_stage.values()) + list(res.rerank.values())
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"cascade_trained {kind}: non-finite "
                                 f"metrics")
    del indexes


def train_smoke_phase(name):
    """The drivers as a user runs them, at their default (smoke) configs,
    each in its own process on the card: ``launch.train`` for prettr-bert
    and gemma3-4b, ``launch.eval_quality --steps 40`` (its trained re-rank
    must beat the same pools in a random order on P@20 or hit@10) and
    ``launch.build_index --distill-steps 4``."""
    from repro_torch.kernels import _build

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = {"phase": "train_smoke", "device": name}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as d:
        qjson = os.path.join(d, "quality.json")
        commands = {
            "train_prettr": ["repro_torch.launch.train", "--ckpt-dir",
                             os.path.join(d, "ck_prettr")],
            "train_gemma3": ["repro_torch.launch.train", "--arch",
                             "gemma3-4b", "--ckpt-dir",
                             os.path.join(d, "ck_gemma3")],
            "eval_quality": ["repro_torch.launch.eval_quality", "--steps",
                             "40", "--json", qjson],
            "build_index": ["repro_torch.launch.build_index", "--out",
                            os.path.join(d, "idx"), "--distill-steps", "4",
                            "--verify"],
        }
        for key, args in commands.items():
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *args], cwd=d,
                                  env=env, capture_output=True, text=True,
                                  timeout=SMOKE_TIMEOUT_S)
            lines = proc.stdout.strip().splitlines()
            out[key] = {"rc": proc.returncode,
                        "wall_s": time.perf_counter() - t0,
                        "tail": lines[-3:]}
            if proc.returncode != 0:
                emit(out)
                raise AssertionError(f"train_smoke {key} failed:\n"
                                     f"{proc.stderr[-3000:]}")
        with open(qjson) as f:
            quality = json.load(f)
    rr, chance = quality["rerank"], quality["chance"]
    out["eval_quality"].update(
        rerank_p20=rr["p@20"], chance_p20=chance["p@20"],
        rerank_hit10=rr["hit@10"], chance_hit10=chance["hit@10"])
    ok = rr["p@20"] > chance["p@20"] or rr["hit@10"] > chance["hit@10"]
    emit({**out, "ok": ok})
    if not ok:
        raise AssertionError("train_smoke: the trained re-ranker does not "
                             "beat a random ordering of its pools")


def training_phases(torch, name, params, cfg, cfg32, plain, launches, build,
                    world, untrained):
    """Phases train, train_validate, checkpoint, distill and
    cascade_trained at full width, then train_smoke."""
    from repro_torch.kernels import _build
    from repro_torch.launch.train import validation_scores

    _, untrained_p20 = validation_scores(params, cfg, world, "cuda",
                                         n_queries=VALIDATE_QUERIES)
    state, kept, losses, opt_cfg = train_phase(torch, name, params, cfg,
                                               world, launches)
    trained = state["params"]
    train_validate_phase(torch, name, trained, cfg, cfg32, plain, world,
                         launches, untrained_p20)
    checkpoint_phase(torch, name, cfg, world, kept, opt_cfg, losses)
    del state, kept
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as root:
        distilled, fp16_index = distill_phase(torch, name, trained, cfg,
                                              world, launches, build, root)
        cascade_trained_phase(torch, name, distilled, cfg, world, launches,
                              build, untrained, root, fp16_index)
        del fp16_index
    del trained, distilled
    torch.cuda.empty_cache()
    train_smoke_phase(name)


# ---------------------------------------------------------------------------
# Phase 6: the LMs' prefill and decode (gemma3-4b, then LM_MORE)
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


def lm_decode(torch, T, params, cfg, kv, first, forced=None,
              steps=LM_STEPS):
    """The collected K/V (S keys) copied into ``init_decode_cache(cfg, B,
    S + LM_STEPS)``, then ``steps`` ``decode_step``s from position S:
    greedy from ``first`` [B, 1], or fed ``forced`` [B, >= steps]
    (teacher forcing).  Returns (each step's logits, the tokens fed
    [B, steps], seconds of the steps alone)."""
    b, s = kv[0].shape[1], kv[0].shape[2]
    with torch.inference_mode():
        cache = T.init_decode_cache(cfg, b, s + LM_STEPS)
        cache[0][:, :, :s] = kv[0]
        cache[1][:, :, :s] = kv[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, fed, out = first, [], []
        for i in range(steps):
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


def profile_lm(torch, T, params, cfg, prompts, fed, name, suffix=""):
    """Where the LM's device time goes: one prefill of 4 x 2048 tokens,
    then 4 decode steps, each under torch.profiler: the device's busy
    time beside the wall time, and its kernels by total time (runs
    ``lm_prefill`` and ``lm_decode_4_steps``, plus ``suffix``)."""
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

    profile_run(torch, name, "lm_prefill" + suffix,
                lambda: lm_prefill(torch, T, params, cfg, prompts))
    profile_run(torch, name, "lm_decode_4_steps" + suffix, steps)


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
              n for k, n in launched.items()
              if k not in ROUTE_COUNTERS + SHAPE_COUNTERS))})


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


class _TorchWith:
    """``torch`` as a module sees it, with some of its functions
    replaced."""

    def __init__(self, base, **fns):
        self._base, self._fns = base, fns

    def __getattr__(self, name):
        return self._fns.get(name) or getattr(self._base, name)


def routed(torch, fn, pin=None):
    """``fn()`` with every ``moe_ffn`` call's top-k experts ([T, k], in
    ``topk``'s order) recorded; with ``pin``, a recorded run's experts,
    each call takes those, call by call, in place of its own top-k,
    weighted by its own probabilities at them (drops and combine follow
    the pinned experts).  Returns (fn's result, the experts)."""
    from repro_torch.models import moe
    sets, pins = [], iter(pin or ())

    def topk(probs, k, dim=-1):
        idx = next(pins) if pin is not None \
            else torch.topk(probs, k, dim=dim).indices
        sets.append(idx)
        return probs.gather(dim, idx), idx

    moe.torch = _TorchWith(torch, topk=topk)
    try:
        return fn(), sets
    finally:
        moe.torch = torch


def compared_routes(sets, n_layers, b):
    """A prefill + decode run's experts -> for each compared output (the
    prefill's last position, then each step's token) the [B, L, k]
    sorted expert sets of its token in every layer."""
    import torch
    calls = [sets[i:i + n_layers] for i in range(0, len(sets), n_layers)]
    return [torch.stack([x.reshape(b, -1, x.shape[-1])[:, -1].sort(-1)
                         .values for x in c], 1) for c in calls]


def same_routes(a, b):
    """Per compared output, the [B] rows whose token took the same
    experts in every layer in both runs."""
    return [(x == y).all(-1).all(-1) for x, y in zip(a, b)]


def prefill_flips(a, b, n_layers):
    """The share of the prefill's tokens whose expert set differs between
    two runs, layer by layer."""
    return [(x.sort(-1).values != y.sort(-1).values).any(-1).float().mean()
            .item() for x, y in zip(a[:n_layers], b[:n_layers])]


def lm_phases(torch, name, launches, key="", module="gemma3_4b",
              layers=None):
    """One LM at full width on the card (``configs.<module>``, bf16
    weights; ``layers`` keeps that many of the published depth): the
    timed bf16 prefill and greedy decode through the kernels, the same
    through the plain impl and in float32 (fed the kernel run's tokens),
    the soundness of prefill + decode against a longer forward, and a
    profile.  Paths are ``lm_<kind>`` for gemma3-4b (``key`` ""), else
    ``lm_<kind>_<key>``.  An MoE model also reports its routing flips
    between the runs, and its soundness runs at capacity factor E / k,
    where no slot can drop: at 1.25 the longer forward drops other
    tokens' slots than the prefill did, in the JAX package as well; it
    is held on the prefill's routing, and the share of tokens its own
    routing tips on ``LM_ROUTED_APART``."""
    import dataclasses
    import importlib

    import numpy as np
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    path = lambda kind: f"lm_{kind}" + (f"_{key}" if key else "")
    published = importlib.import_module(
        f"repro_torch.configs.{module}").full_config(
            param_dtype=torch.bfloat16)
    cfg = dataclasses.replace(published,
                              n_layers=layers or published.n_layers)
    torch.cuda.reset_peak_memory_stats()
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
          "n_layers": cfg.n_layers,
          "n_layers_published": published.n_layers,
          "reduced": ({"n_layers": [cfg.n_layers, published.n_layers]}
                      if cfg.n_layers != published.n_layers else {}),
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.dh, "d_ff": cfg.d_ff,
          "experts": [cfg.n_experts, cfg.top_k, cfg.capacity_factor],
          "params": cfg.num_params(),
          "params_published": published.num_params(),
          "param_bytes": sum(t.numel() * t.element_size() for t in
                             leaves(params)),
          "layer_windows": cfg.layer_windows(), "decode_steps": LM_STEPS,
          "init_s": init_s})

    # warm-up (cuBLAS handles, the kernel library), not counted
    lg, kv, _ = lm_prefill(torch, T, params, cfg, prompts[:, :64])
    lm_decode(torch, T, params, cfg, kv, lg.argmax(-1), steps=2)
    del lg, kv

    # the main path: bf16 prefill, then greedy decode, through the kernels
    (lg0, kv, prefill_s), launches[path("prefill")] = counted(
        lambda: lm_prefill(torch, T, params, cfg, prompts))
    flops = 2 * cfg.num_active_params() * LM_B * LM_S
    emit({"phase": "lm_prefill", "device": name, "config": cfg.name,
          "batch": LM_B, "prompt": LM_S, "ms": prefill_s * 1e3,
          "tokens_per_s": LM_B * LM_S / prefill_s, "model_flops": flops,
          "model_flops_share_of_bf16_peak":
              flops / prefill_s / PEAK_BF16_FLOPS,
          "finite": bool(torch.isfinite(lg0).all()),
          "launches": launches[path("prefill")]})
    (out, fed, decode_s), launches[path("decode")] = counted(
        lambda: lm_decode(torch, T, params, cfg, kv, lg0.argmax(-1)))
    del kv
    emit({"phase": "lm_decode", "device": name, "config": cfg.name,
          "batch": LM_B, "steps": LM_STEPS, "cache": LM_S + LM_STEPS,
          "ms_per_step": decode_s / LM_STEPS * 1e3,
          "tokens_per_s": LM_B * LM_STEPS / decode_s,
          "finite": all(bool(torch.isfinite(x).all()) for x in out),
          "max_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches[path("decode")]})
    cuda_bf16 = [lg0, *out]
    if not all(bool(torch.isfinite(x).all()) for x in cuda_bf16) \
            or lg0.shape != (LM_B, 1, cfg.vocab_size):
        raise AssertionError(f"{cfg.name}: non-finite or misshapen logits")

    # agreement: the plain impl in bf16 and float32 and the kernels in
    # float32, all fed the kernel run's tokens
    moe = bool(cfg.n_experts)

    def run(c):
        lg, kv, _ = lm_prefill(torch, T, params, c, prompts)
        got, _, _ = lm_decode(torch, T, params, c, kv, None, forced=fed)
        return [lg, *got]

    plain16 = impl(cfg, "plain", torch.bfloat16)
    runs, experts = {}, {}
    for kind, c in (("plain_bf16", plain16),
                    ("plain_f32", impl(cfg, "plain", torch.float32)),
                    ("cuda_f32", cfg32)):
        (runs[kind], experts[kind]), launches[path(kind)] = counted(
            lambda c=c: routed(torch, lambda: run(c)))
    agree = {"phase": "lm_agreement", "device": name, "config": cfg.name}
    bf16_ref = noise_ref = runs["plain_bf16"]
    f32_ref = runs["plain_f32"]
    if moe:
        # A token whose top-k experts differ between two runs in some
        # layer (a near-tie that rounding tipped) takes other experts'
        # weights: a difference of the model's size, not of rounding, and
        # through attention it reaches other tokens.  Each run's routing
        # is recorded (the kernel run's by a replay), and the limits
        # compare runs whose experts are pinned to one routing: the
        # kernels against the plain impl taking the kernel run's experts,
        # the plain bf16 rounding against the plain impl taking the float32
        # run's; the distances at each run's own routing are reported
        replay, experts["cuda_bf16"] = routed(torch, lambda: run(cfg))
        bf16_ref, _ = routed(torch, lambda: run(plain16),
                             pin=experts["cuda_bf16"])
        noise_ref, _ = routed(torch, lambda: run(plain16),
                              pin=experts["plain_f32"])
        f32_ref, _ = routed(torch, lambda: run(impl(cfg, "plain",
                                                    torch.float32)),
                            pin=experts["cuda_f32"])
        routes = {k: compared_routes(v, cfg.n_layers, LM_B)
                  for k, v in experts.items()}
        pairs = (("cuda_bf16", "plain_bf16"), ("plain_bf16", "plain_f32"),
                 ("cuda_f32", "plain_f32"))
        agree.update(
            replay_max_abs_diff=lm_max_diff(replay, cuda_bf16),
            routing_flips_by_layer={
                f"{a}_vs_{b}": prefill_flips(experts[a], experts[b],
                                             cfg.n_layers)
                for a, b in pairs},
            rows_routed_apart={
                f"{a}_vs_{b}": LM_B * (LM_STEPS + 1) - int(sum(
                    m.sum().item() for m in same_routes(routes[a],
                                                        routes[b])))
                for a, b in pairs},
            bf16_max_abs_diff_own_routing=lm_max_diff(cuda_bf16,
                                                      runs["plain_bf16"]),
            bf16_rounding_of_plain_own_routing=lm_max_diff(
                runs["plain_bf16"], runs["plain_f32"]),
            f32_max_abs_diff_own_routing=lm_max_diff(runs["cuda_f32"],
                                                     runs["plain_f32"]))
        del replay, routes
    del experts
    bf16_noise = lm_max_diff(noise_ref, runs["plain_f32"])
    agree.update(
        f32_max_abs_diff=lm_max_diff(runs["cuda_f32"], f32_ref),
        f32_tol=LM_F32_TOL,
        bf16_max_abs_diff=lm_max_diff(cuda_bf16, bf16_ref),
        bf16_tol=2 * bf16_noise, bf16_rounding_of_plain=bf16_noise,
        bf16_kernels_vs_plain_f32=lm_max_diff(cuda_bf16, runs["plain_f32"]),
        logit_abs_max=runs["plain_f32"][0].abs().max().item(),
        same_greedy_tokens_plain_bf16=int(sum(
            (a.argmax(-1) == b.argmax(-1)).sum().item()
            for a, b in zip(cuda_bf16, bf16_ref))),
        of=LM_B * (LM_STEPS + 1),
        launches={path(k): launches[path(k)] for k in runs})
    emit(agree)
    del bf16_ref, noise_ref, f32_ref
    if agree["f32_max_abs_diff"] > LM_F32_TOL \
            or agree["bf16_max_abs_diff"] > agree["bf16_tol"]:
        raise AssertionError(f"{cfg.name}: the kernels disagree with the "
                             f"plain impl")

    # soundness: prefill over 2048 + one decode step == forward over 2049.
    # An MoE model runs both at E / k, where no slot drops, and the
    # forward takes the experts the prefill and the step took (a prompt
    # token tipped to other experts moves the step's logits through
    # attention); its own routing may tip at most LM_ROUTED_APART of the
    # tokens a layer, and its distance, a model-sized move, is given
    snd = cfg32
    if moe:
        snd = dataclasses.replace(cfg32, capacity_factor=cfg.n_experts
                                  / cfg.top_k)

    def forward_last(pin=None):
        def fwd():
            with torch.inference_mode():
                h, _, _ = T.forward(params, snd,
                                    torch.cat([prompts, fed[:, :1]], 1))
                return T.logits(params, snd, h[:, -1:])
        return routed(torch, fwd, pin=pin)

    def sound():
        if not moe:
            return runs["cuda_f32"][1], forward_last()[0], None

        def prefill_step():
            _, kv, _ = lm_prefill(torch, T, params, snd, prompts)
            return lm_decode(torch, T, params, snd, kv, None, forced=fed,
                             steps=1)[0][0]
        step, sets = routed(torch, prefill_step)
        n = cfg.n_layers
        pin = [torch.cat([p.reshape(LM_B, LM_S, -1), d[:, None]], 1)
               .reshape(-1, p.shape[-1]) for p, d in zip(sets[:n], sets[n:])]
        own, own_sets = forward_last()
        apart = prefill_flips(pin, own_sets, n)
        return step, forward_last(pin)[0], {
            "own_routing_max_abs_err": (own - step).abs().max().item(),
            "tokens_routed_apart_by_layer": [
                round(f * LM_B * (LM_S + 1)) for f in apart],
            "routed_apart_share_max": max(apart),
            "routed_apart_tol": LM_ROUTED_APART}
    (step, longer, own), launches[path("soundness")] = counted(sound)
    err = (longer - step).abs().max().item()
    emit({"phase": "lm_soundness", "device": name, "config": cfg.name,
          "max_abs_err": err, "tol": LM_SOUND_TOL,
          "capacity_factor": snd.capacity_factor if moe else None,
          **(own or {}), "launches": launches[path("soundness")],
          **memory(torch)})
    if not err <= LM_SOUND_TOL:
        raise AssertionError(f"{cfg.name}: prefill + decode_step != "
                             f"forward")
    if own and not own["routed_apart_share_max"] <= LM_ROUTED_APART:
        raise AssertionError(f"{cfg.name}: the forward's own routing "
                             f"differs from the prefill's")
    del runs, longer, step
    profile_lm(torch, T, params, cfg, prompts, fed, name,
               "" if not key else f"_{key}")


# ---------------------------------------------------------------------------
# Phase 6b: the "cuda" attention's blocked gradient
# ---------------------------------------------------------------------------


def _blocked_case(torch, seq, dtype):
    """gemma3-4b's full config and seeded q, k, v, cotangent at ``seq``."""
    from repro_torch.configs import gemma3_4b
    cfg = gemma3_4b.full_config()
    b, h, hkv, d = (BLOCKED_GRAD[k] for k in ("batch", "heads", "kv_heads",
                                               "head_dim"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return cfg, [r(b, seq, h, d), r(b, seq, hkv, d), r(b, seq, hkv, d),
                 r(b, seq, h, d)]


def _attention_op(torch, cfg, impl, reference=None):
    """``fn(q, k, v)``: the backend's ``impl`` attention, causal over every
    key; with ``reference`` the "cuda" op's kernel forward under that
    impl's gradient (``"plain"``: the gradient the op took before the
    blocked one)."""
    from repro_torch.models import backend as B
    kw = dict(cfg=cfg, scale=cfg.dh ** -0.5, split_flag=False, segs=None,
              valid=None, window=-1)
    op = lambda name: lambda q, k, v: B.get_impl("attention", name)(
        q, k, v, **kw)
    if reference is None:
        return op(impl)
    return lambda q, k, v: B._ReferenceGradient.apply(
        op("cuda"), op(reference), q, k, v)


def _attention_grads(torch, fn, q, k, v, g):
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, g)


def _backward_peak(torch, fn, q, k, v, g):
    """Bytes allocated at the peak of one backward above what the forward
    left allocated, and that backward's ms (CUDA events)."""
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*xs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    grads = torch.autograd.grad(out, xs, g)
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads, out, xs
    return peak, start.elapsed_time(end)


def blocked_grad_check(torch):
    """The blocked-gradient check (BLOCKED_GRAD): returns its line, with
    ``ok`` and the launches of the bf16 op's forward and backward
    (``launches``) and of the float32 op's (``launches_f32``)."""
    cfg, (q, k, v, g) = _blocked_case(torch, BLOCKED_GRAD_SEQ,
                                      torch.bfloat16)
    cuda_op, plain_op = (_attention_op(torch, cfg, i)
                         for i in ("cuda", "plain"))
    to32 = lambda ts: [t.float() for t in ts]
    _, want = _attention_grads(torch, plain_op, *to32((q, k, v, g)))
    _, plain16 = _attention_grads(torch, plain_op, q, k, v, g)
    (out, got), launched = counted(
        lambda: _attention_grads(torch, cuda_op, q, k, v, g))
    (_, got32), launched32 = counted(
        lambda: _attention_grads(torch, cuda_op, *to32((q, k, v, g))))
    torch.cuda.synchronize()
    grads, ok = {}, launched["split_attention_causal"] > 0
    for n, a, p, a32, w in zip(("dq", "dk", "dv"), got, plain16, got32,
                               want):
        dist = lambda x: (x.float() - w).abs().max().item()
        row = {"kernel_vs_f32": dist(a), "plain_bf16_vs_f32": dist(p),
               "f32_rel": dist(a32) / w.abs().max().item()}
        row["limit"] = CELLS_BF16_FACTOR * row["plain_bf16_vs_f32"]
        ok = ok and row["kernel_vs_f32"] <= row["limit"] \
            and row["f32_rel"] <= LM_SPMD_GRAD_LEAF_REL \
            and bool(torch.isfinite(a).all())
        grads[n] = row
    del want, plain16, got, got32, out
    cfg, (q, k, v, g) = _blocked_case(torch, BLOCKED_MEMORY_SEQ,
                                      torch.bfloat16)
    peak, ms = {"blocked": [], "plain": []}, {"blocked": [], "plain": []}
    for ref in ("blocked", "plain", "blocked", "plain"):
        torch.cuda.empty_cache()
        p, t = _backward_peak(
            torch, _attention_op(torch, cfg, "cuda", ref), q, k, v, g)
        peak[ref].append(p)
        ms[ref].append(t)
    ok = ok and max(peak["blocked"]) < min(peak["plain"])
    b, h, d = BLOCKED_GRAD["batch"], BLOCKED_GRAD["heads"], \
        BLOCKED_GRAD["head_dim"]
    return {"phase": "blocked_grad", "config": cfg.name,
            "q": [b, BLOCKED_GRAD_SEQ, h, d],
            "kv_heads": BLOCKED_GRAD["kv_heads"], "dtype": "bfloat16",
            "block_kv": cfg.block_kv, "causal": True, "grads": grads,
            "factor": CELLS_BF16_FACTOR, "f32_limit": LM_SPMD_GRAD_LEAF_REL,
            "memory_seq": BLOCKED_MEMORY_SEQ,
            "backward_peak_bytes": peak, "backward_ms": ms,
            "launches": launched, "launches_f32": launched32, "ok": ok}


def blocked_grad_phase(torch, name, launches):
    """Phase 6b: the "cuda" attention's forward launches the split kernel,
    its backward takes the blocked gradient within its limit and below
    the plain gradient's peak memory (``blocked_grad_check``)."""
    t0 = time.perf_counter()
    line = blocked_grad_check(torch)
    launches["blocked_grad"] = line.pop("launches")
    launches["blocked_grad_f32"] = line.pop("launches_f32")
    line.update(device=name, seconds=time.perf_counter() - t0,
                row3_launches={
                    p: launches[p]["split_attention_causal"]
                    for p in ("blocked_grad", "blocked_grad_f32")})
    emit(line)
    torch.cuda.empty_cache()
    if not line["ok"]:
        raise AssertionError(f"blocked_grad: {line}")


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
    from repro_torch.tree import leaves

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
          "param_bytes": sum(nbytes(t) for t in leaves(params)),
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
          "param_bytes": sum(nbytes(t) for t in leaves(params)),
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


# ---------------------------------------------------------------------------
# Phase 8: BERT4Rec's PreTTR split
# ---------------------------------------------------------------------------


def bert4rec_phase(torch, name, launches):
    """BERT4Rec at ``configs.bert4rec.full_config`` (2^20 items, 200 slots,
    d 64, 2 heads of 32, split after layer 1 of 2, bf16) at serve_p99
    (REC_P99 histories): ``precompute_history`` (the history through
    layer 0, offline) and ``serve_scores_from_reps`` (a [MASK] slot joined
    to it through layer 1, online) through the kernels and through the
    plain impl, bf16 and float32; the kernels' bf16 scores held to twice
    the plain impl's own bf16 rounding, float32 to the served-score limit;
    top-100 from those scores beside one ``torch.topk``; ``serve_topk``
    timed on the plain impl (its one range mixes split flags); and
    ``forward_hidden`` on the kernel impl must raise that refusal before
    any launch."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.bert4rec import full_config
    from repro_torch.data.recsys import item_seq_batch
    from repro_torch.models.recsys import bert4rec as TB

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = full_config()
    cfgs = {"cuda_bf16": cfg,
            "plain_bf16": dataclasses.replace(cfg, attn_impl="plain"),
            "cuda_f32": dataclasses.replace(cfg, compute_dtype=torch.float32),
            "plain_f32": dataclasses.replace(cfg, attn_impl="plain",
                                             compute_dtype=torch.float32)}
    params = TB.init_bert4rec(cfg, torch.Generator(device="cuda")
                              .manual_seed(SEED))
    batch = item_seq_batch(np.random.default_rng(SEED), REC_P99,
                           n_items=cfg.n_items, seq_len=cfg.seq_len)
    # a user's history is the item sequence itself: the Cloze holes filled
    hist = np.where(batch["targets"] > 0, batch["targets"],
                    batch["item_seq"])
    seq = torch.from_numpy(hist.astype(np.int64)).cuda()
    valid = torch.from_numpy(batch["valid"]).cuda()
    out, ms = {}, {}
    for run, c in cfgs.items():
        history, join = BERT4REC_PATHS[run]
        with torch.inference_mode():
            reps, launches[history] = counted(
                lambda: TB.precompute_history(params, c, seq, valid))
            scores, launches[join] = counted(
                lambda: TB.serve_scores_from_reps(params, c, reps, valid))
            ms[run] = {
                "history": wall_ms(torch, lambda: TB.precompute_history(
                    params, c, seq, valid)),
                "join": wall_ms(torch, lambda: TB.serve_scores_from_reps(
                    params, c, reps, valid))}
        out[run] = (reps.float(), scores)
    diff = lambda a, b, i: (out[a][i] - out[b][i]).abs().max().item()
    rounding = diff("plain_bf16", "plain_f32", 1)
    agree = {"scores_bf16_max_abs_diff": diff("cuda_bf16", "plain_bf16", 1),
             "scores_bf16_limit": 2 * rounding,
             "bf16_rounding_of_plain": rounding,
             "reps_bf16_max_abs_diff": diff("cuda_bf16", "plain_bf16", 0),
             "reps_bf16_limit": 2 * diff("plain_bf16", "plain_f32", 0),
             "scores_f32_max_abs_diff": diff("cuda_f32", "plain_f32", 1),
             "reps_f32_max_abs_diff": diff("cuda_f32", "plain_f32", 0),
             "f32_tol": 1e-3}
    scores = out["cuda_bf16"][1]
    with torch.inference_mode():
        vals, ids = TB.two_stage_topk(scores, 100, 16)
        want_v = torch.topk(scores, 100, dim=-1).values
        topk_ok = bool(torch.equal(vals, want_v)) and bool(torch.equal(
            torch.take_along_dim(scores, ids, 1), vals))
        topk_ms = wall_ms(torch, lambda: TB.two_stage_topk(scores, 100, 16))
        item_seq = torch.from_numpy(batch["item_seq"].astype(np.int64)) \
            .cuda()
        masked = item_seq.clone()
        last = valid.long().sum(-1) - 1
        masked[torch.arange(REC_P99, device="cuda"), last] = TB.MASK_ITEM
        serve_topk_ms = wall_ms(torch, lambda: TB.serve_topk(
            params, cfgs["plain_bf16"], masked, valid, k=100), n=3)
        try:
            _, refused_launches = counted(lambda: TB.forward_hidden(
                params, cfg, masked, valid))
            refusal = None
        except ValueError as e:
            refusal = str(e)
            refused_launches = {k: getattr(w, a) for k, (w, a)
                                in launch_counters().items()}
    line = {"phase": "bert4rec", "device": name, "batch": REC_P99,
            "seq_len": cfg.seq_len, "n_items": cfg.n_items + 2,
            "head_dim": cfg.backbone().dh, "prettr_l": cfg.prettr_l,
            "table_bytes": nbytes(params["embed"]["tokens"]),
            "scores_bytes": nbytes(scores), "ms": ms, **agree,
            "top100_ok": topk_ok, "top100_ms": topk_ms,
            "serve_topk_plain_ms": serve_topk_ms,
            "forward_hidden_refusal": refusal,
            "refusal_launches": sum(refused_launches.values()),
            "launches": {p: launches[p] for p in BERT4REC_PATHS["cuda_bf16"]},
            **memory(torch)}
    emit(line)
    finite = all(bool(torch.isfinite(o[1]).all()) for o in out.values())
    if not (finite and topk_ok
            and agree["scores_bf16_max_abs_diff"] <= agree[
                "scores_bf16_limit"]
            and agree["reps_bf16_max_abs_diff"] <= agree["reps_bf16_limit"]
            and agree["scores_f32_max_abs_diff"] <= agree["f32_tol"]
            and agree["reps_f32_max_abs_diff"] <= agree["f32_tol"]
            and refusal and "uniform split-flag" in refusal
            and line["refusal_launches"] == 0):
        raise AssertionError(f"bert4rec: {line}")


# ---------------------------------------------------------------------------
# Phase 9: DimeNet, forward and training at three GNN cells
# ---------------------------------------------------------------------------


def dimenet_graph(cell):
    """The cell's graph (a numpy ``GraphBatch``, ``launch.steps.gnn_graph``
    at the published sizes), the host seconds it took and the line's
    notes on how it was made."""
    from repro_torch.configs import dimenet as DC
    from repro_torch.launch.steps import gnn_graph

    g, notes = gnn_graph(DC.spec(), cell, seed=SEED)
    return g, sum(notes["host_s"].values()), notes


def _dimenet_forward(D, params, cfg, b):
    extra = {}
    if cfg.task == "energy":
        extra = {"graph_ids": b["graph_ids"], "n_graphs": b["labels"].shape[0]}
    return D.dimenet_forward(
        params, cfg, node_feat=b["node_feat"], positions=b["positions"],
        edge_src=b["edge_src"], edge_dst=b["edge_dst"],
        edge_valid=b["edge_valid"], trip_kj=b["trip_kj"],
        trip_ji=b["trip_ji"], trip_valid=b["trip_valid"], **extra)


def _grad_rel(got, want):
    """Per leaf, max|got - want| over max|want| (0 where both are 0, inf
    where only ``want`` is): the largest, and the three leaves that give
    the largest."""
    from repro_torch.tree import leaves_with_paths
    want = {k: w.cpu().double() for k, w in leaves_with_paths(want)}
    rel = []
    for k, g in leaves_with_paths(got):
        err = (g.cpu().double() - want[k]).abs().max().item()
        scale = want[k].abs().max().item()
        rel.append((err / scale if scale else (0.0 if err == 0 else
                                                math.inf), k))
    rel.sort(reverse=True)
    return rel[0][0], {k: r for r, k in rel[:3]}


def dimenet_cell(torch, name, launches, cell):
    """One cell: the port on the card against the port on the CPU (the
    forward, the loss and every gradient leaf, same inputs and weights),
    the card's run-to-run distance (and both float32 gradients against
    the card's float64 one), the forward's ms, DIMENET_STEPS of
    ``gnn_train_step`` (ms a step, losses, ``mfu`` over the float32 peak,
    peak memory), then a profile of one more step.  Every card call is
    counted under ``dimenet_<cell>`` and must launch no kernel.  Returns
    the CPU params and batch for the bf16 line."""
    import dataclasses

    from repro_torch.configs import dimenet as DC
    from repro_torch.data import graphs as G
    from repro_torch.device import to_device
    from repro_torch.launch.steps import (_dimenet_flops, gnn_cell_config,
                                          gnn_train_step)
    from repro_torch.models.gnn import dimenet as D
    from repro_torch.optim import (OptimizerConfig, init_opt_state,
                                   value_and_grad)
    from repro_torch.tree import tree_map

    spec = gnn_cell_config(DC.spec(), cell)
    cfg = spec.cfg
    g, host_s, notes = dimenet_graph(cell)
    b_cpu = G.graph_batch_tensors(g, device="cpu")
    if cell == "minibatch_lg":         # the loss over the seeds, first
        b_cpu["label_mask"] = torch.arange(len(g.labels)) < notes[
            "seed_nodes"]
    n_nodes, n_edges, n_trip = (len(g.positions), len(g.edge_src),
                                len(g.trip_kj))
    del g
    p_cpu = D.init_dimenet(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    loss_fn = D.energy_loss if cfg.task == "energy" else D.node_cls_loss
    t0 = time.perf_counter()
    with torch.no_grad():
        out_cpu = _dimenet_forward(D, p_cpu, cfg, b_cpu)
    loss_cpu, grads_cpu = value_and_grad(lambda p: loss_fn(p, cfg, b_cpu),
                                         p_cpu)
    cpu_s = time.perf_counter() - t0
    b, params = to_device(b_cpu, "cuda"), to_device(p_cpu, "cuda")
    # the same gradients in float64 on the card: how far each float32 run
    # sits from them
    cfg64 = dataclasses.replace(cfg, compute_dtype=torch.float64)
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in b.items()}
    _, grads64 = value_and_grad(lambda p: loss_fn(p, cfg64, b64),
                                tree_map(lambda a: a.double(), params))
    del b64
    fwd = lambda: _dimenet_forward(D, params, cfg, b)
    opt_cfg = OptimizerConfig()

    def on_card():
        with torch.no_grad():
            outs = [fwd(), fwd()]
        runs = [value_and_grad(lambda p: loss_fn(p, cfg, b), params)
                for _ in range(2)]
        with torch.no_grad():
            fwd_ms = time_ms(fwd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p, opt = params, init_opt_state(params, opt_cfg)
        losses, norms, events = [], [], []
        for _ in range(DIMENET_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p, opt, out = gnn_train_step(p, opt, cfg, opt_cfg, b)
            end.record()
            losses.append(out["loss"])
            norms.append(out["grad_norm"])
            events.append((start, end))
        torch.cuda.synchronize()
        return outs, runs, fwd_ms, (p, opt), losses, norms, events

    t0 = time.perf_counter()
    (outs, runs, fwd_ms, state, losses, norms, events), \
        launches[f"dimenet_{cell}"] = counted(on_card)
    card_s = time.perf_counter() - t0
    mem = memory(torch)
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    step_ms = statistics.median(a.elapsed_time(e)
                                for a, e in events[DIMENET_WARMUP:])
    flops = 3 * _dimenet_flops(cfg, n_edges, n_trip, n_nodes, cfg.d_feat)
    w = DIMENET_LOSS_WINDOW
    scale = out_cpu.abs().max().item()
    rel_cpu, rel64 = (_grad_rel(runs[0][1], ref)
                      for ref in (grads_cpu, grads64))
    cpu64 = _grad_rel(grads_cpu, grads64)
    del grads64
    line = {"phase": f"dimenet_{cell}", "device": name,
            "config": cfg.name, "n_blocks": cfg.n_blocks,
            "d_hidden": cfg.d_hidden, "task": cfg.task,
            "d_feat": cfg.d_feat, "n_classes": cfg.n_classes,
            "compute_dtype": str(cfg.compute_dtype), **notes,
            "host_build_s": host_s, "nodes": n_nodes, "edges": n_edges,
            "triplet_slots": n_trip,
            "triplets_valid_share": b["trip_valid"].float().mean().item(),
            "cell_nodes": spec.n_nodes, "cell_edges_padded": spec.n_edges,
            "cell_triplet_slots": spec.n_trip,
            "forward_ms": fwd_ms, "step_ms": step_ms,
            "steps": DIMENET_STEPS, "lr": opt_cfg.lr,
            "loss_first": losses[:w], "loss_last": losses[-w:],
            "loss_first_mean": statistics.fmean(losses[:w]),
            "loss_last_mean": statistics.fmean(losses[-w:]),
            "grad_norm_first": norms[0], "grad_norm_last": norms[-1],
            "model_flops_per_step": flops,
            "model_flops_per_s": flops / step_ms * 1e3,
            "mfu": flops / step_ms * 1e3 / PEAK_F32_FLOPS,
            "mfu_peak": "float32, CUDA cores (TF32 off)",
            "max_abs_out": scale,
            "fwd_rel_vs_cpu": (outs[0].cpu() - out_cpu).abs().max().item()
            / scale,
            "loss_rel_vs_cpu": abs(runs[0][0].item() - loss_cpu.item())
            / abs(loss_cpu.item()),
            "grad_rel_vs_cpu": rel_cpu[0],
            "grad_rel_vs_cpu_worst": rel_cpu[1],
            "grad_rel_vs_f64": {"card": rel64[0], "cpu": cpu64[0],
                                "card_worst": rel64[1],
                                "cpu_worst": cpu64[1]},
            "limits": {"fwd_rel": DIMENET_FWD_REL,
                       "loss_rel": DIMENET_LOSS_REL,
                       "grad_rel_vs_f64": DIMENET_GRAD_REL,
                       "grad_rel_vs_cpu": DIMENET_GRAD_REL + cpu64[0]},
            "fwd_rel_run_to_run": (outs[0] - outs[1]).abs().max().item()
            / scale,
            "grad_rel_run_to_run": _grad_rel(runs[0][1], runs[1][1])[0],
            "cpu_reference_s": cpu_s, "card_s": card_s,
            "launches": launches[f"dimenet_{cell}"], **mem}
    emit(line)
    finite = all(math.isfinite(x) for x in losses + norms) and bool(
        torch.isfinite(outs[0]).all())
    if not (finite and line["fwd_rel_vs_cpu"] <= DIMENET_FWD_REL
            and line["loss_rel_vs_cpu"] <= DIMENET_LOSS_REL
            and rel64[0] <= DIMENET_GRAD_REL
            and rel_cpu[0] <= DIMENET_GRAD_REL + cpu64[0]
            and line["loss_last_mean"] < line["loss_first_mean"]):
        raise AssertionError(f"dimenet_{cell}: {line}")
    p, opt = state
    profile_run(torch, name, f"dimenet_{cell}_step",
                lambda: gnn_train_step(p, opt, cfg, opt_cfg, b))
    return p_cpu, b_cpu, cfg, out_cpu


def dimenet_phases(torch, name, launches):
    """DimeNet at DIMENET_CELLS, then ``dimenet_bf16``: Cora's forward at
    bf16 compute on the card, within twice the CPU port's own bf16 vs
    float32 distance on the same inputs; then ``dimenet_wall``."""
    import dataclasses

    from repro_torch.device import to_device
    from repro_torch.models.gnn import dimenet as D

    wall = {}
    for cell in DIMENET_CELLS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu_run = dimenet_cell(torch, name, launches, cell)
        if cell == "full_graph_sm":
            p_cpu, b_cpu, cfg, out32 = cpu_run
        wall[cell] = time.perf_counter() - t0
    del cpu_run
    t0 = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        cpu16 = _dimenet_forward(D, p_cpu, cfg16, b_cpu).float()
        params, b = to_device(p_cpu, "cuda"), to_device(b_cpu, "cuda")
        fwd = lambda: _dimenet_forward(D, params, cfg16, b)
        card16, launches["dimenet_bf16"] = counted(fwd)
        ms = time_ms(fwd)
    scale = out32.abs().max().item()
    rounding = (cpu16 - out32).abs().max().item() / scale
    line = {"phase": "dimenet_bf16", "device": name, "cell": "full_graph_sm",
            "forward_ms": ms,
            "max_abs_out_f32": scale,
            "card_bf16_vs_cpu_f32_rel": (card16.float().cpu() - out32).abs()
            .max().item() / scale,
            "cpu_bf16_vs_cpu_f32_rel": rounding, "limit_rel": 2 * rounding,
            "card_bf16_vs_cpu_bf16_rel": (card16.float().cpu() - cpu16).abs()
            .max().item() / scale,
            "launches": launches["dimenet_bf16"]}
    emit(line)
    if not (bool(torch.isfinite(card16).all())
            and line["card_bf16_vs_cpu_f32_rel"] <= line["limit_rel"]):
        raise AssertionError(f"dimenet_bf16: {line}")
    wall["bf16"] = time.perf_counter() - t0
    del p_cpu, b_cpu, params, b
    torch.cuda.empty_cache()
    emit({"phase": "dimenet_wall", "device": name, "seconds": wall,
          "total_s": sum(wall.values())})


def main():
    # cuBLAS's workspace made explicit (the size PyTorch picks on Hopper),
    # so the checkpoint phase may run under use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
          "kernel_build_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.NVCC_SECONDS)})

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
    added_s = {}                   # the sharded and BERT4Rec phases' walls
    plain = lambda c: dataclasses.replace(c, backbone=dataclasses.replace(
        c.backbone, attn_impl="plain", compress_impl="plain"))

    def build(tmp, label, corpus=None, p=None, **kw):
        """Build ``corpus`` (the seeded docs by default) with params ``p``
        (the seeded random ones by default) into ``tmp``, reopen it
        verified and print its line; every build carries chunk checksums,
        and a build the reopening verified none of fails."""
        corpus = docs if corpus is None else corpus
        p = params if p is None else p
        report, launches[label] = counted(
            lambda: IndexBuilder(tmp, cfg, p, batch_size=INDEX_BATCH,
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
        # 4f. the router over the same index: 1, 2 and 4 workers sharing
        #     the card, bit-equal to the service; then its fault ladder
        t0 = time.perf_counter()
        router_lines = sharded_phases(
            torch, params, cfg, index, requests, name, launches, "fp16",
            fused_runs["serve"][0], SHARD_COUNTS["fp16"])
        sharded_faults(torch, params, cfg, index, requests, name,
                       fused_runs["serve"][0], router_lines[2]["wall_s"])
        added_s["serve_sharded_fp16"] = time.perf_counter() - t0
        # 4g. the mesh: the same index built data-parallel over every
        #     card, and the router on a ("shard",) mesh of them
        t0 = time.perf_counter()
        mesh_build_phase(torch, name, launches, params, cfg, cfg32, docs,
                         requests, tmp, fp16_line,
                         fused_runs["serve_f32"][0], "index_dp",
                         codec="fp16")
        mesh_router_phase(torch, name, launches, params, cfg, index,
                          requests, [fused_runs["serve"][0]], "fp16")
        added_s["mesh_fp16"] = time.perf_counter() - t0
        del index

    # 4b. int8 reps with int8 layer-l K/V: the index, then the service
    #     with stored K/V and no cache, then through the paged doc cache
    #     over a hot-document stream, cold then warm
    zipf = make_zipf_requests(rng, cfg)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        index, _ = build(tmp, "index_int8", codec="int8",
                         store_layer_kv=True, kv_codec="int8")
        int8_runs = serve_both(index, requests,
                   ("serve_int8_kv", "plain_int8_kv_bf16",
                    "serve_int8_kv_f32", "plain_int8_kv_f32"),
                   ("cuda_int8_kv_bf16", "plain_int8_kv_bf16",
                    "cuda_int8_kv_f32", "plain_int8_kv_f32"),
                   use_layer_kv=True)
        t0 = time.perf_counter()
        sharded_phases(torch, params, cfg, index, requests, name, launches,
                       "int8_kv", int8_runs["serve_int8_kv"][0],
                       SHARD_COUNTS["int8_kv"], use_layer_kv=True)
        added_s["serve_sharded_int8_kv"] = time.perf_counter() - t0
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
        # the router with a paged doc cache of CACHE_MB a worker: cold
        # then warm, each pass bit-equal to the service's
        t0 = time.perf_counter()
        sh_runs, launches["serve_sharded_cached"], sh_line = serve_router(
            torch, params, cfg, index, zipf, "cuda_cached_2", name, 2,
            runs["serve_cached"], passes=2, use_layer_kv=True,
            doc_cache_mb=CACHE_MB, page_tokens=PAGE_TOKENS)
        sh_cached = {"phase": "serve_sharded_cached", "device": name,
                     "warm_vs_cold_max_abs_diff": max_diff(sh_runs[0],
                                                           sh_runs[1]),
                     "pass_qps": [N_CACHED_REQUESTS / w
                                  for w in sh_line["pass_wall_s"]],
                     "paged_join_launches": launches[
                         "serve_sharded_cached"]["join_attention_paged"],
                     "doc_cache_hit": sh_line["merged"]["n_doc_cache_hit"],
                     "doc_cache_miss": sh_line["merged"]["n_doc_cache_miss"]}
        emit(sh_cached)
        if sh_cached["warm_vs_cold_max_abs_diff"] \
                or not sh_cached["paged_join_launches"] \
                or not (sh_cached["doc_cache_hit"]
                        and sh_cached["doc_cache_miss"]):
            raise AssertionError(f"serve_sharded_cached: {sh_cached}")
        added_s["serve_sharded_cached"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_router_phase(torch, name, launches, params, cfg, index,
                          requests, [int8_runs["serve_int8_kv"][0]],
                          "int8_kv", use_layer_kv=True)
        mesh_router_phase(torch, name, launches, params, cfg, index, zipf,
                          runs["serve_cached"], "cached", passes=2,
                          use_layer_kv=True, doc_cache_mb=CACHE_MB,
                          page_tokens=PAGE_TOKENS)
        added_s["mesh_int8_kv"] = time.perf_counter() - t0
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
        pq_runs = serve_both(index, requests, ("serve_pq", "plain_pq_bf16",
                                               "serve_pq_f32",
                                               "plain_pq_f32"),
                             ("cuda_pq_bf16", "plain_pq_bf16", "cuda_pq_f32",
                              "plain_pq_f32"))
        t0 = time.perf_counter()
        sharded_phases(torch, params, cfg, index, requests, name, launches,
                       "pq", pq_runs["serve_pq"][0], SHARD_COUNTS["pq"])
        added_s["serve_sharded_pq"] = time.perf_counter() - t0
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
    world, untrained = cascade_phases(torch, name, params, cfg, cfg32, plain,
                                      launches, build)

    # 4e. training at full width: the train steps (no kernel), the
    #     validation through the kernels, checkpoints, the compressor's
    #     distillation, the trained cascade; then the drivers
    training_phases(torch, name, params, cfg, cfg32, plain, launches, build,
                    world, untrained)
    del world, untrained

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

    # 6. gemma3-4b, then the later LMs, prefill and decode
    lm_s = {}
    for model in (("", "gemma3_4b", None), *LM_MORE):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lm_phases(torch, name, launches, *model)
        lm_s[model[1]] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit({"phase": "lm_wall", "device": name, "seconds": lm_s,
          "total_s": sum(lm_s.values())})

    # 6b. the "cuda" attention's blocked gradient at gemma3's global layer
    blocked_grad_phase(torch, name, launches)

    # 7. the recsys models, once the LM's state is freed
    recsys_phases(torch, name, launches, rows)

    # 8. BERT4Rec's PreTTR split at serve_p99
    t0 = time.perf_counter()
    bert4rec_phase(torch, name, launches)
    added_s["bert4rec"] = time.perf_counter() - t0
    emit({"phase": "sharded_and_bert4rec_wall", "device": name,
          "seconds": added_s, "total_s": sum(added_s.values())})

    # 9. DimeNet: three GNN cells, forward and training, no kernel
    dimenet_phases(torch, name, launches)

    # 9b. the SPMD checks, one rank a card over NCCL
    spmd_phase(torch, name, launches)

    # 9c. the cells of launch.steps, one rank a card
    cells_phase(torch, name, launches)

    # 10. kernels line: `launches` counts the main paths (the index builds,
    #    the bf16 drains, the LMs' bf16 prefill and decode and the recsys
    #    paths of MAIN_PATHS, the later LMs' under their shapes' rows);
    #    `launches_by_path` each counted path alone
    for row in rows:
        k = row.pop("counter", row["name"])
        paths = row.pop("paths", [p for p in MAIN_PATHS
                                  if p not in LM_MORE_MAIN])
        row["launches"] = sum(launches[p][k] for p in paths)
        row["launches_by_path"] = {p: n[k] for p, n in launches.items()}
        if k + "_merge" in MERGE_COUNTERS:
            row["merge_launches"] = sum(launches[p][k + "_merge"]
                                        for p in paths)
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
