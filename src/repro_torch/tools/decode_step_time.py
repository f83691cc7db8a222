"""Wall and device time of gemma3-4b's decode step on the card, for
an A/B of two checkouts of the port.

It times whatever ``repro_torch`` the path gives, so one copy of this file
times any checkout; run it once per checkout, alternating which goes first:

    PYTHONPATH=<checkout>/src python src/repro_torch/tools/decode_step_time.py --label <name>

The model is ``chip_smoke.py``'s LM path: gemma3-4b at full width and
depth, random bf16 weights from a seed, 4 prompts of 2048 tokens
prefilled into a 2080-key cache, then decode steps from position 2048.
Each repeat gives the mean wall time a step of 32 unprofiled steps, and the wall and the device's busy time (its kernels' device times
summed) of 4 steps under ``torch.profiler``.  Prints one JSON line."""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

B, S, STEPS = 4, 2048, 32


def _cache(T, cfg, kv):
    cache = T.init_decode_cache(cfg, B, S + STEPS)
    cache[0][:, :, :S] = kv[0]
    cache[1][:, :, :S] = kv[1]
    return cache


def _steps(T, params, cfg, cache, tokens):
    for i in range(tokens.shape[1]):
        T.decode_step(params, cfg, tokens[:, i:i + 1], cache, S + i)


def _busy_ms(events):
    from torch.autograd import DeviceType
    total = 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA \
                or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "device_time_total", None)
        total += (e.cuda_time_total if us is None else us) / 1e3
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_step_time: no CUDA device")
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.configs.gemma3_4b import full_config
    from repro_torch.models import transformer as T

    cfg = full_config(param_dtype=torch.bfloat16)
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(args.seed))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, STEPS), generator=gen,
                           device="cuda")
    line = {"label": args.label, "steps": STEPS, "step_ms": [],
            "profiled_4_steps_ms": [], "device_busy_4_steps_ms": []}
    with torch.inference_mode():
        _, kv, _ = T.forward(params, cfg, prompts, collect_cache=True)
        _steps(T, params, cfg, _cache(T, cfg, kv), tokens[:, :4])  # warm
        for _ in range(args.repeats):
            cache = _cache(T, cfg, kv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _steps(T, params, cfg, cache, tokens)
            torch.cuda.synchronize()
            line["step_ms"].append((time.perf_counter() - t0) * 1e3 / STEPS)
            read = []
            cache = _cache(T, cfg, kv)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: read.append(
                             p.key_averages())) as prof:
                _steps(T, params, cfg, cache, tokens[:, :4])
                torch.cuda.synchronize()
                prof.step()
                t0 = time.perf_counter()
                _steps(T, params, cfg, cache, tokens[:, 4:8])
                torch.cuda.synchronize()
                line["profiled_4_steps_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                prof.step()
            line["device_busy_4_steps_ms"].append(_busy_ms(read[0]))
    line["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
