"""Mistral-Large-Instruct-2407 (123B dense): 88 layers, d_model=12288, 96
heads (GQA kv=8), head_dim=128, d_ff=28672, vocab=32768, RoPE base 1M.
The same numbers as ``repro.configs.mistral_large_123b``; the default
impl runs the hand-written CUDA kernels (split attention's causal form in
prefill, flash decode in ``decode_step``).  The whole model (~246 GB in
bf16) does not fit one card; ``chip_smoke.py`` runs it at full width
with its depth cut."""
import torch

from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full_config(attn_impl: str = "cuda", compute_dtype=torch.bfloat16,
                param_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
        n_kv_heads=8, head_dim=128, d_ff=28672, vocab_size=32768,
        causal=True, rope_base=1e6, norm="rmsnorm", gated_mlp=True,
        activation="silu", compute_dtype=compute_dtype,
        param_dtype=param_dtype, attn_impl=attn_impl, block_kv=512,
        logits_chunk=512)


def smoke_config(attn_impl: str = "cuda",
                 compute_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="mistral-large-123b-smoke", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512, causal=True,
        rope_base=1e6, compute_dtype=compute_dtype, attn_impl=attn_impl,
        block_kv=32, logits_chunk=16)


def spec() -> ArchSpec:
    return ArchSpec(
        name="mistral-large-123b", family="lm", config=full_config(),
        smoke=smoke_config(), shapes=LM_SHAPES, skip_shapes=("long_500k",),
        notes="long_500k skipped: pure full attention.")
