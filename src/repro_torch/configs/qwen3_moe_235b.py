"""Qwen3-235B-A22B MoE: 94 layers, d_model=4096, 64 heads (GQA kv=4),
head_dim=128, QK-norm, expert d_ff=1536, 128 experts top-8 at capacity
factor 1.25, vocab=151936, RoPE base 1M.  The same numbers as
``repro.configs.qwen3_moe_235b``; the default impl runs the hand-written
CUDA kernels (split attention's causal form in prefill, flash decode in
``decode_step``), the MoE FFN in plain torch (``models.moe``)."""
import torch

from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full_config(attn_impl: str = "cuda", compute_dtype=torch.bfloat16,
                param_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
        causal=True, rope_base=1e6, use_qk_norm=True, norm="rmsnorm",
        gated_mlp=True, activation="silu", n_experts=128, top_k=8,
        capacity_factor=1.25, compute_dtype=compute_dtype,
        param_dtype=param_dtype, attn_impl=attn_impl, block_kv=512,
        logits_chunk=256)


def smoke_config(attn_impl: str = "cuda",
                 compute_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=512, causal=True,
        use_qk_norm=True, n_experts=8, top_k=2, compute_dtype=compute_dtype,
        attn_impl=attn_impl, block_kv=16, logits_chunk=16)


def spec() -> ArchSpec:
    return ArchSpec(
        name="qwen3-moe-235b-a22b", family="lm", config=full_config(),
        smoke=smoke_config(), shapes=LM_SHAPES, skip_shapes=("long_500k",),
        notes="long_500k skipped: pure full attention.")
