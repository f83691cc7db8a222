"""Granite-3.0-3B-A800M MoE: 32 layers, d_model=1536, 24 heads (GQA
kv=8), head_dim=64, expert d_ff=512, 40 experts top-8 at capacity factor
1.25, vocab=49155, tied head.  The same numbers as
``repro.configs.granite_moe_3b``; the default impl runs the hand-written
CUDA kernels (split attention's causal form in prefill, flash decode in
``decode_step``), the MoE FFN in plain torch (``models.moe``)."""
import torch

from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full_config(attn_impl: str = "cuda", compute_dtype=torch.bfloat16,
                param_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
        causal=True, rope_base=1e4, norm="rmsnorm", gated_mlp=True,
        activation="silu", n_experts=40, top_k=8, capacity_factor=1.25,
        compute_dtype=compute_dtype, param_dtype=param_dtype,
        attn_impl=attn_impl, block_kv=512, logits_chunk=512,
        tie_embeddings=True)


def smoke_config(attn_impl: str = "cuda",
                 compute_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-smoke", n_layers=4, d_model=48, n_heads=4,
        n_kv_heads=2, head_dim=12, d_ff=32, vocab_size=512, causal=True,
        n_experts=5, top_k=2, tie_embeddings=True,
        compute_dtype=compute_dtype, attn_impl=attn_impl, block_kv=16,
        logits_chunk=16)


def spec() -> ArchSpec:
    return ArchSpec(
        name="granite-moe-3b-a800m", family="lm", config=full_config(),
        smoke=smoke_config(), shapes=LM_SHAPES, skip_shapes=("long_500k",),
        notes="long_500k skipped: pure full attention.")
