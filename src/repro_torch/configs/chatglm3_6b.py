"""ChatGLM3-6B: 28 layers, d_model=4096, 32 heads (GQA kv=2),
head_dim=128, d_ff=13696, vocab=65024; "2d" RoPE (half of each head
rotated), QKV bias.  The same numbers as ``repro.configs.chatglm3_6b``;
the default impl runs the hand-written CUDA kernels (split attention's
causal form in prefill, flash decode in ``decode_step``)."""
import torch

from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full_config(attn_impl: str = "cuda", compute_dtype=torch.bfloat16,
                param_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
        n_kv_heads=2, head_dim=128, d_ff=13696, vocab_size=65024,
        causal=True, rope_base=1e4, rope_fraction=0.5, qkv_bias=True,
        norm="rmsnorm", gated_mlp=True, activation="silu",
        compute_dtype=compute_dtype, param_dtype=param_dtype,
        attn_impl=attn_impl, block_kv=512, logits_chunk=512)


def smoke_config(attn_impl: str = "cuda",
                 compute_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="chatglm3-6b-smoke", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512, causal=True,
        rope_fraction=0.5, qkv_bias=True, compute_dtype=compute_dtype,
        attn_impl=attn_impl, block_kv=32, logits_chunk=16)


def spec() -> ArchSpec:
    return ArchSpec(
        name="chatglm3-6b", family="lm", config=full_config(),
        smoke=smoke_config(), shapes=LM_SHAPES, skip_shapes=("long_500k",),
        notes="long_500k skipped: pure full attention.")
