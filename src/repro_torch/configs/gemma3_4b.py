"""Gemma3-4B: 34 layers, d_model=2560, 8 heads (GQA kv=4), d_ff=10240,
vocab=262144; 5:1 local:global sliding window (1024), head_dim=256,
QK-norm, post-block norms, RoPE base 10k local / 1M global, embeddings
scaled by sqrt(d), tied head.  The same numbers as
``repro.configs.gemma3_4b``; the default impl runs the hand-written CUDA
kernels (split attention's causal and window forms in prefill, flash
decode in ``decode_step``)."""
import torch

from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full_config(attn_impl: str = "cuda", compute_dtype=torch.bfloat16,
                param_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8,
        n_kv_heads=4, head_dim=256, d_ff=10240, vocab_size=262144,
        causal=True, window_pattern=(1, 1, 1, 1, 1, -1), window_size=1024,
        rope_base=1e6, rope_base_local=1e4, use_qk_norm=True,
        use_post_norm=True, scale_embeddings=True, norm="rmsnorm",
        gated_mlp=True, activation="gelu", compute_dtype=compute_dtype,
        param_dtype=param_dtype, attn_impl=attn_impl, block_kv=512,
        logits_chunk=256, tie_embeddings=True)


def smoke_config(attn_impl: str = "cuda",
                 compute_dtype=torch.float32) -> TransformerConfig:
    return TransformerConfig(
        name="gemma3-4b-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, causal=True,
        window_pattern=(1, 1, 1, 1, 1, -1), window_size=8, rope_base=1e6,
        rope_base_local=1e4, use_qk_norm=True, use_post_norm=True,
        scale_embeddings=True, activation="gelu", tie_embeddings=True,
        compute_dtype=compute_dtype, attn_impl=attn_impl, block_kv=16,
        logits_chunk=16)


def spec() -> ArchSpec:
    return ArchSpec(
        name="gemma3-4b", family="lm", config=full_config(),
        smoke=smoke_config(), shapes=LM_SHAPES,
        notes="hybrid local:global -- long_500k runs (local layers hold a "
              "1024 window; a sixth of the layers carry full-length KV).")
