"""The paper's own model: Vanilla BERT-base PreTTR ranker (section 5.2).
12L d_model=768 12H d_ff=3072 vocab=30522, split at l, compression e.
The same numbers as ``repro.configs.prettr_bert``; the default impl runs
the hand-written CUDA kernels."""
import torch

from repro_torch.configs import LM_SHAPES, ArchSpec
from repro_torch.core.prettr import PreTTRConfig, make_backbone


def full_config(l: int = 6, compress_dim: int = 256,
                max_query_len: int = 32, max_doc_len: int = 480,
                attn_impl: str = "cuda", compress_impl: str = "cuda",
                compute_dtype=torch.bfloat16) -> PreTTRConfig:
    return PreTTRConfig(
        backbone=make_backbone(
            n_layers=12, d_model=768, n_heads=12, d_ff=3072,
            vocab_size=30522, l=l, max_len=max_query_len + max_doc_len,
            compute_dtype=compute_dtype, block_kv=128, attn_impl=attn_impl,
            compress_impl=compress_impl),
        l=l, max_query_len=max_query_len, max_doc_len=max_doc_len,
        compress_dim=compress_dim)


def smoke_config(l: int = 2, compress_dim: int = 16,
                 attn_impl: str = "cuda", compress_impl: str = "cuda",
                 compute_dtype=torch.float32) -> PreTTRConfig:
    return PreTTRConfig(
        backbone=make_backbone(
            n_layers=4, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
            l=l, max_len=48, compute_dtype=compute_dtype, block_kv=16,
            attn_impl=attn_impl, compress_impl=compress_impl),
        l=l, max_query_len=8, max_doc_len=40, compress_dim=compress_dim)


def spec() -> ArchSpec:
    return ArchSpec(
        name="prettr-bert", family="prettr", config=full_config(),
        smoke=smoke_config(), shapes=LM_SHAPES,
        skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        notes="The paper's own ranker; exercised through the PreTTR paths "
              "(train, index, serve, the quality cascade).")
