"""DLRM MLPerf benchmark config (Criteo 1TB) [arXiv:1906.00091; paper]:
n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1 interaction=dot.  The same numbers as
``repro.configs.dlrm_mlperf``; the fused table has 187,767,808 rows after
padding to 512 (96.1 GB in float32, 48.1 GB with
``param_dtype=torch.bfloat16``)."""
import torch

from repro_torch.configs import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys.dlrm import CRITEO_1TB_VOCABS, DLRMConfig


def full_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-mlperf", n_dense=13, vocab_sizes=CRITEO_1TB_VOCABS,
        embed_dim=128, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1), compute_dtype=torch.bfloat16)


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-smoke", n_dense=13, vocab_sizes=(1000,) * 26,
        embed_dim=16, bot_mlp=(32, 16), top_mlp=(64, 32, 1),
        compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(
        name="dlrm-mlperf", family="recsys", config=full_config(),
        smoke=smoke_config(), shapes=RECSYS_SHAPES,
        notes="PreTTR analogue: item-side tower precomputed offline "
              "(retrieval_cand cell).")
