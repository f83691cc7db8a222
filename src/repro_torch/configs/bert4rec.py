"""BERT4Rec [arXiv:1904.06690; paper]: embed_dim=64 n_blocks=2 n_heads=2
seq_len=200, bidirectional over item sequences.  The same numbers as
``repro.configs.bert4rec``: the item vocabulary sized to the 1M-candidate
retrieval cell, the PreTTR split after layer 1 of 2."""
import torch

from repro_torch.configs import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys.bert4rec import Bert4RecConfig


def full_config() -> Bert4RecConfig:
    # n_items + 2 specials = 2^20, which 16 vocab shards divide
    return Bert4RecConfig(
        name="bert4rec", n_items=1_048_574, seq_len=200, embed_dim=64,
        n_blocks=2, n_heads=2, prettr_l=1, compute_dtype=torch.bfloat16)


def smoke_config() -> Bert4RecConfig:
    return Bert4RecConfig(
        name="bert4rec-smoke", n_items=500, seq_len=20, embed_dim=32,
        n_blocks=2, n_heads=2, prettr_l=1, compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(
        name="bert4rec", family="recsys", config=full_config(),
        smoke=smoke_config(), shapes=RECSYS_SHAPES,
        notes="PreTTR applies natively: history segment precomputed "
              "offline via the split mask (prettr_l=1 of 2 layers).")
