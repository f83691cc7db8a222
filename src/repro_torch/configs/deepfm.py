"""DeepFM [arXiv:1703.04247; paper]: n_sparse=39 embed_dim=10
mlp=400-400-400 interaction=fm.  The same numbers as
``repro.configs.deepfm``."""
import torch

from repro_torch.configs import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys.deepfm import DeepFMConfig


def full_config() -> DeepFMConfig:
    return DeepFMConfig(
        name="deepfm", n_fields=39, vocab_per_field=1_000_000, embed_dim=10,
        mlp=(400, 400, 400), interaction="fm", compute_dtype=torch.bfloat16)


def smoke_config() -> DeepFMConfig:
    return DeepFMConfig(
        name="deepfm-smoke", n_fields=10, vocab_per_field=500, embed_dim=8,
        mlp=(32, 16), interaction="fm", item_fields=tuple(range(5, 10)),
        compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(
        name="deepfm", family="recsys", config=full_config(),
        smoke=smoke_config(), shapes=RECSYS_SHAPES,
        notes="PreTTR analogue: item-side FM partial sums precomputed.")
