"""xDeepFM [arXiv:1803.05170; paper]: n_sparse=39 embed_dim=10
cin_layers=200-200-200 mlp=400-400 interaction=cin.  The same numbers as
``repro.configs.xdeepfm``."""
import torch

from repro_torch.configs import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys.deepfm import DeepFMConfig


def full_config() -> DeepFMConfig:
    return DeepFMConfig(
        name="xdeepfm", n_fields=39, vocab_per_field=1_000_000, embed_dim=10,
        mlp=(400, 400), interaction="cin", cin_layers=(200, 200, 200),
        compute_dtype=torch.bfloat16)


def smoke_config() -> DeepFMConfig:
    return DeepFMConfig(
        name="xdeepfm-smoke", n_fields=10, vocab_per_field=500, embed_dim=8,
        mlp=(32, 16), interaction="cin", cin_layers=(16, 16),
        item_fields=tuple(range(5, 10)), compute_dtype=torch.float32)


def spec() -> ArchSpec:
    return ArchSpec(
        name="xdeepfm", family="recsys", config=full_config(),
        smoke=smoke_config(), shapes=RECSYS_SHAPES,
        notes="CIN mixes fields at layer 1 -- only the embedding gather is "
              "precomputable; PreTTR largely inapplicable.")
