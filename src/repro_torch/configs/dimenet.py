"""DimeNet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6.  The same numbers as ``repro.configs.dimenet``."""
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn.dimenet import DimeNetConfig


def full_config() -> DimeNetConfig:
    return DimeNetConfig(
        name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8,
        n_spherical=7, n_radial=6)


def smoke_config() -> DimeNetConfig:
    return DimeNetConfig(
        name="dimenet-smoke", n_blocks=2, d_hidden=32, n_bilinear=4,
        n_spherical=3, n_radial=4, n_classes=8)


def spec() -> ArchSpec:
    return ArchSpec(
        name="dimenet", family="gnn", config=full_config(),
        smoke=smoke_config(), shapes=GNN_SHAPES,
        notes="PreTTR inapplicable to message passing; citation-graph "
              "cells use a feature input projection + synthetic 3D "
              "positions.")
