"""The port's architecture registry against the JAX package's, and its
drivers run as a user runs them, on the CPU: ``launch.train`` for both
trainable architectures (with ``--resume``), ``launch.eval_quality`` and
``launch.build_index --distill-steps``."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as J
from repro_torch import configs as T
from repro_torch.checkpoint import latest_step
from repro_torch.launch import build_index, eval_quality, train

PORTED = ("prettr-bert", "gemma3-4b", "granite-moe-3b-a800m",
          "qwen3-moe-235b-a22b", "chatglm3-6b", "mistral-large-123b",
          "dimenet", "dlrm-mlperf", "deepfm", "xdeepfm", "bert4rec")
# the backend knobs name each package's own implementations
IMPL_FIELDS = {"attn_impl", "compress_impl", "bag_impl"}


def test_registry_names_and_shape_tables_match_jax():
    assert T.ALL_ARCHS == J.ALL_ARCHS
    assert T.ASSIGNED_ARCHS == J.ASSIGNED_ARCHS
    assert (T.LM_SHAPES, T.GNN_SHAPES, T.RECSYS_SHAPES) == \
        (J.LM_SHAPES, J.GNN_SHAPES, J.RECSYS_SHAPES)
    assert set(PORTED) == set(T.ALL_ARCHS)


def _same_fields(got, want, path):
    """Every field the port's config shares with the JAX config's holds
    the same value (dtypes by name, nested configs field by field)."""
    shared = {f.name for f in dataclasses.fields(got)} \
        & {f.name for f in dataclasses.fields(want)}
    assert len(shared) >= 5, path
    for name in sorted(shared - IMPL_FIELDS):
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(g):
            _same_fields(g, w, f"{path}.{name}")
        elif isinstance(g, torch.dtype):
            assert str(g).removeprefix("torch.") == jnp.dtype(w).name, \
                f"{path}.{name}"
        else:
            assert g == w, f"{path}.{name}: {g!r} != {w!r}"


@pytest.mark.parametrize("name", PORTED)
def test_ported_specs_match_jax(name):
    got, want = T.get_arch(name), J.get_arch(name)
    assert (got.name, got.family, got.shapes, got.skip_shapes) == \
        (want.name, want.family, want.shapes, want.skip_shapes)
    assert T.arch_cells(name) == J.arch_cells(name)
    _same_fields(got.config, want.config, f"{name}.config")
    _same_fields(got.smoke, want.smoke, f"{name}.smoke")


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        T.get_arch("bert-base")


# ---------------------------------------------------------------------------
# The drivers, at --device cpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["prettr-bert", "gemma3-4b"])
def test_train_driver_trains_and_resumes(arch, tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--arch", arch, "--device", "cpu", "--ckpt-dir", ck,
              "--ckpt-every", "2", "--eval-every", "2", "--batch", "4"]
    first = train.main(common + ["--steps", "4"])
    assert first["start"] == 0 and np.isfinite(first["loss_last"])
    assert latest_step(ck) == 3
    resumed = train.main(common + ["--steps", "6", "--resume"])
    assert resumed["start"] == 4
    assert int(resumed["state"]["opt"]["step"]) == 6
    # the resumed run draws the batches the uninterrupted run would have
    whole = train.main(["--arch", arch, "--device", "cpu", "--ckpt-dir",
                        str(tmp_path / "whole"), "--ckpt-every", "100",
                        "--eval-every", "100", "--batch", "4", "--steps",
                        "6"])
    assert resumed["loss_last"] == pytest.approx(whole["loss_last"],
                                                 rel=2e-5, abs=2e-5)
    if arch == "prettr-bert":
        assert 0.0 <= resumed["best_p20"] <= 1.0


def test_train_driver_refuses_a_recsys_arch(tmp_path):
    with pytest.raises(SystemExit, match="recsys"):
        train.main(["--arch", "deepfm", "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


def test_eval_quality_driver(tmp_path):
    out = tmp_path / "q.json"
    dump = eval_quality.main(["--steps", "4", "--device", "cpu", "--n-docs",
                              "96", "--n-queries", "8", "--json", str(out)])
    assert len(dump) == 1
    saved = json.loads(out.read_text())
    for stage in ("first_stage", "rerank", "chance"):
        assert all(np.isfinite(v) for v in saved[stage].values()), stage
    assert {"p@20", "hit@10"} <= set(saved["rerank"]) \
        and {"p@20", "hit@10"} <= set(saved["chance"])
    assert saved["meta"]["codec"] == "fp16"


def test_build_index_driver_distills_then_builds(tmp_path, capsys):
    build_index.main(["--out", str(tmp_path / "idx"), "--n-docs", "48",
                      "--distill-steps", "2", "--device", "cpu",
                      "--verify"])
    out = capsys.readouterr().out
    assert "distilled compressor 2 steps: attn-MSE" in out
    assert "byte-identical" in out
