"""The port's recsys cells (``launch.steps.make_recsys_cell``) against the
JAX package's, in one process on the CPU: one cell of each kind and
family at the smoke configs, the JAX cell's own function (built by
``repro.launch.steps.make_recsys_cell`` on a one-device mesh) and the
port's cell run on the same inputs (the port's ``cell_inputs``, batch
cut to 8) and the
same weights (JAX's init carried over by ``bridge``).

* ``rec_train``: DLRM (``bag_impl`` "plain" and "cuda", whose lookups
  run the kernel wrapper forward, its plain version on these CPU
  tensors, and the plain gradient backward), xDeepFM and BERT4Rec (at a
  40-slot sequence: the Cloze loss takes 32 masked slots): loss,
  ``grad_norm`` and every leaf of the updated state;
* ``rec_serve``: DeepFM's logits, float32 and bf16 compute; BERT4Rec's
  top-k values, and its ids wherever the values are not tied;
* ``rec_retrieval``: DLRM's scores of its published single user over
  the published 1,000,192 candidates.

Limits: rtol = atol = 2e-5 in float32, 2e-2 in bf16
(``tests/test_kernels.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.dist import sharding as JS
from repro.launch import steps as JST
from repro.models.recsys import bert4rec as JB
from repro.models.recsys import deepfm as JF
from repro.models.recsys import dlrm as JD
from repro.optim import adam as JA
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.dist import default_rules
from repro_torch.dist.compat import AbstractMesh
from repro_torch.launch import steps as ST
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ONE = default_rules(AbstractMesh((1, 1), ("data", "model")))
BATCH = 8
# BERT4Rec's Cloze loss takes 32 masked slots: a sequence that holds them
BERT4REC_TRAIN_SEQ = 40


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(
        a, np.float32 if jnp.issubdtype(a.dtype, jnp.floating) else None),
        tree)


def _j(x):
    if isinstance(x, dict):
        return {k: _j(v) for k, v in x.items()}
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _close(got, want, what, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               err_msg=what, **tol)


def _cells(arch, shape, seed, batch=BATCH, **over):
    """The JAX cell and the port's at ``arch``'s smoke config (``over``'s
    fields replaced in both; ``compute_dtype`` by name, ``bag_impl`` in
    the port's alone), the port's whole inputs, the JAX weights and the
    port's config."""
    dt = over.pop("compute_dtype", None)
    base = jax_arch(arch).smoke
    jcfg = dataclasses.replace(base, **{k: v for k, v in over.items()
                                        if hasattr(base, k)})
    tcfg = dataclasses.replace(get_arch(arch).smoke, **over)
    if dt is not None:
        jcfg = dataclasses.replace(jcfg, compute_dtype=getattr(jnp, dt))
        tcfg = dataclasses.replace(tcfg, compute_dtype=getattr(torch, dt))
    jrules = JS.default_rules(jax.make_mesh((1, 1), ("data", "model")))
    jcell = JST.make_recsys_cell(dataclasses.replace(jax_arch(arch),
                                                     config=jcfg),
                                 shape, jrules)
    cell = ST.build_spec_cell(dataclasses.replace(get_arch(arch),
                                                  smoke=tcfg),
                              shape, ONE, smoke=True, batch=batch)
    assert cell.kind == jcell.kind
    init = {"dlrm-mlperf": JD.init_dlrm, "bert4rec": JB.init_bert4rec}.get(
        arch, JF.init_deepfm)
    out = init(jax.random.PRNGKey(seed), jcfg)
    jp = out[0] if isinstance(out, tuple) else out
    args = ST.cell_inputs(cell, torch.Generator().manual_seed(seed), "cpu",
                          whole=True)
    return jcell, cell, args[1:], jp, tcfg


def _params(jp, cfg):
    if hasattr(cfg, "backbone"):
        return bridge.bert4rec_params_from_jax(_np32(jp), cfg, device="cpu")
    return bridge.recsys_params_from_jax(_np32(jp), cfg, device="cpu")


def _close_trees(got, want):
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert sorted(g) == sorted(w)
    for k in w:
        _close(g[k], w[k].float() if w[k].is_floating_point() else w[k], k)


@pytest.mark.parametrize("arch,over", [
    ("dlrm-mlperf", {"bag_impl": "plain"}),
    ("dlrm-mlperf", {"bag_impl": "cuda"}),
    ("xdeepfm", {"bag_impl": "cuda"}),
    ("bert4rec", {"seq_len": BERT4REC_TRAIN_SEQ})], ids=str)
def test_recsys_train_cell_matches_jax_step(arch, over):
    jcell, cell, (batch,), jp, tcfg = _cells(arch, "train_batch", 0,
                                             **over)
    jstate = {"params": jp,
              "opt": JA.init_opt_state(jp, JA.OptimizerConfig())}
    state = bridge.train_state_from_jax(_np32(jstate), tcfg, device="cpu")
    new, out = cell.fn(state, batch)
    wnew, wout = jax.jit(jcell.fn)(jstate, _j(batch))
    _close(out["loss"], wout["loss"], "loss")
    _close(out["grad_norm"], wout["grad_norm"], "grad_norm")
    _close_trees(new, bridge.train_state_from_jax(_np32(wnew), tcfg,
                                                  device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepfm_serve_cell_matches_jax(dtype):
    jcell, cell, (batch,), jp, tcfg = _cells("deepfm", "serve_p99", 1,
                                             compute_dtype=dtype)
    got = cell.fn(_params(jp, tcfg), batch)
    want = jax.jit(jcell.fn)(jp, _j(batch))
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    _close(got, want, "logits", TOL if dtype == "float32" else BF16_TOL)


def test_dlrm_retrieval_cell_matches_jax():
    jcell, cell, (bt, iv), jp, tcfg = _cells("dlrm-mlperf",
                                             "retrieval_cand", 2, batch=None)
    assert iv.shape == (1_000_192, tcfg.embed_dim)
    got = cell.fn(_params(jp, tcfg), bt, iv)
    want = jax.jit(jcell.fn)(jp, _j(bt), _j(iv))
    assert got.shape == (1, 1_000_192)
    _close(got, want, "scores")


def test_bert4rec_serve_cell_matches_jax_topk():
    jcell, cell, (seq, valid), jp, tcfg = _cells("bert4rec", "serve_p99", 3)
    # [MASK] at each row's last valid slot, items elsewhere in the prefix
    last = valid.sum(1) - 1
    assert (seq[torch.arange(BATCH), last] == 1).all()
    assert ((seq >= 2) == (valid & (seq != 1))).all()
    gv, gi = cell.fn(_params(jp, tcfg), seq, valid)
    wv, wi = jax.jit(jcell.fn)(jp, _j(seq), _j(valid))
    assert gv.shape == gi.shape == (BATCH, 100)
    _close(gv, wv, "values")
    wv, wi, gi = np.asarray(wv), np.asarray(wi), gi.numpy()
    gap = np.minimum(np.abs(np.diff(wv, prepend=np.inf, axis=1)),
                     np.abs(np.diff(wv, append=-np.inf, axis=1)))
    apart = gap > 1e-4
    assert apart.mean() > 0.5
    np.testing.assert_array_equal(gi[apart], wi[apart])
