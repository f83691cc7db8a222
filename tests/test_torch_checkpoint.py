"""The port's checkpoint store against the JAX package's on the CPU: the
four cases of tests/test_checkpoint.py run against the port; the two
stores write the same bytes for the same tree (manifest and leaves, bf16
leaves as raw 2-byte words), and each restores what the other wrote;
``bridge.read_jax_checkpoint`` + ``train_state_from_jax`` resume a JAX
PreTTR train state, and the port's next training step matches the JAX
package's.

Restores are bit-equal; the training step holds to rtol = atol = 2e-5
(float32, tests/test_kernels.py)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import prettr_bert as jax_prettr_cfg
from repro.core import prettr as JP
from repro.optim import adam as JA
from repro_torch import bridge
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import prettr_bert as prettr_cfg
from repro_torch.data.synthetic_ir import SyntheticIRWorld
from repro_torch.launch.train import batch_tensors, prettr_train_step
from repro_torch.optim import OptimizerConfig
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=2e-5, atol=2e-5)


def _tree(step):
    return {"params": {"w": torch.full((4, 3), float(step)),
                       "b": torch.arange(3.0)},
            "opt": {"step": torch.tensor(step, dtype=torch.int32)}}


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, against the port
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 10, _tree(10))
    save_checkpoint(d, 20, _tree(20))
    assert latest_step(d) == 20
    restored, step = restore_checkpoint(d, _tree(0))
    assert step == 20
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((4, 3), 20.0))
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 20


def test_corruption_fallback(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    path2 = save_checkpoint(d, 2, _tree(2))
    # corrupt one leaf of step 2 (a torn write on a failed node)
    with open(os.path.join(path2, "leaf_00000.bin"), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    restored, step = restore_checkpoint(d, _tree(0))
    assert step == 1, "must fall back past the corrupt checkpoint"
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((4, 3), 1.0))


def test_restore_empty_dir(tmp_path):
    target = _tree(0)
    restored, step = restore_checkpoint(str(tmp_path / "nope"), target)
    assert step is None and restored is target


def test_async_checkpointer_and_gc(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    ck.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d))
    assert steps == [3, 4], f"GC should keep last 2, got {steps}"
    restored, step = restore_checkpoint(d, _tree(0))
    assert step == 4


# ---------------------------------------------------------------------------
# The port's own guarantees
# ---------------------------------------------------------------------------


def test_async_save_snapshots_before_it_returns(tmp_path):
    """The update mutates nothing the snapshot shares: a tensor changed in
    place right after ``save`` returns is written as it was."""
    d = str(tmp_path)
    tree = _tree(5)
    ck = AsyncCheckpointer(d)
    ck.save(5, tree)
    tree["params"]["w"].fill_(-1.0)
    ck.wait()
    restored, _ = restore_checkpoint(d, _tree(0))
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((4, 3), 5.0))


def test_restore_is_bit_equal_across_dtypes_and_lists(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"layers": [{"w": torch.randn(3, 5, generator=g),
                        "h": torch.randn(4, generator=g).bfloat16()}
                       for _ in range(3)],
            "ids": torch.randint(0, 9, (6,), generator=g),
            "f16": torch.randn(2, 2, generator=g).half(),
            "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 7, tree)
    target = jax.tree.map(torch.zeros_like, tree)
    restored, step = restore_checkpoint(str(tmp_path), target)
    assert step == 7
    got, want = (dict(leaves_with_paths(t)) for t in (restored, tree))
    assert sorted(got) == sorted(want)
    assert "layers/2/h" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_async_checkpointer_raises_what_its_write_raised(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, _tree(1))
    with pytest.raises(OSError):
        ck.wait()


# ---------------------------------------------------------------------------
# The two packages' stores
# ---------------------------------------------------------------------------


def _flat_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "ids": rng.integers(0, 100, (5,)).astype(np.int32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "step": np.asarray(3, np.int32)}


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def test_both_stores_write_the_same_bytes(tmp_path):
    tree = _flat_tree()
    p_jax = jax_save(str(tmp_path / "jax"), 3,
                     jax.tree.map(jnp.asarray, tree))
    p_port = save_checkpoint(str(tmp_path / "port"), 3,
                             {k: torch.from_numpy(v) for k, v in
                              tree.items()})
    assert os.path.basename(p_jax) == os.path.basename(p_port) \
        == "step_00000003"
    assert _files(p_port) == _files(p_jax)


def test_bf16_leaves_are_written_as_the_jax_store_writes_them(tmp_path):
    """Raw 2-byte words with dtype.str '<V2' in both; the port restores
    the JAX-written leaf into a bf16 target bit for bit.  (The JAX reader
    cannot restore such a leaf: np.frombuffer gives it a void array.)"""
    x = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    p_jax = jax_save(str(tmp_path / "jax"), 1,
                     {"h": jnp.asarray(x).astype(jnp.bfloat16)})
    t = torch.from_numpy(x).bfloat16()
    p_port = save_checkpoint(str(tmp_path / "port"), 1, {"h": t})
    assert _files(p_port) == _files(p_jax)
    restored, step = restore_checkpoint(
        str(tmp_path / "jax"), {"h": torch.zeros(3, 4, dtype=torch.bfloat16)})
    assert step == 1 and torch.equal(restored["h"], t)


def test_each_package_restores_the_others_checkpoint(tmp_path):
    tree = _flat_tree()
    save_checkpoint(str(tmp_path / "port"), 4,
                    {k: torch.from_numpy(v) for k, v in tree.items()})
    got, step = jax_restore(str(tmp_path / "port"),
                            jax.tree.map(jnp.zeros_like, tree))
    assert step == 4
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    jax_save(str(tmp_path / "jax"), 6, jax.tree.map(jnp.asarray, tree))
    got, step = restore_checkpoint(
        str(tmp_path / "jax"),
        {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype)
         for k, v in tree.items()})
    assert step == 6
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """A JAX PreTTR train state after two steps, saved by the JAX store
    (then a corrupt newer step), is read by ``read_jax_checkpoint``,
    bridged by ``train_state_from_jax``, and one more step in each package
    agrees: loss, grad norm, params and optimizer state."""
    jcfg = jax_prettr_cfg.smoke_config(attn_impl="plain",
                                       compress_impl="plain")
    tcfg = prettr_cfg.smoke_config()
    world = SyntheticIRWorld(n_docs=32, n_queries=4, vocab_size=512,
                             doc_len=38, seed=5)
    opt_cfg = JA.OptimizerConfig()
    params, _ = JP.init_prettr(jax.random.PRNGKey(1), jcfg)
    opt = JA.init_opt_state(params, opt_cfg)

    @jax.jit
    def jstep(params, opt, pos, neg):
        loss, g = jax.value_and_grad(
            lambda p: JP.rank_pairs_loss(p, jcfg, pos, neg))(params)
        params, opt, gn = JA.adam_update(g, opt, params, opt_cfg,
                                         lr=opt_cfg.lr)
        return params, opt, loss, gn

    def batch(i):
        return world.pair_batch(np.random.default_rng(i), 4,
                                tcfg.max_query_len, tcfg.max_doc_len)

    for i in range(2):
        pos, neg = batch(i)
        params, opt, _, _ = jstep(params, opt,
                                  jax.tree.map(jnp.asarray, pos),
                                  jax.tree.map(jnp.asarray, neg))
    d = str(tmp_path / "ck")
    jax_save(d, 1, {"params": params, "opt": opt})
    torn = jax_save(d, 2, {"params": params, "opt": opt})
    os.remove(os.path.join(torn, "leaf_00003.bin"))

    tree, step = bridge.read_jax_checkpoint(d)
    assert step == 1
    state = bridge.train_state_from_jax(tree, tcfg, device="cpu")
    assert int(state["opt"]["step"]) == 2
    pos, neg = batch(2)
    jp, jo, jloss, jgn = jstep(params, opt, jax.tree.map(jnp.asarray, pos),
                               jax.tree.map(jnp.asarray, neg))
    tp, to, tloss, tgn = prettr_train_step(
        state["params"], state["opt"], tcfg, OptimizerConfig(),
        batch_tensors(pos, "cpu"), batch_tensors(neg, "cpu"))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(float(tgn), float(jgn), **TOL)
    assert int(to["step"]) == int(jo["step"]) == 3
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"]),
                      (to["master"], jo["master"])):
        want = dict(leaves_with_paths(bridge.params_from_jax(
            np_tree(want), tcfg, device="cpu")))
        for k, g in leaves_with_paths(got):
            np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                       err_msg=k, **TOL)
