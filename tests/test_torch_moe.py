"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU: ``init_moe``'s tree, the
per-group dispatch (ranks, keeps and the buffer bit for bit),
``moe_ffn``'s output and aux loss over capacity factors that drop no
slot (8.0), some (1.25) and many (0.5), one and four dispatch groups and
a token count four does not divide, and the gradients.

Weights come from JAX ``init_moe``; inputs are made with numpy from a
seed.  Tolerances follow the JAX tests: rtol = atol = 2e-5 in float32
(``tests/test_kernels.py``), 2e-2 in bfloat16."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as JM
from repro_torch.models import moe as TM

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
D, F, E, K = 32, 48, 8, 2


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _params(seed=0):
    jp, _ = JM.init_moe(jax.random.PRNGKey(seed), D, F, E, jnp.float32)
    return {k: np.asarray(v) for k, v in jp.items()}


def _torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in tree.items()}


def _jax(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _x(t, seed=1):
    return np.random.default_rng(seed).standard_normal((t, D)) \
        .astype(np.float32)


def test_init_moe_matches_the_jax_tree():
    tp = TM.init_moe(D, F, E, torch.float32, torch.Generator().manual_seed(0),
                     device="cpu")
    jp = _params()
    assert {k: tuple(v.shape) for k, v in tp.items()} \
        == {k: v.shape for k, v in jp.items()}
    for name, scale in (("router", 0.02), ("w_gate", D ** -0.5),
                        ("w_up", D ** -0.5), ("w_down", F ** -0.5)):
        assert float(tp[name].std()) == pytest.approx(scale, rel=0.1), name
        assert float(jp[name].std()) == pytest.approx(scale, rel=0.1), name
    bf = TM.init_moe(D, F, E, torch.bfloat16,
                     torch.Generator().manual_seed(0), device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf.values())


@pytest.mark.parametrize("capacity", [4, 9, 64])
def test_dispatch_group_matches_jax_bit_for_bit(capacity):
    """Ranks in flat (token-major, slot-minor) order from a stable sort;
    slots at rank >= C dropped (safe_rank = C) and absent from the
    buffer."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, D)).astype(np.float32)
    experts = np.stack([rng.choice(E, K, replace=False) for _ in range(40)]) \
        .astype(np.int32)
    jb, jr, jk = JM._dispatch_group(jnp.asarray(x), jnp.asarray(experts),
                                    capacity, E)
    tb, tr, tk = TM._dispatch_group(torch.from_numpy(x),
                                    torch.from_numpy(experts).long(),
                                    capacity, E)
    assert tuple(tb.shape) == jb.shape == (E, capacity, D)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert bool((~tk).any()) == (capacity < 40 * K // E)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_groups", [1, 4])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
@pytest.mark.parametrize("t", [64, 30])
def test_moe_ffn_matches_jax(t, cf, n_groups, dtype):
    """Output and aux loss; T = 30 is not a multiple of 4, so four groups
    fall back to one; at 0.5 slots are dropped."""
    params, x = _params(), _x(t)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    jo, ja = JM.moe_ffn(_jax(params, jdt), jnp.asarray(x, jdt), top_k=K,
                        capacity_factor=cf, n_groups=n_groups)
    to, ta = TM.moe_ffn(_torch(params, tdt), torch.from_numpy(x).to(tdt),
                        top_k=K, capacity_factor=cf, n_groups=n_groups)
    assert to.dtype == tdt and tuple(to.shape) == (t, D)
    assert ta.dtype == torch.float32 and ta.shape == ()
    np.testing.assert_allclose(_np(to), _np(jo), **TOL[dtype])
    np.testing.assert_allclose(float(ta), float(ja), **TOL[dtype])
    if cf == 0.5:
        # the capacity really drops slots: zero rows in the combine, and
        # a result unlike the no-drop one
        full, _ = TM.moe_ffn(_torch(params), torch.from_numpy(x), top_k=K,
                             capacity_factor=8.0, n_groups=n_groups)
        assert not np.allclose(_np(to), _np(full), atol=0.1)


def test_groups_fall_back_to_one_when_t_is_not_divisible():
    params, x = _torch(_params()), torch.from_numpy(_x(30))
    one, a1 = TM.moe_ffn(params, x, top_k=K, capacity_factor=1.25)
    four, a4 = TM.moe_ffn(params, x, top_k=K, capacity_factor=1.25,
                          n_groups=4)
    assert torch.equal(one, four) and torch.equal(a1, a4)


def test_moe_ffn_gradients_match_jax():
    """d(sum(out * r) + aux) by x and every weight, at a capacity that
    drops slots (their gradient is 0 in both)."""
    params, x = _params(), _x(32)
    r = np.random.default_rng(3).standard_normal((32, D)).astype(np.float32)

    def jloss(p, xx):
        out, aux = JM.moe_ffn(p, xx, top_k=K, capacity_factor=0.5)
        return jnp.sum(out * r) + aux

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        _jax(params), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _torch(params).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TM.moe_ffn(tp, tx, top_k=K, capacity_factor=0.5)
    loss = (out * torch.from_numpy(r)).sum() + aux
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               **TOL["float32"])
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), **TOL["float32"])
    for k in tp:
        np.testing.assert_allclose(_np(tp[k].grad), _np(jg[k]),
                                   **TOL["float32"], err_msg=k)
