"""The transformer over an SPMD mesh: the :class:`Route` that
:func:`repro_torch.models.transformer.forward` and ``causal_lm_loss``
take when the installed rules' mesh is an
:class:`~repro_torch.dist.compat.SpmdMesh`.  It computes what the JAX
package computes when GSPMD lays the model out by ``default_rules``
(``repro.dist.sharding``), with the collectives written out
(:mod:`repro_torch.dist.spmd`).  The blocks, the layer loop and the
chunked loss are the transformer's own; this module gives them a rank's
views of the weights and the collectives around the parts that the
ranks of ``model`` split (``transformer.Local`` lists the hooks).

Each rank holds its shards of the parameters (``dist.spmd.shard_tree``
over :func:`~repro_torch.models.transformer.param_axes`) and its data
group's rows of the batch:

* **FSDP.** Every dim sharded over the data axes (the ``embed`` dims) is
  all-gathered just before its layer runs, and its gradient
  reduce-scattered; a leaf the data axes do not cut has its gradient
  all-reduced over them.  With a gradient each layer runs under
  ``torch.utils.checkpoint``, so the gathers are made again in the
  backward pass and a rank holds its shards plus one gathered layer.
* **Tensor parallelism over ``model``.**  Where ``model`` divides the
  query heads, each rank runs its own heads: ``wq`` / ``wk`` / ``wv``
  column blocks, attention through the ``attn_impl`` backend on the
  local heads (``"cuda"``: the split-attention kernel), ``wo`` row
  blocks and an all-reduce.  Query head ``h`` reads kv head ``h //
  (Hq / Hkv)``: a rank takes the kv heads its query heads read, whole,
  wherever the rules cut the kv columns (a kv head that several ranks
  share is gathered whole, and their gradients summed).  The MLP runs
  column / row parallel where ``model`` divides ``d_ff``; row-parallel
  biases are added once, after the all-reduce.
* **Vocab over ``model``.**  The token lookup is masked to the rank's
  rows and all-reduced; the (tied) head is the rank's rows, and the
  chunked cross-entropy takes a vocab-parallel logsumexp and gold logit
  in float32 (max, sum-exp and gold reduced over ``model``).  A vocab
  that ``model`` does not divide stays replicated: the lookup runs whole
  and the head takes an uneven slice of the rows.
* **Batch over the data axes.**  The loss is the global masked mean: its
  numerator and count are all-reduced.
* **MoE.**  The experts' ``embed`` dim is gathered like any other; the
  FFN then runs expert-parallel where E divides ``model``, column / row
  parallel over ``d_ff`` with an all-reduce where ``d_ff`` takes
  ``model`` (``moe.moe_ffn(..., model_cut=...)``), its collectives
  autograd's, so the MoE blocks train as the dense ones do.
* **Decode.**  With ``collect_cache`` a rank keeps the K/V of its own kv
  heads; :func:`cache_block` gives a rank's ``[L, B / data, S,
  Hkv_local, Dh]`` block of a whole cache, and ``decode_step`` runs each
  rank's query heads against it, then gathers the vocab-parallel logits
  whole (:meth:`Route.full_logits`).  JAX's ``DECODE_CACHE_AXES`` cut the
  cache's sequence over ``model`` instead; that would need a
  log-sum-exp merge of partial attentions across ranks, which the decode
  kernel does not return.

Rules that cut the batch over ``model`` as well
(``replicated_serving_rules``) give every rank its own rows with whole
weights: there the model runs as in one process (:func:`active_mesh` is
None).  A dim the rules leave whole on a rank is used whole; work that
``model`` does not split (heads it does not divide, a ``d_ff`` it does
not divide) runs on every model rank alike, with no collective.  The
residual stream is whole on every rank of a data group: JAX's
``act_shard`` constraints only place its bytes.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.dist import spmd as S
from repro_torch.dist.compat import SpmdMesh, axis_index
from repro_torch.dist.context import current_rules, install_rules
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

MODEL = ("model",)


def active_mesh():
    """The installed rules' mesh when it is an SPMD mesh whose ``model``
    ranks share a data group's rows, else None."""
    rules = current_rules()
    if rules is not None and isinstance(rules.mesh, SpmdMesh) \
            and "model" not in rules.mesh_axes("batch"):
        return rules.mesh
    return None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one rank splits the work of a config on a mesh."""
    mesh: object
    model: tuple            # ("model",) when the mesh has a model axis > 1
    attn_split: bool
    q_cols: tuple           # (start, length) of the local query columns
    kv_cols: object         # (start, length), or a LongTensor of columns
    local: object           # the config at the local head / d_ff counts
    mlp_split: bool
    f_cols: tuple
    vocab_split: bool
    vocab: tuple            # (start, length) of the local vocab rows


def plan(cfg, mesh) -> Plan:
    m = mesh.shape.get("model", 1)
    j = axis_index(mesh, "model") if m > 1 else 0
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    attn_split = m > 1 and hq % m == 0
    hl = hq // m if attn_split else hq
    h0 = j * hl if attn_split else 0
    group = hq // hkv
    kv = [h // group for h in range(h0, h0 + hl)]
    uniq = sorted(set(kv))
    per = hl // len(uniq) if hl % len(uniq) == 0 else 0
    if per and kv == [uniq[i // per] for i in range(hl)]:
        # whole GQA groups: the kv heads the local query heads read
        kv_cols, n_kv = (uniq[0] * dh, len(uniq) * dh), len(uniq)
    else:
        # query heads that straddle kv groups: one kv head a query head
        kv_cols = torch.tensor([k * dh + i for k in kv for i in range(dh)])
        n_kv = hl
    mlp_split = m > 1 and not cfg.n_experts and cfg.d_ff % m == 0
    fl = cfg.d_ff // m if mlp_split else cfg.d_ff
    vl = -(-cfg.vocab_size // m)
    v0 = min(j * vl, cfg.vocab_size)
    local = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=n_kv,
                                head_dim=dh, d_ff=fl)
    return Plan(mesh, MODEL if m > 1 else (), attn_split,
                (h0 * dh, hl * dh), kv_cols, local, mlp_split,
                (j * fl if mlp_split else 0, fl), m > 1,
                (v0, min(vl, cfg.vocab_size - v0)))


def lm_init(cfg, generator, device):
    """``(params, axes)`` of a transformer config."""
    return T.init_params(cfg, generator, device), T.param_axes(cfg)


@functools.lru_cache(maxsize=32)
def _specs(init, cfg, mesh_shape: tuple, rules_items: tuple):
    """The PartitionSpec tree of the whole params ``init(cfg, generator,
    device) -> (params, axes)`` makes (cached: the shapes come from an
    init under FakeTensorMode)."""
    from repro_torch.dist.compat import AbstractMesh
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.steps import eval_params

    shapes, axes = eval_params(lambda g, d: init(cfg, g, d))
    names, sizes = zip(*mesh_shape)
    rules = ShardingRules(AbstractMesh(sizes, names), dict(rules_items))
    return S.tree_specs(shapes, axes, rules)


def param_specs(cfg, rules, init=lm_init):
    """The ``PartitionSpec`` of every leaf of the params that ``init``
    makes for ``cfg`` (default: a transformer's) under ``rules``."""
    return _specs(init, cfg, tuple(rules.mesh.shape.items()),
                  tuple(sorted(rules.rules.items())))


def _kv_heads(p: Plan, dh: int):
    """The kv heads a rank's query heads read: a ``(start, length)``
    block or a LongTensor of heads."""
    if isinstance(p.kv_cols, tuple):
        return p.kv_cols[0] // dh, p.kv_cols[1] // dh
    return p.kv_cols.reshape(-1, dh)[:, 0] // dh


def cache_block(x, cfg, mesh):
    """This rank's block ``[L, B / data, S, Hkv_local, Dh]`` of a whole
    ``[L, B, S, Hkv, Dh]`` K or V cache of ``cfg`` on ``mesh``: its data
    group's rows and the kv heads its query heads read (a kv head that
    several ranks read held whole by each).  The layout that
    ``forward(collect_cache=True)`` returns and ``decode_step`` takes
    under the sharded route.  A batch the data axes do not divide is
    whole on every rank (its spec replicates it)."""
    if x.shape[1] % mesh.axis_size(S.data_axes(mesh)) == 0:
        x = S.data_block(x, mesh, dim=1)
    return _take(x, 3, _kv_heads(plan(cfg, mesh), cfg.dh)).contiguous()


# ---------------------------------------------------------------------------
# A rank's view of a leaf
# ---------------------------------------------------------------------------


def _take(w, dim, index):
    if isinstance(index, tuple):
        return w.narrow(dim, *index)
    return w.index_select(dim, index.to(w.device))


def _model_view(w, spec, p: Plan, *, split: bool, dim=None, index=None):
    """What a rank computes with from ``w`` (its data dims gathered).
    ``split``: the ranks of ``model`` do different parts of the work, and
    this rank takes ``index`` (a ``(start, length)`` block or a column
    list) along ``dim`` of the whole leaf; else every rank uses the whole
    leaf alike."""
    mesh = p.mesh
    dims = [d for d, e in enumerate(spec) if S.entry_axes(e) == MODEL]
    if not split:
        for d in dims:
            w = S.all_gather(w, d, mesh, MODEL, backward="split")
        return w
    if dims:
        (d,) = dims
        if d == dim and isinstance(index, tuple):
            i, n = S.block(mesh, MODEL)
            if index == (i * w.shape[d], w.shape[d]):
                return w                       # the stored block itself
        w = S.all_gather(w, d, mesh, MODEL, backward="sum")
    else:
        w = S.copy_to(w, mesh, MODEL)
    return w if dim is None else _take(w, dim, index)


def _view(w, spec, p: Plan, **kw):
    return _model_view(S.gather_data_dims(w, spec, p.mesh), spec, p, **kw)


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


class Route(T.Local):
    """The transformer's hooks on this rank of the installed rules' SPMD
    mesh: ``params`` are its shards, ``tokens`` its data group's rows.
    Made once a forward or loss call (it keeps the gathered token table
    that the lookup and the tied head share).  ``specs``: the
    transformer's spec tree when its params sit inside a larger model's
    (PreTTR's backbone), and ``extra`` the spec trees of that model's
    other params, by key (:meth:`whole`)."""

    def __init__(self, cfg, specs=None, extra=None):
        self.rules = rules = current_rules()
        self.specs = param_specs(cfg, rules) if specs is None else specs
        self.extra = extra or {}
        self.p = plan(cfg, rules.mesh)
        self.mesh = rules.mesh
        self._split = {"attn": self.p.attn_split, "ffn": self.p.mlp_split,
                       "vocab": self.p.vocab_split}
        self.v0 = self.p.vocab[0] if self.p.vocab_split else 0
        self.moe_cut = None
        if cfg.n_experts and self.p.model:
            # which dim of the expert weights ``model`` cut
            e, _, f = (S.entry_axes(a) == MODEL for a in
                       self.specs["layers"][0]["moe"]["w_gate"])
            self.moe_cut = "experts" if e else "ff" if f else None
        self._table = None

    def local(self, cfg):
        return self.p.local

    def run(self, fn, x):
        from torch.utils.checkpoint import checkpoint

        # the layer's gathers are made again in the backward pass
        if torch.is_grad_enabled():
            return checkpoint(self._under_rules, fn, x, use_reentrant=False)
        return fn(x)

    def _under_rules(self, fn, x):
        # the recomputation runs on autograd's own thread on the card,
        # where the thread-local rules (which moe_ffn reads) are not
        # installed
        with install_rules(self.rules):
            return fn(x)

    def enter(self, x, part):
        return S.copy_to(x, self.mesh, MODEL) if self._split[part] else x

    def leave(self, x, part):
        return S.all_reduce_sum(x, self.mesh, MODEL) if self._split[part] \
            else x

    def _whole(self, tree, specs):
        """Leaves every model rank uses alike, their data dims
        gathered."""
        return {k: S.whole_leaf(v, specs[k], self.mesh)
                for k, v in tree.items()}

    def layer(self, i, lp):
        specs, p = self.specs["layers"][i], self.p
        out = {k: self._whole(lp[k], specs[k])
               for k in ("ln1", "ln2", "ln1_post", "ln2_post") if k in lp}
        cols = {"wq": (1, p.q_cols), "wk": (1, p.kv_cols),
                "wv": (1, p.kv_cols), "wo": (0, p.q_cols),
                "bq": (0, p.q_cols), "bk": (0, p.kv_cols),
                "bv": (0, p.kv_cols)}
        out["attn"] = {k: _view(v, specs["attn"][k], p, split=p.attn_split,
                                **(dict(zip(("dim", "index"), cols[k]))
                                   if p.attn_split and k in cols else {}))
                       for k, v in lp["attn"].items()}
        if "moe" in lp:
            out["moe"] = {k: S.gather_data_dims(v, specs["moe"][k], self.mesh)
                          for k, v in lp["moe"].items()}
        else:
            rows = {"w_gate": 1, "w_up": 1, "w_in": 1, "b_in": 0,
                    "w_down": 0, "w_out": 0}
            out["mlp"] = {k: _view(v, specs["mlp"][k], p,
                                   split=p.mlp_split and k in rows,
                                   dim=rows.get(k) if p.mlp_split else None,
                                   index=p.f_cols)
                          for k, v in lp["mlp"].items()}
        return out

    def _tokens(self, params):
        """The token table with its data dims gathered: this rank's vocab
        rows where the rules cut the vocab over ``model``, else the whole
        table."""
        if self._table is None:
            self._table = S.gather_data_dims(params["embed"]["tokens"],
                                       self.specs["embed"]["tokens"],
                                       self.mesh)
        return self._table

    def _vocab_cut(self):
        return S.entry_axes(self.specs["embed"]["tokens"][0]) == MODEL

    def embed_params(self, params):
        rest = {k: v for k, v in params["embed"].items() if k != "tokens"}
        return {"tokens": self._tokens(params),
                **self._whole(rest, self.specs["embed"])}

    def lookup(self, table, tokens):
        if not self._vocab_cut():
            return table[tokens]
        # the rank's rows; the others' are all-reduced in
        v0 = table.shape[0] * S.block(self.mesh, MODEL)[0]
        inside = (tokens >= v0) & (tokens < v0 + table.shape[0])
        x = table[torch.where(inside, tokens - v0, 0)] \
            * inside[..., None].to(table.dtype)
        return S.all_reduce_sum(x, self.mesh, MODEL)

    def final_norm(self, params):
        return self._whole(params["final_norm"], self.specs["final_norm"])

    def head(self, params, cfg):
        """This rank's columns of the LM head ``[d, v]`` in the compute
        dtype: the rows ``p.vocab`` of the whole vocab (every row on one
        model rank)."""
        p, split = self.p, self.p.vocab_split
        if cfg.tie_embeddings:
            w = _model_view(self._tokens(params),
                            self.specs["embed"]["tokens"], p, split=split,
                            dim=0 if split else None, index=p.vocab).T
        else:
            w = _view(params["lm_head"], self.specs["lm_head"], p,
                      split=split, dim=1 if split else None, index=p.vocab)
        return w.to(cfg.compute_dtype)

    def full_logits(self, lg):
        """``[N, V_local]`` float32 logits of this rank's vocab rows ->
        ``[N, V]``: gathered over ``model`` (no gradient), the last
        rank's short block padded for the gather and cut after."""
        if not self.p.vocab_split:
            return lg
        m = self.mesh.shape["model"]
        width = -(-self.p.local.vocab_size // m)
        pad = lg.new_zeros((lg.shape[0], width - lg.shape[1]))
        with torch.no_grad():
            full = S._gather(torch.cat([lg, pad], 1), 1, self.mesh, MODEL)
        return full[:, :self.p.local.vocab_size]

    def whole(self, tree, key):
        """``tree`` (this rank's shards of the params ``extra[key]``
        specifies) with every dim gathered, as each rank uses it alike."""
        return tree_map(lambda v, spec: S.whole_leaf(v, spec, self.mesh),
                        tree, self.extra[key])

    def logsumexp(self, lg):
        """A float32 logsumexp over the vocab columns of every model
        rank (max and sum-exp reduced over ``model``)."""
        if not self.p.vocab_split:
            return super().logsumexp(lg)
        top = S.all_reduce_max(lg.max(dim=-1).values, self.mesh, MODEL)
        sumexp = S.all_reduce_sum(
            torch.exp(lg - top[..., None]).sum(dim=-1), self.mesh, MODEL)
        return top + torch.log(sumexp)

    def gold(self, lg, y):
        """The label's logit, from the model rank whose columns hold
        it."""
        if not self.p.vocab_split:
            return super().gold(lg, y)
        inside = (y >= self.v0) & (y < self.v0 + lg.shape[-1])
        gold = super().gold(lg, torch.where(inside, y - self.v0, 0))
        return S.all_reduce_sum(torch.where(inside, gold, 0.0), self.mesh,
                                MODEL)

    def data_sum(self, x):
        return S.all_reduce_sum(x, self.mesh, S.data_axes(self.mesh))
