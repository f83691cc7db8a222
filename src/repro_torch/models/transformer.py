"""Generic transformer LM / encoder, the port of ``repro.models.transformer``:
config, init, embeddings, Q/K/V projections with bias, qk-norm and RoPE,
the block tail with post-norms and the gated MLP or the MoE FFN
(``repro_torch.models.moe``), a plain Python loop over layers,
full-sequence ``forward``, ``logits`` and the KV-cache ``decode_step``.

Parameters are plain dicts of tensors; ``params["layers"]`` is a list with
one dict per layer (the JAX package stacks them on a leading axis;
``repro_torch.bridge`` slices them).  Because the layer loop is Python,
every layer hands its own static window and RoPE base to the backend, so
one ``forward`` runs gemma3's 5 local : 1 global pattern through the
kernels (the JAX ``pallas`` impl traces one scan body and takes uniform
layer ranges only; this computes what its ``plain``/``blocked`` impls
compute).  :func:`causal_lm_loss` is the training loss (through the
plain backend: the kernel wrappers refuse inputs that require grad).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import backend as B
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int | None = None          # defaults to d_model // n_heads
    # --- attention ---
    causal: bool = True
    window_pattern: tuple[int, ...] = (-1,)   # cycled over layers; -1 = global
    window_size: int = 1024                   # width used where pattern > 0
    rope: bool = True
    rope_base: float = 1e4
    rope_base_local: float | None = None      # base for windowed (local) layers
    rope_fraction: float = 1.0                # ChatGLM "2d" RoPE: 0.5
    use_qk_norm: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0           # read by nothing, as in JAX
    # --- norms / mlp ---
    norm: str = "rmsnorm"                     # "rmsnorm" | "layernorm"
    gated_mlp: bool = True
    activation: str = "silu"
    use_post_norm: bool = False               # Gemma-style post-block norms
    mlp_bias: bool = False
    # --- embeddings ---
    scale_embeddings: bool = False            # Gemma: x *= sqrt(d)
    learned_pos: int = 0                      # >0: learned positions (BERT)
    segment_vocab: int = 0                    # >0: segment embeddings (BERT)
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- execution ---
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "cuda"              # "plain" | "cuda" | "blocked"
    compress_impl: str = "cuda"          # "plain" | "cuda"
    # the KV block of "blocked" attention and of the "cuda" one's gradient
    block_kv: int = 512
    logits_chunk: int = 0                # the loss's seq chunk (training)
    # PreTTR hook: layers below split_layers mask query<->doc attention
    split_layers: int = 0

    def __post_init__(self):
        # unknown impl names fail here, not at the first forward
        B.validate_config(self.attn_impl, self.compress_impl)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_windows(self) -> list[int]:
        pat = [w if w <= 0 else self.window_size for w in self.window_pattern]
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def layer_rope_bases(self) -> list[float]:
        local = self.rope_base_local if self.rope_base_local \
            else self.rope_base
        return [local if w > 0 else self.rope_base
                for w in self.layer_windows()]

    def num_params(self) -> int:
        """Analytic parameter count (norms excluded), as the JAX config."""
        return self._count(self.n_experts)

    def num_active_params(self) -> int:
        return self._count(self.top_k)

    def _count(self, experts: int) -> int:
        d, dh = self.d_model, self.dh
        attn = d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
        if self.n_experts:
            ffn = experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the JAX ``init_params`` tree (a list of layer
    dicts instead of stacked leaves), scales and dtypes: dense weights
    ``N(0, 1/d_in)``, embeddings ``N(0, 0.02^2)``, RMSNorm and qk-norm
    scales 0, LayerNorm scales 1, biases 0.  Normals are drawn on
    ``generator``'s device, then moved to ``device`` (``None`` means the
    card)."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    d, dh = cfg.d_model, cfg.dh

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=pd)

    dense = lambda i, o: normal((i, o), 1.0 / math.sqrt(i))
    zeros = lambda n: torch.zeros((n,), device=dev, dtype=pd)

    def norm():
        if cfg.norm == "rmsnorm":
            return {"scale": zeros(d)}
        return {"scale": torch.ones((d,), device=dev, dtype=pd),
                "bias": zeros(d)}

    def layer():
        hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
        attn = {"wq": dense(d, hq), "wk": dense(d, hkv), "wv": dense(d, hkv),
                "wo": dense(hq, d)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(hq), bk=zeros(hkv), bv=zeros(hkv))
        if cfg.use_qk_norm:
            attn.update(q_norm=zeros(dh), k_norm=zeros(dh))
        p = {"attn": attn, "ln1": norm(), "ln2": norm()}
        if cfg.use_post_norm:
            p.update(ln1_post=norm(), ln2_post=norm())
        if cfg.n_experts:
            p["moe"] = moe_lib.init_moe(d, cfg.d_ff, cfg.n_experts, pd,
                                        generator, dev)
        elif cfg.gated_mlp:
            p["mlp"] = {"w_gate": dense(d, cfg.d_ff),
                        "w_up": dense(d, cfg.d_ff),
                        "w_down": dense(cfg.d_ff, d)}
        else:
            p["mlp"] = {"w_in": dense(d, cfg.d_ff),
                        "w_out": dense(cfg.d_ff, d)}
            if cfg.mlp_bias:
                p["mlp"].update(b_in=zeros(cfg.d_ff), b_out=zeros(d))
        return p

    layers = [layer() for _ in range(cfg.n_layers)]
    embed = {"tokens": normal((cfg.vocab_size, d), 0.02)}
    if cfg.learned_pos:
        embed["pos"] = normal((cfg.learned_pos, d), 0.02)
    if cfg.segment_vocab:
        embed["segment"] = normal((cfg.segment_vocab, d), 0.02)
    params = {"embed": embed, "layers": layers, "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_size)
    return params


def layer_axes(cfg: TransformerConfig) -> dict:
    """The logical axes of one layer's params: the JAX tree's layer axes
    without their leading ``"layers"`` (the port keeps a list of layer
    dicts where the JAX package stacks them)."""
    attn = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        attn.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.use_qk_norm:
        attn.update(q_norm=(None,), k_norm=(None,))
    ax = {"attn": attn, "ln1": L.norm_axes(cfg.norm),
          "ln2": L.norm_axes(cfg.norm)}
    if cfg.use_post_norm:
        ax.update(ln1_post=L.norm_axes(cfg.norm),
                  ln2_post=L.norm_axes(cfg.norm))
    if cfg.n_experts:
        ax["moe"] = moe_lib.moe_axes()
    else:
        ax["mlp"] = L.mlp_axes(gated=cfg.gated_mlp, bias=cfg.mlp_bias)
    return ax


def param_axes(cfg: TransformerConfig) -> dict:
    """The logical-axes tree of :func:`init_params`' params: JAX
    ``init_params``' second return, with ``layers`` a list of
    :func:`layer_axes` dicts."""
    embed = {"tokens": ("vocab", "embed")}
    if cfg.learned_pos:
        embed["pos"] = (None, "embed")
    if cfg.segment_vocab:
        embed["segment"] = (None, "embed")
    axes = {"embed": embed,
            "layers": [layer_axes(cfg) for _ in range(cfg.n_layers)],
            "final_norm": L.norm_axes(cfg.norm)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


class Local:
    """How the model reaches its weights and its collectives in one
    process: every weight as stored, every collective the identity.
    ``transformer_spmd.Route`` gives the same hooks over an SPMD mesh,
    where ``params`` are a rank's shards."""
    moe_cut = None          # the expert weights' dim cut over ``model``

    def local(self, cfg):
        """The config a block runs at (a rank's head and d_ff counts)."""
        return cfg

    def layer(self, i: int, lp):
        """The weights layer ``i`` computes with."""
        return lp

    def run(self, fn, x):
        """One layer ``fn(x)`` (the sharded route re-runs its gathers in
        the backward pass)."""
        return fn(x)

    def enter(self, x, part: str):
        """``x`` entering the ``part`` (``"attn"``, ``"ffn"``,
        ``"vocab"``) that the ranks of ``model`` split."""
        return x

    def leave(self, x, part: str):
        """``part``'s partial result, summed over the ranks that split
        it."""
        return x

    def embed_params(self, params):
        return params["embed"]

    def lookup(self, table, tokens):
        return table[tokens]

    def final_norm(self, params):
        return params["final_norm"]

    def head(self, params, cfg):
        return _head(params, cfg)

    def full_logits(self, lg):
        """Logits over the whole vocab from this rank's columns."""
        return lg

    def whole(self, tree, key: str):
        """A parameter tree outside the transformer's own (``key`` names
        it to the route), as every rank uses it alike."""
        return tree

    def logsumexp(self, lg):
        return torch.logsumexp(lg, dim=-1)

    def gold(self, lg, y):
        return torch.take_along_dim(lg, y[..., None].long(), dim=-1)[..., 0]

    def data_sum(self, x):
        """``x`` summed over the data ranks."""
        return x


LOCAL = Local()


def _route(cfg):
    """The installed rules' SPMD route, or :data:`LOCAL`."""
    from repro_torch.models import transformer_spmd as spmd

    return spmd.Route(cfg) if spmd.active_mesh() is not None else LOCAL


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _positions(x, positions):
    """Token-index positions ``[B, S]`` when the caller gives none."""
    if positions is not None:
        return positions
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def project_q(p, x, cfg: TransformerConfig, *, positions=None,
              rope_base=None):
    """Q projection in model layout ``[B, S, Hq, Dh]`` (bias, qk-norm and
    RoPE at ``rope_base``, default ``cfg.rope_base``)."""
    b, s, _ = x.shape
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, cfg.n_heads, cfg.dh)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd).reshape(cfg.n_heads, cfg.dh)
    if cfg.use_qk_norm:
        q = L.rms_norm(q, p["q_norm"])
    if cfg.rope:
        q = L.rope(q, _positions(x, positions),
                   base=cfg.rope_base if rope_base is None else rope_base,
                   fraction=cfg.rope_fraction)
    return q


def project_kv(p, x, cfg: TransformerConfig, *, positions=None,
               rope_base=None):
    """K/V projections in model layout ``[B, S, Hkv, Dh]``: the
    query-invariant half of an attention block, shared with PreTTR's
    index-time layer-``l`` K/V precompute."""
    b, s, _ = x.shape
    cd = cfg.compute_dtype
    k = (x @ p["wk"].to(cd)).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    v = (x @ p["wv"].to(cd)).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    if cfg.qkv_bias:
        k = k + p["bk"].to(cd).reshape(cfg.n_kv_heads, cfg.dh)
        v = v + p["bv"].to(cd).reshape(cfg.n_kv_heads, cfg.dh)
    if cfg.use_qk_norm:
        k = L.rms_norm(k, p["k_norm"])
    if cfg.rope:
        k = L.rope(k, _positions(x, positions),
                   base=cfg.rope_base if rope_base is None else rope_base,
                   fraction=cfg.rope_fraction)
    return k, v


def _attention(p, x, cfg: TransformerConfig, *, positions, window,
               rope_base, split_flag, segs, valid, seg_boundary=-1,
               cache=None, cache_pos=None):
    """One attention block through the ``cfg.attn_impl`` backend.  With
    ``cache=(k, v)`` ([B, S, Hkv, Dh] views of the stacked cache) it is a
    decode step: this step's K/V are written into the cache in place (the
    torch form of JAX's donated cache) and the query attends through the
    ``decode_attention`` kind with ``lengths = position + 1``.  Returns
    ``(out [B, S, d], (k, v))``: this block's K/V, or the cache."""
    b, s, _ = x.shape
    q = project_q(p, x, cfg, positions=positions, rope_base=rope_base)
    k, v = project_kv(p, x, cfg, positions=positions, rope_base=rope_base)
    scale = 1.0 / math.sqrt(cfg.dh)
    if cache is not None:
        ck, cv = cache
        ck[:, cache_pos:cache_pos + s] = k
        cv[:, cache_pos:cache_pos + s] = v
        k_pos = torch.arange(ck.shape[1], device=x.device).expand(
            b, ck.shape[1])
        out = B.get_impl("decode_attention", cfg.attn_impl)(
            q, ck, cv, cfg=cfg, scale=scale, q_pos=positions, k_pos=k_pos,
            window=window, lengths=positions[:, 0] + 1, static_window=window)
        kv = cache
    else:
        out = B.get_impl("attention", cfg.attn_impl)(
            q, k, v, cfg=cfg, scale=scale, positions=positions,
            window=window, split_flag=split_flag, segs=segs, valid=valid,
            seg_boundary=seg_boundary)
        kv = (k, v)
    proj = out.reshape(b, s, cfg.n_heads * cfg.dh) \
        @ p["wo"].to(cfg.compute_dtype)
    return proj, kv


def block_tail(lp, cfg: TransformerConfig, x, attn_out, route=LOCAL):
    """Everything after attention in a block: post-norm, residual, norm,
    MLP or MoE FFN, post-norm, residual.  Returns ``(x, aux)``: ``aux``
    the MoE load loss (a float32 scalar tensor), or the Python ``0.0`` in
    a dense block, which so launches nothing for it.  Shared by the layer
    step and the PreTTR split-residual join.

    The MoE FFN runs over the ``[B * S, d]`` tokens at
    ``cfg.capacity_factor`` with its default SiLU, its weights (the
    router's too) cast to the compute dtype first, as the JAX block
    does.  The MLP's output bias is added after ``route.leave`` (once, not
    on every rank that split the product)."""
    cd = cfg.compute_dtype
    if cfg.use_post_norm:
        attn_out = L.apply_norm(lp["ln1_post"], attn_out, cfg.norm)
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    if cfg.n_experts:
        b, s, d = h.shape
        moe_p = {k: v.to(cd) for k, v in lp["moe"].items()}
        ff, aux = moe_lib.moe_ffn(moe_p, h.reshape(b * s, d),
                                  top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  model_cut=route.moe_cut)
        ff = ff.reshape(b, s, d)
    else:
        mlp_p = {k: v.to(cd) for k, v in lp["mlp"].items() if k != "b_out"}
        ff = route.leave(L.mlp(mlp_p, route.enter(h, "ffn"),
                               gated=cfg.gated_mlp,
                               activation=cfg.activation), "ffn")
        if "b_out" in lp["mlp"]:
            ff = ff + lp["mlp"]["b_out"].to(cd)
        aux = 0.0
    if cfg.use_post_norm:
        ff = L.apply_norm(lp["ln2_post"], ff, cfg.norm)
    return x + ff, aux


def _layer_step(lp, x, cfg: TransformerConfig, route=LOCAL, **kw):
    """One full block over ``x [B, S, d]``; returns ``(x, kv, aux)``."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    attn_out, kv = _attention(lp["attn"], route.enter(h, "attn"), cfg, **kw)
    x, aux = block_tail(lp, cfg, x, route.leave(attn_out, "attn"), route)
    return x, kv, aux


def layer_step(lp, x, cfg: TransformerConfig, *, split_flag: bool, segs,
               valid, seg_boundary: int = -1, positions=None,
               window: int = -1, rope_base=None):
    """One full block over ``x [B, S, d]`` -> ``x``."""
    return _layer_step(lp, x, cfg, positions=_positions(x, positions),
                       window=window, rope_base=rope_base,
                       split_flag=split_flag, segs=segs, valid=valid,
                       seg_boundary=seg_boundary)[0]


def _run_layers(params, cfg: TransformerConfig, x, lo: int, hi: int, *,
                positions, segs=None, valid=None, seg_boundary=-1,
                collect_cache=False, cache=None, cache_pos=None,
                route=LOCAL):
    """Layers [lo, hi), each with its own window, RoPE base and split
    flag.  Returns ``(x, kv, aux)``: ``kv`` the per-layer K/V stacked to
    ``[hi - lo, B, S, Hkv, Dh]`` pairs (``collect_cache``), the updated
    cache (``cache``), else None; ``aux`` the layers' MoE load losses
    summed (the Python ``0.0`` over dense layers).

    The kernel impl takes the split mask as one static ``seg_boundary``
    and cannot mask by per-token segment ids, so on ``"cuda"`` a range
    whose split flags differ is refused before any layer runs, as the JAX
    ``pallas`` impl refuses it; windows may differ (each layer passes its
    own)."""
    windows, bases = cfg.layer_windows(), cfg.layer_rope_bases()
    splits = [i < cfg.split_layers for i in range(lo, hi)]
    if cfg.attn_impl == "cuda" and len(set(splits)) > 1:
        raise ValueError(
            f"attn_impl='cuda' requires a uniform split-flag per layer "
            f"range; layers [{lo}, {hi}) mix windows={windows[lo:hi]} "
            f"splits={splits} — run heterogeneous layers via separate "
            f"layer ranges or use attn_impl='plain'")
    ks, vs = [], []
    aux = 0.0
    local = route.local(cfg)

    def step(i, x, **kw):
        return _layer_step(route.layer(i, params["layers"][i]), x, local,
                           route, **kw)

    for i in range(lo, hi):
        x, (k, v), a = route.run(functools.partial(
            step, i, positions=positions, window=windows[i],
            rope_base=bases[i], split_flag=i < cfg.split_layers, segs=segs,
            valid=valid, seg_boundary=seg_boundary,
            cache=None if cache is None else (cache[0][i], cache[1][i]),
            cache_pos=cache_pos), x)
        aux = aux + a
        if collect_cache:
            ks.append(k)
            vs.append(v)
    if cache is not None:
        return x, cache, aux
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_cache
               else None), aux


def run_layer_range(params, cfg: TransformerConfig, x, lo: int, hi: int, *,
                    positions=None, segs=None, valid=None,
                    seg_boundary: int = -1, route=LOCAL):
    """Run layers [lo, hi) over already-embedded ``x``: the hook PreTTR
    uses for precompute (0..l) and join (l..n).  Layers below
    ``cfg.split_layers`` carry the split mask: by segment ids in the plain
    impl, at the static token index ``seg_boundary`` in the kernel impl
    (-1 = single segment).  ``route``: the weights' views and collectives
    (``transformer_spmd.Route`` over an SPMD mesh)."""
    return _run_layers(params, cfg, x, lo, hi,
                       positions=_positions(x, positions), segs=segs,
                       valid=valid, seg_boundary=seg_boundary,
                       route=route)[0]


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def embed(params, cfg: TransformerConfig, tokens, positions, segs,
          route=LOCAL):
    """Token (+ learned-position + segment) embeddings in compute dtype;
    ``scale_embeddings`` multiplies by ``sqrt(d)`` rounded to the compute
    dtype first, as JAX does."""
    cd = cfg.compute_dtype
    emb = route.embed_params(params)
    x = route.lookup(emb["tokens"].to(cd), tokens)
    if cfg.scale_embeddings:
        # rounded on the host (no stream-waiting copy to the card)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cd))
    if cfg.learned_pos:
        x = x + emb["pos"].to(cd)[positions]
    if cfg.segment_vocab and segs is not None:
        x = x + emb["segment"].to(cd)[segs]
    return x


def forward(params, cfg: TransformerConfig, tokens, *, positions=None,
            segs=None, valid=None, collect_cache=False, seg_boundary=-1):
    """Full-sequence forward.  Returns ``(hidden [B, S, d], kv, aux)``:
    ``kv`` the per-layer K/V as a ``(k, v)`` pair of
    ``[L, B, S, Hkv, Dh]`` (``collect_cache``) or None; ``aux`` the MoE
    load loss summed over layers (0 for a dense config).

    Under rules over an SPMD mesh (``dist.install_rules(default_rules(
    spmd_mesh))``) ``params`` are this rank's shards
    (``dist.spmd.shard_tree`` over :func:`param_axes`) and ``tokens`` its
    data group's rows: the FSDP / tensor-parallel route of
    :mod:`repro_torch.models.transformer_spmd`; the hidden states are
    whole on every rank of the data group, and ``kv`` is this rank's
    cache, ``[L, B / data, S, Hkv_local, Dh]``: the kv heads its query
    heads read (``transformer_spmd.cache_block``)."""
    return _forward(params, cfg, tokens, _route(cfg), positions=positions,
                    segs=segs, valid=valid, collect_cache=collect_cache,
                    seg_boundary=seg_boundary)


def _forward(params, cfg: TransformerConfig, tokens, route, *,
             positions=None, segs=None, valid=None, collect_cache=False,
             seg_boundary=-1):
    positions = _positions(tokens, positions)
    x = embed(params, cfg, tokens, positions, segs, route)
    x, kv, aux = _run_layers(params, cfg, x, 0, cfg.n_layers,
                             positions=positions, segs=segs, valid=valid,
                             seg_boundary=seg_boundary,
                             collect_cache=collect_cache, route=route)
    x = L.apply_norm(route.final_norm(params), x, cfg.norm)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, kv, aux


def _head(params, cfg: TransformerConfig):
    """The LM head ``[d, V]`` in compute dtype (tied: the token table)."""
    head = params["embed"]["tokens"].T if cfg.tie_embeddings \
        else params["lm_head"]
    return head.to(cfg.compute_dtype)


def logits(params, cfg: TransformerConfig, hidden):
    """``hidden [B, S, d]`` -> float32 logits ``[B, S, V]``: the compute
    dtype product summed and returned in float32, not rounded to bf16
    (JAX's ``preferred_element_type``; ``layers.mm_f32``).  Under rules
    over an SPMD mesh ``params`` are this rank's shards: each rank of
    ``model`` multiplies by its vocab columns and the logits are
    gathered whole."""
    return _logits(params, cfg, hidden, _route(cfg))


def _logits(params, cfg: TransformerConfig, hidden, route):
    b, s, d = hidden.shape
    lg = L.mm_f32(hidden.reshape(b * s, d), route.head(params, cfg))
    return route.full_logits(lg).reshape(b, s, -1)


def _chunk_nll(h, y, m, head, route=LOCAL):
    """Summed masked next-token NLL of one chunk: h [B, C, d], y / m
    [B, C], head [d, V] (a rank's vocab columns on the sharded route).
    The logits are float32: the compute-dtype operands widened (exact)
    and multiplied in float32, which autograd can differentiate."""
    b, c, d = h.shape
    lg = (h.reshape(b * c, d).float() @ head.float()).reshape(b, c, -1)
    return ((route.logsumexp(lg) - route.gold(lg, y)) * m).sum()


def causal_lm_loss(params, cfg: TransformerConfig, tokens, labels, *,
                   label_mask=None):
    """Next-token cross-entropy, chunked over the sequence by
    ``cfg.logits_chunk`` (the whole sequence when the chunk does not
    divide S), so [B, S, V] logits never exist at once; each chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``).  Returns the mean over
    ``label_mask`` (float [B, S], default all ones) plus ``0.01 * aux /
    n_layers`` (the MoE load loss, 0 for dense configs).  Under rules over
    an SPMD mesh it takes the sharded route (:func:`forward`), whose loss
    is the mean over every rank's tokens."""
    from torch.utils.checkpoint import checkpoint

    route = _route(cfg)
    hidden, _, aux = _forward(params, cfg, tokens, route)
    b, s, _ = hidden.shape
    chunk = cfg.logits_chunk or s
    if s % chunk:
        chunk = s
    head = route.head(params, cfg)
    hidden = route.enter(hidden, "vocab")
    if label_mask is None:
        label_mask = torch.ones((b, s), dtype=torch.float32,
                                device=hidden.device)
    label_mask = label_mask.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s, chunk):
        sl = slice(c, c + chunk)
        total = total + checkpoint(_chunk_nll, hidden[:, sl], labels[:, sl],
                                   label_mask[:, sl], head, route,
                                   use_reentrant=False)
    count = route.data_sum(label_mask.sum())
    loss = route.data_sum(total) / torch.clamp(count, min=1.0)
    return loss + 0.01 * aux / max(cfg.n_layers, 1)


def init_decode_cache(cfg: TransformerConfig, batch: int, max_len: int,
                      dtype=None, device=None):
    """Zero KV cache: a ``(k, v)`` pair of ``[L, B, max_len, Hkv, Dh]`` in
    ``dtype`` (default the compute dtype) on ``device`` (``None`` means
    the card)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    kw = dict(dtype=dtype or cfg.compute_dtype, device=resolve_device(device))
    return torch.zeros(shape, **kw), torch.zeros(shape, **kw)


#: logical axes of each ``[L, B, S, Hkv, Dh]`` cache of
#: :func:`init_decode_cache` (JAX's ``DECODE_CACHE_AXES``)
DECODE_CACHE_AXES = ("layers", "batch", "kv_seq", None, None)


def decode_step(params, cfg: TransformerConfig, tokens, cache,
                cache_pos: int):
    """One decode step.  tokens: [B, 1] at position ``cache_pos``; cache:
    ``(k, v)`` each ``[L, B, S, Hkv, Dh]``, written in place at
    ``cache_pos`` (callers that reuse a cache clone it first).  Returns
    ``(logits [B, 1, V] float32, cache)``.

    Under rules over an SPMD mesh, as :func:`forward`: ``params`` are
    this rank's shards, ``tokens`` its data group's rows and ``cache``
    its ``[L, B / data, S, Hkv_local, Dh]`` block; each rank runs its
    query heads against its kv heads (the ``decode_attention`` kind on
    the local heads) and the logits come back whole."""
    b = tokens.shape[0]
    route = _route(cfg)
    positions = torch.full((b, 1), int(cache_pos), dtype=torch.long,
                           device=tokens.device)
    x = embed(params, cfg, tokens, positions, None, route)
    x, cache, _ = _run_layers(params, cfg, x, 0, cfg.n_layers,
                              positions=positions, cache=cache,
                              cache_pos=int(cache_pos), route=route)
    x = L.apply_norm(route.final_norm(params), x, cfg.norm)
    return _logits(params, cfg, x, route), cache
