"""Small calls of the backend ops that training differentiates
(``attention``, ``decode_attention``, ``compress``, ``decompress``) and of
the recsys lookups' ``padded_bag`` (its ``impl`` for the backend), for
the tests that hold the ``"cuda"`` ops' gradient against the plain ops'
(``test_torch_train.py`` on the CPU, ``test_torch_cuda.py`` on the
card): torch and the port only."""
import types

import torch

from repro_torch.kernels.decode_attention import flash_decode_attention
from repro_torch.kernels.embedding_bag import embedding_bag_op
from repro_torch.kernels.fused_compress import fused_compress, fused_decompress
from repro_torch.kernels.split_attention import split_flash_attention
from repro_torch.models import backend as B
from repro_torch.models.recsys import embedding as E

B_, S_, H_, D_, E_ = 2, 24, 2, 16, 8
LQ = 8                         # the split cases' query segment


def _inputs(gen, device):
    r = lambda *s: torch.randn(*s, generator=gen).to(device)
    valid = torch.arange(S_)[None] < torch.tensor([[S_], [S_ - 5]])
    return r, valid.to(device)


def _attention(causal, window, split):
    def call(gen, device):
        r, valid = _inputs(gen, device)
        segs = (torch.arange(S_) >= LQ).long().expand(B_, S_).to(device)
        cfg = types.SimpleNamespace(causal=causal, block_kv=16)
        xs = [r(B_, S_, H_, D_) for _ in range(3)]
        fn = lambda impl, q, k, v: B.get_impl("attention", impl)(
            q, k, v, cfg=cfg, scale=D_ ** -0.5, split_flag=split, segs=segs,
            valid=valid, seg_boundary=LQ if split else -1, window=window)
        return fn, xs
    return call


def _decode(gen, device):
    r, valid = _inputs(gen, device)
    pos = torch.arange(S_, device=device).expand(B_, S_)
    q_pos = torch.full((B_, 1), (2 ** 31 - 1) // 2, device=device)
    xs = [r(B_, 1, H_, D_), r(B_, S_, H_, D_), r(B_, S_, H_, D_)]
    fn = lambda impl, q, k, v: B.get_impl("decode_attention", impl)(
        q, k, v, cfg=None, scale=D_ ** -0.5, q_pos=q_pos, k_pos=pos,
        window=-1, k_valid=valid, static_window=-1)
    return fn, xs


def _compress(gen, device):
    r, _ = _inputs(gen, device)
    xs = [r(B_, S_, D_), r(D_, E_) / D_ ** 0.5, r(E_) * 0.1]
    fn = lambda impl, x, w, b: B.get_impl("compress", impl)(
        {"w_comp": w, "b_comp": b}, x, store_dtype=torch.float16)
    return fn, xs


def _decompress(gen, device):
    r, _ = _inputs(gen, device)
    xs = [r(B_, S_, E_).half(), r(E_, D_) / E_ ** 0.5, r(D_) * 0.1,
          1 + r(D_) * 0.1, r(D_) * 0.1]
    fn = lambda impl, x, w, b, g, be: B.get_impl("decompress", impl)(
        {"w_decomp": w, "b_decomp": b, "ln": {"scale": g, "bias": be}}, x,
        compute_dtype=torch.float32)
    return fn, xs


def _bag(gen, device):
    r, _ = _inputs(gen, device)
    ids = torch.randint(0, 40, (B_ * S_, 3), generator=gen).to(device)
    weights = (torch.rand((B_ * S_, 3), generator=gen) < 0.8).float() \
        .to(device)
    fn = lambda impl, table: E.padded_bag(table, ids, weights, impl=impl)
    return fn, [r(40, D_)]


#: name -> (call(gen, device) -> (fn(impl, *xs), xs), the launch counter
#: the call moves on the card)
CASES = {
    "attention_split": (_attention(False, -1, True),
                        (split_flash_attention, "launches")),
    "attention_causal": (_attention(True, -1, False),
                         (split_flash_attention, "causal_launches")),
    "attention_window": (_attention(True, 8, False),
                         (split_flash_attention, "window_launches")),
    "decode_attention": (_decode, (flash_decode_attention, "launches")),
    "compress": (_compress, (fused_compress, "launches")),
    "decompress": (_decompress, (fused_decompress, "launches")),
    "embedding_bag": (_bag, (embedding_bag_op, "launches")),
}


def run(name, impl, device, seed=0):
    """One case through ``impl``: ``(out, grads, launches)``, the grads
    of ``sum(out * w)`` (``w`` seeded) by every float input, and the
    case's launches on the way."""
    call, (wrapper, attr) = CASES[name]
    fn, xs = call(torch.Generator().manual_seed(seed), device)
    xs = [x.requires_grad_() for x in xs]
    setattr(wrapper, attr, 0)
    out = fn(impl, *xs)
    launches = getattr(wrapper, attr)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed + 1)).to(device)
    grads = torch.autograd.grad((out.float() * w).sum(), xs)
    return out, grads, launches
