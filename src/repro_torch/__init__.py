"""PreTTR re-ranking in PyTorch on an NVIDIA H100.

The PyTorch/CUDA twin of the JAX package ``repro``: the split encoder, the
d -> e -> d compressor, the term-rep index (fp16 or int8 reps, optional
stored layer-l K/V), the packed re-ranking service and its paged device
doc cache, with every kernel of that path written by hand in CUDA C++ for
``sm_90a`` (``repro_torch/csrc``).  The package imports ``torch`` and
``numpy`` only.

Entry points (param init, ``IndexBuilder``, ``TermRepIndex.stage``,
``RankingService``) run on the card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
