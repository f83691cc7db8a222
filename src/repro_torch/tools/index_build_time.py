"""Host and wall time of one PQ index build on the card, for an A/B of
two checkouts of the port's index builder.

It times whatever ``repro_torch`` the path gives, so one copy of this file
times any checkout; run it once per checkout, alternating which goes first:

    PYTHONPATH=<checkout>/src python src/repro_torch/tools/index_build_time.py

The build is ``chip_smoke.py``'s cascade PQ index: PreTTR-BERT at full
width (``prettr_bert.full_config``), random weights from a seed, a
SyntheticIRWorld of 2,048 docs, batches of 64 through the kernels, one
shard with chunk checksums.  Prints one JSON line: the build's fit,
encode, write and wall seconds (``BuildReport``) and the checkout."""
from __future__ import annotations

import json
import os
import tempfile

import torch

SEED, N_DOCS, N_QUERIES, BATCH = 0, 2048, 64, 64


def main() -> int:
    import repro_torch
    from repro_torch.configs.prettr_bert import full_config
    from repro_torch.core.prettr import init_prettr
    from repro_torch.data.synthetic_ir import SyntheticIRWorld
    from repro_torch.index import IndexBuilder
    from repro_torch.kernels import _build

    cfg = full_config()
    params = init_prettr(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    world = SyntheticIRWorld(vocab_size=cfg.backbone.vocab_size,
                             n_docs=N_DOCS, n_queries=N_QUERIES,
                             doc_len=cfg.max_doc_len - 1, seed=SEED)
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        r = IndexBuilder(os.path.join(tmp, "pq"), cfg, params,
                         batch_size=BATCH, codec="pq").build(list(world.docs))
    print(json.dumps({"checkout": os.path.dirname(repro_torch.__file__),
                      "device": torch.cuda.get_device_name(0),
                      "n_docs": r.n_docs, "fit_s": r.fit_s,
                      "encode_s": r.encode_s, "write_s": r.write_s,
                      "wall_s": r.wall_s}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
