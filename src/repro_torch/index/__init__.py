"""The port's term-rep index: v2 and v1 reader, builder (trained codecs,
token pruning, chunk checksums, ``verify_index``), storage codecs (fp32,
fp16, int8, pq), the manifest's msgpack, and the serving shards'
ownership-checked views (``ShardIndexView``)."""
from repro_torch.index.builder import (BuildReport, IndexBuilder,
                                       prune_selection, verify_index)
from repro_torch.index.codecs import (available_codecs, get_codec,
                                      register_codec)
from repro_torch.index.store import (IndexFormatError,
                                     IndexIntegrityError, ShardIndexView,
                                     TermRepIndex)

__all__ = ["BuildReport", "IndexBuilder", "IndexFormatError",
           "IndexIntegrityError", "ShardIndexView", "TermRepIndex",
           "available_codecs", "get_codec", "prune_selection",
           "register_codec", "verify_index"]
