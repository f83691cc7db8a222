"""The port's term-rep index: v2 and v1 reader, builder (trained codecs,
token pruning, chunk checksums, ``verify_index``), storage codecs (fp32,
fp16, int8, pq) and the manifest's msgpack."""
from repro_torch.index.builder import (BuildReport, IndexBuilder,
                                       prune_selection, verify_index)
from repro_torch.index.codecs import (available_codecs, get_codec,
                                      register_codec)
from repro_torch.index.store import (IndexFormatError,
                                     IndexIntegrityError, TermRepIndex)

__all__ = ["BuildReport", "IndexBuilder", "IndexFormatError",
           "IndexIntegrityError", "TermRepIndex", "available_codecs",
           "get_codec", "prune_selection", "register_codec", "verify_index"]
