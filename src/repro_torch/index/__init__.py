"""The port's term-rep index: v2 reader, builder, storage codecs (fp32,
fp16, int8) and the manifest's msgpack."""
from repro_torch.index.builder import BuildReport, IndexBuilder
from repro_torch.index.store import (IndexFormatError,
                                     IndexIntegrityError, TermRepIndex)

__all__ = ["BuildReport", "IndexBuilder", "IndexFormatError",
           "IndexIntegrityError", "TermRepIndex"]
