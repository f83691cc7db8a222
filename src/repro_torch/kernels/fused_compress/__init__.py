from repro_torch.kernels.fused_compress.ops import (fused_compress,
                                                    fused_decompress)
from repro_torch.kernels.fused_compress.ref import compress_ref, decompress_ref

__all__ = ["fused_compress", "fused_decompress", "compress_ref",
           "decompress_ref"]
