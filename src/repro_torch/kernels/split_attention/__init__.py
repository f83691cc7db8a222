from repro_torch.kernels.split_attention.ops import split_flash_attention
from repro_torch.kernels.split_attention.ref import split_attention_ref

__all__ = ["split_flash_attention", "split_attention_ref"]
