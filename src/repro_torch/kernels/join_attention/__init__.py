from repro_torch.kernels.join_attention.ops import join_flash_attention
from repro_torch.kernels.join_attention.ref import join_attention_ref

__all__ = ["join_flash_attention", "join_attention_ref"]
