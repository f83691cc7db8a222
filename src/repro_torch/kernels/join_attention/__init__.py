from repro_torch.kernels.join_attention.ops import (join_flash_attention,
                                                   join_flash_attention_paged)
from repro_torch.kernels.join_attention.ref import (dequantize_kv,
                                                    join_attention_ref,
                                                    join_attention_ref_paged,
                                                    join_attention_ref_quant,
                                                    pages_to_dense)

__all__ = ["join_flash_attention", "join_flash_attention_paged",
           "join_attention_ref", "join_attention_ref_quant",
           "join_attention_ref_paged", "dequantize_kv", "pages_to_dense"]
