"""Optimizer, learning-rate schedules and gradient compression
(``repro.optim``)."""
from repro_torch.optim.adam import (OptimizerConfig, adam_update,
                                    clip_by_global_norm, init_opt_state,
                                    opt_state_axes, value_and_grad)
from repro_torch.optim.compression import (compressed_psum,
                                           init_error_feedback)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["OptimizerConfig", "adam_update", "clip_by_global_norm",
           "compressed_psum", "constant", "init_error_feedback",
           "init_opt_state", "opt_state_axes", "value_and_grad",
           "warmup_cosine"]
