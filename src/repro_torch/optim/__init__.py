"""Optimizer and learning-rate schedules (``repro.optim``)."""
from repro_torch.optim.adam import (OptimizerConfig, adam_update,
                                    clip_by_global_norm, init_opt_state,
                                    value_and_grad)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["OptimizerConfig", "adam_update", "clip_by_global_norm",
           "constant", "init_opt_state", "value_and_grad", "warmup_cosine"]
