"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  CUDA sources live in ``repro_torch/csrc`` and are built by
``repro_torch.kernels._build`` at first launch."""
