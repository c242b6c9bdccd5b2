"""Tensor ops of the port: plain PyTorch functions and the wrappers of the
hand-written Hopper kernels (``qkv_attention``, ``window_attention``,
``layernorm``)."""
