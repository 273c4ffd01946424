"""Device execution: the hand-written CUDA kernels (``conv2d_stream``,
``flash_attention``, ``fused_mlp``, ``mamba2_ssd``; built by ``build``),
their plain PyTorch versions, the shared primitives (``ref``) and the
schedule-IR consumer and kernel entry points (``ops``)."""
