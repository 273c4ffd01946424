"""Device execution: the hand-written CUDA kernels (``conv2d_stream``,
``flash_attention``, ``fused_mlp``, ``mamba2_ssd``; built by ``build``),
their plain PyTorch versions, the shared primitives (``ref``), each
kernel's work and the card's peaks that bound it (``work``) and the
schedule-IR consumer and kernel entry points (``ops``)."""
