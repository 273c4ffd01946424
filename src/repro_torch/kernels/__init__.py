"""Device execution: the hand-written CUDA kernels (``conv2d_stream``,
``flash_attention``; built by ``build``), their plain PyTorch versions,
the shared primitives (``ref``) and the schedule-IR consumer and kernel
entry points (``ops``)."""
