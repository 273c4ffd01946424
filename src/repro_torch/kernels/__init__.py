"""Device execution: the hand-written CUDA kernels (``conv2d_stream``),
their plain PyTorch versions, the shared primitives (``ref``) and the
schedule-IR consumer (``ops``)."""
