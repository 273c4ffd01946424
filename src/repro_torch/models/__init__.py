"""The LM stack on PyTorch: transformer layers (``layers``) and the
decoder-only LM of the dense family (``lm``)."""
