"""Launchers of the LM stack: the step functions (``steps``), the
wave-batched LM server (``serve``), the training driver (``train``), the
device mesh (``mesh``) and the input specs (``specs``)."""
