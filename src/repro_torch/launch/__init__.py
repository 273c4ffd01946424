"""Launchers of the LM stack: the serve-side step functions (``steps``)
and the wave-batched LM server (``serve``)."""
