"""Architecture configs (one module per assigned arch) + shape registry."""
