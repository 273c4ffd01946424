"""The optimizer of the train step (``adamw``) and int8 gradient
compression with error feedback (``compress``)."""
