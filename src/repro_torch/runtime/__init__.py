"""The crash-restart loop and the straggler watchdog of the trainer
(``resilience``)."""
