"""The deterministic synthetic data pipeline of the train step
(``pipeline``)."""
