"""The benchmark's yardstick: cells, traffic, weights, work counts, the
trace's reduction and the comparison that decides ``correct``."""
