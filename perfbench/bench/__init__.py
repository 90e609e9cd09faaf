"""The harness: cells, traffic, weights, the timed window, tracing, the
comparison that decides ``correct`` and the result line."""
