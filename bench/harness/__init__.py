"""The harness: traffic, weights, the timed loops (``modes``), the trace
reduction and the check against the reference."""
