"""The benchmark's harness: cells found by name, inputs from the seed,
the timed frame loop, the trace's reduction to per-layer metrics and the
comparison with the reference."""
