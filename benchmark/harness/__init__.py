"""The harness: cells found by name, the timed window of whole CLI jobs,
the trace readings and the one-line result."""
