"""The harness: cell resolution, inputs, drivers and tracing."""
