"""The harness: data, runs, trace, check."""
