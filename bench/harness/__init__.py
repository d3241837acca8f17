"""The benchmark harness: manifest, drivers, traces, checks."""
