"""CPU tests of the benchmark harness; card-only cases are marked ``cuda``."""
