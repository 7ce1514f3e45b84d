"""CPU tests of the benchmark harness (``pytest bench/tests``)."""
