"""Runtime control: fault tolerance for the training loop, and the
in-memory tracer (``tracing.TRACER``)."""
