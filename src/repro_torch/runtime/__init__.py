"""Runtime control: fault tolerance for the training loop."""
