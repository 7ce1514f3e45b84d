"""Entry points: the serving driver (``python -m repro_torch.launch.serve``)."""
