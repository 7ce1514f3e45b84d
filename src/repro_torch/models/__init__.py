"""Model stack: dense attention transformers on the paged compute plane."""
from repro_torch.models.transformer import init_params, model_defs

__all__ = ["init_params", "model_defs"]
