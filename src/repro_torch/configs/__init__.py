"""Architecture configs (``--arch <id>``). Importing this package registers
the architectures the port serves so far: qwen3-8b and mamba2-2.7b."""
from repro_torch.configs.base import ModelConfig, LayerSpec, ScanGroup, REGISTRY, get_config, reduced, register

# register all ported architectures
from repro_torch.configs.mamba2_2p7b import MAMBA2_2P7B
from repro_torch.configs.qwen3_8b import QWEN3_8B

__all__ = [
    "ModelConfig", "LayerSpec", "ScanGroup", "REGISTRY", "get_config",
    "reduced", "register",
]
