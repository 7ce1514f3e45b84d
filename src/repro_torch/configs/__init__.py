"""Architecture configs (``--arch <id>``). Importing this package registers
the architectures the port runs: qwen3-8b and gemma-2b (serving and
training), mamba2-2.7b, hymba-1.5b, deepseek-7b, deepseek-v2-lite-16b,
gemma2-27b, mixtral-8x22b, musicgen-large and internvl2-76b (serving), and
the paper's reference model llama2-70b — every architecture of the JAX
package."""
from repro_torch.configs.base import ModelConfig, LayerSpec, ScanGroup, REGISTRY, get_config, reduced, register
from repro_torch.configs.shapes import SHAPES, ShapeConfig, get_shape, cells, LONG_CONTEXT_OK, LONG_CONTEXT_SKIP

# register all ported architectures
from repro_torch.configs.deepseek_7b import DEEPSEEK_7B
from repro_torch.configs.deepseek_v2_lite_16b import DEEPSEEK_V2_LITE
from repro_torch.configs.gemma2_27b import GEMMA2_27B
from repro_torch.configs.gemma_2b import GEMMA_2B
from repro_torch.configs.hymba_1p5b import HYMBA_1P5B
from repro_torch.configs.internvl2_76b import INTERNVL2_76B
from repro_torch.configs.llama2_70b import LLAMA2_70B
from repro_torch.configs.mamba2_2p7b import MAMBA2_2P7B
from repro_torch.configs.mixtral_8x22b import MIXTRAL_8X22B
from repro_torch.configs.musicgen_large import MUSICGEN_LARGE
from repro_torch.configs.qwen3_8b import QWEN3_8B

ASSIGNED_ARCHS = (
    "mamba2-2.7b",
    "deepseek-7b",
    "gemma-2b",
    "qwen3-8b",
    "gemma2-27b",
    "mixtral-8x22b",
    "deepseek-v2-lite-16b",
    "musicgen-large",
    "hymba-1.5b",
    "internvl2-76b",
)

__all__ = [
    "ModelConfig", "LayerSpec", "ScanGroup", "REGISTRY", "get_config",
    "reduced", "register", "SHAPES", "ShapeConfig", "get_shape", "cells",
    "LONG_CONTEXT_OK", "LONG_CONTEXT_SKIP", "ASSIGNED_ARCHS",
]
