"""The configs the port runs: the paper's CNNs (``CNN_REGISTRY``,
``CNN_SMOKES``) and the LM architectures (``get_config`` / ``get_smoke``
by architecture id): mamba2-130m of the ssm family; granite-3-2b,
starcoder2-3b, gemma-7b and mistral-large-123b of the dense family;
arctic-480b and llama4-maverick-400b-a17b of the moe family; and
jamba-1.5-large-398b of the hybrid family; llava-next-34b of the vlm
family; and seamless-m4t-large-v2 of the encdec family.

Mirrors ``repro/configs/__init__.py``.
"""
import torch

from repro_torch.configs import (arctic_480b, gemma_7b, granite_3_2b,
                                 jamba_1_5_large_398b, llava_next_34b,
                                 llama4_maverick_400b_a17b, mamba2_130m,
                                 mistral_large_123b, seamless_m4t_large_v2,
                                 starcoder2_3b)
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, REGISTRY, TRAIN_4K,
                                      ModelConfig, ShapeCell, get_config,
                                      register)
from repro_torch.configs.cnn import (ALEXNET_SMOKE, CNN_REGISTRY, CNN_SMOKES,
                                     VGG16_SMOKE)

_SMOKES = {m.CONFIG.name: m.SMOKE
           for m in (mamba2_130m, granite_3_2b, starcoder2_3b, gemma_7b,
                     mistral_large_123b, arctic_480b,
                     llama4_maverick_400b_a17b, jamba_1_5_large_398b,
                     llava_next_34b, seamless_m4t_large_v2)}

ARCH_IDS = tuple(sorted(REGISTRY))


def shape_cells(cfg: ModelConfig):
    """The ShapeCell list this architecture runs (long_500k gated on
    subquadratic), as ``repro.configs.shape_cells``."""
    by_name = {c.name: c for c in ALL_SHAPES}
    return tuple(by_name[s] for s in cfg.shapes)


def get_smoke(name: str, dtype=None) -> ModelConfig:
    """Reduced config of the same family, in fp32 unless ``dtype`` says
    otherwise (as ``repro.configs.get_smoke``)."""
    get_config(name)  # raises for an arch the port does not have
    return _SMOKES[name].with_overrides(dtype=dtype or torch.float32)


__all__ = [
    "ALEXNET_SMOKE", "ALL_SHAPES", "ARCH_IDS", "CNN_REGISTRY", "CNN_SMOKES",
    "DECODE_32K", "LONG_500K", "ModelConfig", "PREFILL_32K", "REGISTRY",
    "ShapeCell", "TRAIN_4K", "VGG16_SMOKE", "get_config", "get_smoke",
    "register", "shape_cells",
]
