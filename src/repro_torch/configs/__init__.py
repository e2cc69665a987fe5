"""Architecture registry: --arch <id> resolves here."""
from .base import ArchConfig, SHAPES, ShapeConfig, shape_by_name, smoke_config

from .qwen3_1_7b import CONFIG as _qwen3
from .starcoder2_15b import CONFIG as _sc15
from .gemma3_12b import CONFIG as _gemma3
from .starcoder2_3b import CONFIG as _sc3
from .whisper_base import CONFIG as _whisper
from .zamba2_2_7b import CONFIG as _zamba2
from .phi_3_vision_4_2b import CONFIG as _phi3v
from .deepseek_moe_16b import CONFIG as _dsmoe
from .kimi_k2_1t_a32b import CONFIG as _kimi
from .xlstm_350m import CONFIG as _xlstm

REGISTRY = {c.name: c for c in [
    _qwen3, _sc15, _gemma3, _sc3, _whisper, _zamba2, _phi3v, _dsmoe, _kimi,
    _xlstm,
]}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
