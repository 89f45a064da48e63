from .base import ArchConfig, BlockCfg, InputShape, MoECfg, RopeCfg, SSMCfg
from .registry import ARCH_IDS, all_configs, get_config, reduce_config
from .roberta_base import CONFIG, TINY
from .shapes import SHAPES, get_shape

__all__ = [
    "ArchConfig", "BlockCfg", "InputShape", "MoECfg", "RopeCfg", "SSMCfg",
    "ARCH_IDS", "all_configs", "get_config", "reduce_config", "SHAPES", "get_shape",
    "CONFIG", "TINY",
]
