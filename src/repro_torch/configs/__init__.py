from .base import ArchConfig, BlockCfg, RopeCfg, SSMCfg
from .registry import ARCH_IDS, get_config, reduce_config
from .roberta_base import CONFIG, TINY

__all__ = ["ArchConfig", "BlockCfg", "RopeCfg", "SSMCfg", "ARCH_IDS", "get_config",
           "reduce_config", "CONFIG", "TINY"]
