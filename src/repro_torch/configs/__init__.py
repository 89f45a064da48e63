from .base import ArchConfig, BlockCfg, RopeCfg
from .roberta_base import CONFIG, TINY

__all__ = ["ArchConfig", "BlockCfg", "RopeCfg", "CONFIG", "TINY"]
