from .cfg_node import CfgNode
from .defaults import (
    MAIN_CONFIG,
    SFAT_BENCH_CONFIG,
    SOURCE_CONFIG,
    detector_config_from_cfg,
    get_cfg,
    get_main_cfg,
    get_sfat_bench_cfg,
    get_source_cfg,
)

__all__ = [
    "CfgNode", "MAIN_CONFIG", "SFAT_BENCH_CONFIG", "SOURCE_CONFIG", "get_cfg", "get_main_cfg", "get_sfat_bench_cfg",
    "get_source_cfg", "detector_config_from_cfg",
]
