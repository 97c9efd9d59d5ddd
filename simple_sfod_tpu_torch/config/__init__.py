from .cfg_node import CfgNode
from .defaults import MAIN_CONFIG, detector_config_from_cfg, get_cfg, get_main_cfg

__all__ = ["CfgNode", "MAIN_CONFIG", "get_cfg", "get_main_cfg", "detector_config_from_cfg"]
