from .node import CfgNode
from .defaults import default_config, update_config

__all__ = ["CfgNode", "default_config", "update_config"]
