from .base import ModelConfig
from .registry import get_config, list_archs
