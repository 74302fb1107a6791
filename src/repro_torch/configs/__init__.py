from .base import SHAPES, ModelConfig, ShapeSpec
from .registry import get_config, list_archs
