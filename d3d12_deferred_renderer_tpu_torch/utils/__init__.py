from .image import write_png, read_png
from .debug import debug_layer, validate_scene

__all__ = ["write_png", "read_png", "debug_layer", "validate_scene"]
