from .meshlib import MeshData, SceneGeometry, build_scene_geometry
from . import procedural

__all__ = ["MeshData", "SceneGeometry", "build_scene_geometry", "procedural"]
