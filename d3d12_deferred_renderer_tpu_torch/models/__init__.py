from .meshlib import MeshData, SceneGeometry, build_instanced_geometry, build_scene_geometry
from .obj import load_obj
from . import procedural

__all__ = ["MeshData", "SceneGeometry", "build_instanced_geometry", "build_scene_geometry", "load_obj",
           "procedural"]
