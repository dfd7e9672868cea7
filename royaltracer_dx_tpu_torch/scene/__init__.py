from royaltracer_dx_tpu_torch.scene.types import (
    Materials,
    MeshData,
    LightTriangles,
    SceneArrays,
)
from royaltracer_dx_tpu_torch.scene.scene import Scene

__all__ = ["Materials", "MeshData", "LightTriangles", "SceneArrays", "Scene"]
