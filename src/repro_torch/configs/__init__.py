"""Architecture configs: the reference's ten architectures, its four
input shapes (``SHAPES``) and the VGG-B conv layers."""
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig, SHAPES
from repro_torch.configs.archs import ARCHS, get_arch, smoke_config
from repro_torch.configs.vggb import VGGB_LAYERS

__all__ = [
    "ArchConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS",
    "get_arch", "smoke_config", "VGGB_LAYERS",
]
