"""The ten architectures' configurations (data only), their reduced smoke
sizes, and the dry-run's input shapes."""
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, applicable,
                                        input_specs)

__all__ = ["get_config", "reduced", "ARCH_IDS", "SHAPES", "ShapeSpec",
           "input_specs", "applicable"]
