"""The ten architectures' configurations (data only) and their reduced
smoke sizes. ``shapes.py`` (the dry-run input specs) is not ported yet."""
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced

__all__ = ["get_config", "reduced", "ARCH_IDS"]
