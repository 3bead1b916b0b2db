"""The frontend's public names."""

from . import (
    ClusterGeneratorDataset,
    ClusterGeneratorFieldInfo,
    ClusterGeneratorGrid,
    ClusterGeneratorHierarchy,
    ClusterGeneratorIOHandler,
)

__all__ = [
    "ClusterGeneratorDataset", "ClusterGeneratorFieldInfo",
    "ClusterGeneratorGrid", "ClusterGeneratorHierarchy",
    "ClusterGeneratorIOHandler",
]
