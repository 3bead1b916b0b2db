"""yt frontend for the chunked-grid files of :mod:`..data_structures`.

The yt frontend interface (Dataset, Hierarchy, Grid, FieldInfo, IOHandler)
over ``YTHDF5`` files.  The on-disk format is the JAX package's, so the
dataset type and the field names are the same as its frontend's.  ``yt``
is optional: without it, any name of this subpackage raises ImportError
with a clear message, and the rest of the port is unaffected.
"""

try:
    import yt  # noqa: F401

    _HAS_YT = True
except ImportError:  # pragma: no cover - environment without yt
    _HAS_YT = False

if _HAS_YT:
    from .data_structures import (
        ClusterGeneratorDataset,
        ClusterGeneratorGrid,
        ClusterGeneratorHierarchy,
    )
    from .fields import ClusterGeneratorFieldInfo
    from .io import ClusterGeneratorIOHandler

    __all__ = [
        "ClusterGeneratorDataset", "ClusterGeneratorGrid",
        "ClusterGeneratorHierarchy", "ClusterGeneratorFieldInfo",
        "ClusterGeneratorIOHandler",
    ]
else:
    __all__ = []

    def __getattr__(name):
        raise ImportError(
            f"cluster_generator_tpu_torch.frontend.{name} requires the "
            "optional dependency 'yt' (pip install yt).")
