"""sspslam_tpu — spiking semantic SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``nsdumont/Semantic-Spiking-Neural-SLAM-2023``: SSP vector-symbolic algebra,
a NEF spiking-network engine compiled to a single jitted ``lax.scan`` step
function, path-integration / associative-memory / SLAM model compositions,
and mesh-sharded multi-device execution.
"""

from .version import version as __version__

from .sspspace import (
    SPSpace,
    SSPSpace,
    RandomSSPSpace,
    HexagonalSSPSpace,
    RectangularSSPSpace,
)

from . import nef
from . import ops
from . import utils
from . import models
from .models import (
    AssociativeMemory,
    CircularConvolution,
    PathIntegration,
    Product,
    SLAMGatedNetwork,
    SLAMNetwork,
    SLAMViewNetwork,
)
# keep a `networks` alias mirroring the reference package layout
networks = models

__all__ = [
    "SPSpace",
    "SSPSpace",
    "RandomSSPSpace",
    "HexagonalSSPSpace",
    "RectangularSSPSpace",
    "nef",
    "ops",
    "utils",
    "models",
    "networks",
    "AssociativeMemory",
    "CircularConvolution",
    "PathIntegration",
    "Product",
    "SLAMGatedNetwork",
    "SLAMNetwork",
    "SLAMViewNetwork",
    "__version__",
]
