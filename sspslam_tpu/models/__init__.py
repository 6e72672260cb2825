from .associativememory import AssociativeMemory
from .binding import CircularConvolution, Product, circconv
from .pathintegration import (PathIntegration, PathIntegrationBCsGCs,
                              PathIntegrationGC, PathIntegrationOld,
                              PathIntegrationReencode,
                              get_from_Fourier, get_to_Fourier)
from .slam import (SLAMNetwork, get_anchor_input_functions,
                   get_slam_input_functions, get_slam_input_functions2)
from .slam_gated import SLAMGatedNetwork, SLAMLoihiNetwork
from .slam_view import SLAMViewNetwork, get_slamview_input_functions
from .workingmemory import AdditiveInputGatedMemory

__all__ = [
    "AssociativeMemory",
    "CircularConvolution", "Product", "circconv",
    "PathIntegration", "PathIntegrationOld", "PathIntegrationReencode",
    "PathIntegrationGC", "PathIntegrationBCsGCs",
    "get_to_Fourier", "get_from_Fourier",
    "SLAMNetwork", "get_slam_input_functions", "get_slam_input_functions2",
    "get_anchor_input_functions",
    "SLAMGatedNetwork", "SLAMLoihiNetwork",
    "SLAMViewNetwork", "get_slamview_input_functions",
    "AdditiveInputGatedMemory",
]
