"""Training-time statistics and FVD (I3D features, Frechet distance) of the port."""
from . import statistics  # noqa: F401
from .fvd import FeatureStats, FVDCalculator, frechet_distance  # noqa: F401
