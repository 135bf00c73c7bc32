"""Training-time statistics, FVD (I3D features, Frechet distance), FID
(InceptionV3), JEDi (V-JEPA2 features, polynomial MMD) and MILO of the port."""
from . import statistics  # noqa: F401
from .fid import FIDCalculator  # noqa: F401
from .fvd import FeatureStats, FVDCalculator, frechet_distance  # noqa: F401
from .jedi import JEDiCalculator, polynomial_mmd  # noqa: F401
from .milo import MILOCalculator  # noqa: F401
