from ..registry import datasets  # noqa: F401
from .loader import make_loader  # noqa: F401
from .video_dataset import VideoDataset  # noqa: F401  (registers video_dataset)
