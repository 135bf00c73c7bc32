from ..registry import trainers  # noqa: F401
from .ar_trainer import LARPARFramePredictionTrainer, LARPARTrainer  # noqa: F401
from .base_trainer import BaseTrainer  # noqa: F401
from .tokenizer_trainer import LARPTokenizerTrainer  # noqa: F401  (registers the trainers)
from .tokenizer_trainer_stat import LARPTokenizerTrainerStat  # noqa: F401  (registers it)
