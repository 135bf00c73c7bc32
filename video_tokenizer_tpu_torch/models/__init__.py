from ..registry import models  # noqa: F401
from . import transformer  # noqa: F401  (registers the stacks)
from . import bottleneck  # noqa: F401  (registers bottleneck, vq, skl)
from . import gptc  # noqa: F401  (registers gptc and its zoo)
from . import larp_tokenizer  # noqa: F401  (registers larp_tokenizer)
from . import larp_ar  # noqa: F401  (registers larp_ar and the llama-abs zoo)
from . import loss  # noqa: F401  (registers lpips_disc_loss)
from . import model_new  # noqa: F401  (registers the ten model_new autoencoders)
from . import model_basic  # noqa: F401  (registers the five basic / dual-patch autoencoders)
from . import model_stat  # noqa: F401  (registers autoencoder_stat)

from .bottleneck import Bottleneck, SimpleVectorQuantizer  # noqa: F401
from .embed import LabelEmbedder, PatchEmbed3D, VideoPatchEmbed  # noqa: F401
from .fsq import FSQ, LatticeVectorQuantizer  # noqa: F401
from .gptc import GPTC, GPTCConfig  # noqa: F401
from .larp_ar import LARP_AR, ModelArgs, QuantDense, quantize_params  # noqa: F401
from .larp_tokenizer import LARPTokenizer, OutputLayer  # noqa: F401
from .model_basic import BasicAutoEncoder  # noqa: F401
from .model_new import RoPEAutoEncoder  # noqa: F401
from .model_stat import AutoEncoderStat  # noqa: F401
from .transformer import ViTBlock, ViTStack  # noqa: F401
