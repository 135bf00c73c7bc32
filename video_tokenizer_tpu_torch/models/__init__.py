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
from . import model_titok  # noqa: F401  (registers titok)
from . import cosmos  # noqa: F401  (registers cosmos and cosmos_fsq)
from . import vfm  # noqa: F401  (registers larp_tokenizer_vfm and larp_tokenizer_vfm_noquant)
from . import sem  # noqa: F401  (registers larp_tokenizer_sem)
from . import vfm_auto  # noqa: F401  (registers the five autoencoder_vfm* names)
from . import model_cnnvit  # noqa: F401  (registers the seven autoencoder_cnnvit* names)
from . import discriminators  # noqa: F401  (registers dino_disc)

from .bottleneck import Bottleneck, SimpleVectorQuantizer  # noqa: F401
from .cosmos import CosmosVideoTokenizer  # noqa: F401
from .discriminators import DinoDisc  # noqa: F401
from .embed import (  # noqa: F401
    LabelEmbedder, LatentContEmbedder, LatentTokenEmbedder, PatchEmbed3D, TimestepEmbedder,
    VideoPatchEmbed,
)
from .fsq import FSQ, LatticeVectorQuantizer  # noqa: F401
from .gptc import GPTC, GPTCConfig  # noqa: F401
from .larp_ar import LARP_AR, ModelArgs, QuantDense, quantize_params  # noqa: F401
from .larp_tokenizer import LARPTokenizer, OutputLayer  # noqa: F401
from .model_basic import BasicAutoEncoder  # noqa: F401
from .model_cnnvit import CNNViTAutoEncoder, ResNAFAutoEncoder  # noqa: F401
from .model_new import RoPEAutoEncoder  # noqa: F401
from .model_stat import AutoEncoderStat  # noqa: F401
from .model_titok import TiTok  # noqa: F401
from .transformer import ViTBlock, ViTStack  # noqa: F401
from .vfm_auto import TeacherSpaceAutoEncoder  # noqa: F401
