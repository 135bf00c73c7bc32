"""video_tokenizer_tpu_torch: the PyTorch/CUDA port of video_tokenizer_tpu.

The JAX package beside it is the reference. This package imports `torch`
and never `jax`. Its hot paths run hand-written CUDA kernels
(`csrc/flash_attn_fwd.cu`, `csrc/flash_attn_bwd.cu`, `csrc/vq_lookup.cu`,
`csrc/decode_attention.cu`, `csrc/w8_matmul.cu`, `csrc/chunk_attention.cu`,
`csrc/cache_update.cu`), built with `nvcc` at first use on a card; on CPU
tensors their plain PyTorch versions run instead. Covered so far: inference
through the LARP tokenizer with the 'vq' bottleneck (encode, VQ, decode);
class-conditional (or frame-prediction) sampling from the LARP AR prior with
CFG, top-k/top-p, int8 weights and an int8 KV cache (`generation.generate`,
`sample.py`), also speculatively with a draft model or the prior's own first
layers (`generation.speculative_generate`, `tools/distill_draft.py`); GAN
training of the tokenizer with LPIPS and a transformer discriminator; and
training of the AR prior, class-conditional or frame-prediction, on the
codes of a frozen tokenizer (`trainers`, `train.py`); the model_new
tokenizers (conv-patchify, M-RoPE, FSQ: `models/model_new.py`), for
reconstruction and training; and FVD (`metrics/i3d.py`, `metrics/fvd.py`):
the rFVD evaluator and its CLI (`eval/`), the merge CLI of per-job stats,
eval rFVD with the best checkpoint by FVD in the tokenizer trainer, sample
gFVD in the AR trainer, and FVD in class-conditional `sample.py`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import models  # noqa: F401  (registers the models)
from .models import LARP_AR, LARPTokenizer, ModelArgs
from .models.larp_ar import quantize_model

__version__ = "0.1.0"

FLAGSHIP_VQ = {
    "name": "bottleneck",
    "args": {
        "bottleneck_dim": 8,
        "norm": "none",
        "regularizer": {
            "name": "vq",
            "args": {
                "codebook_size": 8192,
                "commitment_loss_weight": 0.25,
                "codebook_loss_weight": 1.0,
                "l2_normalized": True,
                "stochastic": True,
                "stochastic_temperature": 0.03,
            },
        },
    },
}


# the flagship tokenizer's constructor arguments (JSON-able: the `args` of an
# upstream-format `.pth` spec)
FLAGSHIP_TOKENIZER = dict(
    bottleneck=FLAGSHIP_VQ,
    prior_model={"name": "none"},
    bottleneck_token_num=1024,
    input_size=128,
    frame_num=16,
    temporal_patch_size=4,
    patch_size=8,
    decoder_temporal_patch_size=4,
    decoder_patch_size=8,
    bottleneck_type="vq",
    encoder_hidden_size=768,
    decoder_hidden_size=768,
    encoder_num_heads=12,
    decoder_num_heads=12,
    encoder_depth=12,
    decoder_depth=12,
)


def flagship_tokenizer(dtype: torch.dtype = torch.bfloat16,
                       generator: Optional[torch.Generator] = None, device=None,
                       **overrides) -> LARPTokenizer:
    """LARP-L-long geometry (`FLAGSHIP_TOKENIZER`): 16x128x128 clips, patch
    (4, 8, 8), d = 768, 12 + 12 layers of 12 heads, 1024 latent tokens,
    VQ-8192 of dim 8. The same arguments as the JAX package's
    `__graft_entry__.flagship_tokenizer`."""
    args = dict(FLAGSHIP_TOKENIZER, dtype=dtype, generator=generator, device=device)
    args.update(overrides)
    return LARPTokenizer(**args)


def flagship_ar(dtype: torch.dtype = torch.bfloat16,
                generator: Optional[torch.Generator] = None, device=None,
                quantized: bool = False, **overrides) -> LARP_AR:
    """The 632M `llama-abs-LP` prior at the geometry of the JAX package's AR
    sampling benchmark (`bench.py:394-398`): 30 layers, dim 1280, 20 heads of
    64 (MHA), SwiGLU hidden 3584, vocab 8192, 101 classes, max_seq_len 1024,
    dropouts 0; 631,975,680 parameters. Built on `device` (the CPU when
    None) from the draws of `generator`, which must live there: one seed
    gives other weights on the card than on the host (the card's generator
    draws its own sequence, in a fraction of the host's time). Cast to
    `dtype` (bf16 serving casts every float tensor, as the JAX `sample.py`
    does), then with `quantized=True` every projection is converted to int8
    weights + fp32 per-channel scales (`--dtype int8`). Weights are random
    (the output head starts at zero); load trained ones with
    `LARP_AR.from_checkpoint`."""
    args = dict(n_layer=30, n_head=20, dim=1280, vocab_size=8192, num_classes=101,
                max_seq_len=1024, token_dropout_p=0.0, resid_dropout_p=0.0,
                ffn_dropout_p=0.0)
    args.update(overrides)
    device = torch.device("cpu" if device is None else device)
    if generator is not None and generator.device.type != device.type:
        raise ValueError(f"flagship_ar: a generator on {generator.device} cannot draw a model "
                         f"built on {device}")
    model = LARP_AR(ModelArgs(**args), generator=generator, device=device).to(dtype)
    if quantized:
        model = quantize_model(model)
    return model.eval()


def flagship_draft(dtype: torch.dtype = torch.bfloat16,
                   generator: Optional[torch.Generator] = None, device=None,
                   quantized: bool = False, **overrides) -> LARP_AR:
    """The ~60M draft that the JAX package's speculative benchmark pairs with
    the 632M prior (`bench.py:468`): 8 layers, dim 768, 12 heads of 64, the
    target's other arguments (`flagship_ar`); 70,083,840 parameters."""
    args = dict(n_layer=8, n_head=12, dim=768)
    args.update(overrides)
    return flagship_ar(dtype, generator, device, quantized, **args)
