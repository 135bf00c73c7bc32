"""Shared set-up for the tests that hold the PyTorch port against the JAX package.

A tiny LARP tokenizer (depth 2 + 2, hidden 128, 2 heads of 64, 32 latent
tokens, 8 x 32 x 32 clips, VQ 64 codes of dim 8) is initialised in JAX, every
weight of rank >= 2 is perturbed by 0.02 * N(0, 1) with numpy (the output
layer is zero-initialised, so a fresh model would decode zeros), and the
same weights reach the port through `state_dict_from_jax`.

A tiny LARP AR prior (2 layers, dim 128, 2 heads of 64, vocab 64, 10
classes, max_seq_len 16, dropouts 0, fp32) is made the same way and reaches
the port through `ar_state_dict_from_jax`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY_VQ = {
    "name": "bottleneck",
    "args": {
        "bottleneck_dim": 8,
        "norm": "none",
        "regularizer": {
            "name": "vq",
            "args": {
                "codebook_size": 64,
                "commitment_loss_weight": 0.25,
                "codebook_loss_weight": 1.0,
                "l2_normalized": True,
                "stochastic": True,
                "stochastic_temperature": 0.03,
            },
        },
    },
}

TINY_ARGS = dict(
    bottleneck=TINY_VQ,
    prior_model={"name": "none"},
    bottleneck_token_num=32,
    input_size=32,
    frame_num=8,
    temporal_patch_size=4,
    patch_size=8,
    decoder_temporal_patch_size=4,
    decoder_patch_size=8,
    bottleneck_type="vq",
    encoder_hidden_size=128,
    decoder_hidden_size=128,
    encoder_num_heads=2,
    decoder_num_heads=2,
    encoder_depth=2,
    decoder_depth=2,
)


def perturb(params, seed=9, scale=0.02):
    """numpy copy of a Flax param tree, rank >= 2 leaves + scale * N(0, 1)."""
    rng = np.random.RandomState(seed)

    def leaf(x):
        x = np.asarray(x, np.float32)
        return x + scale * rng.randn(*x.shape).astype(np.float32) if x.ndim >= 2 else x

    return jax.tree_util.tree_map(leaf, params)


def jax_tokenizer(dtype=jnp.float32, **overrides):
    """(Flax LARPTokenizer, perturbed numpy params)."""
    from video_tokenizer_tpu.models import LARPTokenizer

    args = {**TINY_ARGS, **overrides}
    model = LARPTokenizer(**args, dtype=dtype)
    x = jnp.zeros((1, 3, args["frame_num"], args["input_size"], args["input_size"]))
    variables = model.init({"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)}, x)
    return model, perturb(variables["params"])


def port_tokenizer(params, dtype=torch.float32, **overrides):
    """The port's LARPTokenizer with the JAX params loaded (strict)."""
    from video_tokenizer_tpu_torch.models import LARPTokenizer
    from video_tokenizer_tpu_torch.utils.convert import state_dict_from_jax

    model = LARPTokenizer(**{**TINY_ARGS, **overrides}, dtype=dtype,
                          generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model.eval()


TINY_AR = dict(
    n_layer=2, n_head=2, dim=128, vocab_size=64, num_classes=10, max_seq_len=16,
    token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0,
)


def jax_ar(prompt_len=4, **overrides):
    """(Flax LARP_AR, perturbed numpy params). A frame-prediction prior is
    initialised on [1, prompt_len] prompt tokens."""
    from video_tokenizer_tpu.models.larp_ar import LARP_AR, ModelArgs

    cfg = ModelArgs(**{**TINY_AR, **overrides})
    model = LARP_AR(cfg)
    cond = jnp.zeros((1, prompt_len) if cfg.frame_prediction else (1,), jnp.int32)
    variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32), cond)
    return model, perturb(variables["params"])


def port_ar(params, **overrides):
    """The port's LARP_AR with the JAX params loaded (strict), in eval mode."""
    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs
    from video_tokenizer_tpu_torch.utils.convert import ar_state_dict_from_jax

    model = LARP_AR(ModelArgs(**{**TINY_AR, **overrides}), generator=torch.Generator().manual_seed(0))
    model.load_state_dict(ar_state_dict_from_jax(params, model), strict=True)
    return model.eval()


def clips(seed=0, batch=2, frames=8, size=32):
    return np.random.RandomState(seed).rand(batch, 3, frames, size, size).astype(np.float32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)
