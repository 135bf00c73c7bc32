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


# `--opts` that shrink cfgs/larp_tokenizer.yaml to trainer_cfg's geometry
TINY_TOKENIZER_OPTS = [
    "model.args.encoder_depth", "1", "model.args.decoder_depth", "1",
    "model.args.encoder_hidden_size", "64", "model.args.decoder_hidden_size", "64",
    "model.args.encoder_num_heads", "2", "model.args.decoder_num_heads", "2",
    "model.args.bottleneck_token_num", "16",
    "model.args.bottleneck.args.regularizer.args.codebook_size", "64",
    "loss.args.disc_tran_n_layers", "1", "loss.args.disc_tran_hidden_size", "64",
    "loss.args.disc_tran_n_heads", "2"]


def trainer_cfg(save_dir, **over):
    """A tiny tokenizer-trainer config (the geometry of tests/test_trainers.py's
    `_tok_cfg`) with deterministic VQ and the hinge GAN loss, so that no draw
    differs between the JAX trainer and the port's; LeCam on."""
    from video_tokenizer_tpu.config import ConfigDict

    cfg = {
        "save_dir": str(save_dir), "manualSeed": 0, "max_epoch": 1, "eval_epoch": 10,
        "vis_epoch": 10, "latest_interval": 1, "loss_q_weight": 0.1, "use_amp": False,
        "ema_decay": "0.999",
        "train_dataset": {
            "name": "video_dataset",
            "args": {"root_path": str(save_dir), "split": "train", "frame_num": 8,
                     "csv_file": "null128", "crop_size": 32, "cls_vid_num": "-1_-1"},
            "loader": {"batch_size": 2, "num_workers": 0},
        },
        "model": {"name": "larp_tokenizer", "args": {
            "bottleneck": {"name": "bottleneck", "args": {
                "bottleneck_dim": 8, "norm": "none",
                "regularizer": {"name": "vq", "args": {
                    "codebook_size": 64, "l2_normalized": True, "stochastic": False}},
            }},
            "prior_model": {"name": "none"}, "bottleneck_token_num": 16, "input_size": 32,
            "frame_num": 8, "encoder_hidden_size": 64, "decoder_hidden_size": 64,
            "encoder_num_heads": 2, "decoder_num_heads": 2, "encoder_depth": 1,
            "decoder_depth": 1,
        }},
        "loss": {"name": "lpips_disc_loss", "args": {
            "disc_start": 0, "disc_loss": "hinge", "disc_weight": 0.3, "d_update_freq": 1,
            "lecam_weight": 0.001, "disc_tran_hidden_size": 64, "disc_tran_n_heads": 2,
            "disc_tran_n_layers": 1, "disc_tran_temporal_patch_size": 4,
            "disc_tran_patch_size": 8, "input_spatial_size": 32, "frame_num": 8,
        }},
        "optimizer": {
            "name": "adam", "args": {"lr": 1e-4, "betas": [0.5, 0.9]},
            "loss_args": {"lr": 3e-5, "betas": [0.5, 0.9]},
            "lr_type": "cosine", "warmup_epoch": 1, "min_lr_mult": 0.01,
        },
    }
    cfg.update(over)
    return ConfigDict(cfg)


def ar_trainer_cfg(save_dir, name="larp_ar_trainer", **over):
    """A tiny AR-trainer config (the geometry of tests/test_trainers.py's
    `_ar_cfg`): the tokenizer of `trainer_cfg` as an inline frozen vae (16
    tokens, codebook 64), a prior of dim 64, 1 layer, 4 heads, every dropout
    0; AdamW (lr 6e-4, weight decay 0.05) on a cosine warm-up; 8 frames, the
    first 4 the frame-prediction condition."""
    cfg = trainer_cfg(save_dir)
    del cfg["loss"]
    cfg["trainer"] = name
    cfg["vae"] = {"name": "larp_tokenizer", "checkpoint": "",
                  "args": cfg["model"]["args"].to_dict()}
    cfg["model"] = {"name": "larp_ar", "args": {
        "num_classes": 101, "token_dropout_p": 0.0, "resid_dropout_p": 0.0,
        "ffn_dropout_p": 0.0, "class_dropout_prob": 0.0, "dim": 64, "n_layer": 1, "n_head": 4}}
    cfg["ar"] = {"num_samples": 2, "sample_batch_size": 2, "num_frames": 8, "num_cond_frames": 4}
    cfg["optimizer"] = {"name": "adamw", "args": {"lr": 6e-4, "weight_decay": 0.05},
                        "lr_type": "cosine", "warmup_epoch": 1, "min_lr_mult": 0.1}
    cfg.update(over)
    return cfg


def jax_trainer(cfg, capture_grads=False):
    """The JAX LARPTokenizerTrainer at epoch 1 with perturbed weights (the
    EMA starts from them). With `capture_grads`, both optimizers are replaced
    by transforms that apply no update and keep the step's gradients as
    their state (`opt_g['g']`, and the discriminator's masked tree)."""
    import optax

    import video_tokenizer_tpu.data  # noqa: F401
    import video_tokenizer_tpu.models  # noqa: F401
    import video_tokenizer_tpu.trainers  # noqa: F401
    from video_tokenizer_tpu.parallel import replicated_sharding
    from video_tokenizer_tpu.registry import trainers

    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    state = dict(tr.state)
    state["params"] = perturb(state["params"], seed=11)
    state["loss_params"] = perturb(state["loss_params"], seed=12)
    state["ema_params"] = {d: state["params"] for d in state["ema_params"]}
    if capture_grads:
        def capture():
            zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
            return optax.GradientTransformation(
                lambda p: {"g": zeros(p)}, lambda g, s, p=None: (zeros(g), {"g": g}))
        tr.g_tx = capture()
        tr.d_tx = optax.multi_transform(
            {"train": capture(), "freeze": optax.set_to_zero()},
            lambda p: {k: "train" if k == "discriminator" else "freeze" for k in p})
        state["opt_g"] = tr.g_tx.init(state["params"])
        state["opt_d"] = tr.d_tx.init(state["loss_params"])
    tr.state = jax.device_put(state, replicated_sharding(tr.mesh))
    return tr


def tokenizer_state_dict_from_jax(params, model):
    """The converter of `model`'s family: a model_new autoencoder's, else the
    LARP tokenizer's."""
    from video_tokenizer_tpu_torch.models import RoPEAutoEncoder
    from video_tokenizer_tpu_torch.utils.convert import (
        model_new_state_dict_from_jax, state_dict_from_jax,
    )

    convert = (model_new_state_dict_from_jax if isinstance(model, RoPEAutoEncoder)
               else state_dict_from_jax)
    return convert(params, model)


def port_trainer(cfg, jax_tr):
    """The port's LARPTokenizerTrainer on the CPU, at epoch 1, with the JAX
    trainer's weights, LeCam EMAs and EMA parameters."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers
    from video_tokenizer_tpu_torch.utils.convert import loss_state_dict_from_jax

    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    host = jax.device_get(jax_tr.state)
    tr.model.load_state_dict(tokenizer_state_dict_from_jax(host["params"], tr.model), strict=True)
    tr.loss_mod.load_state_dict(
        loss_state_dict_from_jax(host["loss_params"], host["loss_ema"], tr.loss_mod), strict=True)
    tr.ema_params = {d: {n: p.detach().clone() for n, p in tr.model.named_parameters()}
                     for d in tr.ema_params}
    return tr


def jax_ar_trainer(cfg):
    """The JAX AR trainer (`cfg["trainer"]`) at epoch 1 with perturbed prior
    weights (the EMA starts from them); its frozen vae is its seeded init."""
    import video_tokenizer_tpu.data  # noqa: F401
    import video_tokenizer_tpu.models  # noqa: F401
    import video_tokenizer_tpu.trainers  # noqa: F401
    from video_tokenizer_tpu.parallel import replicated_sharding
    from video_tokenizer_tpu.registry import trainers

    tr = trainers.make({"name": cfg["trainer"]}, args={"cfg": cfg})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    state = dict(tr.state)
    state["params"] = perturb(state["params"], seed=11)
    state["ema_params"] = {d: state["params"] for d in state["ema_params"]}
    tr.state = jax.device_put(state, replicated_sharding(tr.mesh))
    return tr


def port_ar_trainer(cfg, jax_tr=None):
    """The port's AR trainer on the CPU at epoch 1; with `jax_tr`, its vae
    and prior weights are the JAX trainer's (the EMA starts from them)."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers
    from video_tokenizer_tpu_torch.utils.convert import ar_state_dict_from_jax, state_dict_from_jax

    tr = trainers.make({"name": cfg["trainer"]}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    if jax_tr is not None:
        host = jax.device_get(jax_tr.state)
        tr.vae.load_state_dict(state_dict_from_jax(jax.device_get(jax_tr.vae_params), tr.vae),
                               strict=True)
        tr.model.load_state_dict(ar_state_dict_from_jax(host["params"], tr.model), strict=True)
        tr.ema_params = {d: {n: p.detach().clone() for n, p in tr.model.named_parameters()}
                         for d in tr.ema_params}
    return tr


def ar_batch(seed=0, batch=2):
    """Clips and class labels of one AR-trainer batch (numpy)."""
    rng = np.random.RandomState(seed)
    return {"gt": clips(seed, batch), "label": rng.randint(0, 101, batch).astype(np.int32)}


def train_batch(seed=0, batch=2):
    return {"gt": clips(seed, batch), "label": np.zeros(batch, np.int32)}


def clips(seed=0, batch=2, frames=8, size=32):
    return np.random.RandomState(seed).rand(batch, 3, frames, size, size).astype(np.float32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)
