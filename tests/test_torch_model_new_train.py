"""One step of the port's tokenizer trainer on a model_new autoencoder against the JAX trainer's.

On the CPU.

A tiny `autoencoder_large` (width 256, 4 + 4 gated blocks, FSQ-64000, 16
latent tokens) with the 1-layer transformer discriminator, LPIPS and the
hinge loss, in the pattern of `tests/test_torch_trainer_step.py`: both
trainers start from the same perturbed weights; the JAX trainer's
optimizers keep the gradients and apply nothing, the port's run at learning
rate 0. Held: every logged scalar (1e-4 relative, 1e-6 absolute; the FSQ
index statistics over 64,000 codes among them), every D gradient to 5e-4
of its tensor's max |g| and every G gradient to 2.5e-3. The pixel loss's
sign flips where the two reconstructions straddle a pixel (and LPIPS's
backward runs through 13 VGG layers); the encoder sees those differences
through the 16 latent codes alone and reads the most (the test prints the
largest difference of each stack). The model's own backward is held tighter, against JAX's on a
fixed output gradient (`tests/test_torch_model_new.py`).
"""
import jax
import numpy as np
import torch

from _torch_port import (
    f32, jax_trainer, port_trainer, tokenizer_state_dict_from_jax, train_batch, trainer_cfg,
)
from video_tokenizer_tpu.parallel import shard_batch
from video_tokenizer_tpu_torch.models import RoPEAutoEncoder
from video_tokenizer_tpu_torch.ops.attention import flash_attn_bwd_dkv, flash_attn_bwd_dq
from video_tokenizer_tpu_torch.utils.convert import loss_state_dict_from_jax

GRAD_REL = 5e-4
G_GRAD_REL = 2.5e-3
TINY_LARGE = {"name": "autoencoder_large", "args": {
    "model_size": "tiny", "num_latent_tokens": 16, "input_size": 32, "frame_num": 8,
    "patch_size": (4, 8, 8)}}


def _close(got: torch.Tensor, want: np.ndarray, name: str, rel: float = GRAD_REL) -> float:
    err = np.abs(f32(got) - want).max()
    assert err <= rel * np.abs(want).max() + 1e-12, f"{name}: {err} vs {np.abs(want).max()}"
    return float(err / max(np.abs(want).max(), 1e-30))


def test_first_step_gradients_and_info_match_jax(tmp_path):
    jtr = jax_trainer(trainer_cfg(tmp_path / "jax", model=TINY_LARGE), capture_grads=True)
    lr0 = {"name": "adam", "args": {"lr": 0.0, "betas": [0.5, 0.9]},
           "loss_args": {"lr": 0.0, "betas": [0.5, 0.9]}, "lr_type": "step"}
    ptr = port_trainer(trainer_cfg(tmp_path / "port", model=TINY_LARGE, optimizer=lr0), jtr)
    assert isinstance(ptr.model, RoPEAutoEncoder) and ptr.model.codebook_size == 64_000
    batch = train_batch()
    keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
    want_info = dict(zip(keys, np.asarray(packed).tolist()))
    flash_attn_bwd_dq.launches = flash_attn_bwd_dkv.launches = 0
    keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
    got_info = dict(zip(keys, packed.tolist()))
    assert (flash_attn_bwd_dq.launches, flash_attn_bwd_dkv.launches) == (0, 0)  # CPU: plain path

    assert set(got_info) == set(want_info), set(got_info) ^ set(want_info)
    assert {"index_usage", "perplexity", "kl_uni", "loss_q"} <= set(got_info)
    for k, v in want_info.items():
        np.testing.assert_allclose(got_info[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert want_info["d_loss"] > 0 and want_info["perceptual_loss"] > 0

    state = jax.device_get(jtr.state)
    g_want = tokenizer_state_dict_from_jax(state["opt_g"]["g"], ptr.model)
    worst = {}
    for name, p in ptr.model.named_parameters():
        assert p.grad is not None, name
        stack = name.split(".")[0]
        worst[stack] = max(worst.get(stack, 0.0), _close(p.grad, g_want[name].numpy(), name,
                                                          G_GRAD_REL))
    print("largest G gradient difference / max|g| by stack:", worst)
    d_tree = state["opt_d"].inner_states["train"].inner_state["g"]["discriminator"]
    d_want = loss_state_dict_from_jax(
        {"discriminator": d_tree, "perceptual": state["loss_params"]["perceptual"]},
        state["loss_ema"], ptr.loss_mod)
    for name, p in ptr.loss_mod.named_parameters():
        if name.startswith("discriminator."):
            assert p.grad is not None, name
            _close(p.grad, d_want[name].numpy(), name)
