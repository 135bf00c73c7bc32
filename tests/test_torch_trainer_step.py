"""One step of the port's tokenizer trainer against the JAX trainer's, on the CPU.

Both trainers start from the same perturbed weights (`tests/_torch_port.py`:
a tiny tokenizer with deterministic VQ, a 1-layer transformer discriminator,
the VGG16 LPIPS, hinge loss, LeCam on) and take one step on the same clips.
The JAX trainer's optimizers are replaced by transforms that keep the step's
gradients and apply nothing; the port's run at learning rate 0, so its
`.grad`s are the step's gradients and the discriminator the generator loss
sees is the same on both sides. Held: every logged scalar (1e-4 relative,
1e-6 absolute) and every G and D gradient, to 5e-4 of each tensor's max |g|:
fp32 on both sides, but the pixel loss's sign(pred - data) flips where the
two reconstructions straddle a clip's pixel, and the LPIPS backward runs
through 13 VGG layers; measured at most 1.7e-4 (the output layer, which the
pixel loss reaches first), below 6e-5 elsewhere.
"""
import jax
import numpy as np
import torch

from _torch_port import f32, jax_trainer, port_trainer, train_batch, trainer_cfg
from video_tokenizer_tpu.parallel import shard_batch
from video_tokenizer_tpu_torch.ops.attention import flash_attn_bwd_dkv, flash_attn_bwd_dq
from video_tokenizer_tpu_torch.utils.convert import loss_state_dict_from_jax, state_dict_from_jax

GRAD_REL = 5e-4


def _close(got: torch.Tensor, want: np.ndarray, name: str):
    err = np.abs(f32(got) - want).max()
    assert err <= GRAD_REL * np.abs(want).max() + 1e-12, f"{name}: {err} vs {np.abs(want).max()}"


def test_first_step_gradients_and_info_match_jax(tmp_path):
    jtr = jax_trainer(trainer_cfg(tmp_path / "jax"), capture_grads=True)
    lr0 = {"name": "adam", "args": {"lr": 0.0, "betas": [0.5, 0.9]},
           "loss_args": {"lr": 0.0, "betas": [0.5, 0.9]}, "lr_type": "step"}
    ptr = port_trainer(trainer_cfg(tmp_path / "port", optimizer=lr0), jtr)
    batch = train_batch()
    keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
    want_info = dict(zip(keys, np.asarray(packed).tolist()))
    flash_attn_bwd_dq.launches = flash_attn_bwd_dkv.launches = 0
    keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
    got_info = dict(zip(keys, packed.tolist()))
    assert (flash_attn_bwd_dq.launches, flash_attn_bwd_dkv.launches) == (0, 0)  # CPU: plain path

    assert set(got_info) == set(want_info), set(got_info) ^ set(want_info)
    for k, v in want_info.items():
        np.testing.assert_allclose(got_info[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert want_info["d_loss"] > 0 and want_info["perceptual_loss"] > 0

    state = jax.device_get(jtr.state)
    g_want = state_dict_from_jax(state["opt_g"]["g"], ptr.model)
    named = dict(ptr.model.named_parameters())
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad, g_want[name].numpy(), name)
    d_tree = state["opt_d"].inner_states["train"].inner_state["g"]["discriminator"]
    d_want = loss_state_dict_from_jax(
        {"discriminator": d_tree, "perceptual": state["loss_params"]["perceptual"]},
        state["loss_ema"], ptr.loss_mod)
    for name, p in ptr.loss_mod.named_parameters():
        if name.startswith("discriminator."):
            assert p.grad is not None, name
            _close(p.grad, d_want[name].numpy(), name)
        else:  # LPIPS is frozen
            assert p.grad is None and not p.requires_grad, name
    # the LeCam EMAs advanced like the JAX trainer's
    for k in ("lecam_ema_real", "lecam_ema_fake"):
        np.testing.assert_allclose(float(getattr(ptr.loss_mod, k)), float(state["loss_ema"][k]),
                                   rtol=1e-5, atol=1e-9)
