"""Three steps of the port's tokenizer trainer against the JAX trainer's, on the CPU.

The set-up of `test_torch_trainer_step.py` with the real optimizers (Adam,
betas 0.5/0.9, cosine warm-up from 1% of lr) and `d_update_freq` 2, so the
discriminator steps once (the second step) and the generator three times.
Adam's first update is about +-lr wherever |g| >> eps, whatever |g|, so the
params agree far better than the gradients would bound: the bound is 0.05 lr
per tensor, and at most 1e-4 of all generator weights may differ by more
than 0.01 lr (measured: at most 0.02 lr, on 1e-5 of them, in the output
layer and the last MLP, where the gradients differ most). The optimizers
themselves are held on identical gradients, the LeCam EMAs and the 0.999 EMA
parameters after the three steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from _torch_port import f32, jax_trainer, port_trainer, train_batch, trainer_cfg
from video_tokenizer_tpu.parallel import shard_batch
from video_tokenizer_tpu_torch.trainers.tokenizer_trainer import make_optimizer
from video_tokenizer_tpu_torch.utils.convert import loss_state_dict_from_jax, state_dict_from_jax

G_LR, D_LR = 1e-4, 3e-5


def test_three_steps_match_jax(tmp_path):
    loss = dict(trainer_cfg(tmp_path)["loss"])
    loss["args"] = dict(loss["args"], d_update_freq=2)
    jtr = jax_trainer(trainer_cfg(tmp_path / "jax", loss=loss))
    ptr = port_trainer(trainer_cfg(tmp_path / "port", loss=loss), jtr)
    d_before = {n: p.detach().clone() for n, p in ptr.disc.named_parameters()}
    for s in range(3):
        batch = train_batch(s)
        keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
        want = dict(zip(keys, np.asarray(packed).tolist()))
        keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
        got = dict(zip(keys, packed.tolist()))
        for k in ("loss", "d_loss", "g_loss", "rec_loss", "perceptual_loss", "logits_real"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=f"step {s}: {k}")
        if s == 0:  # no D step yet: the discriminator has not moved
            assert all(torch.equal(p, d_before[n]) for n, p in ptr.disc.named_parameters())
    state = jax.device_get(jtr.state)
    assert int(state["step"]) == ptr.step == 3

    g_want = state_dict_from_jax(state["params"], ptr.model)
    errs = []
    for name, p in ptr.model.named_parameters():
        e = np.abs(f32(p) - g_want[name].numpy()) / G_LR
        assert e.max() <= 0.05, f"{name}: {e.max()} lr"
        errs.append(e.ravel())
    assert np.mean(np.concatenate(errs) > 0.01) <= 1e-4
    d_want = loss_state_dict_from_jax(state["loss_params"], state["loss_ema"], ptr.loss_mod)
    moved = 0
    for name, p in ptr.disc.named_parameters():
        w = d_want[f"discriminator.{name}"].numpy()
        assert np.abs(f32(p) - w).max() <= 0.01 * D_LR, name
        moved += not np.array_equal(w, f32(d_before[name]))
    assert moved  # the D step of step 2 happened on both sides
    for k in ("lecam_ema_real", "lecam_ema_fake"):
        np.testing.assert_allclose(float(getattr(ptr.loss_mod, k)), float(state["loss_ema"][k]),
                                   rtol=1e-5)
    ema_want = state_dict_from_jax(state["ema_params"]["0.999"], ptr.model)
    for name, e in ptr.ema_params["0.999"].items():
        np.testing.assert_allclose(f32(e), ema_want[name].numpy(), atol=1e-6, err_msg=name)


def test_optimizers_match_optax_on_identical_gradients():
    """torch Adam / AdamW / SGD as `make_optimizer` builds them against
    optax's, three steps of the same gradients (some far below eps), with the
    learning rate set per step like the trainer does: to 1e-6 of lr, plus four
    fp32 ulps of the parameter (the two sides round p + update, and AdamW its
    decay, apart)."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(64, 32).astype(np.float32)
    grads = [(rng.randn(64, 32) * rng.choice([1e-12, 1e-6, 1.0], (64, 32))).astype(np.float32)
             for _ in range(3)]
    lrs = [1e-6, 5e-5, 1e-4]
    for name, args, tx in (
        ("adam", {"betas": [0.5, 0.9]}, lambda lr: optax.adam(lr, b1=0.5, b2=0.9)),
        ("adamw", {"betas": [0.5, 0.9], "weight_decay": 0.05},
         lambda lr: optax.adamw(lr, b1=0.5, b2=0.9, weight_decay=0.05)),
        ("sgd", {"momentum": 0.9}, lambda lr: optax.sgd(lr, momentum=0.9)),
    ):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make_optimizer(name, [p], args)
        sched = lambda count: jnp.asarray(lrs)[count]  # noqa: E731
        jtx = tx(sched)
        jp, js = jnp.asarray(p0), None
        js = jtx.init(jp)
        for g, lr in zip(grads, lrs):
            p.grad = torch.from_numpy(g)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            upd, js = jtx.update(jnp.asarray(g), js, jp)
            jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(f32(p), np.asarray(jp), atol=1e-6 * max(lrs), rtol=4.8e-7,
                                   err_msg=name)
