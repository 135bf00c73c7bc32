"""A data-parallel step of the port's tiny tokenizer trainer at 2 and 4 gloo
ranks against the JAX trainer's step (`_torch_port.jax_trainer`: the JAX
package on its 8 virtual CPU devices, deterministic VQ, hinge loss with
LeCam, every weight perturbed), from the same weights: the port's ranks take
the JAX trainer's generator, loss module and EMA starting point
(`tests/_torch_parallel.py::run_ranks`, one launch per world size). Held as
`test_torch_trainer_steps.py` holds one process: the step's losses to 1e-3
relative, the generator's parameters after the update within 0.05 lr per
tensor with at most 1e-4 of them past 0.01 lr (Adam's first update is about
+-lr wherever |g| >> eps), the discriminator's within 0.01 of its lr, the
LeCam EMAs to 1e-5 relative. Every rank's whole state is the same.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parallel import result, run_ranks
from _torch_port import f32, jax_trainer, port_trainer, tokenizer_state_dict_from_jax, train_batch, trainer_cfg
from video_tokenizer_tpu.parallel import shard_batch
from video_tokenizer_tpu_torch.utils.convert import loss_state_dict_from_jax

G_LR, D_LR = 1e-4, 3e-5


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_tok")
    jtr = jax_trainer(trainer_cfg(tmp / "jax"))
    ptr = port_trainer(trainer_cfg(tmp / "port0"), jtr)  # the converters' layout
    host = jax.device_get(jtr.state)
    load = {"params": tokenizer_state_dict_from_jax(host["params"], ptr.model),
            "loss": loss_state_dict_from_jax(host["loss_params"], host["loss_ema"], ptr.loss_mod)}
    batch = train_batch(5, 4)
    keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
    state = jax.device_get(jtr.state)
    return {"tmp": tmp, "load": load, "batch": {"gt": torch.from_numpy(batch["gt"]),
                                                "label": torch.from_numpy(batch["label"])},
            "info": dict(zip(keys, np.asarray(packed).tolist())),
            "params": tokenizer_state_dict_from_jax(state["params"], ptr.model),
            "disc": loss_state_dict_from_jax(state["loss_params"], state["loss_ema"], ptr.loss_mod)}


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_tokenizer_step_matches_jax_trainer(jax_step, world):
    cfg = trainer_cfg(jax_step["tmp"] / f"port{world}").to_dict()
    cfg["trainer"] = "larp_tokenizer_trainer"
    job = {"scenario": "trainer_steps", "cfg": cfg, "batches": [jax_step["batch"]],
           "load": jax_step["load"]}
    outs = run_ranks([("tok_jax", job)], world, jax_step["tmp"] / f"job{world}")
    got = result(outs, "tok_jax")
    for k in ("loss", "d_loss", "g_loss", "rec_loss", "perceptual_loss", "logits_real"):
        np.testing.assert_allclose(got["infos"][0][k], jax_step["info"][k], rtol=1e-3, err_msg=k)
    errs = []
    for name, want in jax_step["params"].items():
        if name not in got["ema"]["0.999"]:  # buffers (the fixed PEs): not trained
            continue
        e = np.abs(f32(got["params"][name]) - want.numpy()) / G_LR
        assert e.max() <= 0.05, f"{name}: {e.max()} lr"
        errs.append(e.ravel())
    assert np.mean(np.concatenate(errs) > 0.01) <= 1e-4
    for name, want in jax_step["disc"].items():
        if name.startswith("discriminator."):
            np.testing.assert_allclose(f32(got["disc"][name]), want.numpy(), atol=0.01 * D_LR,
                                       err_msg=name)
    for k in ("lecam_ema_real", "lecam_ema_fake"):
        np.testing.assert_allclose(float(got["disc"][k]), float(jax_step["disc"][k]), rtol=1e-5)
    for r in range(1, world):
        other = result(outs, "tok_jax", r)
        assert all(torch.equal(other["params"][n], got["params"][n]) for n in got["params"])
