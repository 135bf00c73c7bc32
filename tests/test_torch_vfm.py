"""The port's V-JEPA2-teacher tokenizers (`models/vfm.py`) against the JAX package, on the CPU.

Tiny sizes: a teacher of width 160 with 2 heads (head dim 80, the registered
teacher's) or 128 with 2 heads (head dim 64), 4 layers tapped after each
(the pyramid fusion unpacks four taps), on 8 x 32 x 32 clips (a 4 x 2 x 2
token grid); students of width 64, one layer each, 8 latents, the Leech
`sq` on 512 codes of the lattice or a 64-code `vq`. Parameters are numpy
draws on the shapes of the JAX init (`jax.eval_shape`, nothing run): kernels
N(0, 1 / fan_in), biases 0.02 N(0, 1), norm scales 1 + 0.1 N(0, 1) (so the
zero-initialised `proj_up` and output layer are exercised), the `sq`
codebook the lattice's, carried to the port by `vfm_state_dict_from_jax`.
The JAX side runs jitted on XLA:CPU (its attention the XLA path), fp32. Held:
  * the teacher's taps at head dim 80 and 64, and each fusion (gated,
    pyramid, concat) on its own, within 1e-5 of their scale (fp32 products
    summed in other orders);
  * both registrations whole, `sq` and `vq`, every fusion (`last` too):
    `pred_frames` within 1e-5 of the scale, `align_loss`, `loss_q` and the
    codebook entropy within 1e-5 relative, the indices equal;
  * the gradients of mean |pred - x| + 0.2 align_loss + 0.1 loss_q against
    `jax.grad` within 1e-4 of each tensor's max |g|; the JAX teacher's
    gradients are exactly 0, the port's teacher has none;
  * a bf16-built model: the taps, the fusion, the bottleneck and the loss in
    fp32 as in the Flax policy, its output no farther from the fp32 JAX model
    than 2x the JAX module's own bf16 output is (and 1e-3 of the scale);
  * `frame_num`, `input_size` and the teacher grid; `load_teacher_weights`
    from an `.npz` written from a seeded JAX tree, the taps then equal to the
    JAX module's with the same file;
  * one trainer step against the JAX trainer (constant Adam lr 1e-3): every
    logged scalar within 1e-4 relative, `align_loss` among them and in the
    total at 0.2, the teacher's parameters unchanged bit for bit on both
    sides, the student's moved;
  * the full-width parameter counts (the JAX init's, by `jax.eval_shape`).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)
from _torch_port import jax_trainer, train_batch, trainer_cfg
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import vfm as jv
from video_tokenizer_tpu.models.fsq import leech_lattice_codebook
from video_tokenizer_tpu.parallel import shard_batch
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import vfm as tv
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import (
    flax_tree_state_dict, loss_state_dict_from_jax, vfm_state_dict_from_jax,
)

TEACHER = dict(teacher_dim=160, teacher_depth=4, teacher_heads=2, vjepa2_img_size=32,
               vjepa2_num_frames=8, vjepa2_patch_size=16, vjepa2_tubelet_size=2,
               out_layers=(0, 1, 2, 3))
STUDENT = dict(bottleneck_token_num=8, encoder_hidden_size=64, decoder_hidden_size=64,
               encoder_num_heads=2, decoder_num_heads=2, encoder_depth=1, decoder_depth=1,
               imagedec_hidden_size=64, imagedec_depth=1, imagedec_heads=2, sq_n_embed=512)
VQ = {"name": "bottleneck", "args": {"bottleneck_dim": 8, "norm": "none", "regularizer": {
    "name": "vq", "args": {"codebook_size": 64, "l2_normalized": True, "stochastic": False}}}}
NOQUANT = dict(decoder_hidden_size=64, dec_depth=1, dec_heads=2)
CLIP = (2, 3, 8, 32, 32)
TOL = 1e-5


def _draw(shapes, seed):
    """Numpy parameters on the shapes of a Flax init (the `sq` codebook the lattice's)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        noise = rng.randn(*shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * noise
        if name == "bias":
            return 0.02 * noise
        if name == "embedding" and shape[-1] == 24:
            return leech_lattice_codebook(*shape)
        return noise / np.float32(math.sqrt(np.prod(shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _init(module, *inputs, seed=1):
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)}, *inputs))
    return jax.tree_util.tree_map(np.asarray, _draw(shapes["params"], seed))


def _clip(seed=0, shape=CLIP):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _pair(name, args, seed=1):
    """(JAX module, its numpy params, the port's model with them loaded)."""
    jm = {"larp_tokenizer_vfm": jv.LARPTokenizerVFM,
          "larp_tokenizer_vfm_noquant": jv.LARPTokenizerVFMNoQuant}[name](**args)
    params = _init(jm, jnp.zeros((1, *CLIP[1:])), seed=seed)
    tm = tmodels.make({"name": name, "args": args})
    tm.load_state_dict(vfm_state_dict_from_jax(params, tm), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("dim, heads", [(160, 2), (128, 2)], ids=["d80", "d64"])
def test_teacher_matches_jax(dim, heads):
    kw = dict(embed_dim=dim, depth=4, num_heads=heads, img_size=32, num_frames=8,
              out_layers=(0, 1, 2, 3))
    jt = jv.VJEPA2TeacherViT(**kw)
    x = _clip(1) * 2 - 1
    params = _init(jt, jnp.asarray(x))
    want = jax.jit(lambda p, x: jt.apply({"params": p}, x))(params, jnp.asarray(x))
    tt = tv.VJEPA2TeacherViT(**kw)
    tt.load_state_dict(flax_tree_state_dict(params), strict=True)
    assert not any(p.requires_grad for p in tt.parameters())
    got = tt(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 16, dim)
        assert _rel(g.numpy(), w) <= TOL


@pytest.mark.parametrize("fusion", ["gated", "pyramid", "concat"])
def test_fusion_matches_jax(fusion):
    dim, grid = 160, (4, 2, 2)
    jf = {"gated": lambda: jv.GatedLinearLayerFusion(dim, 4),
          "pyramid": lambda: jv.SemanticPyramidFusion(dim, grid),
          "concat": lambda: jv.ConcatLayerFusion(dim, 4)}[fusion]()
    tf = {"gated": lambda: tv.GatedLinearLayerFusion(dim, 4),
          "pyramid": lambda: tv.SemanticPyramidFusion(dim, grid),
          "concat": lambda: tv.ConcatLayerFusion(dim, 4)}[fusion]()
    rng = np.random.RandomState(2)
    taps = [(rng.randn(2, 16, dim) * (1 + i)).astype(np.float32) for i in range(4)]
    params = _init(jf, [jnp.asarray(t) for t in taps])
    want = jf.apply({"params": params}, [jnp.asarray(t) for t in taps])
    tf.load_state_dict(flax_tree_state_dict(params), strict=True)
    got = tf([torch.from_numpy(t) for t in taps])
    assert got.dtype == torch.float32 and _rel(got.detach().numpy(), want) <= TOL


REGISTRATIONS = {
    "vfm-sq-gated": ("larp_tokenizer_vfm", dict(**TEACHER, **STUDENT, fusion="gated")),
    "vfm-vq-pyramid": ("larp_tokenizer_vfm", dict(**TEACHER, **STUDENT, fusion="pyramid",
                                                  bottleneck_type="vq", bottleneck=VQ)),
    "vfm-sq-last": ("larp_tokenizer_vfm", dict(**TEACHER, **STUDENT, fusion="last")),
    "noquant-concat": ("larp_tokenizer_vfm_noquant", dict(**TEACHER, **NOQUANT)),
    "noquant-last": ("larp_tokenizer_vfm_noquant", dict(**TEACHER, **NOQUANT, fusion="last")),
}


@pytest.mark.parametrize("case", list(REGISTRATIONS))
def test_registration_matches_jax(case):
    name, args = REGISTRATIONS[case]
    jm, params, tm = _pair(name, args)
    x = _clip(3)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want), set(got) ^ set(want)
    assert tuple(got["pred_frames"].shape) == CLIP
    assert _rel(got["pred_frames"].numpy(), want["pred_frames"]) <= TOL
    for k in ("align_loss", "loss_q", "codebook_entropy"):
        if k in want:
            assert got[k].dtype == torch.float32 and _rel(got[k].numpy(), want[k]) <= TOL, k
    if "bottleneck_rep" in want:
        np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    if name == "larp_tokenizer_vfm":
        assert tm.codebook_size == jm.codebook_size == (64 if "vq" in case else 512)


def test_gradients_match_jax():
    name, args = REGISTRATIONS["vfm-sq-gated"]
    jm, params, tm = _pair(name, args)
    x = _clip(4)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return (jnp.mean(jnp.abs(out["pred_frames"] - x)) + 0.2 * out["align_loss"]
                + 0.1 * out["loss_q"])

    g_want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params))
    assert all(np.all(g == 0) for g in jax.tree_util.tree_leaves(g_want["teacher_model"]))
    out = tm(torch.from_numpy(x), train=True)
    (torch.mean(torch.abs(out["pred_frames"] - torch.from_numpy(x))) + 0.2 * out["align_loss"]
     + 0.1 * out["loss_q"]).backward()
    want = vfm_state_dict_from_jax(g_want, tm)
    named = dict(tm.named_parameters())
    assert all(p.grad is None for n, p in named.items() if n.startswith("teacher_model."))
    for n in ("fusion_proj.gate_fc1_0.weight", "fusion_proj.proj_3.weight", "fusion_proj.post_ln.weight",
              "jepa_to_encoder.weight", "encoder_latent_query_embed",
              "encoder.blocks.0.attn.qkv.weight", "sq_in_linear.weight", "sq_out_linear.weight",
              "decoder_patch_query_embed", "decoder.blocks.0.mlp.fc2.weight", "aligner.weight",
              "aligner.bias", "dec_to_decimage.weight", "pixel_decoder.blocks.0.attn.proj.weight",
              "final_layer.linear.weight"):
        g, w = named[n].grad, want[n].numpy()
        assert g is not None, n
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), n


def test_bf16_model_keeps_the_flax_dtype_policy():
    name, args = REGISTRATIONS["vfm-sq-gated"]
    jm, params, _ = _pair(name, args)
    jb = jv.LARPTokenizerVFM(**args, dtype=jnp.bfloat16)
    x = _clip(5)
    apply = jax.jit(lambda m, p, x: m.apply({"params": p}, x), static_argnums=0)
    want32, want16 = (np.asarray(apply(m, params, jnp.asarray(x))["pred_frames"], np.float32)
                      for m in (jm, jb))
    tm = tmodels.make({"name": name, "args": {**args, "dtype": torch.bfloat16}})
    tm.load_state_dict(vfm_state_dict_from_jax(params, tm), strict=True)
    taps = tm.teacher_taps(torch.from_numpy(x))
    assert all(t.dtype == torch.float32 for t in taps)
    assert tm.fuse(taps).dtype == torch.float32
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out["pred_frames"].dtype == out["align_loss"].dtype == torch.float32
    assert out["encoded"].dtype == torch.float32
    jax_own = _rel(want16, want32)
    assert 0 < _rel(out["pred_frames"].numpy(), want32) <= max(2 * jax_own, 1e-3)


def test_clip_geometry():
    for name, args in (REGISTRATIONS["vfm-sq-gated"], REGISTRATIONS["noquant-concat"]):
        jm = {"larp_tokenizer_vfm": jv.LARPTokenizerVFM,
              "larp_tokenizer_vfm_noquant": jv.LARPTokenizerVFMNoQuant}[name](**args)
        tm = tmodels.make({"name": name, "args": args})
        assert (tm.frame_num, tm.input_size) == (jm.frame_num, jm.input_size) == (8, 32)
        assert tm.teacher_grid == jm.teacher_grid == (4, 2, 2)
    full = tmodels.make({"name": "larp_tokenizer_vfm", "args": {"device": "meta"}})
    assert (full.frame_num, full.input_size, full.teacher_grid) == (16, 256, (8, 16, 16))


def test_load_teacher_weights(tmp_path):
    name, args = REGISTRATIONS["vfm-sq-gated"]
    jm, params, tm = _pair(name, args, seed=1)
    teacher = _init(jv.VJEPA2TeacherViT(embed_dim=160, depth=4, num_heads=2, img_size=32,
                                        num_frames=8, out_layers=(0, 1, 2, 3)),
                    jnp.zeros((1, *CLIP[1:])), seed=7)
    path = tmp_path / "teacher.npz"
    np.savez(path, params=np.array(teacher, dtype=object))
    assert tv.load_teacher_weights(tm, str(path)) is tm
    for n, p in tm.teacher_model.named_parameters():
        assert not p.requires_grad
    np.testing.assert_array_equal(tm.teacher_model.patch_embed.weight.detach().numpy(),
                                  teacher["patch_embed"]["kernel"].T)
    variables = jv.load_teacher_weights({"params": params}, str(path))
    x = _clip(6)
    want = jm.apply(variables, jnp.asarray(x), method=lambda m, x: m.teacher(
        m._preprocess_for_teacher(x)))
    got = tm.teacher_taps(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= TOL
    with pytest.raises(ValueError):  # a teacher of another depth
        np.savez(path, params=np.array({k: v for k, v in teacher.items() if not k.endswith("_3")},
                                       dtype=object))
        tv.load_teacher_weights(tm, str(path))


def _port_trainer(cfg, jax_tr):
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    host = jax.device_get(jax_tr.state)
    tr.model.load_state_dict(vfm_state_dict_from_jax(host["params"], tr.model), strict=True)
    tr.loss_mod.load_state_dict(
        loss_state_dict_from_jax(host["loss_params"], host["loss_ema"], tr.loss_mod), strict=True)
    tr.ema_params = {d: {n: p.detach().clone() for n, p in tr.model.named_parameters()
                         if p.requires_grad} for d in tr.ema_params}
    return tr


def test_trainer_step_matches_jax(tmp_path):
    model = {"name": "larp_tokenizer_vfm",
             "args": dict(**TEACHER, **STUDENT, bottleneck_type="vq", bottleneck=VQ)}
    opt = {"name": "adam", "args": {"lr": 1e-3, "betas": [0.5, 0.9]},
           "loss_args": {"lr": 1e-3, "betas": [0.5, 0.9]}, "lr_type": "step"}
    jtr = jax_trainer(trainer_cfg(tmp_path / "jax", model=model, optimizer=opt))
    ptr = _port_trainer(trainer_cfg(tmp_path / "port", model=model, optimizer=opt), jtr)
    assert isinstance(ptr.model, tv.LARPTokenizerVFM)
    assert not any(n.startswith("teacher_model.") for n in ptr.ema_params["0.999"])
    in_opt = {id(p) for g in ptr.opt_g.param_groups for p in g["params"]}
    assert not any(id(p) in in_opt for p in ptr.model.teacher_model.parameters())
    teacher0 = {n: p.detach().clone() for n, p in ptr.model.named_parameters()}
    jax_teacher0 = jax.device_get(jtr.state["params"]["teacher_model"])
    jax_enc0 = np.asarray(jax.device_get(jtr.state["params"]["jepa_to_encoder"]["kernel"]))
    batch = train_batch()
    keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
    want = dict(zip(keys, np.asarray(packed).tolist()))
    keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
    got = dict(zip(keys, packed.tolist()))
    assert set(got) == set(want), set(got) ^ set(want)
    assert "align_loss" in got and want["align_loss"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    # `loss` is the JAX total, which holds align_loss at 0.2 (tokenizer_trainer.py)
    jax_teacher1 = jax.device_get(jtr.state["params"]["teacher_model"])
    for a, b in zip(jax.tree_util.tree_leaves(jax_teacher0), jax.tree_util.tree_leaves(jax_teacher1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for n, p in ptr.model.named_parameters():  # the teacher frozen, every other tensor moved
        assert torch.equal(p, teacher0[n]) == n.startswith("teacher_model."), n
    jax_enc1 = np.asarray(jax.device_get(jtr.state["params"]["jepa_to_encoder"]["kernel"]))
    assert not np.array_equal(jax_enc0, jax_enc1)


# the JAX init's counts at 16 x 256 x 256 (`jax.eval_shape` of the Flax inits)
FULL_COUNTS = {
    "larp_tokenizer_vfm": 1_123_585_948,  # class defaults: sq, Leech, gated
    "larp_tokenizer_vfm_noquant": 753_746_176,
}
TEACHER_COUNT = 631_645_440  # V-JEPA2 ViT-H: 1280 wide, 32 layers


def test_full_width_counts():
    for name, count in FULL_COUNTS.items():
        m = tmodels.make({"name": name, "args": {"device": "meta"}})
        assert sum(p.numel() for p in m.parameters()) == count, name
        assert sum(p.numel() for p in m.teacher_model.parameters()) == TEACHER_COUNT
    jm = jv.LARPTokenizerVFMNoQuant()
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 3, 16, 256, 256))))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n == FULL_COUNTS["larp_tokenizer_vfm_noquant"]


@pytest.mark.parametrize("init, fan_in", [
    ("lecun_normal", 1280),  # the teacher's projections
    ("lecun_normal", 27),    # the pyramid fusion's depthwise 3 x 3 x 3 filters
    ("trunc02", 512),
])
def test_truncated_normal_draw_has_flax_distribution(init, fan_in):
    """`layers.init_kernel`'s truncated normal (the inverse CDF of a uniform
    draw) against Flax's initializer over 2**20 draws each: the same bound,
    the std within 5e-3 relative, the share beyond one std within 3e-3
    (sampling error ~4e-4)."""
    from video_tokenizer_tpu_torch.models.layers import _TRUNC_STD, init_kernel

    n = 1 << 20
    std = (math.sqrt(1.0 / fan_in) if init == "lecun_normal" else 0.02) / _TRUNC_STD
    w = torch.empty(n // fan_in, fan_in)
    init_kernel(w, init, fan_in, n // fan_in, torch.Generator().manual_seed(0))
    flax_init = (jax.nn.initializers.lecun_normal() if init == "lecun_normal"
                 else jax.nn.initializers.truncated_normal(0.02 / _TRUNC_STD))
    want = np.asarray(flax_init(jax.random.PRNGKey(0), (fan_in, n // fan_in)))
    got = w.numpy()
    assert np.abs(got).max() <= 2 * std and np.abs(want).max() <= 2 * std * (1 + 1e-6)
    np.testing.assert_allclose(got.std(), want.std(), rtol=5e-3)
    np.testing.assert_allclose((np.abs(got) > std).mean(), (np.abs(want) > std).mean(), atol=3e-3)
