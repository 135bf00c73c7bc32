"""The port's teacher-space autoencoders (`models/vfm_auto.py`) against the JAX package, on the CPU.

Every registered name at `tests/test_families.py`'s tiny teacher (32 wide,
4 heads of 8, patch 8 on 8 x 32 x 32 clips: a 4 x 4 x 4 token grid; one
layer tapped, or four for the pyramid fusion, which unpacks four taps), the
`tiny` gated M-RoPE stacks (256 wide, 4 layers, 4 heads of 64) over 4
latents and a one-layer pixel decoder 32 wide. Parameters are numpy draws on
the shapes of the JAX init (`jax.eval_shape`, nothing run): kernels
N(0, 1 / fan_in), biases 0.02 N(0, 1), norm scales 1 + 0.1 N(0, 1) (so the
zero-initialised output layer and pyramid `proj_up` are exercised), carried
to the port by `vfm_auto_state_dict_from_jax`. The JAX side runs jitted on
XLA:CPU, fp32 (its attention the XLA path). Held, within 1e-5 of each
tensor's scale (fp32 products summed in other orders):
  * the teacher's taps, the fusion's output, the encoder's latents before
    FSQ, the FSQ indices (equal), `pred_frames` and `align_loss`, for all
    five names and for `fusion="concat"` as a field value;
  * `decode_from_bottleneck` of the JAX indices, and its refusal without a
    quantizer;
  * the gradients of mean |pred - x| + 0.2 align_loss against `jax.grad`
    within 1e-4 of each tensor's max |g| (or of 1e-3 of the largest tensor's,
    where a tensor's own is smaller: the gate's first layer, ~1e-6 of it):
    the fusion trains through the encoder; the JAX teacher's gradients are
    exactly 0, the port's teacher has none;
  * `autoencoder_vfm2` and `autoencoder_vfm_fianllayer` are one factory;
  * the full-width parameter counts (the JAX init's, by `jax.eval_shape`).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import vfm_auto as jva
from video_tokenizer_tpu.registry import models as jmodels
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import vfm_auto as tva
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import vfm_auto_state_dict_from_jax

TINY_TEACHER = {  # tests/test_families.py's
    "teacher_dim": 32, "teacher_depth": 1, "teacher_heads": 4,
    "vjepa2_img_size": 32, "vjepa2_num_frames": 8, "vjepa2_patch_size": 8,
    "vjepa2_tubelet_size": 2, "out_layers": (0,),
}
STUDENT = dict(model_size="tiny", num_latent_tokens=4, pixel_dec_width=32, pixel_dec_depth=1,
               pixel_dec_heads=4)
FOUR_TAPS = dict(teacher_depth=4, out_layers=(0, 1, 2, 3))
NAMES = {
    "autoencoder_vfm": {},
    "autoencoder_vfm1": FOUR_TAPS,
    "autoencoder_vfm2": {},
    "autoencoder_vfm_fianllayer": {},
    "autoencoder_vfm_fianllayer_noquant": {},
}
CLIP = (2, 3, 8, 32, 32)
TOL = 1e-5
MEAN = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 3, 1, 1, 1)
STD = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 3, 1, 1, 1)


def _draw(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        noise = rng.randn(*shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * noise
        if name == "bias":
            return 0.02 * noise
        return noise / np.float32(math.sqrt(max(np.prod(shape[:-1]), 1)))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _args(name):
    return {**TINY_TEACHER, **STUDENT, **NAMES[name]}


def _pair(name, args, seed=1):
    """(JAX module, its numpy params, the port's model with them loaded)."""
    jm = jmodels.make({"name": name, "args": args})
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, *CLIP[1:]))))
    params = jax.tree_util.tree_map(np.asarray, _draw(shapes["params"], seed))
    tm = tmodels.make({"name": name, "args": args})
    tm.load_state_dict(vfm_auto_state_dict_from_jax(params, tm), strict=True)
    return jm, params, tm.eval()


def _clip(seed):
    return np.random.RandomState(seed).rand(*CLIP).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _jax_parts(jm, params, x):
    """The JAX module's taps, fused features, pre-FSQ latents and output."""
    xn = jnp.asarray((x - MEAN) / STD)

    def parts(p, x, xn):
        v = {"params": p}
        taps = jm.apply(v, xn, method=lambda m, xn: m.teacher(xn))
        feats = jm.apply(v, x, method=lambda m, x: m._teacher_feats(x))
        z = jm.apply(v, feats, method=lambda m, f: m.tokenizer_encoder(f))
        return taps, feats, z, jm.apply(v, x, train=False)

    return jax.jit(parts)(params, jnp.asarray(x), xn)


CASES = [*NAMES, "concat"]


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    if case == "concat":  # a field value, not a registration
        args = {**_args("autoencoder_vfm"), **FOUR_TAPS, "fusion": "concat"}
        jm = jva.TeacherSpaceAutoEncoder(**args)
        tm = tva.TeacherSpaceAutoEncoder(**args)
        shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, *CLIP[1:]))))
        params = jax.tree_util.tree_map(np.asarray, _draw(shapes["params"], 1))
        tm.load_state_dict(vfm_auto_state_dict_from_jax(params, tm), strict=True)
        tm.eval()
    else:
        jm, params, tm = _pair(case, _args(case))
    x = _clip(3)
    taps, feats, z, want = _jax_parts(jm, params, x)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got_taps = tm.teacher_taps(xt)
        got_feats = tm.fuse(got_taps)
        got_z = tm.tokenizer_encoder(got_feats)
        got = tm(xt)
    assert len(got_taps) == len(taps)
    for g, w in zip(got_taps, taps):
        assert _rel(g.numpy(), w) <= TOL
    assert _rel(got_feats.numpy(), feats) <= TOL
    assert tuple(got_z.shape) == (2, 4, 6) and _rel(got_z.numpy(), z) <= TOL
    assert set(got) == set(want), set(got) ^ set(want)
    assert tuple(got["pred_frames"].shape) == CLIP
    assert _rel(got["pred_frames"].numpy(), want["pred_frames"]) <= TOL
    assert got["align_loss"].dtype == torch.float32
    assert _rel(got["align_loss"].numpy(), want["align_loss"]) <= TOL
    assert _rel(got["encoded"].numpy(), want["encoded"]) <= TOL
    quantized = case != "autoencoder_vfm_fianllayer_noquant"
    assert ("bottleneck_rep" in got) == quantized
    if quantized:
        np.testing.assert_array_equal(got["bottleneck_rep"].numpy(),
                                      np.asarray(want["bottleneck_rep"]))
    assert (tm.bottleneck_token_num, tm.codebook_size) == (jm.bottleneck_token_num,
                                                           jm.codebook_size) == (4, 64000)
    assert (tm.frame_num, tm.input_size, tm.vfm_grid) == (jm.frame_num, jm.input_size,
                                                          jm.vfm_grid) == (8, 32, (4, 4, 4))


def test_decode_from_bottleneck_matches_jax():
    jm, params, tm = _pair("autoencoder_vfm_fianllayer", _args("autoencoder_vfm_fianllayer"))
    idx = np.random.RandomState(4).randint(0, 64000, (2, 4)).astype(np.int32)
    want = jax.jit(lambda p, i: jm.apply({"params": p}, i, method=jm.decode_from_bottleneck))(
        params, jnp.asarray(idx))
    with torch.no_grad():
        got = tm.decode_from_bottleneck(torch.from_numpy(idx))
        assert torch.equal(got, tm.decode_indices(torch.from_numpy(idx)))
    assert tuple(got.shape) == CLIP and _rel(got.numpy(), want) <= TOL
    noquant = tmodels.make({"name": "autoencoder_vfm_fianllayer_noquant",
                            "args": _args("autoencoder_vfm_fianllayer_noquant")})
    with pytest.raises(ValueError, match="FSQ"):
        noquant.decode_from_bottleneck(torch.from_numpy(idx))


def test_gradients_match_jax():
    jm, params, tm = _pair("autoencoder_vfm", _args("autoencoder_vfm"))
    x = _clip(5)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.mean(jnp.abs(out["pred_frames"] - x)) + 0.2 * out["align_loss"]

    g_want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params))
    assert all(np.all(g == 0) for g in jax.tree_util.tree_leaves(g_want["teacher_model"]))
    out = tm(torch.from_numpy(x), train=True)
    (torch.mean(torch.abs(out["pred_frames"] - torch.from_numpy(x)))
     + 0.2 * out["align_loss"]).backward()
    want = vfm_auto_state_dict_from_jax(g_want, tm)
    named = dict(tm.named_parameters())
    assert all(p.grad is None for n, p in named.items() if n.startswith("teacher_model."))
    student = {n: want[n].numpy() for n in named if not n.startswith("teacher_model.")}
    top = max(np.abs(w).max() for w in student.values())
    for n, w in student.items():
        g = named[n].grad
        assert g is not None, n
        # the gate's first layer gets ~1e-6 of the top gradient: its scale
        # there is the rounding of the larger paths it shares
        scale = max(np.abs(w).max(), 1e-3 * top)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, n
    assert len(student) > 40 and np.abs(student["fusion_proj.proj_0.weight"]).max() > 0


def test_two_names_one_factory():
    assert tmodels["autoencoder_vfm2"] is tmodels["autoencoder_vfm_fianllayer"]
    a, b = (tmodels.make({"name": n, "args": _args(n)})
            for n in ("autoencoder_vfm2", "autoencoder_vfm_fianllayer"))
    assert (a.fusion, a.use_quantizer) == (b.fusion, b.use_quantizer) == ("last", True)
    assert list(a.state_dict()) == list(b.state_dict())
    jshapes = [jax.tree_util.tree_map(lambda s: s.shape, jax.eval_shape(
        lambda m=jmodels.make({"name": n, "args": _args(n)}): m.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *CLIP[1:]))))["params"])
        for n in ("autoencoder_vfm2", "autoencoder_vfm_fianllayer")]
    assert jshapes[0] == jshapes[1]


# the JAX init's counts at 16 x 256 x 256 (`jax.eval_shape` of the Flax inits)
FULL_COUNTS = {
    "autoencoder_vfm": 884_747_532,
    "autoencoder_vfm1": 876_676_718,
    "autoencoder_vfm2": 876_542_728,
    "autoencoder_vfm_fianllayer": 876_542_728,
    "autoencoder_vfm_fianllayer_noquant": 876_542_728,
}
TEACHER_COUNT = 631_645_440


def test_full_width_counts():
    for name, count in FULL_COUNTS.items():
        with torch.device("meta"):
            m = tmodels.make({"name": name, "args": {}})
        assert sum(p.numel() for p in m.parameters()) == count, name
        assert sum(p.numel() for p in m.teacher_model.parameters()) == TEACHER_COUNT
        assert (m.frame_num, m.input_size, m.teacher_tokens) == (16, 256, 2048)
    jm = jmodels.make({"name": "autoencoder_vfm", "args": {}})
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 3, 16, 256, 256))))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n == FULL_COUNTS["autoencoder_vfm"]
