"""The port's CNN-ViT family (`models/model_cnnvit.py`) against the JAX package, on the CPU.

Tiny sizes: the `tiny` gated M-RoPE stacks (256 wide, 4 layers, 4 heads of
64; `tiny_thin`, 512 wide, 2 layers, 8 heads, for the alignment variants)
over 8 latents and the stem's 4 x 4 x 4 grid of 16 x 32 x 32 clips; the
3D-ResNet stem and decoder at `cnn_ch` 8 (8, 16, 32, 32 channels: GroupNorm
with one group at the first two levels, 32 at the last two) and at the
registered 32 (32, 64, 128, 128: 32 groups at every level; `norm_out` one
group); a teacher 32 wide with 4 heads of 8, patch 8 (an 8 x 4 x 4 grid), 4
k-means prototypes, PCA rank 2. Parameters are numpy draws on the shapes of
the JAX init (kernels N(0, 1 / fan_in), biases 0.02 N(0, 1), scales 1 +
0.1 N(0, 1)), carried by `cnnvit_state_dict_from_jax`; the JAX side runs
jitted on XLA:CPU. Held:
  * `autoencoder_cnnvit` in eval mode at both `cnn_ch` against the JAX
    module evaluated in fp64 (x64 on around its calls): `pred_frames` and
    `decode_from_bottleneck` within 3e-5 of the scale (fp32 rounding through
    26 convolutions; the port lies 1.2e-5 from it at `cnn_ch` 32, where the
    JAX module's own fp32 run lies 1.6e-4 away: XLA:CPU's fp32 sum over the
    524,288 values of `norm_out`'s one group is 1.4e-4 off), the codes within
    1e-5, the FSQ indices equal; the gradients of a fixed loss against the
    fp64 `jax.grad` within 1e-4 of each tensor's scale (at least 1e-3 of the
    largest: a conv bias just before a GroupNorm has the gradient 0);
  * the alignment variants (`gram`, `gram_vic`, `softalign`) in train mode
    against the fp32 JAX module, with JAX's k-means indices (the split of
    PRNGKey(0) its module draws from without rng streams) fed to the port:
    the student's and the teacher's prototypes within 1e-5 of the scale;
    `align_loss` and its parts within 1e-5 relative or 3x what a 1e-7 nudge
    of the clip moves JAX's own (softalign's unit tokens pool at temperature
    0.5 to prototypes near one point, whose Gram and PCA losses are their
    small differences: JAX's own move by 2e-2); in eval mode no teacher;
  * a bf16 model: the stem and decoder in fp32 (their inputs never cast);
    the pre-FSQ latents and the decode of fixed codes each no farther from
    the fp32 JAX model than 2x the JAX module's own bf16 run is;
  * `ResNAFAutoEncoder` (tiny: 256 wide, 4 layers, patch 4 x 8 x 8):
    forward, indices and `decode_from_bottleneck`; its GEGLU is Flax's tanh
    GELU, with the value the first chunk and an unrounded inner width (an
    exact GELU would differ);
  * the JAX factory's int `patch_size` fault: from `cfgs/larp_tokenizer.yaml`
    the JAX `autoencoder_cnnvit_resnaf` raises TypeError, the port's reads 8
    as (4, 8, 8) and equals the JAX model built with the tuple;
  * the full-width parameter counts (the JAX inits', by `jax.eval_shape`).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.config import load_config
from video_tokenizer_tpu.models import model_cnnvit as jc
from video_tokenizer_tpu.registry import models as jmodels
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import model_cnnvit as tc
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import cnnvit_state_dict_from_jax

CNNVIT = dict(model_size="tiny", num_latent_tokens=8, input_size=32, frame_num=16)
TEACHER = dict(align_num_prototypes=4, align_pca_rank=2, teacher_dim=32, teacher_depth=1,
               teacher_heads=4, vjepa2_img_size=32, vjepa2_num_frames=16, vjepa2_patch_size=8,
               vjepa2_tubelet_size=2)
RESNAF = dict(model_size="tiny", input_size=32, frame_num=16)
CLIP = (2, 3, 16, 32, 32)
TOL = 1e-5


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


@functools.lru_cache(maxsize=None)
def _shapes(name, args, train):
    """The JAX init's parameter shapes (traced once per model: ~5 s each)."""
    jm = jmodels.make({"name": name, "args": dict(args)})
    return jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                          jnp.zeros((1, *CLIP[1:])), train=train))["params"]


def _params(name, args, seed=1, train=False):
    shapes = _shapes(name, tuple(sorted(args.items())), train)
    return jax.tree_util.tree_map(np.asarray, _draw(shapes, seed))


def _pair(name, args, seed=1, train=False, dtype=torch.float32, shapes_of=None):
    """(JAX module, numpy params, the port's model with them); `shapes_of`,
    a registration with the same parameters whose traced shapes to reuse."""
    jm = jmodels.make({"name": name, "args": args})
    params = _params(shapes_of or name, args, seed, train)
    tm = tmodels.make({"name": name, "args": {**args, "dtype": dtype}})
    tm.load_state_dict(cnnvit_state_dict_from_jax(params, tm), strict=True)
    return jm, params, tm.eval()


def _clip(seed, batch=2):
    return np.random.RandomState(seed).rand(batch, *CLIP[1:]).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _norm_groups(model):
    return {(n.split(".")[1], m.num_groups) for n, m in model.named_modules()
            if isinstance(m, tc.GroupNorm)}


def _jax64(name, args, params):
    """The JAX module built in fp64 and its params in fp64: the reference
    for the whole CNN-ViT (x64 on only around its calls)."""
    jm = jmodels.make({"name": name, "args": {**args, "dtype": jnp.float64}})
    return jm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)


@pytest.mark.parametrize("cnn_ch", [8, 32])
def test_cnnvit_matches_jax(cnn_ch):
    args = {**CNNVIT, "cnn_ch": cnn_ch}
    _, params, tm = _pair("autoencoder_cnnvit", args)
    blocks = {(level, g) for level, g in _norm_groups(tm) if "block" in level}
    if cnn_ch == 32:
        assert {g for _, g in blocks} == {32}  # every level's channels divide by 32
    else:
        assert ("level0_block0", 1) in blocks and ("level3_block0", 32) in blocks
    assert tm.cnn_decoder.norm_out.num_groups == 1
    x = _clip(3, batch=1)  # the fp64 convolutions are XLA:CPU's slowest part
    with jax.enable_x64(True):
        jm, p64 = _jax64("autoencoder_cnnvit", args, params)
        want = jax.tree_util.tree_map(np.asarray, jax.jit(lambda p, x: jm.apply({"params": p}, x))(
            p64, jnp.asarray(x, jnp.float64)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want), set(got) ^ set(want)
    assert tuple(got["pred_frames"].shape) == x.shape and got["pred_frames"].is_contiguous()
    assert _rel(got["pred_frames"].numpy(), want["pred_frames"]) <= 3 * TOL
    assert _rel(got["encoded"].numpy(), want["encoded"]) <= TOL
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), want["bottleneck_rep"])
    if cnn_ch == 8:
        idx = np.random.RandomState(4).randint(0, 64000, (1, 8)).astype(np.int32)
        with jax.enable_x64(True):
            want_dec = np.asarray(jax.jit(lambda p, i: jm.apply(
                {"params": p}, i, method=jm.decode_from_bottleneck))(p64, jnp.asarray(idx)))
        with torch.no_grad():
            assert _rel(tm.decode_from_bottleneck(torch.from_numpy(idx)).numpy(),
                        want_dec) <= 3 * TOL
    assert (tm.grid, tm.bottleneck_token_num, tm.codebook_size) == (
        jm.grid, jm.bottleneck_token_num, jm.codebook_size) == ((4, 4, 4), 8, 64000)


def test_cnnvit_gradients_match_jax():
    args = {**CNNVIT, "cnn_ch": 8}
    _, params, tm = _pair("autoencoder_cnnvit", args)
    x = _clip(5, batch=1)
    with jax.enable_x64(True):
        jm, p64 = _jax64("autoencoder_cnnvit", args, params)

        def loss(p):
            out = jm.apply({"params": p}, jnp.asarray(x, jnp.float64))["pred_frames"]
            return jnp.mean(jnp.abs(out - x))

        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       jax.jit(jax.grad(loss))(p64))
    want = {n: w.numpy() for n, w in cnnvit_state_dict_from_jax(grads, tm).items()}
    torch.mean(torch.abs(tm(torch.from_numpy(x))["pred_frames"] - torch.from_numpy(x))).backward()
    top = max(np.abs(w).max() for w in want.values())
    for n, p in tm.named_parameters():
        assert p.grad is not None, n
        # a conv bias just before a GroupNorm has the gradient 0: its scale
        # there is the rounding of the other paths
        scale = max(np.abs(want[n]).max(), 1e-3 * top)
        assert np.abs(p.grad.numpy() - want[n]).max() <= 1e-4 * scale, n


ALIGNS = {
    "autoencoder_cnnvit_softalign_gramonly_vjepa2": ("gram_loss",),
    "autoencoder_cnnvit_softalign_gram_vic_vjepa2": ("gram_loss", "vic_sim", "vic_var", "vic_cov"),
    "autoencoder_cnnvit_softalign": ("gram_loss", "pca_loss"),
}


@pytest.mark.parametrize("name", list(ALIGNS))
def test_alignment_matches_jax(name):
    # 2 layers a stack (512 wide, 8 heads of 64), over softalign's small_thin
    args = {**CNNVIT, **TEACHER, "cnn_ch": 8, "model_size": "tiny_thin"}
    jm, params, tm = _pair(name, args, train=True, shapes_of="autoencoder_cnnvit_align")
    assert not any(p.requires_grad for p in tm.teacher_model.parameters())
    x = _clip(6)
    nudged = x * (1 + 1e-7 * np.random.RandomState(1).randn(*x.shape).astype(np.float32))
    apply = jax.jit(lambda p, x, train: jm.apply(
        {"params": p}, x, train=train, capture_intermediates=lambda m, _: m.name == "align_pool"),
        static_argnums=2)
    (want, inter), (moved, _) = (apply(params, jnp.asarray(v), True) for v in (x, nudged))
    want_eval, _ = apply(params, jnp.asarray(x), False)
    # no rng stream: the JAX module draws from PRNGKey(0), split in two
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    draws = (torch.from_numpy(np.array(jax.random.randint(r1, (2, 4), 0, 8))),
             torch.from_numpy(np.array(jax.random.randint(r2, (2, 4), 0, 128))))
    protos = []
    hook = tm.align_pool.register_forward_hook(lambda m, i, o: protos.append(o.detach()))
    got = tm(torch.from_numpy(x), train=True, kmeans_draws=draws)
    hook.remove()
    assert set(got) == set(want), set(got) ^ set(want)
    assert _rel(got["pred_frames"].detach().numpy(), want["pred_frames"]) <= 3 * TOL
    # the student's and the teacher's prototypes, means of the token sets
    want_protos = inter["intermediates"]["align_pool"]["__call__"]
    assert len(protos) == len(want_protos) == 2
    for g, w in zip(protos, want_protos):
        assert _rel(g.numpy(), w) <= TOL
    for k in ("align_loss", *ALIGNS[name]):
        # prototypes near one point (softalign's unit tokens at temperature
        # 0.5) leave a loss of their small differences: JAX's own moves by
        # 2e-2 under a 1e-7 nudge of the clip, so 3x that move is the bound
        tol = max(TOL, 3 * _rel(moved[k], want[k]))
        assert got[k].dtype == torch.float32 and _rel(got[k].item(), want[k]) <= tol, k
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x), train=False)
    assert set(got_eval) == set(want_eval) and "align_loss" not in got_eval
    # the port's own draws: the model's generator
    tm.sample_generator.manual_seed(5)
    a = tm(torch.from_numpy(x), train=True)["gram_loss"].item()
    tm.sample_generator.manual_seed(5)
    assert tm(torch.from_numpy(x), train=True)["gram_loss"].item() == a


def test_bf16_model_keeps_the_cnn_in_fp32():
    """The bf16 model's pre-FSQ latents, and its decode of the fp32 JAX
    model's codes, each no farther from the fp32 JAX model than 2x the JAX
    module's own bf16 run is (a whole forward would compare FSQ rounding
    flips of 8 tokens)."""
    args = {**CNNVIT, "cnn_ch": 8}
    jm, params, tm = _pair("autoencoder_cnnvit", args, dtype=torch.bfloat16)
    jb = jc.CNNViTAutoEncoder(**args, dtype=jnp.bfloat16)
    x = _clip(7, batch=1)
    codes = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(x))["encoded"])

    def parts(m):
        def run(p, x, c):
            z = m.apply({"params": p}, x, method=lambda mm, x: mm.enc_proj_out(
                mm._run_encoder(x).astype(jnp.float32)))
            return z, m.apply({"params": p}, c, method=lambda mm, c: mm.decode(c))
        return [np.asarray(a, np.float32) for a in jax.jit(run)(params, jnp.asarray(x),
                                                               jnp.asarray(codes))]

    (z32, d32), (z16, d16) = parts(jm), parts(jb)
    seen = {}
    hooks = [getattr(tm, n).register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, (i[0].dtype, o.dtype)))
        for n in ("cnn_encoder", "cnn_decoder")]
    with torch.no_grad():
        z = tm.enc_proj_out(tm._run_encoder(torch.from_numpy(x)).float())
        dec = tm.decode(torch.from_numpy(codes))
        out = tm(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert seen == {n: (torch.float32, torch.float32) for n in ("cnn_encoder", "cnn_decoder")}
    assert out["pred_frames"].dtype == out["encoded"].dtype == z.dtype == torch.float32
    for got, want, own in ((z, z32, z16), (dec, d32, d16)):
        assert 0 < _rel(got.numpy(), want) <= max(2 * _rel(own, want), 1e-3)


def test_resnaf_matches_jax():
    jm, params, tm = _pair("autoencoder_cnnvit_resnaf", RESNAF)
    assert tm.patch_size == (4, 8, 8) and tm.grid == jm.grid == (4, 4, 4)
    assert tm.enc_blocks.ffd0.proj_out.weight.shape[1] == int(4 * 2 / 3 * 256) == 682
    x = _clip(8)
    idx = np.random.RandomState(9).randint(0, 64000, (2, 64)).astype(np.int32)

    def run(p, x, idx):
        v = {"params": p}
        return jm.apply(v, x), jm.apply(v, idx, method=jm.decode_from_bottleneck)

    want, want_dec = jax.jit(run)(params, jnp.asarray(x), jnp.asarray(idx))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        got_dec = tm.decode_from_bottleneck(torch.from_numpy(idx))
    assert set(got) == set(want)
    assert _rel(got["pred_frames"].numpy(), want["pred_frames"]) <= TOL
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    assert _rel(got_dec.numpy(), want_dec) <= TOL
    assert tm.bottleneck_token_num == jm.bottleneck_token_num == 64


def test_resnaf_geglu_is_flax_tanh_gelu():
    jf = jc.GEGLUFeedForward(4.0)
    rng = np.random.RandomState(10)
    x = (3 * rng.randn(2, 5, 48)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jf.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jf.apply(params, jnp.asarray(x)))
    tf = tc.GEGLUFeedForward(48, 4.0)
    tf.load_state_dict(cnnvit_state_dict_from_jax(params["params"], tf), strict=True)
    with torch.no_grad():
        got = tf(torch.from_numpy(x)).numpy()
        val, gate = tf.proj_in(tf.norm(torch.from_numpy(x))).chunk(2, dim=-1)
        exact = tf.proj_out(torch.nn.functional.gelu(gate) * val).numpy()
    assert tf.proj_in.weight.shape[0] == 2 * int(4 * 2 / 3 * 48) == 2 * 128
    assert _rel(got, want) <= TOL
    assert _rel(exact, want) > 1e-4  # the exact GELU is another function


def test_resnaf_int_patch_size_fault_of_the_reference():
    """`--opts model.name autoencoder_cnnvit_resnaf` on the flagship cfg: the
    JAX factory passes `patch_size: 8` over the tuple field and the model's
    `grid` / `_patchify` fail to unpack it."""
    cfg = load_config("cfgs/larp_tokenizer.yaml", {"input_size": 32, "frame_num": 16},
                      ["model.name", "autoencoder_cnnvit_resnaf"])
    spec = cfg.model.to_dict()
    assert spec["args"]["patch_size"] == 8 and spec["args"]["temporal_patch_size"] == 4
    jm = jmodels.make(spec)
    with pytest.raises(TypeError):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *CLIP[1:])))
    args = {**spec["args"], "patch_size": (4, 8, 8)}
    jm = jmodels.make({"name": spec["name"], "args": args})
    params = _params(spec["name"], RESNAF)  # the cfg sets no other field of the model
    tm = tmodels.make(spec)
    assert tm.patch_size == (4, 8, 8)
    tm.load_state_dict(cnnvit_state_dict_from_jax(params, tm), strict=True)
    x = _clip(11)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert _rel(got["pred_frames"].numpy(), want["pred_frames"]) <= TOL


# the JAX inits' counts at 16 x 128 x 128 (`jax.eval_shape` of the Flax inits)
FULL_COUNTS = {
    "autoencoder_cnnvit": 149_360_491,
    "autoencoder_cnnvit_align": 252_753_771,
    "autoencoder_cnnvit_align1": 252_753_771,
    "autoencoder_cnnvit_softalign_gramonly_vjepa2": 252_753_771,
    "autoencoder_cnnvit_softalign_gram_vic_vjepa2": 252_753_771,
    "autoencoder_cnnvit_softalign": 171_209_067,
    "autoencoder_cnnvit_resnaf": 4_649_222,
}


def test_full_width_counts():
    for name, count in FULL_COUNTS.items():
        with torch.device("meta"):
            m = tmodels.make({"name": name, "args": {}})
        assert sum(p.numel() for p in m.parameters()) == count, name
        if hasattr(m, "teacher_model"):
            assert sum(p.numel() for p in m.teacher_model.parameters()) == 102_343_680
    jm = jmodels.make({"name": "autoencoder_cnnvit", "args": {}})
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 3, 16, 128, 128))))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n == FULL_COUNTS["autoencoder_cnnvit"]
