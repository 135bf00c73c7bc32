"""The port's Cosmos tokenizers (`models/cosmos.py`) against the JAX package, on the CPU.

The sizes are tests/test_families.py's: base 8, latent 16, SimVQ K = 64,
on seeded numpy clips of 9 x 32 x 32 (two motion latents). Parameters are
numpy draws on the shapes of the JAX init (`jax.eval_shape`, nothing run):
kernels N(0, 1 / fan_in), biases 0.02 N(0, 1), GroupNorm scales
1 + 0.1 N(0, 1), carried to the port by `cosmos_state_dict_from_jax`. The
JAX side runs jitted on XLA:CPU, fp32 throughout; the port's VQ wrapper
runs its plain version on CPU tensors. Held:
  * the SimVQ anchors: the port's threefry-2x32 words equal to
    `jax.random.bits` and its normals within 3 fp32 ulp of
    `jax.random.normal(PRNGKey(0), ...)` (the largest difference found: XLA's
    erfinv and log1p are not reproduced to the bit), its uniforms bit for bit,
    at (64, 16) and at the full (16384, 256);
  * every module on its own, outputs within 1e-5 of their scale (fp32
    convolutions and matmuls summed in other orders): `CausalConv3d` in each
    padding and stride case, the norm, the resnet block with and without its
    shortcut, the spatial, causal temporal (and its T = 1 identity) and cross
    attention blocks, both resamplers in each mode, the encoder (both
    branches), the decoder, `FSQuantizerProj` and `SimVQ` (indices equal);
  * the whole forward of both families (`pred_frames` 1e-5 of scale, `loss_q`
    1e-5 relative, both index maps equal), `encode_indices` and
    `decode_indices`;
  * the gradients of mean |pred_frames - x| + loss_q for six named
    parameters against `jax.grad`, within 1e-4 of each tensor's max |g| (5e-4
    for the output convolution's bias, a sum of 18,432 terms a channel in
    fp32, whose summation order alone moves it 1.6e-4 with one torch thread),
    the L1's sign taken from the JAX forward on both sides (a pixel whose
    two reconstructions straddle x would flip it and move that bias's
    gradient by 2 / 55,296);
  * a bf16-built model: convolutions and norms in bf16, the quantizer and its
    projections in fp32, its output no farther from the fp32 JAX model than
    2x the JAX module's own bf16 output is;
  * the full-width parameter counts (113,163,651 and 113,101,193, the JAX
    init's), the factories, the model `reconstruct.py --cfg
    cfgs/larp_tokenizer.yaml --opts model.name cosmos` builds on each side;
  * the reference's faults, kept: no `frame_num` or `input_size` on the JAX
    model (its tokenizer trainer reads both), and a 16-frame clip comes back
    with 13 frames on both sides.
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
from video_tokenizer_tpu.models import cosmos as jc
from video_tokenizer_tpu.registry import models as jmodels
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import cosmos as tc
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils import jax_random
from video_tokenizer_tpu_torch.utils.convert import cosmos_state_dict_from_jax

TINY = {"base_channels": 8, "latent_dim": 16, "codebook_size": 64}
CLIP = (3, 9, 32, 32)
TOL = 1e-5
ULP = 3  # the anchors: the largest difference from jax.random.normal found


def _draw(shapes, seed):
    """Numpy parameters on the shapes of a Flax init."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        noise = rng.randn(*shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * noise
        if name == "bias":
            return 0.02 * noise
        return noise / np.float32(math.sqrt(np.prod(shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(jmod, tmod, *args, seed=1):
    """(JAX module's jitted apply, its params) and the port module with them."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    params = _draw(shapes["params"], seed)
    tmod.load_state_dict(cosmos_state_dict_from_jax(params, tmod), strict=True)
    return jax.jit(lambda p, *a: jmod.apply({"params": p}, *a)), params, tmod.eval()


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(torch.as_tensor(got).float()), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err} of {np.abs(want).max()}"


def _cl(x):  # [B, C, T, H, W] numpy -> the JAX modules' [B, T, H, W, C]
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _cf(y):  # a JAX module's [B, T, H, W, C] -> [B, C, T, H, W]
    return np.moveaxis(np.asarray(y), -1, 1)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(tmod, *xs, **kw):
    with torch.no_grad():
        return tmod(*(torch.from_numpy(x) for x in xs), **kw)


# ---- the anchors


@pytest.mark.parametrize("shape", [(64, 16), (16384, 256)], ids=["tiny", "full"])
def test_threefry_bits_and_normals_match_jax(shape):
    assert jax.config.jax_threefry_partitionable  # the mode jax_random reproduces
    key = jax.random.PRNGKey(0)
    assert np.array_equal(jax_random.random_bits(0, shape),
                          np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = jax_random.uniform_bits(jax_random.random_bits(0, shape), lo, np.float32(1))
    assert np.array_equal(u, np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0)))
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = jax_random.normal(0, shape)
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= ULP
    # and the anchors as SimVQ scales them, e_dim**-0.5 in fp32
    anchors = tc.simvq_anchors(*shape).numpy()
    want_a = np.asarray(jax.random.normal(key, shape, jnp.float32) * shape[1] ** -0.5)
    ulp_a = np.abs(anchors.view(np.int32).astype(np.int64) - want_a.view(np.int32).astype(np.int64))
    assert ulp_a.max() <= ULP


def test_threefry_other_seeds_and_a_counter_past_2_32():
    """Other seeds; two nonzero key words and counters with a nonzero high
    word (elements 2**32 and on) through `threefry2x32` itself."""
    for seed in (1, 2**31 + 7):  # JAX without x64 keeps a seed's low 32 bits
        assert np.array_equal(
            jax_random.random_bits(seed, (3, 5)),
            np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (3, 5), jnp.uint32)))
    from jax._src import prng as jprng

    hi = np.array([1, 2, 0xFFFFFFFF], np.uint32)
    lo = np.array([0, 5, 123], np.uint32)
    want = jprng.threefry_2x32(jnp.array([3, 4], jnp.uint32), jnp.concatenate([hi, lo]))
    w0, w1 = jax_random.threefry2x32((3, 4), hi, lo)
    assert np.array_equal(np.concatenate([w0, w1]), np.asarray(want))


# ---- the modules, one at a time

CONV_CASES = [  # (kernel, stride, time_stride, padding): every use in the model
    ((3, 3, 3), 1, 1, 1), ((1, 3, 3), 1, 1, 1), ((3, 1, 1), 1, 1, 0), ((1, 1, 1), 1, 1, 0),
    ((1, 3, 3), 2, 1, 0), ((3, 1, 1), 1, 2, 0),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "k{}{}{}_s{}_ts{}_p{}".format(*c[0], *c[1:]))
def test_causal_conv3d(case):
    k, s, ts, p = case
    x = _x((2, 5, 7, 9, 9))
    f, params, tm = _pair(jc.CausalConv3d(6, k, s, ts, p), tc.CausalConv3d(5, 6, k, s, ts, p),
                          _cl(x))
    _close(_run(tm, x), _cf(f(params, _cl(x))), what=str(case))


def test_causal_normalize_statistics_over_c_t_h_w():
    x = 3 + 2 * _x((2, 6, 3, 5, 5))
    f, params, tm = _pair(jc.CausalNormalize(), tc.CausalNormalize(6), _cl(x))
    _close(_run(tm, x), _cf(f(params, _cl(x))))


@pytest.mark.parametrize("out", [6, 10], ids=["same_width", "nin_shortcut"])
def test_resnet_block(out):
    x = _x((2, 6, 4, 8, 8))
    f, params, tm = _pair(jc.CausalResnetBlockFactorized3d(out),
                          tc.CausalResnetBlockFactorized3d(6, out), _cl(x))
    _close(_run(tm, x), _cf(f(params, _cl(x))))


@pytest.mark.parametrize("block", ["spatial", "temporal", "temporal_one_frame"])
def test_attention_blocks(block):
    x = _x((2, 8, 1 if block == "temporal_one_frame" else 4, 6, 6))
    jmod, tmod = ((jc.CausalAttnBlock(), tc.CausalAttnBlock(8, torch.float32, None))
                  if block == "spatial" else
                  (jc.CausalTemporalAttnBlock(), tc.CausalTemporalAttnBlock(8, torch.float32, None)))
    if block == "temporal_one_frame":  # the identity, and no parameters in JAX
        shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), _cl(x))
        assert not shapes.get("params")
        assert np.array_equal(_run(tmod, x).numpy(), x)
        return
    f, params, tm = _pair(jmod, tmod, _cl(x))
    _close(_run(tm, x), _cf(f(params, _cl(x))))


def test_spatial_cross_attention_to_frame_zero():
    mot, ref = _x((2, 8, 3, 6, 6)), _x((2, 8, 1, 6, 6), seed=1)
    f, params, tm = _pair(jc.SpatialCrossAttnBlock(), tc.SpatialCrossAttnBlock(8, torch.float32, None),
                          _cl(mot), _cl(ref))
    want = _cf(f(params, _cl(mot), _cl(ref)))
    _close(_run(tm, mot, ref), want)
    # chunks of frames: the same per-frame arithmetic
    budget = tc.CROSS_ATTN_SCORES
    try:
        tc.CROSS_ATTN_SCORES = 2 * 36 * 36  # one frame of the batch of 2 a chunk
        _close(_run(tm, mot, ref), want)
    finally:
        tc.CROSS_ATTN_SCORES = budget


@pytest.mark.parametrize("mode", [(True, False), (True, True), (False, True)],
                         ids=["spatial", "spatial_temporal", "temporal"])
def test_downsample(mode):
    x = _x((2, 6, 5, 8, 8))
    f, params, tm = _pair(jc.CausalHybridDownsample3d(*mode),
                          tc.CausalHybridDownsample3d(6, *mode), _cl(x))
    _close(_run(tm, x), _cf(f(params, _cl(x))))


@pytest.mark.parametrize("mode,frames", [((True, False), 3), ((True, True), 3), ((True, True), 1)],
                         ids=["spatial", "spatial_temporal", "temporal_one_frame"])
def test_upsample(mode, frames):
    x = _x((2, 6, frames, 4, 4))
    f, params, tm = _pair(jc.CausalHybridUpsample3d(*mode), tc.CausalHybridUpsample3d(6, *mode),
                          _cl(x))
    _close(_run(tm, x), _cf(f(params, _cl(x))))


ENC = dict(channels=8, channels_mult=(1, 2, 4, 4), z_channels=16, ref_target_stride=8,
           motion_target_stride=16, motion_temporal_down_count=2)


def test_encoder_both_branches():
    x = np.random.RandomState(0).rand(2, *CLIP).astype(np.float32)
    jmod = jc.CosmosDualSharedEncoder(**ENC)
    f, params, tm = _pair(jmod, tc.CosmosDualSharedEncoder(**ENC), jnp.asarray(x))
    z_ref, z_mot = f(params, jnp.asarray(x))
    got_ref, got_mot = _run(tm, x)
    assert got_ref.shape == (2, 16, 1, 4, 4) and got_mot.shape == (2, 16, 2, 2, 2)
    _close(got_ref, z_ref, what="reference branch")
    _close(got_mot, z_mot, what="motion branch")
    # one frame: no motion branch
    z_ref1, z_mot1 = f(params, jnp.asarray(x[:, :, :1]))
    got1, none = _run(tm, x[:, :, :1])
    assert z_mot1 is None and none is None
    _close(got1, z_ref1)


DEC = dict(channels=8, channels_mult=(1, 2, 4, 4), z_channels=16, spatial_compression=8,
           motion_spatial_compression=16, motion_temporal_compression=4,
           cross_attn_resolutions=(8, 4, 2))


def test_decoder():
    z_ref, z_mot = _x((2, 16, 1, 4, 4)), _x((2, 16, 2, 2, 2), seed=1)
    f, params, tm = _pair(jc.CosmosDualSharedDecoder(**DEC), tc.CosmosDualSharedDecoder(**DEC),
                          jnp.asarray(z_ref), jnp.asarray(z_mot))
    got = _run(tm, z_ref, z_mot)
    assert got.shape == (2, 3, 9, 32, 32)
    _close(got, f(params, jnp.asarray(z_ref), jnp.asarray(z_mot)))


def test_fsq_quantizer_proj():
    z = 2 * _x((2, 16, 2, 3, 3))
    f, params, tm = _pair(jc.FSQuantizerProj(dim=16), tc.FSQuantizerProj(dim=16), jnp.asarray(z))
    out, loss, idx = f(params, jnp.asarray(z))
    got, got_loss, got_idx = _run(tm, z)
    assert np.array_equal(got_idx.numpy(), np.asarray(idx)) and float(got_loss) == 0.0
    _close(got, out)
    entry = jax.jit(lambda p, i: jc.FSQuantizerProj(dim=16).apply(
        {"params": p}, i, method="get_codebook_entry"))(params, idx)
    with torch.no_grad():
        _close(tm.get_codebook_entry(got_idx), entry)


@pytest.mark.parametrize("legacy", [True, False])
def test_simvq(legacy):
    z = _x((2, 16, 2, 3, 3))
    jmod = jc.SimVQ(n_e=64, e_dim=16, legacy=legacy)
    f, params, tm = _pair(jmod, tc.SimVQ(64, 16, legacy=legacy), jnp.asarray(z))
    assert not dict(tm.named_parameters()).get("embedding") and "embedding" not in tm.state_dict()
    out, loss, idx = f(params, jnp.asarray(z))
    z_q, got_loss, got_idx = _run(tm, z)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (2, 2, 3, 3)
    assert np.array_equal(got_idx.numpy(), np.asarray(idx))
    _close(z_q, out)
    assert abs(float(got_loss) - float(loss)) <= TOL * abs(float(loss))
    entry = jax.jit(lambda p, i: jmod.apply({"params": p}, i, method="get_codebook_entry"))(params, idx)
    with torch.no_grad():
        _close(tm.get_codebook_entry(got_idx), entry)


# ---- the whole tokenizer


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX tokenizer, its params, the port's tokenizer with them)."""
    jm = jmodels.make({"name": name, "args": TINY})
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *CLIP)))
    params = _draw(shapes["params"], seed=2)
    pm = tmodels.make({"name": name, "args": {**TINY, "generator": torch.Generator().manual_seed(0)}})
    pm.load_state_dict(cosmos_state_dict_from_jax(params, pm), strict=True)
    return jm, params, pm.eval()


def _clips(batch=2, seed=0, shape=CLIP):
    return np.random.RandomState(seed).rand(batch, *shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    jm, params, _ = _models(name)
    return jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, _clips())


@pytest.mark.parametrize("name", ["cosmos", "cosmos_fsq"])
def test_forward_matches_jax(name):
    want = _jax_forward(name)
    out = _run(_models(name)[2], _clips())
    assert set(out) == {"pred_frames", "loss_q", "ind_ref", "ind_mot"}
    assert out["pred_frames"].shape == (2, *CLIP)
    _close(out["pred_frames"], want["pred_frames"], what="pred_frames")
    for k in ("ind_ref", "ind_mot"):
        assert np.array_equal(out[k].numpy(), np.asarray(want[k])), k
    assert out["ind_ref"].shape == (2, 1, 4, 4) and out["ind_mot"].shape == (2, 2, 2, 2)
    want_q = float(want["loss_q"])
    assert abs(float(out["loss_q"]) - want_q) <= TOL * max(abs(want_q), 1e-30)
    assert (want_q > 0) == (name == "cosmos")


@pytest.mark.parametrize("name", ["cosmos", "cosmos_fsq"])
def test_encode_and_decode_indices_match_jax(name):
    jm, params, pm = _models(name)
    x = _clips()
    # JAX's encode_indices runs the forward's encoder and quantizer: its indices
    want = _jax_forward(name)
    ind_ref, ind_mot = want["ind_ref"], want["ind_mot"]
    got_ref, got_mot = pm.encode_indices(torch.from_numpy(x))
    assert np.array_equal(got_ref.numpy(), np.asarray(ind_ref))
    assert np.array_equal(got_mot.numpy(), np.asarray(ind_mot))
    video = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b, method="decode_indices"))(
        params, ind_ref, ind_mot)
    with torch.no_grad():
        got = pm.decode_indices(got_ref, got_mot)
        _close(got, video)
        # the forward's reconstruction: only the straight-through rounding differs
        _close(got, pm(torch.from_numpy(x))["pred_frames"])
        with pytest.raises(ValueError):
            pm.decode_indices(got_ref, None)
        with pytest.raises(ValueError):
            pm(torch.from_numpy(x[:, :, :1]))
        ref_only, none = pm.encode_indices(torch.from_numpy(x[:, :, :1]))
        assert none is None and torch.equal(ref_only, got_ref)


GRADS = {"encoder.conv_in_s.conv3d.weight": 1e-4,
         "encoder.layer1_block0.nin_shortcut.conv3d.weight": 1e-4,
         "encoder.mot_head.mid_attn_t.q.conv3d.weight": 1e-4,
         "quantizer.embedding_proj.weight": 1e-4, "decoder.inject_scale_2.k.conv3d.weight": 1e-4,
         "decoder.conv_out.conv3d.bias": 5e-4}  # a sum over 2 x 9 x 32 x 32 outputs


def test_gradients_match_jax_grad():
    jm, params, pm = _models("cosmos")
    x = _clips()
    # mean |pred - x| with the sign of pred - x at the JAX forward's pred: its
    # value and gradient there, on both sides
    sign = np.sign(np.asarray(_jax_forward("cosmos")["pred_frames"]) - x)

    def loss(p):
        out = jm.apply({"params": p}, x)
        return jnp.mean((out["pred_frames"] - x) * sign) + out["loss_q"]

    want = cosmos_state_dict_from_jax(jax.jit(jax.grad(loss))(params), pm)
    pm.zero_grad()
    out = pm(torch.from_numpy(x))
    l1 = torch.mean((out["pred_frames"] - torch.from_numpy(x)) * torch.from_numpy(sign))
    assert torch.isclose(l1, torch.mean(torch.abs(out["pred_frames"] - torch.from_numpy(x))))
    (l1 + out["loss_q"]).backward()
    got = dict(pm.named_parameters())
    for name, tol in GRADS.items():
        g, w = got[name].grad, want[name]
        assert g is not None and float(w.abs().max()) > 0, name
        _close(g, w.numpy(), tol=tol, what=name)
    pm.zero_grad()


def test_bf16_model_keeps_the_quantizer_in_fp32():
    jm, params, pm32 = _models("cosmos")
    pm = tmodels.make({"name": "cosmos", "args": {**TINY, "dtype": torch.bfloat16}})
    pm.load_state_dict(pm32.state_dict())
    pm.eval()
    x = _clips()
    seen = {}

    def keep(name):
        def hook(module, inputs, output):
            seen.setdefault(name, (inputs[0], output))
        return hook

    pm.quantizer.register_forward_hook(keep("q"))
    pm.quantizer.embedding_proj.register_forward_hook(keep("proj"))
    out = _run(pm, x)
    z_in, (z_q, loss, _) = seen["q"]
    assert z_in.dtype == z_q.dtype == out["pred_frames"].dtype == torch.bfloat16
    assert seen["proj"][1].dtype == loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    # no farther from the fp32 JAX model than the JAX module's own bf16 output
    j16 = jmodels.make({"name": "cosmos", "args": {**TINY, "dtype": jnp.bfloat16}})
    want16 = jax.jit(lambda p, v: j16.apply({"params": p}, v))(params, x)
    want32 = np.asarray(_jax_forward("cosmos")["pred_frames"], np.float32)
    err = np.abs(out["pred_frames"].float().numpy() - want32).max()
    err_jax = np.abs(np.asarray(want16["pred_frames"], np.float32) - want32).max()
    assert 0 < err <= 2 * err_jax, (err, err_jax)


# ---- sizes, factories, the reference's faults


@pytest.mark.parametrize("name,count", [("cosmos", 113_163_651), ("cosmos_fsq", 113_101_193)])
def test_full_width_parameter_counts(name, count):
    """The registered defaults (base 128, multipliers 1, 2, 4, 4, latent 256,
    K = 16,384, strides 8 / 16, two temporal downs) at 17 x 128 x 128: the
    port's parameters, built on the meta device, against the JAX init's shapes
    (traced, not run). The anchors are a buffer, not a parameter, on both
    sides."""
    jm = jmodels.make({"name": name, "args": {}})
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 17, 128, 128)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        pm = tmodels.make({"name": name, "args": {}})
    assert sum(p.numel() for p in pm.parameters()) == want == count
    assert pm.codebook_size == (16384 if name == "cosmos" else 64000) == jm.codebook_size


def test_factories_drop_unknown_keys_and_reconstruct_builds_the_same_model():
    from video_tokenizer_tpu_torch.config import load_config
    from video_tokenizer_tpu_torch.reconstruct import build_model

    cfg = load_config("cfgs/larp_tokenizer.yaml", {"input_size": 128, "frame_num": 17},
                      ["model.name", "cosmos"])
    args = cfg.model.to_dict()["args"]
    assert "bottleneck_token_num" in args  # a key neither model takes
    jm = jmodels.make(cfg.model.to_dict())
    with torch.device("meta"):
        pm = build_model("cfgs/larp_tokenizer.yaml", None, torch.bfloat16, "meta", 0, 128, 17,
                         ["model.name", "cosmos"])
    assert isinstance(pm, tc.CosmosVideoTokenizer) and pm.quantizer_type == "simvq"
    assert (jm.base_channels, jm.latent_dim, jm.codebook_size) == (128, 256, 16384)
    assert sum(p.numel() for p in pm.parameters()) == 113_163_651
    assert pm.decoder.conv_out.dtype == torch.bfloat16


def test_the_reference_faults_are_kept():
    """The JAX model has neither `frame_num` nor `input_size` (its tokenizer
    trainer reads both, so it cannot train Cosmos), and with two temporal
    downs a 16-frame clip reconstructs to 1 + 4 ceil(15 / 4) = 13 frames, on
    both sides (17 and 9 round-trip)."""
    jm, params, pm = _models("cosmos_fsq")
    assert not hasattr(jm, "frame_num") and not hasattr(jm, "input_size")
    assert not hasattr(pm, "frame_num") and not hasattr(pm, "input_size")
    x = _clips(1, shape=(3, 16, 32, 32))
    want = jax.eval_shape(lambda v: jm.apply({"params": params}, v), jnp.asarray(x))
    assert want["pred_frames"].shape == (1, 3, 13, 32, 32)
    assert _run(pm, x)["pred_frames"].shape == (1, 3, 13, 32, 32)
