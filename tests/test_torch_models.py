"""Parity of the port's modules with their Flax counterparts, on the CPU.

Weights go from Flax to the port through `state_dict_from_jax`; inputs are
numpy arrays from a seed. The JAX side runs its XLA attention and VQ paths;
the port's kernel wrappers run their plain versions on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import clips, f32, jax_tokenizer, perturb, port_tokenizer
from video_tokenizer_tpu.models import bottleneck as jbn
from video_tokenizer_tpu.models import embed as jembed
from video_tokenizer_tpu.models import transformer as jtr
from video_tokenizer_tpu_torch.models import bottleneck as tbn
from video_tokenizer_tpu_torch.models import embed as tembed
from video_tokenizer_tpu_torch.models import transformer as ttr
from video_tokenizer_tpu_torch.utils import convert

# fp32 on both sides: only summation order differs (GEMMs over <= 512
# terms, LayerNorm variance formula), ~1e-6 per layer on O(1) activations
ATOL_MODULE = 2e-5
ATOL_MODEL = 1e-4


def _init(module, *inputs, **kw):
    variables = module.init({"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, inputs), **kw)
    return perturb(variables["params"], scale=0.05)


def test_patch_embed_3d():
    x = clips(1)
    jm = jembed.PatchEmbed3D(spatial_patch_size=8, temporal_patch_size=4, embed_dim=128)
    params = _init(jm, x)
    tm = tembed.PatchEmbed3D(8, 4, 3, 128)
    sd = {}
    convert.patch_embed_from_jax(sd, "proj", params["proj"], (4, 8, 8), 3)
    assert sd["proj.weight"].shape == (128, 3, 4, 8, 8)  # the upstream Conv3d layout
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2 * 4 * 4, 128)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL_MODULE)
    # the same weight as a stride == kernel Conv3d, the upstream module
    conv = torch.nn.functional.conv3d(torch.from_numpy(x), tm.proj.weight, tm.proj.bias,
                                      stride=(4, 8, 8))
    np.testing.assert_allclose(f32(got), f32(conv.flatten(2).transpose(1, 2)), atol=ATOL_MODULE)


def test_video_patch_embed():
    """Per-frame 2D patches (temporal_patch_size == 1): upstream Conv2d layout."""
    x = clips(2, frames=2)
    jm = jembed.VideoPatchEmbed(patch_size=8, embed_dim=64)
    params = _init(jm, x)
    tm = tembed.VideoPatchEmbed(8, 3, 64)
    sd = {}
    convert.patch_embed_from_jax(sd, "proj", params["proj"], (8, 8), 3)
    assert sd["proj.weight"].shape == (64, 3, 8, 8)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2 * 4 * 4, 64)
    np.testing.assert_allclose(
        f32(got), f32(jm.apply({"params": params}, jnp.asarray(x))), atol=ATOL_MODULE
    )


def _vit_state_dict(params, depth):
    sd = {}
    convert.vit_stack_from_jax(sd, "stack", {f"blocks_{i}": params[f"blocks_{i}"]
                                             for i in range(depth)})
    return {k.removeprefix("stack."): torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def test_vit_block():
    x = np.random.RandomState(2).randn(2, 48, 128).astype(np.float32)
    jm = jtr.ViTBlock(128, 2)
    params = _init(jm, x)
    tm = ttr.ViTBlock(128, 2)
    sd = _vit_state_dict({"blocks_0": params}, 1)
    tm.load_state_dict({k.removeprefix("blocks.0."): v for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(
        f32(tm(torch.from_numpy(x))), f32(jm.apply({"params": params}, jnp.asarray(x))),
        atol=ATOL_MODULE,
    )


def test_vit_stack():
    x = np.random.RandomState(3).randn(2, 64, 128).astype(np.float32)
    jm = jtr.ViTStack(128, 2, 2)
    params = _init(jm, x)
    tm = ttr.ViTStack(128, 2, 2)
    tm.load_state_dict(_vit_state_dict(params, 2), strict=True)
    np.testing.assert_allclose(
        f32(tm(torch.from_numpy(x))), f32(jm.apply({"params": params}, jnp.asarray(x))),
        atol=ATOL_MODULE,
    )


# (norm, stochastic (-> cos lookup), stochastic_temperature (<= 0: learnable,
# folded into z), entropy_loss_weight)
BOTTLENECK_CASES = [
    ("none", True, 0.03, 0.0), ("ln_d", False, 1.0, 0.1), ("ln_d_na", True, 0.03, 0.0),
    ("none", True, 0.0, 0.0),
]


@pytest.mark.parametrize("norm,stochastic,temperature,entropy_w", BOTTLENECK_CASES)
def test_bottleneck_vq(norm, stochastic, temperature, entropy_w):
    reg = {"name": "vq", "args": {
        "codebook_size": 64, "l2_normalized": True, "stochastic": stochastic,
        "stochastic_temperature": temperature, "entropy_loss_weight": entropy_w,
    }}
    kw = dict(bottleneck_dim=8, input_dim=128, output_dim=128, token_nums=32, norm=norm,
              regularizer=reg)
    x = np.random.RandomState(4).randn(2, 32, 128).astype(np.float32)
    jm = jbn.Bottleneck(**kw)
    params = _init(jm, x)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = tbn.Bottleneck(**kw).eval()
    sd = {}
    convert.bottleneck_from_jax(sd, "b", params)
    tm.load_state_dict({k.removeprefix("b."): torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in sd.items()}, strict=True)
    got = tm(torch.from_numpy(x))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    for key in sorted(set(want) - {"bottleneck_rep"}):
        np.testing.assert_allclose(f32(got[key]), f32(want[key]), atol=ATOL_MODULE, err_msg=key)
    # decode: indices -> the out-projected (normalised) codes
    np.testing.assert_allclose(
        f32(tm.decode(got["bottleneck_rep"])),
        f32(jm.apply({"params": params}, want["bottleneck_rep"], method=jm.decode)),
        atol=ATOL_MODULE,
    )


def test_entropy_loss():
    aff = np.random.RandomState(5).randn(4, 16, 64).astype(np.float32)
    for loss_type in ("softmax", "argmax"):
        got = tbn.entropy_loss(torch.from_numpy(aff), loss_type, 0.05)
        want = jbn.entropy_loss(jnp.asarray(aff), loss_type, 0.05)
        np.testing.assert_allclose([f32(g) for g in got], [f32(w) for w in want], rtol=1e-5)


@pytest.fixture(scope="module")
def tiny_fp32():
    jm, params = jax_tokenizer(jnp.float32)
    return jm, params, port_tokenizer(params, torch.float32)


def test_tokenizer_forward_fp32(tiny_fp32):
    jm, params, tm = tiny_fp32
    x = clips(0)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want)
    assert got["pred_frames"].shape == (2, 3, 8, 32, 32)
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    for key in ("pred_frames", "encoded", "projected_z", "loss_q", "loss_commit"):
        np.testing.assert_allclose(f32(got[key]), f32(want[key]), atol=ATOL_MODEL, err_msg=key)


def test_tokenizer_eval_and_decode_from_bottleneck_fp32(tiny_fp32):
    jm, params, tm = tiny_fp32
    x = clips(1, frames=4)  # fewer frames than trained: the PEs are truncated
    v = {"params": params}
    enc = jm.apply(v, jnp.asarray(x), method=jm.encode_eval)
    want = jm.apply(v, enc["encoded"], enc["num_x_tokens"], method=jm.decode_eval)
    with torch.inference_mode():
        tenc = tm.encode_eval(torch.from_numpy(x))
        got = tm.decode_eval(tenc["encoded"], tenc["num_x_tokens"])
    assert tenc["num_x_tokens"] == enc["num_x_tokens"] == 16
    np.testing.assert_array_equal(tenc["bottleneck_rep"].numpy(), np.asarray(enc["bottleneck_rep"]))
    assert got.shape == (2, 3, 4, 32, 32)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL_MODEL)

    idx = np.random.RandomState(2).randint(0, 64, (2, 32)).astype(np.int32)
    want = jm.apply(v, jnp.asarray(idx), method=jm.decode_from_bottleneck)
    with torch.inference_mode():
        got = tm.decode_from_bottleneck(torch.from_numpy(idx))
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL_MODEL)


def test_tokenizer_bf16_dtype_policy():
    """bf16 mode: bf16 encoder and output layer, fp32 bottleneck and decoder
    stream. Tolerance 3e-2 on outputs of magnitude ~0.5: the two frameworks
    round the bf16 GEMM outputs and GELU at slightly different points,
    ~1 bf16 ulp (2^-8 relative) per layer over 2 + 2 layers. Indices are
    compared through decode_from_bottleneck with shared indices, and must
    agree on most tokens (a bf16 near-tie may flip)."""
    jm, params = jax_tokenizer(jnp.bfloat16)
    tm = port_tokenizer(params, torch.bfloat16)
    x = clips(3)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got["pred_frames"].dtype == torch.bfloat16 and want["pred_frames"].dtype == jnp.bfloat16
    assert got["encoded"].dtype == torch.float32 and want["encoded"].dtype == jnp.float32
    agree = np.mean(got["bottleneck_rep"].numpy() == np.asarray(want["bottleneck_rep"]))
    assert agree >= 0.9, agree
    idx = np.array(want["bottleneck_rep"])
    want_dec = jm.apply({"params": params}, jnp.asarray(idx), method=jm.decode_from_bottleneck)
    with torch.inference_mode():
        got_dec = tm.decode_from_bottleneck(torch.from_numpy(idx))
    assert got_dec.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got_dec), f32(want_dec), atol=3e-2)
    if agree == 1.0:
        np.testing.assert_allclose(f32(got["pred_frames"]), f32(want["pred_frames"]), atol=3e-2)
