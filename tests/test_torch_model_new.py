"""The port's model_new family (M-RoPE, FSQ, the autoencoders) against the JAX package.

On the CPU.

Weights are drawn with numpy from a seed on the shapes of the JAX init
(`numpy_params`: compiling each variant's init would cost more than its
test) and reach the port through `model_new_state_dict_from_jax`; clips are numpy
from a seed. The JAX side runs jitted with its XLA attention; the port's
flash wrapper runs its plain version on CPU tensors. Tolerances:
  * rotary tables: bit for bit (both are numpy in fp64, cast to fp32);
  * `apply_rotary`: 1e-6 absolute (fp32 on both sides);
  * FSQ codes and indices exact; the STE gradient within 1e-6 (XLA's tanh
    and torch's differ in their last bits);
  * blocks and whole models in fp32: 1e-5 of the output's scale, indices
    equal. The 'simple' style's whole model gets 1e-4: its scalar mask
    token makes every pixel query a constant row at the decoder's first
    LayerNorm, where Flax's fast variance (E[x^2] - E[x]^2) leaves rounding
    residue that 1/sqrt(eps) = 1000 amplifies, while torch's layer_norm finds
    zero variance; `test_simple_style_gap_is_the_references_fp32_rounding`
    holds the port nearer the JAX model in fp64 than JAX's fp32 output;
  * bf16: as accurate as the JAX module's own bf16 (see the test).
Also: the ten registrations, the four shipped configs' parameter counts, and
the reference's fault with the configs' int `patch_size`, which the port
reads as (temporal_patch_size, p, p).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video_tokenizer_tpu.models  # noqa: F401
from _torch_port import f32
from video_tokenizer_tpu.models import fsq as jfsq
from video_tokenizer_tpu.models import model_new as jmn
from video_tokenizer_tpu.ops import rope as jrope
from video_tokenizer_tpu.registry import models as jmodels
from video_tokenizer_tpu_torch.config import load_config
from video_tokenizer_tpu_torch.models import fsq as tfsq
from video_tokenizer_tpu_torch.models import model_new as tmn
from video_tokenizer_tpu_torch.ops import rope as trope
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import model_new_state_dict_from_jax

TINY = {"model_size": "tiny", "num_latent_tokens": 8, "input_size": 32, "frame_num": 8}
TINY_FIRST = {**TINY, "decoder_model_size": "tiny", "first_frame_tokens": 4}
# every registration at the shapes of tests/test_families.py; f256t1024a keeps
# its thin encoders (GEGLU at mult 2)
CASES = [
    ("autoencoder_convpatchify", TINY),
    ("autoencoder_convpatchify_greatfsq", TINY),
    ("autoencoder_mask3", TINY),
    ("autoencoder_convpatchify_mask2", TINY),
    ("autoencoder_convpatchify_mask2_greatfsq", TINY),
    ("autoencoder_convpatchify_simplytransformer", TINY),
    ("autoencoder_large", TINY),
    ("autoencoder_first_token_f256t1024a", {**TINY_FIRST, "model_size": "tiny_thin"}),
    ("autoencoder_first_token_f256t768", TINY_FIRST),
    ("autoencoder_first_token_f256t512", TINY_FIRST),
]
IDS = [c[0] for c in CASES]
SHIPPED = {  # config -> (registered name, parameters); full width, 16 x 128 x 128
    "larp_tokenizer_large": ("autoencoder_large", 659_155_720),
    "larp_tokenizerf256t1024": ("autoencoder_first_token_f256t1024a", 81_655_567),
    "larp_tokenizerf256t768": ("autoencoder_first_token_f256t768", 277_451_535),
    "larp_tokenizerf256t512": ("autoencoder_first_token_f256t512", 277_451_535),
}


def _clips(seed=0, batch=2):
    return np.random.RandomState(seed).rand(batch, 3, 8, 32, 32).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(f32(got) - want).max() / np.abs(want).max())


def numpy_params(module, *inputs, seed=0):
    """Seeded weights for `module`'s Flax tree, drawn with numpy on the shapes
    of its init (traced, not compiled): LayerNorm scales 1 + 0.1 N(0, 1),
    biases 0.02 N(0, 1), kernels and mask tokens 0.03 N(0, 1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.randn(*s.shape).astype(np.float32)
        return 1 + 0.1 * x if name == "scale" else (0.02 if name == "bias" else 0.03) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """(JAX module, params, jitted apply) of a CASES entry, fp32."""
    m = jmodels.make({"name": name, "args": dict(CASES)[name]})
    params = numpy_params(m, jnp.asarray(_clips(batch=1)))
    return m, params, jax.jit(lambda p, x: m.apply({"params": p}, x))


def _port_model(name, dtype=torch.float32):
    _, params, _ = _jax_model(name)
    m = tmodels.make({"name": name, "args": dict(CASES)[name]},
                     args={"dtype": dtype, "generator": torch.Generator().manual_seed(0)})
    m.load_state_dict(model_new_state_dict_from_jax(params, m), strict=True)
    return m.eval()


# ------------------------------------------------------------------ rope


def _grids():
    """(in_tokens, grid) of every stack of the four shipped configs."""
    seen = []
    for cfg_name in SHIPPED:
        m = _shipped(cfg_name)
        for stack in (m.encoder, getattr(m, "encoder1", None)):
            if stack is not None:
                seen.append((stack.out_tokens, tuple(stack.grid)))
    return sorted(set(seen))


@functools.lru_cache(maxsize=None)
def _shipped(cfg_name):
    cfg = load_config(f"cfgs/{cfg_name}.yaml", {"input_size": 128, "frame_num": 16})
    with torch.device("meta"):
        return tmodels.make(cfg.model.to_dict())


def test_rope_tables_equal_jax_bit_for_bit():
    """The single-segment tables of every encoder of the four configs, the
    multi-segment tables of the conditioned decoders, both layouts."""
    grids = _grids()
    assert (1024, (4, 16, 16)) in grids and (256, (1, 16, 16)) in grids
    for toks, grid in grids:
        for interleave in (True, False):
            for j, t in zip(jrope.mrope_cos_sin(toks, grid, 64, interleave=interleave),
                            trope.mrope_cos_sin(toks, grid, 64, interleave=interleave)):
                assert t.dtype == np.float32 and np.array_equal(j, t), (toks, grid)
    for latents in (1024, 768, 512):
        segs = [(256, [1, 16, 16]), (latents, [4, 16, 16])]
        for j, t in zip(jrope.mrope_cos_sin_multi(segs, 64), trope.mrope_cos_sin_multi(segs, 64)):
            assert j.shape == (256 + 256 + latents + 1024, 32) and np.array_equal(j, t)
    for dim, axes in ((64, 3), (62, 3), (32, 2)):
        assert trope._axes_dims(dim, axes) == jrope._axes_dims(dim, axes)


def test_decoder_table_cuts_the_conditioning_grid():
    """A conditioned decoder's buffer is [cond rows || latent rows || pixel
    rows] of the JAX multi-segment table (the first frame's grid rows cut
    out); it is no part of the state dict."""
    m = tmodels.make({"name": "autoencoder_first_token_f256t512", "args": TINY_FIRST})
    cos, sin = jrope.mrope_cos_sin_multi([(4, [1, 4, 4]), (8, [2, 4, 4])], 64)
    keep = list(range(4)) + list(range(4 + 16, len(cos)))
    assert np.array_equal(m.decoder.rope_cos.numpy(), cos[keep])
    assert np.array_equal(m.decoder.rope_sin.numpy(), sin[keep])
    assert not any("rope" in k or "quantize" in k for k in m.state_dict())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_rotary_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 3, 64).astype(np.float32)
    cos, sin = jrope.mrope_cos_sin(8, [2, 4, 4], 64)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jrope.apply_rotary(jx, jnp.asarray(cos), jnp.asarray(sin))
    got = trope.apply_rotary(torch.from_numpy(x).to(dtype), torch.from_numpy(cos),
                             torch.from_numpy(sin))
    assert got.dtype == dtype
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-6)


# ------------------------------------------------------------------- FSQ


@pytest.mark.parametrize("levels", [(8, 8, 8, 5, 5, 5), tmn.GREAT_FSQ], ids=["default", "great"])
def test_fsq_matches_jax(levels):
    """Codes, indices and both round trips exact on random inputs, and the
    STE gradient of a weighted sum. Where the bound lands within an ulp of a
    half-integer, the last bit of tanh decides the rounding, and JAX's XLA
    tanh and torch's differ in their last bits: there only the bound is
    held (1e-6), as the card's indices are held against the CPU's by share."""
    rng = np.random.RandomState(2)
    z = (rng.randn(4, 64, len(levels)) * 2).astype(np.float32)
    jq, tq = jfsq.FSQ(levels), tfsq.FSQ(levels)
    want_codes, want_info = jq(jnp.asarray(z))
    got_codes, got_info = tq(torch.from_numpy(z))
    assert tq.codebook_size == jq.codebook_size == int(np.prod(levels))
    np.testing.assert_array_equal(f32(got_codes), f32(want_codes))
    assert got_info["indices"].dtype == torch.int32
    np.testing.assert_array_equal(got_info["indices"].numpy(), np.asarray(want_info["indices"]))
    # z at the bound's half-integer crossings
    levels_np = np.asarray(levels)
    half_l, offset = (levels_np - 1) * (1 + 1e-3) / 2, np.where(levels_np % 2 == 0, 0.5, 0.0)
    edge = np.clip((np.arange(-3, 4)[:, None] + 0.5 + offset) / half_l, -0.999, 0.999)
    edge = (np.arctanh(edge) - np.arctanh(offset / half_l)).astype(np.float32)
    np.testing.assert_allclose(f32(tq.bound(torch.from_numpy(edge))),
                               f32(jq.bound(jnp.asarray(edge))), atol=1e-6)

    idx = np.concatenate([np.asarray(want_info["indices"]).reshape(-1),
                          [0, jq.codebook_size - 1]]).astype(np.int32)
    np.testing.assert_array_equal(f32(tq.indices_to_codes(torch.from_numpy(idx))),
                                  f32(jq.indices_to_codes(jnp.asarray(idx))))
    np.testing.assert_array_equal(tq.codes_to_indices(tq.indices_to_codes(torch.from_numpy(idx)))
                                  .numpy(), idx)
    every = np.arange(jq.codebook_size, dtype=np.int32)  # the implicit codebook
    np.testing.assert_array_equal(f32(tq.indices_to_codes(torch.from_numpy(every))),
                                  jq.implicit_codebook)

    w = rng.randn(*z.shape).astype(np.float32)
    want_g = jax.grad(lambda z: jnp.sum(jq(z)[0] * w))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    (tq(zt)[0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(f32(zt.grad), f32(want_g), atol=1e-6)


def test_round_ste_rounds_half_to_even_with_identity_gradient():
    z = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49], requires_grad=True)
    out = tfsq.round_ste(z)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jfsq.round_ste(jnp.asarray(z.detach().numpy()))))
    out.sum().backward()
    np.testing.assert_array_equal(z.grad.numpy(), np.ones(7, np.float32))


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("size", ["tiny", "small", "base", "large", "tiny_thin", "small_thin",
                                  "base_thin", "large_thin"])
def test_model_dims_match_jax(size):
    assert tmn.get_model_dims(size) == jmn.get_model_dims(size)


@pytest.mark.parametrize("style", ["gated", "simple"])
def test_block_matches_jax(style):
    """One block of width 128, 2 heads of 64, at an M-RoPE geometry."""
    cos, sin = jrope.mrope_cos_sin(8, [2, 4, 4], 64)
    x = np.random.RandomState(3).randn(2, 40, 128).astype(np.float32)
    jm = jmn.RoPEBlockStack(128, 1, 2, style=style)
    args = (jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    params = numpy_params(jm, *args)
    want = jm.apply({"params": params}, *args)
    tm = tmn.RoPEBlockStack(128, 1, 2, style=style)
    tm.load_state_dict(model_new_state_dict_from_jax(params, tm), strict=True)
    got = tm(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------- whole models


@pytest.mark.parametrize("name", IDS)
def test_variant_matches_jax_fp32(name):
    """pred_frames within 1e-5 of its scale (1e-4 for the simple style, see
    the module docstring), codes and indices (and first-frame ones) equal."""
    _, params, apply = _jax_model(name)
    x = _clips()
    want = apply(params, jnp.asarray(x))
    model = _port_model(name)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want), set(got) ^ set(want)
    assert got["pred_frames"].shape == (2, 3, 8, 32, 32)
    tol = 1e-4 if "simplytransformer" in name else 1e-5
    assert _rel(got["pred_frames"], want["pred_frames"]) <= tol
    for key in ("bottleneck_rep", "first_rep"):
        if key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("encoded", "first_encoded"):
        if key in want:
            np.testing.assert_array_equal(f32(got[key]), f32(want[key]))
    assert float(got["loss_q"]) == 0.0
    assert model.codebook_size == int(np.prod(model.quantize.levels.numpy()))
    assert model.bottleneck_token_num == 8


@pytest.mark.parametrize("name", ["autoencoder_large", "autoencoder_first_token_f256t768"])
def test_variant_gradients_match_jax(name):
    """Every parameter's gradient of sum(pred_frames * w), a fixed output
    gradient, against JAX's autodiff: 1e-4 of each tensor's max |g| (the
    scalar mask token's gradient sums every row and channel of the
    decoder's pixel queries, the loosest of them)."""
    m, params, _ = _jax_model(name)
    x = _clips(seed=7)
    w = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(m.apply({"params": p}, jnp.asarray(x))["pred_frames"] * w)))(params)
    want = model_new_state_dict_from_jax(jax.device_get(grads), _port_model(name))
    model = _port_model(name)
    (model(torch.from_numpy(x))["pred_frames"] * torch.from_numpy(w)).sum().backward()
    for n, p in model.named_parameters():
        scale = want[n].abs().max().item()
        assert (p.grad - want[n]).abs().max().item() <= 1e-4 * scale + 1e-12, n


_FP64_DECODE = """
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.registry import models
data = np.load(sys.argv[1])
params = {}
for key in data.files:
    if key != "codes":
        *path, leaf = key.split("/")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(data[key], np.float64)
m = models.make({"name": sys.argv[2], "args": {**eval(sys.argv[3]), "dtype": jnp.float64}})
out = m.apply({"params": params}, jnp.asarray(data["codes"], jnp.float64),
              method=lambda mod, c: mod.decode(c))
np.save(sys.argv[4], np.asarray(out, np.float64))
"""


def test_simple_style_gap_is_the_references_fp32_rounding(tmp_path):
    """Why the simple style's whole model gets 1e-4 above: both fp32 decodes
    of the same codes against the JAX decoder evaluated in fp64 (x64 on, in
    a subprocess): the port lies within 1e-5 of it and nearer than JAX's
    own fp32 decode."""
    import subprocess
    import sys
    from pathlib import Path

    name = "autoencoder_convpatchify_simplytransformer"
    m, params, apply = _jax_model(name)
    codes = np.asarray(apply(params, jnp.asarray(_clips()))["encoded"])
    decode = jax.jit(lambda p, c: m.apply({"params": p}, c, method=lambda mod, z: mod.decode(z)))
    jax32 = np.asarray(decode(params, jnp.asarray(codes)))
    with torch.no_grad():
        port = f32(_port_model(name).decode(torch.from_numpy(codes)))
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "p.npz", codes=codes, **flat)
    proc = subprocess.run(
        [sys.executable, "-c", _FP64_DECODE, str(tmp_path / "p.npz"), name, repr(TINY),
         str(tmp_path / "ref.npy")], cwd=Path(__file__).resolve().parent.parent,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = np.load(tmp_path / "ref.npy")
    scale = np.abs(ref).max()
    jax_err, port_err = (float(np.abs(a - ref).max() / scale) for a in (jax32, port))
    print(f"{name} decode against fp64 JAX: JAX fp32 {jax_err:.3g}, port {port_err:.3g} of the "
          f"scale; port vs JAX fp32 {_rel(port, jax32):.3g}")
    assert port_err <= 1e-5 and port_err <= jax_err


@pytest.mark.parametrize("name", ["autoencoder_large",
                                  "autoencoder_convpatchify_simplytransformer"])
def test_variant_bf16_as_accurate_as_the_jax_module(name):
    """The bf16 dtype policy (bf16 GEMMs and stream, fp32 FSQ and heads):
    no farther from the fp32 JAX output than 1.25x the JAX module's own bf16
    output evaluated op by op (or 2e-2 of the scale, if larger). The port
    rounds to bf16 after each op as the module is written, as op-by-op JAX
    does; the jitted JAX program keeps excess precision between ops (XLA's
    allow_excess_precision) and lands nearer fp32. The three distances are
    printed."""
    _, params, apply = _jax_model(name)
    jm = jmodels.make({"name": name, "args": dict(dict(CASES)[name], dtype=jnp.bfloat16)})
    x = _clips(seed=4)
    want = apply(params, jnp.asarray(x))
    ref_err = _rel(jm.apply({"params": params}, jnp.asarray(x))["pred_frames"], want["pred_frames"])
    jit_err = _rel(jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))[
        "pred_frames"], want["pred_frames"])
    with torch.no_grad():
        got = _port_model(name, torch.bfloat16)(torch.from_numpy(x))
    assert got["pred_frames"].dtype == torch.float32 and got["encoded"].dtype == torch.float32
    port_err = _rel(got["pred_frames"], want["pred_frames"])
    print(f"{name} bf16 from fp32 JAX, of the scale: jitted JAX {jit_err:.3g}, op-by-op JAX "
          f"{ref_err:.3g}, port {port_err:.3g}")
    assert port_err <= max(2e-2, 1.25 * ref_err)


@pytest.mark.parametrize("name", ["autoencoder_large", "autoencoder_first_token_f256t512"])
def test_decode_from_bottleneck_matches_jax(name):
    """decode_from_bottleneck(indices[, first_indices]) against JAX and against
    the forward's own decode; a conditioned model refuses no first indices."""
    m, params, apply = _jax_model(name)
    x = _clips(seed=5)
    out = apply(params, jnp.asarray(x))
    idx = [np.array(out[k]) for k in ("bottleneck_rep", "first_rep") if k in out]
    want = jax.jit(lambda p, *i: m.apply({"params": p}, *i, method=m.decode_from_bottleneck))(
        params, *map(jnp.asarray, idx))
    model = _port_model(name)
    with torch.no_grad():
        got = model.decode_from_bottleneck(*map(torch.from_numpy, idx))
        fwd = model(torch.from_numpy(x))["pred_frames"]
        assert _rel(got, want) <= 1e-5
        np.testing.assert_array_equal(f32(got), f32(fwd))
        assert model.decode_indices == model.decode_from_bottleneck
        if len(idx) == 2:
            with pytest.raises(ValueError, match="first_indices"):
                model.decode_from_bottleneck(torch.from_numpy(idx[0]))


def test_state_dict_from_jax_covers_every_parameter():
    """Every Flax leaf lands on one port parameter of the same size, and the
    state dict holds parameters only (the tables and FSQ constants are
    non-persistent buffers)."""
    for name in ("autoencoder_convpatchify_simplytransformer", "autoencoder_first_token_f256t768",
                 "autoencoder_convpatchify_mask2"):
        _, params, _ = _jax_model(name)
        model = _port_model(name)
        sd = model_new_state_dict_from_jax(params, model)
        assert set(sd) == {n for n, _ in model.named_parameters()} == set(model.state_dict())
        assert sum(v.numel() for v in sd.values()) == sum(
            np.size(leaf) for leaf in jax.tree_util.tree_leaves(params))
    with pytest.raises(ValueError, match="differ"):
        model_new_state_dict_from_jax({"encoder": params["encoder"]}, model)


def test_all_ten_names_register():
    names = {"autoencoder_convpatchify", "autoencoder_convpatchify_greatfsq", "autoencoder_mask3",
             "autoencoder_convpatchify_mask2", "autoencoder_convpatchify_mask2_greatfsq",
             "autoencoder_convpatchify_simplytransformer", "autoencoder_large",
             "autoencoder_first_token_f256t1024a", "autoencoder_first_token_f256t768",
             "autoencoder_first_token_f256t512"}
    assert names == set(IDS) and all(n in tmodels for n in names)


# ---------------------------------------------------- the shipped configs


@pytest.mark.parametrize("cfg_name", list(SHIPPED))
def test_shipped_config_builds_at_its_parameter_count(cfg_name):
    """Each config builds from its yaml (on the meta device: full width, no
    memory): the registered name, patch (4, 8, 8) from the int `patch_size: 8`
    and `temporal_patch_size: 4`, FSQ-64000, and the LARP keys the factory
    drops (width 768, depth 12, VQ-8192 are not this model's)."""
    name, n_params = SHIPPED[cfg_name]
    m = _shipped(cfg_name)
    assert isinstance(m, tmn.RoPEAutoEncoder) and m.patch_size == (4, 8, 8)
    assert sum(p.numel() for p in m.parameters()) == n_params
    assert m.codebook_size == 64_000 and m.bottleneck_token_num == m.num_latent_tokens
    if cfg_name == "larp_tokenizer_large":
        assert m.encoder.width == 1024 and m.encoder.blocks.depth == 24
        assert m.encoder.blocks.ffd_0.proj_out.weight.shape == (1024, 2752)


def test_int_patch_size_fault_of_the_reference():
    """The JAX factory passes the yaml's int `patch_size: 8` on, and the model
    raises TypeError when it builds; the port reads it as (4, 8, 8) and then
    equals the JAX model built with the explicit tuple (at the tiny size)."""
    cfg = load_config("cfgs/larp_tokenizer_large.yaml", {"input_size": 32, "frame_num": 8})
    spec = cfg.model.to_dict()
    x = _clips(seed=6, batch=1)
    jm = jmodels.make(spec)
    with pytest.raises(TypeError):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))

    spec["args"].update(model_size="tiny", num_latent_tokens=8)
    jm = jmodels.make({"name": spec["name"], "args": {**spec["args"], "patch_size": (4, 8, 8)}})
    params = numpy_params(jm, jnp.asarray(x))
    tm = tmodels.make(spec, args={"generator": torch.Generator().manual_seed(0)})
    assert tm.patch_size == (4, 8, 8) and spec["args"]["patch_size"] == 8
    tm.load_state_dict(model_new_state_dict_from_jax(params, tm), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert _rel(got["pred_frames"], want["pred_frames"]) <= 1e-5
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    for bad in ((4, 8), [8]):
        with pytest.raises(ValueError, match="patch_size"):
            tmodels.make({"name": "autoencoder_large", "args": {**TINY, "patch_size": bad}})
