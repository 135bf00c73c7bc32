"""The port's basic / dual-patch family (`models/model_basic.py`) against the JAX package, on the CPU.

Weights are drawn with numpy on the shapes of the JAX init (`numpy_params`,
as tests/test_torch_model_new.py draws them) and reach the port through
`model_new_state_dict_from_jax`; clips are numpy from a seed. The JAX side
runs jitted with its XLA attention; the port's flash wrapper runs its plain
version on CPU tensors. Each of the five registrations at the sizes of
tests/test_families.py, in fp32: `pred_frames` within 1e-5 of the output's
scale, FSQ indices (and the first frame's) equal; `decode_from_bottleneck`
of the JAX indices within 1e-5, including the first-frame path and its
ValueError without `first_indices`. The rotation the JAX stack applies with
its identity table (cos 1, sin 0) is exact, so the port's stack, which
skips it, gives the same values: held block by block at 1e-6. Also: the
full-width parameter counts equal the JAX init's shapes, and unknown
overrides are dropped as the JAX factory drops them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import model_basic as jmb
from video_tokenizer_tpu.registry import models as jmodels
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import model_basic as tmb
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import model_new_state_dict_from_jax

TINY = {"model_size": "tiny", "num_latent_tokens": 8, "input_size": 32, "frame_num": 16}
FIRST = {**TINY, "first_frame_tokens": 4}
CASES = [
    ("autoencoder", TINY),
    ("autoencoder_dualpatch", TINY),
    ("autoencoder_first_token", FIRST),
    ("autoencoder_first_token_res", FIRST),
    ("autoencoder_design", FIRST),
]
IDS = [c[0] for c in CASES]
FULL = {  # name -> (arch, FSQ levels) at the default width, small_thin
    "autoencoder": ("uniform", 5), "autoencoder_dualpatch": ("dualpatch", 6),
    "autoencoder_first_token": ("first_token", 5),
    "autoencoder_first_token_res": ("first_token", 5), "autoencoder_design": ("first_token", 6),
}


def numpy_params(module, *inputs, seed=0):
    """Seeded weights on the shapes of `module`'s Flax init (traced, not
    compiled): LayerNorm scales 1 + 0.1 N(0, 1), biases 0.02 N(0, 1),
    kernels, PEs and query tokens 0.03 N(0, 1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.randn(*s.shape).astype(np.float32)
        return 1 + 0.1 * x if name == "scale" else (0.02 if name == "bias" else 0.03) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _clips(seed=0, batch=2, frames=16, size=32):
    return np.random.RandomState(seed).rand(batch, 3, frames, size, size).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(f32(got) - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    m = jmodels.make({"name": name, "args": dict(CASES)[name]})
    params = numpy_params(m, jnp.asarray(_clips(batch=1)))
    return m, params, jax.jit(lambda p, x: m.apply({"params": p}, x))


def _port_model(name):
    _, params, _ = _jax_model(name)
    m = tmodels.make({"name": name, "args": dict(CASES)[name]},
                     args={"generator": torch.Generator().manual_seed(0)})
    m.load_state_dict(model_new_state_dict_from_jax(params, m), strict=True)
    return m.eval()


@pytest.mark.parametrize("name", IDS)
def test_forward_matches_jax(name):
    m, params, apply = _jax_model(name)
    x = _clips(1)
    want = apply(params, jnp.asarray(x))
    port = _port_model(name)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert _rel(got["pred_frames"], want["pred_frames"]) <= 1e-5
    for k in ("bottleneck_rep", "first_rep"):
        assert (k in got) == (k in want) == (k == "bottleneck_rep" or "first" in name
                                             or name == "autoencoder_design")
        if k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(f32(got["encoded"]), np.asarray(want["encoded"]))
    assert port.bottleneck_token_num == m.bottleneck_token_num == 8
    assert port.codebook_size == m.codebook_size


@pytest.mark.parametrize("name", IDS)
def test_decode_from_bottleneck_matches_jax(name):
    m, params, apply = _jax_model(name)
    want_out = apply(params, jnp.asarray(_clips(2)))
    idx = np.asarray(want_out["bottleneck_rep"])
    first = want_out.get("first_rep")
    args = (jnp.asarray(idx),) + ((jnp.asarray(first),) if first is not None else ())
    want = m.apply({"params": params}, *args, method=m.decode_from_bottleneck)
    port = _port_model(name)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    with torch.no_grad():
        got = port.decode_from_bottleneck(*targs)
    assert _rel(got, want) <= 1e-5
    if first is not None:  # a plain class-conditional prior cannot drive it
        with pytest.raises(ValueError, match="first-frame indices"):
            m.apply({"params": params}, jnp.asarray(idx), method=m.decode_from_bottleneck)
        with pytest.raises(ValueError, match="first-frame indices"):
            port.decode_from_bottleneck(targs[0])


def test_blocks_without_rotation_match_the_identity_table():
    """The JAX `NoRoPEStack` (identity cos / sin through `apply_rotary`) and
    the port's (rotation skipped) on the same inputs and weights."""
    stack = jmb.NoRoPEStack(dim=128, depth=2, heads=2, mlp_ratio=2.0)
    x = np.random.RandomState(3).randn(2, 24, 128).astype(np.float32)
    params = numpy_params(stack, jnp.asarray(x))
    want = stack.apply({"params": params}, jnp.asarray(x))
    port = tmb.NoRoPEStack(128, 2, 2, 2.0)
    from video_tokenizer_tpu_torch.utils.convert import model_new_state_dict_from_jax

    port.load_state_dict(model_new_state_dict_from_jax(params, port), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("name", IDS)
def test_full_width_parameter_counts_equal_jax(name):
    m = jmodels.make({"name": name, "args": {}})
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 128, 128)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        port = tmodels.make({"name": name})
    arch, n_levels = FULL[name]
    assert port.arch == arch and len(port.quantize.levels) == n_levels
    assert sum(p.numel() for p in port.parameters()) == want
    assert port.encoder.stack.blocks.depth == 5 and port.encoder.stack.blocks.heads == 12


def test_unknown_overrides_are_dropped():
    """The registrations take the trainers' extra keys (a LARP config's
    `bottleneck`, `temporal_patch_size`, ...) and ignore them, as JAX does."""
    extra = {"temporal_patch_size": 4, "bottleneck_type": "vq", "encoder_depth": 12}
    for name, args in CASES:
        port = tmodels.make({"name": name, "args": {**args, **extra}},
                            args={"dtype": torch.bfloat16,
                                  "generator": torch.Generator().manual_seed(0)})
        jax_m = jmodels.make({"name": name, "args": {**args, **extra}})
        assert port.num_latent_tokens == jax_m.num_latent_tokens == 8
    with pytest.raises(ValueError, match="arch"):
        tmb.BasicAutoEncoder(arch="cnn")
