"""The port's `dino_disc` (`models/discriminators.py`) against the JAX package, on the CPU.

At the registered width (DINO-S: 384 wide, 12 blocks of 6 heads of 64, five
conv1d heads with k = 9) on 32 x 32 frames (2 x 2 patches + the class
token: L = 5), fp32. The parameters are numpy draws on the shapes of the
JAX init (kernels N(0, 1 / fan_in), biases 0.02 N(0, 1), scales 1 + 0.1
N(0, 1)), the `spectral` collection's `u` the JAX init's own, carried by
`dino_disc_state_dict_from_jax`. Held:
  * a fresh port module's `u` equals `jax.random.normal(PRNGKey(0), (C,))`
    within 3 fp32 ulp (`utils/jax_random.py`);
  * the logits [B, 5 L] within 1e-5 of their scale, and the input gradient
    of a fixed weighting of them against `jax.grad` within 1e-4 of its
    scale (the input stays differentiable through the frozen DINO, whose
    parameters take no gradient in the port);
  * one call with `update_stats`: every head's `u` within 1e-5 of the JAX
    module's new `spectral` collection, and a call without it leaves `u`
    as it is; sigma's gradient through the kernel (a head's kernel gradient
    against `jax.grad`);
  * `load_dino_weights` on a synthetic `.npz` whose `pos_embed` is a 14 x 14
    grid (+ the class row), resized to the 2 x 2 grid by the antialiased
    bilinear resize: the loaded parameters and the logits after equal the
    JAX function's within 1e-5; the heads untouched;
  * `pos_embed` sized by `img_size`, the full count at 256 x 256.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import discriminators as jd
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import discriminators as td
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import (
    dino_disc_state_dict_from_jax, flax_tree_state_dict,
)

FRAMES = (4, 3, 32, 32)
TOL = 1e-5


def _draw(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        noise = rng.randn(*shape).astype(np.float32)
        if name in ("scale", "x_scale"):
            return 1 + 0.1 * noise
        if name in ("bias", "x_shift"):
            return 0.02 * noise
        return noise / np.float32(math.sqrt(max(np.prod(shape[:-1]), 1)))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def pair():
    """(JAX module, its variables, the port's module with them loaded)."""
    jm = jd.DinoDisc()
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *FRAMES[1:])))
    variables = {"params": jax.tree_util.tree_map(np.asarray, _draw(init["params"], 1)),
                 "spectral": jax.tree_util.tree_map(np.asarray, init["spectral"])}
    tm = tmodels.make({"name": "dino_disc", "args": {"img_size": 32}})
    fresh_u = {n: b.clone() for n, b in tm.named_buffers()}
    tm.load_state_dict(dino_disc_state_dict_from_jax(variables, tm), strict=True)
    return jm, variables, tm, fresh_u


def _frames(seed):
    return (np.random.RandomState(seed).rand(*FRAMES) * 2 - 1).astype(np.float32)


def test_fresh_u_is_jax_normal(pair):
    _, variables, _, fresh_u = pair
    assert len(fresh_u) == 15  # 5 heads x (conv1, conv2, proj)
    for i in range(5):
        for conv in ("conv1", "conv2", "proj"):
            want = variables["spectral"][f"head_{i}"][conv]["u"]
            got = fresh_u[f"head_{i}.{conv}.u"].numpy()
            assert got.shape == want.shape == ((1,) if conv == "proj" else (384,))
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.all(np.abs(got - want) <= 3 * ulp), (i, conv)


def test_logits_and_input_gradient_match_jax(pair):
    jm, variables, tm, _ = pair
    x = _frames(2)
    w = np.random.RandomState(3).randn(4, 25).astype(np.float32)
    logits = jax.jit(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x))
    g_want = jax.jit(jax.grad(lambda x: jnp.sum(jm.apply(variables, x) * w)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tm(xt)
    assert tuple(got.shape) == (4, 5 * 5) and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), logits) <= TOL
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(xt.grad.numpy(), g_want) <= 1e-4
    assert all(p.grad is None for p in tm.dino.parameters())
    assert not any(p.requires_grad for p in tm.dino.parameters())


def test_update_stats_and_sigma_gradient_match_jax(pair):
    jm, variables, tm, _ = pair
    x = _frames(4)
    before = {n: b.clone() for n, b in tm.named_buffers()}
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert all(torch.equal(b, before[n]) for n, b in tm.named_buffers())
    (logits, new) = jax.jit(lambda v, x: jm.apply(v, x, update_stats=True, mutable=["spectral"]))(
        variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x), update_stats=True)
    assert _rel(got.detach().numpy(), logits) <= TOL
    want = flax_tree_state_dict(jax.tree_util.tree_map(np.asarray, new["spectral"]))
    bufs = dict(tm.named_buffers())
    assert set(want) == set(bufs)
    for n, u in want.items():
        assert not torch.equal(bufs[n], before[n]), n
        assert _rel(bufs[n].numpy(), u.numpy()) <= TOL, n
    tm.load_state_dict({**tm.state_dict(), **before})  # the fixture's u for the other tests

    def loss(p):
        return jnp.sum(jm.apply({**variables, "params": p}, jnp.asarray(x)) ** 2)

    g = jax.jit(jax.grad(loss))(variables["params"])
    tm.zero_grad()
    (tm(torch.from_numpy(x)) ** 2).sum().backward()
    for i in (0, 4):
        for conv in ("conv1", "conv2", "proj"):
            want_g = np.asarray(g[f"head_{i}"][conv]["kernel"]).transpose(2, 1, 0)
            got_g = getattr(getattr(tm, f"head_{i}"), conv).weight.grad.numpy()
            assert _rel(got_g, want_g) <= 1e-4, (i, conv)


def test_load_dino_weights(pair, tmp_path):
    jm, variables, tm, _ = pair
    # a DINO-S tree at 224 x 224: pos_embed 1 + 14 x 14 rows
    big = jax.eval_shape(jd.FrozenDINOSmall().init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 3, 224, 224)))["params"]
    dino = jax.tree_util.tree_map(np.asarray, _draw(big, 7))
    assert dino["pos_embed"].shape == (1, 197, 384)
    path = tmp_path / "dino.npz"
    np.savez(path, params=np.array(dino, dtype=object))
    heads = {n: p.detach().clone() for n, p in tm.named_parameters() if n.startswith("head_")}
    assert td.load_dino_weights(tm, str(path)) is tm
    want = jd.load_dino_weights(variables, str(path))
    want_sd = flax_tree_state_dict(jax.tree_util.tree_map(np.asarray, want["params"]["dino"]))
    for n, p in tm.dino.named_parameters():
        assert tuple(p.shape) == tuple(want_sd[n].shape)
        assert _rel(p.detach().numpy(), want_sd[n].numpy()) <= TOL, n
    assert tm.dino.pos_embed.shape == (1, 5, 384)
    for n, p in tm.named_parameters():
        if n.startswith("head_"):
            assert torch.equal(p, heads[n]), n
    x = _frames(5)
    logits = jax.jit(lambda v, x: jm.apply(v, x))(want, jnp.asarray(x))
    with torch.no_grad():
        assert _rel(tm(torch.from_numpy(x)).numpy(), logits) <= TOL


def test_pos_embed_follows_img_size():
    with torch.device("meta"):
        full = tmodels.make({"name": "dino_disc", "args": {}})
        m = td.DinoDisc(img_size=128)
    assert full.dino.pos_embed.shape == (1, 257, 384)
    assert m.dino.pos_embed.shape == (1, 65, 384)
    assert sum(p.numel() for p in full.parameters()) == 29_074_187  # the JAX init's at 256
    assert sum(p.numel() for p in full.dino.parameters()) == 21_687_942
    with pytest.raises(ValueError, match="img_size"):
        td.DinoDisc(img_size=32, depth=1)(torch.zeros(1, 3, 64, 64))
