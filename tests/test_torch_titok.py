"""The port's TiTok (`models/model_titok.py`) against the JAX package, on the CPU.

A tiny TiTok (`model_size` "tiny": 256 wide, 4 + 4 layers, 4 query heads over
2 KV heads of 64; 8 latent tokens; 8 x 32 x 32 clips in (2, 8, 8) patches, as
tests/test_families.py sizes it) is initialised by the JAX package, every
leaf moved by seeded numpy noise (so that no LayerNorm or bias is trivially 1
or 0), and carried across by `titok_state_dict_from_jax`. Clips are numpy
from a seed. The JAX side runs jitted with its XLA attention; the port's
flash wrapper runs its plain version on CPU tensors (segment ids included).
Held, in fp32:
  * the forward at batch 1 (the packed path, ids all 0) and at batch 3 (the
    batched path): `pred_frames` within 1e-5 of the output's scale, FSQ
    indices equal, `loss_q` 0;
  * `encode_packed` / `decode_packed` on three clips of different grids and
    token counts: codes and indices equal, each clip within 1e-5;
  * `decode_from_bottleneck` of the JAX indices, [B, N] and per-clip list
    forms, within 1e-5;
  * the batched path against the packed one on the port alone: a clip
    encoded in a uniform batch and alone within 2e-5 (the bound
    tests/test_families.py holds the JAX model to);
  * `get_titok_model_dims` for every size, the base size's exact parameter
    count against the JAX init's shapes, `pack_segments`;
  * one fp32 step of the tokenizer trainer against the JAX trainer's, as
    tests/test_torch_model_new_train.py holds model_new: every logged scalar
    1e-4 relative (1e-6 absolute), D gradients 5e-4 and G gradients 2.5e-3 of
    each tensor's max |g| (the pixel loss's sign flips where the two
    reconstructions straddle a pixel; the encoder sees those differences
    through 8 latent codes).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, jax_trainer, train_batch, trainer_cfg
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import model_titok as jmt
from video_tokenizer_tpu.parallel import shard_batch
from video_tokenizer_tpu.registry import models as jmodels
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import TiTok
from video_tokenizer_tpu_torch.models import model_titok as tmt
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import (
    loss_state_dict_from_jax, titok_state_dict_from_jax,
)

TINY = {"model_size": "tiny", "num_latent_tokens": 8, "input_size": 32, "frame_num": 8,
        "patch_size": (2, 8, 8)}
TOL = 1e-5
# three clips that share neither grid nor token count: (C, T, H, W), tokens
HETERO = [((3, 8, 32, 32), 8), ((3, 4, 32, 16), 6), ((3, 8, 16, 16), 4)]


def _perturb(params, seed=3):
    """A numpy copy of a Flax tree, every leaf moved: LayerNorm scales
    1 + 0.1 N(0, 1), biases 0.02 N(0, 1), kernels and mask tokens + 0.02 N."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.randn(*x.shape).astype(np.float32)
        name = path[-1].key
        return 1 + 0.1 * noise if name == "scale" else (
            0.02 * noise if name == "bias" else x + 0.02 * noise)

    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX TiTok, its params, the port's TiTok with them)."""
    jm = jmodels.make({"name": "titok", "args": TINY})
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 32, 32)))["params"]
    params = _perturb(params)
    pm = tmodels.make({"name": "titok",
                       "args": {**TINY, "generator": torch.Generator().manual_seed(0)}})
    pm.load_state_dict(titok_state_dict_from_jax(params, pm), strict=True)
    return jm, params, pm.eval()


def _clips(batch, seed=0, shape=(3, 8, 32, 32)):
    return np.random.RandomState(seed).rand(batch, *shape).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float32)
    err = np.abs(f32(got) - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err} of {np.abs(want).max()}"


@pytest.mark.parametrize("size", ["tiny", "small", "base", "large",
                                  "tiny_thin", "small_thin", "base_thin", "large_thin"])
def test_model_dims_match_jax(size):
    assert tmt.get_titok_model_dims(size) == jmt.get_titok_model_dims(size)


def test_base_parameter_count_matches_the_jax_init():
    """The registered base size (768 wide, 12 + 12 layers, 12 query heads over
    4 KV heads, GEGLU inner 2048, FSQ 8,8,8,5,5,5) at 16 x 128 x 128: the
    port's parameters, built on the meta device, against the JAX init's
    shapes (traced, not run)."""
    jm = jmodels.make({"name": "titok", "args": {}})
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 128, 128)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        pm = tmodels.make({"name": "titok", "args": {}})
    assert sum(p.numel() for p in pm.parameters()) == want == 152_270_598
    assert pm.codebook_size == 64_000 and pm.bottleneck_token_num == 1024
    attn = pm.encoder.blocks.attn_0
    assert (attn.q_heads, attn.kv_heads, attn.head_dim) == (12, 4, 64)
    assert pm.encoder.blocks.ffd_out_0.weight.shape == (768, 2048)


def test_pack_segments_pads_to_the_key_tile_with_id_minus_one():
    parts = [torch.ones(72, 4), 2 * torch.ones(40, 4)]
    x, seg, lens = tmt.pack_segments(parts)
    assert x.shape == (1, 128, 4) and seg.shape == (1, 128) and lens == [72, 40]
    assert seg.dtype == torch.int32
    assert (seg[0, :72] == 0).all() and (seg[0, 72:112] == 1).all() and (seg[0, 112:] == -1).all()
    assert (x[0, 112:] == 0).all() and (x[0, 72:112] == 2).all()
    assert tmt.pack_segments(parts, pad_to=256)[0].shape == (1, 256, 4)


@pytest.mark.parametrize("batch", [1, 3], ids=["packed_b1", "batched_b3"])
def test_forward_matches_jax(batch):
    jm, params, pm = _models()
    x = _clips(batch, seed=batch)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got["pred_frames"].shape == x.shape
    _close(got["pred_frames"], want["pred_frames"], what="pred_frames")
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(),
                                  np.asarray(want["bottleneck_rep"]))
    assert float(got["loss_q"]) == 0.0


def _hetero_clips():
    rng = np.random.RandomState(7)
    return [rng.rand(*shape).astype(np.float32) for shape, _ in HETERO], [n for _, n in HETERO]


def test_packed_heterogeneous_clips_match_jax():
    jm, params, pm = _models()
    xs, counts = _hetero_clips()
    grids = [shape for shape, _ in HETERO]

    def jax_pack(p, xs):
        x_q, idx = jm.apply({"params": p}, xs, counts, method=jm.encode_packed)
        return x_q, idx, jm.apply({"params": p}, x_q, counts, grids, method=jm.decode_packed)

    want_q, want_idx, want_videos = jax.jit(jax_pack)(params, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got_q, got_idx = pm.encode_packed([torch.from_numpy(x) for x in xs], counts)
        got_videos = pm.decode_packed(got_q, counts, grids)
    assert got_q.shape == (sum(counts), 6)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(f32(got_q), np.asarray(want_q))
    for i, (g, w) in enumerate(zip(got_videos, want_videos)):
        assert g.shape == HETERO[i][0]
        _close(g, w, what=f"clip {i}")


@pytest.mark.parametrize("form", ["tensor_b2", "tensor_b1", "list"])
def test_decode_from_bottleneck_matches_jax(form):
    """[B, N] indices at the configured geometry (batched for B = 2, packed
    for B = 1), and the list form with the heterogeneous grids."""
    jm, params, pm = _models()
    rng = np.random.RandomState(11)
    if form == "list":
        idx = [rng.randint(0, 64_000, n).astype(np.int32) for _, n in HETERO]
        grids = [shape for shape, _ in HETERO]
        want = jax.jit(lambda p, i: jm.apply({"params": p}, i, grids,
                                             method=jm.decode_from_bottleneck))(
            params, [jnp.asarray(i) for i in idx])
        with torch.no_grad():
            got = pm.decode_from_bottleneck([torch.from_numpy(i) for i in idx], grids)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == HETERO[i][0]
            _close(g, w, what=f"clip {i}")
        return
    B = 2 if form == "tensor_b2" else 1
    idx = rng.randint(0, 64_000, (B, 8)).astype(np.int32)
    want = jax.jit(lambda p, i: jm.apply({"params": p}, i, method=jm.decode_from_bottleneck))(
        params, jnp.asarray(idx))
    with torch.no_grad():
        got = pm.decode_from_bottleneck(torch.from_numpy(idx))
    assert got.shape == (B, 3, 8, 32, 32)
    _close(got, want, what="videos")


def test_batched_path_equals_the_packed_path():
    """The same clip through the batched path (a uniform batch of three) and
    packed alone: latents within 2e-5, reconstructions within 1e-5 of scale."""
    _, _, pm = _models()
    x = torch.from_numpy(_clips(3, seed=5))
    with torch.no_grad():
        enc_b = pm.encode_packed(list(x.unbind(0)), [8] * 3)
        enc_1 = pm.encode_packed([x[0]], [8])
        np.testing.assert_allclose(f32(enc_b[0][:8]), f32(enc_1[0]), atol=2e-5)
        _close(pm(x[:1])["pred_frames"][0], f32(pm(x)["pred_frames"][0]), what="pred")


def test_factory_drops_unknown_keys():
    m = tmodels.make({"name": "titok", "args": {**TINY, "bottleneck_token_num": 3,
                                                "generator": torch.Generator().manual_seed(1)}})
    assert isinstance(m, TiTok) and m.bottleneck_token_num == 8 and m.codebook_size == 64_000


def _port_trainer(cfg, jax_tr):
    """The port's tokenizer trainer on the CPU at epoch 1 with the JAX
    trainer's TiTok weights, discriminator, LeCam EMAs and EMA parameters."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    tr = trainers.make({"name": "larp_tokenizer_trainer"}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    host = jax.device_get(jax_tr.state)
    tr.model.load_state_dict(titok_state_dict_from_jax(host["params"], tr.model), strict=True)
    tr.loss_mod.load_state_dict(
        loss_state_dict_from_jax(host["loss_params"], host["loss_ema"], tr.loss_mod), strict=True)
    tr.ema_params = {d: {n: p.detach().clone() for n, p in tr.model.named_parameters()}
                     for d in tr.ema_params}
    return tr


def test_trainer_step_matches_jax(tmp_path):
    model = {"name": "titok", "args": dict(TINY)}
    jtr = jax_trainer(trainer_cfg(tmp_path / "jax", model=model), capture_grads=True)
    lr0 = {"name": "adam", "args": {"lr": 0.0, "betas": [0.5, 0.9]},
           "loss_args": {"lr": 0.0, "betas": [0.5, 0.9]}, "lr_type": "step"}
    ptr = _port_trainer(trainer_cfg(tmp_path / "port", model=model, optimizer=lr0), jtr)
    assert isinstance(ptr.model, TiTok) and ptr.model.codebook_size == 64_000
    batch = train_batch()
    keys, packed = jtr.train_step(shard_batch(jtr.mesh, batch))
    want_info = dict(zip(keys, np.asarray(packed).tolist()))
    keys, packed = ptr.train_step({"gt": torch.from_numpy(batch["gt"])})
    got_info = dict(zip(keys, packed.tolist()))
    assert set(got_info) == set(want_info), set(got_info) ^ set(want_info)
    assert {"index_usage", "perplexity", "kl_uni", "loss_q"} <= set(got_info)
    for k, v in want_info.items():
        np.testing.assert_allclose(got_info[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert got_info["loss_q"] == 0.0 and want_info["d_loss"] > 0

    state = jax.device_get(jtr.state)
    g_want = titok_state_dict_from_jax(state["opt_g"]["g"], ptr.model)
    for name, p in ptr.model.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, g_want[name].numpy(), 2.5e-3, name)
    d_tree = state["opt_d"].inner_states["train"].inner_state["g"]["discriminator"]
    d_want = loss_state_dict_from_jax(
        {"discriminator": d_tree, "perceptual": state["loss_params"]["perceptual"]},
        state["loss_ema"], ptr.loss_mod)
    for name, p in ptr.loss_mod.named_parameters():
        if name.startswith("discriminator."):
            _close(p.grad, d_want[name].numpy(), 5e-4, name)
