"""The LARP tokenizer's fsq and sq bottlenecks and the Leech-lattice search, on the CPU.

Held against the JAX package:
  * `leech_lattice_codebook`: equal bit for bit (numpy on both sides);
  * `LatticeVectorQuantizer` on the full 196,560-code Leech codebook at
    M = 32 and on a 512-code sphere: indices equal, the loss and the
    codebook entropy within 1e-5, the straight-through output within 1e-6,
    the gradient of a fixed weighting within 1e-5;
  * `vq_argmax_tf32x3_tiled_reference` (the d = 24 arithmetic of
    `vq_tc_kernel` with its 512-code tiles) against `vq_lookup_reference`
    and JAX's `vq_lookup_pallas` in interpret mode: indices equal, or
    different only where the two top scores are within 1e-5 in fp64 (the
    card's gate); planted ties resolve to the lowest index; the tile
    geometry divides as the kernel's static_asserts require;
  * tiny LARP tokenizers with the fsq, sq and ablation bottlenecks (the
    JAX init, perturbed, through `state_dict_from_jax`): forward, indices,
    loss_q and the codebook entropy (1e-5 of the output's scale, indices
    equal), `encode_eval` / `decode_eval`, `decode_from_bottleneck`, and the
    gradients of a fixed weighting (1e-4 of each tensor's max |g|);
  * the full-width parameter counts of both (JAX `init`);
  * the reference's fault that the port does not copy: the JAX trainer's
    step moves the "frozen" Leech codebook, the port's leaves it unchanged
    and out of the optimizer.
"""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, jax_tokenizer, port_tokenizer, trainer_cfg

import video_tokenizer_tpu.models  # noqa: F401
import video_tokenizer_tpu.ops.attention  # noqa: F401
import video_tokenizer_tpu.ops.vq  # noqa: F401
from video_tokenizer_tpu.models import fsq as jfsq
from video_tokenizer_tpu.registry import models as jmodels
from video_tokenizer_tpu_torch.config import load_config
from video_tokenizer_tpu_torch.models import fsq as tfsq
from video_tokenizer_tpu_torch.ops.vq import (
    _VQ_CLUSTER, vq_argmax_tf32x3_tiled_reference, vq_kernel, vq_lookup_reference,
    vq_tile_codes,
)
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import state_dict_from_jax

_ATT = sys.modules["video_tokenizer_tpu.ops.attention"]
_VQ = sys.modules["video_tokenizer_tpu.ops.vq"]
GAP = 1e-5  # chip_smoke.py's gate: indices differ only at a smaller fp64 score gap
LEECH = 196_560


@pytest.fixture
def interpret_mode():
    _ATT._INTERPRET = True
    try:
        yield
    finally:
        _ATT._INTERPRET = False


@functools.lru_cache(maxsize=None)
def _codebook(n_embed):
    return tfsq.leech_lattice_codebook(n_embed, 24)


def _unit(rng, *shape):
    z = rng.randn(*shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _gap(z, emb, a, b):
    s = z.astype(np.float64) @ emb.astype(np.float64).T
    rows = np.arange(len(z))
    return np.abs(s[rows, a] - s[rows, b])


def _assert_close_indices(got, want, z, emb):
    got, want = np.asarray(got), np.asarray(want)
    differ = got != want
    assert _gap(z, emb, got, want)[differ].max(initial=0.0) < GAP


# ----------------------------------------------------------- the codebook


@pytest.mark.parametrize("n_embed", [LEECH, 512])
def test_codebook_equals_jax(n_embed):
    got = _codebook(n_embed)
    np.testing.assert_array_equal(got, jfsq.leech_lattice_codebook(n_embed, 24))
    assert got.shape == (n_embed, 24) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    if n_embed == LEECH:  # the minimal vectors: norm^2 32, and each one's negative is there
        from video_tokenizer_tpu_torch.utils.leech import leech_minimal_vectors

        v = leech_minimal_vectors().astype(np.int64)
        assert ((v**2).sum(1) == 32).all() and len({tuple(r) for r in v}) == LEECH
        assert {tuple(r) for r in -v[:500]} <= {tuple(r) for r in v}


# ------------------------------------------------------------ the quantizer


@pytest.mark.parametrize("n_embed", [LEECH, 512], ids=["leech", "sphere512"])
def test_lattice_quantizer_matches_jax(n_embed):
    """M = 32 vectors of dim 24: indices, the dim-summed loss, the entropy
    of the index counts, the straight-through output and its gradient."""
    rng = np.random.RandomState(n_embed % 1000)
    z = rng.randn(2, 16, 24).astype(np.float32)
    w = rng.randn(2, 16, 24).astype(np.float32)
    jq = jfsq.LatticeVectorQuantizer(n_embed=n_embed, embed_dim=24)
    variables = {"params": {"embedding": jnp.asarray(_codebook(n_embed))}}

    def jfn(z):
        out = jq.apply(variables, z)
        return jnp.sum(out["output"] * w) + out["loss_codebook"], out

    (_, want), want_g = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(z))
    tq = tfsq.LatticeVectorQuantizer(n_embed, 24)
    assert not tq.embedding.requires_grad  # frozen: no optimizer takes it
    zt = torch.from_numpy(z).requires_grad_()
    got = tq(zt)
    (torch.sum(got["output"] * torch.from_numpy(w)) + got["loss_codebook"]).backward()
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    assert got["bottleneck_rep"].dtype == torch.int32
    for k in ("loss_codebook", "codebook_entropy"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(f32(got["output"]), f32(want["output"]), atol=1e-6)
    np.testing.assert_allclose(f32(zt.grad), f32(want_g), atol=1e-5)
    np.testing.assert_allclose(  # the codes, normalised by each side's norm
        f32(tq.decode(got["bottleneck_rep"])),
        f32(jq.apply(variables, jnp.asarray(want["bottleneck_rep"]), method=jq.decode)), atol=1e-6)


def test_unfrozen_codebook_is_a_trained_parameter():
    tq = tfsq.LatticeVectorQuantizer(64, 24, use_predefined_codebook=False,
                                     freeze_codebook=False,
                                     generator=torch.Generator().manual_seed(0))
    assert tq.embedding.requires_grad and tq.embedding.abs().max() <= 1 / 64
    tq(torch.randn(5, 24))["loss_codebook"].backward()
    assert tq.embedding.grad.abs().sum() > 0


# --------------------------------------------------- the search at d = 24


def test_tile_geometry_divides():
    """`vq_tc_kernel`'s tiles: whole pairs of 16-code n-tiles, whole shares of
    256 threads, whole batches of 8 fragment loads, and two blocks an SM
    (the static_asserts of its `Geometry`; 341 codes at d = 24 would not)."""
    for d in (4, 8, 16, 24, 32):
        tc, steps = vq_tile_codes(d), max(1, d // 8)
        frag = tc * 64 * steps
        assert tc % 16 == 0 and tc % 256 == 0 and frag % (16 * 256 * 8) == 0, d
        assert 2 * (frag + 4 * tc + 128 * 8 * 2) <= 227 * 1024, d
    assert vq_tile_codes(24) == 512 and 64 * 1024 // (64 * 3) == 341
    for stochastic in (False, True):
        assert vq_kernel(24, stochastic) == "vq_tc_kernel"
    with pytest.raises(ValueError):
        vq_tile_codes(12)


@pytest.mark.parametrize("n_splits", [1, _VQ_CLUSTER])
def test_tiled_search_on_the_leech_codebook_matches_plain(n_splits):
    """M = 32 unit vectors against all 196,560 codes, cos."""
    z = _unit(np.random.RandomState(3), 32, 24)
    emb = _codebook(LEECH)
    got = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb),
                                           n_splits=n_splits)
    want = vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb))
    _assert_close_indices(got.numpy(), want.numpy(), z, emb)


@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_tiled_search_at_d24_matches_jax(metric, interpret_mode):
    """2,100 Leech codes (a ragged K: not a multiple of 16 nor of the
    splits) and 64 rows, against the JAX Pallas kernel in interpret mode."""
    rng = np.random.RandomState(5)
    z = _unit(rng, 64, 24)
    emb = _codebook(LEECH)[rng.permutation(LEECH)[:2100]]
    bias = None
    if metric == "l2":
        z, emb = 0.5 * z, emb * rng.rand(2100, 1).astype(np.float32)
        bias = -0.5 * np.sum(emb**2, axis=-1)
    bias_t = torch.from_numpy(bias) if bias is not None else None
    got = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t)
    want = _VQ.vq_lookup_pallas(jnp.asarray(z), jnp.asarray(emb),
                                jnp.asarray(bias) if bias is not None else None)
    plain = vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb), bias_t)
    s = z.astype(np.float64) @ emb.astype(np.float64).T + (0 if bias is None else bias)
    rows = np.arange(64)
    for other in (np.asarray(want), plain.numpy()):
        differ = got.numpy() != other
        assert np.abs(s[rows, got.numpy()] - s[rows, other])[differ].max(initial=0.0) < GAP


@pytest.mark.parametrize("n_splits", [1, 2, _VQ_CLUSTER])
def test_planted_ties_at_d24_take_the_lowest_index(n_splits):
    """Duplicates of a Leech code within a thread's four, in other tiles of a
    split (512 codes a tile) and in other splits of the codebook: a row equal
    to the code scores every copy the same, and the lowest index wins."""
    emb = _codebook(LEECH)[:8192].copy()
    plants = {100: (101, 103, 130, 700, 3000, 8191), 2000: (2513, 7000), 40: (45,)}
    for lo, dups in plants.items():
        emb[list(dups)] = emb[lo]
    z = emb[list(plants)]
    got = vq_argmax_tf32x3_tiled_reference(torch.from_numpy(z), torch.from_numpy(emb),
                                           n_splits=n_splits)
    assert got.tolist() == list(plants)
    assert vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(emb)).tolist() == list(plants)


# ------------------------------------------------ tiny LARP fsq / sq tokenizers


BOTTLENECKS = {
    "fsq": dict(bottleneck_type="fsq"),
    "sq": dict(bottleneck_type="sq", sq_n_embed=512),
    "ablation": dict(bottleneck_type="fsq", fsq_norm_after_proj=True),
}


@functools.lru_cache(maxsize=None)
def _pair(kind):
    jm, params = jax_tokenizer(**BOTTLENECKS[kind])
    return jm, params, port_tokenizer(params, **BOTTLENECKS[kind])


def _clips(seed=0, batch=2, frames=8):
    return np.random.RandomState(seed).rand(batch, 3, frames, 32, 32).astype(np.float32)


def _rel(got, want):
    want = f32(want)
    return np.abs(f32(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind", list(BOTTLENECKS))
def test_tokenizer_forward_matches_jax(kind):
    jm, params, tm = _pair(kind)
    x = _clips()
    for train in (False, True):
        want = jm.apply({"params": params}, jnp.asarray(x), train=train)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=train)
        assert set(got) == set(want), set(got) ^ set(want)
        np.testing.assert_array_equal(got["bottleneck_rep"].numpy(),
                                      np.asarray(want["bottleneck_rep"]))
        assert _rel(got["pred_frames"], want["pred_frames"]) < 1e-5
        assert _rel(got["encoded"], want["encoded"]) < 1e-5
        for k in ("loss_q", "codebook_entropy"):
            if k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7)
    assert tm.codebook_size == jm.codebook_size == (512 if kind == "sq" else 64_000)


@pytest.mark.parametrize("kind", list(BOTTLENECKS))
def test_tokenizer_eval_paths_match_jax(kind):
    """encode_eval / decode_eval on 4 of the 8 frames (PE truncation), and
    decode_from_bottleneck of the forward's indices."""
    jm, params, tm = _pair(kind)
    x = _clips(1, frames=4)
    enc = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode_eval)
    rec = jm.apply({"params": params}, enc["encoded"], enc["num_x_tokens"], method=jm.decode_eval)
    with torch.no_grad():
        tenc = tm.encode_eval(torch.from_numpy(x))
        trec = tm.decode_eval(tenc["encoded"], tenc["num_x_tokens"])
    assert tenc["num_x_tokens"] == enc["num_x_tokens"] == 16
    np.testing.assert_array_equal(tenc["bottleneck_rep"].numpy(), np.asarray(enc["bottleneck_rep"]))
    assert _rel(trec, rec) < 1e-5
    idx = np.array(enc["bottleneck_rep"])
    want = jm.apply({"params": params}, jnp.asarray(idx), method=jm.decode_from_bottleneck)
    with torch.no_grad():
        got = tm.decode_from_bottleneck(torch.from_numpy(idx))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kind", list(BOTTLENECKS))
def test_tokenizer_gradients_match_jax(kind):
    """Every trained parameter's gradient of sum(pred_frames * w) + loss_q
    (training mode) against JAX's autodiff, 1e-4 of each tensor's max |g|.
    The sq codebook is frozen in the port (no gradient); JAX differentiates
    it, and its trainer then moves it (`test_jax_step_moves_the_frozen_codebook`)."""
    jm, params, tm = _pair(kind)
    x = _clips(2)
    w = np.random.RandomState(7).randn(*x.shape).astype(np.float32)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(out["pred_frames"] * w) + out["loss_q"]

    grads = jax.device_get(jax.grad(jloss)(params))
    want = state_dict_from_jax(grads, tm)
    tm.zero_grad(set_to_none=True)
    out = tm(torch.from_numpy(x), train=True)
    (torch.sum(out["pred_frames"] * torch.from_numpy(w)) + out["loss_q"]).backward()
    checked = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert name == "sq_quantizer.embedding" and p.grad is None
            assert np.abs(want[name].numpy()).max() > 0  # JAX's is not zero
            continue
        scale = np.abs(want[name].numpy()).max()
        assert np.abs(f32(p.grad) - want[name].numpy()).max() <= 1e-4 * scale + 1e-12, name
        checked += 1
    assert checked == sum(p.requires_grad for p in tm.parameters())


def test_ablation_registration_refuses_sq_on_both_sides():
    from _torch_port import TINY_ARGS

    args = {**TINY_ARGS, "bottleneck_type": "fsq"}
    tm = tmodels.make({"name": "larp_tokenizer_ablation", "args": args})
    jm = jmodels.make({"name": "larp_tokenizer_ablation", "args": args})
    assert tm.fsq_norm_after_proj and jm.fsq_norm_after_proj and tm.fsq_norm.dim == 6
    with pytest.raises(ValueError, match="sq"):
        tmodels.make({"name": "larp_tokenizer_ablation", "args": {**args, "bottleneck_type": "sq"}})
    with pytest.raises(AssertionError, match="sq"):
        jmodels.make({"name": "larp_tokenizer_ablation", "args": {**args, "bottleneck_type": "sq"}})


def test_prior_needs_the_vq_bottleneck():
    from _torch_port import TINY_ARGS

    with pytest.raises(ValueError, match="requires bottleneck_type 'vq'"):
        tmodels.make({"name": "larp_tokenizer", "args": {
            **TINY_ARGS, "bottleneck_type": "fsq", "prior_model": {"name": "gptc-S"}}})


@pytest.mark.parametrize("kind,n_params", [("sq", 176_778_648), ("fsq", 172_035_078)])
def test_full_width_parameter_counts_equal_jax_init(kind, n_params):
    """cfgs/larp_tokenizer.yaml with `bottleneck_type` swapped, on the meta
    device; the counts are the JAX init's (the sq one holds the 4,717,440
    codebook entries)."""
    cfg = load_config("cfgs/larp_tokenizer.yaml", {"input_size": 128, "frame_num": 16},
                      ["model.args.bottleneck_type", kind])
    with torch.device("meta"):
        m = tmodels.make(cfg.model.to_dict())
    assert sum(p.numel() for p in m.parameters()) == n_params
    if kind == "sq":
        assert m.sq_quantizer.embedding.numel() == 4_717_440


# -------------------------------------------- the reference's frozen-codebook fault


def _sq_trainer_cfg(save_dir):
    cfg = trainer_cfg(save_dir)
    cfg["model"]["args"].update(bottleneck_type="sq", sq_n_embed=512)
    cfg["loss"]["args"]["perceptual_weight"] = 0.0
    return cfg


def test_jax_step_moves_the_frozen_codebook_and_the_ports_does_not(tmp_path):
    """`LatticeVectorQuantizer.freeze_codebook` (default True) is read by no
    JAX trainer: one JAX step moves the codebook through Adam. The port's
    frozen codebook is in no optimizer group and comes out of a step bit
    for bit unchanged, while the rest of the generator trains."""
    import video_tokenizer_tpu.data  # noqa: F401
    import video_tokenizer_tpu.trainers  # noqa: F401
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from _torch_port import train_batch
    from video_tokenizer_tpu.parallel import shard_batch
    from video_tokenizer_tpu.registry import trainers as jtrainers
    from video_tokenizer_tpu_torch.registry import trainers as ttrainers

    batch = train_batch()
    jtr = jtrainers.make({"name": "larp_tokenizer_trainer"},
                         args={"cfg": _sq_trainer_cfg(tmp_path / "jax")})
    jtr.make_datasets()
    jtr.epoch = 1
    jtr.make_model()
    before = np.array(jax.device_get(jtr.state["params"]["sq_quantizer"]["embedding"]))
    jtr.train_step(shard_batch(jtr.mesh, batch))
    after = np.array(jax.device_get(jtr.state["params"]["sq_quantizer"]["embedding"]))
    assert np.abs(after - before).max() > 1e-6  # the fault: the "frozen" codebook moved

    ttr = ttrainers.make({"name": "larp_tokenizer_trainer"},
                         args={"cfg": _sq_trainer_cfg(tmp_path / "port"), "device": "cpu"})
    ttr.make_datasets()
    ttr.epoch = 1
    ttr.make_model()
    emb = ttr.model.sq_quantizer.embedding
    held = {id(p) for g in ttr.opt_g.param_groups for p in g["params"]}
    assert id(emb) not in held and len(held) == sum(p.requires_grad for p in ttr.model.parameters())
    assert all("sq_quantizer.embedding" not in e for e in ttr.ema_params.values())
    emb_before = emb.detach().clone()
    proj_before = ttr.model.sq_in_linear.weight.detach().clone()
    keys, packed = ttr.train_step({"gt": torch.from_numpy(batch["gt"])})
    info = dict(zip(keys, packed.tolist()))
    assert torch.equal(emb, emb_before)
    assert not torch.equal(ttr.model.sq_in_linear.weight, proj_before)
    assert info["loss_q"] > 0 and np.isfinite(info["codebook_entropy"])


def test_sq_tokenizer_through_the_clis(tmp_path):
    """LARP-sq from cfgs/larp_tokenizer.yaml (`--opts model.args.bottleneck_type
    sq`, tiny) through the reconstruct CLI; an upstream-format `.pth` of it
    through `load_tokenizer_checkpoint` (strict, the codebook included and
    still frozen) and the eval CLI."""
    from _torch_port import TINY_TOKENIZER_OPTS
    from video_tokenizer_tpu_torch.eval import eval_larp_tokenizer as eval_cli
    from video_tokenizer_tpu_torch.reconstruct import main as reconstruct_main
    from video_tokenizer_tpu_torch.utils.model_io import load_tokenizer_checkpoint

    opts = [*TINY_TOKENIZER_OPTS, "model.args.bottleneck_type", "sq",
            "model.args.sq_n_embed", "512"]
    common = ["--device", "cpu", "--dtype", "fp32", "--batch_size", "1", "--num_batches", "1",
              "--input_size", "32", "--frame_num", "8"]
    got = reconstruct_main([*common, "--cfg", "cfgs/larp_tokenizer.yaml", "--opts", *opts])
    assert got["clips"] == 1 and 0.0 < got["mse"] < 1.0

    _, params, tm = _pair("sq")
    from _torch_port import TINY_ARGS

    args = {**TINY_ARGS, **BOTTLENECKS["sq"]}
    torch.save({"model": {"name": "larp_tokenizer", "args": args, "sd": tm.state_dict()}},
               tmp_path / "sq.pth")
    model = load_tokenizer_checkpoint(str(tmp_path / "sq.pth"))
    assert not model.sq_quantizer.embedding.requires_grad
    assert torch.equal(model.sq_quantizer.embedding, tm.sq_quantizer.embedding)
    got = reconstruct_main([*common, "--checkpoint", str(tmp_path / "sq.pth")])
    assert got["clips"] == 1 and np.isfinite(got["psnr"])
    res = eval_cli.main(["--tokenizer", str(tmp_path / "sq.pth"), "--csv_path", "null128",
                         "--frames", "8", "--input_size", "32", "--batch_size", "2",
                         "--max_batches", "1", "--num_workers", "0", "--no_fvd",
                         "--device", "cpu"])
    assert res["num_samples"] == 2 and np.isfinite(res["lpips"]) and np.isfinite(res["psnr"])
