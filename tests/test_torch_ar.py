"""Parity of the port's AR prior and sampler with the JAX package, on the CPU.

The tiny prior of `_torch_port` (2 layers, dim 128, 2 heads of 64, vocab 64,
10 classes, max_seq_len 16, fp32) with perturbed weights (its output head is
zero-initialised, so a fresh model would emit token 0 whatever it computed)
runs through the JAX package and the port on the same numpy inputs. Sampled
draws cannot match (jax.random and torch.Generator differ), so sequences are
compared under greedy decoding and sampling by its distribution.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY_AR, f32, jax_ar, port_ar

from video_tokenizer_tpu.generation import generate as jax_generate
from video_tokenizer_tpu.generation.generate import _combine_cfg as jax_combine_cfg
from video_tokenizer_tpu.generation.generate import sample_from_logits as jax_sample
from video_tokenizer_tpu.generation.generate import top_k_top_p_filtering as jax_filter
from video_tokenizer_tpu.models.larp_ar import LARP_AR as FlaxLARP_AR
from video_tokenizer_tpu.models.larp_ar import ModelArgs as FlaxModelArgs
from video_tokenizer_tpu.models.larp_ar import quantize_params as jax_quantize_params
from video_tokenizer_tpu_torch.generation.generate import (
    NEG_INF, _combine_cfg, generate, sample_from_logits, top_k_top_p_filtering,
)
from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs, quantize_model
from video_tokenizer_tpu_torch.registry import models
from video_tokenizer_tpu_torch.utils.convert import ar_state_dict_from_jax
from video_tokenizer_tpu_torch.utils.model_io import load_ar_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from export_reference_tokenizer import export_larp_ar  # noqa: E402

B, SEQ = 3, 16


@pytest.fixture(scope="module")
def tiny():
    """(Flax model, perturbed params, port model, seq [B, 16], cond [B])."""
    jm, params = jax_ar()
    rng = np.random.RandomState(0)
    seq = rng.randint(0, TINY_AR["vocab_size"], (B, SEQ)).astype(np.int32)
    cond = np.array([1, 4, 9], np.int32)
    return jm, params, port_ar(params), seq, cond


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_forward_logits_and_nll_match_flax(tiny):
    jm, params, tm, seq, cond = tiny
    want, want_loss = jm.apply({"params": params}, jnp.asarray(seq[:, :-1]), jnp.asarray(cond),
                               targets=jnp.asarray(seq))
    with torch.inference_mode():
        got, loss = tm(_t(seq[:, :-1]), _t(cond), targets=_t(seq))
    assert got.shape == (B, SEQ, TINY_AR["vocab_size"])
    # fp32 on both sides through 2 layers: ~1e-6 on logits of scale ~0.5
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    assert np.abs(f32(want)).max() > 0.1  # the perturbed head is not silent


def _jax_steps(jm, params, seq, cond, cache_dtype):
    """JAX prefill + decode_step over the teacher tokens: logits [B, 16, V]."""
    v = {"params": params}
    cache = jm.apply(v, B, SEQ + 1, cache_dtype, method=jm.init_cache)
    logits, cache = jm.apply(v, jnp.asarray(cond), cache, None, method=jm.prefill)
    out = [logits[:, -1]]
    for i in range(1, SEQ):
        logits, cache = jm.apply(v, jnp.asarray(seq[:, i - 1 : i]), jnp.int32(i), cache,
                                 method=jm.decode_step)
        out.append(logits[:, -1])
    return f32(jnp.stack(out, 1))


# (cache dtype, tolerance against teacher forcing, tolerance against the
# JAX steps), as fractions of the logit scale. Against teacher forcing: fp32
# rows are exact up to summation order; bf16 rows carry 2**-9 relative
# rounding, int8 rows 1/254 of each row's amax (measured 2e-3 and 8e-3).
# Against JAX, whose rows are rounded or quantised the same way, only
# summation order differs, and it flips the rounding of a few cache elements
# (measured 1.2e-4 for bf16, 4e-5 for int8).
CACHES = [("float32", 1e-5, 1e-5), ("bfloat16", 1e-2, 1e-3), ("int8", 3e-2, 1e-3)]


@pytest.mark.parametrize("cache_dtype,tol,tol_jax", CACHES, ids=[c[0] for c in CACHES])
def test_incremental_decoding_equals_teacher_forcing(tiny, cache_dtype, tol, tol_jax):
    jm, params, tm, seq, cond = tiny
    with torch.inference_mode():
        want = f32(tm(_t(seq[:, :-1]), _t(cond))[0])
        cache = tm.init_cache(B, SEQ + 1, getattr(torch, cache_dtype))
        logits, cache = tm.prefill(_t(cond), cache)
        steps = [logits[:, -1]]
        pos = torch.arange(SEQ, dtype=torch.int32)
        for i in range(1, SEQ):
            logits, cache = tm.decode_step(_t(seq[:, i - 1 : i]), pos[i : i + 1], cache)
            steps.append(logits[:, -1])
    got = f32(torch.stack(steps, 1))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale
    jsteps = _jax_steps(jm, params, seq, cond, getattr(jnp, cache_dtype))
    np.testing.assert_allclose(got, jsteps, atol=tol_jax * scale)


# (cfg_scale, cfg_interval, cache dtype)
GREEDY = [(1.0, -1, None), (1.5, -1, None), (1.5, 3, None), (1.5, -1, "int8")]


@pytest.mark.parametrize("cfg_scale,cfg_interval,kv", GREEDY,
                         ids=["no_cfg", "cfg", "cfg_interval_3", "cfg_int8_kv"])
def test_greedy_generate_matches_jax(tiny, cfg_scale, cfg_interval, kv):
    jm, params, tm, _, cond = tiny
    want = jax_generate(jm, {"params": params}, jnp.asarray(cond), SEQ, jax.random.PRNGKey(0),
                        cfg_scale=cfg_scale, cfg_interval=cfg_interval, sample_logits=False,
                        cache_dtype=getattr(jnp, kv) if kv else None)
    got = generate(tm, _t(cond), SEQ, cfg_scale=cfg_scale, cfg_interval=cfg_interval,
                   sample_logits=False, cache_dtype=getattr(torch, kv) if kv else None)
    assert got.dtype == torch.int32 and got.shape == (B, SEQ)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 3  # not a constant sequence


def test_cfg_interval_changes_the_tokens(tiny):
    """The cutoff is live: guidance on every step and guidance on the first
    few only give different greedy sequences on this model."""
    _, _, tm, _, cond = tiny
    always = generate(tm, _t(cond), SEQ, cfg_scale=3.0, sample_logits=False)
    early = generate(tm, _t(cond), SEQ, cfg_scale=3.0, cfg_interval=1, sample_logits=False)
    plain = generate(tm, _t(cond), SEQ, sample_logits=False)
    assert not torch.equal(always, plain)
    assert not torch.equal(always, early)


# rows with deliberate ties at the top-k threshold and in the nucleus
TIED = np.array([
    [3.0, 1.0, 1.0, 1.0, 0.0, -2.0, 1.0, 2.0],
    [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
    [4.0, 4.0, -1.0, 2.0, 2.0, 2.0, -3.0, 0.0],
], np.float32)
FILTERS = [(3, 1.0), (1, 1.0), (0, 0.7), (4, 0.9), (100, 0.5), (0, 0.999)]


@pytest.mark.parametrize("top_k,top_p", FILTERS, ids=[f"k{k}_p{p}" for k, p in FILTERS])
def test_top_k_top_p_filtering_matches_jax(top_k, top_p):
    got = top_k_top_p_filtering(torch.from_numpy(TIED), top_k, top_p).numpy()
    want = np.asarray(jax_filter(jnp.asarray(TIED), top_k, top_p))
    np.testing.assert_array_equal(got, want)
    if top_k == 3:  # the ties at the 3rd logit survive: 6 of 8 in row 0
        assert (got[0] > NEG_INF).sum() == 6


def test_sample_from_logits_greedy_and_probs_match_jax():
    logits = TIED * 1.3
    for top_k, top_p in FILTERS:
        idx, probs = sample_from_logits(torch.from_numpy(logits), None, 0.7, top_k, top_p,
                                        sample_logits=False)
        jidx, jprobs = jax_sample(jax.random.PRNGKey(0), jnp.asarray(logits), 0.7, top_k, top_p,
                                  sample_logits=False)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-7)


@pytest.mark.parametrize("flag", [True, False])
def test_combine_cfg_matches_jax(flag):
    logits = np.random.RandomState(3).randn(4, 1, 16).astype(np.float32)
    got = _combine_cfg(torch.from_numpy(logits), 1.5, flag).numpy()
    want = np.asarray(jax_combine_cfg(jnp.asarray(logits), 1.5, flag))
    np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.8)])
def test_sampling_follows_the_filtered_softmax(top_k, top_p):
    """20,000 draws of one row: each token's frequency is within 0.015 (over
    four standard errors) of its filtered-softmax probability, and filtered
    tokens are never drawn."""
    n = 20000
    logits = torch.from_numpy(np.tile(TIED[0] * 0.8, (n, 1)))
    gen = torch.Generator().manual_seed(0)
    idx, probs = sample_from_logits(logits, gen, 0.9, top_k, top_p)
    freq = np.bincount(idx[:, 0].numpy(), minlength=8) / n
    p = probs[0].numpy()
    np.testing.assert_allclose(freq, p, atol=0.015)
    assert freq[p == 0].sum() == 0
    _, jprobs = jax_sample(jax.random.PRNGKey(0), jnp.asarray(logits[:1].numpy()), 0.9, top_k, top_p)
    np.testing.assert_allclose(p, np.asarray(jprobs)[0], atol=1e-7)


def test_frame_prediction_prefill_and_greedy_steps():
    T, new = 4, 8
    jm, params = jax_ar(prompt_len=T, frame_prediction=True)
    tm = port_ar(params, frame_prediction=True)
    assert tm.tok_embeddings.weight.shape[0] == TINY_AR["vocab_size"] + 1  # + sep token
    prompt = np.random.RandomState(5).randint(0, TINY_AR["vocab_size"] + 1, (2, T)).astype(np.int32)
    v = {"params": params}
    jcache = jm.apply(v, 2, T + new, jnp.float32, method=jm.init_cache)
    want, _ = jm.apply(v, jnp.asarray(prompt), jcache, None, method=jm.prefill)
    with torch.inference_mode():
        got, _ = tm.prefill(_t(prompt), tm.init_cache(2, T + new))
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5)
    want_seq = jax_generate(jm, v, jnp.asarray(prompt), new, jax.random.PRNGKey(0),
                            sample_logits=False)
    got_seq = generate(tm, _t(prompt), new, sample_logits=False)
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))


def test_prefill_with_cond_mask_matches_jax():
    """Masked prompt positions are keys for no valid query, and keep
    attending to themselves (the segment trick); the decode steps mask them
    through key_valid."""
    T, new = 4, 6
    jm, params = jax_ar(prompt_len=T, frame_prediction=True)
    tm = port_ar(params, frame_prediction=True)
    prompt = np.random.RandomState(6).randint(0, TINY_AR["vocab_size"], (2, T)).astype(np.int32)
    mask = np.array([[0, 1, 1, 1], [0, 0, 1, 1]], bool)
    want = jax_generate(jm, {"params": params}, jnp.asarray(prompt), new, jax.random.PRNGKey(0),
                        sample_logits=False, emb_masks=jnp.asarray(mask))
    got = generate(tm, _t(prompt), new, sample_logits=False, emb_masks=_t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_bf16_model_matches_flax(tiny):
    """int8 serving: weights cast to bf16, then every projection quantised
    (the JAX `sample.py --dtype int8` order). The int8 values equal; bf16
    activations are rounded at other places by the two frameworks, so the
    logits agree to 2e-2 of their scale."""
    jm, params, tm, seq, cond = tiny
    bf = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16), params)
    qparams = jax_quantize_params(bf)
    jq = FlaxLARP_AR(dataclasses.replace(jm.config, quantized=True))
    want = f32(jq.apply({"params": qparams}, jnp.asarray(seq[:, :-1]), jnp.asarray(cond))[0])
    tq = quantize_model(port_ar(params).to(torch.bfloat16))
    # the bridge maps a quantized Flax tree onto the same tensors
    bridged = ar_state_dict_from_jax(qparams, tq)
    for key, value in tq.state_dict().items():
        np.testing.assert_array_equal(bridged[key].to(value.dtype).float().numpy(),
                                      value.float().numpy(), err_msg=key)
    with torch.inference_mode():
        got = f32(tq(_t(seq[:, :-1]), _t(cond))[0])
    assert tq.layers[0].attention.wqkv.weight.dtype == torch.int8
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("fixed_pe", [False, True], ids=["learned_pe", "fixed_pe"])
def test_ar_pth_round_trip(fixed_pe, tmp_path):
    """The exporter's state dict is the bridge's, key for key and value for
    value; the `.pth` it writes loads strictly and reproduces JAX."""
    jm, params = jax_ar(use_fixed_pe=fixed_pe)
    upstream = export_larp_ar(jm, params)
    tm = LARP_AR(ModelArgs(**TINY_AR, use_fixed_pe=fixed_pe))
    ours = ar_state_dict_from_jax(params, tm)
    assert sorted(ours) == sorted(upstream) == sorted(tm.state_dict())
    for key, value in upstream.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    path = tmp_path / "ar.pth"
    # the layout tools/export_reference_tokenizer.py:212-218 writes
    torch.save({"model": {
        "name": "larp_ar",
        "args": {**TINY_AR, "use_fixed_pe": fixed_pe, "remat": False},
        "sd": {k: torch.from_numpy(np.array(v)) for k, v in upstream.items()},
    }}, path)
    loaded = LARP_AR.from_checkpoint(str(path))
    assert loaded.config.use_fixed_pe == fixed_pe and not loaded.training
    seq = np.random.RandomState(1).randint(0, 64, (2, 8)).astype(np.int32)
    cond = np.array([0, 7], np.int32)
    want = jm.apply({"params": params}, jnp.asarray(seq), jnp.asarray(cond))[0]
    with torch.inference_mode():
        got = loaded(_t(seq), _t(cond))[0]
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5)
    q = load_ar_checkpoint(str(path), dtype=torch.bfloat16, quantized=True)
    assert q.output.weight.dtype == torch.int8 and q.norm.weight.dtype == torch.bfloat16


def test_zoo_geometry():
    """The registered zoo sizes; the LP prior has 631,975,680 parameters
    (SwiGLU hidden 3584), counted on the meta device. llama-abs-S is held
    against the JAX package's parameter count."""
    lp = models["llama-abs-LP"](device="meta")
    assert sum(p.numel() for p in lp.parameters()) == 631_975_680
    assert lp.layers[0].feed_forward.w1.weight.shape == (3584, 1280)
    s = models["llama-abs-S"](device="meta", num_classes=101)
    jm = FlaxLARP_AR(FlaxModelArgs(n_layer=12, n_head=6, dim=384, num_classes=101))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 4), jnp.int32), jnp.zeros((1,), jnp.int32)))
    jcount = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in s.parameters()) == jcount


def test_training_is_not_ported(tiny):
    """Of the prior's training forward only remat is not ported (it names its
    ROADMAP item); with every dropout at 0 the training forward is the
    inference forward, bit for bit."""
    _, _, tm, seq, cond = tiny
    remat = LARP_AR(dataclasses.replace(tm.config, remat=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        remat(_t(seq[:, :-1]), _t(cond), train=True)
    m0 = LARP_AR(dataclasses.replace(tm.config, class_dropout_prob=0.0))
    m0.load_state_dict(tm.state_dict(), strict=True)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        got, got_loss = m0(_t(seq[:, :-1]), _t(cond), targets=_t(seq), train=True, generator=g)
        want, want_loss = tm(_t(seq[:, :-1]), _t(cond), targets=_t(seq))
    assert torch.equal(got, want) and torch.equal(got_loss, want_loss)
