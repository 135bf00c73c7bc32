"""Parity of the port's speculative decoding with the JAX package, on the CPU.

Tiny priors (2 layers, dim 64, 4 heads, vocab 32, as tests/test_speculative.py)
are initialised in JAX, perturbed with numpy and given a sharp output head
(the head is zero-initialised: a fresh model's distributions are uniform and
prove nothing), and the same weights reach the port through
`ar_state_dict_from_jax`. Held against JAX: `decode_chunk` (logits and
caches), `sampling_dist` / `residual_dist`, and `speculative_generate` token
for token under greedy decoding (draws differ between the frameworks, so a
stochastic run is held by its distribution instead). On CPU tensors the two
kernels of the path run their plain versions.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from _torch_port import jax_ar, port_ar
from video_tokenizer_tpu.generation import speculative_generate as jax_speculative_generate
from video_tokenizer_tpu.generation.speculative import residual_dist as jax_residual_dist
from video_tokenizer_tpu.generation.speculative import sampling_dist as jax_sampling_dist
from video_tokenizer_tpu.generation.speculative import self_draft as jax_self_draft
from video_tokenizer_tpu_torch.generation import generate, self_draft, speculative_generate
from video_tokenizer_tpu_torch.generation.speculative import residual_dist, sampling_dist
from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row
from video_tokenizer_tpu_torch.ops.decode_attention import chunk_attention

TINY = dict(dim=64, n_layer=2, n_head=4, vocab_size=32, num_classes=5, max_seq_len=12)


def pair(seed=0, head_seed=100, **overrides):
    """(Flax model, {'params': numpy tree}, the port's model with those weights)."""
    args = {**TINY, **overrides}
    jmodel, params = jax_ar(**args)
    rng = np.random.RandomState(head_seed + seed)
    # per-seed weights: the same init for every seed would make every draft its target
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * np.random.RandomState(seed).randn(*x.shape).astype(np.float32)
        if x.ndim >= 2 else x, params)
    params["output"] = {"kernel": 0.5 * rng.randn(args["dim"], args["vocab_size"]).astype(np.float32)}
    return jmodel, {"params": params}, port_ar(params, **args)


def jcache(jmodel, variables, batch, seq, dtype):
    return jmodel.apply(variables, batch, seq, dtype, method=jmodel.init_cache)


def planes_to_rows(plane, batch):
    """The JAX [S, 128] scale plane -> the port's [B, S]."""
    return np.asarray(plane)[:, :batch].T


# --------------------------------------------------------------- decode_chunk


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_decode_chunk_matches_jax(cache):
    """Two chunk forwards at per-row positions (rows 3 apart), GQA 4/2: the
    logits and both layers' caches against JAX. fp32 on both sides with sums
    in other orders: 1e-5 of the logit scale; int8 rows equal but for
    one-step flips at a rounding boundary (none at these seeds)."""
    jmodel, variables, model = pair(0, n_kv_head=2, max_seq_len=16)
    rng = np.random.RandomState(5)
    cond = np.array([2, 3])
    pre = rng.randint(0, 32, (2, 6))
    toks = rng.randint(0, 32, (2, 3))
    pos = np.array([3, 6], np.int32)  # row 0 has 2 committed tokens, row 1 has 5
    jdt, tdt = (jnp.int8, torch.int8) if cache == "int8" else (jnp.float32, torch.float32)

    jc = jcache(jmodel, variables, 2, 16, jdt)
    _, jc = jmodel.apply(variables, jnp.asarray(cond), jc, method=jmodel.prefill)
    jl1, jc = jmodel.apply(variables, jnp.asarray(pre), jnp.full((2,), 1, jnp.int32), jc,
                           method=jmodel.decode_chunk)
    jl2, jc = jmodel.apply(variables, jnp.asarray(toks), jnp.asarray(pos), jc,
                           method=jmodel.decode_chunk)
    with torch.inference_mode():
        tc = model.init_cache(2, 16, tdt)
        model.prefill(torch.from_numpy(cond), tc)
        tl1, _ = model.decode_chunk(torch.from_numpy(pre), torch.full((2,), 1, dtype=torch.int32), tc)
        tl2, _ = model.decode_chunk(torch.from_numpy(toks), torch.from_numpy(pos), tc)
    scale = float(np.abs(np.asarray(jl2)).max())
    assert scale > 1.0  # a sharp head: the comparison is not one of zeros
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=1e-5 * scale)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-5 * scale)
    for lt, lj in zip(tc, jc):
        for name in lt:
            want = np.asarray(lj[name], np.float32)
            if name in ("ks", "vs"):
                want = planes_to_rows(want, 2)
            else:  # the JAX cache pads its rows to 128 lanes
                assert not want[..., lt[name].shape[-1]:].any()
                want = want[..., : lt[name].shape[-1]]
            np.testing.assert_allclose(lt[name].float().numpy(), want, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cache", [torch.float32, torch.int8])
def test_decode_chunk_equals_sequential_decode_steps(cache):
    """decode_chunk over G tokens == G one-token decode_steps, logits and
    caches (uniform positions)."""
    _, _, model = pair(0, n_kv_head=2)
    toks = torch.from_numpy(np.random.RandomState(5).randint(0, 32, (2, 4)))
    cond = torch.tensor([2, 3])
    with torch.inference_mode():
        ca, cb = model.init_cache(2, 12, cache), model.init_cache(2, 12, cache)
        model.prefill(cond, ca)
        model.prefill(cond, cb)
        steps = torch.stack([model.decode_step(toks[:, g : g + 1], 1 + g, ca)[0][:, 0]
                             for g in range(4)], dim=1)
        chunk, _ = model.decode_chunk(toks, torch.full((2,), 1, dtype=torch.int32), cb)
    np.testing.assert_allclose(chunk.numpy(), steps.numpy(), atol=2e-5, rtol=2e-5)
    for la, lb in zip(ca, cb):
        for name in la:
            np.testing.assert_allclose(la[name].float().numpy(), lb[name].float().numpy(), atol=1e-6)


def test_decode_chunk_rows_are_independent():
    """Rows at different positions: each row of a batched chunk forward
    equals the same row run alone."""
    _, _, model = pair(1, max_seq_len=16)
    rng = np.random.RandomState(6)
    cond = torch.tensor([2, 3])
    pre = torch.from_numpy(rng.randint(0, 32, (2, 5)))
    toks = torch.from_numpy(rng.randint(0, 32, (2, 3)))
    pos = torch.tensor([3, 6], dtype=torch.int32)
    with torch.inference_mode():
        cache = model.init_cache(2, 16)
        model.prefill(cond, cache)
        for g in range(5):
            model.decode_step(pre[:, g : g + 1], 1 + g, cache)
        batched, _ = model.decode_chunk(toks, pos, cache)
        for r in range(2):
            solo_cache = model.init_cache(1, 16)
            model.prefill(cond[r : r + 1], solo_cache)
            for g in range(int(pos[r]) - 1):
                model.decode_step(pre[r : r + 1, g : g + 1], 1 + g, solo_cache)
            solo, _ = model.decode_chunk(toks[r : r + 1], pos[r : r + 1], solo_cache)
            np.testing.assert_allclose(batched[r].numpy(), solo[0].numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("cache", [torch.float32, torch.int8])
def test_width_2_rewrite_preserves_cache_and_logits(cache):
    """The invariant behind the width-2 first draft forward: feeding the
    already-cached token again at its own position rewrites that cache row
    with the same values, and the new position's logits equal the width-1
    path's. "The same" is up to the projection GEMM's summation order, which
    changes with its row count (2 rows, then 4): 1e-6 on fp32 rows and int8
    scales, at most one int8 step on a value that sits on a rounding boundary."""
    _, _, model = pair(3)
    cond = torch.tensor([1, 4])
    tok_a, tok_b = torch.tensor([[7], [11]]), torch.tensor([[3], [29]])
    pos1 = torch.full((2,), 1, dtype=torch.int32)
    with torch.inference_mode():
        cache = model.init_cache(2, 12, cache)
        model.prefill(cond, cache)
        model.decode_chunk(tok_a, pos1, cache)
        before = [{n: t.clone() for n, t in lc.items()} for lc in cache]
        ref, _ = model.decode_chunk(tok_b, pos1 + 1,
                                    [{n: t.clone() for n, t in lc.items()} for lc in before])
        w2, _ = model.decode_chunk(torch.cat([tok_a, tok_b], dim=1), pos1, cache)
    np.testing.assert_allclose(w2[:, -1].numpy(), ref[:, -1].numpy(), atol=2e-5, rtol=2e-5)
    for la, lb in zip(before, cache):
        for name in la:
            a, b = la[name][:, 1].float(), lb[name][:, 1].float()
            if la[name].dtype == torch.int8:
                assert (a - b).abs().max() <= 1 and (a != b).float().mean() < 0.01, name
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6, err_msg=name)
            assert not la[name][:, 2:].any() and not lb[name][:, 3:].any(), name  # rows never written


# ------------------------------------------------------- acceptance operator


def test_sampling_and_residual_dists_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 19).astype(np.float32) * 2
    for kw in (dict(), dict(temperature=0.7, top_k=5, top_p=0.9), dict(top_k=4),
               dict(top_p=0.8), dict(sample_logits=False)):
        got = sampling_dist(torch.from_numpy(logits), **kw).numpy()
        want = np.asarray(jax_sampling_dist(jnp.asarray(logits), **kw))
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=str(kw))
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    p = sampling_dist(torch.from_numpy(logits))
    q = sampling_dist(torch.from_numpy(rng.randn(3, 19).astype(np.float32) * 2))
    for a, b in ((p, q), (p, p), (p, torch.zeros_like(p))):
        got = residual_dist(a, b).numpy()
        want = np.asarray(jax_residual_dist(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(residual_dist(p, p).numpy(), p.numpy(), atol=1e-7)
    np.testing.assert_allclose(residual_dist(p, torch.zeros_like(p)).numpy(), p.numpy(), atol=1e-7)


def test_rejection_sampling_is_exact():
    """q(x) min(1, p(x)/q(x)) + P(reject) residual(x) == p(x) for arbitrary p
    and q: one speculative step emits exactly the target's distribution."""
    rng = np.random.RandomState(0)
    for _ in range(5):
        p = torch.softmax(torch.from_numpy(rng.randn(17).astype(np.float32)) * 2, -1)
        q = torch.softmax(torch.from_numpy(rng.randn(17).astype(np.float32)) * 2, -1)
        accept = torch.clamp(p / q, max=1.0)
        out = q * accept + (q * (1 - accept)).sum() * residual_dist(p, q)
        np.testing.assert_allclose(out.numpy(), p.numpy(), atol=1e-6)


# ------------------------------------------------------- speculative_generate

# (name, target overrides, draft overrides, new tokens, gammas, kwargs)
GREEDY_CASES = [
    ("plain", {}, dict(dim=32, n_head=2), 12, (1, 3, 5), {}),
    ("cfg", {}, dict(dim=32, n_head=2), 10, (3,), dict(cfg_scale=2.0)),
    ("int8_kv", dict(dim=128, n_head=2), dict(dim=128, n_head=2), 10, (3,), dict(cache_dtype="int8")),
    ("gqa", dict(n_kv_head=2), dict(dim=32, n_head=2), 12, (4,), {}),
]


@pytest.mark.parametrize("case", GREEDY_CASES, ids=[c[0] for c in GREEDY_CASES])
def test_greedy_equals_generate_and_jax(case):
    """Greedy speculative decoding == the port's greedy `generate` == JAX's
    `speculative_generate`, token for token, whatever the draft."""
    _, t_over, d_over, N, gammas, kw = case
    jt, tv, target = pair(0, **t_over)
    jd, dv, draft = pair(7, **d_over)
    cond = np.array([2, 3])
    tkw, skw, jkw = dict(kw), dict(kw), dict(kw)
    if kw.get("cache_dtype") == "int8":
        tkw.update(cache_dtype=torch.int8)
        skw.update(cache_dtype=torch.int8, draft_cache_dtype=torch.int8)
        jkw.update(cache_dtype=jnp.int8, draft_cache_dtype=jnp.int8)
    want = generate(target, torch.from_numpy(cond), N, sample_logits=False, **tkw)
    for gamma in gammas:
        got, stats = speculative_generate(target, draft, torch.from_numpy(cond), N, gamma=gamma,
                                          sample_logits=False, return_stats=True, **skw)
        assert got.dtype == torch.int32 and torch.equal(got, want), gamma
        jgot, jstats = jax_speculative_generate(
            jt, tv, jd, dv, jnp.asarray(cond), N, jax.random.PRNGKey(0), gamma=gamma,
            sample_logits=False, return_stats=True, **jkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
        # greedy acceptance is deterministic too: the same iterations and rate
        assert stats["iterations"] == int(jstats["iterations"])
        assert float(stats["acceptance_rate"]) == pytest.approx(float(jstats["acceptance_rate"]))


def test_self_draft_shares_the_targets_modules_and_matches_jax():
    jt, tv, target = pair(0)
    draft = self_draft(target, 1)
    assert draft.config.n_layer == 1 and len(draft.layers) == 1
    assert draft.layers[0] is target.layers[0] and draft.output is target.output
    assert draft.tok_embeddings is target.tok_embeddings and draft.abs_pe is target.abs_pe
    assert not any(p.is_meta for p in draft.parameters())
    with pytest.raises(ValueError):
        self_draft(target, 2)
    cond = np.array([2, 3])
    want = generate(target, torch.from_numpy(cond), 10, sample_logits=False)
    got = speculative_generate(target, draft, torch.from_numpy(cond), 10, gamma=3, sample_logits=False)
    assert torch.equal(got, want)
    jd, jdp = jax_self_draft(jt, tv["params"], 1)
    jgot = jax_speculative_generate(jt, tv, jd, {"params": jdp}, jnp.asarray(cond), 10,
                                    jax.random.PRNGKey(0), gamma=3, sample_logits=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    # the JAX draft's key subset loads into a port model of that depth
    loaded = port_ar(jdp, **{**TINY, "n_layer": 1})
    idx, c = torch.from_numpy(np.array([[1, 2, 3]])), torch.tensor([2])
    with torch.inference_mode():
        np.testing.assert_allclose(loaded(idx, c)[0].numpy(), draft(idx, c)[0].numpy(), atol=1e-6)


def test_frame_prediction_greedy_equals_generate_and_jax():
    cfg = dict(max_seq_len=8, cls_token_num=5, frame_prediction=True)
    jt, tv, target = pair(0, **cfg)
    jd, dv, draft = pair(7, dim=32, n_head=2, **cfg)
    cond = np.random.RandomState(0).randint(0, 32, (2, 5))
    want = generate(target, torch.from_numpy(cond), 6, sample_logits=False)
    got = speculative_generate(target, draft, torch.from_numpy(cond), 6, gamma=2, sample_logits=False)
    assert torch.equal(got, want)
    jgot = jax_speculative_generate(jt, tv, jd, dv, jnp.asarray(cond), 6, jax.random.PRNGKey(2),
                                    gamma=2, sample_logits=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    with pytest.raises(ValueError, match="cfg_scale"):
        speculative_generate(target, draft, torch.from_numpy(cond), 6, cfg_scale=1.5)


def test_emb_masks_greedy_equals_generate():
    cfg = dict(max_seq_len=8, cls_token_num=5, frame_prediction=True)
    _, _, target = pair(0, **cfg)
    _, _, draft = pair(7, dim=32, n_head=2, **cfg)
    cond = torch.from_numpy(np.random.RandomState(1).randint(0, 32, (2, 5)))
    masks = torch.tensor([[1, 1, 0, 1, 1], [1, 0, 0, 1, 1]], dtype=torch.bool)
    want = generate(target, cond, 6, sample_logits=False, emb_masks=masks)
    got = speculative_generate(target, draft, cond, 6, gamma=3, sample_logits=False, emb_masks=masks)
    assert torch.equal(got, want)


def test_draft_equals_target_accepts_everything():
    """draft == target: every proposal is accepted, acceptance 1.0, and
    ceil((N - 1) / (gamma + 1)) verify iterations."""
    _, _, model = pair(0)
    seq, stats = speculative_generate(model, model, torch.tensor([2, 3]), 12,
                                      torch.Generator().manual_seed(3), gamma=3, temperature=0.9,
                                      top_k=8, return_stats=True)
    assert seq.shape == (2, 12) and int(seq.min()) >= 0 and int(seq.max()) < 32
    assert float(stats["acceptance_rate"]) == pytest.approx(1.0)
    assert stats["iterations"] == math.ceil(11 / 4)


def test_zero_heads_accept_everything():
    """The ceiling construction of the on-card smoke run: two different models
    with zero output heads are both uniform, so every proposal is accepted."""
    _, _, target = pair(0)
    _, _, draft = pair(7, dim=32, n_head=2)
    with torch.no_grad():
        target.output.weight.zero_()
        draft.output.weight.zero_()
    _, stats = speculative_generate(target, draft, torch.tensor([2, 3]), 12,
                                    torch.Generator().manual_seed(0), gamma=4, cfg_scale=1.5,
                                    top_k=8, return_stats=True)
    assert float(stats["acceptance_rate"]) == 1.0 and stats["iterations"] == math.ceil(11 / 5)


def test_stochastic_run_is_repeatable_and_counts_kernel_calls():
    _, _, target = pair(0)
    _, _, draft = pair(7, dim=32, n_head=2)
    cond = torch.tensor([1, 4])
    kw = dict(gamma=2, cfg_scale=1.5, temperature=0.8, top_k=6, top_p=0.9)
    chunk_attention.launches = write_rows_per_row.launches = 0
    a = speculative_generate(target, draft, cond, 9, torch.Generator().manual_seed(4), **kw)
    b = speculative_generate(target, draft, cond, 9, torch.Generator().manual_seed(4), **kw)
    c = speculative_generate(target, draft, cond, 9, torch.Generator().manual_seed(5), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 9) and int(a.min()) >= 0 and int(a.max()) < 32
    assert chunk_attention.launches == 0 and write_rows_per_row.launches == 0  # CPU: plain versions


def test_stochastic_tokens_follow_the_targets_distribution():
    """2000 rows of one class: token 0 is a plain target sample and token 1
    the first speculative one (accepted, redrawn or bonus). Their counts are
    held against the target's exact distributions, p(t0) and
    sum_t0 p(t0) p(t1 | t0) from teacher forcing over every t0, by chi-square
    (p > 1e-3), with temperature and top-k."""
    _, _, target = pair(0)
    _, _, draft = pair(7, dim=32, n_head=2)
    n, V = 2000, 32
    kw = dict(temperature=0.9, top_k=12)
    cond = torch.full((n,), 2)
    seq = speculative_generate(target, draft, cond, 3, torch.Generator().manual_seed(11), gamma=2, **kw)
    with torch.inference_mode():
        logits, _ = target(torch.arange(V)[:, None], torch.full((V,), 2))  # [V, 2, V]
    p0 = sampling_dist(logits[0, 0], **kw).double()
    p1 = (p0[:, None] * sampling_dist(logits[:, 1], **kw).double()).sum(0)
    for name, p, col in (("token 0", p0, 0), ("token 1", p1, 1)):
        counts = torch.bincount(seq[:, col].long(), minlength=V).double()
        assert counts[p == 0].sum() == 0, f"{name}: a filtered token was sampled"
        keep = n * p >= 5  # merge the rare tokens into one bin
        obs = torch.cat([counts[keep], counts[~keep].sum()[None]])
        exp = torch.cat([n * p[keep], n * p[~keep].sum()[None]])
        obs, exp = obs[exp > 0], exp[exp > 0]
        stat = (((obs - exp) ** 2) / exp).sum().item()
        assert chi2.sf(stat, len(exp) - 1) > 1e-3, f"{name}: chi-square {stat} on {len(exp) - 1} dof"


def test_speculative_generate_refuses_mismatched_pairs():
    _, _, target = pair(0)
    _, _, fp = pair(7, max_seq_len=8, cls_token_num=5, frame_prediction=True)
    with pytest.raises(ValueError, match="frame_prediction"):
        speculative_generate(target, fp, torch.tensor([1]), 4)
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(target, target, torch.tensor([1]), 4, gamma=0)


# ------------------------------------------------------------- distillation


def test_distill_tiny_lowers_the_soft_ce():
    """A few distillation steps on a tiny pair with a sharpened teacher pull
    the draft's soft cross-entropy down; the trained draft comes back in bf16,
    the draft handed in is left as it was, and the pair serves."""
    from video_tokenizer_tpu_torch import LARP_AR, ModelArgs
    from video_tokenizer_tpu_torch.tools.distill_draft import distill

    common = dict(vocab_size=32, num_classes=101, max_seq_len=32, class_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(0)
    target = LARP_AR(ModelArgs(n_layer=2, n_head=2, dim=64, **common), generator=gen).bfloat16().eval()
    draft = LARP_AR(ModelArgs(n_layer=1, n_head=2, dim=64, **common), generator=gen).bfloat16().eval()
    with torch.no_grad():
        target.output.weight.copy_(0.5 * torch.randn(32, 64, generator=gen))
    before = {k: v.clone() for k, v in draft.state_dict().items()}
    trained, stats = distill(target, draft, torch.Generator().manual_seed(2), steps=8, batch=2,
                             seq_len=32, lr=1e-2, log=lambda *a: None)
    assert stats["last_loss"] < stats["first_loss"]
    assert all(p.dtype == torch.bfloat16 for p in trained.parameters()) and not trained.training
    assert all(torch.equal(v, before[k]) for k, v in draft.state_dict().items())
    seq, st = speculative_generate(target, trained, torch.tensor([0, 0]), 8,
                                   torch.Generator().manual_seed(1), gamma=2, return_stats=True)
    assert seq.shape == (2, 8) and 0.0 <= float(st["acceptance_rate"]) <= 1.0
