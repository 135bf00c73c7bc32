"""Remat, `attention_with_lse`'s backward and the ring's per-step bodies, on
the CPU, against the plain forward and the JAX package.

  * `LARP_AR(remat=True)`: the training forward's loss and every gradient
    equal the plain forward's bit for bit with every dropout on (the masks
    are drawn from the caller's generator outside the recompute), and the
    generator ends in the same state; against the JAX prior with
    `remat=True` (every dropout 0): the loss to 1e-5 relative, the gradients
    to 1e-5 of each tensor's max |g|;
  * `LARPTokenizer(remat=True)` (both ViT stacks): loss and gradients equal
    the plain model's bit for bit in training (stochastic VQ on, the same
    seeds), and against the JAX tokenizer with `remat=True` to 5e-4 of each
    tensor's max |g| (the bound of `test_torch_trainer_step.py`);
  * `attention_with_lse`'s gradient with cotangents on both out and lse
    against autograd through the plain attention (1e-6) and `jax.vjp` of
    the JAX `attention_with_lse` (1e-5): causal and not, GQA, segment ids,
    a causal offset;
  * `ring_forward_shards` / `ring_backward_shards` (the ring of P shards
    in one process, chip_smoke.py's phase 30 (c)) against whole attention:
    out 2e-6, gradients 1e-5, causal and not, GQA, P = 2 and 4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY_AR, f32, jax_ar, jax_tokenizer, port_ar, port_tokenizer
from video_tokenizer_tpu.ops.attention import attention_with_lse as jax_attention_with_lse
from video_tokenizer_tpu_torch.ops.attention import attention_reference, attention_with_lse
from video_tokenizer_tpu_torch.parallel.ring import ring_backward_shards, ring_forward_shards
from video_tokenizer_tpu_torch.utils.convert import ar_state_dict_from_jax, state_dict_from_jax

DROPOUTS = dict(token_dropout_p=0.2, resid_dropout_p=0.2, ffn_dropout_p=0.2,
                class_dropout_prob=0.3, drop_path_rate=0.3)


def _ar_inputs(seed=0, B=3):
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, TINY_AR["vocab_size"], (B, TINY_AR["max_seq_len"]))
    return torch.from_numpy(seq[:, :-1]), torch.from_numpy(rng.randint(0, 10, B)), torch.from_numpy(seq)


def _grads(model, loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def ar_pair():
    model, params = jax_ar()
    return model, params


def test_ar_remat_equals_plain_bit_for_bit_with_dropouts(ar_pair):
    _, params = ar_pair
    plain = port_ar(params, **DROPOUTS).train()
    remat = port_ar(params, remat=True, **DROPOUTS).train()
    idx, cond, tgt = _ar_inputs()
    out = []
    for m in (plain, remat):
        g = torch.Generator().manual_seed(7)
        logits, loss = m(idx, cond, targets=tgt, train=True, generator=g)
        out.append((logits.detach(), loss.detach(), _grads(m, loss), g.get_state()))
    (l0, s0, g0, st0), (l1, s1, g1, st1) = out
    assert torch.equal(l0, l1) and torch.equal(s0, s1) and torch.equal(st0, st1)
    assert set(g0) == set(g1) and all(torch.equal(g0[n], g1[n]) for n in g0)
    # the dropouts acted: another seed gives another loss
    _, other = plain(idx, cond, targets=tgt, train=True, generator=torch.Generator().manual_seed(8))
    assert not torch.equal(other.detach(), s0)


def test_ar_remat_matches_jax_remat(ar_pair):
    from video_tokenizer_tpu.models.larp_ar import LARP_AR as JaxAR

    model, params = ar_pair
    jmodel = JaxAR(dataclasses.replace(model.config, remat=True, class_dropout_prob=0.0))
    idx, cond, tgt = _ar_inputs(1)

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(idx.numpy()), jnp.asarray(cond.numpy()),
                            targets=jnp.asarray(tgt.numpy()), train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})[1]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    port = port_ar(params, remat=True, class_dropout_prob=0.0).train()
    _, loss = port(idx, cond, targets=tgt, train=True, generator=torch.Generator().manual_seed(0))
    got = _grads(port, loss)
    want = ar_state_dict_from_jax(jax.device_get(jgrads), port)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for n, g in got.items():
        w = f32(want[n])
        assert np.abs(f32(g) - w).max() <= 1e-5 * np.abs(w).max() + 1e-12, n
    assert np.abs(f32(want["layers.0.attention.wqkv.weight"])).max() > 0


@pytest.fixture(scope="module")
def tok_pair():
    return jax_tokenizer(remat=True)


def _clips(seed=0, B=2):
    return torch.from_numpy(np.random.RandomState(seed).rand(B, 3, 8, 32, 32).astype(np.float32))


def test_tokenizer_remat_equals_plain_bit_for_bit(tok_pair):
    _, params = tok_pair
    plain, remat = port_tokenizer(params).train(), port_tokenizer(params, remat=True).train()
    assert remat.encoder.remat and remat.decoder.remat and not plain.encoder.remat
    x = _clips()
    out = []
    for m in (plain, remat):
        o = m(x, train=True)  # stochastic VQ: the same seeds (one generator seed each)
        loss = (o["pred_frames"] - x).square().mean() + o["loss_q"]
        out.append((loss.detach(), o["bottleneck_rep"], _grads(m, loss)))
    (s0, r0, g0), (s1, r1, g1) = out
    assert torch.equal(s0, s1) and torch.equal(r0, r1)
    assert set(g0) == set(g1) and all(torch.equal(g0[n], g1[n]) for n in g0)


def test_tokenizer_remat_matches_jax_remat(tok_pair):
    model, params = tok_pair
    x = _clips(1)
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(x.numpy()), train=False)
        return jnp.sum(out["pred_frames"] * w)

    jgrads = jax.grad(loss_fn)(params)
    port = port_tokenizer(params, remat=True)
    loss = (port(x, train=False)["pred_frames"] * torch.from_numpy(w)).sum()
    got = _grads(port, loss)
    want = state_dict_from_jax(jax.device_get(jgrads), port)
    assert len(got) > 20
    for n, g in got.items():
        wn = f32(want[n])
        assert np.abs(f32(g) - wn).max() <= 5e-4 * np.abs(wn).max() + 1e-12, n


@pytest.mark.parametrize("case", ["full", "causal", "gqa_causal", "segments", "offset"])
def test_attention_with_lse_grads_both_cotangents(case):
    rng = np.random.RandomState(5)
    B, Sq, Sk, H, Hkv, D = 2, 24, 24, 4, 4, 16
    kw = {}
    if case == "gqa_causal":
        Hkv = 2
    if case in ("causal", "gqa_causal"):
        kw["causal"] = True
    if case == "offset":
        Sk, kw = 40, {"causal": True, "causal_offset": 8}
    seg = None
    if case == "segments":
        seg = np.zeros((B, Sq), np.int32)
        seg[:, 15:] = 1
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k, v = (rng.randn(B, Sk, Hkv, D).astype(np.float32) for _ in range(2))
    do, dlse = rng.randn(B, Sq, H, D).astype(np.float32), rng.randn(B, H, Sq).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tseg = torch.from_numpy(seg) if seg is not None else None
    out, lse = attention_with_lse(*ts, segment_ids=tseg, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionLSEBackward"
    torch.autograd.backward([out, lse], [torch.from_numpy(do), torch.from_numpy(dlse)])
    got = [t.grad for t in ts]
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    po, pl = attention_reference(*plain, segment_ids=tseg, **kw)
    torch.autograd.backward([po, pl], [torch.from_numpy(do), torch.from_numpy(dlse)])
    for a, b in zip(got, plain):
        np.testing.assert_allclose(f32(a), f32(b.grad), atol=1e-6)
    jseg = jnp.asarray(seg) if seg is not None else None
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_with_lse(a, b, c, segment_ids=jseg,
                                                           use_pallas=False, **kw), q, k, v)
    for a, b in zip(got, vjp((jnp.asarray(do), jnp.asarray(dlse)))):
        np.testing.assert_allclose(f32(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("causal, Hkv", [(False, 4), (True, 4), (True, 2)])
def test_ring_shards_in_one_process_match_whole_attention(P, causal, Hkv):
    rng = np.random.RandomState(P)
    B, S, H, D = 2, 32, 4, 16
    q = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.randn(B, S, Hkv, D).astype(np.float32)).requires_grad_()
            for _ in range(2))
    do = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
    out, _ = attention_reference(q, k, v, causal=causal)
    out.backward(do)
    parts = lambda t: list(t.detach().chunk(P, dim=1))  # noqa: E731
    outs, lses = ring_forward_shards(parts(q), parts(k), parts(v), causal)
    np.testing.assert_allclose(f32(torch.cat(outs, 1)), f32(out), atol=2e-6)
    dq, dk, dv = ring_backward_shards(parts(q), parts(k), parts(v), outs, lses, parts(do), causal)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        np.testing.assert_allclose(f32(torch.cat(got, 1)), f32(want), atol=1e-5)
