"""Stochastic (Gumbel-max) VQ sampling of the port, on the CPU.

The port draws its Gumbel noise from a counter-based Philox4x32-10 (the same
bits as `csrc/vq_lookup.cu`, which chip_smoke.py holds index for index
against the plain version on the card); the JAX package draws from the TPU
core's PRNG or `jax.random.gumbel`. So the port and JAX are compared by
distribution: each against softmax(score * inv_temp), and against each other,
by chi-square tests at p > 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2, chi2_contingency

import _torch_port  # noqa: F401  (this test worker's share of the cores)

import video_tokenizer_tpu.ops.vq as jax_vq
from video_tokenizer_tpu_torch.models.bottleneck import SimpleVectorQuantizer
from video_tokenizer_tpu_torch.ops.vq import (
    gumbel_noise, philox4x32_10, vq_argmax, vq_lookup, vq_lookup_reference,
)

K, N, INV_TEMP = 12, 1 << 14, 3.0


def _codebook(seed=0):
    rng = np.random.RandomState(seed)
    emb = rng.randn(K, 8).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return emb


def test_philox_matches_the_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    vectors = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, (k0, k1), want in vectors:
        got = philox4x32_10(*(torch.tensor(c, dtype=torch.int64) for c in ctr), k0 | (k1 << 32))
        assert tuple(int(x) for x in got) == want


def test_plain_sampling_is_a_function_of_the_seed():
    rng = np.random.RandomState(1)
    z = torch.from_numpy(rng.randn(300, 8).astype(np.float32))
    emb = torch.from_numpy(rng.randn(70, 8).astype(np.float32))
    draw = lambda seed: vq_lookup_reference(z, emb, stochastic=True, inv_temp=2.0, seed=seed)  # noqa: E731
    assert torch.equal(draw(5), draw(5))
    assert (draw(5) != draw(6)).any()
    # the noise of (row, code) does not depend on how many rows or codes there are
    assert torch.equal(gumbel_noise(300, 70, 9)[:17, :33], gumbel_noise(17, 33, 9))
    # the public wrapper takes the plain path on CPU tensors, without launching
    vq_argmax.launches = 0
    assert torch.equal(vq_argmax(z, emb, stochastic=True, inv_temp=2.0, seed=5), draw(5))
    assert vq_argmax.launches == 0
    # Gumbel(0, 1): mean Euler's gamma, variance pi^2 / 6
    g = gumbel_noise(512, 512, 3).double()
    assert abs(g.mean().item() - 0.5772) < 0.01 and abs(g.var().item() - np.pi**2 / 6) < 0.03


def _softmax_probs(emb, row):
    p = np.exp(INV_TEMP * (emb @ emb[row]))
    return p / p.sum()


def test_sample_frequencies_match_softmax_and_jax():
    """One z row (a code) drawn N times: the port's counts against
    softmax(cos * inv_temp), JAX's `vq_lookup_xla` counts likewise, and the
    two count vectors against each other (chi-square homogeneity)."""
    emb = _codebook()
    z = np.repeat(emb[3:4], N, axis=0)
    port = vq_lookup(torch.from_numpy(z), torch.from_numpy(emb), metric="cos", stochastic=True,
                     inv_temp=INV_TEMP, seed=2024).numpy()
    jx = np.asarray(jax_vq.vq_lookup(jnp.asarray(z), jnp.asarray(emb), metric="cos",
                                     stochastic=True, inv_temp=INV_TEMP,
                                     key=jax.random.PRNGKey(0), use_pallas=False))
    p = _softmax_probs(emb, 3)
    for name, idx in (("port", port), ("jax", jx)):
        counts = np.bincount(idx, minlength=K)
        stat = (((counts - N * p) ** 2) / (N * p)).sum()
        assert chi2.sf(stat, K - 1) > 1e-3, f"{name}: chi-square {stat}"
    table = np.stack([np.bincount(port, minlength=K), np.bincount(jx, minlength=K)])
    assert chi2_contingency(table)[1] > 1e-3


def _quantizer(**kw):
    args = dict(dim=8, codebook_size=K, l2_normalized=True, stochastic=True,
                stochastic_temperature=1.0 / INV_TEMP,
                generator=torch.Generator().manual_seed(0))
    args.update(kw)
    vq = SimpleVectorQuantizer(**args)
    with torch.no_grad():
        vq.embedding.weight.copy_(torch.from_numpy(_codebook()))
    return vq


def test_training_mode_samples():
    """Training (or eval_deterministic=False) samples, one seed drawn from the
    module's generator per call; deterministic eval takes the argmax."""
    vq = _quantizer()
    z = torch.from_numpy(np.repeat(_codebook()[3:4], N, axis=0))[None]
    state = vq.sample_generator.get_state()
    a = vq(z, train=True)["bottleneck_rep"][0]
    b = vq(z, train=True)["bottleneck_rep"][0]
    assert (a != b).any()  # a fresh seed per call
    vq.sample_generator.set_state(state)
    seed = vq.draw_seed()
    want = vq_lookup_reference(z[0], vq.get_emb(), stochastic=True, inv_temp=INV_TEMP, seed=seed)
    assert torch.equal(a, want)
    counts = np.bincount(a.numpy(), minlength=K)
    p = _softmax_probs(_codebook(), 3)
    assert chi2.sf((((counts - N * p) ** 2) / (N * p)).sum(), K - 1) > 1e-3
    assert (vq(z, train=False)["bottleneck_rep"] == 3).all()
    sampled = _quantizer(eval_deterministic=False)(z, train=False)["bottleneck_rep"]
    assert (sampled != 3).any()
    # the straight-through output and the losses are those of the drawn codes
    out = vq(z[:, :64], train=True)
    emb = vq.get_emb()
    np.testing.assert_allclose(out["regularized_z"].detach().numpy(),
                               emb[out["bottleneck_rep"].long()].detach().numpy(), atol=1e-6)


def test_learnable_temperature_is_folded_into_z():
    """stochastic_temperature <= 0: a learnable inverse temperature (10 at
    init) scales z before the lookup, at inv_temp 1, as in the JAX module."""
    vq = _quantizer(stochastic_temperature=0.0)
    assert float(vq.stochastic_temperature_inv.detach()) == 10.0
    z = torch.from_numpy(np.random.RandomState(2).randn(1, 500, 8).astype(np.float32))
    state = vq.sample_generator.get_state()
    got = vq(z, train=True)["bottleneck_rep"][0]
    vq.sample_generator.set_state(state)
    zn = z[0] / (z[0].norm(dim=-1, keepdim=True) + 1e-12)
    want = vq_lookup_reference(zn * 10.0, vq.get_emb(), stochastic=True, inv_temp=1.0,
                               seed=vq.draw_seed())
    assert torch.equal(got, want)


@pytest.mark.parametrize("stochastic", [False, True])
def test_jax_module_draws_like_the_port_in_distribution(stochastic):
    """The JAX SimpleVectorQuantizer in training mode against the port's,
    same codebook: identical argmax when deterministic, the same code
    frequencies (chi-square homogeneity) when sampling."""
    from video_tokenizer_tpu.models.bottleneck import SimpleVectorQuantizer as JaxVQ

    emb = _codebook()
    z = np.repeat(emb[5:6], N, axis=0)[None] * 2.0
    kw = dict(dim=8, codebook_size=K, l2_normalized=True, stochastic=stochastic,
              stochastic_temperature=1.0 / INV_TEMP)
    jmod = JaxVQ(**kw)
    out = jmod.apply({"params": {"embedding": jnp.asarray(emb)}}, jnp.asarray(z), train=True,
                     rngs={"vq": jax.random.PRNGKey(3)})
    jx = np.asarray(out["bottleneck_rep"][0])
    port = _quantizer(stochastic=stochastic)(torch.from_numpy(z), train=True)
    got = port["bottleneck_rep"][0].numpy()
    np.testing.assert_allclose(float(port["loss_q"].detach()), float(out["loss_q"]), rtol=0.05)
    if not stochastic:
        np.testing.assert_array_equal(got, jx)
        return
    table = np.stack([np.bincount(got, minlength=K), np.bincount(jx, minlength=K)])
    assert chi2_contingency(table)[1] > 1e-3
