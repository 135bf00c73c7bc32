"""The port's latent-token, latent-continuous and timestep embedders (`models/embed.py`) against JAX.

On the CPU, fp32, with the JAX init's parameters carried by
`embedder_state_dict_from_jax`. Held:
  * with `force_drop_ids` the outputs equal the JAX module's exactly (a
    table lookup; the Dense within 1e-6 of the scale), the dropped samples
    on the null row / `uncond_embed`, also at dropout probability 0 (the null
    entry always allocated) and outside train mode;
  * train-mode dropout by its distribution (the draws are the port's own
    generator's, not JAX's bits): over 40,000 samples the drop rate of each
    side within 5 sigma of p = 0.3 and of each other, whole sequences
    dropped together; the same generator seed gives the same drops; nothing
    dropped in eval mode or at p = 0;
  * `TimestepEmbedder`: the sinusoidal table for even and odd widths
    entrywise within 1e-6 + 6e-8 t (fp32 `exp`s of the frequencies may
    round 1 ulp apart), the MLP on JAX's table within 1e-5 of the scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)
from video_tokenizer_tpu.models import embed as je
from video_tokenizer_tpu_torch.models import embed as te
from video_tokenizer_tpu_torch.utils.convert import embedder_state_dict_from_jax


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _token_pair(p):
    jm = je.LatentTokenEmbedder(codebook_size=16, hidden_size=8, dropout_prob=p)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 5), jnp.int32))["params"]
    tm = te.LatentTokenEmbedder(16, 8, p)
    tm.load_state_dict(embedder_state_dict_from_jax(jax.device_get(params), tm), strict=True)
    return jm, params, tm


def _cont_pair(p):
    jm = je.LatentContEmbedder(token_dim=6, hidden_size=8, dropout_prob=p)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 5, 6)))["params"])
    params["uncond_embed"] = np.random.RandomState(1).randn(8).astype(np.float32)
    tm = te.LatentContEmbedder(6, 8, p)
    tm.load_state_dict(embedder_state_dict_from_jax(params, tm), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("train", [False, True])
def test_token_embedder_forced_drops_match_jax(p, train):
    jm, params, tm = _token_pair(p)
    assert tm.embedding_table.weight.shape == (17, 8)  # the null row always there
    tokens = np.random.RandomState(2).randint(0, 16, (4, 5)).astype(np.int32)
    force = np.array([1, 0, 1, 0], np.int32)
    want = jm.apply({"params": params}, jnp.asarray(tokens), train=train,
                    force_drop_ids=jnp.asarray(force), rng=jax.random.PRNGKey(3))
    got = tm(torch.from_numpy(tokens).long(), train=train,
             force_drop_ids=torch.from_numpy(force), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    null = tm.embedding_table.weight[16].detach().numpy()
    assert np.all(got.detach().numpy()[[0, 2]] == null)
    plain = jm.apply({"params": params}, jnp.asarray(tokens))
    np.testing.assert_array_equal(tm(torch.from_numpy(tokens).long()).detach().numpy(),
                                  np.asarray(plain))


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("train", [False, True])
def test_cont_embedder_forced_drops_match_jax(p, train):
    jm, params, tm = _cont_pair(p)
    embs = np.random.RandomState(4).randn(4, 5, 6).astype(np.float32)
    force = np.array([0, 1, 1, 0], np.int32)
    want = jm.apply({"params": params}, jnp.asarray(embs), train=train,
                    force_drop_ids=jnp.asarray(force), rng=jax.random.PRNGKey(3))
    got = tm(torch.from_numpy(embs), train=train, force_drop_ids=torch.from_numpy(force))
    assert _rel(got.detach().numpy(), want) <= 1e-6
    np.testing.assert_array_equal(got.detach().numpy()[[1, 2]],
                                  np.broadcast_to(params["uncond_embed"], (2, 5, 8)))
    plain = jm.apply({"params": params}, jnp.asarray(embs))
    assert _rel(tm(torch.from_numpy(embs)).detach().numpy(), plain) <= 1e-6


def _rate(drop, n, p):
    """|drop / n - p| in sigmas of the binomial."""
    return abs(drop / n - p) / np.sqrt(p * (1 - p) / n)


def test_train_dropout_by_distribution():
    n, p = 40_000, 0.3
    jm, params, tm = _token_pair(p)
    tokens = np.random.RandomState(5).randint(0, 16, (n, 3)).astype(np.int32)
    null = tm.embedding_table.weight[16].detach()
    got = tm(torch.from_numpy(tokens).long(), train=True,
             generator=torch.Generator().manual_seed(6)).detach()
    rows = (got == null).all(-1)  # [n, 3]: a sample drops whole
    assert torch.equal(rows.all(-1), rows.any(-1))
    port = int(rows.all(-1).sum())
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens), train=True,
                               rng=jax.random.PRNGKey(6)))
    jax_drop = int(np.all(want == np.asarray(null), axis=(-1, -2)).sum())
    assert _rate(port, n, p) <= 5 and _rate(jax_drop, n, p) <= 5
    assert abs(port - jax_drop) / n <= 5 * np.sqrt(2 * p * (1 - p) / n)
    again = tm(torch.from_numpy(tokens).long(), train=True,
               generator=torch.Generator().manual_seed(6)).detach()
    assert torch.equal(got, again)
    assert not (tm(torch.from_numpy(tokens).long()) == null).all(-1).any()

    _, _, cm = _cont_pair(p)
    embs = torch.randn(n, 2, 6, generator=torch.Generator().manual_seed(7))
    out = cm(embs, train=True, generator=torch.Generator().manual_seed(8)).detach()
    dropped = (out == cm.uncond_embed.detach()).all(-1).all(-1)
    assert _rate(int(dropped.sum()), n, p) <= 5
    _, _, c0 = _cont_pair(0.0)
    assert not (c0(embs, train=True) == c0.uncond_embed.detach()).all(-1).any()


@pytest.mark.parametrize("freq", [256, 7])
def test_timestep_embedder_matches_jax(freq):
    """The table entrywise within 1e-6 + 6e-8 t: the frequencies are fp32
    `exp`s that XLA and torch may round 1 ulp apart, which moves t f by t
    ulps (3e-5 at t = 999). The MLP on JAX's own table within 1e-5 of the
    scale, and the whole embedder within that bound carried through it."""
    jm = je.TimestepEmbedder(hidden_size=32, frequency_embedding_size=freq)
    t = np.array([0.0, 1.0, 10.5, 999.0], np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(t))["params"])
    tm = te.TimestepEmbedder(32, freq)
    tm.load_state_dict(embedder_state_dict_from_jax(params, tm), strict=True)
    table = te.TimestepEmbedder.timestep_embedding(torch.from_numpy(t), freq).numpy()
    want_table = np.asarray(je.TimestepEmbedder.timestep_embedding(jnp.asarray(t), freq))
    assert table.shape == (4, freq) and table.dtype == np.float32
    bound = 1e-6 + 6e-8 * t[:, None]
    assert np.all(np.abs(table - want_table) <= bound)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(t)))
    with torch.no_grad():
        mlp = tm.mlp_2(torch.nn.functional.silu(tm.mlp_0(torch.from_numpy(want_table)))).numpy()
        got = tm(torch.from_numpy(t)).numpy()
    assert _rel(mlp, want) <= 1e-5
    w0 = np.abs(np.asarray(params["mlp_0"]["kernel"])).sum(0).max()
    w2 = np.abs(np.asarray(params["mlp_2"]["kernel"])).sum(0).max()
    carried = 1.1 * w0 * w2 * bound.max(-1)  # silu is 1.1-Lipschitz
    assert np.all(np.abs(got - want).max(-1) <= carried + 1e-5 * np.abs(want).max())
