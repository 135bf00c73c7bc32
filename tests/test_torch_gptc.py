"""The gptc prior of the port (`models/gptc.py`) and the LARP tokenizer that co-trains it, on the CPU.

Held against the JAX package's `models/gptc.py` and `LARPTokenizer`, the
same weights on both sides (the JAX init, perturbed, through
`gptc_state_dict_from_jax` / `state_dict_from_jax`), fp32:
  * a 2-layer GPTC's forward (prediction and MSE, 1e-5) with ragged S;
  * `compute_prior_loss` with `detach_x` both ways, its value (1e-6
    relative) and its gradients in every parameter and in the input (1e-4 of
    each tensor's max |g|; the key biases, whose gradient is 0 in exact
    arithmetic, 1e-6 of the largest gradient);
  * `ar_predict` (1e-5); dropout by its rate and its generator (the JAX
    module's draws cannot match);
  * `decode_step`, prefilled with 6 rows and then 4 single steps, against
    the full forward of the port (1e-5) and JAX's `decode_step` (1e-5);
  * the parameter count of gptc-S at the LARP recipe's n_ind 8 and
    max_seq_len 1024 equal to the JAX init's, and the zoo's registrations
    (layers, heads, width) equal;
  * the tiny tokenizer of `tests/_torch_port.py` with a 1- and a 2-layer
    gptc: `loss_latent_ce` (1e-5 relative), the VQ indices equal, and the
    gradients of `loss_latent_ce` in the encoder, the bottleneck and the
    prior (1e-4 of each tensor's max |g|), the encoder's through the VQ's
    straight-through path; fsq and sq with a prior stay refused;
  * the recipe's full width (cfgs/larp_tokenizer.yaml with
    scripts/train_larp_tokenizer.sh's flags: gptc-S, the 512/8/12
    discriminator): the tokenizer's and the loss module's parameter counts
    equal to the JAX init's (`jax.eval_shape`, meta device here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY_ARGS, clips, f32, jax_tokenizer, perturb, port_tokenizer

import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.registry import models as jmodels
from video_tokenizer_tpu_torch.config import load_config
from video_tokenizer_tpu_torch.models import LARPTokenizer
from video_tokenizer_tpu_torch.models import gptc as tgptc
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import gptc_state_dict_from_jax

TINY_GPTC = dict(n_layer=2, n_head=2, n_embd=64, n_ind=8, max_seq_len=16,
                 embd_pdrop=0.0, resid_pdrop=0.0)


def _pair(**over):
    """(JAX GPTC, its perturbed numpy params, the port's GPTC with them)."""
    args = {**TINY_GPTC, **over}
    jm = jmodels.make({"name": "gptc", "args": args})
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, args["n_ind"])))["params"]
    params = perturb(params, seed=3)
    tm = tmodels.make({"name": "gptc", "args": args})
    tm.load_state_dict(gptc_state_dict_from_jax(params), strict=True)
    return jm, params, tm


def _latents(B=2, S=13, d=8, seed=0):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def _rel(got, want):
    return np.abs(f32(got) - np.asarray(want, np.float32)).max() / max(
        np.abs(np.asarray(want, np.float32)).max(), 1e-30)


def test_forward_matches_jax():
    jm, params, tm = _pair()
    x = _latents(S=13)  # ragged: no multiple of any tile
    tgt = _latents(S=13, seed=1)
    pred, loss = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(tgt))
    with torch.no_grad():
        tpred, tloss = tm(torch.from_numpy(x), torch.from_numpy(tgt))
    np.testing.assert_allclose(f32(tpred), np.asarray(pred), atol=1e-5)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)


@pytest.mark.parametrize("detach_x", [False, True])
def test_compute_prior_loss_and_gradients_match_jax(detach_x):
    jm, params, tm = _pair(detach_x=detach_x)
    x = _latents(S=16)

    def jloss(p, xx):
        return jm.apply({"params": p}, xx, method=jm.compute_prior_loss)

    want, (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm.compute_prior_loss(xt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    if detach_x:  # only the detached target and input: no gradient reaches x
        assert xt.grad is None or not xt.grad.abs().max()
        assert not np.abs(np.asarray(gx)).max()
    else:
        assert _rel(xt.grad, gx) <= 1e-4
    _check_grads(dict(tm.named_parameters()), gptc_state_dict_from_jax(jax.device_get(gp)))


def _check_grads(named, want_g, names=None):
    """Each gradient within 1e-4 of its tensor's max |g|; a key projection's
    bias, whose gradient is 0 in exact arithmetic (softmax is shift
    invariant), within 1e-6 of the largest gradient of all."""
    names = list(named) if names is None else names
    top = max(np.abs(want_g[n].numpy()).max() for n in names)
    for name in names:
        g = named[name].grad
        assert g is not None, name
        if name.endswith("key.bias"):
            assert np.abs(f32(g)).max() <= 1e-6 * top, name
        else:
            assert _rel(g, want_g[name].numpy()) <= 1e-4, name


def test_ar_predict_matches_jax():
    jm, params, tm = _pair()
    x = _latents(S=10)
    want = jm.apply({"params": params}, jnp.asarray(x), method=jm.ar_predict)
    with torch.no_grad():
        got = tm.ar_predict(torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), np.asarray(want), atol=1e-5)


def test_decode_step_matches_the_full_forward_and_jax():
    jm, params, tm = _pair()
    x = _latents(S=10)
    with torch.no_grad():
        full, _ = tm(torch.from_numpy(x))
    jcache = jm.apply({"params": params}, 2, 16, method=jm.init_cache)
    cache = tm.init_cache(2, 16)
    spans = [(0, 6)] + [(t, t + 1) for t in range(6, 10)]
    for a, b in spans:
        jpred, jcache = jm.apply({"params": params}, jnp.asarray(x[:, a:b]), a, jcache,
                                 method=jm.decode_step)
        with torch.no_grad():
            pred, cache = tm.decode_step(torch.from_numpy(x[:, a:b]), a, cache)
        np.testing.assert_allclose(f32(pred), f32(full[:, a:b]), atol=1e-5, err_msg=f"{a}:{b}")
        np.testing.assert_allclose(f32(pred), np.asarray(jpred), atol=1e-5, err_msg=f"{a}:{b}")
    np.testing.assert_allclose(f32(cache[1]["k"]), np.asarray(jcache[1]["k"]), atol=1e-5)


def _n_params(tree):
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))


def test_gptc_s_parameter_count_equals_jax_init():
    """gptc-S as the LARP recipe builds it (n_ind 8, max_seq_len 1024)."""
    args = {"n_ind": 8, "max_seq_len": 1024}
    jm = jmodels.make({"name": "gptc-S", "args": args})
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 4, 8))))["params"]
    with torch.device("meta"):
        tm = tmodels.make({"name": "gptc-S", "args": args})
    n = sum(p.numel() for p in tm.parameters())
    assert n == _n_params(shapes) == 21_694_088


@pytest.mark.parametrize("name", ["gptc-L", "gptc-B", "gptc-M", "gptc-S", "gptc-XS", "gptc-XXS"])
def test_zoo_registrations_equal_jax(name):
    args = {"n_ind": 8, "max_seq_len": 16}
    jc = jmodels.make({"name": name, "args": args}).config
    with torch.device("meta"):
        tc = tmodels.make({"name": name, "args": args}).config
    assert (tc.n_layer, tc.n_head, tc.n_embd) == (jc.n_layer, jc.n_head, jc.n_embd)
    assert tgptc.GPTCConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__}) == tc


def test_dropout_draws_from_the_modules_generator():
    """`embd_pdrop` / `resid_pdrop` as Flax's dropout (keep 1 - p, scale
    1 / (1 - p); the mask fraction within 0.01 of p over 40,000 draws), the
    masks from `dropout_generator`, so a restored state redraws them; eval
    applies none. The tokenizer builds its prior without dropout unless
    `no_dropout: false` (then the JAX defaults, 0.1)."""
    x = torch.ones(200, 200)
    y = tgptc._dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert abs((y == 0).float().mean().item() - 0.3) <= 0.01
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))
    tm = tmodels.make({"name": "gptc", "args": {**TINY_GPTC, "embd_pdrop": 0.2,
                                                "resid_pdrop": 0.2}},
                      args={"generator": torch.Generator().manual_seed(1)})
    xs = torch.from_numpy(_latents(S=10))
    state = tm.dropout_generator.get_state()
    with torch.no_grad():
        a, b = tm(xs, train=True)[0], tm(xs, train=True)[0]
        tm.dropout_generator.set_state(state)
        again, plain = tm(xs, train=True)[0], tm(xs)[0]
    assert not torch.equal(a, b) and torch.equal(a, again) and not torch.equal(a, plain)
    prior = {"name": "gptc", "args": {"n_layer": 1, "n_head": 2, "n_embd": 32}}
    for flag, p in ((None, 0.0), (False, 0.1)):
        spec = prior if flag is None else {**prior, "no_dropout": flag}
        cfg = LARPTokenizer(**{**TINY_ARGS, "prior_model": spec}).prior.config
        assert (cfg.embd_pdrop, cfg.resid_pdrop, cfg.attn_pdrop) == (p, p, p)


# ------------------------------------------------------ the co-trained prior


def _tokenizer_pair(n_layer):
    prior = {"name": "gptc", "args": {"n_layer": n_layer, "n_head": 2, "n_embd": 32}}
    jm, params = jax_tokenizer(prior_model=prior)
    tm = port_tokenizer(params, prior_model=prior).train()  # the prior's loss in training mode
    return jm, params, tm


@pytest.mark.parametrize("n_layer", [1, 2])
def test_loss_latent_ce_and_its_gradients_match_jax(n_layer):
    """`loss_latent_ce` of the tokenizer's forward (deterministic VQ: the
    eval-mode draw, train=False) and its gradient in the encoder (through
    the straight-through estimator), the bottleneck and the prior."""
    jm, params, tm = _tokenizer_pair(n_layer)
    x = clips(5)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=False)
        return out["loss_latent_ce"], out["bottleneck_rep"]

    (want, want_rep), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tm(torch.from_numpy(x), train=False)
    np.testing.assert_array_equal(out["bottleneck_rep"].numpy(), np.asarray(want_rep))
    np.testing.assert_allclose(float(out["loss_latent_ce"].detach()), float(want), rtol=1e-5)
    out["loss_latent_ce"].backward()
    from video_tokenizer_tpu_torch.utils.convert import state_dict_from_jax

    want_g = state_dict_from_jax(jax.device_get(grads), tm)
    named = dict(tm.named_parameters())
    checked = [n for n in named if n.startswith(("prior.", "encoder.blocks.", "bottleneck."))]
    assert any(n.startswith("encoder.") for n in checked) and any(n.startswith("prior.")
                                                                   for n in checked)
    # no path from the codebook (straight-through) or the out-projection (after
    # the prior's input) to the loss
    idle = ("bottleneck.regularizer.embedding.weight", "bottleneck.out_linear.weight",
            "bottleneck.out_linear.bias")
    for name in idle:
        assert named[name].grad is None or not named[name].grad.abs().max(), name
    _check_grads(named, want_g, [n for n in checked if n not in idle])


def test_eval_mode_skips_the_prior():
    """A model in eval mode (as the loaders return it) leaves out the loss
    that nothing at inference reads; in training mode `train=False` keeps
    it (the trainer's eval)."""
    _, _, tm = _tokenizer_pair(1)
    x = torch.from_numpy(clips(2))
    with torch.no_grad():
        assert "loss_latent_ce" in tm(x, train=False)
        tm.eval()
        assert "loss_latent_ce" not in tm(x, train=False)
        assert "loss_latent_ce" not in tm.encode_eval(x)


@pytest.mark.parametrize("kind", ["fsq", "sq"])
def test_prior_with_another_bottleneck_is_refused(kind):
    with pytest.raises(ValueError, match="requires bottleneck_type 'vq'"):
        tmodels.make({"name": "larp_tokenizer", "args": {
            **TINY_ARGS, "bottleneck_type": kind, "sq_n_embed": 64,
            "prior_model": {"name": "gptc-XXS"}}})


# the recipe's flags (scripts/train_larp_tokenizer.sh) that change the models
RECIPE_OPTS = ["model.args.prior_model.name", "gptc-S", "loss.args.disc_tran_hidden_size", "512",
               "loss.args.disc_tran_n_heads", "8", "loss.args.disc_tran_n_layers", "12"]


def test_recipe_parameter_counts_equal_jax_init():
    cfg = load_config("cfgs/larp_tokenizer.yaml", {"input_size": 128, "frame_num": 16},
                      RECIPE_OPTS)
    model_spec, loss_spec = cfg.model.to_dict(), cfg.loss.to_dict()
    with torch.device("meta"):
        tm = tmodels.make(model_spec)
        tl = tmodels.make(loss_spec)
    jm = jmodels.make(model_spec)
    jl = jmodels.make(loss_spec)
    x = jnp.zeros((1, 3, 16, 128, 128))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "vq": jax.random.PRNGKey(1)}, x))["params"]
    lshapes = jax.eval_shape(lambda: jl.init({"params": jax.random.PRNGKey(0),
                                              "gan": jax.random.PRNGKey(1)}, x, x,
                                             method="initialize"))["params"]
    n_prior = sum(p.numel() for p in tm.prior.parameters())
    assert n_prior == _n_params(shapes["prior"]) == 21_694_088
    assert sum(p.numel() for p in tm.parameters()) == _n_params(shapes)
    n_disc = sum(p.numel() for p in tl.discriminator.parameters())
    assert n_disc == _n_params(lshapes["discriminator"])
    assert len(tl.discriminator.transformer_encoder.blocks) == 12
