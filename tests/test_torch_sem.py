"""The port's semantic-alignment utilities and `larp_tokenizer_sem` (`models/sem.py`) against JAX.

On the CPU, fp32 on both sides, seeded numpy inputs; the k-means draws are
JAX's own (`jax.random.randint` of the key the JAX module splits) handed to
the port. Held:
  * `SoftKMeans` (values and the gradient of a fixed weighting of the
    prototypes) within 1e-5 of their scale;
  * `gram_matrix`, `pca_subspace_basis` (as the projector B B^T: the basis is
    defined up to the signs of the singular vectors),
    `subspace_alignment_loss` with and without a degenerate (constant)
    sample, whose gradient stays finite and which the mean leaves out,
    `off_diagonal`, `vicreg_pooled_loss` and its three terms: values within
    1e-5, gradients within 1e-4 of their scale (SVD gradients summed in
    other orders);
  * `VJepaAlignerV3`: loss and `gram_loss` at its default temperature and
    at 4, the gradients of the student's input and projection at 4;
  * `larp_tokenizer_sem` in train mode: `align_loss` (0.5 x the aligner's),
    `gram_loss`, the reconstruction and the tokenizer's outputs, and in eval
    mode no teacher. The whole model runs at k-means temperature 4: at 0.2
    the sharp soft assignments amplify 1e-7 differences of their inputs to
    1e-3 of `gram_loss`, between the JAX module jitted and eager as much as
    against the port;
  * the port's own draws from `sample_generator`, and the full-width count
    through `cfgs/larp_tokenizer.yaml` (the JAX init's, by `jax.eval_shape`).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (this test worker's share of the cores)
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.models import sem as js
from video_tokenizer_tpu.registry import models as jmodels
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.models import sem as ts
from video_tokenizer_tpu_torch.registry import models as tmodels
from video_tokenizer_tpu_torch.utils.convert import flax_tree_state_dict, sem_state_dict_from_jax


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def test_soft_kmeans_matches_jax():
    rng = np.random.RandomState(0)
    B, N, D, K = 2, 40, 8, 6
    x, w = rng.randn(B, N, D).astype(np.float32), rng.randn(B, K, D).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jk = js.SoftKMeans(num_prototypes=K, iters=5, temp=0.5)
    want = jk.apply({}, jnp.asarray(x), key)
    g_want = jax.grad(lambda x: jnp.sum(jk.apply({}, x, key) * w))(jnp.asarray(x))
    idx = torch.from_numpy(np.array(jax.random.randint(key, (B, K), 0, N)))
    xt = _t(x, grad=True)
    got = ts.SoftKMeans(K, 5, 0.5)(xt, idx)
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(got.detach().numpy(), want) <= 1e-5
    assert _rel(xt.grad.numpy(), g_want) <= 1e-5


@pytest.mark.parametrize("normalize", [True, False])
def test_gram_matrix_matches_jax(normalize):
    x = np.random.RandomState(1).randn(2, 7, 5).astype(np.float32)
    w = np.random.RandomState(2).randn(2, 7, 7).astype(np.float32)
    want = js.gram_matrix(jnp.asarray(x), normalize)
    g_want = jax.grad(lambda x: jnp.sum(js.gram_matrix(x, normalize) * w))(jnp.asarray(x))
    xt = _t(x, grad=True)
    got = ts.gram_matrix(xt, normalize)
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(got.detach().numpy(), want) <= 1e-5 and _rel(xt.grad.numpy(), g_want) <= 1e-5


def test_pca_subspace_basis_spans_the_jax_subspace():
    x = np.random.RandomState(3).randn(3, 12, 10).astype(np.float32)
    want = np.asarray(js.pca_subspace_basis(jnp.asarray(x), r=4))
    got = ts.pca_subspace_basis(torch.from_numpy(x), r=4).numpy()
    assert got.shape == want.shape == (3, 10, 4)
    proj = lambda b: np.einsum("bdr,ber->bde", b, b)  # noqa: E731
    np.testing.assert_allclose(proj(got), proj(want), atol=1e-5)
    np.testing.assert_allclose(np.einsum("bdr,bds->brs", got, got),
                               np.eye(4)[None].repeat(3, 0), atol=1e-5)


@pytest.mark.parametrize("degenerate", [False, True], ids=["ok", "with_constant_sample"])
def test_subspace_alignment_loss_matches_jax(degenerate):
    rng = np.random.RandomState(4)
    u, v = rng.randn(3, 12, 10).astype(np.float32), rng.randn(3, 12, 10).astype(np.float32)
    if degenerate:  # a clip of black padding frames: one token repeated
        u[1] = 0.5
    loss_fn = lambda u, v: js.subspace_alignment_loss(u, v, r=4)  # noqa: E731
    want = loss_fn(jnp.asarray(u), jnp.asarray(v))
    gu, gv = jax.grad(loss_fn, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    ut, vt = _t(u, grad=True), _t(v, grad=True)
    got = ts.subspace_alignment_loss(ut, vt, r=4)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    for g, w in ((ut.grad, gu), (vt.grad, gv)):
        assert torch.isfinite(g).all()
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4 * max(np.abs(w).max(), 1e-6)
    if degenerate:  # the mean is over the two samples that vary, the constant one gets 0
        assert ut.grad[1].abs().max().item() == 0.0
        keep = ts.subspace_alignment_loss(ut[[0, 2]], vt[[0, 2]], r=4)
        assert abs(keep.item() - got.item()) <= 1e-5


def test_degenerate_dummy_and_off_diagonal():
    np.testing.assert_array_equal(ts._degenerate_dummy(5, 3).numpy(),
                                  np.asarray(js._degenerate_dummy(5, 3)))
    m = np.arange(16, dtype=np.float32).reshape(4, 4)
    np.testing.assert_array_equal(ts.off_diagonal(torch.from_numpy(m)).numpy(),
                                  np.asarray(js.off_diagonal(jnp.asarray(m))))


def test_vicreg_pooled_loss_matches_jax():
    rng = np.random.RandomState(5)
    s, t = rng.randn(4, 6, 8).astype(np.float32), 0.3 * rng.randn(4, 6, 8).astype(np.float32)
    (want, info), (gs, gt) = (js.vicreg_pooled_loss(jnp.asarray(s), jnp.asarray(t)),
                              jax.grad(lambda s, t: js.vicreg_pooled_loss(s, t)[0],
                                       argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t)))
    st, tt = _t(s, grad=True), _t(t, grad=True)
    got, got_info = ts.vicreg_pooled_loss(st, tt)
    got.backward()
    assert _rel(got.item(), want) <= 1e-5
    for k in ("vic_sim", "vic_var", "vic_cov"):
        assert _rel(got_info[k].item(), info[k]) <= 1e-5, k
    assert _rel(st.grad.numpy(), gs) <= 1e-5 and _rel(tt.grad.numpy(), gt) <= 1e-5


def _draws(key, B, K, n_student, n_teacher):
    r1, r2 = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.randint(r1, (B, K), 0, n_student))),
            torch.from_numpy(np.array(jax.random.randint(r2, (B, K), 0, n_teacher))))


@pytest.mark.parametrize("temp", [0.2, 4.0])
def test_aligner_matches_jax(temp):
    """The teacher grid (4, 4, 4) resized to the student's (2, 4, 4) by the
    antialiased trilinear resize. The gradients at temperature 4 only: at the
    default 0.2 the soft assignments are nearly hard, and an input near a
    switch moves its gradient by ~2e-2 of the scale between fp32 orders of
    summation (the values still agree within 1e-5)."""
    rng = np.random.RandomState(6)
    B, K = 2, 8
    sq, tf = rng.randn(B, 32, 64).astype(np.float32), rng.randn(B, 64, 48).astype(np.float32)
    ja = js.VJepaAlignerV3(student_dim=64, teacher_dim=48, student_grid=(2, 4, 4),
                           common_dim=32, num_prototypes=K, kmeans_temp=temp, gram_weight=2.0)
    key = jax.random.PRNGKey(7)
    params = jax.tree_util.tree_map(np.asarray, ja.init(
        jax.random.PRNGKey(0), jnp.asarray(sq), jnp.asarray(tf), (4, 4, 4), key)["params"])

    def loss(p, sq):
        return ja.apply({"params": p}, sq, jnp.asarray(tf), (4, 4, 4), key)

    (want, info), (gp, gq) = loss(params, jnp.asarray(sq)), jax.grad(
        lambda p, q: loss(p, q)[0], argnums=(0, 1))(params, jnp.asarray(sq))
    ta = ts.VJepaAlignerV3(64, 48, (2, 4, 4), 32, K, kmeans_temp=temp, gram_weight=2.0)
    ta.load_state_dict(flax_tree_state_dict(params), strict=True)
    sqt = _t(sq, grad=True)
    got, got_info = ta(sqt, torch.from_numpy(tf), (4, 4, 4), _draws(key, B, K, 32, 32))
    got.backward()
    assert _rel(got.item(), want) <= 1e-5 and _rel(got_info["gram_loss"].item(), info["gram_loss"]) <= 1e-5
    if temp < 1:
        return
    assert _rel(sqt.grad.numpy(), gq) <= 1e-4
    want_g = flax_tree_state_dict(jax.tree_util.tree_map(np.asarray, gp))
    for n, p in ta.named_parameters():
        if n.startswith("student_proj."):
            assert _rel(p.grad.numpy(), want_g[n].numpy()) <= 1e-4, n
        else:  # the teacher's projection sees only the detached teacher grid
            assert p.grad is None or p.grad.abs().max().item() == 0.0, n


TOK = dict(
    bottleneck={"name": "bottleneck", "args": {"bottleneck_dim": 8, "norm": "none", "regularizer": {
        "name": "vq", "args": {"codebook_size": 64, "l2_normalized": True, "stochastic": False}}}},
    prior_model={"name": "none"}, bottleneck_token_num=16, input_size=32, frame_num=8,
    temporal_patch_size=4, patch_size=8, encoder_hidden_size=64, decoder_hidden_size=64,
    encoder_num_heads=2, decoder_num_heads=2, encoder_depth=1, decoder_depth=1)
SEM = dict(teacher_dim=128, teacher_depth=2, teacher_heads=2, vjepa2_img_size=32,
           vjepa2_num_frames=8, latent_grid_shape=(2, 2, 4), align_common_dim=32,
           align_num_prototypes=4, align_kmeans_temp=4.0)


def _draw(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        noise = rng.randn(*shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * noise
        if name == "bias":
            return 0.02 * noise
        return noise / np.float32(math.sqrt(np.prod(shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_sem_train_forward_matches_jax():
    jm = jmodels.make({"name": "larp_tokenizer_sem", "args": {**TOK, **SEM}})
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 3, 8, 32, 32)), train=True))
    params = jax.tree_util.tree_map(np.asarray, _draw(shapes["params"], 1))
    x = np.random.RandomState(8).rand(2, 3, 8, 32, 32).astype(np.float32)
    apply = jax.jit(lambda p, x, train: jm.apply({"params": p}, x, train=train),
                    static_argnums=2)
    want, want_eval = apply(params, jnp.asarray(x), True), apply(params, jnp.asarray(x), False)
    tm = tmodels.make({"name": "larp_tokenizer_sem", "args": {**TOK, **SEM}})
    tm.load_state_dict(sem_state_dict_from_jax(params, tm), strict=True)
    assert not any(p.requires_grad for p in tm.teacher_model.parameters())
    assert (tm.frame_num, tm.input_size, tm.bottleneck_token_num, tm.codebook_size) == (8, 32, 16, 64)
    # with no rng stream the JAX module draws from PRNGKey(0), split in two
    draws = _draws(jax.random.PRNGKey(0), 2, 4, 16, 16)
    out = tm(torch.from_numpy(x), train=True, kmeans_draws=draws)
    assert set(out) == set(want), set(out) ^ set(want)
    assert _rel(out["pred_frames"].detach().numpy(), want["pred_frames"]) <= 1e-5
    for k in ("align_loss", "gram_loss", "loss_q"):
        assert _rel(out[k].item(), want[k]) <= 1e-5, k
    assert abs(out["align_loss"].item() - 0.5 * SEM.get("align_gram_weight", 1.0)
               * out["gram_loss"].item()) <= 1e-7
    np.testing.assert_array_equal(out["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    with torch.no_grad():
        out_eval = tm(torch.from_numpy(x), train=False)
    assert "align_loss" not in out_eval and "align_loss" not in want_eval
    assert _rel(out_eval["pred_frames"].numpy(), want_eval["pred_frames"]) <= 1e-5
    # the port's own draws: the model's generator, fresh each step
    a = tm(torch.from_numpy(x), train=True)["gram_loss"].item()
    b = tm(torch.from_numpy(x), train=True)["gram_loss"].item()
    tm.sample_generator.manual_seed(5)
    c = tm(torch.from_numpy(x), train=True)["gram_loss"].item()
    tm.sample_generator.manual_seed(5)
    assert tm(torch.from_numpy(x), train=True)["gram_loss"].item() == c and a != b


def test_sem_full_width_count():
    """Through the flagship cfg: the LARP tokenizer, an 8-layer 1024-wide
    teacher (head dim 64) and the aligner: the JAX init's count."""
    from video_tokenizer_tpu_torch.config import load_config

    cfg = load_config("cfgs/larp_tokenizer.yaml", {"input_size": 256, "frame_num": 16},
                      ["model.name", "larp_tokenizer_sem"])
    tm = tmodels.make(cfg.model.to_dict(), args={"device": "meta"})
    assert sum(p.numel() for p in tm.parameters()) == 275_037_704
    assert tm.teacher_model.embed_dim // tm.teacher_model.num_heads == 64
    jm = jmodels.make(cfg.model.to_dict())
    # train mode: the JAX module makes its teacher and aligner there only
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)},
        jnp.zeros((1, 3, 16, 256, 256)), train=True))
    assert sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"])) == 275_037_704
