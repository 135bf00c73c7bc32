"""JEDi and MILO in the port against the JAX package, on the CPU.

JEDi: `polynomial_mmd` equal to JAX's (fp64 on both sides) and its
empty-side refusal; the V-JEPA2 extractor with a tiny teacher (2 layers of
64, 4 heads, `img_size` 32, 4 frames, its last tap after layer 1) from one
`.npz` of JAX-initialised weights, on clips of 2 frames at 24 x 24 (the
resize and the frame pad both run), within 1e-5 of the features' scale;
`JEDiCalculator` against the JAX one.

MILO: a seeded torch init under the reference's `MILO.pth` keys, into JAX
through the JAX package's `load_torch_milo_state_dict` and back through
`utils/convert.milo_state_dict_from_jax` unchanged, loaded strictly by
`MILOCalculator`; per-sample scores
at 32 x 32 and at 36 x 44 (odd pyramid levels, the replicate pad) within
1e-6; identical inputs score 0; the reference's swapped `mask_generator`
call is kept; no weights, no score.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (each worker's share of the cores)
from video_tokenizer_tpu.metrics import jedi as jjedi
from video_tokenizer_tpu.metrics.milo import MILO as JaxMILO, load_torch_milo_state_dict
from video_tokenizer_tpu.models.vfm import VJEPA2TeacherViT as JaxTeacher
from video_tokenizer_tpu_torch.metrics import jedi as tjedi
from video_tokenizer_tpu_torch.metrics import milo as tmilo
from video_tokenizer_tpu_torch.utils.convert import milo_state_dict_from_jax

TEACHER = dict(embed_dim=64, depth=2, num_heads=4, img_size=32, num_frames=4, out_layers=(1,))
MILO_KEYS = sorted([f"mask_finder_1.netBasic.{i}.{p}" for i in (0, 2, 4, 6, 8)
                    for p in ("weight", "bias")]
                   + [f"scaler_network.model.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")])


def test_polynomial_mmd_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(7, 24)), rng.normal(0.3, 1.2, size=(5, 24)).astype(np.float32)
    for degree in (2, 3):
        got, want = tjedi.polynomial_mmd(a, b, degree), jjedi.polynomial_mmd(a, b, degree)
        assert abs(got - want) <= 1e-12 * abs(want)
    assert tjedi.polynomial_mmd(a, a) == 0.0
    for x, y in ((a[:0], b), (a, b[:0])):
        with pytest.raises(ValueError, match="at least one sample on each side"):
            tjedi.polynomial_mmd(x, y)


@pytest.fixture(scope="module")
def teacher_npz(tmp_path_factory):
    teacher = JaxTeacher(**TEACHER)
    variables = teacher.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 4, 32, 32)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    path = tmp_path_factory.mktemp("jedi") / "vjepa2.npz"
    np.savez(path, params=np.asarray(params, dtype=object))
    return str(path)


def test_vjepa_extractor_and_jedi_match_jax(teacher_npz):
    port, port_pre = tjedi.make_vjepa_extractor(teacher_npz, device="cpu", **TEACHER)
    ref, ref_pre = jjedi.make_vjepa_extractor(teacher_npz, **TEACHER)
    assert port_pre and ref_pre
    rng = np.random.default_rng(1)
    # 2 frames at 24 x 24: resized to 32 and padded to 4 frames; values past
    # [0, 1] are clipped first
    clips = [rng.uniform(-0.1, 1.1, (3, 3, 2, 24, 24)).astype(np.float32) for _ in range(2)]
    for c in clips:
        got, want = port(torch.from_numpy(c)), np.asarray(ref(c))
        assert got.shape == want.shape == (3, 64) and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    ours, theirs = tjedi.JEDiCalculator(port), jjedi.JEDiCalculator(ref)
    for calc in (ours, theirs):
        with pytest.raises(ValueError, match="before update"):
            calc.compute()
        calc.update(gen_videos=clips[0], real_videos=clips[1])
    assert abs(ours.compute() - theirs.compute()) <= 1e-4 * abs(theirs.compute())


def test_vjepa_extractor_refuses_a_tree_of_another_teacher(teacher_npz):
    with pytest.raises(ValueError, match="differ"):
        tjedi.make_vjepa_extractor(teacher_npz, device="cpu", **dict(TEACHER, depth=3))


@pytest.fixture(scope="module")
def milo_weights(tmp_path_factory):
    """(JAX MILO params, a `.pth` under the reference's keys). A seeded
    torch init under those keys goes to JAX through the JAX package's own
    `load_torch_milo_state_dict` and comes back through the port's
    converter unchanged. (A Flax init has no `scaler_network`: the forward
    never calls it.)"""
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in tmilo.MILO().state_dict().items()}
    assert sorted(sd) == MILO_KEYS
    params = load_torch_milo_state_dict(sd)["params"]
    back = milo_state_dict_from_jax(params)
    assert sorted(back) == MILO_KEYS and all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)
    path = tmp_path_factory.mktemp("milo") / "MILO.pth"
    torch.save(back, path)
    return params, str(path)


def _frames(seed, shape):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, shape).astype(np.float32)


@pytest.mark.parametrize("size", [(32, 32), (36, 44)])
def test_milo_scores_match_jax(milo_weights, size):
    params, path = milo_weights
    calc = tmilo.MILOCalculator(path, device="cpu")
    y, x = _frames(2, (3, 3, *size)), _frames(3, (3, 3, *size))
    got = calc(y, x)
    want = np.asarray(JaxMILO().apply({"params": params}, y, x))
    assert got.shape == (3,) and np.abs(got - want).max() <= 1e-6
    assert np.abs(calc(x, x)).max() == 0.0


def test_milo_keeps_the_swapped_mask_arguments(milo_weights):
    """The reference's forward calls `mask_generator(x, y)` against the (y =
    distorted, x = reference) signature. The port keeps the swap: its score
    is the swapped mask's, and the mask of the signature's order scores
    otherwise."""
    params, path = milo_weights
    model = tmilo.MILOCalculator(path, device="cpu").model
    y, x = (torch.from_numpy(_frames(s, (2, 3, 32, 32))) for s in (4, 5))
    y01, x01 = (y.clamp(-1, 1) + 1) / 2, (x.clamp(-1, 1) + 1) / 2
    with torch.no_grad():
        score = model(y, x)
        swapped = (model.mask_generator(x01, y01) * (x01 - y01).abs()).mean(dim=(1, 2, 3))
        signature = (model.mask_generator(y01, x01) * (x01 - y01).abs()).mean(dim=(1, 2, 3))
    assert torch.equal(score, swapped)
    assert (score - signature).abs().max() > 1e-4
    want = np.asarray(JaxMILO().apply({"params": params}, y.numpy(), x.numpy()))
    assert np.abs(score.numpy() - want).max() <= 1e-6


def test_milo_calculator_refuses_without_weights():
    calc = tmilo.MILOCalculator(device="cpu")
    assert not calc.pretrained
    with pytest.raises(RuntimeError, match="MILO weights are not available"):
        calc(_frames(0, (1, 3, 16, 16)), _frames(1, (1, 3, 16, 16)))


def test_milo_converter_refuses_a_missing_or_an_extra_key(milo_weights):
    params, _ = milo_weights
    missing = {k: dict(v) for k, v in params.items()}
    del missing["mask_finder_1"]["conv4"]
    with pytest.raises(ValueError, match="netBasic.8"):
        milo_state_dict_from_jax(missing)
    extra = {k: dict(v) for k, v in params.items()}
    extra["scaler_network"]["conv3"] = extra["scaler_network"]["conv2"]
    with pytest.raises(ValueError, match="model.6"):
        milo_state_dict_from_jax(extra)
