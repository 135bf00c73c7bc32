"""The port's multi-device training (`video_tokenizer_tpu_torch/parallel/`) on
the CPU, against one process and against the JAX package.

The port's ranks are subprocesses over gloo, launched once per world size
(2 and 4) for the whole file (`_torch_parallel.run_ranks`: a `FileStore`
in a fresh directory, one thread each); every scenario runs in that launch
and the tests read its results. The one-process runs and the JAX package
(on its 8 virtual CPU devices, `tests/conftest.py`) run in the pytest
process. Held:
  * `MeshConfig.resolve` against the JAX one over a table with its errors;
    `batch_rows` with a ragged batch replicated; the global-batch draws;
    the fused-wqkv split (whole heads on each rank);
  * trainer steps at N ranks equal to one process at the same seed, with
    every dropout of the prior on (class, token, residual, FFN, DropPath):
    the data axis for the tiny AR prior (a ragged batch included) and the
    tiny tokenizer (its generator clipped by the global norm at 0.05, so the
    clip acts); `param_placement: fsdp` for both, with the sharded share of
    parameters, moments and EMAs per rank, and resumes across world sizes
    (N ranks' checkpoint at one process, one process's at N ranks); TP with
    sequence parallelism for both (`mesh_model 2`; `mesh_model 4` for the
    prior at 4 ranks); the ring (`mesh_seq`) for the prior, with and
    without remat; what `state_for_checkpoint` keeps (rank 0 only); remat
    under the ring with its backward on another thread. Parameters,
    EMAs and AdamW moments to 2e-6 + 1e-5 relative (reduction order: the
    sums over ranks and the split products round differently), the
    step's scalars to 1e-5 relative;
  * against the JAX package: a data-parallel AR trainer step (every dropout
    0) against the JAX trainer's (the tolerances of
    `test_torch_ar_trainer.py`: 1e-4 relative, 1e-3 lr); the TP loss and
    gradients with and without SP against `shard_params_tp` under
    `sequence_parallel` (`test_tp.py`'s 1e-5 relative loss and 1e-5
    absolute gradients); an FSDP AdamW step against `shard_params_fsdp` +
    optax (`test_fsdp.py`'s 1e-6 loss, 1e-5 parameters); ring attention's
    out and gradients, causal and not, against whole attention (2e-6 out,
    1e-5 gradients) and against `ring_attention_sharded` (`test_ring.py`'s
    2e-5 out, 5e-4 gradients), and the ambient routing with its
    fall-through for segment ids.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_parallel_worker as W
from _torch_parallel import result, run_ranks
from _torch_port import ar_batch, ar_trainer_cfg, f32, jax_ar, jax_ar_trainer, trainer_cfg, train_batch
from video_tokenizer_tpu.parallel import MeshConfig as JaxMeshConfig
from video_tokenizer_tpu.parallel import create_mesh as jax_create_mesh
from video_tokenizer_tpu.parallel import shard_batch as jax_shard_batch
from video_tokenizer_tpu_torch.parallel.mesh import (
    MeshConfig, batch_rows, draw_keep, draw_uniform, global_batch,
)
from video_tokenizer_tpu_torch.parallel.tp import merge_heads, split_heads
from video_tokenizer_tpu_torch.utils.convert import ar_state_dict_from_jax, state_dict_from_jax

WORLDS = (2, 4)
DROPOUTS = dict(token_dropout_p=0.2, resid_dropout_p=0.2, ffn_dropout_p=0.2,
                class_dropout_prob=0.3, drop_path_rate=0.2)
PARAM_ATOL, PARAM_RTOL, INFO_RTOL, INFO_ATOL = 2e-6, 1e-5, 1e-5, 1e-6
LR = 6e-4
TP_ARGS = dict(n_head=4, n_kv_head=2, dim=64, vocab_size=32, num_classes=5, max_seq_len=12)


def _batches(make, rows):
    return [{k: torch.from_numpy(v) for k, v in make(s, n).items()} for s, n in enumerate(rows)]


def _ar_cfg(save_dir, **over):
    cfg = ar_trainer_cfg(save_dir).to_dict()
    cfg["model"]["args"].update(DROPOUTS)
    cfg.update(over)
    return cfg


def _tok_cfg(save_dir, **over):
    cfg = trainer_cfg(save_dir, clip_grad_max_norm=0.05).to_dict()
    cfg["trainer"] = "larp_tokenizer_trainer"
    cfg.update(over)
    return cfg


FSDP = {"param_placement": "fsdp", "fsdp_min_size": 512}
AR_ROWS, TOK_ROWS = (8, 6), (4, 4)  # 6 rows at 4 ranks: a ragged batch, replicated


def _jobs(world, tmp):
    """(name, job, one-process twin) for `world` ranks. The twin's key names
    the one-process run the test compares with."""
    ar_b, tok_b = _batches(ar_batch, AR_ROWS), _batches(train_batch, TOK_ROWS)
    d = lambda name: str(tmp / f"w{world}" / name)  # noqa: E731
    jobs = [
        ("ar_dp", {"scenario": "trainer_steps", "cfg": _ar_cfg(d("ar_dp")), "batches": ar_b}, "ar"),
        ("ar_fsdp", {"scenario": "trainer_steps", "cfg": _ar_cfg(d("ar_fsdp"), **FSDP),
                     "batches": ar_b, "save_after": 1}, "ar"),
        ("ar_fsdp_resume", {"scenario": "trainer_steps", "resume": True,
                            "cfg": _ar_cfg(str(tmp / "one_ar"), **FSDP),
                            "batches": ar_b[1:]}, "ar"),
        ("ar_tp_sp", {"scenario": "trainer_steps", "batches": ar_b,
                      "cfg": _ar_cfg(d("ar_tp_sp"), mesh_model=2, sequence_parallel=True,
                                     **{"model.args.remat": True})}, "ar"),
        ("ar_seq", {"scenario": "trainer_steps", "batches": ar_b,
                    "cfg": _ar_cfg(d("ar_seq"), mesh_seq=world)}, "ar"),
        ("ar_seq_remat", {"scenario": "trainer_steps", "batches": ar_b,
                          "cfg": _ar_cfg(d("ar_seq_remat"), mesh_seq=world,
                                         **{"model.args.remat": True})}, "ar"),
        ("tok_dp", {"scenario": "trainer_steps", "cfg": _tok_cfg(d("tok_dp")), "batches": tok_b},
         "tok"),
        ("tok_fsdp", {"scenario": "trainer_steps", "cfg": _tok_cfg(d("tok_fsdp"), **FSDP),
                      "batches": tok_b, "save_after": 1}, "tok"),
        ("tok_tp_sp", {"scenario": "trainer_steps", "batches": tok_b,
                       "cfg": _tok_cfg(d("tok_tp_sp"), mesh_model=2, sequence_parallel=True)},
         "tok"),
    ]
    val = _ar_cfg(d("loader"))
    val["train_dataset"]["args"]["split"] = "val"  # seeded clips
    val["train_dataset"]["loader"]["batch_size"] = 8
    jobs.append(("loader", {"scenario": "loader", "cfg": val}, "ar"))
    jobs.append(("preempt", {"scenario": "preempt", "cfg": _ar_cfg(d("preempt"), **FSDP),
                             "batches": ar_b}, "ar"))
    # every rank on the model axis (data 1), with fsdp over what the data axis leaves
    jobs.append(("ar_tp_fsdp", {"scenario": "trainer_steps", "batches": ar_b,
                                "cfg": _ar_cfg(d("ar_tp_fsdp"), mesh_model=world, **FSDP)}, "ar"))
    for job in jobs:  # "model.args.x" keys set the prior's args
        cfg = job[1]["cfg"]
        for k in [k for k in cfg if k.startswith("model.args.")]:
            cfg["model"]["args"][k[len("model.args."):]] = cfg.pop(k)
    return jobs


def _one_process(cfg, batches, resume=False):
    cfg = copy.deepcopy(cfg)
    for k in ("mesh_model", "mesh_seq", "sequence_parallel", "param_placement", "fsdp_min_size"):
        cfg.pop(k, None)
    tr = W._trainer(cfg)
    if resume:
        assert tr.try_resume()
    infos = [W._step(tr, b) for b in batches]
    return tr, infos


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX references and their port inputs, and the one-process runs."""
    tmp = tmp_path_factory.mktemp("refs")
    out = {"tmp": tmp}
    # one process: the prior (saving after its first step, for the N-rank
    # resume) and the tokenizer
    ar_b, tok_b = _batches(ar_batch, AR_ROWS), _batches(train_batch, TOK_ROWS)
    ar_cfg = _ar_cfg(str(tmp / "one_ar"))
    tr = W._trainer(ar_cfg)
    out["ar_infos"] = [W._step(tr, ar_b[0])]
    tr.save_checkpoint("epoch-last")
    out["ar_infos"].append(W._step(tr, ar_b[1]))
    out["ar"] = tr.state_for_checkpoint()
    tr, out["tok_infos"] = _one_process(_tok_cfg(str(tmp / "one_tok")), tok_b)
    out["tok"] = tr.state_for_checkpoint()

    # the JAX AR trainer's data-parallel step, every dropout 0
    jcfg = ar_trainer_cfg(tmp / "jax")
    jtr = jax_ar_trainer(jcfg)
    ptr = W._trainer({**ar_trainer_cfg(tmp / "port").to_dict()})
    load = {"params": ar_state_dict_from_jax(jax.device_get(jtr.state["params"]), ptr.model),
            "vae": state_dict_from_jax(jax.device_get(jtr.vae_params), ptr.vae)}
    jb = ar_batch(7, 8)
    out["jax_dp_info"] = dict(zip(*[np.asarray(x).tolist() if i else x
                                   for i, x in enumerate(jtr.train_step(jax_shard_batch(jtr.mesh, jb)))]))
    out["jax_dp_params"] = ar_state_dict_from_jax(jax.device_get(jtr.state["params"]), ptr.model)
    out["jax_dp_job"] = {"scenario": "trainer_steps", "cfg": ar_trainer_cfg(tmp / "port_dp").to_dict(),
                         "batches": [{k: torch.from_numpy(v) for k, v in jb.items()}], "load": load}

    # the JAX TP loss and gradients (test_tp.py's step), with and without SP
    from video_tokenizer_tpu.parallel.tp import sequence_parallel, shard_params_tp
    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs

    model, params = jax_ar(**TP_ARGS)
    rng = np.random.RandomState(3)
    idx, tgt = rng.randint(0, 32, (4, 11)), rng.randint(0, 32, (4, 12))
    cond = np.array([0, 1, 2, 3])
    port = LARP_AR(ModelArgs(**{**_tiny_ar(), **TP_ARGS}))
    out["tp_state"] = ar_state_dict_from_jax(params, port)
    out["tp_inputs"] = tuple(torch.from_numpy(x) for x in (idx, cond, tgt))
    mesh = jax_create_mesh(JaxMeshConfig(data=4, model=2))
    p_tp = shard_params_tp(params, mesh)
    put = lambda x, spec: jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))  # noqa: E731
    args = (put(idx, P("data", None)), put(cond, P("data")), put(tgt, P("data", None)))

    def loss_fn(p, i, c, t):
        return model.apply({"params": p}, i, c, targets=t)[1]

    for sp in (False, True):
        step = jax.jit(jax.value_and_grad(loss_fn))
        if sp:
            with sequence_parallel(mesh):
                loss, g = step(p_tp, *args)
        else:
            loss, g = step(p_tp, *args)
        out[f"jax_tp_{sp}"] = (float(loss), ar_state_dict_from_jax(jax.device_get(g), port))
    # one process, the port, same weights
    port.load_state_dict(out["tp_state"], strict=True)
    _, loss = port(*out["tp_inputs"][:2], targets=out["tp_inputs"][2])
    loss.backward()
    out["port_tp_one"] = (float(loss), {n: p.grad.clone() for n, p in port.named_parameters()})

    # an FSDP AdamW step (test_fsdp.py): JAX shard_params_fsdp + optax.adamw
    from video_tokenizer_tpu.parallel.fsdp import shard_like_params, shard_params_fsdp

    fmodel, fparams = jax_ar(n_head=4, n_kv_head=2, dim=64, vocab_size=64, num_classes=5)
    fport = LARP_AR(ModelArgs(**{**_tiny_ar(), "n_head": 4, "n_kv_head": 2, "dim": 64,
                                 "vocab_size": 64, "num_classes": 5}))
    out["fsdp_state"] = ar_state_dict_from_jax(fparams, fport)
    fi, fc, ft = rng.randint(0, 64, (8, 15)), rng.randint(0, 5, 8), rng.randint(0, 64, (8, 16))
    out["fsdp_inputs"] = tuple(torch.from_numpy(x) for x in (fi, fc, ft))
    tx = optax.adamw(1e-3)
    fmesh = jax_create_mesh(JaxMeshConfig(data=8))
    p_sh = shard_params_fsdp(fparams, fmesh, min_size=512)
    o_sh = shard_like_params(tx.init(fparams), p_sh, fmesh)

    @jax.jit
    def fstep(p, o, i, c, t):
        loss, g = jax.value_and_grad(lambda q: fmodel.apply({"params": q}, i, c, targets=t)[1])(p)
        upd, o = tx.update(g, o, p)
        return optax.apply_updates(p, upd), loss, g

    fb = jax.device_put((jnp.asarray(fi), jnp.asarray(fc), jnp.asarray(ft)),
                        NamedSharding(fmesh, P("data")))
    p_new, floss, fg = fstep(p_sh, o_sh, *fb)
    out["jax_fsdp"] = (float(floss), ar_state_dict_from_jax(jax.device_get(p_new), fport),
                       ar_state_dict_from_jax(jax.device_get(fg), fport))

    # remat under the ring: a tiny prior with its dropouts, S = 16 (1 + 15)
    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR as PortAR

    rargs = {**_tiny_ar(), **DROPOUTS}
    rng = np.random.RandomState(4)
    out["ring_remat"] = {
        "args": rargs, "idx": torch.from_numpy(rng.randint(0, 64, (2, 15))),
        "cond": torch.from_numpy(rng.randint(0, 10, 2)),
        "tgt": torch.from_numpy(rng.randint(0, 64, (2, 16))),
        "state": PortAR(ModelArgs(**rargs), generator=torch.Generator().manual_seed(0)).state_dict()}

    # ring attention: JAX's ring over a (data, seq) mesh, and whole attention
    from video_tokenizer_tpu.parallel.ring import ring_attention_sharded

    qkv = [np.random.RandomState(10 + i).randn(2, 32, 2, 32).astype(np.float32) for i in range(3)]
    w = np.random.RandomState(20).randn(2, 32, 2, 32).astype(np.float32)
    out["ring_inputs"] = ([torch.from_numpy(x) for x in qkv], torch.from_numpy(w))
    for world in WORLDS:
        rmesh = jax_create_mesh(JaxMeshConfig(data=8 // world, seq=world))
        for causal in (False, True):
            def f(q, k, v):
                o = ring_attention_sharded(q, k, v, rmesh, "seq", causal=causal)
                return jnp.sum(o * w), o
            (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(*qkv)
            out[f"jax_ring_{world}_{causal}"] = (np.asarray(o), [np.asarray(x) for x in g])
    return out


def _tiny_ar():
    from _torch_port import TINY_AR

    return dict(TINY_AR)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, refs):
    world = request.param
    tmp = refs["tmp"]
    jobs = _jobs(world, tmp)
    extra = [
        ("jax_dp", refs["jax_dp_job"]),
        ("ring", {"scenario": "ring", "seq": world, "qkv": refs["ring_inputs"][0],
                  "w": refs["ring_inputs"][1]}),
        ("fsdp_model", {"scenario": "ar_model_fsdp", "min_size": 512, "state": refs["fsdp_state"],
                        "args": {**_tiny_ar(), "n_head": 4, "n_kv_head": 2, "dim": 64,
                                 "vocab_size": 64, "num_classes": 5},
                        **dict(zip(("idx", "cond", "tgt"), refs["fsdp_inputs"]))}),
    ]
    extra.append(("ring_remat", {"scenario": "ring_remat", "seq": world, **refs["ring_remat"]}))
    for sp in (False, True):
        extra.append((f"tp_model_{sp}", {
            "scenario": "ar_model_grads", "model": 2, "sp": sp, "state": refs["tp_state"],
            "args": {**_tiny_ar(), **TP_ARGS}, **dict(zip(("idx", "cond", "tgt"), refs["tp_inputs"]))}))
    outs = run_ranks([(n, j) for n, j, _ in jobs] + extra, world, tmp / f"job{world}")
    return {"world": world, "outs": outs, "twins": {n: t for n, _, t in jobs}, "jobs": dict(
        (n, j) for n, j, _ in jobs)}


# ------------------------------------------------------------ no ranks


@pytest.mark.parametrize("n, data, model, seq", [
    (8, -1, 1, 1), (8, -1, 2, 1), (8, -1, 2, 2), (8, 2, 4, 1), (4, -1, 4, 1), (6, -1, 4, 1),
    (8, 4, 4, 1), (1, -1, 1, 1), (4, 2, 1, 1),
])
def test_mesh_config_resolve_matches_jax(n, data, model, seq):
    want = got = None
    try:
        want = JaxMeshConfig(data=data, model=model, seq=seq).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("x", "x")):
            MeshConfig(data=data, model=model, seq=seq).resolve(n)
        return
    got = MeshConfig(data=data, model=model, seq=seq).resolve(n)
    assert got == want


def test_batch_rows_and_ragged_replication():
    assert [batch_rows(8, r, 4) for r in range(4)] == [slice(2 * r, 2 * r + 2) for r in range(4)]
    assert all(batch_rows(6, r, 4) == slice(0, 6) for r in range(4))  # ragged: replicated
    assert batch_rows(5, 0, 1) == slice(0, 5)


def test_draws_are_parts_of_the_global_draw():
    """Under `global_batch` a rank's draw is its rows (and, for a
    sequence-sharded activation, its sequence part) of the one-process draw."""
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    whole = torch.empty(8, 6, 5, dtype=torch.bool).bernoulli_(0.7, generator=g())
    u = torch.rand(8, generator=g())
    for r in range(4):
        rows = batch_rows(8, r, 4)
        with global_batch(rows, 8, r, 4):
            assert torch.equal(draw_keep((2, 6, 5), 0.7, g(), "cpu"), whole[rows])
            assert torch.equal(draw_keep((2, 3, 5), 0.7, g(), "cpu", seq=(r % 2, 2)),
                               whole[rows, (r % 2) * 3:(r % 2) * 3 + 3])
            assert torch.equal(draw_uniform((2,), g(), "cpu"), u[rows])
    with global_batch(slice(0, 6), 6, 1, 4):  # replicated: the whole draw
        assert torch.equal(draw_keep((6, 6, 5), 0.7, g(), "cpu"),
                           torch.empty(6, 6, 5, dtype=torch.bool).bernoulli_(0.7, generator=g()))


@pytest.mark.parametrize("heads, m", [((4, 2, 3), 2), ((40, 40, 2), 4), ((4, 4, 2), 4)])
def test_fused_qkv_split_puts_whole_heads_on_each_rank(heads, m):
    """Rank r's rows of the fused [q | k | v] projection are q heads
    r H/m .. (r+1) H/m - 1 and KV heads r Hkv/m .., each whole; the parts
    merge back to the whole."""
    H, Hkv, D = heads
    rows = torch.arange((H + 2 * Hkv) * D)
    full = torch.stack([rows, -rows], dim=1)
    parts = [split_heads(full, heads, r, m) for r in range(m)]
    for r, part in enumerate(parts):
        hq, hkv = H // m, Hkv // m
        want_q = torch.arange(r * hq * D, (r + 1) * hq * D)
        want_k = H * D + torch.arange(r * hkv * D, (r + 1) * hkv * D)
        want_v = (H + Hkv) * D + torch.arange(r * hkv * D, (r + 1) * hkv * D)
        assert torch.equal(part[:, 0], torch.cat([want_q, want_k, want_v]))
    assert torch.equal(merge_heads(parts, heads), full)


# ------------------------------------------------------------- at N ranks


def _close(got, want, what, atol=PARAM_ATOL, rtol=PARAM_RTOL):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(f32(got[n]), f32(want[n]), atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {n}")


def _opt_close(got, want, what):
    assert set(got["state"]) == set(want["state"]), what
    for i, st in want["state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(f32(torch.as_tensor(got["state"][i][k])), f32(torch.as_tensor(v)),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=f"{what} {i} {k}")


TRAINER_JOBS = ("ar_dp", "ar_fsdp", "ar_tp_sp", "ar_seq", "ar_seq_remat", "tok_dp", "tok_fsdp",
                "tok_tp_sp", "ar_tp_fsdp")


@pytest.mark.parametrize("name", TRAINER_JOBS)
def test_trainer_steps_equal_one_process(ranks, refs, name):
    """Two steps at N ranks from the same seed: the step's scalars, the
    parameters, the EMAs and the AdamW moments of one process, masks and
    all (the prior's dropouts on)."""
    twin = ranks["twins"][name]
    want, infos = refs[twin], refs[f"{twin}_infos"]
    for r in range(ranks["world"]):
        got = result(ranks["outs"], name, r)
        for s, info in enumerate(infos):
            for k, v in info.items():
                np.testing.assert_allclose(got["infos"][s][k], v, rtol=INFO_RTOL, atol=INFO_ATOL,
                                           err_msg=f"{name} rank {r} step {s} {k}")
        _close(got["params"], want["params"], f"{name} rank {r} params")
        for d in want["ema_params"]:
            _close(got["ema"][d], want["ema_params"][d], f"{name} rank {r} ema {d}")
        _opt_close(got["opt"], want["opt" if twin == "ar" else "opt_g"], f"{name} rank {r} opt")
    if name.startswith("ar_tp"):
        m = ranks["world"] if name == "ar_tp_fsdp" else 2
        assert result(ranks["outs"], name)["heads"] == [(4 // m, 4 // m)]


def test_fsdp_shards_parameters_moments_and_emas(ranks):
    """Each rank holds about 1/N of what FSDP shards (FSDP2 pads dim 0 to a
    multiple of N), and everything at or above fsdp_min_size is sharded."""
    N = ranks["world"]
    for name in ("ar_fsdp", "tok_fsdp"):
        for r in range(N):
            share = result(ranks["outs"], name, r)["share"]
            assert share["full"] > 0
            assert share["held"] <= share["full"] / N * 1.1, (name, r, share)
    total = sum(result(ranks["outs"], "ar_fsdp", r)["share"]["held"] for r in range(N))
    assert total >= result(ranks["outs"], "ar_fsdp")["share"]["full"]


@pytest.mark.parametrize("name", ["ar_dp", "ar_fsdp", "tok_fsdp", "ar_tp_fsdp"])
def test_checkpoint_state_is_kept_on_rank_zero_only(ranks, name):
    """Every rank takes part in the gathers of `state_for_checkpoint`; rank 0,
    which writes the checkpoint, keeps the whole parameters, AdamW moments
    and EMAs on its host, the other ranks nothing."""
    for r in range(ranks["world"]):
        got = result(ranks["outs"], name, r)
        want = {"params": len(got["params"]), "ema_params": sum(len(e) for e in got["ema"].values()),
                "opt": len(got["opt"]["state"])}
        assert want["params"] > 0 and want["opt"] > 0
        assert got["kept"] == (want if r == 0 else {"params": 0, "ema_params": 0, "opt": 0}), (
            name, r, got["kept"])


def test_resume_across_world_sizes(ranks, refs):
    """A checkpoint saved at N ranks (FSDP, after one step) resumes at one
    process, and one process's resumes at N ranks: the next step equals the
    uninterrupted one-process run."""
    name = "ar_fsdp"
    job = ranks["jobs"][name]
    tr, infos = _one_process(job["cfg"], job["batches"][1:], resume=True)
    np.testing.assert_allclose(infos[0]["loss"], refs["ar_infos"][1]["loss"], rtol=INFO_RTOL)
    _close(tr.state_for_checkpoint()["params"], refs["ar"]["params"], "one process from N ranks")
    got = result(ranks["outs"], "ar_fsdp_resume")
    np.testing.assert_allclose(got["infos"][0]["loss"], refs["ar_infos"][1]["loss"], rtol=INFO_RTOL)
    _close(got["params"], refs["ar"]["params"], "N ranks from one process")
    _opt_close(got["opt"], refs["ar"]["opt"], "N ranks from one process: opt")


def test_each_rank_loads_its_rows_in_one_process_order(ranks, refs):
    """Each data index's loader yields its rows of each global batch that
    one process's loader yields, batch for batch."""
    job = ranks["jobs"]["loader"]
    cfg = copy.deepcopy(job["cfg"])
    cfg["save_dir"] = str(refs["tmp"] / f"loader_one{ranks['world']}")
    it = W._trainer(cfg).train_loader(1)
    want = [next(it), next(it)]
    for r in range(ranks["world"]):
        got = result(ranks["outs"], "loader", r)
        rows = got["rows"]
        assert rows == batch_rows(8, r, ranks["world"])
        for g, w in zip(got["batches"], want):
            assert torch.equal(g["gt"], w["gt"][rows]) and torch.equal(g["label"], w["label"][rows])


def test_sigterm_on_one_rank_stops_every_rank_at_one_boundary(ranks, refs):
    """A SIGTERM flag on the last rank alone: all ranks leave through
    SystemExit(0) at the same step boundary, rank 0 writes one `epoch-last`
    with `preempted`, and its parameters are the ranks' gathered ones."""
    from video_tokenizer_tpu_torch.utils import checkpoint as ckpt_lib

    outs = [result(ranks["outs"], "preempt", r) for r in range(ranks["world"])]
    assert [o["exit"] for o in outs] == [0] * ranks["world"]
    path = ranks["jobs"]["preempt"]["cfg"]["save_dir"] + "/epoch-last"
    state = ckpt_lib.restore_checkpoint(path)
    assert state["preempted"] and state["resume_skip_steps"] == 1 and state["epoch"] == 0
    _close(state["params"], outs[0]["params"], "preempted checkpoint", atol=0, rtol=0)


def test_tokenizer_clip_acts(refs):
    """The tokenizer runs are clipped: the global norm of their gradients
    at the first step exceeds clip_grad_max_norm = 0.05, so the equality
    above holds the global norm, not an unclipped step."""
    tr = W._trainer(_tok_cfg(str(refs["tmp"] / "clip")))
    seen = {}
    orig = torch.nn.utils.clip_grad_norm_

    def spy(params, max_norm, *a, **k):
        norm = orig(params, max_norm, *a, **k)
        seen.setdefault("norm", float(norm))
        return norm

    torch.nn.utils.clip_grad_norm_ = spy
    try:
        W._step(tr, _batches(train_batch, TOK_ROWS)[0])
    finally:
        torch.nn.utils.clip_grad_norm_ = orig
    assert seen["norm"] > 0.05


def test_data_parallel_step_matches_jax_trainer(ranks, refs):
    """One AR trainer step at N ranks (every dropout 0) against the JAX
    trainer's step on its 8-device data mesh, from the same weights."""
    got = result(ranks["outs"], "jax_dp")
    for k, v in refs["jax_dp_info"].items():
        np.testing.assert_allclose(got["infos"][0][k], v, rtol=1e-4, err_msg=k)
    for n, p in refs["jax_dp_params"].items():
        np.testing.assert_allclose(f32(got["params"][n]), f32(p), rtol=1e-4, atol=1e-3 * LR,
                                   err_msg=n)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_tp_loss_and_grads_match_replicated_and_jax(ranks, refs, sp):
    got = result(ranks["outs"], f"tp_model_{sp}")
    loss1, grads1 = refs["port_tp_one"]
    jloss, jgrads = refs[f"jax_tp_{sp}"]
    np.testing.assert_allclose(got["loss"], loss1, rtol=1e-6)
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    for n, g in grads1.items():
        np.testing.assert_allclose(f32(got["grads"][n]), f32(g), atol=1e-6, err_msg=n)
        np.testing.assert_allclose(f32(got["grads"][n]), f32(jgrads[n]), atol=1e-5, err_msg=n)
    assert f32(grads1["layers.0.attention.wqkv.weight"]).__abs__().max() > 0
    # the rank's wqkv rows: whole q, k and v heads of the whole weight
    want = split_heads(refs["tp_state"]["layers.0.attention.wqkv.weight"], (4, 2, 16), 0, 2)
    assert torch.equal(got["wqkv_rows"], want)


def test_fsdp_step_matches_jax(ranks, refs):
    """The loss to 1e-6 and the parameters after AdamW's first step to 1e-5,
    where the gradient is above 1e-6: below, Adam's first update g / (|g| +
    1e-8) * lr turns on the rounding of a near-zero gradient, and those
    elements are held to 2 lr (they moved by at most lr either way)."""
    got = result(ranks["outs"], "fsdp_model")
    jloss, jparams, jgrads = refs["jax_fsdp"]
    np.testing.assert_allclose(got["loss"], jloss, atol=1e-6)
    for n, p in jparams.items():
        err = np.abs(f32(got["params"][n]) - f32(p))
        tiny = np.abs(f32(jgrads[n])) < 1e-6
        assert (err[~tiny] <= 1e-5).all() and (err[tiny] <= 2e-3).all(), (n, err.max())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_matches_whole_attention_and_jax(ranks, refs, causal):
    from video_tokenizer_tpu_torch.ops.attention import attention_reference

    got = result(ranks["outs"], "ring")[causal]
    q, k, v = (t.clone().requires_grad_() for t in refs["ring_inputs"][0])
    w = refs["ring_inputs"][1]
    out = attention_reference(q, k, v, causal=causal)[0]
    (out * w).sum().backward()
    np.testing.assert_allclose(f32(got[0]), f32(out), atol=2e-6)
    for a, b in zip(got[1:], (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-5)
    jo, jg = refs[f"jax_ring_{ranks['world']}_{causal}"]
    np.testing.assert_allclose(f32(got[0]), jo, atol=2e-5)
    for a, b in zip(got[1:], jg):
        np.testing.assert_allclose(f32(a), b, atol=5e-4)


def test_ring_ambient_routing_and_fall_through(ranks, refs):
    """Inside `ring_sequence` a plain causal `attention` call rings (its
    graph ends in the gather of the ring's output); a call with segment ids
    runs the one-device flash attention and its numbers."""
    from video_tokenizer_tpu_torch.ops.attention import attention

    got = result(ranks["outs"], "ring")
    assert got["routed"] == "_GatherBackward"
    fell, fn = got["fell"]
    assert fn == "FlashAttentionBackward"
    q, k, v = refs["ring_inputs"][0]
    seg = torch.zeros(q.shape[:2], dtype=torch.int32)
    assert torch.equal(fell, attention(q, k, v, segment_ids=seg))


def test_ring_remat_recompute_on_another_thread(ranks, refs):
    """Remat under `ring_sequence` with the backward on another thread, as a
    card's autograd runs it: the recompute rings as the forward did (every
    block's attention rings twice), and the gradients are the plain ring's
    bit for bit and one process's without a ring within 1e-5."""
    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs

    job = refs["ring_remat"]
    model = LARP_AR(ModelArgs(**job["args"]))
    model.load_state_dict(job["state"], strict=True)
    _, loss = model(job["idx"], job["cond"], targets=job["tgt"], train=True,
                    generator=torch.Generator().manual_seed(5))
    loss.backward()
    n_layer = job["args"]["n_layer"]
    for r in range(ranks["world"]):
        got = result(ranks["outs"], "ring_remat", r)
        (plain, rang_plain), (remat, rang_remat) = got[False], got[True]
        assert (rang_plain, rang_remat) == (n_layer, 2 * n_layer)
        for n, p in model.named_parameters():
            assert torch.equal(remat[n], plain[n]), (r, n)
            np.testing.assert_allclose(f32(plain[n]), f32(p.grad), atol=1e-5, err_msg=f"{r} {n}")
