"""One rank of the port's multi-device tests: `python _torch_parallel_worker.py
<job dir> <rank> <world>`.

Joins a gloo group through a `FileStore` in the job dir, runs every scenario
that `job.pt` lists in order and writes `out_<rank>.pt`. It imports torch and
the port only (no JAX): the tests compare its results with one process and
with the JAX package in the pytest process.
"""
import os
import sys
import traceback

import torch
import torch.distributed as dist

torch.set_num_threads(1)


def _trainer(cfg):
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    tr = trainers.make({"name": cfg["trainer"]}, args={"cfg": cfg, "device": "cpu"})
    tr.make_datasets()
    tr.n_steps_per_epoch = 4
    tr.epoch = 1
    tr.make_model()
    return tr


def _step(tr, batch):
    """One trainer step on this rank's rows of a global batch."""
    from video_tokenizer_tpu_torch.parallel.mesh import shard_batch

    n = len(batch["gt"])
    local = shard_batch(batch, tr.layout.batch_rows(n))
    with tr.step_context(n):
        keys, packed = tr.train_step(local)
    if tr.layout.data_size > 1:
        packed = packed.clone()
        dist.all_reduce(packed, group=tr.layout.data_group)
        packed /= tr.layout.data_size
    return dict(zip(keys, packed.tolist()))


def _sharded_share(tr) -> dict:
    """Elements this rank holds of the parameters, AdamW moments and EMAs
    that FSDP shards, over their whole counts."""
    from video_tokenizer_tpu_torch.parallel.fsdp import is_sharded, local

    opt = tr.opt if hasattr(tr, "opt") else tr.opt_g
    held = full = 0
    for p in tr.model.parameters():
        if is_sharded(p):
            held += local(p).numel()
            full += p.numel()
            for t in opt.state.get(p, {}).values():
                if torch.is_tensor(t) and is_sharded(t):
                    held += local(t).numel()
                    full += t.numel()
    for ema in tr.ema_params.values():
        for t in ema.values():
            if is_sharded(t):
                held += local(t).numel()
                full += t.numel()
    return {"held": held, "full": full}


def trainer_steps(job):
    """`steps` global batches through a trainer; optionally save `epoch-last`
    after `save_after` steps, or resume from `resume` first."""
    tr = _trainer(job["cfg"])
    out = {}
    if job.get("resume"):
        assert tr.try_resume()
    if job.get("load"):  # whole weights (the prior and its vae, or the tokenizer and its
        # loss module); the EMAs start from them
        from video_tokenizer_tpu_torch.parallel.fsdp import load_full_state_dict, placed_tensors

        load = job["load"]
        load_full_state_dict(tr.model, load["params"], tr.layout)
        if "vae" in load:
            tr.vae.load_state_dict(load["vae"], strict=True)
        if "loss" in load:
            tr.loss_mod.load_state_dict(load["loss"], strict=True)
        params = {n: load["params"][n] for n, _ in tr.model.named_parameters()}
        tr.ema_params = {d: placed_tensors(params, tr.model, tr.layout) for d in tr.ema_params}
    infos = []
    for i, batch in enumerate(job["batches"]):
        infos.append(_step(tr, batch))
        if job.get("save_after") == i + 1:
            tr.save_checkpoint("epoch-last")
    state = tr.state_for_checkpoint(on_every_rank=True)
    kept = tr.state_for_checkpoint()  # what a checkpoint keeps on this rank
    out["kept"] = {"params": len(kept["params"]),
                   "ema_params": sum(len(e) for e in kept["ema_params"].values()),
                   "opt": len(kept.get("opt", kept.get("opt_g"))["state"])}
    out["infos"] = infos
    out["params"] = state["params"]
    out["ema"] = state["ema_params"]
    out["opt"] = state.get("opt", state.get("opt_g"))
    if "loss_params" in state:  # the tokenizer's discriminator and LeCam EMAs
        out["disc"] = state["loss_params"]
    out["share"] = _sharded_share(tr)
    if tr.tp is not None:
        out["heads"] = [(l.attention.n_head, l.attention.n_kv_head)
                        for l in getattr(tr.model, "layers", [])]
    return out


def ar_model_grads(job):
    """The port's LARP_AR split over the model axis: loss and whole gradients."""
    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs
    from video_tokenizer_tpu_torch.parallel.fsdp import full_tensor, sync_grads
    from video_tokenizer_tpu_torch.parallel.mesh import Layout, MeshConfig, create_mesh
    from video_tokenizer_tpu_torch.parallel.tp import ModelParallel, shard_larp_ar

    mesh = create_mesh(MeshConfig(model=job["model"]), "cpu")
    lay = Layout(mesh)
    model = LARP_AR(ModelArgs(**job["args"]))
    model.load_state_dict(job["state"], strict=True)
    shard_larp_ar(model, ModelParallel(lay.model_group, job["sp"]))
    rows = lay.batch_rows(len(job["idx"]))
    _, loss = model(job["idx"][rows], job["cond"][rows], targets=job["tgt"][rows])
    loss.backward()
    sync_grads(list(model.parameters()), lay.data_group, lay.data_size)  # the global mean's
    loss_all = loss.detach().clone()
    if lay.data_size > 1:
        dist.all_reduce(loss_all, group=lay.data_group)
        loss_all /= lay.data_size
    specs = model._tp_specs
    grads = {n: full_tensor(p.grad, specs.get(n), lay) for n, p in model.named_parameters()}
    return {"loss": float(loss_all), "grads": grads,
            "wqkv_rows": model.layers[0].attention.wqkv.weight.detach().clone()}


def ar_model_fsdp(job):
    """One AdamW step of a LARP_AR sharded by FSDP2 over the data axis."""
    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs
    from video_tokenizer_tpu_torch.parallel.fsdp import full_state_dict, shard_module, sync_grads
    from video_tokenizer_tpu_torch.parallel.mesh import Layout, MeshConfig, create_mesh

    lay = Layout(create_mesh(MeshConfig(), "cpu"))
    model = LARP_AR(ModelArgs(**job["args"]))
    model.load_state_dict(job["state"], strict=True)
    kept = shard_module(model, model.layers, lay.mesh["data"], job["min_size"])
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
    rows = lay.batch_rows(len(job["idx"]))
    _, loss = model(job["idx"][rows], job["cond"][rows], targets=job["tgt"][rows])
    loss.backward()
    sync_grads(kept, lay.data_group, lay.data_size)
    opt.step()
    loss_all = loss.detach().clone()
    dist.all_reduce(loss_all, group=lay.data_group)
    return {"loss": float(loss_all) / lay.data_size, "params": full_state_dict(model, lay)}


def ring(job):
    """Ring attention over the seq axis: whole out and gradients, and the
    ambient routing with its fall-through."""
    from video_tokenizer_tpu_torch.ops.attention import attention
    from video_tokenizer_tpu_torch.parallel.mesh import Layout, MeshConfig, create_mesh
    from video_tokenizer_tpu_torch.parallel.ring import RingGroup, ring_attention, ring_sequence

    lay = Layout(create_mesh(MeshConfig(seq=job["seq"]), "cpu"))
    out = {}
    for causal in (False, True):
        q, k, v = (t.clone().requires_grad_() for t in job["qkv"])
        o = ring_attention(q, k, v, RingGroup(lay.seq_group), causal=causal)
        (o * job["w"]).sum().backward()
        out[causal] = (o.detach(), q.grad, k.grad, v.grad)
    q, k, v = (t.clone().requires_grad_() for t in job["qkv"])
    seg = torch.zeros(q.shape[:2], dtype=torch.int32)
    with ring_sequence(lay.seq_group):
        o = attention(q, k, v, causal=True)
        routed = type(o.grad_fn).__name__
        fell = attention(q, k, v, segment_ids=seg)
        fell_fn = type(fell.grad_fn).__name__
    out["routed"], out["fell"] = routed, (fell.detach(), fell_fn)
    return out


def loader(job):
    """This rank's first two batches of epoch 1 (clips and labels)."""
    tr = _trainer(job["cfg"])
    it = tr.train_loader(1)
    return {"rows": tr.layout.batch_rows(tr.train_batch_size),
            "batches": [{k: next_b[k] for k in ("gt", "label")} for next_b in (next(it), next(it))]}


def preempt(job):
    """A SIGTERM seen by the last rank only, after the first step: every rank
    leaves through SystemExit(0) at that boundary, with one checkpoint."""
    tr = _trainer(job["cfg"])
    _step(tr, job["batches"][0])
    tr._epoch_complete, tr._epoch_step = False, 1
    tr._preempt_requested = tr.layout.rank == dist.get_world_size() - 1
    try:
        tr._maybe_preempt()
    except SystemExit as e:
        return {"exit": e.code, "params": tr.state_for_checkpoint()["params"]}
    return {"exit": None}


def ring_remat(job):
    """LARP_AR with remat and its dropouts under `ring_sequence`, its backward
    on another thread (where autograd runs it on a card, with no ring
    entered): the gradients of the plain model, and how many attention
    calls rang (forwards, remat's recomputes included)."""
    import threading

    from video_tokenizer_tpu_torch.models.larp_ar import LARP_AR, ModelArgs
    from video_tokenizer_tpu_torch.parallel import ring as ring_lib
    from video_tokenizer_tpu_torch.parallel.mesh import Layout, MeshConfig, create_mesh

    lay = Layout(create_mesh(MeshConfig(seq=job["seq"]), "cpu"))
    local, rang = ring_lib.ring_attention_local, []

    def counted(*a, **k):
        rang.append(1)
        return local(*a, **k)

    ring_lib.ring_attention_local = counted
    out = {}
    try:
        for remat in (False, True):
            model = LARP_AR(ModelArgs(**job["args"], remat=remat))
            model.load_state_dict(job["state"], strict=True)
            rang.clear()
            with ring_lib.ring_sequence(lay.seq_group):
                _, loss = model(job["idx"], job["cond"], targets=job["tgt"], train=True,
                                generator=torch.Generator().manual_seed(5))
            failed = []

            def backward():
                try:
                    loss.backward()
                except Exception as e:  # re-raised on this thread
                    failed.append(e)

            t = threading.Thread(target=backward)
            t.start()
            t.join()
            if failed:
                raise failed[0]
            out[remat] = ({n: p.grad.clone() for n, p in model.named_parameters()}, len(rang))
    finally:
        ring_lib.ring_attention_local = local
    return out


SCENARIOS = {f.__name__: f for f in (trainer_steps, ar_model_grads, ar_model_fsdp, ring, loader,
                                     preempt, ring_remat)}


def main(job_dir: str, rank: int, world: int) -> None:
    jobs = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(job_dir, 'store')}",
                            rank=rank, world_size=world)
    results = {}
    for name, job in jobs:
        try:
            results[name] = SCENARIOS[job["scenario"]](job)
        except Exception:  # recorded, so that the test names the failing scenario
            results[name] = {"error": traceback.format_exc()}
            break
        dist.barrier()
    torch.save(results, os.path.join(job_dir, f"out_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
