"""ZeRO-3 placement over the mesh's "data" axis (cfg `param_placement: fsdp`),
the gradient reductions of data parallelism, and whole state dicts.

Counterpart of `video_tokenizer_tpu/parallel/fsdp.py` and of the placement
code of the JAX trainers (`ar_trainer.py:187-262`,
`tokenizer_trainer.py:208-247`). The JAX package lays every large leaf out
sharded over 'data' and lets GSPMD insert the all-gathers and
reduce-scatters; here FSDP2's `fully_shard` does the same per block
(`shard_module`): each parameter of at least `fsdp_min_size` elements
(default 2**16, the JAX `min_size`) is a DTensor split on dim 0 over the
data axis, all-gathered before its block's forward and backward and freed
after, its gradient reduce-scattered (averaged). AdamW's moments and the
EMA copies are made from those DTensors, so they are sharded alike. GSPMD
shards the largest divisible dim where FSDP2 shards dim 0: a layout, not a
number. Smaller tensors stay replicated and are averaged by `sync_grads`,
as is every parameter under plain data parallelism (the tokenizer's
discriminator always: it is replicated, as in the JAX trainer). A
tensor-parallel weight is this rank's slice (`parallel/tp.py`), which
FSDP2 then shards over data: ZeRO-3 + TP, the llama-abs-XXXL layout.

`clip_grad_norm_` clips by the global norm: each element of each gradient
counted once, whatever its placement. `optimizer_step` runs a fused or
foreach optimizer over param groups that mix FSDP's DTensors with
replicated tensors. `full_state_dict`, `full_optimizer_state` and
`full_tensors` gather the whole tensors in the one-device format, one
tensor at a time (collectives: every rank calls them); rank 0, which
writes checkpoints, keeps each on the host, every other rank drops it
after the gather unless `on_every_rank` asks otherwise. The `load_*`
functions slice whole tensors back to this rank's placement, so a
checkpoint saved at N ranks resumes at any other count, one included. At
one process without a mesh they are `state_dict()` / `load_state_dict()`
with the tensors on the host.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .tp import merge_parts, split_full

FSDP_MIN_SIZE = 2**16


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_sharded(t) -> bool:
    return isinstance(t, _dtensor())


def local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_sharded(t) else t


def shard_module(model: nn.Module, blocks: Iterable[nn.Module], mesh,
                 min_size: int = FSDP_MIN_SIZE, skip: Iterable[nn.Parameter] = ()) -> List[nn.Parameter]:
    """FSDP2 `fully_shard` on each block, then on `model`, over the 1-D
    `mesh` (the data axis); parameters under `min_size` elements and those
    in `skip` stay replicated (returned: `sync_grads` averages them)."""
    from torch.distributed.fsdp import fully_shard

    skip = set(skip)
    kept = [p for p in model.parameters() if p.numel() < min_size or p in skip]
    ignored = set(kept)
    for block in blocks:
        fully_shard(block, mesh=mesh, ignored_params=ignored)
    fully_shard(model, mesh=mesh, ignored_params=ignored)
    return kept


@torch.no_grad()
def sync_grads(params: Iterable[nn.Parameter], group, size: int) -> None:
    """Averages the plain (not sharded) gradients of `params` over `group`,
    flattened into one buffer per dtype."""
    if size <= 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None and not is_sharded(p.grad):
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def optimizer_step(opt: torch.optim.Optimizer) -> None:
    """`opt.step()` with the plain tensors of a group taken as replicated over
    the mesh of its DTensors: the fused and foreach kernels then take groups
    that mix both (FSDP's sharded parameters and those under
    `fsdp_min_size`). A group without DTensors is untouched."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        opt.step()


@torch.no_grad()
def clip_grad_norm_(params: Iterable[nn.Parameter], max_norm: float, layout,
                    tp_params: Optional[set] = None) -> torch.Tensor:
    """torch's `clip_grad_norm_` (coefficient max_norm / (norm + 1e-6),
    at most 1) by the GLOBAL norm: FSDP-sharded gradients summed over the
    data axis, tensor-parallel slices (`tp_params`) over the model axis,
    replicated ones counted once."""
    params = [p for p in params if p.grad is not None]
    tp_params = tp_params or set()
    if not params:
        return torch.zeros(())
    device = local(params[0].grad).device
    # [sharded over data: tp, rest], [replicated over data: tp, rest]
    sums = torch.zeros(4, dtype=torch.float32, device=device)
    for p in params:
        sq = local(p.grad).float().pow(2).sum()
        sums[(0 if is_sharded(p.grad) else 2) + (0 if p in tp_params else 1)] += sq
    if layout.data_size > 1:
        shard = sums[:2].clone()
        dist.all_reduce(shard, group=layout.data_group)
        sums[:2] = shard
    tp_sum = sums[0] + sums[2]
    if layout.model_size > 1:
        tp_sum = tp_sum.clone()
        dist.all_reduce(tp_sum, group=layout.model_group)
    total = torch.sqrt(tp_sum + sums[1] + sums[3])
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        local(p.grad).mul_(coef)
    return total


# ------------------------------------------------------------ whole state


def _gather_model_axis(t: torch.Tensor, spec, layout) -> torch.Tensor:
    if spec is None or layout.model_size <= 1:
        return t
    parts = [torch.empty_like(t) for _ in range(layout.model_size)]
    dist.all_gather(parts, t.contiguous(), group=layout.model_group)
    return merge_parts(parts, spec)


def full_tensor(t: torch.Tensor, spec, layout) -> torch.Tensor:
    """The whole tensor of this rank's placement of it (a collective)."""
    if is_sharded(t):
        t = t.full_tensor()
    return _gather_model_axis(t.detach(), spec, layout)


def placed_like(full: torch.Tensor, like: torch.Tensor, spec, layout) -> torch.Tensor:
    """This rank's placement of a whole tensor, the placement of `like`."""
    part = split_full(full, spec, layout.model_rank, layout.model_size) if layout.model_size > 1 else full
    if is_sharded(like):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(part.to(device=like.device, dtype=like.dtype),
                                 like.device_mesh, like.placements)
    return part.to(device=like.device, dtype=like.dtype)


def _specs(model: nn.Module) -> dict:
    return getattr(model, "_tp_specs", {})


def _gathered(items, model: nn.Module, layout, on_every_rank: bool) -> Dict:
    """{key: whole tensor on the host} of {key: (parameter name, tensor in
    that parameter's placement)}: every rank takes part in each gather, rank
    0 (or every rank, `on_every_rank`) keeps the result."""
    specs, keep = _specs(model), on_every_rank or layout.is_master
    out = {}
    for key, (name, t) in items:
        whole = full_tensor(t, specs.get(name), layout)
        if keep:
            out[key] = whole.cpu()
    return out


def full_state_dict(model: nn.Module, layout, on_every_rank: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The whole state dict on rank 0's host ({} elsewhere unless `on_every_rank`)."""
    return _gathered(((n, (n, t)) for n, t in model.state_dict().items()), model, layout,
                     on_every_rank)


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor], layout) -> None:
    """Copies a whole (one-device) state dict into `model`'s placement, strictly."""
    specs = _specs(model)
    own = model.state_dict(keep_vars=True)
    missing = set(own) - set(state)
    unexpected = set(state) - set(own)
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
    for n, t in own.items():
        value = placed_like(state[n], t, specs.get(n), layout)
        local(t).copy_(local(value))


def full_tensors(tensors: Dict[str, torch.Tensor], model: nn.Module, layout,
                 on_every_rank: bool = False) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor in that parameter's placement} -> whole (EMA
    copies), kept as `full_state_dict` keeps them."""
    return _gathered(((n, (n, t)) for n, t in tensors.items()), model, layout, on_every_rank)


def placed_tensors(full: Dict[str, torch.Tensor], model: nn.Module, layout,
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    params, specs = dict(model.named_parameters()), _specs(model)
    return {n: placed_like(t, params[n].detach(), specs.get(n), layout).to(dtype)
            for n, t in full.items()}


def _param_names(opt: torch.optim.Optimizer, model: nn.Module) -> List[str]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in opt.param_groups for p in g["params"]]


def full_optimizer_state(opt: torch.optim.Optimizer, model: nn.Module, layout,
                         on_every_rank: bool = False) -> dict:
    """`opt.state_dict()` with every per-parameter tensor whole: the format
    of the one-device optimizer, kept as `full_state_dict` keeps it (the
    other ranks' "state" is empty)."""
    sd = opt.state_dict()
    names = _param_names(opt, model)
    params = [p for g in opt.param_groups for p in g["params"]]
    moments = [((idx, k), (names[idx], v)) for idx, st in sd["state"].items()
               for k, v in st.items()
               if torch.is_tensor(v) and v.ndim and local(v).shape == local(params[idx]).shape]
    whole = _gathered(moments, model, layout, on_every_rank)
    state = {}
    if on_every_rank or layout.is_master:
        state = {idx: {k: whole.get((idx, k), v) for k, v in st.items()}
                 for idx, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_optimizer_state(opt: torch.optim.Optimizer, model: nn.Module, sd: dict, layout) -> None:
    names = _param_names(opt, model)
    params = [p for g in opt.param_groups for p in g["params"]]
    specs = _specs(model)
    state = {}
    for idx, st in sd["state"].items():
        idx = int(idx)
        p = params[idx]
        state[idx] = {k: (placed_like(v, p.detach(), specs.get(names[idx]), layout).to(torch.float32)
                          if torch.is_tensor(v) and v.ndim and tuple(v.shape) == _full_shape(p, specs.get(names[idx]), layout)
                          else v)
                      for k, v in st.items()}
    opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def _full_shape(p: torch.Tensor, spec, layout):
    shape = list(p.shape)  # a DTensor's shape is its global shape over data
    if spec is not None and layout.model_size > 1:
        dim = 1 if spec == "row" else 0
        shape[dim] *= layout.model_size
    return tuple(shape)
