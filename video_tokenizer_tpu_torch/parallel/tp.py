"""Megatron tensor parallelism over the mesh's "model" axis, with sequence
parallelism.

Counterpart of `video_tokenizer_tpu/parallel/tp.py`. The JAX package
annotates PartitionSpecs and lets GSPMD insert the collectives; here each
rank holds its slice of every split weight (`shard_larp_ar`, `shard_vit`)
and the modules call the collectives themselves through a `ModelParallel`
(`.tp` on the module; None: one device):

  * column-parallel (output dim split): LARP_AR's wqkv, w1, w3 and the
    ViT's qkv, fc1 (with its bias). The fused wqkv is [(H + 2 Hkv) D, dim]
    (q rows, then k, then v): a contiguous split would give the first rank
    only q rows, so each of the q, k and v blocks is split by head groups
    (`split_heads`), and each rank runs the flash kernels on its H / m
    query heads over its Hkv / m KV heads. n_head or n_kv_head not
    divisible by m is refused;
  * row-parallel (input dim split): wo, w2, the ViT's attn.proj and fc2;
    their biases are added once, after the reduction;
  * vocab-parallel: LARP_AR's `tok_embeddings` rows (a masked lookup and a
    sum over the axis) and `output` columns, when the axis divides the
    vocabulary (else both stay replicated). The loss over the split vocab
    is `vocab_parallel_nll`: all-reduces of the row max, the sum of exps and
    the target logit, never the full logits. `vocab_parallel_topk_accuracy`
    counts each target's rank across the shards (two all-reduces: the
    target logit, then the counts), the rule of
    `metrics.statistics.topk_accuracy`, also without gathering logits;
  * everything else (norms, the PE, the class embedding, the ViT's patch
    embed, bottleneck and query tokens) is replicated.

Without sequence parallelism the activations between blocks are whole on
every rank: a column-parallel product's input passes `copy` (identity,
its gradient summed over the axis) and a row-parallel output `reduce`
(summed). With `sequence_parallel: true` they are sharded on the sequence
dim over the axis (Megatron-SP, arXiv:2205.05198): `enter` all-gathers the
sequence before a column-parallel product (its gradient reduce-scattered)
and `exit` reduce-scatters after a row-parallel one, so norms, residuals
and dropouts compute on 1/m of the tokens; the replicated parameters used
there (norm weights, row-parallel biases) pass `copy`, so that their
gradients sum over the axis. As in the JAX `seq_constraint`, a sequence
that the axis does not divide stays whole. Dropout masks under it are
slices of the global draw (`parallel/mesh.py`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + xt.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + xt.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    """This rank's part along `dim` of a tensor whole on every rank; the
    gradient is all-gathered (the whole gradient on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _part(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` into a tensor that the ranks then use
    alike: the gradient is this rank's part of the (equal) gradients."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.dim, ctx.group), None, None


class _GatherSum(torch.autograd.Function):
    """All-gather along `dim` before a column-parallel product: each rank's
    gradient is partial, so it is reduce-scattered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Scatter.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim, group)


class ModelParallel:
    """The "model" axis as the modules see it. `sp` arguments say whether the
    activation at hand is sequence-sharded (decided once per stack, from
    `sequence_parallel` and the sequence length: `seq_sharded`)."""

    def __init__(self, group, sequence_parallel: bool = False):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.sequence_parallel = bool(sequence_parallel)

    def seq_sharded(self, seq_len: int) -> bool:
        return self.sequence_parallel and self.size > 1 and seq_len % self.size == 0

    def seq_part(self, sp: bool) -> Optional[Tuple[int, int]]:
        return (self.rank, self.size) if sp else None

    def copy(self, x):
        return _Copy.apply(x, self.group)

    def enter(self, x, sp: bool):
        """Before a column-parallel product."""
        return _GatherSum.apply(x, 1, self.group) if sp else _Copy.apply(x, self.group)

    def exit(self, x, sp: bool):
        """After a row-parallel product."""
        return _ReduceScatter.apply(x, 1, self.group) if sp else _Reduce.apply(x, self.group)

    def reduce(self, x):
        return _Reduce.apply(x, self.group)

    def scatter_seq(self, x):
        return scatter(x, 1, self.group)

    def gather_seq(self, x):
        return gather(x, 1, self.group)

    def replicated(self, module: nn.Module, x, sp: bool):
        """`module(x)` for a replicated module (a norm) on an activation that
        may be sequence-sharded: its parameters then pass `copy`."""
        if not sp:
            return module(x)
        params = {n: self.copy(p) for n, p in module.named_parameters()}
        return torch.func.functional_call(module, params, (x,))


# -------------------------------------------------------------- splitting


def split_heads(full: torch.Tensor, heads: Tuple[int, int, int], rank: int, size: int,
                dim: int = 0) -> torch.Tensor:
    """Rank `rank`'s rows of a fused [q | k | v] projection (weight or bias)
    with heads = (H, Hkv, D): each block split by head groups."""
    H, Hkv, D = heads
    q, k, v = full.split((H * D, Hkv * D, Hkv * D), dim=dim)
    return torch.cat([t.chunk(size, dim=dim)[rank] for t in (q, k, v)], dim=dim)


def merge_heads(parts: List[torch.Tensor], heads: Tuple[int, int, int], dim: int = 0):
    H, Hkv, D = heads
    m = len(parts)
    split = (H * D // m, Hkv * D // m, Hkv * D // m)
    blocks = [p.split(split, dim=dim) for p in parts]
    return torch.cat([torch.cat([b[i] for b in blocks], dim=dim) for i in range(3)], dim=dim)


def split_full(full: torch.Tensor, spec, rank: int, size: int) -> torch.Tensor:
    """This rank's slice of a whole tensor under `spec` ('col', 'row' or
    ('qkv', heads)); None: whole."""
    if spec is None:
        return full
    if spec == "col":
        return full.chunk(size, dim=0)[rank]
    if spec == "row":
        return full.chunk(size, dim=1)[rank]
    return split_heads(full, spec[1], rank, size)


def merge_parts(parts: List[torch.Tensor], spec) -> torch.Tensor:
    if spec == "col":
        return torch.cat(parts, dim=0)
    if spec == "row":
        return torch.cat(parts, dim=1)
    return merge_heads(parts, spec[1])


def _check_heads(n_head: int, n_kv_head: int, m: int, where: str) -> None:
    if n_head % m or n_kv_head % m:
        raise ValueError(
            f"{where}: mesh_model {m} must divide n_head {n_head} and n_kv_head {n_kv_head} "
            "(each rank takes whole heads of the fused qkv projection)")


def _replace(module: nn.Module, name: str, value: torch.Tensor) -> None:
    setattr(module, name, nn.Parameter(value.detach().clone(),
                                       requires_grad=getattr(module, name).requires_grad))


def _shard_params(model: nn.Module, specs: Dict[str, object], tp: ModelParallel) -> None:
    modules = dict(model.named_modules())
    for name, spec in specs.items():
        mod_name, _, attr = name.rpartition(".")
        mod = modules[mod_name]
        _replace(mod, attr, split_full(getattr(mod, attr).data, spec, tp.rank, tp.size))
    model._tp_specs = dict(specs)
    model._tp = tp


def larp_ar_param_specs(model) -> Dict[str, object]:
    """State-dict name -> split of every LARP_AR parameter that TP splits
    (the JAX `larp_ar_param_spec`; the rest are replicated)."""
    cfg = model.config
    H, Hkv, D = cfg.n_head, cfg.n_kv_head or cfg.n_head, cfg.dim // cfg.n_head
    specs: Dict[str, object] = {}
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        specs[p + "attention.wqkv.weight"] = ("qkv", (H, Hkv, D))
        specs[p + "attention.wo.weight"] = "row"
        specs[p + "feed_forward.w1.weight"] = "col"
        specs[p + "feed_forward.w3.weight"] = "col"
        specs[p + "feed_forward.w2.weight"] = "row"
    return specs


def shard_larp_ar(model, tp: ModelParallel) -> None:
    """Splits a LARP_AR's weights in place for `tp` (before any optimizer
    is built) and gives its modules the `.tp` they call."""
    cfg = model.config
    m = tp.size
    if cfg.quantized:
        raise ValueError("tensor parallelism trains float models; int8 serving over a mesh "
                         "is ROADMAP.md item 8b")
    _check_heads(cfg.n_head, cfg.n_kv_head or cfg.n_head, m, "LARP_AR")
    hidden = model.layers[0].feed_forward.w1.weight.shape[0]
    if hidden % m:
        raise ValueError(f"LARP_AR: mesh_model {m} must divide the FFN width {hidden}")
    specs = larp_ar_param_specs(model)
    model.vocab_parallel_embed = model.tok_embeddings.weight.shape[0] % m == 0
    model.vocab_parallel_head = cfg.vocab_size % m == 0
    if model.vocab_parallel_embed:
        specs["tok_embeddings.weight"] = "col"
    if model.vocab_parallel_head:
        specs["output.weight"] = "col"
    _shard_params(model, specs, tp)
    model.tp = tp
    for layer in model.layers:
        layer.tp = layer.attention.tp = layer.feed_forward.tp = tp
        layer.attention.n_head //= m
        layer.attention.n_kv_head //= m


def vit_param_specs(model: nn.Module) -> Dict[str, object]:
    """The JAX `vit_param_spec` over every ViTBlock of `model` (its
    encoder and decoder; any discriminator is another model)."""
    from ..models.transformer import ViTBlock

    specs: Dict[str, object] = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, ViTBlock):
            continue
        C = mod.attn.proj.weight.shape[0]
        H = mod.attn.num_heads
        heads = ("qkv", (H, H, C // H))
        specs[f"{name}.attn.qkv.weight"] = heads
        if mod.attn.qkv.bias is not None:
            specs[f"{name}.attn.qkv.bias"] = heads
        specs[f"{name}.attn.proj.weight"] = "row"
        specs[f"{name}.mlp.fc1.weight"] = "col"
        specs[f"{name}.mlp.fc1.bias"] = "col"
        specs[f"{name}.mlp.fc2.weight"] = "row"
    return specs


def shard_vit(model: nn.Module, tp: ModelParallel) -> None:
    """Splits every ViT stack of a tokenizer in place for `tp`."""
    from ..models.transformer import ViTBlock, ViTStack

    for name, mod in model.named_modules():
        if isinstance(mod, ViTBlock):
            _check_heads(mod.attn.num_heads, mod.attn.num_heads, tp.size, name)
            if mod.mlp.fc1.weight.shape[0] % tp.size:
                raise ValueError(f"{name}: mesh_model {tp.size} must divide the MLP width")
    specs = vit_param_specs(model)
    _shard_params(model, specs, tp)
    for mod in model.modules():
        if isinstance(mod, ViTBlock):
            mod.tp = mod.attn.tp = mod.mlp.tp = tp
            mod.attn.num_heads //= tp.size
        elif isinstance(mod, ViTStack):
            mod.tp = tp


def row_parallel(dense: nn.Module, x: torch.Tensor, tp: ModelParallel, sp: bool) -> torch.Tensor:
    """A row-parallel `Dense`: the local product, the reduction over the
    axis, then the bias once (the `Dense` dtype rule)."""
    dtype = dense.dtype or torch.promote_types(x.dtype, dense.weight.dtype)
    y = tp.exit(F.linear(x.to(dtype), dense.weight.to(dtype)), sp)
    if dense.bias is not None:
        bias = tp.copy(dense.bias) if sp else dense.bias
        y = y + bias.to(dtype)
    return y


# ------------------------------------------------------ vocab-parallel loss


def vocab_range(logits_local: torch.Tensor, tp: ModelParallel) -> Tuple[int, int]:
    V = logits_local.shape[-1]
    return tp.rank * V, (tp.rank + 1) * V


def _target_logit(l: torch.Tensor, targets: torch.Tensor, lo: int, hi: int, group):
    inside = (targets >= lo) & (targets < hi)
    t = torch.where(inside, targets - lo, 0).long()
    mine = torch.gather(l, -1, t.unsqueeze(-1)).squeeze(-1)
    return _all_reduce(torch.where(inside, mine, 0.0), group), inside, t


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, tp):
        l = logits.float()
        lo, hi = vocab_range(logits, tp)
        m = l.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        e = torch.exp(l - m.unsqueeze(-1))
        s = _all_reduce(e.sum(-1), tp.group)
        tl, inside, t = _target_logit(l, targets, lo, hi, tp.group)
        ctx.save_for_backward(e / s.unsqueeze(-1), inside, t)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - tl

    @staticmethod
    def backward(ctx, g):
        p, inside, t = ctx.saved_tensors
        grad = p * g.unsqueeze(-1)
        hit = F.one_hot(t, p.shape[-1]).to(grad.dtype) * inside.unsqueeze(-1)
        return (grad - hit * g.unsqueeze(-1)).to(ctx.dtype), None, None


def vocab_parallel_nll(logits_local: torch.Tensor, targets: torch.Tensor,
                       tp: ModelParallel) -> torch.Tensor:
    """Per-token NLL (fp32, the shape of targets) of logits whose last dim is
    this rank's contiguous part of the vocabulary."""
    return _VocabParallelNLL.apply(logits_local, targets, tp)


@torch.no_grad()
def vocab_parallel_topk_accuracy(logits_local: torch.Tensor, targets: torch.Tensor,
                                 tp: ModelParallel, ks=(1, 5)) -> dict:
    """`metrics.statistics.topk_accuracy` over a split vocabulary: a
    target's rank is the count, over every shard, of logits above its own
    plus equal logits at lower indices; no logits are gathered."""
    l = logits_local.float()
    lo, hi = vocab_range(l, tp)
    mine, _, _ = _target_logit(l, targets, lo, hi, tp.group)
    mine = mine.unsqueeze(-1)
    idx = torch.arange(lo, hi, device=l.device)
    lower = idx < targets.long().unsqueeze(-1)
    rank = _all_reduce((l > mine).sum(-1) + ((l == mine) & lower).sum(-1), tp.group)
    return {f"top{k}": (rank < k).float().mean() for k in ks}
