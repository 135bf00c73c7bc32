"""Ring attention: the sequence sharded over the mesh's "seq" axis.

Counterpart of `video_tokenizer_tpu/parallel/ring.py`. Each rank holds an
equal, contiguous shard of q, k and v (shards in rank order). The forward
ring visits every K/V shard: each rank runs the flash forward of its
queries against the shard it holds, merges the partial result into an fp32
accumulator by the log-sum-exp (`merge`), and passes K/V to the next rank
(`dist.batch_isend_irecv`). A causal ring takes one of three ways per step
(`step_kind`): a shard from the future is skipped (no kernel), the
diagonal runs causal at offset 0, a past shard runs full attention. The
output is cast once, at the end.

The backward is a second ring that rotates k, v and their fp32 gradient
accumulators together: at each step the block gradients come from the
flash backward kernels with the ring's GLOBAL out and lse injected
(`flash_attn_bwd(q, k_blk, v_blk, out, lse, do, causal=diag,
causal_offset=0)`: p_ij = exp(s_ij - lse_i) is already the global softmax,
and delta = rowsum(out * do) is the global one), so no block renormalises;
after P rotations every dk / dv accumulator is home. The kernels write each
block's gradient in the inputs' dtype; the sums are fp32 and are cast once.

`ring_fwd_step` and `ring_bwd_step` are the per-step bodies: they do not
communicate, so `ring_forward_shards` / `ring_backward_shards` can run the
ring of P shards in one process (on one card, or on the CPU in the tests).

`ring_attention` is what `ops.attention.attention` calls inside
`ring_sequence` (cfg `mesh_seq: N`): every rank of the seq axis holds the
whole activations; the call gives the ring this rank's S / P slice of q, k
and v and all-gathers the output, with backwards that slice the output's
gradient and all-gather q's, k's and v's, so that every rank ends with the
same whole gradients. The same numbers as whole attention. What it saves:
each rank computes the attention of S / P queries against all keys and
holds K/V shards of S / P rows in the ring; what it does not save: every
other activation (the projections, norms and MLPs) is whole on every rank
of the axis.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import flash_attn_bwd, flash_attn_fwd, ring_as
from .tp import gather, scatter

NEG = -1e30  # the LSE of an accumulator that has seen no key


def step_kind(src: int, my: int, causal: bool) -> str:
    """What rank `my` does at the step where it holds shard `src`'s K/V."""
    if not causal:
        return "full"
    return "skip" if src > my else "diag" if src == my else "full"


def merge(out: torch.Tensor, lse: torch.Tensor, o: torch.Tensor, l: torch.Tensor):
    """Combines two attention partials over disjoint key sets: out [B,S,H,D]
    fp32 and lse [B,H,S] fp32 with a block's (o, l); returns fp32."""
    m = torch.maximum(lse, l)
    wa, wb = torch.exp(lse - m), torch.exp(l - m)
    den = wa + wb
    t = lambda w: w.transpose(1, 2).unsqueeze(-1)  # noqa: E731  [B,H,S] -> [B,S,H,1]
    merged = (out * t(wa) + o.float() * t(wb)) / t(den)
    return merged, m + torch.log(den)


def ring_fwd_step(q, k, v, out, lse, kind: str, sm_scale: Optional[float] = None):
    """One forward step: the block (q, this K/V shard) merged into (out, lse)."""
    if kind == "skip":
        return out, lse
    diag = kind == "diag"
    o, l = flash_attn_fwd(q, k, v, causal=diag, causal_offset=0 if diag else None,
                          sm_scale=sm_scale, return_lse=True)
    return merge(out, lse, o, l)


def ring_bwd_step(q, k, v, out, lse, do, kind: str, sm_scale: Optional[float] = None):
    """One backward step: (dq, dk, dv) of the block from the global out and
    lse, or None for a skipped block."""
    if kind == "skip":
        return None
    diag = kind == "diag"
    return flash_attn_bwd(q, k, v, out, lse, do, causal=diag, causal_offset=0 if diag else None,
                          sm_scale=sm_scale)


def _init_acc(q):
    B, S, H, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((B, H, S), NEG, dtype=torch.float32, device=q.device))


class RingGroup:
    """The seq axis as the ring sees it: its group, this rank's index and the
    global ranks it sends to and receives from."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def rotate(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sends each tensor to the next rank; returns the previous rank's."""
        got = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.next, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, g, self.prev, self.group) for g in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring: RingGroup, causal: bool, sm_scale):
        out, lse = _init_acc(q)
        kc, vc = k, v
        for step in range(ring.size):
            src = (ring.rank - step) % ring.size
            out, lse = ring_fwd_step(q, kc, vc, out, lse, step_kind(src, ring.rank, causal),
                                     sm_scale)
            if step < ring.size - 1:
                kc, vc = ring.rotate([kc, vc])
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.sm_scale = ring, causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for step in range(ring.size):
            src = (ring.rank - step) % ring.size
            g = ring_bwd_step(q, kc, vc, out, lse, do, step_kind(src, ring.rank, ctx.causal),
                              ctx.sm_scale)
            if g is not None:
                dq += g[0].float()
                dk += g[1].float()
                dv += g[2].float()
            if ring.size > 1:  # the accumulators travel with their shard: home after P
                if step < ring.size - 1:
                    kc, vc, dk, dv = ring.rotate([kc, vc, dk, dv])
                else:
                    dk, dv = ring.rotate([dk, dv])
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention_local(q, k, v, ring: RingGroup, causal: bool = False,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Per-shard ring attention: q, k, v this rank's [B, S/P, H, D] shards."""
    return _RingAttention.apply(q, k, v, ring, causal, sm_scale)


def ring_attention(q, k, v, ring: RingGroup, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Whole [B, S, H, D] q, k, v, equal on every rank of the ring -> the
    whole output (module docstring)."""
    g = ring.group
    out = ring_attention_local(scatter(q, 1, g), scatter(k, 1, g), scatter(v, 1, g), ring,
                               causal, sm_scale)
    return gather(out, 1, g)


class ring_sequence(ring_as):
    """Context: every eligible `ops.attention.attention` call rings over
    `group` (no segment ids, Sq == Sk, no causal offset but 0, S divisible by
    the ring); every other call runs on the one device (cfg `mesh_seq: N`).
    A block under remat recomputes under the same ring
    (`ops.attention.checkpoint_block`)."""

    def __init__(self, group):
        super().__init__(RingGroup(group))


# ------------------------------------------------- P shards in one process


def ring_forward_shards(qs, ks, vs, causal: bool = False, sm_scale: Optional[float] = None
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The forward ring of P = len(qs) shards in one process: rank r holds
    shard (r - step) mod P at each step. Returns each shard's (out, lse)."""
    P = len(qs)
    outs, lses = [], []
    for r in range(P):
        out, lse = _init_acc(qs[r])
        for step in range(P):
            src = (r - step) % P
            out, lse = ring_fwd_step(qs[r], ks[src], vs[src], out, lse,
                                     step_kind(src, r, causal), sm_scale)
        outs.append(out.to(qs[r].dtype))
        lses.append(lse)
    return outs, lses


def ring_backward_shards(qs, ks, vs, outs, lses, dos, causal: bool = False,
                         sm_scale: Optional[float] = None):
    """The backward ring of P shards in one process: each shard's (dq, dk, dv)
    from the fp32 sums of the block gradients, cast once."""
    P = len(qs)
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    for r in range(P):
        for step in range(P):
            src = (r - step) % P
            g = ring_bwd_step(qs[r], ks[src], vs[src], outs[r], lses[r], dos[r],
                              step_kind(src, r, causal), sm_scale)
            if g is not None:
                dq[r] += g[0].float()
                dk[src] += g[1].float()
                dv[src] += g[2].float()
    return ([d.to(q.dtype) for d, q in zip(dq, qs)], [d.to(k.dtype) for d, k in zip(dk, ks)],
            [d.to(v.dtype) for d, v in zip(dv, vs)])
