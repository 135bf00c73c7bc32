"""Distil a small draft model against a frozen AR target for speculative decoding.

Counterpart of the JAX package's `tools/distill_draft.py`. The recipe, on
generated data only (no checkpoint needed):
  1. sample `batch` full sequences FROM the target (on-policy prefixes: the
     distribution the draft must match at serving time);
  2. a teacher-forcing forward of the frozen target over them gives the
     per-position distributions p(. | prefix);
  3. train the draft with cross-entropy against p (soft labels: the full-vocab
     KL up to the teacher's entropy) for `steps` AdamW steps, the targets
     refreshed every `steps // 5`.
The draft's parameters are trained in fp32 and cast to bf16 for every forward
and backward. The forward is `LARP_AR.forward` under autograd, so on a card
its attention runs the flash forward and backward kernels.

  python -m video_tokenizer_tpu_torch.tools.distill_draft --tiny --device cpu

trains a tiny pair for a few steps; without `--tiny` the pair is the 632M
llama-abs-LP prior and its ~60M draft (`flagship_ar`, `flagship_draft`). A
freshly initialised target has a zero output head, a uniform teacher with no
gradient for the draft, so the smoke run sharpens the target's head first.
"""
from __future__ import annotations

import argparse
import copy
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from ..generation import generate


def sample_target_sequences(target, n_seq: int, seq_len: int,
                            generator: Optional[torch.Generator] = None,
                            temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """[n_seq, seq_len] on-policy sequences from the target (class 0, no CFG:
    the draft should match the raw conditional; guidance is applied to both
    alike at serving time)."""
    cond = torch.zeros(n_seq, dtype=torch.int64, device=target.tok_embeddings.weight.device)
    return generate(target, cond, seq_len, generator, cfg_scale=1.0, temperature=temperature,
                    top_k=top_k)


@torch.no_grad()
def target_soft_labels(target, seqs: torch.Tensor, cond: torch.Tensor,
                       temperature: float) -> torch.Tensor:
    """Teacher-forcing forward of the frozen target: p(. | prefix) [B, S, V] fp32."""
    logits, _ = target(seqs[:, :-1], cond)
    return torch.softmax(logits.float() / temperature, dim=-1)


def distill(target, draft, generator: Optional[torch.Generator] = None, steps: int = 150,
            batch: int = 8, seq_len: int = 1024, lr: float = 3e-4, temperature: float = 1.0,
            log: Callable[[str], None] = print) -> Tuple[torch.nn.Module, dict]:
    """Runs the bounded distillation and returns (the trained draft in bf16,
    stats); `draft` itself is left as it was. Budget: one sampling pass and
    one teacher forward per refresh, `steps` draft forward/backward steps."""
    device = target.tok_embeddings.weight.device
    cond = torch.zeros(batch, dtype=torch.int64, device=device)
    work = copy.deepcopy(draft).float()  # fp32 masters; bf16 compute below
    masters = dict(work.named_parameters())
    opt = torch.optim.AdamW(masters.values(), lr=lr, betas=(0.9, 0.95), weight_decay=0.0)

    t0 = time.perf_counter()
    refresh_every = max(steps // 5, 1)
    losses = []
    for step in range(steps):
        if step % refresh_every == 0:
            # generate runs in inference mode: autograd needs an ordinary tensor
            seqs = sample_target_sequences(target, batch, seq_len, generator, temperature).clone()
            p_soft = target_soft_labels(target, seqs, cond, temperature)
        compute = {name: p.to(torch.bfloat16) for name, p in masters.items()}
        logits, _ = functional_call(work, compute, (seqs[:, :-1], cond))
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -(p_soft * logp).sum(dim=-1).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if step % 25 == 0 or step == steps - 1:
            losses.append(loss.item())
            log(f"[distill] step {step}: soft-CE {losses[-1]:.4f}")
    stats = {"steps": steps, "wall_s": round(time.perf_counter() - t0, 1),
             "first_loss": losses[0] if losses else None,
             "last_loss": losses[-1] if losses else None}
    return work.to(torch.bfloat16).eval(), stats


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from .. import flagship_ar, flagship_draft

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tiny", action="store_true", help="a tiny pair that also runs on a CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device")

    common = dict(class_dropout_prob=0.0)
    tkw, dkw, (B, S) = {}, {}, (8, 1024)
    if args.tiny:
        common.update(vocab_size=512, max_seq_len=64)
        tkw, dkw, (B, S) = dict(n_layer=2, n_head=4, dim=128), dict(n_layer=1, n_head=2, dim=64), (4, 64)
    target = flagship_ar(torch.bfloat16, torch.Generator().manual_seed(0), **common, **tkw)
    draft = flagship_draft(torch.bfloat16, torch.Generator().manual_seed(1), **common, **dkw)
    with torch.no_grad():  # a zero head is a uniform teacher: sharpen it
        w = target.output.weight
        w.copy_(0.11 * torch.randn(w.shape, generator=torch.Generator().manual_seed(7)))
    target, draft = target.to(device), draft.to(device)
    _, stats = distill(target, draft, torch.Generator(device=device).manual_seed(2),
                       steps=args.steps, batch=B, seq_len=S, lr=args.lr)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
