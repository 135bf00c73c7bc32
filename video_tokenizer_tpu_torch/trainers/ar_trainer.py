"""AR prior trainers on one device: class-conditional and frame-prediction.

Counterpart of `video_tokenizer_tpu/trainers/ar_trainer.py`, function by
function (the replicated layout only):
  * a frozen tokenizer ("vae") from a checkpoint directory or an upstream
    `.pth` (`vae.checkpoint`, `utils/model_io.py`), or a seeded fresh one
    from an inline `vae.args` / `vae.model`; it sets the prior's
    `max_seq_len` and `vocab_size`, sits in eval mode with no gradient, and
    encodes under `torch.no_grad()`, so it builds no graph;
  * one step: codes of the clips, the prior's teacher-forcing forward with
    its dropouts (`LARP_AR.forward(train=True)`, every mask drawn from the
    trainer's own generator), the cross-entropy, top-1/top-5 accuracy, the
    backward; with `grad_accum_steps: A`, A microbatches whose gradients are
    summed in fp32 and divided by A; then AdamW at the schedule's rate of the
    global step, decaying the `Dense` weights only (minGPT's split), then the
    EMAs. The step's scalars come back as one device tensor;
  * frame prediction: the condition is the codes of the first
    `num_cond_frames` frames repeated to `num_frames`, then the separator
    token `codebook_size`; `cls_token_num = seq_len + 1`;
  * `visualize_epoch`: `generation.generate` + `decode_from_bottleneck`,
    written as `vis/samples_ep<n>.png`; then, with `fvd_real_stats_path`
    set and pretrained I3D weights or `force_fvd: true`, the samples' FVD
    against those real stats, logged as `sample gFVD: <value>` and as the
    scalar `eval/gfvd` (`_maybe_fvd`). A failure of either is logged, never
    raised;
  * the epoch loop, preemption, `profile_steps` and the writers are the
    base trainer's (this trainer keeps its `train_epoch`).
The JAX trainer computes in fp32 whatever `use_amp` says (it sets a compute
dtype that nothing reads), and so does this one. `model.args.remat`
recomputes the prior's blocks in the backward (`models/larp_ar.py`).
Under a mesh (`BaseTrainer`): `mesh_model` splits the prior Megatron-style
(`parallel.tp.shard_larp_ar`, with `sequence_parallel`), `param_placement:
fsdp` shards its parameters, AdamW moments and EMAs over the data axis, and
the replicated gradients are averaged over the data axis; the loss and the
top-k accuracy run over a vocab-parallel head without gathering logits
(`LARP_AR.topk_accuracy`). `visualize_epoch` samples on rank 0 under plain
data parallelism; over split or sharded weights it logs that sampling over
a mesh is ROADMAP.md item 8b and skips.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import registry
from ..generation import generate
from ..models.layers import Dense
from ..parallel import fsdp as fsdp_lib
from ..registry import trainers
from ..utils import common
from ..utils.model_io import load_tokenizer_checkpoint
from .base_trainer import BaseTrainer, _plain, ema_update, make_lr_schedule


def adamw_mingpt(model: torch.nn.Module, betas=(0.9, 0.95), weight_decay: float = 0.0,
                 fused: bool = False) -> torch.optim.AdamW:
    """AdamW that decays only the `Dense` weights (the JAX mask decays the
    leaves named `kernel`); embeddings, norms and the PE are not decayed.
    eps is optax's 1e-8; the learning rate is set before every step."""
    decay = {id(m.weight) for m in model.modules() if isinstance(m, Dense)}
    params = [p for p in model.parameters() if p.requires_grad]
    groups = [{"params": [p for p in params if id(p) in decay], "weight_decay": weight_decay},
              {"params": [p for p in params if id(p) not in decay], "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=1e-8, fused=fused)


class _ARTrainerBase(BaseTrainer):
    frame_prediction = False

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        ar_cfg = cfg.get("ar", {})
        self.sample_batch_size = int(ar_cfg.get("sample_batch_size", 8))
        self.cfg_scale = float(ar_cfg.get("cfg_scale", 1.0))
        self.cfg_interval = int(ar_cfg.get("cfg_interval", -1))
        self.temperature = float(ar_cfg.get("temperature", 1.0))
        self.top_k = int(ar_cfg.get("top_k", 0))
        self.top_p = float(ar_cfg.get("top_p", 1.0))
        self.num_frames = int(ar_cfg.get("num_frames", 16))
        self.num_cond_frames = int(ar_cfg.get("num_cond_frames", 5))
        if cfg.get("use_amp", False):
            self.log("use_amp is ignored: the AR trainer computes in fp32, as the JAX one does")
        self.grad_accum = int(cfg.get("grad_accum_steps", 1))
        self.step = 0

    # -------------------------------------------------------------- building

    def _load_vae(self):
        vae_cfg = self.cfg["vae"]
        path = str(vae_cfg.get("checkpoint", "") or "").strip("'\"")
        if path:
            self.vae = load_tokenizer_checkpoint(path, str(vae_cfg.get("version", "sd")))
            self.log(f"Loaded VAE from {path}")
        elif "args" in vae_cfg or "model" in vae_cfg:
            spec = dict(vae_cfg["model"] if "model" in vae_cfg
                        else {"name": vae_cfg["name"], "args": vae_cfg["args"]})
            args = {**dict(spec.get("args") or {}),
                    "generator": torch.Generator().manual_seed(self.seed)}
            self.vae = registry.models.make({"name": spec["name"], "args": args})
            self.log("VAE initialized randomly (no checkpoint given)")
        else:
            raise ValueError("vae.checkpoint is empty and no inline vae.args / vae.model is given")
        self.vae = self.vae.to(self.device).eval().requires_grad_(False)

    def make_model(self):
        self._load_vae()
        seq_length = self.vae.bottleneck_token_num
        args = dict(self.cfg["model"].get("args", {}))
        args["max_seq_len"] = seq_length
        args["vocab_size"] = self.vae.codebook_size
        if self.frame_prediction:
            args["frame_prediction"] = True
            args["cls_token_num"] = seq_length + 1
        else:
            num_classes = getattr(self.train_dataset, "num_classes", None)
            if num_classes:
                args["num_classes"] = num_classes
        # built on the host from the seed, then moved (the init draws on the CPU)
        self.model = registry.models.make(
            {"name": self.cfg["model"]["name"], "args": args},
            args={"generator": torch.Generator().manual_seed(self.seed)}).to(self.device)
        self.model_cfg = self.model.config
        self.log(f"AR model params: {common.compute_num_params(self.model)}")
        from ..parallel.tp import shard_larp_ar

        self.place_model(self.model, self.model.layers, shard_larp_ar)

        opt_cfg = self.cfg["optimizer"]
        self.sched = make_lr_schedule(opt_cfg, float(opt_cfg["args"]["lr"]),
                                      self.steps_per_epoch(), int(self.cfg["max_epoch"]))
        self.opt = adamw_mingpt(self.model, betas=opt_cfg["args"].get("betas", [0.9, 0.95]),
                                weight_decay=float(opt_cfg["args"].get("weight_decay", 0.0)),
                                fused=self.device.type == "cuda")
        self.ema_params = {
            str(d): {n: p.detach().float().clone() for n, p in self.model.named_parameters()}
            for d in self.ema_decays
        }
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed + 99)
        self.step = 0

    def _generators(self) -> Dict[str, torch.Generator]:
        """The dropout generator and the tokenizer's own (its VQ seeds)."""
        gens = {"dropout": self.dropout_gen}
        for name, m in self.vae.named_modules():
            if isinstance(getattr(m, "sample_generator", None), torch.Generator):
                gens[f"vae.{name}.sample_generator"] = m.sample_generator
        return gens

    # ------------------------------------------------------------------ step

    @torch.no_grad()
    def _encode_tokens(self, x: torch.Tensor) -> torch.Tensor:
        return self.vae.encode(x, train=False)["bottleneck_rep"]

    def _make_cond_and_targets(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cond, z). Overridden by the frame-prediction trainer."""
        x = common.video_to_float(batch["gt"].to(self.device, non_blocking=True))
        return batch["label"].to(self.device).long(), self._encode_tokens(x)

    def _forward(self, batch, train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"loss", "top1", "top5"}) of one (micro)batch."""
        cond, z = self._make_cond_and_targets(batch)
        logits, loss = self.model(z[:, :-1], cond, targets=z, train=train,
                                  generator=self.dropout_gen if train else None)
        return loss, {"loss": loss.detach(), **self.model.topk_accuracy(logits.detach(), z)}

    def _pack(self, info: Dict[str, torch.Tensor]) -> Tuple[List[str], torch.Tensor]:
        keys = sorted(info)
        return keys, torch.stack([info[k].float() for k in keys])

    def train_step(self, batch) -> Tuple[List[str], torch.Tensor]:
        """One optimizer update; returns (keys, fp32 device tensor of the step's scalars)."""
        self.opt.zero_grad(set_to_none=True)
        A = self.grad_accum
        if A == 1:
            loss, info = self._forward(batch, True)
            loss.backward()
        else:
            B = len(batch["gt"])
            if B % A:
                raise ValueError(f"grad_accum_steps={A} must divide the per-step batch {B}")
            info = {}
            for i in range(A):
                micro = {k: batch[k][i * B // A:(i + 1) * B // A] for k in ("gt", "label")}
                loss, mi = self._forward(micro, True)
                loss.backward()  # .grad sums the microbatches' gradients (fp32 parameters)
                info = {k: info.get(k, 0.0) + v for k, v in mi.items()}
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(A)
            info = {k: v / A for k, v in info.items()}
        self.sync_grads()
        for group in self.opt.param_groups:
            group["lr"] = self.sched(self.step)
        fsdp_lib.optimizer_step(self.opt)
        if self.ema_params:
            params = dict(self.model.named_parameters())
            for d, ema in self.ema_params.items():
                ema_update(ema, params, float(d))
        self.step += 1
        return self._pack(info)

    @torch.no_grad()
    def evaluate_step(self, batch) -> Dict[str, float]:
        _, info = self._forward(batch, False)
        keys, packed = self._pack(info)
        return dict(zip(keys, packed.tolist()))

    # --------------------------------------------------------- visualization

    @torch.no_grad()
    def sample_videos(self, cond: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """cond -> decoded videos [B, C, T, H, W] through KV-cache sampling."""
        seq = generate(self.model, cond, self.model.max_seq_length, generator,
                       cfg_scale=self.cfg_scale, cfg_interval=self.cfg_interval,
                       temperature=self.temperature, top_k=self.top_k, top_p=self.top_p)
        return self.vae.decode_from_bottleneck(seq)

    def _sample_conditions(self, n: int) -> torch.Tensor:
        if self.frame_prediction:
            batch = next(iter(self.test_loader(next(iter(self.test_datasets)))))
            x = common.video_to_float(batch["gt"][:n].to(self.device))
            c = self._encode_tokens(
                common.repeat_to_m_frames(x[:, :, : self.num_cond_frames], m=self.num_frames))
            sep = torch.full((c.shape[0], 1), self.vae.codebook_size, dtype=c.dtype,
                             device=c.device)
            return torch.cat([c, sep], dim=1)
        counts = np.asarray(getattr(self.train_dataset, "label_count", None)
                            or [1] * self.model.num_classes, np.float64)
        rng = np.random.default_rng(self.seed * 1_000_003 + self.epoch)
        labels = rng.choice(len(counts), size=n, p=counts / counts.sum())
        return torch.as_tensor(labels, dtype=torch.long, device=self.device)

    def visualize_epoch(self):
        """`vis/samples_ep<epoch>.png`: min(sample_batch_size, 4) sampled
        videos, one row of frames each. A failure is logged: visualization
        never stops training (the JAX trainer's rule)."""
        if self.placement == "fsdp" or self.tp is not None:
            self.log("visualize_epoch: sampling over split or sharded weights is ROADMAP.md "
                     "item 8b (slice 23); skipped")
            return
        if not self.is_master:
            return
        try:
            cond = self._sample_conditions(min(self.sample_batch_size, 4))
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed * 1_000_003 + self.epoch)
            videos = self.sample_videos(cond, gen).float()
            vis_dir = common.ensure_path(os.path.join(self.save_dir, "vis"))
            common.save_video_grid(os.path.join(vis_dir, f"samples_ep{self.epoch}.png"),
                                   list(videos.cpu().numpy()))
            self._maybe_fvd(videos)
        except Exception as e:  # visualization must never kill training
            self.log(f"visualize_epoch failed: {e}")

    def _maybe_fvd(self, videos: torch.Tensor):
        """gFVD of sampled videos [B, C, T, H, W] in [0, 1] against the real
        stats of `fvd_real_stats_path` (a `FeatureStats` .pkl). A failure is
        logged, never raised."""
        stats_path = str(self.cfg.get("fvd_real_stats_path", "") or "")
        if not stats_path or not os.path.exists(stats_path):
            return
        try:
            from ..metrics.fvd import FeatureStats, FVDCalculator

            if getattr(self, "_fvd_calc", None) is None:
                weights = FVDCalculator.resolve_weights(self.cfg.get("i3d_weights"))
                if weights is None and not self.cfg.get("force_fvd", False):
                    return
                self._fvd_calc = FVDCalculator(weights, device=self.device)
            gen = self._fvd_calc.get_feature_stats_for_batch(videos)
            real = FeatureStats.load(stats_path)
            self.current_fvd = float(self._fvd_calc.calculate_fvd(gen, real))
            self.log(f"sample gFVD: {self.current_fvd:.3f}")
            self.log_temp_scalar("eval/gfvd", self.current_fvd)
        except Exception as e:
            self.log(f"gFVD computation failed: {e}")

    # ----------------------------------------------------------- checkpoints

    def checkpoint_meta(self):
        meta = super().checkpoint_meta()
        meta["model"] = {"name": self.cfg["model"]["name"],
                         "args": dataclasses.asdict(self.model_cfg)}
        meta["vae"] = _plain(self.cfg["vae"])
        return meta

    def state_for_checkpoint(self, on_every_rank: bool = False) -> Dict[str, Any]:
        lay, keep = self.layout, on_every_rank
        return {
            "params": fsdp_lib.full_state_dict(self.model, lay, keep),
            "opt": fsdp_lib.full_optimizer_state(self.opt, self.model, lay, keep),
            "ema_params": {d: fsdp_lib.full_tensors(e, self.model, lay, keep)
                           for d, e in self.ema_params.items()},
            "step": self.step,
            "rng": {k: g.get_state() for k, g in self._generators().items()},
        }

    def load_state(self, state: Dict[str, Any]):
        lay = self.layout
        fsdp_lib.load_full_state_dict(self.model, state["params"], lay)
        fsdp_lib.load_optimizer_state(self.opt, self.model, state["opt"], lay)
        self.ema_params = {d: fsdp_lib.placed_tensors(e, self.model, lay)
                           for d, e in state["ema_params"].items()}
        self.step = int(state["step"])
        gens = self._generators()
        for k, s in state.get("rng", {}).items():
            gens[k].set_state(s)


@trainers.register("larp_ar_trainer")
class LARPARTrainer(_ARTrainerBase):
    frame_prediction = False


@trainers.register("larp_ar_fp_trainer")
class LARPARFramePredictionTrainer(_ARTrainerBase):
    frame_prediction = True

    def _make_cond_and_targets(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One encode of [clips || condition clips]: z, and the condition's
        codes + the separator token."""
        x = common.video_to_float(batch["gt"].to(self.device, non_blocking=True))
        x_cond = common.repeat_to_m_frames(x[:, :, : self.num_cond_frames], m=self.num_frames)
        z, c = self._encode_tokens(torch.cat([x, x_cond])).chunk(2)
        sep = torch.full((c.shape[0], 1), self.vae.codebook_size, dtype=c.dtype, device=c.device)
        return torch.cat([c, sep], dim=1), z
