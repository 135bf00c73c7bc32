"""LARP tokenizer trainer: a generator and a discriminator, two optimizers, one device.

Counterpart of `video_tokenizer_tpu/trainers/tokenizer_trainer.py`. One
step, in the JAX package's order:
  1. ONE tokenizer forward under autograd (stochastic VQ draws its seed from
     the bottleneck's generator; a BatchNorm bottleneck norm moves its
     running statistics);
  2. the discriminator branch runs when epoch >= disc_self_start and
     (step + 1) % d_update_freq == 0: its loss on real clips and the
     detached reconstructions, the LeCam EMA advances, and the D optimizer
     steps if the loss is above `d_update_loss_threshold`, at the D learning
     rate of the global step. On other steps the D loss is only evaluated
     (for the log) without a graph, and the D optimizer is not touched;
  3. the generator loss with the UPDATED discriminator: pixel + LPIPS
     (frozen) + adversarial, + loss_q (warmed up by epoch) + loss_kl (an
     skl bottleneck, weighted by `_kl_weight_for_step`: `loss_kl_weight`,
     decaying linearly to 0 over `kl_decay_epoch` epochs when that is > 0)
     + align_loss x 0.2 (the teacher alignment of the V-JEPA2 tokenizers,
     `models/vfm.py`, `models/sem.py`) + loss_latent_ce x `loss_latent_ce_weight` (the gptc prior) + the
     `_generator_extra_loss` hook (none here; the STAT trainer's
     adaptive-token losses), in training and in eval as in the JAX step.
     The discriminator's parameters are frozen for this backward, so its
     gradient reaches the reconstruction only, never the D optimizer;
  4. the G optimizer steps after ONE global-norm clip over all its
     parameters (optional), then the EMAs of the parameters.
The G optimizer has the JAX trainer's learning-rate groups: `base`, `prior`
(every parameter of the tokenizer's prior, at `prior_lr_mult` x the
schedule) and, when `emb_lr_mult` != 1, `emb` (the tokenizer's parameters
at the top of its Flax tree, `utils/convert.py::top_level_param_names`, at
`emb_lr_mult` x). With `grad_accum_steps: A` > 1 a step runs A equal
microbatches (A must divide the batch): both optimizers' gradients are
summed in fp32 and each optimizer applies one update from their mean; the
generator loss sees the discriminator before its update, the LeCam EMA
chains through the microbatches (kept only if the D branch runs), the D
update is gated on the mean microbatch D loss and the plain step's
epoch / frequency gate, and the logged scalars are microbatch means (the
JAX `_accum_step_impl`).
The step's scalars (the JAX step's packed keys) come back as one device
tensor. Every tokenizer forward goes through `_model_forward`, where a
subclass passes its own arguments (the STAT trainer's stage and generator).
The generator optimizer and the EMAs hold the parameters that require a
gradient: a frozen codebook (the `sq` bottleneck's Leech lattice) stays
out. Attention runs through `ops.attention` (the flash forward and the
dQ / dK-dV backward kernels on the card), VQ through `ops.vq`.
`use_amp: true` computes the tokenizer, LPIPS and the discriminator in
bf16 (the bottleneck and the prior stay fp32); `false` is fp32.
`visualize_epoch` writes the JAX trainer's gt-over-reconstruction grid
(`vis/epoch_<n>.png`, through the standard-library PNG writer), and with a
TensorBoard writer adds the same image as `vis/gt_vs_recon_grid` and tries
`add_video` (which needs moviepy), as the JAX trainer does; any failure is
logged rather than stopping the run.
Eval rFVD: with pretrained I3D weights (`i3d_weights`, or the default path
of `metrics/fvd.py`) or `force_fvd: true`, `evaluate_step` adds I3D
features of the reconstruction it already computed (clipped to [0, 1]) and
of the real clips, and `evaluate_epoch` logs `eval rFVD: <value>` (and the
scalar `eval/rfvd`), the
`current_fvd` that `save_best: true` keeps the best checkpoint by. A failed
FVD pass is logged and training goes on (the JAX trainer's rule).
A checkpoint holds the parameters with the BatchNorm statistics (buffers of
the model), both optimizers with their groups, the EMAs, the step and every
generator's state, so a resumed run takes the steps an uninterrupted one
takes.
Under a mesh (`BaseTrainer`, the JAX `tokenizer_trainer.py:208-247`):
`mesh_model` splits the tokenizer's ViT stacks Megatron-style
(`parallel.tp.shard_vit`), `param_placement: fsdp` shards the generator's
parameters, moments and EMAs over the data axis, and the discriminator stays
replicated, its gradients averaged over the data axis; the D update's gate
reads the data axis's mean D loss, LeCam reads the global batch's mean
logits (`parallel.mesh.batch_mean`), the code statistics the global batch's
indices (`parallel.mesh.gather_rows`), and the generator is clipped by its
global norm (`parallel.fsdp.clip_grad_norm_`). A bottleneck with batch
statistics (BatchNorm) would see only this rank's rows and is refused
there.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import registry
from ..metrics import statistics as stats
from ..parallel import fsdp as fsdp_lib
from ..parallel.mesh import gather_rows
from ..registry import trainers
from ..utils import common
from ..utils.convert import top_level_param_names
from .base_trainer import BaseTrainer, ema_update, make_lr_schedule

# the tokenizer's outputs that the generator loss takes (not logged as aux scalars)
_DIFF_KEYS = ("pred_frames", "loss_q", "loss_kl", "loss_latent_ce", "align_loss")
ALIGN_LOSS_WEIGHT = 0.2  # the teacher-alignment term of the VFM / sem tokenizers


def make_optimizer(name: str, params, args) -> torch.optim.Optimizer:
    """adam / adamw / sgd with the config's args; the learning rate is set
    before every step from the schedule."""
    name = name.lower()
    betas = tuple(args.get("betas", [0.9, 0.999]))
    lr = float(args.get("lr", 0.0))
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas,
                                 weight_decay=float(args.get("weight_decay", 0.0)))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(args.get("momentum", 0.0)))
    raise ValueError(f"unknown optimizer {name}")


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate: `lr` times the group's `lr_mult`."""
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)


@trainers.register("larp_tokenizer_trainer")
class LARPTokenizerTrainer(BaseTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.loss_q_weight = float(cfg.get("loss_q_weight", 0.0))
        warmup = str(cfg.get("loss_q_warmup", "1.0_1")).split("_")
        self.loss_q_starting_ratio = float(warmup[0])
        self.loss_q_warmup_epochs = int(warmup[1])
        self.base_kl_weight = float(cfg.get("loss_kl_weight", 0.0))
        self.kl_decay_epoch = int(cfg.get("kl_decay_epoch", -1))
        self.loss_latent_ce_weight = float(cfg.get("loss_latent_ce_weight", 0.0))
        self.clip_grad_max_norm = float(cfg.get("clip_grad_max_norm", 0.0))
        self.grad_accum = int(cfg.get("grad_accum_steps", 1))
        self.compute_dtype = torch.bfloat16 if cfg.get("use_amp", False) else torch.float32
        self.step = 0

    # -------------------------------------------------------------- building

    def make_model(self):
        cfg = self.cfg
        gen = torch.Generator().manual_seed(self.seed)
        model_spec = dict(cfg["model"])
        model_args = {**dict(model_spec.get("args", {})), "generator": gen}
        model_args.setdefault("dtype", self.compute_dtype)
        # built on the host from the seed, then moved (the init draws on the CPU)
        self.model = registry.models.make({"name": model_spec["name"], "args": model_args})
        self.model.to(self.device)
        self._place_generator()
        loss_spec = dict(cfg["loss"])
        self.loss_mod = registry.models.make({
            "name": loss_spec["name"],
            "args": {**dict(loss_spec.get("args", {})), "dtype": self.compute_dtype,
                     "generator": gen},
        }).to(self.device)
        self.disc = self.loss_mod.discriminator
        if self.loss_mod.r1_gp_weight > 0.0:
            self.log(f"R1 penalty x{self.loss_mod.r1_gp_weight:g}: the discriminator runs the "
                     "plain attention (twice differentiable), no flash kernel")
        if self.loss_mod.spectral_norm:
            self.log("spectral_norm: the discriminator's projection weights are divided by "
                     "their top singular value at every loss call")
        self.log(f"model params: {common.compute_num_params(self.model)}; "
                 f"loss params: {common.compute_num_params(self.loss_mod)}")

        opt_cfg = cfg["optimizer"]
        steps_per_epoch, max_epoch = self.steps_per_epoch(), int(cfg["max_epoch"])
        d_args = opt_cfg.get("loss_args", opt_cfg["args"])
        self.g_sched = make_lr_schedule(opt_cfg, float(opt_cfg["args"]["lr"]), steps_per_epoch,
                                        max_epoch)
        self.d_sched = make_lr_schedule(opt_cfg, float(d_args["lr"]), steps_per_epoch, max_epoch)
        # a frozen codebook (requires_grad False) is neither optimised nor averaged
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        groups = self._param_groups(named, float(opt_cfg.get("prior_lr_mult", 1.0)),
                                    float(opt_cfg.get("emb_lr_mult", 1.0)))
        self.log("generator learning-rate groups: " + ", ".join(
            f"{g['name']} {sum(p.numel() for p in g['params']):,} params x{g['lr_mult']:g}"
            for g in groups))
        self.opt_g = make_optimizer(opt_cfg.get("name", "adam"), groups, opt_cfg["args"])
        # only the discriminator trains; LPIPS is frozen
        self.opt_d = make_optimizer(opt_cfg.get("loss_name", opt_cfg.get("name", "adam")),
                                    self.disc.parameters(), d_args)
        self.ema_params = {
            str(d): {n: p.detach().float().clone() for n, p in named} for d in self.ema_decays
        }
        self.step = 0
        self._setup_fvd()

    def _place_generator(self) -> None:
        """The generator over the mesh: its ViT stacks split over the model
        axis, its blocks sharded over the data axis under fsdp."""
        from ..models.transformer import ViTBlock
        from ..parallel.tp import shard_vit

        if self.layout.data_size > 1 and any(
                isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in self.model.modules()):
            raise NotImplementedError("a BatchNorm bottleneck under a data axis would normalise "
                                      "by this rank's rows only: not ported")
        blocks = [m for m in self.model.modules() if isinstance(m, ViTBlock)]
        self.place_model(self.model, blocks, shard_vit)

    def _data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank scalar over the data axis."""
        if self.layout.data_size <= 1:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=self.layout.data_group)
        return t / self.layout.data_size

    def _clip_generator(self) -> None:
        if self.layout.distributed:
            fsdp_lib.clip_grad_norm_(self.model.parameters(), self.clip_grad_max_norm,
                                     self.layout, self.tp_params)
        else:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.clip_grad_max_norm)

    def _param_groups(self, named, prior_mult: float, emb_mult: float) -> List[Dict[str, Any]]:
        """The JAX trainer's labels as torch param groups: `prior` (under the
        tokenizer's prior), `emb` (its top-level Flax parameters, only when
        emb_mult != 1) and `base`; empty groups are left out."""
        emb = top_level_param_names(self.model) if emb_mult != 1.0 else set()
        members: Dict[str, list] = {"base": [], "prior": [], "emb": []}
        for n, p in named:
            label = "prior" if n.startswith("prior.") else "emb" if n in emb else "base"
            members[label].append(p)
        mults = {"base": 1.0, "prior": prior_mult, "emb": emb_mult}
        return [{"params": ps, "name": k, "lr_mult": mults[k]} for k, ps in members.items() if ps]

    def _setup_fvd(self):
        """Eval-time FVD of reconstructions: on when the I3D weights are
        pretrained or `force_fvd` is set."""
        from ..metrics.fvd import FVDCalculator

        self.fvd_calc = self._fake_stats = self._real_stats = None
        weights = FVDCalculator.resolve_weights(self.cfg.get("i3d_weights"))
        if weights is None and not self.cfg.get("force_fvd", False):
            self.log("eval FVD disabled (no pretrained I3D weights)")
            return
        try:
            self.fvd_calc = FVDCalculator(weights, device=self.device)
            self.log("eval FVD enabled")
        except Exception as e:
            self.log(f"eval FVD unavailable: {e}")

    # ------------------------------------------------------------- schedules

    def _loss_q_weight_for_epoch(self, epoch: int) -> float:
        w = self.loss_q_weight
        if self.loss_q_warmup_epochs > 1 and epoch < self.loss_q_warmup_epochs:
            ratio = self.loss_q_starting_ratio + (1 - self.loss_q_starting_ratio) * (
                epoch - 1) / (self.loss_q_warmup_epochs - 1)
            w = ratio * w
        return w

    def _kl_weight_for_step(self, step: int) -> float:
        if self.kl_decay_epoch <= 0:
            return self.base_kl_weight
        cutoff = self.kl_decay_epoch * self.n_steps_per_epoch
        return self.base_kl_weight * (1 - step / cutoff) if step < cutoff else 0.0

    def _generators(self) -> Dict[str, torch.Generator]:
        """The modules' own generators (VQ seeds, skl noise, ns_smooth label
        noise, the prior's dropout seeds)."""
        gens = {}
        for root, mod in (("model", self.model), ("loss", self.loss_mod)):
            for name, m in mod.named_modules():
                for attr in ("sample_generator", "noise_generator", "dropout_generator"):
                    if isinstance(getattr(m, attr, None), torch.Generator):
                        gens[f"{root}.{name}.{attr}"] = getattr(m, attr)
        return gens

    # ------------------------------------------------------------------ step

    def _model_forward(self, data: torch.Tensor, train: bool) -> Dict[str, Any]:
        """The tokenizer's forward; a subclass adds its own arguments."""
        return self.model(data, train=train)

    def _generator_extra_loss(self, out, data, pred
                              ) -> Tuple[Optional[torch.Tensor], Dict[str, Any]]:
        """An extra generator-loss term (None: no term) and its scalars."""
        return None, {}

    def _generator_total(self, data, pred, out, epoch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        g_loss, info = self.loss_mod.generator_loss(data, pred, epoch)
        total = g_loss
        if "loss_kl" in out:
            klw = self._kl_weight_for_step(self.step)
            total = total + out["loss_kl"].float() * klw
            info["loss_kl"], info["kl_weight"] = out["loss_kl"], klw
        if "align_loss" in out:
            total = total + out["align_loss"].float() * ALIGN_LOSS_WEIGHT
            info["align_loss"] = out["align_loss"]
        if "loss_q" in out:
            total = total + out["loss_q"].float() * self._loss_q_weight_for_epoch(epoch)
            info["loss_q"] = out["loss_q"]
        if "loss_latent_ce" in out:
            total = total + out["loss_latent_ce"].float() * self.loss_latent_ce_weight
            info["loss_latent_ce"] = out["loss_latent_ce"]
        extra, extra_info = self._generator_extra_loss(out, data, pred)
        info.update(extra_info)
        return (total if extra is None else total + extra), info

    @torch.no_grad()
    def _metrics(self, info, data, pred, out, total) -> None:
        B = data.shape[0]
        mses = torch.mean((pred - data).reshape(B, -1) ** 2, dim=-1)
        info["mse"] = mses.mean()
        info["psnr"] = common.psnr_from_mse(mses).mean()
        info["ssim"] = stats.video_ssim(pred, data)
        info["loss"] = total
        rep = out.get("bottleneck_rep")
        if rep is not None and rep.dtype in (torch.int32, torch.int64):
            rep = gather_rows(rep)  # the global batch's codes under a data axis
            cb = self.model.codebook_size
            hist_first = stats.index_histogram(rep[0], cb)
            info["index_usage"] = stats.index_usage_percentage(hist_first)
            info["index_usage_batch"] = stats.index_usage_percentage(stats.index_histogram(rep, cb))
            info["perplexity"] = stats.perplexity(hist_first)
            info["kl_uni"] = stats.kl_divergence_from_uniform(hist_first)
        for k, v in out.items():
            if k not in _DIFF_KEYS and isinstance(v, torch.Tensor) and v.ndim == 0:
                info[k] = v

    def _pack(self, info: Dict[str, Any]) -> Tuple[List[str], torch.Tensor]:
        keys = sorted(k for k, v in info.items() if not isinstance(v, torch.Tensor) or v.ndim == 0)
        return keys, torch.stack([
            torch.as_tensor(info[k], dtype=torch.float32, device=self.device).detach()
            for k in keys
        ])

    def train_step(self, batch) -> Tuple[List[str], torch.Tensor]:
        """One GAN step; returns (keys, fp32 device tensor of the step's scalars)."""
        data = common.video_to_float(batch["gt"].to(self.device, non_blocking=True))
        if self.grad_accum > 1:
            return self._accum_train_step(data)
        epoch, step = self.epoch, self.step
        out = self._model_forward(data, train=True)
        pred, info = out["pred_frames"].float(), {}

        # --- the discriminator first, on the detached reconstructions
        lm = self.loss_mod
        should_run = epoch >= lm.disc_self_start and (step + 1) % lm.d_update_freq == 0
        with torch.set_grad_enabled(should_run):
            d_loss, d_info = lm.discriminator_loss(data, pred.detach(), epoch, train=True,
                                                   update_ema=should_run)
        if should_run and float(self._data_mean(d_loss.detach())) > lm.d_update_loss_threshold:
            self.opt_d.zero_grad(set_to_none=True)
            d_loss.backward()
            self.sync_grads(self.disc.parameters())
            if self.clip_grad_max_norm > 0:
                torch.nn.utils.clip_grad_norm_(self.disc.parameters(), self.clip_grad_max_norm)
            _set_lr(self.opt_d, self.d_sched(step))
            self.opt_d.step()
        info.update(d_info)

        # --- the generator, against the updated discriminator (frozen here)
        self.disc.requires_grad_(False)
        try:
            total, g_info = self._generator_total(data, pred, out, epoch)
            self.opt_g.zero_grad(set_to_none=True)
            total.backward()
        finally:
            self.disc.requires_grad_(True)
        self._generator_update(step)
        info.update(g_info)
        self._metrics(info, data, pred, out, total)
        self.step += 1
        return self._pack(info)

    def _generator_update(self, step: int) -> None:
        """The data axis's gradient mean, one global clip over every generator
        parameter, the G optimizer's step at each group's learning rate, then
        the EMAs."""
        self.sync_grads()
        if self.clip_grad_max_norm > 0:
            self._clip_generator()
        _set_lr(self.opt_g, self.g_sched(step))
        fsdp_lib.optimizer_step(self.opt_g)
        if self.ema_params:
            params = dict(self.model.named_parameters())
            for d, ema in self.ema_params.items():
                ema_update(ema, params, float(d))

    def _accum_train_step(self, data_all: torch.Tensor) -> Tuple[List[str], torch.Tensor]:
        """`grad_accum_steps` A > 1: A equal microbatches against the
        discriminator of the step's start; both optimizers' gradients summed
        (fp32 parameters, so fp32 sums), then one update each from the mean."""
        A, B = self.grad_accum, data_all.shape[0]
        if B % A:
            raise ValueError(f"grad_accum_steps={A} must divide the per-step batch {B}")
        epoch, step, lm = self.epoch, self.step, self.loss_mod
        should_run = epoch >= lm.disc_self_start and (step + 1) % lm.d_update_freq == 0
        ema0 = (lm.lecam_ema_real.clone(), lm.lecam_ema_fake.clone())
        self.opt_g.zero_grad(set_to_none=True)
        self.opt_d.zero_grad(set_to_none=True)
        d_losses, infos = [], []
        for data in data_all.chunk(A):
            out = self._model_forward(data, train=True)
            pred, info = out["pred_frames"].float(), {}
            # the LeCam EMA chains through the microbatches; kept if D runs
            with torch.set_grad_enabled(should_run):
                d_loss, d_info = lm.discriminator_loss(data, pred.detach(), epoch, train=True)
            if should_run:
                d_loss.backward()
            info.update(d_info)
            self.disc.requires_grad_(False)
            try:
                total, g_info = self._generator_total(data, pred, out, epoch)
                total.backward()
            finally:
                self.disc.requires_grad_(True)
            info.update(g_info)
            self._metrics(info, data, pred, out, total)
            d_losses.append(d_loss.detach())
            infos.append(info)
        if (should_run and float(self._data_mean(torch.stack(d_losses).mean()))
                > lm.d_update_loss_threshold):
            self.sync_grads(self.disc.parameters())
            for p in self.disc.parameters():
                p.grad.div_(A)
            if self.clip_grad_max_norm > 0:
                torch.nn.utils.clip_grad_norm_(self.disc.parameters(), self.clip_grad_max_norm)
            _set_lr(self.opt_d, self.d_sched(step))
            self.opt_d.step()
        self.opt_d.zero_grad(set_to_none=True)
        if not should_run:
            lm.lecam_ema_real.copy_(ema0[0])
            lm.lecam_ema_fake.copy_(ema0[1])
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(A)
        self._generator_update(step)
        self.step += 1
        keys, packed = zip(*(self._pack(info) for info in infos))
        if any(k != keys[0] for k in keys):
            raise RuntimeError(f"microbatches logged different keys: {keys}")
        return keys[0], torch.stack(packed).mean(dim=0)

    @torch.no_grad()
    def evaluate_step(self, batch) -> Dict[str, float]:
        data = common.video_to_float(batch["gt"].to(self.device, non_blocking=True))
        out = self._model_forward(data, train=False)
        pred, info = out["pred_frames"].float(), {}
        _, d_info = self.loss_mod.discriminator_loss(data, pred, self.epoch, train=False)
        info.update(d_info)
        total, g_info = self._generator_total(data, pred, out, self.epoch)
        info.update(g_info)
        self._metrics(info, data, pred, out, total)
        keys, packed = self._pack(info)
        if self.fvd_calc is not None and data.shape[2] >= 10:
            try:
                self._fake_stats = self.fvd_calc.get_feature_stats_for_batch(
                    pred.clamp(0.0, 1.0), self._fake_stats)
                self._real_stats = self.fvd_calc.get_feature_stats_for_batch(
                    data, self._real_stats)
            except Exception as e:  # FVD never stops training
                self.log(f"eval FVD feature pass failed: {e}")
                self.fvd_calc = None
        return dict(zip(keys, packed.tolist()))

    def evaluate_epoch(self):
        self._fake_stats = self._real_stats = None
        super().evaluate_epoch()
        if (self.fvd_calc is not None and self._fake_stats is not None
                and self._fake_stats.num_items > 1):
            try:
                fvd = self.fvd_calc.calculate_fvd(self._fake_stats, self._real_stats)
            except Exception as e:  # recorded as 99999.99, as the reference does
                self.log(f"FVD computation failed: {e}")
                fvd = 99999.99
            self.current_fvd = float(fvd)
            self.log(f"eval rFVD: {self.current_fvd:.3f}")
            self.log_temp_scalar("eval/rfvd", self.current_fvd)

    def visualize_epoch(self):
        """`vis/epoch_<epoch>.png`: for up to 4 clips of the first test set's
        first batch, a row of ground-truth frames over a row of
        reconstructed ones. A failure is logged: visualization never stops
        training (the JAX trainer's rule)."""
        if not self.test_datasets:
            return
        try:
            batch = next(iter(self.test_loader(next(iter(self.test_datasets)))))
            data = common.video_to_float(batch["gt"][:4].to(self.device))
            with torch.no_grad():  # every rank: the forward may be split over the mesh
                pred = self._model_forward(data, train=False)["pred_frames"].float()
            if not self.is_master:
                return
            vis_dir = common.ensure_path(os.path.join(self.save_dir, "vis"))
            gt, pred = data.cpu().numpy(), pred.cpu().numpy()
            grid = common.save_video_grid(os.path.join(vis_dir, f"epoch_{self.epoch}.png"),
                                          [v for pair in zip(gt, pred) for v in pair])
            if self.writer is not None:
                self.writer.add_image("vis/gt_vs_recon_grid", grid, self.epoch,
                                      dataformats="HWC")
                try:  # [gt..., recon...] as [N, T, C, H, W] uint8
                    vids = np.concatenate([gt, np.clip(pred, 0, 1)], axis=0)
                    self.writer.add_video(
                        "vis/gt_vs_recon",
                        torch.from_numpy((vids.transpose(0, 2, 1, 3, 4) * 255).astype(np.uint8)),
                        self.epoch)
                except Exception:
                    pass  # add_video needs moviepy
        except Exception as e:  # visualization must never kill training
            self.log(f"visualize_epoch failed: {e}")

    # ----------------------------------------------------------- checkpoints

    def checkpoint_meta(self):
        meta = super().checkpoint_meta()
        meta["model"] = meta["cfg"]["model"]
        return meta

    def state_for_checkpoint(self, on_every_rank: bool = False) -> Dict[str, Any]:
        lay, keep = self.layout, on_every_rank
        return {
            "params": fsdp_lib.full_state_dict(self.model, lay, keep),
            "loss_params": self.loss_mod.state_dict(),  # the LeCam EMAs are its buffers
            "opt_g": fsdp_lib.full_optimizer_state(self.opt_g, self.model, lay, keep),
            "opt_d": self.opt_d.state_dict(),
            "ema_params": {d: fsdp_lib.full_tensors(e, self.model, lay, keep)
                           for d, e in self.ema_params.items()},
            "step": self.step,
            "rng": {k: g.get_state() for k, g in self._generators().items()},
        }

    def load_state(self, state: Dict[str, Any]):
        lay = self.layout
        fsdp_lib.load_full_state_dict(self.model, state["params"], lay)
        fsdp_lib.load_optimizer_state(self.opt_g, self.model, state["opt_g"], lay)
        self.ema_params = {d: fsdp_lib.placed_tensors(e, self.model, lay)
                           for d, e in state["ema_params"].items()}
        self.loss_mod.load_state_dict(state["loss_params"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.step = int(state["step"])
        gens = self._generators()
        for k, s in state.get("rng", {}).items():
            gens[k].set_state(s)
