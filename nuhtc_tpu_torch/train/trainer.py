"""Epoch-based training on one device or data-parallel over a process group
(port of nuhtc_tpu/train/trainer.py; the mmcv EpochBasedRunner equivalent):
the threaded loader, the AdamW + EMA
step (or, for a config with ``semi_wrapper``, the teacher/student step),
text and json logs (``train.log``, ``log.json``, the JAX trainer's lines),
checkpoints every ``checkpoint_interval`` epochs keeping
``max_keep_ckpts``, explicit and automatic resume, and evaluation every
``eval_interval`` epochs, of the EMA weights (the teacher's and the
student's in a semi run) through the port's ``InferenceEngine`` and
``evaluate_dataset``.

In a process group (``parallel.mesh.init_distributed``) every rank trains on
its own local batches, the step sums the gradients over the ranks, and the
metrics it returns are the global batch's. The parameters start as rank 0's
(broadcast after any resume, which every rank reads). Rank 0 alone writes
``log.json``, ``train.log``, the checkpoints and the evaluations; the other
ranks wait for it at a barrier after each checkpoint and evaluation. Every
rank logs its device.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from nuhtc_tpu_torch.parallel import mesh as P
from nuhtc_tpu_torch.utils.logging import get_root_logger


class Trainer:
    def __init__(self, model: torch.nn.Module, cfg, work_dir: str, max_epochs: int = 200,
                 iters_per_epoch: int = 1000, log_interval: int = 50,
                 checkpoint_interval: int = 10, eval_interval: int = 10,
                 max_keep_ckpts: int = 40, seed: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 record_timing: Optional[list] = None, rank: int = 0):
        """``model``: the detector on its device, f32 (the student of a semi
        run). ``compute_dtype``: the forward's type under autocast (bf16 on
        the card), None for f32. ``record_timing``: a list that receives each
        step's synchronized split (loader_wait_s, forward_s, backward_s,
        optimizer_s: the optimizer and the EMA; teacher_s in a semi run,
        which forward_s leaves out). ``rank``: this process's rank in the
        process group; only rank 0 writes files."""
        self.model = model
        self.cfg = cfg
        self.work_dir = work_dir
        self.max_epochs = max_epochs
        self.iters_per_epoch = iters_per_epoch
        self.log_interval = log_interval
        self.checkpoint_interval = checkpoint_interval
        self.eval_interval = eval_interval
        self.max_keep_ckpts = max_keep_ckpts
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.record_timing = record_timing
        self.rank = rank
        if rank == 0:
            os.makedirs(work_dir, exist_ok=True)
        self.logger = get_root_logger(os.path.join(work_dir, "train.log") if rank == 0 else None)
        self.json_log = None  # log.json, open on rank 0 while run() runs

    def _hook_settings(self):
        """EMA momentum, the MeanTeacher hook's momentum (None when absent)
        and the unfreeze step, from the flat keys or the reference's
        ``custom_hooks`` (LinearMomentumEMAHook, MeanTeacher, FineTune)."""
        ema_momentum = self.cfg.get("ema", {}).get("momentum")
        finetune_iter = self.cfg.get("finetune_iter")
        teacher_momentum = None
        for hk in self.cfg.get("custom_hooks") or []:
            t = str(hk.get("type", ""))
            if t == "LinearMomentumEMAHook" and ema_momentum is None:
                ema_momentum = hk.get("momentum")
            if t == "MeanTeacher" and teacher_momentum is None:
                # the hook's own momentum, not the evaluation EMA's
                teacher_momentum = hk.get("momentum")
            if t == "FineTune" and finetune_iter is None:
                finetune_iter = hk.get("iter")
        return (2e-4 if ema_momentum is None else ema_momentum, teacher_momentum,
                15000 if finetune_iter is None else finetune_iter)

    def run(self, loader, test_dataset=None, resume_from: Optional[str] = None):
        """Trains from the start, a checkpoint or the work dir's newest
        checkpoint to ``max_epochs``; returns the train state."""
        log_json = (open(os.path.join(self.work_dir, "log.json"), "a") if self.rank == 0
                    else contextlib.nullcontext())
        with log_json as self.json_log:
            return self._run(loader, test_dataset, resume_from)

    def _run(self, loader, test_dataset, resume_from):
        from nuhtc_tpu_torch.train.optim_groups import build_named_optimizer
        from nuhtc_tpu_torch.train.train_state import lr_schedule
        from nuhtc_tpu_torch.utils import checkpoint as ckpt
        from nuhtc_tpu_torch.utils.hooks import WeightSummary, build_weighter

        model = self.model
        device = next(model.parameters()).device
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        rank, world = P.world()
        self.logger.info(f"rank {rank} of {world}: device {device} ({name})")
        if self.rank == 0 and self.cfg.get("weight_summary", True):
            WeightSummary()(model.named_parameters(), self.logger)
        elif self.rank == 0:
            n_params = sum(p.numel() for p in model.parameters())
            self.logger.info(f"params: {n_params / 1e6:.2f}M")

        schedule = lr_schedule(
            base_lr=self.cfg.get("optimizer", {}).get("lr", 1e-4),
            warmup_iters=self.cfg.get("lr_config", {}).get("warmup_iters", 1000),
            step_epochs=tuple(self.cfg.get("lr_config", {}).get("step", [30, 160])),
            iters_per_epoch=self.iters_per_epoch)
        weighter = build_weighter(self.cfg.get("loss_weight_schedules"))
        custom_keys = self.cfg.get("optimizer", {}).get("paramwise_cfg", {}).get("custom_keys")
        tx = None
        if custom_keys:  # built before the split: semi runs take custom_keys too
            tx = build_named_optimizer(
                [n for n, _ in model.named_parameters()], base_lr=schedule,
                weight_decay=self.cfg.get("optimizer", {}).get("weight_decay", 0.05),
                rules=[dict(pattern=k, **v) for k, v in dict(custom_keys).items()])
        state, train_step = self._make_step(schedule, tx, weighter)

        ckpt_dir = os.path.join(os.path.abspath(self.work_dir), "checkpoints")
        start_epoch = 0
        if resume_from:
            if not (os.path.isfile(resume_from) or ckpt.latest_step(resume_from) is not None):
                # an explicit resume with nothing to load must not start afresh
                raise FileNotFoundError(f"--resume-from {resume_from!r}: no loadable "
                                        "checkpoint found")
            start_epoch = self._resume(ckpt, resume_from, state)
            self.logger.info(f"resumed from epoch {start_epoch}")
        elif ckpt.latest_step(ckpt_dir) is not None:
            start_epoch = self._resume(ckpt, ckpt_dir, state)
            self.logger.info(f"auto-resumed from epoch {start_epoch}")
        # every rank starts from rank 0's weights and train state
        P.replicate([*model.parameters(), *model.buffers(), *self._state_tensors(state)])

        vis_hook = self._vis_hook(test_dataset) if self.rank == 0 else None
        generator = torch.Generator(device=device)
        it = iter(loader)
        t_start = time.time()
        for epoch in range(start_epoch, self.max_epochs):
            for i in range(self.iters_per_epoch):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(device, non_blocking=True)
                         for k, v in next(it).items()}
                wait = time.perf_counter() - t0
                # the step's draws are a function of (seed, step): a resumed
                # run draws what an uninterrupted one would
                generator.manual_seed((self.seed + 1) * 1_000_003 + state.step)
                timing = {} if self.record_timing is not None else None
                state, metrics = train_step(state, batch, generator, timing)
                if timing is not None:
                    timing["loader_wait_s"] = wait
                    self.record_timing.append(timing)
                gstep = epoch * self.iters_per_epoch + i
                if (i + 1) % self.log_interval == 0 and self.rank == 0:
                    self._log_train(epoch, i, schedule(gstep), metrics)
                if vis_hook is not None and gstep and gstep % vis_hook.interval == 0:
                    try:
                        vis_hook.maybe_log(gstep, next(iter(
                            self._eval_submodules(state).values())))
                    except Exception as e:  # the overlays must not stop training
                        self.logger.warning(f"mask_vis failed: {e}")
            if (epoch + 1) % self.checkpoint_interval == 0 or epoch + 1 == self.max_epochs:
                if self.rank == 0:
                    ckpt.save_checkpoint(ckpt_dir, state, model, step=epoch + 1,
                                         keep=self.max_keep_ckpts)
                    self.logger.info(f"saved checkpoint @ epoch {epoch + 1}")
                P.barrier()
            if test_dataset is not None and (epoch + 1) % self.eval_interval == 0:
                if self.rank == 0:
                    for name, sd in self._eval_submodules(state).items():
                        try:
                            self._evaluate(test_dataset, sd, tag=name, epoch=epoch + 1)
                        except Exception as e:  # evaluation must not stop training
                            self.logger.warning(f"eval[{name}] failed: {e}")
                P.barrier()
        self.logger.info(f"training done in {(time.time() - t_start) / 3600:.2f}h")
        return state

    def _make_step(self, schedule, tx, weighter):
        """The train state and step: the teacher/student ones when the
        config names ``semi_wrapper`` (teacher momentum from
        ``semi_wrapper.momentum``, else the MeanTeacher hook's, else 0.999;
        ``warm_up``, ``unsup_weight`` and ``burn_in`` from ``semi_wrapper``),
        else the supervised AdamW + EMA ones."""
        from nuhtc_tpu_torch.train import train_state as TS

        model = self.model
        ema_momentum, teacher_momentum, finetune_iter = self._hook_settings()
        num_stages = getattr(model, "num_stages", 1)  # MaskRCNN has one stage
        semi_cfg = self.cfg.get("semi_wrapper")
        if not semi_cfg:
            state, tx = TS.create_train_state(model, num_stages=num_stages,
                                              num_classes=model.num_classes,
                                              schedule=schedule, tx=tx)
            return state, TS.make_train_step(model, tx, ema_momentum=ema_momentum,
                                             finetune_iter=finetune_iter, weighter=weighter,
                                             compute_dtype=self.compute_dtype)
        from nuhtc_tpu_torch.models.semi import MultiStreamDetector

        wrapper = MultiStreamDetector(model, score_thr=semi_cfg.get("score_thr", 0.9),
                                      max_gt=semi_cfg.get("max_gt", 128))
        state, tx = TS.create_semi_train_state(model, wrapper.teacher,
                                               num_stages=num_stages,
                                               num_classes=model.num_classes,
                                               schedule=schedule, tx=tx)
        return state, TS.make_semi_train_step(
            wrapper, tx,
            teacher_momentum=semi_cfg.get("momentum") or teacher_momentum or 0.999,
            teacher_warmup=semi_cfg.get("warm_up", 100),
            unsup_weight=semi_cfg.get("unsup_weight", 1.0),
            burn_in=semi_cfg.get("burn_in", 0), finetune_iter=finetune_iter,
            weighter=weighter, compute_dtype=self.compute_dtype)

    @staticmethod
    def _state_tensors(state) -> list:
        """The train state's tensors besides the model's parameters: the
        moments, the EMA or the teacher, the seesaw counts."""
        out = [*state.opt_state.mu.values(), *state.opt_state.nu.values(), state.cum_samples]
        extra = state.teacher_params if hasattr(state, "teacher_params") else state.ema_params
        return out + list(extra.values())

    def _resume(self, ckpt, path: str, state) -> int:
        """Loads a checkpoint file or the newest of a directory into
        ``state``; returns its epoch."""
        if os.path.isdir(path):
            epoch = ckpt.latest_step(path)
            ckpt.load_checkpoint(path, state, self.model, epoch)
        else:
            ckpt.load_checkpoint(path, state, self.model)
            epoch = int(os.path.basename(path)[len("step_"):-len(".pt")])
        return epoch

    def _log_train(self, epoch: int, i: int, lr: float, metrics: Dict[str, torch.Tensor]):
        m = {k: float(v) for k, v in metrics.items()}
        self.logger.info(
            f"Epoch [{epoch + 1}][{i + 1}/{self.iters_per_epoch}] lr: {lr:.2e} "
            f"total: {m['total']:.4f} "
            + " ".join(f"{k}: {v:.4f}" for k, v in m.items() if k != "total"))
        self.json_log.write(json.dumps({"mode": "train", "epoch": epoch + 1, "iter": i + 1,
                                        "lr": lr, **m}) + "\n")
        self.json_log.flush()

    def _eval_submodules(self, state) -> Dict[str, Any]:
        """The state dicts to evaluate (the SubModulesDistEvalHook
        analogue): "teacher" and "student" in a semi run, else "ema" (the
        default) and "raw" (the trained weights); cfg key
        ``evaluated_modules`` picks among them."""
        raw = dict(self.model.state_dict())
        if hasattr(state, "teacher_params"):
            avail = {"teacher": dict(raw, **state.teacher_params), "student": raw}
            default = ("teacher", "student")  # semi runs evaluate both streams
        else:
            avail = {"ema": dict(raw, **state.ema_params), "raw": raw}
            default = ("ema",)
        wanted = self.cfg.get("evaluated_modules")
        if wanted:
            sel = {n: avail[n] for n in wanted if n in avail}
            missing = [n for n in wanted if n not in avail]
            if missing:
                self.logger.warning(f"evaluated_modules {missing} not on this train state "
                                    f"(available: {sorted(avail)})")
            if sel:
                return sel
        return {n: avail[n] for n in default}

    def _engine(self, state_dict, batch_size: int = 8):
        """An InferenceEngine on a copy of the model holding ``state_dict``,
        in the card's inference type (bf16 on CUDA)."""
        from nuhtc_tpu_torch.apis.inference import InferenceEngine

        model = copy.deepcopy(self.model)
        model.load_state_dict(state_dict, strict=True)
        device = next(model.parameters()).device
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        return InferenceEngine(model.to(dtype=dtype).eval(), batch_size=batch_size)

    def _vis_hook(self, test_dataset):
        vis_cfg = self.cfg.get("mask_vis")
        if vis_cfg is None:
            for h in self.cfg.get("custom_hooks") or []:
                if str(h.get("type", "")).lower().replace("_", "") == "maskvishook":
                    vis_cfg = {k: v for k, v in h.items() if k != "type"}
        if not vis_cfg or test_dataset is None:
            return None
        from nuhtc_tpu_torch.utils.hooks import MaskVisHook
        from nuhtc_tpu_torch.utils.logging import MetricLogger

        self.metric_logger = MetricLogger(os.path.join(self.work_dir, "tf_logs"))
        return MaskVisHook(lambda sd: self._engine(sd, batch_size=2), test_dataset,
                           self.metric_logger, interval=vis_cfg.get("interval", 2000),
                           num_images=vis_cfg.get("num_images", 2))

    def _evaluate(self, dataset, state_dict, limit: int = 256, tag: str = "ema",
                  epoch: Optional[int] = None):
        from nuhtc_tpu_torch.eval.evaluate import evaluate_dataset
        from nuhtc_tpu_torch.tools.test import _SlicedDataset, run_dataset

        engine = self._engine(state_dict)
        n = min(len(dataset), limit)
        results = run_dataset(engine, dataset, engine.batch_size, limit=n)
        metrics = evaluate_dataset(_SlicedDataset(dataset, n), results)
        self.logger.info(f"eval[{tag}]: " + " ".join(
            f"{k}: {v:.4f}" for k, v in metrics.items() if isinstance(v, float)))
        if epoch is not None:  # val rows, as analyze_logs plots them
            self.json_log.write(json.dumps(
                {"mode": "val", "epoch": epoch, "tag": tag,
                 **{k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}})
                + "\n")
            self.json_log.flush()
        return metrics
