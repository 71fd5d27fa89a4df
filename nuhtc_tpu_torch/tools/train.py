"""Train the port's detector (the command line of tools/train.py, as a
module; reference tools/train.py).

  python -m nuhtc_tpu_torch.tools.train configs/nuhtc/htc_lite_swin_fpn_pannuke.py \\
      [--work-dir DIR] [--resume-from CKPT] [--cfg-options k=v ...] [--device cpu]
  python -m nuhtc_tpu_torch.tools.train configs/nuhtc/semi_base.py ...
  torchrun --standalone --nproc_per_node=N -m nuhtc_tpu_torch.tools.train <config> \\
      --launcher pytorch [...]

A config with ``semi_wrapper`` and a ``SemiDataset`` trains the teacher and
student of the semi-supervised recipe (``SemiPrefetchLoader``, the
teacher/student step); its checkpoints hold both.

The JAX script's arguments plus ``--device`` (default the first CUDA device,
which raises without one; ``cpu`` trains on the CPU in f32). On the card
the forward runs under bf16 autocast, parameters, gradients, AdamW and the
EMA stay f32. Writes <work-dir>/train.log, <work-dir>/log.json and
<work-dir>/checkpoints/step_<epoch>.pt; without --work-dir the config's
``work_dir`` or ./work_dirs/<config name>. Weights start from a seed
(``init_random_weights``).

``--launcher pytorch`` (the reference's name; the JAX script's ``jax``)
trains data-parallel, one process per card as torchrun starts them: the
process group from torchrun's environment (NCCL on the cards, gloo with
``--device cpu``; without that environment it raises), each process on
``cuda:LOCAL_RANK`` unless ``--device`` names one, ``samples_per_gpu``
images a rank, the global batch's loss and gradient (``parallel.mesh``);
rank 0 writes the logs and checkpoints.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Train NuHTC with the PyTorch port")
    ap.add_argument("config")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--resume-from", default=None,
                    help="a checkpoint file (step_<n>.pt) or a checkpoint directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--iters-per-epoch", type=int, default=None)
    ap.add_argument("--cfg-options", nargs="+", default=None)
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the periodic evaluation (reference --no-validate)")
    ap.add_argument("--deterministic", action="store_true",
                    help="seed Python, numpy and torch and ask torch for deterministic "
                    "algorithms (reference --deterministic): two runs of one seed give "
                    "the same weights bit for bit")
    ap.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                    help="'pytorch' = data-parallel over the processes torchrun "
                    "starts (reference init_dist, tools/train.py:136)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' trains on the CPU")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, trainer_kw: Optional[dict] = None):
    """Runs the training; returns the final train state. ``trainer_kw``
    (from Python only) reaches ``Trainer``, e.g. ``record_timing=[]``."""
    args = parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import resolve_device
    from nuhtc_tpu_torch.parallel import mesh as P

    device = resolve_device(args.device, "train")
    with P.launched(args.launcher, device, args.device is not None) as (device, rank, world):
        if world > 1 or P.is_distributed():
            print(f"distributed: rank {rank} of {world} on {device}", flush=True)
        return _train(args, device, rank, world, trainer_kw)


def _train(args, device, rank: int, world: int, trainer_kw: Optional[dict]):
    import torch

    from nuhtc_tpu_torch.apis.train import set_random_seed, train_detector
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.models.build import build_detector, init_random_weights

    if args.deterministic:
        set_random_seed(args.seed, deterministic=True)
    # f32 products stay f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    work_dir = args.work_dir or cfg.get("work_dir") or (
        "./work_dirs/" + os.path.splitext(os.path.basename(args.config))[0])

    train_ds = build_dataset(cfg.data.train)
    test_ds = None
    if "test" in cfg.data and not args.no_validate:
        try:
            test_ds = build_dataset({**cfg.data.test, "test_mode": True})
        except FileNotFoundError:
            pass
    model = build_detector(cfg.model, cfg.model.get("test_cfg"),
                           float(cfg.get("scale_factor", 2.0)))
    init_random_weights(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    batch_size = cfg.get("samples_per_gpu", None) or cfg.get("data", {}).get(
        "samples_per_gpu", 8)
    # checkpoint_config = dict(interval=, max_keep_ckpts=) is the reference
    # schema; checkpoint_interval the flat shorthand
    ckpt_cfg = cfg.get("checkpoint_config", {}) or {}
    kw = dict(max_epochs=args.max_epochs or cfg.get("max_epochs", 200),
              iters_per_epoch=args.iters_per_epoch or max(len(train_ds) // batch_size, 1),
              log_interval=cfg.get("log_interval", 50),
              checkpoint_interval=cfg.get("checkpoint_interval", ckpt_cfg.get("interval", 10)),
              max_keep_ckpts=ckpt_cfg.get("max_keep_ckpts", 40),
              eval_interval=cfg.get("evaluation", {}).get("interval", 10),
              **(trainer_kw or {}))
    return train_detector(model, train_ds, cfg, work_dir, test_dataset=test_ds,
                          resume_from=args.resume_from, seed=args.seed,
                          compute_dtype=torch.bfloat16 if device.type == "cuda" else None,
                          rank=rank, world_size=world, **kw)


if __name__ == "__main__":
    main()
