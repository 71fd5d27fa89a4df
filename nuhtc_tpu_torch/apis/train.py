"""Train API (port of nuhtc_tpu/apis/train.py; reference nuhtc/apis/train.py:
``set_random_seed``, ``train_detector``)."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


def set_random_seed(seed: int, deterministic: bool = False) -> int:
    """Seeds Python, numpy and torch; ``deterministic`` also sets
    ``torch.use_deterministic_algorithms(True)`` (``warn_only``: an op
    without a deterministic implementation warns instead of raising; cuBLAS
    gets the workspace setting it needs for that). The port's own kernels
    add in a fixed order (K4's backward gathers, without atomics), and no op
    of the supervised train step draws that warning, so two runs of one seed
    give the same weights bit for bit on the card."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        import os

        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.benchmark = False
    return seed


def train_detector(model, dataset, cfg, work_dir: str, test_dataset=None,
                   resume_from: Optional[str] = None, seed: int = 0,
                   compute_dtype: Optional[torch.dtype] = None, **trainer_kw):
    """The loader and ``Trainer`` as tools/train.py builds them:
    ``samples_per_gpu`` from the config (or ``data.samples_per_gpu``),
    iterations per epoch from the dataset's size; a ``SemiDataset`` takes the
    ``SemiPrefetchLoader`` with ``sup_ratio`` and ``unsup_strong_pipeline``.
    ``model``: the detector on its device, f32; ``compute_dtype``: bf16 on
    the card. Returns the final train state.

    As in the JAX package, a config without ``train_pipeline`` (the semi
    template) gets an empty pipeline: its supervised images reach the model
    as raw 0-255 pixels, while the unlabelled views are normalized."""
    from nuhtc_tpu_torch.data.loader import PrefetchLoader, SemiDataset, SemiPrefetchLoader
    from nuhtc_tpu_torch.data.pipelines import build_train_pipeline
    from nuhtc_tpu_torch.train.trainer import Trainer

    pipeline = build_train_pipeline(cfg.get("train_pipeline", []))
    batch_size = cfg.get("samples_per_gpu", None) or cfg.get("data", {}).get(
        "samples_per_gpu", 8)
    if isinstance(dataset, SemiDataset):
        strong = cfg.get("unsup_strong_pipeline")
        loader = SemiPrefetchLoader(
            dataset, pipeline, strong_pipeline=build_train_pipeline(strong) if strong else None,
            batch_size=batch_size, sup_ratio=cfg.get("sup_ratio", 0.5), seed=seed)
    else:
        loader = PrefetchLoader(dataset, pipeline, batch_size=batch_size, seed=seed)
    trainer_kw.setdefault("max_epochs", cfg.get("max_epochs", 200))
    trainer_kw.setdefault("iters_per_epoch", max(len(dataset) // batch_size, 1))
    trainer_kw.setdefault("checkpoint_interval", cfg.get("checkpoint_interval", 10))
    trainer_kw.setdefault("eval_interval", cfg.get("evaluation", {}).get("interval", 10))
    trainer = Trainer(model, cfg, work_dir, seed=seed, compute_dtype=compute_dtype, **trainer_kw)
    try:
        return trainer.run(loader, test_dataset, resume_from=resume_from)
    finally:
        loader.close()
