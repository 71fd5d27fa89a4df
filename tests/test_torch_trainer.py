"""The port's trainer and train command line on the CPU.

``python -m nuhtc_tpu_torch.tools.train`` (through ``main(argv)``) with
``--device cpu`` on the tiny synthetic config (Swin embed 32, depths
1-1-1-1, FPN 32; scale 1, B2), its Resize cut to 128² to keep the CPU run
short, over a synthetic PanNuke release of 128² tiles
(``tools.synthetic.synthetic_pannuke``, seed 0) converted by
``tools.preprocess_pannuke``: two epochs of one step with evaluation of the
EMA weights after each, then ``--resume-from`` a checkpoint for a third
epoch, then an automatic resume that finds nothing left to do. Checked: the
``train.log`` and ``log.json`` lines of the JAX trainer (every loss,
``lr``, ``grad_norm``, the val rows), the checkpoint files and their
contents, the resumed step count and state, the frozen stage-0 leaves
bit-equal (the step count is below ``finetune_iter``), and
``init_detector(checkpoint, use_ema=...)`` on the EMA and the raw weights.
Without ``--device`` on a host without CUDA the command raises, as does an
explicit resume from nothing. The semi-supervised recipe trains in
test_torch_semi.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from nuhtc_tpu_torch.apis.inference import init_detector
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.models.build import build_detector
from nuhtc_tpu_torch.tools import preprocess_pannuke
from nuhtc_tpu_torch.tools import train as train_tool
from nuhtc_tpu_torch.tools.synthetic import synthetic_pannuke
from nuhtc_tpu_torch.train.train_state import frozen_mask
from nuhtc_tpu_torch.train.trainer import Trainer
from nuhtc_tpu_torch.utils import checkpoint as ckpt
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

CONFIG = "configs/nuhtc/htc_lite_tiny_synthetic.py"
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_semantic_seg", "s0.loss_cls", "s0.loss_obj",
          "s0.loss_bbox", "s1.loss_cls", "s2.loss_bbox", "s2.loss_mask")


TILE = 128


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """The release's tree and a config on it: the tiny config with its
    Resize at the tiles' 128²."""
    root = tmp_path_factory.mktemp("release")
    images, masks, types = synthetic_pannuke(np.random.RandomState(0), 6, TILE)
    for fold, sl in ((1, slice(0, 4)), (3, slice(4, 6))):
        paths = []
        for name, arr in (("images", images), ("masks", masks), ("types", types)):
            paths.append(str(root / f"{name}{fold}.npy"))
            np.save(paths[-1], arr[sl])
        assert preprocess_pannuke.main([
            "--images", paths[0], "--masks", paths[1], "--types", paths[2],
            "--fold", str(fold), "--out-dir", str(root / "datasets"),
            "--coco-dir", str(root / "coco")]) == 0
    pipeline = Config.fromfile(CONFIG).to_dict()["train_pipeline"]
    for t in pipeline:
        if t["type"] == "Resize":
            t["img_scale"] = (TILE, TILE)
    with open(root / "tiny128.py", "w") as f:
        f.write(f"_base_ = {os.path.abspath(CONFIG)!r}\ntrain_pipeline = {pipeline!r}\n")
    return root


def _options(root):
    ds = f"{root}/datasets"
    # EMA momentum 0.5: at the warm-up's lr (1e-7) the default 2e-4 moves
    # the EMA of a norm's weight of 1.0 by less than half an f32 ulp
    return ["--cfg-options", "log_interval=1", "evaluation.interval=1", "ema.momentum=0.5",
            f"data.train.dataset.ann_file={root}/coco/PanNuke_annt_RLE_fold1.json",
            f"data.train.dataset.img_prefix={ds}/rgb/",
            f"data.train.dataset.seg_prefix={ds}/rgb_seg",
            f"data.test.ann_file={root}/coco/PanNuke_annt_RLE_fold3.json",
            f"data.test.img_prefix={ds}/rgb/", f"data.test.seg_prefix={ds}/rgb_seg"]


def _json_rows(work):
    with open(os.path.join(work, "log.json")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_trains_checkpoints_resumes_and_loads_ema(release, tmp_path):
    work = str(tmp_path / "work")
    base = [str(release / "tiny128.py"), "--device", "cpu", "--work-dir", work,
            "--iters-per-epoch", "1"]

    state = train_tool.main(base + ["--max-epochs", "2"] + _options(release))
    assert state.step == 2 and state.opt_state.count == 2
    ck = os.path.join(work, "checkpoints")
    assert sorted(os.listdir(ck)) == ["step_1.pt", "step_2.pt"]
    rows = _json_rows(work)
    train_rows = [r for r in rows if r["mode"] == "train"]
    val_rows = [r for r in rows if r["mode"] == "val"]
    assert [(r["epoch"], r["iter"]) for r in train_rows] == [(1, 1), (2, 1)]
    for r in train_rows:
        assert all(np.isfinite(r[k]) for k in LOSSES + ("total", "grad_norm", "lr"))
    assert 0 < train_rows[0]["lr"] < train_rows[-1]["lr"] < 1e-4  # warm-up
    assert [(r["epoch"], r["tag"]) for r in val_rows] == [(1, "ema"), (2, "ema")]
    with open(os.path.join(work, "train.log")) as f:
        log = f.read()
    assert "Epoch [2][1/1] lr: " in log and "saved checkpoint @ epoch 2" in log
    assert "eval[ema]: " in log

    blob = ckpt.read_checkpoint(ck)
    assert blob["step"] == 2 and blob["opt_count"] == 2
    # the weights after training: frozen stage-0 leaves unchanged, the rest moved
    first = torch.load(os.path.join(ck, "step_1.pt"), weights_only=True)
    frozen = frozen_mask(blob["ema_params"])
    assert 0 < sum(frozen.values()) < len(frozen)
    for k in blob["ema_params"]:
        same = torch.equal(blob["params"][k], first["params"][k])
        assert same == frozen[k], k
        if frozen[k]:  # the EMA of a fixed leaf stays on it (up to rounding)
            assert torch.allclose(blob["ema_params"][k], blob["params"][k], atol=1e-6), k
        else:
            assert not torch.equal(blob["ema_params"][k], first["ema_params"][k]), k

    # an explicit resume continues from the file's state
    state = train_tool.main(base + ["--max-epochs", "3", "--resume-from",
                                    os.path.join(ck, "step_2.pt")] + _options(release))
    assert state.step == 3 and state.opt_state.count == 3
    assert sorted(os.listdir(ck)) == ["step_1.pt", "step_2.pt", "step_3.pt"]
    with open(os.path.join(work, "train.log")) as f:
        assert "resumed from epoch 2" in f.read()
    assert [(r["epoch"], r["iter"]) for r in _json_rows(work) if r["mode"] == "train"][-1] \
        == (3, 1)
    # an automatic resume from the work directory: nothing left to train
    state = train_tool.main(base + ["--max-epochs", "3"] + _options(release))
    assert state.step == 3
    with open(os.path.join(work, "train.log")) as f:
        assert "auto-resumed from epoch 3" in f.read()

    last = ckpt.read_checkpoint(ck)
    for use_ema, key in ((True, "ema_params"), (False, "params")):
        engine = init_detector(CONFIG, ck, batch_size=2, device="cpu", use_ema=use_ema,
                               tile_size=TILE)
        sd = engine.model.state_dict()
        for k, v in last[key].items():
            assert torch.equal(sd[k], v), (use_ema, k)
    tile = np.full((TILE, TILE, 3), 200, np.uint8)
    res = engine.run_batch([tile])
    assert len(res) == 1 and np.isfinite(res[0]["scores"]).all()


def test_train_cli_without_device_raises_on_a_host_without_cuda(release, tmp_path,
                                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tool.main([str(release / "tiny128.py"), "--work-dir", str(tmp_path)]
                        + _options(release))


def test_trainer_raises_on_an_empty_resume(tmp_path):
    cfg = Config.fromfile(CONFIG)
    det = build_detector(cfg.model, None, 1.0)
    with pytest.raises(FileNotFoundError, match="no loadable checkpoint"):
        Trainer(det, cfg, str(tmp_path / "b")).run(iter([]), resume_from=str(tmp_path / "x"))


def test_weighter_equals_jax():
    """Scheduled loss weights (the reference Weighter hook) at steps on and
    around the boundaries, "total" recomputed without aggregate keys."""
    import jax.numpy as jnp

    from nuhtc_tpu.utils.hooks import build_weighter as j_build
    from nuhtc_tpu_torch.utils.hooks import build_weighter

    spec = {"s2.loss_mask": dict(steps=[10, 20], vals=[0.5, 1.0, 2.0]), "loss_rpn_cls": 3.0}
    losses = {"s2.loss_mask": 0.25, "loss_rpn_cls": 0.5, "s0.loss_cls": 1.5,
              "sup.total": 9.0, "total": 2.25}
    got_w, want_w = build_weighter(spec), j_build(spec)
    for step in (0, 9, 10, 19, 20, 35):
        got = got_w({k: torch.tensor(v) for k, v in losses.items()}, step)
        want = want_w({k: jnp.float32(v) for k, v in losses.items()}, jnp.int32(step))
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(float(got[k]) - float(want[k])) < 1e-6, (step, k)
    assert build_weighter(None) is None


def test_metric_logger_raises_by_name_without_its_writer(monkeypatch, tmp_path):
    import sys

    from nuhtc_tpu_torch.utils.logging import MetricLogger

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="tensorboardX"):
        MetricLogger(str(tmp_path))
