"""Data-parallel training and evaluation over the cards of one host, timed.

    torchrun --standalone --nproc_per_node=N -m nuhtc_tpu_torch.tools.profile_parallel

Rank 0 makes the synthetic PanNuke release of ``chip_smoke.py``'s phase 10
(``tools/synthetic.py synthetic_pannuke``, seed 0, TILES tiles of SIZE²)
converted by ``tools.preprocess_pannuke``, and the seed-0 weights with the
objectness lifted saved as a ``.pth``, in a temporary directory whose path
every rank receives. Then, on every rank, on ``cuda:LOCAL_RANK`` (NCCL):
``tools.train --launcher pytorch`` on the PanNuke config for STEPS steps
without evaluation (the config's ``samples_per_gpu`` a rank), each step's
split recorded (loader wait, forward, backward, optimizer + EMA), the
collectives' calls and bytes, and a checksum of the final weights (every
rank's must be equal); then ``tools.test --launcher pytorch`` over the tiles
from the ``.pth``. Rank 0 prints the card's name and power limit and one
line ``profile_parallel: {json}``: the world size, s/step of each rank after
the first step (median), global train img/s, the evaluation's img/s and its
split on rank 0. Every time is the host's clock around synchronized work.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import tempfile

import numpy as np

CONFIG = "configs/nuhtc/htc_lite_swin_fpn_pannuke.py"
TILES, SIZE, STEPS = 64, 256, 6


def _release(root: str) -> dict:
    """The release, the ``.pth``, the data options and the train config (rank
    0). Without Pillow (its JPEG codec) the train config's ``RandCorrupt``
    draws from the other 18 corruptions."""
    import importlib.util

    import torch

    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.pipelines import CORRUPTIONS
    from nuhtc_tpu_torch.tools import preprocess_pannuke
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_pannuke

    images, masks, types = synthetic_pannuke(np.random.RandomState(0), TILES, SIZE)
    paths = []
    for name, arr in (("images", images), ("masks", masks), ("types", types)):
        paths.append(os.path.join(root, f"{name}.npy"))
        np.save(paths[-1], arr)
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess_pannuke.main(["--images", paths[0], "--masks", paths[1], "--types", paths[2],
                                 "--fold", "3", "--out-dir", os.path.join(root, "datasets"),
                                 "--coco-dir", os.path.join(root, "coco")])
    engine = init_detector(CONFIG, None, batch_size=1, device="cpu")
    lift_objectness(engine.model)
    ckpt = os.path.join(root, "seed0.pth")
    torch.save({"state_dict": engine.model.state_dict()}, ckpt)
    train_cfg = os.path.join(root, "train_config.py")
    lines = [f"_base_ = {os.path.abspath(CONFIG)!r}"]
    if importlib.util.find_spec("PIL") is None:
        pipeline = Config.fromfile(CONFIG).to_dict().get("train_pipeline", [])
        for t in pipeline:
            if t["type"] == "RandCorrupt":
                t["corruption"] = [n for n in CORRUPTIONS if n != "jpeg_compression"]
        lines.append(f"train_pipeline = {pipeline!r}")
    with open(train_cfg, "w") as f:
        f.write("\n".join(lines) + "\n")
    ds = os.path.join(root, "datasets")
    ann = os.path.join(root, "coco", "PanNuke_annt_RLE_fold3.json")
    return dict(ckpt=ckpt, config=train_cfg, train=[f"data.train.dataset.ann_file={ann}",
                                  f"data.train.dataset.img_prefix={ds}/rgb/",
                                  f"data.train.dataset.seg_prefix={ds}/rgb_seg"],
                test=[f"data.test.ann_file={ann}", f"data.test.img_prefix={ds}/rgb/",
                      f"data.test.seg_prefix={ds}/rgb_seg"])


def main() -> int:
    import torch

    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.parallel import mesh as P
    from nuhtc_tpu_torch.tools import test as test_tool
    from nuhtc_tpu_torch.tools import train as train_tool

    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("profile_parallel: start it with torchrun")
    world = P.init_distributed(device=P.local_device())
    rank = P.world()[0]
    try:
        root = tempfile.mkdtemp() if rank == 0 else None
        if rank == 0:
            data = _release(root)
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True)
            print(smi.stdout.strip().splitlines()[0], flush=True)
        root, data = P.gather_objects((root, data if rank == 0 else None))[0]

        timing = []
        P.reset_collectives()
        state = train_tool.main([data["config"], "--work-dir", os.path.join(root, "work"),
                                 "--launcher", "pytorch", "--iters-per-epoch", str(STEPS),
                                 "--max-epochs", "1", "--no-validate",
                                 "--cfg-options", *data["train"], *data["test"]],
                                trainer_kw=dict(record_timing=timing))
        collectives = {k: list(v) for k, v in P.COLLECTIVES.items()}
        with torch.no_grad():
            checksum = float(sum(p.double().sum() for p in state.params.values()))
        steps = [sum(t.values()) for t in timing[1:]] or [sum(timing[0].values())]
        mine = dict(rank=rank, s_step=float(np.median(steps)), checksum=checksum,
                    split={k: float(np.median([t[k] for t in timing[1:] or timing]))
                           for k in timing[0]})
        ranks = P.gather_objects(mine)

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            test_tool.main([CONFIG, data["ckpt"], "--launcher", "pytorch",
                            "--batch-size", "16", "--cfg-options", *data["test"]])
        if rank == 0:
            summary = json.loads([ln for ln in out.getvalue().splitlines()
                                  if ln.startswith("test: ")][-1][6:])
            if len({r["checksum"] for r in ranks}) != 1:
                raise AssertionError(f"profile_parallel: the ranks' weights differ: {ranks}")
            cfg = Config.fromfile(CONFIG)
            batch = cfg.get("samples_per_gpu", None) or cfg.data.get("samples_per_gpu", 8)
            s_step = max(r["s_step"] for r in ranks)
            print("profile_parallel: " + json.dumps(dict(
                world=world, steps=STEPS, tiles=TILES, s_step_by_rank=[
                    r["s_step"] for r in ranks], split_rank0=ranks[0]["split"],
                train_img_per_s=world * batch / s_step, collectives_rank0=collectives,
                test=summary)), flush=True)
        P.barrier()
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    finally:
        P.destroy_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
