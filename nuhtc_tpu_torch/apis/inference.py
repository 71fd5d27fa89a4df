"""Inference engine (port of nuhtc_tpu/apis/inference.py).

``init_detector`` builds the detector from a config, with weights from a
reference-format ``.pth`` state dict or, without one, random weights made
from a seed. ``InferenceEngine`` serves two contracts:

- the strict patch path (the defaults, as in the JAX package): tiles are
  resized (``cv2.INTER_LINEAR`` arithmetic), normalized and padded on the
  host (``data.pipelines.preprocess_test_image``), and every detection
  comes back with its own full-frame binary mask (``ops.mask_paste.paste_masks``);
- WSI mode (``device_preprocess=True, compact_masks=True``): uint8 tiles
  are uploaded, resized (half-pixel bilinear) and normalized on the device,
  and all detections of a tile are pasted into one int32 instance label map.

``dispatch`` enqueues a batch, ``collect`` waits for the device, downloads
and unpads per-image results on the host. ``TTAEngine`` adds flip test-time
augmentation on top of an engine.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.data.pipelines import IMG_NORM, preprocess_test_image
from nuhtc_tpu_torch.models.build import build_detector, init_random_weights
from nuhtc_tpu_torch.ops.components import resize_half_pixel
from nuhtc_tpu_torch.ops.mask_paste import paste_label_map, paste_masks as paste_fn
from nuhtc_tpu_torch.utils.profiling import span


class InferenceEngine:
    def __init__(self, model, batch_size: int = 8, tile_size: int = 256,
                 scale_factor: Optional[float] = None, paste_masks: bool = True,
                 device_preprocess: bool = False, compact_masks: bool = False):
        """``model``: a detector (NuHTC or MaskRCNN), already on its device
        and dtype.
        ``device_preprocess``: upload uint8 tiles and resize + normalize on
        the device. ``compact_masks``: one int32 instance label map per tile
        instead of N full-frame masks (overlapping pixels go to the
        higher-scoring detection). ``paste_masks``: without compact masks,
        paste each detection's mask into the tile frame on the device; when
        off, results carry the raw 28×28 ``mask_probs`` instead."""
        self.model = model.eval()
        self.batch_size = batch_size
        self.tile_size = tile_size
        # from the model unless overridden: a mismatch would return boxes in
        # the wrong frame (the model divides by its own scale_factor)
        self.scale_factor = (scale_factor if scale_factor is not None
                             else float(getattr(model, "scale_factor", 2.0)))
        self.num_classes = model.num_classes
        self.paste_masks = paste_masks and not compact_masks
        self.device_preprocess = device_preprocess
        self.compact_masks = compact_masks
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        # cumulative collect() attribution; callers read and reset it
        self.collect_timing = {"device_s": 0.0, "download_s": 0.0}

    @property
    def resized_size(self) -> int:
        return int(self.tile_size * self.scale_factor + 0.5)

    @property
    def input_size(self) -> int:
        return ((self.resized_size + 31) // 32) * 32  # Pad(size_divisor=32)

    def preprocess(self, imgs: Sequence[np.ndarray]) -> np.ndarray:
        """RGB uint8 images (tile_size²) → padded normalized f32 batch."""
        if len(imgs) > self.batch_size:
            raise ValueError(f"{len(imgs)} images for a batch of {self.batch_size}")
        out = np.zeros((self.batch_size, self.input_size, self.input_size, 3), np.float32)
        for i, im in enumerate(imgs):
            t = preprocess_test_image(im, self.scale_factor)
            out[i, :t.shape[0], :t.shape[1]] = t
        return out

    def preprocess_u8(self, imgs: Sequence[np.ndarray]):
        """uint8 tiles → ((B, tile, tile, 3) uint8 batch, resized extents
        hs, ws (B,) int32). Undersized tiles are edge-replicated."""
        t = self.tile_size
        out = np.zeros((self.batch_size, t, t, 3), np.uint8)
        hs = np.full((self.batch_size,), self.resized_size, np.int32)
        ws = np.full((self.batch_size,), self.resized_size, np.int32)
        for i, im in enumerate(imgs):
            im = im[:t, :t]
            h, w = im.shape[:2]
            if (h, w) != (t, t):
                im = np.pad(im, ((0, t - h), (0, t - w), (0, 0)), mode="edge")
                hs[i] = int(round(h * self.scale_factor))
                ws[i] = int(round(w * self.scale_factor))
            out[i] = im
        return out, hs, ws

    def _prep(self, x_u8: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
        rs, size = self.resized_size, self.input_size
        x = resize_half_pixel(x_u8.float().permute(0, 3, 1, 2), (rs, rs)).permute(0, 2, 3, 1)
        mean = torch.tensor(IMG_NORM["mean"], device=x.device)
        std = torch.tensor(IMG_NORM["std"], device=x.device)
        x = (x - mean) / std
        # zero the pad band after normalization (Normalize, then zero Pad)
        iy = torch.arange(rs, device=x.device)[None, :, None]
        ix = torch.arange(rs, device=x.device)[None, None, :]
        x = x * ((iy < hs[:, None, None]) & (ix < ws[:, None, None]))[..., None]
        if size != rs:
            x = torch.nn.functional.pad(x, (0, 0, 0, size - rs, 0, size - rs))
        return x.to(self.dtype)

    def forward(self, x: torch.Tensor):
        """The model and the paste on a batch already on the device, in the
        model's input layout and dtype: (B, input_size, input_size, 3),
        normalized and padded → (det, pasted), device tensors. With compact
        masks ``det`` holds the label maps and ``pasted`` is None; without,
        ``pasted`` holds each detection's full-frame mask when the engine
        pastes. Host-side syncs inside the proposal stages (NMS and
        component fixpoints) make this partly blocking on the card."""
        det = self.model(x)
        t = self.tile_size
        thr = self.model.mask_thr_binary
        pasted = None
        with span("engine.paste"):
            if self.compact_masks:
                det["label_map"] = paste_label_map(det.pop("mask_probs"), det["boxes"],
                                                   det["valid"], (t, t), threshold=thr)
            elif self.paste_masks:
                # per image: (D, 28, 28) probs + boxes in the tile frame → (D, t, t) u8
                pasted = torch.stack([paste_fn(m, b, (t, t), threshold=thr)
                                      for m, b in zip(det["mask_probs"], det["boxes"])])
        return det, pasted

    def dispatch(self, imgs: Sequence[np.ndarray]):
        """Upload and enqueue the forward (``forward``); returns device
        tensors."""
        with span("engine.dispatch"):
            n = len(imgs)
            if self.device_preprocess:
                with span("engine.upload"):
                    batch, hs, ws = self.preprocess_u8(imgs)
                    x = torch.from_numpy(batch).to(self.device, non_blocking=True)
                    hs = torch.from_numpy(hs).to(self.device)
                    ws = torch.from_numpy(ws).to(self.device)
                with span("engine.prep"):
                    x = self._prep(x, hs, ws)
            else:
                with span("engine.upload"):
                    x = torch.from_numpy(self.preprocess(imgs)).to(self.device).to(self.dtype)
            with span("engine.forward"):
                det, pasted = self.forward(x)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            return det, pasted, n, done

    def collect(self, handle) -> List[Dict[str, np.ndarray]]:
        det, pasted, n, done = handle
        with span("engine.collect"):
            # 1) device wait, apart from 2) the bulk download
            with span("engine.wait", self.collect_timing, "device_s"):
                if done is not None:
                    done.synchronize()
            with span("engine.download", self.collect_timing, "download_s"):
                if pasted is not None:
                    pasted = pasted.cpu().numpy()
                # masks come back in the pasted tensor: the raw probs stay behind
                det = {k: v.float().cpu().numpy() if v.dtype == torch.bfloat16
                       else v.cpu().numpy()
                       for k, v in det.items() if not (k == "mask_probs" and pasted is not None)}
            with span("engine.split"):
                return self._split_results(det, pasted, n)

    def run_batch(self, imgs: Sequence[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Per-image dicts: boxes (n, 4) in the tile frame, scores, labels,
        probs, masks (n, tile, tile) uint8."""
        return self.collect(self.dispatch(imgs))

    def _split_results(self, det, pasted, n) -> List[Dict[str, np.ndarray]]:
        results = []
        for i in range(n):
            valid = det["valid"][i]
            r = dict(boxes=det["boxes"][i][valid], scores=det["scores"][i][valid],
                     labels=det["labels"][i][valid], probs=det["probs"][i][valid])
            if "mask_probs" in det:
                r["mask_probs"] = det["mask_probs"][i][valid]
            if self.compact_masks:
                ids = np.nonzero(valid)[0]
                r["masks"] = (det["label_map"][i][None] == (ids + 1)[:, None, None]
                              ).astype(np.uint8)
            elif pasted is not None:
                r["masks"] = pasted[i][valid]
            results.append(r)
        return results

    def to_reference_format(self, result: Dict[str, np.ndarray]) -> Tuple[List, List]:
        """→ (bbox_results [C × (n, 5)], segm_results [C × [mask, ...]]), the
        result contract the reference's tools parse."""
        bboxes, segms = [], []
        for c in range(self.num_classes):
            sel = result["labels"] == c
            arr = np.concatenate([result["boxes"][sel], result["scores"][sel][:, None]],
                                 axis=1).astype(np.float32)
            bboxes.append(arr)
            segms.append([m for m in result["masks"][sel]] if "masks" in result else [])
        return bboxes, segms


_MASK_HEAD_LIST = re.compile(r"^roi_head\.mask_head\.\d+\.")


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> List[str]:
    """Loads a reference (mmdet-named) ``.pth`` state dict, as the JAX
    package's ``convert_torch_state_dict`` maps one: the ModuleList form of
    the lite mask head (``roi_head.mask_head.0.*``) loads into the one head
    (a later index overwrites an earlier, as there), while a full-cascade
    model (``lite=False``) takes ``roi_head.mask_head.N.*`` into its head N,
    ``conv_res`` too (the JAX package's ``map_torch_key`` sends every index
    to its one lite head and cannot load such a file); the buffers the
    reference also stores (relative_position_index, num_batches_tracked) are
    rebuilt here, not loaded; any other key the model lacks (SeesawLoss's
    ``cum_samples``) is skipped, counted on stdout and returned. A key of the
    model that the file lacks, or a shape that differs, raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    loaded, unmatched = {}, []
    for k, v in ckpt.get("state_dict", ckpt).items():
        if k.endswith("relative_position_index") or "num_batches_tracked" in k:
            continue
        key = k if k in own else _MASK_HEAD_LIST.sub("roi_head.mask_head.", k)
        if key not in own:
            unmatched.append(k)
            continue
        if tuple(v.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch for {k}: the file has {tuple(v.shape)}, the "
                             f"model {tuple(own[key].shape)}")
        loaded[key] = v
    missing = sorted(set(own) - set(loaded))
    if missing:
        raise RuntimeError(f"{path}: missing key(s) {missing[:8]}"
                           f"{' ...' if len(missing) > 8 else ''} ({len(missing)} in all)")
    model.load_state_dict(loaded, strict=True)
    if unmatched:
        print(f"[init_detector] {len(unmatched)} torch keys unmatched")
    return unmatched


def resolve_device(device: Optional[str | torch.device] = None,
                   caller: str = "init_detector") -> torch.device:
    """``device``, or the first CUDA device when it is None; raises when
    there is none. The CPU is taken only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{caller}: no CUDA device; pass device=\"cpu\" (--device cpu) "
                               "to run on the CPU")
        device = "cuda:0"
    return torch.device(device)


def init_detector(config: str | Config, checkpoint: Optional[str] = None,
                  batch_size: int = 8, dtype: Optional[torch.dtype] = None,
                  device: Optional[str | torch.device] = None,
                  device_preprocess: bool = False, compact_masks: bool = False,
                  scale_factor: Optional[float] = None, tile_size: int = 256,
                  swin_kernel: str = "block", use_ema: bool = True) -> InferenceEngine:
    """``device`` None means the first CUDA device, and raises when there is
    none: the CPU is taken only when asked for (``device="cpu"``). ``dtype``
    defaults to bf16 on CUDA and f32 on the CPU. ``checkpoint``: a reference
    (mmdet-named) ``.pth``, or a checkpoint of the port's trainer (a
    ``step_<n>.pt`` file or its directory, whose newest step is read), whose
    EMA weights (a semi run's teacher) are taken when ``use_ema`` and the
    raw ones (the student) otherwise.
    Without a checkpoint the weights are random, from seed 0. ``scale_factor`` overrides the config's
    test rescale; it is baked into the model so boxes come back in the tile
    frame. ``swin_kernel``: the Swin block's kernel tier on CUDA, "block"
    (K1), "attn" (K2) or "none"."""
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    device = resolve_device(device, "init_detector")
    dtype = dtype or (torch.bfloat16 if device.type == "cuda" else torch.float32)
    # f32 products stay f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if scale_factor is None:
        scale_factor = float(cfg.get("scale_factor", 2.0))
    model = build_detector(cfg.model, cfg.model.get("test_cfg"), scale_factor,
                           swin_kernel=swin_kernel)
    if checkpoint:
        from nuhtc_tpu_torch.utils import checkpoint as ckpt

        if ckpt.is_train_checkpoint(checkpoint):
            model.load_state_dict(ckpt.checkpoint_state_dict(checkpoint, use_ema), strict=True)
        else:
            load_reference_checkpoint(model, checkpoint)
    else:
        init_random_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device=device, dtype=dtype).eval()
    return InferenceEngine(model, batch_size=batch_size, tile_size=tile_size,
                           scale_factor=scale_factor, device_preprocess=device_preprocess,
                           compact_masks=compact_masks)


class TTAEngine:
    """Flip test-time augmentation: detections from each flipped view are
    mapped back to the original frame and merged with mask-NMS."""

    def __init__(self, engine: InferenceEngine, flips=("none", "horizontal", "vertical")):
        self.engine = engine
        self.flips = flips

    @staticmethod
    def _flip_img(img, d):
        if d == "horizontal":
            return np.ascontiguousarray(img[:, ::-1])
        if d == "vertical":
            return np.ascontiguousarray(img[::-1])
        return img

    def _unflip(self, res, d, h, w):
        if d == "none":
            return res
        boxes = res["boxes"].copy()
        masks = res.get("masks")
        # masks are pasted in the tile frame; flip only the image extent
        # (cols [0:w] / rows [0:h]) so they stay aligned with the unflipped
        # boxes when the image is smaller than the tile
        if d == "horizontal":
            boxes[:, [0, 2]] = w - res["boxes"][:, [2, 0]]
            if masks is not None:
                masks = masks.copy()
                masks[:, :, :w] = masks[:, :, :w][:, :, ::-1]
        else:
            boxes[:, [1, 3]] = h - res["boxes"][:, [3, 1]]
            if masks is not None:
                masks = masks.copy()
                masks[:, :h, :] = masks[:, :h, :][:, ::-1, :]
        out = dict(res)
        out["boxes"] = boxes
        if masks is not None:
            out["masks"] = np.ascontiguousarray(masks)
        return out

    def run_batch(self, imgs) -> List[Dict[str, np.ndarray]]:
        from nuhtc_tpu_torch.eval.evaluate import mask_nms
        from nuhtc_tpu_torch.ops import rle as rle_ops

        per_flip = []
        for d in self.flips:
            flipped = [self._flip_img(im, d) for im in imgs]
            per_flip.append([self._unflip(r, d, im.shape[0], im.shape[1])
                             for r, im in zip(self.engine.run_batch(flipped), imgs)])
        merged = []
        for i in range(len(imgs)):
            keys = [k for k in ("boxes", "scores", "labels", "probs", "masks")
                    if k in per_flip[0][i]]
            cat = {k: np.concatenate([pf[i][k] for pf in per_flip]) for k in keys}
            if len(cat["scores"]):
                if "masks" in cat:
                    rles = [rle_ops.encode(m) for m in cat["masks"]]
                    _, keep = mask_nms(rles, cat["scores"], thr=0.5)
                else:
                    # paste_masks=False: dedup on box IoU, or every instance
                    # would appear once per flip
                    keep = _box_nms(cat["boxes"], cat["scores"], thr=0.5)
                cat = {k: v[keep] for k, v in cat.items()}
            merged.append(cat)
        return merged


def _box_nms(boxes: np.ndarray, scores: np.ndarray, thr: float = 0.5) -> np.ndarray:
    """Greedy host-side box-IoU NMS; returns kept indices (score-desc)."""
    order = np.argsort(-scores)
    b = boxes[order].astype(np.float64)
    areas = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    keep = []
    alive = np.ones(len(b), bool)
    for i in range(len(b)):
        if not alive[i]:
            continue
        keep.append(order[i])
        x1 = np.maximum(b[i, 0], b[i + 1:, 0])
        y1 = np.maximum(b[i, 1], b[i + 1:, 1])
        x2 = np.minimum(b[i, 2], b[i + 1:, 2])
        y2 = np.minimum(b[i, 3], b[i + 1:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        iou = inter / np.maximum(areas[i] + areas[i + 1:] - inter, 1e-12)
        alive[i + 1:] &= iou <= thr
    return np.asarray(keep, np.int64)
