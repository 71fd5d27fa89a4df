"""Dataset wrappers, train-sample preparation, padded collation and the
threaded prefetch loader (port of nuhtc_tpu/data/loader.py):

- ``CASDataset``: class-aware sampling; ``sample_index`` draws a uniform
  class, then a uniform image that holds it (reference
  nuhtc/datasets/dataset_wrappers.py:36-43);
- ``SemiDataset``: a supervised and an unsupervised dataset side by side
  (reference dataset_wrappers.py:7);
- ``prepare_train_sample`` / ``sample_train_valid``: decode and augment one
  sample, drawing another index when the pipeline rejects it;
- ``collate_train``: the padded numpy batch the train step takes (gt boxes,
  labels, valid flags, 64×64 mask patches in each gt box, the stride-4
  semantic map), the same dict the JAX package builds;
- ``PrefetchLoader``: host threads build batches while the card trains;
  batch k is built from ``np.random.RandomState(seed + k)`` and batches come
  out in order, so a seed gives the same sequence whatever the threads do;
- ``SemiPrefetchLoader``: the teacher/student batches, supervised samples
  beside unlabelled images in a weak and a strong view.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from nuhtc_tpu_torch.data.pipelines import Normalize, PhotoMetricDistortion, run_pipeline
from nuhtc_tpu_torch.ops import imgproc
from nuhtc_tpu_torch.ops import rle as rle_ops

PATCH_SIZE = 64  # per-instance gt mask patch resolution


class CASDataset:
    """Class-aware sampling wrapper."""

    def __init__(self, dataset, **kwargs):
        self.dataset = dataset
        self.class_index = dataset.build_class_index()
        self.classes = sorted(self.class_index.keys())
        self.CLASSES = dataset.CLASSES
        self.PALETTE = getattr(dataset, "PALETTE", None)

    def __len__(self):
        return len(self.dataset)

    def sample_index(self, rng: np.random.RandomState) -> int:
        c = self.classes[rng.randint(len(self.classes))]
        imgs = self.class_index[c]
        return imgs[rng.randint(len(imgs))]

    def __getattr__(self, name):
        return getattr(self.dataset, name)


class SemiDataset:
    """Concatenation of a supervised and an unsupervised dataset."""

    def __init__(self, sup, unsup=None, **kwargs):
        self.sup = sup
        self.unsup = unsup
        self.CLASSES = sup.CLASSES

    def __len__(self):
        return len(self.sup) + (len(self.unsup) if self.unsup else 0)


def prepare_train_sample(dataset, idx: int, pipeline, rng: np.random.RandomState
                         ) -> Optional[dict]:
    """Load, decode and augment one sample → the pipeline's results, or None
    when a transform rejects it."""
    img = dataset.load_image(idx).astype(np.float32)
    ann = dataset.get_ann_info(idx)
    masks = (np.stack([rle_ops.decode(m) for m in ann["masks"]]) if len(ann["masks"])
             else np.zeros((0,) + img.shape[:2], np.uint8))
    seg = dataset.load_semantic(idx)
    if seg is None:  # the binary semantic map from the instance masks
        seg = ((masks.sum(0) > 0).astype(np.uint8) if len(masks)
               else np.zeros(img.shape[:2], np.uint8))
    results = dict(img=img, gt_bboxes=ann["bboxes"], gt_labels=ann["labels"], gt_masks=masks,
                   gt_semantic_seg=seg, ismask=ann.get("ismask"),
                   img_info=dataset.img_info(idx) if hasattr(dataset, "img_info") else None)
    return run_pipeline(pipeline, results, rng)


def sample_train_valid(dataset, idx_fn, pipeline, rng, max_tries: int = 50) -> dict:
    """Draw indices until the pipeline accepts a sample (mmdet
    CustomDataset.__getitem__)."""
    for _ in range(max_tries):
        s = prepare_train_sample(dataset, idx_fn(rng), pipeline, rng)
        if s is not None:
            return s
    raise RuntimeError(f"pipeline rejected {max_tries} consecutive samples — check crop "
                       "sizes vs annotation density (allow_negative_crop?)")


def instance_patches(masks: np.ndarray, boxes: np.ndarray, size: int = PATCH_SIZE) -> np.ndarray:
    """Each instance mask inside its gt box, resized to size×size (bilinear)."""
    n = len(masks)
    out = np.zeros((n, size, size), np.float32)
    h, w = masks.shape[1:] if n else (0, 0)
    for i in range(n):
        x1, y1, x2, y2 = boxes[i]
        xi1, yi1 = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
        xi2, yi2 = int(np.ceil(x2)), int(np.ceil(y2))
        xi2, yi2 = min(max(xi2, xi1 + 1), w), min(max(yi2, yi1 + 1), h)
        crop = masks[i, yi1:yi2, xi1:xi2]
        out[i] = imgproc.resize_linear_f32(crop.astype(np.float32), (size, size))
    return out


def collate_train(samples: List[dict], max_gt: int = 160, sem_stride: int = 4
                  ) -> Dict[str, np.ndarray]:
    """Pipeline results → padded numpy arrays for the train step."""
    b = len(samples)
    hs = max(s["img"].shape[0] for s in samples)
    ws = max(s["img"].shape[1] for s in samples)
    img = np.zeros((b, hs, ws, 3), np.float32)
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    gt_patches = np.zeros((b, max_gt, PATCH_SIZE, PATCH_SIZE), np.float32)
    gt_ismask = np.ones((b, max_gt), np.float32)
    gt_sem = np.zeros((b, hs // sem_stride, ws // sem_stride), np.int32)
    for i, s in enumerate(samples):
        h, w = s["img"].shape[:2]
        img[i, :h, :w] = s["img"]
        n = min(len(s["gt_bboxes"]), max_gt)
        if n:
            gt_boxes[i, :n] = s["gt_bboxes"][:n]
            gt_labels[i, :n] = s["gt_labels"][:n]
            gt_valid[i, :n] = True
            # box-only annotations may carry fewer masks than boxes: their
            # patches stay zero and they are flagged maskless
            nm = min(len(s["gt_masks"]), n)
            if nm:
                gt_patches[i, :nm] = instance_patches(s["gt_masks"][:nm], s["gt_bboxes"][:nm])
            if s.get("ismask") is not None:
                gt_ismask[i, :n] = s["ismask"][:n]
            elif nm < n:
                gt_ismask[i, nm:n] = 0.0
        seg = s.get("gt_semantic_seg")
        if seg is not None:
            th, tw = h // sem_stride, w // sem_stride
            if seg.shape[0] > th or seg.shape[1] > tw:  # no SegRescale in the pipeline
                seg = imgproc.resize_nearest(seg.astype(np.uint8), (th, tw))
            sh, sw = seg.shape
            gt_sem[i, :sh, :sw] = seg
    return dict(img=img, gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid,
                gt_patches=gt_patches, gt_ismask=gt_ismask, gt_semantic=gt_sem)


class PrefetchLoader:
    """Threaded train loader: CAS or uniform sampling, the pipeline and the
    collation, ``prefetch`` batches ahead. ``close()`` stops the threads."""

    def __init__(self, dataset, pipeline, batch_size: int = 8, max_gt: int = 160,
                 seed: int = 0, num_threads: int = 2, prefetch: int = 4,
                 class_aware: Optional[bool] = None):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.class_aware = (class_aware if class_aware is not None
                            else isinstance(dataset, CASDataset))
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._counter = 0
        self._lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._pending: Dict[int, dict] = {}
        self._next_emit = 0

    def _next_seed(self) -> int:
        with self._lock:
            s = self._counter
            self._counter += 1
        return s

    def make_batch(self, seq: int) -> Dict[str, np.ndarray]:
        """Batch ``seq`` of the sequence, from ``RandomState(seed + seq)``."""
        inner = self.dataset.dataset if isinstance(self.dataset, CASDataset) else self.dataset
        rng = np.random.RandomState(self.seed + seq)
        idx_fn = ((lambda r: self.dataset.sample_index(r)) if self.class_aware
                  else (lambda r: r.randint(len(inner))))
        samples = [sample_train_valid(inner, idx_fn, self.pipeline, rng)
                   for _ in range(self.batch_size)]
        return collate_train(samples, max_gt=self.max_gt)

    def _worker(self):
        try:
            while not self._stop.is_set():
                seq = self._next_seed()
                batch = self.make_batch(seq)
                while not self._stop.is_set():
                    try:
                        self._q.put((seq, batch), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # a worker's failure reaches the consumer
            self._err = e
            self._stop.set()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._threads:
            for _ in range(self.num_threads):
                t = threading.Thread(target=self._worker, daemon=True)
                t.start()
                self._threads.append(t)
        while True:
            yield self._ordered_get()

    def _ordered_get(self) -> Dict[str, np.ndarray]:
        """The batches in sequence order; out-of-order arrivals wait here."""
        nxt = self._next_emit
        while nxt not in self._pending:
            if self._err is not None:
                raise RuntimeError(f"{type(self).__name__} worker crashed") from self._err
            try:
                seq, batch = self._q.get(timeout=1.0)
                self._pending[seq] = batch
            except queue.Empty:
                continue
        self._next_emit = nxt + 1
        return self._pending.pop(nxt)

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)


class SemiPrefetchLoader(PrefetchLoader):
    """Threaded loader for teacher/student training (reference
    DistributedGroupSemiBalanceSampler + MultiBranch unsup_teacher /
    unsup_student pipelines, configs/nuhtc/base.py:180-222).

    Each batch holds ``round(batch_size · sup_ratio)`` supervised samples
    (``collate_train``'s targets, through ``pipeline``) and the rest as
    unlabelled images at the supervised batch's size (a random crop, or a
    linear resize of a smaller image) in two aligned views:
    ``unsup_img_teacher`` (weak: normalized only) and ``unsup_img`` (strong:
    ``strong_pipeline``, PhotoMetricDistortion by default, on the raw
    pixels, then normalized), both with the ``Normalize`` of ``pipeline``
    (its default when ``pipeline`` has none). Batch k is built from
    ``RandomState(seed + k)``, the supervised samples first, as the JAX
    loader draws them. An unlabelled dataset of length 0 (a json without
    annotations loses every image to ``filter_empty``) falls back to the
    supervised images, as in the JAX package."""

    def __init__(self, semi_dataset, pipeline, strong_pipeline=None, batch_size: int = 8,
                 sup_ratio: float = 0.5, max_gt: int = 160, seed: int = 0,
                 num_threads: int = 2, prefetch: int = 4):
        n_sup = max(int(round(batch_size * sup_ratio)), 1)
        self.n_unsup = batch_size - n_sup
        if self.n_unsup <= 0:
            raise ValueError(f"SemiPrefetchLoader needs sup_ratio < 1 to leave room for unsup "
                             f"samples (batch_size={batch_size}, sup_ratio={sup_ratio})")
        super().__init__(semi_dataset.sup, pipeline, batch_size=n_sup, max_gt=max_gt, seed=seed,
                         num_threads=num_threads, prefetch=prefetch, class_aware=False)
        self.sup = semi_dataset.sup
        self.unsup = semi_dataset.unsup or semi_dataset.sup
        self.strong = strong_pipeline if strong_pipeline is not None else [PhotoMetricDistortion()]
        self._norm = next((t for t in (pipeline or []) if isinstance(t, Normalize)), Normalize())

    def _unsup_views(self, idx: int, hs: int, ws: int, rng: np.random.RandomState):
        """One unlabelled image → (weak, strong) views of (hs, ws)."""
        img = self.unsup.load_image(idx).astype(np.float32)
        h, w = img.shape[:2]
        if (h, w) != (hs, ws):
            if h >= hs and w >= ws:  # random crop
                y0 = rng.randint(h - hs + 1)
                x0 = rng.randint(w - ws + 1)
                img = img[y0:y0 + hs, x0:x0 + ws]
            else:
                img = imgproc.resize_linear_f32(np.ascontiguousarray(img), (hs, ws))
        # the photometric augmentations take raw 0-255 pixels; both views are
        # then normalized as the supervised pipeline normalizes
        res = dict(img=img.copy(), gt_bboxes=np.zeros((0, 4), np.float32),
                   gt_labels=np.zeros((0,), np.int64))
        strong_raw = run_pipeline(self.strong, res, rng)["img"]
        return self._norm({"img": img})["img"], self._norm({"img": strong_raw})["img"]

    def make_batch(self, seq: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + seq)
        samples = [sample_train_valid(self.sup, lambda r: r.randint(len(self.sup)),
                                      self.pipeline, rng) for _ in range(self.batch_size)]
        batch = collate_train(samples, max_gt=self.max_gt)
        hs, ws = batch["img"].shape[1:3]
        weak = np.zeros((self.n_unsup, hs, ws, 3), np.float32)
        strong = np.zeros((self.n_unsup, hs, ws, 3), np.float32)
        for i in range(self.n_unsup):
            weak[i], strong[i] = self._unsup_views(rng.randint(len(self.unsup)), hs, ws, rng)
        batch["unsup_img"] = strong
        batch["unsup_img_teacher"] = weak
        return batch
