"""Dataset wrappers of the test-time path (port of the part of
nuhtc_tpu/data/loader.py that ``build_dataset`` needs for a config's
``data.train``):

- ``CASDataset``: class-aware sampling; ``sample_index`` draws a uniform
  class, then a uniform image that holds it (reference
  nuhtc/datasets/dataset_wrappers.py:36-43);
- ``SemiDataset``: a supervised and an unsupervised dataset side by side
  (reference dataset_wrappers.py:7).

Training's sample preparation, collation and prefetch loaders come with the
port of training.
"""

from __future__ import annotations

import numpy as np


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
