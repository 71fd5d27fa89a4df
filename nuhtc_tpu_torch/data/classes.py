"""Class names per dataset (the ``CLASSES`` of nuhtc_tpu/data/coco.py's
dataset types, keyed by the config's ``dataset``) and the overlay palette
(nuhtc_tpu/utils/visualize.py)."""

from __future__ import annotations

from typing import Tuple

DATASET_CLASSES = {
    "PanNukeCocoDataset": ("Neoplastic", "Inflammatory", "Connective", "Dead", "Epithelial"),
    "CoNSePCocoDataset": ("Miscellaneous", "Inflammatory", "Epithelial", "Spindle"),
    "CoNICCocoDataset": ("Neutrophil", "Epithelial", "Lymphocyte", "Plasma", "Eosinophil",
                         "Connective"),
    "NuCLSCocoDataset": ("tumor", "fibroblast", "lymphocyte", "plasma_cell", "macrophage",
                         "mitotic_figure", "vascular_endothelium", "apoptotic_body"),
}

DEFAULT_PALETTE = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 150, 0),
    (150, 0, 255), (0, 255, 255), (128, 128, 0),
]


def dataset_classes(name: str) -> Tuple[str, ...]:
    try:
        return DATASET_CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASET_CLASSES)}") from None
