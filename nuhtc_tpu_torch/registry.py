"""String-keyed registries for config-driven construction (port of
nuhtc_tpu/registry.py: ``Registry`` and the registries the port uses,
``BACKBONES``, ``NECKS``, ``DETECTORS``, ``HEADS``, ``DATASETS``, ``LOSSES``
and ``PIPELINES``).

The reference framework wires every component through mmdet registries
(`@DETECTORS.register_module()` etc.; see reference
nuhtc/models/__init__.py:1-10). A config names a dataset as
``dict(type='PanNukeCocoDataset', ...)``, and ``data.coco.build_dataset``
looks the class up here, and ``models.build.build_detector`` a detector
type other than the HTC schema's.
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable] = {}

    def register(self, name: str | None = None):
        def deco(cls):
            key = name or cls.__name__
            if key in self._registry and self._registry[key] is not cls:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._registry[key] = cls
            return cls

        return deco

    def get(self, key: str) -> Callable:
        if key not in self._registry:
            raise KeyError(
                f"{key!r} is not registered in {self.name}; "
                f"known: {sorted(self._registry)}"
            )
        return self._registry[key]

    def __contains__(self, key):
        return key in self._registry


# the backbones and necks (SwinTransformer, ViT, SwinUnet; FPN, ViT_FPN),
# detectors (other than the HTC schema, which models/build.py maps itself),
# the extra heads, datasets, losses and the train pipeline's transforms go
# by name
BACKBONES = Registry("backbones")
NECKS = Registry("necks")
DETECTORS = Registry("detectors")
HEADS = Registry("heads")
DATASETS = Registry("datasets")
LOSSES = Registry("losses")
PIPELINES = Registry("pipelines")
