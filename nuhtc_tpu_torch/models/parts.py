"""A detector's backbone and neck, built by type from the registries
(``BACKBONES``, ``NECKS``).

``backbone`` and ``neck`` are config dicts, ``{"type": ..., **kwargs}``.
Without them, ``backbone_cfg`` holds a ``SwinTransformer``'s arguments and
the neck is an ``FPN`` of ``fpn_channels``: the spelling of Swin-T + FPN
that the detectors' constructors have always had. A key that is not an
argument of the class raises, unless it is one of ``TRAINING_KEYS``, which
change nothing at inference and are dropped. A backbone reports the
channels of the maps it returns (``out_channels``): they are the neck's
``in_channels`` (the last map's alone for a neck that reads only the last,
``takes_last_map``), and a config that lists others raises. The neck's
``out_channels`` are the heads' channels.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Tuple

from torch import nn

from nuhtc_tpu_torch.models import backbones, extra_heads, fpn, swin  # noqa: F401  (register)
from nuhtc_tpu_torch.registry import BACKBONES, NECKS, Registry

# the reference's keys for freezing, checkpointing, loading and dropout
TRAINING_KEYS = ("frozen_stages", "init_cfg", "pretrained", "with_cp", "convert_weights",
                 "drop_rate", "attn_drop_rate")


def _build(registry: Registry, cfg: Dict[str, Any], **fixed) -> nn.Module:
    """The ``registry`` class named by ``cfg["type"]``, built from ``cfg``'s
    keys and ``fixed``; a key that is neither an argument of the class nor
    one of ``TRAINING_KEYS`` raises."""
    cls = registry.get(cfg["type"])
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    unknown = set(cfg) - fields - set(TRAINING_KEYS) - {"type"}
    if unknown:
        raise ValueError(f"{cfg['type']}: unknown config keys {sorted(unknown)}")
    kwargs = {k: v for k, v in cfg.items() if k in fields}
    return cls(**dict(kwargs, **fixed))


def build_backbone_neck(backbone: Dict[str, Any] | None = None,
                        neck: Dict[str, Any] | None = None,
                        backbone_cfg: Dict[str, Any] | None = None,
                        fpn_channels: int = 64) -> Tuple[nn.Module, nn.Module]:
    """(backbone, neck): the typed ``backbone`` (else ``backbone_cfg``'s
    Swin) and the typed ``neck`` (else an FPN of ``fpn_channels``) over the
    backbone's channels."""
    bb = dict(backbone) if backbone else dict(backbone_cfg or {}, type="SwinTransformer")
    nk = dict(neck) if neck else {"type": "FPN", "out_channels": fpn_channels}
    bb.setdefault("type", "SwinTransformer")
    nk.setdefault("type", "FPN")
    bb_module = _build(BACKBONES, bb)
    channels = list(bb_module.out_channels)
    if getattr(NECKS.get(nk["type"]), "takes_last_map", False):
        channels = channels[-1]
    listed = nk.get("in_channels", channels)
    if (listed if isinstance(listed, int) else list(listed)) != channels:
        raise ValueError(f"{nk['type']}: in_channels {listed}, where {bb['type']} "
                         f"returns maps of {channels}")
    return bb_module, _build(NECKS, nk, in_channels=channels)
