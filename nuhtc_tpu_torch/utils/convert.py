"""JAX param tree → the port's (mmdet-named) state dict.

``state_dict_from_jax`` inverts ``nuhtc_tpu.utils.checkpoint.map_torch_key``
and its layout transforms (``_conv_w``, ``_deconv_w`` with its spatial flip,
``_lin_w``, ``_roi_fc_w``). It takes the flax tree as nested dicts of numpy
arrays and needs no JAX.

The Mask R-CNN tree (nuhtc_tpu/models/mask_rcnn.py) maps onto mmdet's Mask
R-CNN names: its one ``bbox_head`` (no stage index) onto
``roi_head.bbox_head.{shared_fcs.0, shared_fcs.1, fc_cls, fc_reg}``, its
``mask_head`` onto ``roi_head.mask_head.*`` as NuHTC's, and the mid-seg
``conv_last`` onto ``conv_last`` (the reference's mask_rcnn_part.py name).
``map_torch_key`` of the JAX package reads none of those three un-indexed
or extra names back.

The full cascade's per-stage heads ``mask_heads_{i}`` map onto
``roi_head.mask_head.{i}.*`` (``conv_res`` a ConvModule as the convs), and
the ``_Lite_Fuse`` seg branch ``seg_branch`` onto ``roi_head.seg_branch.*``
under its flax module names (convolutions as convolutions, ``fc_cls`` as a
linear layer).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _conv(w):  # (kh, kw, I, O) → (O, I, kh, kw)
    return np.transpose(w, (3, 2, 0, 1))


def _deconv(w):  # flipped (kh, kw, I, O) → (I, O, kh, kw)
    return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))


def _lin(w):  # (I, O) → (O, I)
    return np.transpose(w)


def _roi_fc(w, roi_size: int = 7):  # (S*S*C, O) rows (i, j, c) → (O, C*S*S) rows (c, i, j)
    cin, o = w.shape
    c = cin // (roi_size * roi_size)
    return np.transpose(w.reshape(roi_size, roi_size, c, o), (3, 2, 0, 1)).reshape(o, cin)


def _ident(w):
    return w


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_key(path: Tuple[str, ...]):
    """flax path → (mmdet key, inverse transform), or None if unknown."""
    top, rest = path[0], path[1:]
    leaf = {"kernel": "weight", "scale": "weight"}.get(rest[-1], rest[-1])

    def wfn(transform):  # the layout transform applies to kernels only
        return transform if rest[-1] == "kernel" else _ident

    if top == "backbone":
        mod = rest[0]
        if mod == "patch_embed":
            return f"backbone.patch_embed.projection.{leaf}", wfn(_conv)
        if mod == "patch_norm":
            return f"backbone.patch_embed.norm.{leaf}", _ident
        m = re.fullmatch(r"stage(\d+)_block(\d+)", mod)
        if m:
            base = f"backbone.stages.{m.group(1)}.blocks.{m.group(2)}"
            sub = rest[1]
            if sub in ("norm1", "norm2"):
                return f"{base}.{sub}.{leaf}", _ident
            if sub == "attn":
                if rest[2] == "relative_position_bias_table":
                    return f"{base}.attn.w_msa.relative_position_bias_table", _ident
                return f"{base}.attn.w_msa.{rest[2]}.{leaf}", wfn(_lin)
            if sub == "ffn":
                layer = "layers.0.0" if rest[2] == "fc1" else "layers.1"
                return f"{base}.ffn.{layer}.{leaf}", wfn(_lin)
        m = re.fullmatch(r"downsample(\d+)", mod)
        if m:
            base = f"backbone.stages.{m.group(1)}.downsample"
            if rest[1] == "norm":
                return f"{base}.norm.{leaf}", _ident
            return f"{base}.reduction.weight", _lin
        m = re.fullmatch(r"out_norm(\d+)", mod)
        if m:
            return f"backbone.norm{m.group(1)}.{leaf}", _ident
    if top == "neck":
        m = re.fullmatch(r"(lateral|fpn)(\d+)", rest[0])
        which = "lateral_convs" if m.group(1) == "lateral" else "fpn_convs"
        return f"neck.{which}.{m.group(2)}.conv.{leaf}", wfn(_conv)
    if top == "rpn_head":
        return f"rpn_head.{rest[0]}.{leaf}", wfn(_conv)
    if top == "semantic_head":
        base = "roi_head.semantic_head"
        m = re.fullmatch(r"(lateral|conv)(\d+)", rest[0])
        if m:
            which = "lateral_convs" if m.group(1) == "lateral" else "convs"
            return f"{base}.{which}.{m.group(2)}.conv.{leaf}", wfn(_conv)
        if rest[0] == "conv_embedding":
            return f"{base}.conv_embedding.conv.{leaf}", wfn(_conv)
        return f"{base}.{rest[0]}.{leaf}", wfn(_conv)
    m = re.fullmatch(r"bbox_heads_(\d+)", top)
    if m or top == "bbox_head":
        base = f"roi_head.bbox_head.{m.group(1)}" if m else "roi_head.bbox_head"
        if rest[0] == "shared_fc0":
            return f"{base}.shared_fcs.0.{leaf}", wfn(_roi_fc)
        if rest[0] == "shared_fc1":
            return f"{base}.shared_fcs.1.{leaf}", wfn(_lin)
        return f"{base}.{rest[0]}.{leaf}", wfn(_lin)
    m = re.fullmatch(r"mask_heads_(\d+)", top)
    if m or top == "mask_head":
        base = f"roi_head.mask_head.{m.group(1)}" if m else "roi_head.mask_head"
        m = re.fullmatch(r"conv(\d+)", rest[0])
        if m:
            return f"{base}.convs.{m.group(1)}.conv.{leaf}", wfn(_conv)
        if rest[0] == "conv_res":
            return f"{base}.conv_res.conv.{leaf}", wfn(_conv)
        if rest[0] == "upsample":
            return f"{base}.upsample.{leaf}", wfn(_deconv)
        return f"{base}.{rest[0]}.{leaf}", wfn(_conv)
    if top == "seg_branch":
        m = re.fullmatch(r"conv(\d+)", rest[0])
        name = f"convs.{m.group(1)}" if m else rest[0]
        return f"roi_head.seg_branch.{name}.{leaf}", wfn(_lin if rest[0] == "fc_cls" else _conv)
    if top == "conv_last":
        return f"conv_last.{leaf}", wfn(_conv)
    return None


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (``{"params": ...}`` or the inner dict) of numpy
    arrays → the port's state dict (f32 tensors, mmdet key names)."""
    tree = params.get("params", params)
    out = {}
    for path, value in _flatten(tree):
        mapped = torch_key(path)
        if mapped is None:
            raise KeyError(f"state_dict_from_jax: no port key for {'/'.join(path)}")
        key, fn = mapped
        out[key] = torch.from_numpy(np.array(fn(np.asarray(value, np.float32)), order="C"))
    return out
