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

The standalone backbones and neck of nuhtc_tpu/models/backbones.py and
extra_heads.py (``family`` "vit", "swin_unet", "vit_fpn") map onto their
port modules' keys: the ViT onto the reference visiontransformer.py names,
SwinUnet's Swin blocks onto the mmdet sub-names ``SwinTransformer`` uses.
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


def _leaf(path: Tuple[str, ...]) -> str:
    return {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])


def _swin_block_key(base: str, rest: Tuple[str, ...]):
    """A Swin block's flax sub-path (``norm1``, ``attn/qkv``, ``ffn/fc1`` ...)
    → (its mmdet key under ``base``, inverse transform)."""
    leaf, kernel = _leaf(rest), rest[-1] == "kernel"
    sub = rest[0]
    if sub in ("norm1", "norm2"):
        return f"{base}.{sub}.{leaf}", _ident
    if sub == "attn":
        if rest[1] == "relative_position_bias_table":
            return f"{base}.attn.w_msa.relative_position_bias_table", _ident
        return f"{base}.attn.w_msa.{rest[1]}.{leaf}", _lin if kernel else _ident
    if sub == "ffn":
        layer = "layers.0.0" if rest[1] == "fc1" else "layers.1"
        return f"{base}.ffn.{layer}.{leaf}", _lin if kernel else _ident
    return None


def vit_key(path: Tuple[str, ...]):
    """A standalone JAX ``ViT`` tree's path → (the reference's
    visiontransformer.py key, inverse transform), or None."""
    leaf, kernel = _leaf(path), path[-1] == "kernel"
    if path[0] == "patch_embed":
        return f"patch_embed.proj.{leaf}", _conv if kernel else _ident
    if path == ("pos_embed",):
        return "pos_embed", _ident
    m = re.fullmatch(r"block(\d+)", path[0])
    if m is None or len(path) < 3:
        return None
    base = f"blocks.{m.group(1)}"
    if path[1] in ("norm1", "norm2"):
        return f"{base}.{path[1]}.{leaf}", _ident
    if path[1] == "attn" and path[2] in ("rel_pos_h", "rel_pos_w"):
        return f"{base}.attn.{path[2]}", _ident
    if path[1] in ("attn", "mlp"):
        return f"{base}.{path[1]}.{path[2]}.{leaf}", _lin if kernel else _ident
    return None


def swin_unet_key(path: Tuple[str, ...]):
    """A standalone JAX ``SwinUnet`` tree's path → (the port's key, inverse
    transform), or None."""
    leaf, kernel = _leaf(path), path[-1] == "kernel"
    mod = path[0]
    if mod == "patch_embed":
        return f"patch_embed.projection.{leaf}", _conv if kernel else _ident
    if mod == "patch_norm":
        return f"patch_embed.norm.{leaf}", _ident
    m = re.fullmatch(r"enc(\d+)_block(\d+)", mod)
    if m:
        return _swin_block_key(f"enc.{m.group(1)}.blocks.{m.group(2)}", path[1:])
    m = re.fullmatch(r"down(\d+)", mod)
    if m:
        if path[1] == "norm":
            return f"enc.{m.group(1)}.downsample.norm.{leaf}", _ident
        return f"enc.{m.group(1)}.downsample.reduction.weight", _lin
    m = re.fullmatch(r"up(\d+)_expand", mod)
    if m:
        return f"dec.{m.group(1)}.expand.{leaf}", _lin if kernel else _ident
    m = re.fullmatch(r"dec(\d+)_block", mod)
    if m:
        return _swin_block_key(f"dec.{m.group(1)}.block", path[1:])
    return None


def vit_fpn_key(path: Tuple[str, ...]):
    """A standalone JAX ``ViT_FPN`` tree's path → (the port's key, inverse
    transform), or None. ``up4``/``up2`` are flax ConvTransposes (flipped)."""
    if path[0] not in ("up4", "up2", "same", "down") or len(path) != 2:
        return None
    transform = _deconv if path[0].startswith("up") else _conv
    return f"{path[0]}.{_leaf(path)}", transform if path[-1] == "kernel" else _ident


def torch_key(path: Tuple[str, ...]):
    """flax path → (mmdet key, inverse transform), or None if unknown."""
    top, rest = path[0], path[1:]
    leaf = _leaf(rest)

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
            return _swin_block_key(f"backbone.stages.{m.group(1)}.blocks.{m.group(2)}", rest[1:])
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


FAMILIES = {"detector": torch_key, "vit": vit_key, "swin_unet": swin_unet_key,
            "vit_fpn": vit_fpn_key}


def state_dict_from_jax(params: Dict[str, Any], family: str = "detector"
                        ) -> Dict[str, torch.Tensor]:
    """flax param tree (``{"params": ...}`` or the inner dict) of numpy
    arrays → the port's state dict (f32 tensors, mmdet key names).
    ``family`` "detector" takes a detector's tree (``backbone``, ``neck``,
    the heads); "vit", "swin_unet" and "vit_fpn" take the standalone tree
    of that module (no top level) and give the module's own keys. A leaf
    with no port key raises."""
    if family not in FAMILIES:
        raise ValueError(f"state_dict_from_jax: family {family!r} is not one of "
                         f"{sorted(FAMILIES)}")
    key_fn = FAMILIES[family]
    tree = params.get("params", params)
    out = {}
    for path, value in _flatten(tree):
        mapped = key_fn(path)
        if mapped is None:
            raise KeyError(f"state_dict_from_jax: no port key for {'/'.join(path)}")
        key, fn = mapped
        out[key] = torch.from_numpy(np.array(fn(np.asarray(value, np.float32)), order="C"))
    return out
