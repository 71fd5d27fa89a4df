"""The yardstick of the kernels' roofline shares: the published peaks of one
H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit) and the least time
a kernel's work can take on them. Frozen copies of ``chip_smoke.py``'s
``PEAK_*``, ``bound_ms`` and ``block_bound``, with the batch an argument,
and a bytes bound of K4 from the shapes of its launches.

A share is the bound over the measured kernel time, so it cannot pass 100 %
unless the work is counted too high or the time too low."""

from __future__ import annotations

from typing import List, Tuple

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def bound_ms(flops: float, peak: float, nbytes: float) -> Tuple[float, str]:
    """(least time in ms, what bounds it) for this much work on the card."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def block_bound(batch: int, side: int, c: int, mode: str = "block") -> Tuple[float, float]:
    """(FLOP, bytes) of one Swin block on a (batch, side, side, c) padded
    map. "block" (K1): qkv, proj, fc1, fc2 (24·M·C² FLOP) and attention
    (4·M·49·C); two maps read, one written, weights read once (bf16). "attn"
    (K2): qkv and proj (8·M·C²) and attention; one map read, one written."""
    m = batch * side * side
    attn = 4.0 * m * 49 * c
    if mode == "block":
        return 24.0 * m * c * c + attn, 3 * m * c * 2 + 12 * c * c * 2
    return 8.0 * m * c * c + attn, 2 * m * c * 2 + 4 * c * c * 2


def _pad(n: int, ws: int) -> int:
    return (n + ws - 1) // ws * ws


def swin_stages(backbone: dict, side: int) -> List[Tuple[int, int, int, int]]:
    """(map side, padded side, channels, blocks) of each stage for a square
    input of ``side``."""
    s = side // backbone.get("patch_size", 4)
    c = backbone.get("embed_dims", 96)
    ws = backbone.get("window_size", 7)
    out = []
    for depth in backbone.get("depths", (2, 2, 6, 2)):
        out.append((s, _pad(s, ws), c, depth))
        s, c = (s + 1) // 2, 2 * c
    return out


def backbone_cfg(cfg: dict) -> dict:
    m = cfg["model"]
    return dict(m.get("backbone") or m.get("backbone_cfg") or {})


def fpn_channels(cfg: dict) -> int:
    """The neck's channels: its ``out_channels``, else a Mask R-CNN's
    ``fpn_channels``."""
    m = cfg["model"]
    return m["neck"].get("out_channels", 64) if "neck" in m else m.get("fpn_channels", 64)


def input_side(cfg: dict) -> int:
    rs = int(cfg["tile"] * cfg["scale_factor"] + 0.5)
    return (rs + 31) // 32 * 32


def k1_bound_s(cfg: dict, batch: int) -> float:
    """Least seconds of one forward's K1 launches (every Swin block)."""
    total = 0.0
    for _, padded, c, depth in swin_stages(backbone_cfg(cfg), input_side(cfg)):
        f, by = block_bound(batch, padded, c, "block")
        total += depth * bound_ms(f, PEAK_BF16, by)[0] * 1e-3
    return total


def k4_launches(cfg: dict, batch: int) -> List[Tuple[List[Tuple[int, int]], int, int, bool]]:
    """One forward's K4 launches: (maps' sides and channels, RoIs, output
    size, with an f32 bias) each."""
    m = cfg["model"]
    side = input_side(cfg)
    strides = (4, 8, 16, 32)
    c = fpn_channels(cfg)
    if m["type"] == "MaskRCNN":
        props, dets = m.get("rpn_max_per_img", 1000), m.get("rcnn_max_per_img", 100)
        per_level = [([(side // s, c)], props, 7, False) for s in strides]
        per_level += [([(side // s, c)], dets, 14, False) for s in strides]
        return per_level
    rpn = m["test_cfg"]["rpn"].get("max_per_img", 1000)
    rois = rpn + (512 if m["roi_head"].get("watershed_proposal", True) else 0)
    dets = m["test_cfg"]["rcnn"].get("max_per_img", 500)
    maps = [(side // 4, c), (side // 8, c), (side // 4, c)]  # levels 0, 1 and the semantic map
    stages = m["roi_head"].get("num_stages", 3)
    return [(maps, rois, 7, True)] * stages + [(maps, dets, 14, True)]


def k4_bound_s(cfg: dict, batch: int, elem_bytes: int = 2) -> float:
    """Least seconds of one forward's K4 launches by their bytes: each map,
    the boxes and the bias read once, the output written once (the
    operations depend on the boxes and are left out: the bound only gets
    smaller)."""
    total = 0
    for maps, r, out, bias in k4_launches(cfg, batch):
        c = maps[0][1]
        total += sum(batch * s * s * ch * elem_bytes for s, ch in maps)
        total += batch * r * 4 * 4 + (batch * r * c * 4 if bias else 0)
        total += batch * r * out * out * c * elem_bytes
    return total / PEAK_BYTES
