"""Drawing helpers of the analysis tools (the JAX package's
tools/analysis_tools/viz_utils.py) on the port's own drawing code: overlays
of detections and ground truth (``utils.visualize.draw_detections``),
palettes, a jet colour map, multi-panel figures with titles, and a command
line that draws an instance map over its image:

  python -m nuhtc_tpu_torch.tools.analysis_tools.viz_utils img.png --inst inst.npy \\
      [--type type.npy] [--dataset pannuke] [--out overlay.png]

``colorize`` is ``cv2.applyColorMap(…, COLORMAP_JET)`` from OpenCV's table
carried here (``JET_U8``). ``put_text`` draws what ``cv2.putText(img, text,
org, FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1, LINE_AA)`` draws, from a table
of each printable ASCII glyph's coverage rendered by cv2 5.0.0
(``hershey_simplex_05.npz``; tests/test_torch_analysis_tools.py rebuilds and
checks it): cv2 5.0.0 places each glyph at a whole pixel, advances the pen
by whole pixels and blends each glyph over what is there as
(c · k + 127) // 255, k its coverage on white; so the table reproduces
cv2's text exactly, equal on every pixel of the tests' strings and
backgrounds. Characters outside printable ASCII are drawn as "?".
"""

from __future__ import annotations

import colorsys
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.data.classes import DATASET_CLASSES, DEFAULT_PALETTE
from nuhtc_tpu_torch.ops import imgproc
from nuhtc_tpu_torch.utils.imageio import read_image, write_image
from nuhtc_tpu_torch.utils.visualize import draw_detections

# OpenCV 5.0.0's COLORMAP_JET: applyColorMap of 0..255, as RGB rows
JET_U8 = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"
), np.uint8).reshape(256, 3)

_GLYPHS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hershey_simplex_05.npz")


def imshow_gt_det(
    img: np.ndarray,
    gt_masks: Sequence[np.ndarray],
    gt_labels: Sequence[int],
    det_masks: Sequence[np.ndarray],
    det_labels: Sequence[int],
    det_scores: Optional[Sequence[float]] = None,
    palette=None,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """Side-by-side ground truth | prediction panel (the reference's
    imshow_gt_det_bboxes, as analyze_results uses it)."""
    left = draw_detections(img, gt_masks, gt_labels, palette=palette)
    right = draw_detections(img, det_masks, det_labels, scores=det_scores, palette=palette)
    panel = np.concatenate([left, np.full((img.shape[0], 4, 3), 255, np.uint8), right], axis=1)
    if out_file:
        write_image(out_file, panel)
    return panel


def overlay_instances(img: np.ndarray, inst_map: np.ndarray, palette=None) -> np.ndarray:
    """A labelled instance map (a compact label map or a ground-truth
    instance map) as a coloured overlay."""
    ids = [int(i) for i in np.unique(inst_map) if i != 0]
    masks = [inst_map == i for i in ids]
    labels = [(i - 1) % len(palette or DEFAULT_PALETTE) for i in ids]
    return draw_detections(img, masks, labels, palette=palette)


def get_bounding_box(mask: np.ndarray):
    """[y1, y2, x1, x2], the tight box of a binary mask, each end one past
    the last pixel (the reference's convention)."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        return [0, 0, 0, 0]
    y1, y2 = np.where(rows)[0][[0, -1]]
    x1, x2 = np.where(cols)[0][[0, -1]]
    return [int(y1), int(y2) + 1, int(x1), int(x2) + 1]


def colorize(ch: np.ndarray, vmin: float | None = None, vmax: float | None = None) -> np.ndarray:
    """A scalar map → RGB uint8 through the jet colour map."""
    vmin = float(np.min(ch)) if vmin is None else vmin
    vmax = float(np.max(ch)) if vmax is None else vmax
    ch = (np.clip((ch - vmin) / max(vmax - vmin, 1e-8), 0, 1) * 255).astype(np.uint8)
    return JET_U8[ch]


def random_colors(n: int, bright: bool = True, seed: int = 0):
    """n distinct RGB tuples (a sweep of hues, shuffled)."""
    brightness = 1.0 if bright else 0.7
    hsv = [(i / max(n, 1), 1, brightness) for i in range(n)]
    colors = [tuple(int(c * 255) for c in colorsys.hsv_to_rgb(*h)) for h in hsv]
    np.random.RandomState(seed).shuffle(colors)
    return colors


def visualize_instances_map(
    img: np.ndarray,  # RGB uint8
    inst_map: np.ndarray,  # (H, W) int instance ids (0 = background)
    type_map: np.ndarray | None = None,  # (H, W) int class ids (1-based)
    dataset: str = "pannuke",
    line_thickness: int = 2,
) -> np.ndarray:
    """Instance borders from an instance map, each in the colour of its
    majority type (or of its id without a type map); the per-dataset
    visualize_instances_map_{pannuke,conic,consep} of the reference behind
    one ``dataset`` switch, the colours those of the dataset's classes."""
    palette = _dataset_palette(dataset) or DEFAULT_PALETTE
    ids = [int(i) for i in np.unique(inst_map) if i != 0]
    masks, labels = [], []
    for i in ids:
        m = inst_map == i
        if type_map is not None:
            vals, counts = np.unique(type_map[m], return_counts=True)
            lbl = max(int(vals[np.argmax(counts)]) - 1, 0)  # the majority type, 1-based map
        else:
            lbl = (i - 1) % len(palette)
        masks.append(m)
        labels.append(lbl)
    return draw_detections(img, masks, labels, palette=palette, thickness=line_thickness)


def _dataset_palette(dataset: str):
    """The class colours of a dataset named as ``visualize_instances_map``
    names it, None for another name."""
    name = {"pannuke": "PanNukeCocoDataset", "conic": "CoNICCocoDataset",
            "consep": "CoNSePCocoDataset", "nucls": "NuCLSCocoDataset"}.get(dataset.lower())
    return list(DEFAULT_PALETTE[:len(DATASET_CLASSES[name])]) if name else None


_glyph_table = None


def _glyphs() -> dict:
    """{character: (dx, dy, advance, coverage)} of the font table."""
    global _glyph_table
    if _glyph_table is None:
        t = np.load(_GLYPHS)
        out, start = {}, 0
        for code, (dx, dy, adv, h, w) in zip(t["codes"], t["meta"]):
            cov = t["coverage"][start:start + h * w].reshape(h, w)
            start += h * w
            out[chr(code)] = (int(dx), int(dy), int(adv), cov)
        _glyph_table = out
    return _glyph_table


def put_text(img: np.ndarray, text: str, org) -> np.ndarray:
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0,
    0), 1, cv2.LINE_AA)`` on a uint8 (H, W, 3) image, in place (and
    returned): glyph by glyph, each pixel a glyph covers becomes
    (c · k + 127) // 255 (k the glyph's coverage on white), the pen advancing
    by the glyph's advance; clipped to the image."""
    table = _glyphs()
    x, y = (int(v) for v in org)
    h, w = img.shape[:2]
    for ch in str(text):
        dx, dy, adv, cov = table.get(ch, table["?"])
        y0, x0 = y + dy, x + dx
        ys = slice(max(y0, 0), min(y0 + cov.shape[0], h))
        xs = slice(max(x0, 0), min(x0 + cov.shape[1], w))
        if ys.start < ys.stop and xs.start < xs.stop:
            k = cov[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0].astype(np.int64)
            region = img[ys, xs].astype(np.int64)
            k = k[..., None]
            img[ys, xs] = np.where(k != 255, (region * k + 127) // 255, region).astype(np.uint8)
        x += adv
    return img


def gen_figure(panels, titles=None, out_file: str | None = None, pad: int = 4):
    """A horizontal multi-panel figure with a white gap between panels and
    each title written at the top left of its panel (``put_text``); a 2-D
    panel goes through ``colorize``, a panel of another height is resized
    (bilinear) to the first one's."""
    h = max(p.shape[0] for p in panels)
    norm = []
    for p in panels:
        if p.ndim == 2:
            p = colorize(p)
        if p.shape[0] != h:
            size = (h, int(p.shape[1] * h / p.shape[0]))
            p = (imgproc.resize_u8(p, size) if p.dtype == np.uint8
                 else imgproc.resize_linear_f32(np.asarray(p, np.float32), size))
        norm.append(p.astype(np.uint8))
    spacer = np.full((h, pad, 3), 255, np.uint8)
    row = norm[0]
    for p in norm[1:]:
        row = np.concatenate([row, spacer, p], axis=1)
    if titles:
        for i, t in enumerate(titles[: len(norm)]):
            x = sum(p.shape[1] + pad for p in norm[:i])
            put_text(row, str(t), (x + 4, 18))
    if out_file:
        write_image(out_file, row)
    return row


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The command line: an overlay of saved maps (``python -m
    nuhtc_tpu_torch.tools.analysis_tools.viz_utils img.png --inst inst.npy
    [--type type.npy] [--dataset pannuke] [--out overlay.png]``)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("image")
    ap.add_argument("--inst", required=True, help=".npy instance map")
    ap.add_argument("--type", dest="type_map", default=None, help=".npy type map")
    ap.add_argument("--dataset", default="pannuke")
    ap.add_argument("--out", default="overlay.png")
    args = ap.parse_args(argv)

    img = read_image(args.image)
    inst = np.load(args.inst)
    tmap = np.load(args.type_map) if args.type_map else None
    out = visualize_instances_map(img, inst, tmap, dataset=args.dataset)
    write_image(args.out, out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
