"""Tile-level segmentation results converted between dataset layouts (the
command line of tools/dataset/convert_format.py, as a module):

  python -m nuhtc_tpu_torch.tools.dataset.convert_format --data_path preds_conic.npy \\
      --format conic --to pannuke [--class_num 5] [--name out]

Layouts: conic — (N, H, W, 2), instance ids then class ids; pannuke —
(N, H, W, C + 1), per-class instance maps and a background flag; consep —
one .mat per image with inst_map (and inst_type). ``to_qupath`` writes a
centroid TSV for QuPath's point import.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np


def to_qupath(file_path, nuc_pos_list, nuc_type_list, type_info_dict):
    """Centroid TSV for QuPath v0.2.3 (x, y, class, name, color-int)."""
    nuc_pos_list = np.asarray(nuc_pos_list)
    nuc_type_list = np.asarray(nuc_type_list)
    assert nuc_pos_list.shape[0] == nuc_type_list.shape[0]
    with open(file_path, "w") as f:
        f.write("x\ty\tclass\tname\tcolor\n")
        for pos, t in zip(nuc_pos_list, nuc_type_list):
            name, (r, g, b) = type_info_dict[int(t)]
            f.write(f"{pos[0]}\t{pos[1]}\t\t{name}\t{(r << 16) + (g << 8) + b}\n")


def conic2pannuke(data: np.ndarray) -> np.ndarray:
    """(N, H, W, 2) → (N, H, W, C+1)."""
    class_num = int(data[..., 1].max())
    n, h, w = data.shape[:3]
    out = np.zeros((n, h, w, class_num + 1), data.dtype)
    for c in range(class_num):
        sel = data[..., 1] == c + 1
        out[..., c][sel] = data[..., 0][sel]
    out[..., -1][data[..., 0] == 0] = 1
    return out


def pannuke2conic(data: np.ndarray) -> np.ndarray:
    """(N, H, W, C+1) → (N, H, W, 2) with instance ids renumbered 1..n."""
    class_num = data.shape[-1] - 1
    n, h, w = data.shape[:3]
    out = np.zeros((n, h, w, 2), data.dtype)
    for idx in range(n):
        uid = 1
        for c in range(class_num):
            for inst in np.unique(data[idx, :, :, c]):
                if inst == 0:
                    continue
                sel = data[idx, :, :, c] == inst
                out[idx, :, :, 0][sel] = uid
                out[idx, :, :, 1][sel] = c + 1
                uid += 1
    return out


def _save_consep_mats(inst_maps, data_dir, data_name):
    import scipy.io as sio

    os.makedirs(f"{data_dir}/mat/{data_name}", exist_ok=True)
    for idx, inst in enumerate(inst_maps):
        # note: the reference writes range(1, max) which drops the last uid —
        # we write the full 1..max list
        sio.savemat(
            f"{data_dir}/mat/{data_name}/{data_name}_{idx + 1}.mat",
            {"inst_map": inst, "inst_uid": np.arange(1, int(inst.max()) + 1)},
        )


def conic2consep(data: np.ndarray, data_dir: str, data_name: str):
    _save_consep_mats([d[..., 0] for d in data], data_dir, data_name)


def pannuke2consep(data: np.ndarray, data_dir: str, data_name: str):
    _save_consep_mats([c[..., 0] for c in pannuke2conic(data)], data_dir, data_name)


def _load_consep_dir(file_path):
    import scipy.io as sio

    def _order(path):
        # Numeric sort on the trailing integer so '{name}_{idx}.mat' files
        # (our own _save_consep_mats layout) round-trip; pure-numeric stems
        # ('3.mat') sort the same as the reference. Lexical fallback.
        import re

        stem = os.path.splitext(os.path.basename(path))[0]
        m = re.search(r"(\d+)$", stem)
        return (0, int(m.group(1)), stem) if m else (1, 0, stem)

    paths = sorted(glob.glob(os.path.join(file_path, "*mat")), key=_order)
    return [sio.loadmat(p) for p in paths]


def consep2conic(file_path: str) -> list:
    out = []
    for mat in _load_consep_dir(file_path):
        inst_map, inst_type = mat["inst_map"], mat["inst_type"]
        img = np.zeros(inst_map.shape + (2,))
        img[..., 0] = inst_map
        for i, uid in enumerate(np.delete(np.unique(inst_map), 0)):
            img[..., 1][inst_map == uid] = int(inst_type[i, 0])
        out.append(img)
    return out


def consep2pannuke(file_path: str, class_num: int = 5) -> list:
    out = []
    for mat in _load_consep_dir(file_path):
        inst_map, inst_type = mat["inst_map"], mat["inst_type"]
        img = np.zeros(inst_map.shape + (class_num + 1,))
        for i, uid in enumerate(np.delete(np.unique(inst_map), 0)):
            c = int(inst_type[i, 0] - 1)
            img[..., c][inst_map == uid] = img[..., c].max() + 1
        img[..., -1] = 1 - np.max(img[..., :-1], axis=-1).clip(0, 1)
        out.append(img)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_path", type=str, required=True)
    ap.add_argument("--format", type=str, required=True, choices=["consep", "conic", "pannuke"])
    ap.add_argument("--to", type=str, required=True, choices=["consep", "conic", "pannuke"])
    ap.add_argument("--class_num", type=int, default=5)
    ap.add_argument("--name", type=str, default=None)
    args = ap.parse_args(argv)

    data_name = os.path.splitext(os.path.basename(args.data_path))[0]
    data_dir = os.path.dirname(args.data_path) or "."
    out_path = os.path.join(data_dir, f"{args.name or f'{data_name}_{args.to}'}.npy")
    pair = f"{args.format}2{args.to}"

    if pair == "conic2pannuke":
        np.save(out_path, conic2pannuke(np.load(args.data_path)))
    elif pair == "pannuke2conic":
        np.save(out_path, pannuke2conic(np.load(args.data_path)))
    elif pair == "consep2conic":
        np.save(out_path, np.asarray(consep2conic(args.data_path)))
    elif pair == "consep2pannuke":
        np.save(out_path, np.asarray(consep2pannuke(args.data_path, args.class_num)))
    elif pair == "conic2consep":
        conic2consep(np.load(args.data_path), data_dir, data_name)
    elif pair == "pannuke2consep":
        pannuke2consep(np.load(args.data_path), data_dir, data_name)
    else:
        raise NotImplementedError(pair)
    print(f"converted {pair}")

    return 0

if __name__ == "__main__":
    raise SystemExit(main())
