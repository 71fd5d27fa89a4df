"""CoNSeP metric suite over .mat instance and type maps (the command line of
tools/analysis_tools/consep/compute_stats.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.consep.compute_stats \\
      --mode type --true-dir Labels/ --pred-dir infer/CoNSePCocoDataset/

``type``: centroids paired over all images (Hungarian within radius 12),
the detection F1 and HoVer-Net's weighted per-type Fc; ``inst``: dice, aji,
dq, sq, pq and aji+ per image and their average; ``both`` runs the two.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np
from scipy import io as sio
from scipy import ndimage as ndi

from nuhtc_tpu_torch.eval.stats import (
    get_fast_pq,
    get_fast_aji,
    get_fast_aji_plus,
    get_dice_1,
    pair_coordinates,
    remap_label,
)


def centroids_types(inst_map, type_map):
    """Fallback when a .mat lacks inst_centroid/inst_type: derive per-instance
    centroids (X, Y order, ref docstring :28-30) and majority types."""
    ids = np.unique(inst_map)
    ids = ids[ids != 0]
    cents, types = [], []
    for i in ids:
        m = inst_map == i
        cy, cx = ndi.center_of_mass(m)
        cents.append([cx, cy])
        vals, counts = np.unique(type_map[m], return_counts=True)
        types.append(int(vals[np.argmax(counts)]))
    return (
        np.asarray(cents, np.float32).reshape(-1, 2),
        np.asarray(types, np.int32),
    )


def _load_centroids_types(path):
    """Prefer the stored inst_centroid/inst_type fields (ref :51-77),
    falling back to deriving them from inst_map/type_map."""
    info = sio.loadmat(path)
    if "inst_centroid" in info:
        cent = info["inst_centroid"].astype("float32").reshape(-1, 2)
        it = info["inst_type"].astype("int32")
        it = it[:, 0] if cent.shape[0] != 0 else np.array([0], np.int32)
    else:
        inst = info["inst_map"].astype(np.int32)
        tmap = info.get("type_map", np.zeros_like(inst))
        if tmap.shape != inst.shape:  # per-instance vector form
            tm = np.zeros_like(inst)
            for i, v in enumerate(np.ravel(tmap), 1):
                tm[inst == i] = v
            tmap = tm
        cent, it = centroids_types(inst, tmap)
    if cent.shape[0] == 0:
        # reference :57-60: empty images contribute one dummy instance
        cent = np.array([[0.0, 0.0]], np.float32)
        it = np.array([0], np.int32)
    return cent, it


def run_nuclei_type_stat(pred_dir, true_dir, radius=12.0, type_uid_list=None,
                         exhaustive=True):
    """Reference run_nuclei_type_stat (:22-179). Returns
    [f1_d, acc_type, f1_type_per_uid...]."""
    file_list = sorted(glob.glob(os.path.join(pred_dir, "*.mat")))

    paired_all, unpaired_true_all, unpaired_pred_all = [], [], []
    true_inst_type_all, pred_inst_type_all = [], []
    true_idx_offset = pred_idx_offset = 0
    for file_idx, ppath in enumerate(file_list):
        basename = os.path.basename(ppath).split(".")[0]
        true_centroid, true_inst_type = _load_centroids_types(
            os.path.join(true_dir, basename + ".mat")
        )
        pred_centroid, pred_inst_type = _load_centroids_types(ppath)

        paired, unpaired_true, unpaired_pred = pair_coordinates(
            true_centroid, pred_centroid, radius
        )

        true_idx_offset = (
            true_idx_offset + true_inst_type_all[-1].shape[0] if file_idx != 0 else 0
        )
        pred_idx_offset = (
            pred_idx_offset + pred_inst_type_all[-1].shape[0] if file_idx != 0 else 0
        )
        true_inst_type_all.append(true_inst_type)
        pred_inst_type_all.append(pred_inst_type)
        if paired.shape[0] != 0:
            paired = paired.copy()
            paired[:, 0] += true_idx_offset
            paired[:, 1] += pred_idx_offset
            paired_all.append(paired)
        unpaired_true_all.append(unpaired_true + true_idx_offset)
        unpaired_pred_all.append(unpaired_pred + pred_idx_offset)

    paired_all = (
        np.concatenate(paired_all, axis=0)
        if paired_all else np.zeros((0, 2), np.int64)
    )
    unpaired_true_all = np.concatenate(unpaired_true_all, axis=0)
    unpaired_pred_all = np.concatenate(unpaired_pred_all, axis=0)
    true_inst_type_all = np.concatenate(true_inst_type_all, axis=0)
    pred_inst_type_all = np.concatenate(pred_inst_type_all, axis=0)

    paired_true_type = true_inst_type_all[paired_all[:, 0]]
    paired_pred_type = pred_inst_type_all[paired_all[:, 1]]
    unpaired_true_type = true_inst_type_all[unpaired_true_all]
    unpaired_pred_type = pred_inst_type_all[unpaired_pred_all]

    def _f1_type(paired_true, paired_pred, unpaired_true, unpaired_pred, type_id, w):
        # HoVer-Net weighted Fc (ref :116-145): TN over paired samples
        # carrying the type on either side, w-weighted paired/unpaired errors
        type_samples = (paired_true == type_id) | (paired_pred == type_id)
        paired_true = paired_true[type_samples]
        paired_pred = paired_pred[type_samples]

        tp_dt = ((paired_true == type_id) & (paired_pred == type_id)).sum()
        tn_dt = ((paired_true != type_id) & (paired_pred != type_id)).sum()
        fp_dt = ((paired_true != type_id) & (paired_pred == type_id)).sum()
        fn_dt = ((paired_true == type_id) & (paired_pred != type_id)).sum()

        if not exhaustive:
            ignore = (paired_true == -1).sum()
            fp_dt -= ignore

        fp_d = (unpaired_pred == type_id).sum()
        fn_d = (unpaired_true == type_id).sum()
        return (2 * (tp_dt + tn_dt)) / (
            2 * (tp_dt + tn_dt)
            + w[0] * fp_dt + w[1] * fn_dt + w[2] * fp_d + w[3] * fn_d
        )

    w = [1, 1]
    tp_d = paired_pred_type.shape[0]
    fp_d = unpaired_pred_type.shape[0]
    fn_d = unpaired_true_type.shape[0]
    tp_tn_dt = (paired_pred_type == paired_true_type).sum()
    fp_fn_dt = (paired_pred_type != paired_true_type).sum()
    if not exhaustive:
        fp_fn_dt -= (paired_true_type == -1).sum()
    acc_type = tp_tn_dt / (tp_tn_dt + fp_fn_dt)
    f1_d = 2 * tp_d / (2 * tp_d + w[0] * fp_d + w[1] * fn_d)

    w = [2, 2, 1, 1]
    if type_uid_list is None:
        type_uid_list = np.unique(true_inst_type_all).tolist()
    results_list = [f1_d, acc_type]
    for type_uid in type_uid_list:
        results_list.append(
            _f1_type(paired_true_type, paired_pred_type,
                     unpaired_true_type, unpaired_pred_type, type_uid, w)
        )
    np.set_printoptions(formatter={"float": "{: 0.5f}".format})
    print(np.array(results_list))
    return results_list


def run_nuclei_inst_stat(pred_dir, true_dir, print_img_stats=False, ext=".mat"):
    """Reference run_nuclei_inst_stat (:182-236): per-image
    dice/aji/dq/sq/pq/aji+ and the average row."""
    file_list = sorted(glob.glob(os.path.join(pred_dir, "*" + ext)))
    metrics = [[], [], [], [], [], []]
    for ppath in file_list:
        basename = os.path.basename(ppath).split(".")[0]
        true = sio.loadmat(os.path.join(true_dir, basename + ".mat"))
        true = remap_label(true["inst_map"].astype("int32"), by_size=False)
        pred = sio.loadmat(ppath)
        pred = remap_label(pred["inst_map"].astype("int32"), by_size=False)

        pq_info = get_fast_pq(true, pred, match_iou=0.5)[0]
        metrics[0].append(get_dice_1(true, pred))
        metrics[1].append(get_fast_aji(true, pred))
        metrics[2].append(pq_info[0])  # dq
        metrics[3].append(pq_info[1])  # sq
        metrics[4].append(pq_info[2])  # pq
        metrics[5].append(get_fast_aji_plus(true, pred))
        if print_img_stats:
            print(basename, "  ".join(f"{m[-1]:.4f}" for m in metrics))
    metrics = np.array(metrics)
    metrics_avg = np.mean(metrics, axis=-1)
    names = ["dice", "aji", "dq", "sq", "pq", "aji+"]
    print("  ".join(f"{n}: {v:.4f}" for n, v in zip(names, metrics_avg)))
    return dict(zip(names, metrics_avg.tolist()))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["type", "inst", "both"], default="both")
    ap.add_argument("--true-dir", required=True)
    ap.add_argument("--pred-dir", required=True)
    ap.add_argument("--radius", type=float, default=12.0)
    ap.add_argument("--non-exhaustive", action="store_true",
                    help="GT type labels are not exhaustive (-1 = ignore)")
    args = ap.parse_args(argv)
    if args.mode in ("inst", "both"):
        run_nuclei_inst_stat(args.pred_dir, args.true_dir)
    if args.mode in ("type", "both"):
        run_nuclei_type_stat(args.pred_dir, args.true_dir, radius=args.radius,
                             exhaustive=not args.non_exhaustive)

    return 0

if __name__ == "__main__":
    raise SystemExit(main())
