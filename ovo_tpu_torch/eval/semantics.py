"""Confusion-matrix semantic-segmentation metrics (port of
``ovo_tpu/eval/semantics.py``, numpy on the host).

Per-class IoU / Acc with nan masking, mIoU / mAcc, frequency-weighted
f-mIoU / f-mAcc, head / common / tail thirds, ``statistics.txt`` and the
best-effort matplotlib plots; the confusion matrix is one bincount.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from ..utils.io import read_labels


def update_confmat(confusion: np.ndarray, gt_ids: np.ndarray,
                   pr_ids: np.ndarray, ignore: Sequence[int]) -> None:
    """Vectorized confusion update: confusion[gt, pr] += 1 for every vertex
    whose gt label is not ignored."""
    n = confusion.shape[0]
    gt = np.asarray(gt_ids, np.int64)
    pr = np.asarray(pr_ids, np.int64)
    keep = ~np.isin(gt, np.asarray(list(ignore), np.int64)) if len(ignore) \
        else np.ones_like(gt, bool)
    keep &= (gt >= 0) & (gt < n) & (pr >= 0) & (pr < n)
    flat = gt[keep] * n + pr[keep]
    confusion += np.bincount(flat, minlength=n * n).reshape(n, n).astype(
        confusion.dtype)


def evaluate_scan(pr_file, gt_file, confusion, map_gt_ids=None, ignore=()):
    pr_ids = read_labels(pr_file)
    gt_ids = read_labels(gt_file)
    if map_gt_ids is not None:
        gt_ids = np.vectorize(lambda v: map_gt_ids.get(int(v), -1))(gt_ids)
    if pr_ids.shape != gt_ids.shape:
        print(f"number of predicted values does not match number of vertices."
              f" pred: {pr_ids.shape}; gt: {gt_ids.shape}; {pr_file}")
    update_confmat(confusion, gt_ids, pr_ids, ignore)


def get_iou(label_id: int, confusion: np.ndarray) -> Tuple[float, float]:
    tp = np.longlong(confusion[label_id, label_id])
    fn = np.longlong(confusion[label_id, :].sum()) - tp
    fp = np.longlong(confusion[:, label_id].sum()) - tp
    denom = float(tp + fp + fn)
    if denom == 0:
        return float("nan"), float("nan")
    return tp / denom, tp / max(float(tp + fn), 1e-6)


def iou_acc_from_confmat(confmat: np.ndarray, num_classes: int,
                         ignore: Sequence[int], mask_nan: bool = True,
                         verbose: bool = False, labels=None):
    if verbose:
        print("\n classes \t IoU \t Acc")
        print("----------------------------")
    ious, accs, weights = [], [], []
    for i in range(num_classes):
        if i in ignore:
            continue
        iou, acc = get_iou(i, confmat)
        ious.append(iou)
        accs.append(acc)
        weights.append(confmat[i].sum())
        if verbose:
            print("{0:<14s}: {1:>5.2%}   {2:>6.2%}".format(labels[i], iou, acc))
    iou_values = np.array(ious)
    acc_values = np.array(accs)
    weight_values = np.array(weights, dtype=np.float64)
    if mask_nan:
        iou_mask = ~np.isnan(iou_values)
        acc_mask = ~np.isnan(acc_values)
    else:
        iou_mask = np.ones_like(iou_values, bool)
        acc_mask = np.ones_like(acc_values, bool)
    return iou_values, iou_mask, weight_values, acc_values, acc_mask


def eval_semantics(output_path, gt_path, scenes: List[str],
                   dataset_info: Dict[str, Any], mask_nan: bool = True,
                   ignore_background: bool = False, verbose: bool = True,
                   return_metrics: bool = False):
    num_classes = dataset_info["num_classes"]
    map_to_reduced = dataset_info.get("map_to_reduced")
    labels = (dataset_info["class_names"] if map_to_reduced is None
              else dataset_info["class_names_reduced"])
    ignore = list(dataset_info.get("ignore", []))
    if ignore_background:
        key = ("background_reduced_ids" if map_to_reduced
               else "background_ids")
        assert dataset_info.get(key), \
            "To ignore background a list of background ids is required!"
        ignore.extend(dataset_info[key])

    output_path = Path(output_path)
    confusion = np.zeros([len(scenes), num_classes, num_classes],
                         dtype=np.ulonglong)
    if verbose:
        print("evaluating", len(scenes), "scans...")
    for i, scene in enumerate(scenes):
        evaluate_scan(output_path / f"{scene}.txt",
                      Path(gt_path) / f"{scene}.txt",
                      confusion[i], map_to_reduced, ignore)

    for i, scene in enumerate(scenes):
        iou_v, iou_m, w_v, acc_v, acc_m = iou_acc_from_confmat(
            confusion[i], num_classes, ignore, mask_nan, False, labels)
        if verbose:
            print(f"Scene: {scene}")
            print(f"mIoU: \t {np.mean(iou_v[iou_m]):.2%}; "
                  f"mAcc: \t {np.mean(acc_v[acc_m]):.2%}\n")

    confusion = confusion.sum(0)
    iou_v, iou_m, w_v, acc_v, acc_m = iou_acc_from_confmat(
        confusion, num_classes, ignore, mask_nan, verbose, labels)
    metrics = {
        "iou": round(float(np.mean(iou_v[iou_m])), 3),
        "acc": round(float(np.mean(acc_v[acc_m])), 3),
        "fiou": round(float(np.sum(iou_v[iou_m] * w_v[iou_m]) /
                            max(w_v[iou_m].sum(), 1e-9)), 3),
        "facc": round(float(np.sum(acc_v[acc_m] * w_v[acc_m]) /
                            max(w_v[acc_m].sum(), 1e-9)), 3),
    }
    thirds = len(iou_v) // 3
    for split, i in [["head", 0], ["comm", 1], ["tail", 2]]:
        lo, hi = thirds * i, thirds * (i + 1)
        metrics[f"iou_{split}"] = round(
            float(np.mean(iou_v[lo:hi][iou_m[lo:hi]])), 3) \
            if iou_m[lo:hi].any() else float("nan")
        metrics[f"acc_{split}"] = round(
            float(np.mean(acc_v[lo:hi][acc_m[lo:hi]])), 3) \
            if acc_m[lo:hi].any() else float("nan")

    if verbose:
        print(f"\nmIoU: \t {metrics['iou']:.2%}; mAcc: \t {metrics['acc']:.2%}\n")
        print(f"f-mIoU: \t {metrics['fiou']:.2%}; "
              f"f-mAcc: \t {metrics['facc']:.2%}\n")
        _write_statistics(output_path, labels, ignore, acc_v, iou_v)
        _plots(output_path, iou_v, acc_v, labels, ignore, confusion)
    if return_metrics:
        return metrics, confusion
    return float(np.mean(iou_v[iou_m])), confusion


def _write_statistics(output_path: Path, labels, ignore, acc_values,
                      iou_values) -> None:
    with open(output_path / "statistics.txt", "w") as f:
        f.write("label, acc, iou, \n")
        count = 0
        for i in range(len(labels)):
            if i in ignore:
                continue
            f.write(f"{labels[i]}, {acc_values[count]}, {iou_values[count]}, \n")
            count += 1


def _plots(output_path: Path, iou_values, acc_values, labels, ignore,
           confusion) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        names = [l for i, l in enumerate(labels) if i not in ignore]
        idx = np.asarray([0.4 + i * 3 for i in range(len(names))])
        fig, ax = plt.subplots(figsize=(20, max(4, 400 / max(len(names), 1) / 4)))
        ax.bar(idx, np.nan_to_num(iou_values), width=1.0)
        ax.bar(idx + 1.0, np.nan_to_num(acc_values), width=1.0)
        ax.set_xticks(idx)
        ax.set_xticklabels(names, rotation=85)
        ax.legend(["IoU", "Acc"], loc="upper right")
        plt.tight_layout()
        plt.savefig(output_path / "plot_iou_acc.png")
        plt.close()

        fig, ax = plt.subplots(figsize=(10, 9))
        with np.errstate(divide="ignore"):
            ax.imshow(np.log1p(confusion.astype(np.float64)), cmap="viridis")
        ax.set_title("Confusion matrix (log scale)")
        plt.tight_layout()
        plt.savefig(output_path / "confmat.png")
        plt.close()
    except Exception as e:  # plots are best-effort artifacts
        print(f"plotting skipped: {e}")


def eval_scannetpp_semantic(cfg: Dict[str, Any], top_k: List[int] = [1],
                            verbose: bool = True):
    """ScanNet++ semantic-segmentation evaluation, self-contained: per-vertex
    prediction files under ``preds_dir``
    (``<scene>.txt`` -- one class id per line, or k whitespace-separated
    ids per line for top-k predictions) and GT files under ``gt_dir``,
    classes from ``classes_file``. Ignore id -100 matches the toolkit.

    Returns top-1 mIoU (float), printing per-class IoU like the reference.
    """
    scene_ids = cfg["scene_ids"]
    with open(cfg["classes_file"]) as f:
        semantic_classes = f.read().splitlines()
    num_classes = len(semantic_classes)
    ignore_id = cfg.get("ignore_id", -100)

    results = {}
    for k in top_k:
        confusion = np.zeros((num_classes, num_classes), dtype=np.ulonglong)
        for scene in scene_ids:
            pred = np.loadtxt(Path(cfg["preds_dir"]) / f"{scene}.txt",
                              dtype=np.longlong, ndmin=2)
            gt = np.loadtxt(Path(cfg["gt_dir"]) / f"{scene}.txt",
                            dtype=np.longlong).reshape(-1)
            assert pred.shape[0] == gt.shape[0], \
                f"{scene}: {pred.shape[0]} preds vs {gt.shape[0]} gt"
            assert pred.shape[1] >= k, \
                f"{scene}: top-{k} requested but predictions have only " \
                f"{pred.shape[1]} column(s)"
            keep = gt != ignore_id
            p, g = pred[keep, :k], gt[keep]
            # top-k: credit the GT class when it appears in the first k
            # predictions, else count the top-1 prediction as the error
            hit = (p == g[:, None]).any(axis=1)
            eff = np.where(hit, g, p[:, 0])
            update_confmat(confusion, g, eff, [])
        iou_v, iou_m, _, _, _ = iou_acc_from_confmat(
            confusion, num_classes, [], True, False, semantic_classes)
        miou = float(np.mean(iou_v[iou_m]))
        results[k] = (miou, iou_v)
        if verbose:
            print(f"Top {k} mIOU: {miou}")
    if verbose:
        for name, class_iou in zip(semantic_classes, results[top_k[-1]][1]):
            print(f"{name: <25}: {class_iou}")
        print("----------------------------------------------------")
    return results[1][0] if 1 in results else results[top_k[0]][0]
