"""Depth accuracy evaluation over the bundled data_split manifests.

A copy of ``rollingdepth_tpu/eval.py`` with OpenCV imported inside the
functions that read frames or resize, whose ``evaluate_dataset`` drives the
port's pipeline.  The data_split CSV manifests (header ``rgb,depth``,
relative frame paths) cover scannet / bonn_rgbd / pointodyssey / dydtof.
The protocol is the affine-invariant video-depth standard: predictions are
least-squares scale/shift-aligned to GT per sequence, then

    AbsRel = mean(|pred - gt| / gt)        δ1 = mean(max(pred/gt, gt/pred) < 1.25)

over valid GT pixels.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# the repository's eval manifests:
# scannet 99x90f, bonn_rgbd 5x110f, pointodyssey 250f masked, dydtof sub16
DEFAULT_SPLIT_DIR = os.path.join(os.path.dirname(__file__), "..", "data_split")

# GT depth decoding: uint16 PNG value -> meters, pinned to the datasets'
# published conventions:
# - scannet: depth PNGs are millimeters ("depth in millimeters stored as
#   16-bit", ScanNet data-organization docs) -> 1000
# - bonn_rgbd: TUM-RGBD-format factor 5000 ("the depth images are scaled by
#   a factor of 5000", TUM RGB-D dataset file-format docs; the Bonn dynamic
#   RGB-D dataset states it follows the TUM format)
# - pointodyssey: depth PNGs encode meters*1000 as uint16 (PointOdyssey
#   toolkit reads depth/ *.png / 1000.0)
# - dydtof: the bundled manifests reference DepthMap/*.npy float maps, which
#   load unscaled (load_gt_depths); the 1000 entry applies only if a PNG
#   export is used instead (ToF millimeter convention)
# tests/test_torch_copies.py holds the table and the decode to the JAX package's.
DATASET_DEPTH_SCALE = {
    "scannet": 1000.0,
    "bonn_rgbd": 5000.0,  # TUM-format factor
    "pointodyssey": 1000.0,
    "dydtof": 1000.0,
}


@dataclasses.dataclass
class EvalSample:
    rgb_paths: List[str]
    depth_paths: List[str]
    name: str


def load_manifest(csv_path: str, data_root: str) -> EvalSample:
    """Parse one data_split CSV (rgb,depth paths relative to the SEQUENCE
    directory).

    The sequence identity lives only in the CSV filename — every scannet
    scene CSV contains the same ``color/0.jpg`` rows — and ``^`` in a stem
    encodes a path separator (``apartment_big^ba_shot1.csv`` →
    ``apartment_big/ba_shot1/``), so frames resolve under
    ``data_root/<seq>/``."""
    seq_rel = os.path.splitext(os.path.basename(csv_path))[0].replace("^", os.sep)
    seq_root = os.path.join(data_root, seq_rel)
    rgb, depth = [], []
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        for row in reader:
            rgb.append(os.path.join(seq_root, row["rgb"]))
            depth.append(os.path.join(seq_root, row["depth"]))
    return EvalSample(rgb, depth, os.path.splitext(os.path.basename(csv_path))[0])


def list_manifests(split_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(split_dir):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".csv"))
    # os.walk visits directories in arbitrary filesystem order; sort the full
    # list so max_sequences selects a deterministic subset on every machine
    return sorted(out)


def load_frames_from_manifest(sample: EvalSample, processing_res: int = 0) -> np.ndarray:
    """RGB frames -> [N, 3, H, W] in [-1, 1]."""
    from .io.video import _cv2, resize_max_res

    cv2 = _cv2()
    frames = []
    for p in sample.rgb_paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise RuntimeError(f"cannot read RGB frame {p}")
        img = img[:, :, ::-1]
        if processing_res > 0:
            img = resize_max_res(img, processing_res)
        frames.append((img.astype(np.float32) / 255.0 * 2 - 1).transpose(2, 0, 1))
    return np.stack(frames)


def load_gt_depths(sample: EvalSample, depth_scale: float) -> List[np.ndarray]:
    out = []
    cv2 = None
    for p in sample.depth_paths:
        if p.endswith(".npy"):
            # float depth maps (dydtof DepthMap/*.npy) are already metric;
            # the integer-PNG scale table does not apply
            d = np.load(p)
            out.append(np.asarray(d, np.float32))
            continue
        if cv2 is None:
            from .io.video import _cv2

            cv2 = _cv2()
        d = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise RuntimeError(f"cannot read GT depth {p}")
        out.append(d.astype(np.float32) / depth_scale)
    if out:
        # plausibility guard for the pinned decode table: indoor/outdoor GT
        # should land in single-digit meters; a wrong factor shifts the
        # median by 3+ orders of magnitude.  Warn, don't fail — exotic
        # exports exist and --eval-depth-scale can override.
        valid = np.concatenate([d[d > 0].ravel()[:10000] for d in out])
        if valid.size:
            med = float(np.median(valid))
            if not (0.05 <= med <= 200.0):
                logger.warning(
                    "GT depth median %.4g m looks implausible for scale %.0f "
                    "— check the dataset's depth encoding (override with "
                    "depth_scale/--eval-depth-scale)", med, depth_scale,
                )
    return out


def align_least_squares(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> Tuple[float, float]:
    """Closed-form (scale, shift) minimizing ||s*pred + t - gt||² on mask."""
    x = pred[mask].astype(np.float64)
    y = gt[mask].astype(np.float64)
    a = np.stack([x, np.ones_like(x)], axis=1)
    sol, *_ = np.linalg.lstsq(a, y, rcond=None)
    return float(sol[0]), float(sol[1])


def depth_metrics(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> Dict[str, float]:
    p = pred[mask]
    g = gt[mask]
    p = np.clip(p, 1e-6, None)
    abs_rel = float(np.mean(np.abs(p - g) / g))
    ratio = np.maximum(p / g, g / p)
    return {
        "abs_rel": abs_rel,
        "delta1": float(np.mean(ratio < 1.25)),
        "delta2": float(np.mean(ratio < 1.25**2)),
        "delta3": float(np.mean(ratio < 1.25**3)),
        "rmse": float(np.sqrt(np.mean((p - g) ** 2))),
    }


def evaluate_sequence(
    pred_depth: np.ndarray,  # [N, H, W] model output (affine-invariant)
    gt_depths: List[np.ndarray],
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    align_per_sequence: bool = True,
) -> Dict[str, float]:
    """Affine-align prediction to GT (one (s,t) per sequence, the paper's
    protocol) and compute metrics averaged over frames."""
    n = len(gt_depths)
    preds, gts, masks = [], [], []
    for i in range(n):
        gt = gt_depths[i]
        pred = pred_depth[i]
        if pred.shape != gt.shape:
            from .io.video import _cv2

            cv2 = _cv2()
            pred = cv2.resize(pred, (gt.shape[1], gt.shape[0]), interpolation=cv2.INTER_LINEAR)
        mask = (gt > min_depth) & (gt < max_depth) & np.isfinite(gt)
        preds.append(pred)
        gts.append(gt)
        masks.append(mask)

    pred_all = np.stack(preds)
    gt_all = np.stack(gts)
    mask_all = np.stack(masks)
    if not mask_all.any():
        raise ValueError("no valid GT pixels")

    if align_per_sequence:
        s, t = align_least_squares(pred_all, gt_all, mask_all)
        pred_all = pred_all * s + t

    per_frame = [
        depth_metrics(pred_all[i], gt_all[i], mask_all[i])
        for i in range(n)
        if masks[i].any()
    ]
    return {k: float(np.mean([m[k] for m in per_frame])) for k in per_frame[0]}


METRIC_COLUMNS = ("abs_rel", "delta1", "delta2", "delta3", "rmse")


def write_eval_csv(path: str, rows: List[Tuple[str, Dict[str, float]]]) -> None:
    """Per-sequence metric rows + a final mean row (one header, plain floats)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(("sequence",) + METRIC_COLUMNS)
        for name, m in rows:
            writer.writerow([name] + [f"{m[k]:.6f}" for k in METRIC_COLUMNS])
        if rows:
            writer.writerow(
                ["MEAN"]
                + [f"{np.mean([m[k] for _, m in rows]):.6f}" for k in METRIC_COLUMNS]
            )


def evaluate_dataset(
    pipeline,
    split_dir: Optional[str],
    data_root: str,
    dataset: str,
    processing_res: int = 768,
    max_sequences: Optional[int] = None,
    csv_path: Optional[str] = None,
    depth_scale: Optional[float] = None,
    **pipe_kwargs,
) -> Dict[str, float]:
    """Run the pipeline over every manifest in a split and average metrics.

    ``csv_path`` additionally writes one row per sequence plus a MEAN row.
    ``depth_scale`` overrides the per-dataset GT decode factor — the table
    is pinned from published conventions, so a mismatched export can be
    corrected without code changes (a wrong factor leaves AbsRel intact
    through the affine alignment but silently corrupts delta thresholds and
    rmse)."""
    if split_dir is None:
        split_dir = os.path.join(DEFAULT_SPLIT_DIR, dataset)
    scale = (
        depth_scale if depth_scale is not None
        else DATASET_DEPTH_SCALE.get(dataset, 1000.0)
    )
    manifests = list_manifests(split_dir)
    if not manifests:
        raise FileNotFoundError(f"no .csv manifests found under {split_dir}")
    if max_sequences is not None:
        manifests = manifests[:max_sequences]
    results: List[Tuple[str, Dict[str, float]]] = []
    for m in manifests:
        sample = load_manifest(m, data_root)
        frames = load_frames_from_manifest(sample, processing_res)
        out = pipeline.forward(frames, **pipe_kwargs)
        # model predicts affine-invariant inverse-ish depth in [-1,1]; shift
        # to positive before alignment
        pred = np.asarray(out.depth_pred).squeeze(1) / 2.0 + 0.5
        gt = load_gt_depths(sample, scale)
        metrics = evaluate_sequence(pred, gt)
        logger.info("%s: %s", sample.name, metrics)
        results.append((sample.name, metrics))
        if csv_path is not None:
            write_eval_csv(csv_path, results)  # incremental: long splits survive interrupts
    return {k: float(np.mean([m[k] for _, m in results])) for k in results[0][1]}
