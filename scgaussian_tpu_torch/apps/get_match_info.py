"""Offline match-prior extraction — `match_data.npy` producer.

A copy of the JAX package's `apps/get_match_info.py` (OpenCV on the host
in both packages). It mirrors `data_preprocess/get_match_info.py:300-422`:
pick the same 3-view training split as training, produce up to
`--num_matches` correspondences per view pair, filter with MAGSAC
fundamental-matrix RANSAC (`:389-393`), and store normalized-[0, 1] pixel
coordinates both directions.

Matcher backends (`--matcher`):
- `dkm` — GIM-trained DKMv3 dense matcher like the reference; requires the
  external checkpoint + model code (`--dkm_checkpoint`, torch). Not bundled
  (the repository ships no checkpoint); the hook mirrors
  `get_match_info.py:310-328`.
- `sift` (default) — classical fallback: OpenCV SIFT + ratio-test FLANN
  matching. Fewer, sparser matches than DKM but produces a valid prior for
  the full pipeline without any external weights.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np


def llff_train_split(filenames, n_sparse=3):
    """Same split as training (`data_preprocess/get_match_info.py:340-344`)."""
    train = [c for idx, c in enumerate(filenames) if idx % 8 != 0]
    idx_train = [round(i) for i in np.linspace(0, len(train) - 1, n_sparse)]
    return [c for idx, c in enumerate(train) if idx in idx_train]


def magsac_filter(kpts0: np.ndarray, kpts1: np.ndarray):
    """`get_match_info.py:389-393`."""
    import cv2

    if len(kpts0) < 8:
        return np.ones(len(kpts0), bool)
    _, mask = cv2.findFundamentalMat(
        kpts0,
        kpts1,
        cv2.USAC_MAGSAC,
        ransacReprojThreshold=1.0,
        confidence=0.999999,
        maxIters=10000,
    )
    if mask is None:
        return np.ones(len(kpts0), bool)
    return mask.ravel() > 0


def match_pair_sift(img0: np.ndarray, img1: np.ndarray, num_matches: int):
    """Classical SIFT + FLANN + ratio test; returns pixel coords per image."""
    import cv2

    sift = cv2.SIFT_create(nfeatures=4 * num_matches)
    g0 = cv2.cvtColor(img0, cv2.COLOR_RGB2GRAY)
    g1 = cv2.cvtColor(img1, cv2.COLOR_RGB2GRAY)
    kp0, des0 = sift.detectAndCompute(g0, None)
    kp1, des1 = sift.detectAndCompute(g1, None)
    if des0 is None or des1 is None or len(kp0) < 8 or len(kp1) < 8:
        return np.zeros((0, 2)), np.zeros((0, 2))
    flann = cv2.FlannBasedMatcher({"algorithm": 1, "trees": 5}, {"checks": 50})
    knn = flann.knnMatch(des0, des1, k=2)
    good = [m for m, n in knn if m.distance < 0.8 * n.distance]
    good = sorted(good, key=lambda m: m.distance)[:num_matches]
    pts0 = np.array([kp0[m.queryIdx].pt for m in good], np.float32)
    pts1 = np.array([kp1[m.trainIdx].pt for m in good], np.float32)
    return pts0, pts1


def match_pair_dkm(model, img0, img1, num_matches):
    """DKMv3 dense match + sample (`get_match_info.py:373-386`)."""
    import torch

    device = next(model.parameters()).device
    t0 = torch.from_numpy(img0).permute(2, 0, 1)[None].float().to(device) / 255.0
    t1 = torch.from_numpy(img1).permute(2, 0, 1)[None].float().to(device) / 255.0
    dense_matches, dense_certainty = model.match(t0, t1)
    sparse_matches, _ = model.sample(dense_matches, dense_certainty, num_matches)
    sm = sparse_matches.cpu().numpy()
    h0, w0 = img0.shape[:2]
    h1, w1 = img1.shape[:2]
    pts0 = np.stack([w0 * (sm[:, 0] + 1) / 2, h0 * (sm[:, 1] + 1) / 2], -1)
    pts1 = np.stack([w1 * (sm[:, 2] + 1) / 2, h1 * (sm[:, 3] + 1) / 2], -1)
    return pts0, pts1


def make_matching_figure(
    img0: np.ndarray,
    img1: np.ndarray,
    pts0: np.ndarray,
    pts1: np.ndarray,
    inliers: np.ndarray,
    line_alpha: float = 0.4,
) -> np.ndarray:
    """Match-pair visualization (RGB uint8), equivalent to the reference's
    `fast_make_matching_figure`/`_overlay` blend
    (`data_preprocess/get_match_info.py:65-141,413-417`): a two-row canvas —
    row 1 the plain side-by-side pair, row 2 the pair with green dots on
    inlier keypoints and their connecting lines blended in at `line_alpha`."""
    import cv2

    margin = 2
    h0, w0 = img0.shape[:2]
    h1, w1 = img1.shape[:2]
    h = max(h0, h1)
    H, W = margin * 3 + 2 * h, margin * 3 + w0 + w1
    canvas = np.full((H, W, 3), 255, np.uint8)
    x0, x1 = margin, margin * 2 + w0  # column offsets of the two images
    for row in range(2):
        y = margin * (row + 1) + h * row
        canvas[y : y + h0, x0 : x0 + w0] = img0
        canvas[y : y + h1, x1 : x1 + w1] = img1
    y2 = margin * 2 + h  # second row
    pts = np.round(pts0).astype(int), np.round(pts1).astype(int)
    dots = canvas.copy()
    lines = canvas.copy()
    green = (0, 255, 0)
    for (px0, py0), (px1, py1) in zip(pts[0][inliers], pts[1][inliers]):
        a = (x0 + px0, y2 + py0)
        b = (x1 + px1, y2 + py1)
        cv2.circle(dots, a, 3, green, -1, lineType=cv2.LINE_AA)
        cv2.circle(dots, b, 3, green, -1, lineType=cv2.LINE_AA)
        cv2.line(lines, a, b, color=green, thickness=1, lineType=cv2.LINE_AA)
        cv2.circle(lines, a, 3, green, -1, lineType=cv2.LINE_AA)
        cv2.circle(lines, b, 3, green, -1, lineType=cv2.LINE_AA)
    return cv2.addWeighted(dots, 1 - line_alpha, lines, line_alpha, 0)


def extract_matches(
    images_dir: str,
    out_path: str,
    matcher: str = "sift",
    num_matches: int = 2000,
    n_sparse: int = 3,
    filenames=None,
    dkm_checkpoint: str | None = None,
    vis_dir: str | None = None,
) -> dict:
    import cv2

    all_files = sorted(
        f for f in os.listdir(images_dir) if f.lower().endswith((".jpg", ".png", ".jpeg"))
    )
    filenames = filenames or llff_train_split(all_files, n_sparse)

    model = None
    if matcher == "dkm":
        from dkm.models.model_zoo.DKMv3 import DKMv3  # external, like the reference
        import torch

        model = DKMv3(weights=None, h=672, w=896)
        state_dict = torch.load(dkm_checkpoint, map_location="cpu")
        if "state_dict" in state_dict:
            state_dict = state_dict["state_dict"]
        for k in list(state_dict.keys()):
            if k.startswith("model."):
                state_dict[k.replace("model.", "", 1)] = state_dict.pop(k)
            if "encoder.net.fc" in k:
                state_dict.pop(k)
        model.load_state_dict(state_dict)
        model = model.eval()

    match_data: dict = {}
    for i in range(len(filenames) - 1):
        name0 = os.path.basename(filenames[i]).split(".")[0]
        match_data.setdefault(name0, {})
        img0 = cv2.cvtColor(
            cv2.imread(os.path.join(images_dir, filenames[i])), cv2.COLOR_BGR2RGB
        )
        for j in range(i + 1, len(filenames)):
            name1 = os.path.basename(filenames[j]).split(".")[0]
            match_data.setdefault(name1, {})
            img1 = cv2.cvtColor(
                cv2.imread(os.path.join(images_dir, filenames[j])), cv2.COLOR_BGR2RGB
            )
            if matcher == "dkm":
                pts0, pts1 = match_pair_dkm(model, img0, img1, num_matches)
            else:
                pts0, pts1 = match_pair_sift(img0, img1, num_matches)
            mask = magsac_filter(pts0, pts1)
            h0, w0 = img0.shape[:2]
            h1, w1 = img1.shape[:2]
            match_data[name0][name1] = (pts0[mask] / [w0, h0]).astype(np.float32)
            match_data[name1][name0] = (pts1[mask] / [w1, h1]).astype(np.float32)
            if vis_dir is not None:
                os.makedirs(vis_dir, exist_ok=True)
                fig = make_matching_figure(img0, img1, pts0, pts1, mask)
                cv2.imwrite(
                    os.path.join(vis_dir, f"{name0}_{name1}_match.png"),
                    fig[..., ::-1],  # RGB -> BGR for imwrite
                )
            print(f"{name0}<->{name1}: {mask.sum()} matches")

    np.save(out_path, match_data, allow_pickle=True)
    return match_data


def main(argv=None):
    parser = ArgumentParser(description="Match-prior extraction")
    parser.add_argument("--images_dir", "-i", required=True)
    parser.add_argument("--out", "-o", default=None, help="default: <scene>/match_data.npy")
    parser.add_argument("--matcher", choices=["sift", "dkm"], default="sift")
    parser.add_argument("--num_matches", type=int, default=2000)
    parser.add_argument("--n_sparse", type=int, default=3)
    parser.add_argument("--dkm_checkpoint", default="weights/gim_dkm_100h.ckpt")
    parser.add_argument("--no_vis", action="store_true",
                        help="skip the per-pair match figures (the reference "
                             "writes {name0}_{name1}_match.png next to the "
                             "images, get_match_info.py:413-417)")
    args = parser.parse_args(argv)
    out = args.out or os.path.join(os.path.dirname(args.images_dir.rstrip("/")), "match_data.npy")
    extract_matches(
        args.images_dir, out, args.matcher, args.num_matches, args.n_sparse,
        dkm_checkpoint=args.dkm_checkpoint,
        vis_dir=None if args.no_vis else args.images_dir,
    )


if __name__ == "__main__":
    main()
