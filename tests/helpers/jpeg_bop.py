"""JPEG data for the port's loader tests, made from the `synthetic_bop` PNG
fixture with OpenCV's encoder (libjpeg-turbo, as BOP's pbr frames and VOC
are written by libjpeg):

- `write_pbr_split`: a copy of a split with every `rgb/*.png` frame
  re-encoded as `rgb/*.jpg` (BOP's pbr layout: `scene_gt_info.json`,
  `mask_visib/`, PNG depth);
- `write_voc`: a VOC2012-style `JPEGImages` directory of seeded images at
  VOC's sizes (500x375 and 375x500), one of them gray and one written with
  a restart interval.
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def write_pbr_split(ds_root: str, src_split: str, dst_split: str = "train_pbr",
                    quality: int = 95) -> str:
    import cv2

    src, dst = os.path.join(ds_root, src_split), os.path.join(ds_root, dst_split)
    shutil.copytree(src, dst)
    for scene in sorted(os.listdir(dst)):
        rgb = os.path.join(dst, scene, "rgb")
        for f in sorted(os.listdir(rgb)):
            png = os.path.join(rgb, f)
            img = cv2.imread(png)
            cv2.imwrite(png[:-4] + ".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
            os.remove(png)
    return dst


def voc_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A bright textured BGR image (smooth colour fields plus noise)."""
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    c = rng.uniform(0, 6, 3)
    base = np.stack([np.sin(5 * xx + c[i]) * np.cos(3 * yy - c[i]) for i in range(3)], -1)
    return np.clip(150 + 90 * base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def write_voc(bop_root: str, n: int = 8, seed: int = 0) -> str:
    """`<bop_root>/VOCdevkit/VOC2012/JPEGImages` with n images; returns it."""
    import cv2

    d = os.path.join(bop_root, "VOCdevkit", "VOC2012", "JPEGImages")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (375, 500) if i % 2 == 0 else (500, 375)
        img = voc_image(rng, h, w)
        params = [cv2.IMWRITE_JPEG_QUALITY, 90]
        if i == 1:
            img = img[..., 1]
        if i == 2:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 4]
        cv2.imwrite(os.path.join(d, f"2008_{i:06d}.jpg"), img, params)
    return d
