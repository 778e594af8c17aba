"""Visualization utilities (matplotlib and OpenCV, on the host).

Port of ``sfd2_tpu/utils/viz.py``: ``hloc/utils/viz.py`` (plot_images /
plot_keypoints / plot_matches), ``hloc/visualization.py``
(visualize_sfm_2d keypoint coverage), ``it_loc/common.py`` (cv2
side-by-side match drawing with inlier colouring, reprojection overlay)
and ``tools/viz.py`` (the optical-flow colour wheel). numpy only, with
matplotlib and cv2 imported by the functions that draw.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# matplotlib figures (hloc-style)
# ---------------------------------------------------------------------------


def plot_images(imgs: Sequence[np.ndarray], titles=None, dpi=100):
    import matplotlib.pyplot as plt

    n = len(imgs)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), dpi=dpi)
    if n == 1:
        axes = [axes]
    for ax, im in zip(axes, imgs):
        ax.imshow(im, cmap="gray" if im.ndim == 2 else None)
        ax.axis("off")
    if titles:
        for ax, t in zip(axes, titles):
            ax.set_title(t)
    fig.tight_layout()
    return fig, axes


def plot_keypoints(ax, kpts: np.ndarray, color="lime", ps=4):
    ax.scatter(kpts[:, 0], kpts[:, 1], c=color, s=ps, linewidths=0)


def plot_matches_mpl(fig, ax1, ax2, kpts1, kpts2, color="lime", lw=0.5):
    """Lines across two axes (hloc plot_matches)."""
    import matplotlib

    fig.canvas.draw()
    t1 = ax1.transData
    t2 = ax2.transData
    tf = fig.transFigure.inverted()
    for (x1, y1), (x2, y2) in zip(kpts1, kpts2):
        f1 = tf.transform(t1.transform((x1, y1)))
        f2 = tf.transform(t2.transform((x2, y2)))
        fig.lines.append(
            matplotlib.lines.Line2D(
                (f1[0], f2[0]), (f1[1], f2[1]),
                transform=fig.transFigure, color=color, linewidth=lw,
            )
        )


# ---------------------------------------------------------------------------
# cv2 image compositing (it_loc-style)
# ---------------------------------------------------------------------------


def draw_matches_cv2(
    img1: np.ndarray,
    img2: np.ndarray,
    pts1: np.ndarray,
    pts2: np.ndarray,
    inliers: Optional[np.ndarray] = None,
    plot_outliers: bool = False,
    radius: int = 3,
):
    """Vertical side-by-side match plot, green inliers / red outliers
    (``it_loc/common.py`` plot_matches semantics)."""
    import cv2

    h1, w1 = img1.shape[:2]
    h2, w2 = img2.shape[:2]
    w = max(w1, w2)
    canvas = np.zeros((h1 + h2, w, 3), np.uint8)
    canvas[:h1, :w1] = img1 if img1.ndim == 3 else img1[..., None]
    canvas[h1 : h1 + h2, :w2] = img2 if img2.ndim == 3 else img2[..., None]
    if inliers is None:
        inliers = np.ones(len(pts1), bool)
    for (x1, y1), (x2, y2), ok in zip(pts1, pts2, inliers):
        if not ok and not plot_outliers:
            continue
        color = (0, 255, 0) if ok else (0, 0, 255)
        p1 = (int(x1), int(y1))
        p2 = (int(x2), int(y2) + h1)
        cv2.circle(canvas, p1, radius, color, 2)
        cv2.circle(canvas, p2, radius, color, 2)
        cv2.line(canvas, p1, p2, color, 1)
    return canvas


def draw_reprojections(
    img: np.ndarray, points2d: np.ndarray, reproj2d: np.ndarray, radius: int = 3
):
    """Observed (green) vs reprojected (red) keypoints
    (``plot_reprojpoint2D``)."""
    import cv2

    canvas = np.ascontiguousarray(img if img.ndim == 3 else img[..., None].repeat(3, -1))
    for (x, y), (u, v) in zip(points2d, reproj2d):
        cv2.circle(canvas, (int(x), int(y)), radius, (0, 255, 0), 1)
        cv2.circle(canvas, (int(u), int(v)), radius, (0, 0, 255), 1)
        cv2.line(canvas, (int(x), int(y)), (int(u), int(v)), (255, 0, 0), 1)
    return canvas


# ---------------------------------------------------------------------------
# optical-flow colorwheel (tools/viz.py parity)
# ---------------------------------------------------------------------------


def _make_colorwheel() -> np.ndarray:
    """Standard Middlebury flow colorwheel (55 colours)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:ry, 0] = 255
    wheel[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


def flow_to_color(flow: np.ndarray, max_flow: Optional[float] = None) -> np.ndarray:
    """[H, W, 2] flow (relative; NaN = invalid → black) → uint8 RGB."""
    u = flow[..., 0].copy()
    v = flow[..., 1].copy()
    bad = ~np.isfinite(u) | ~np.isfinite(v)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u * u + v * v)
    maxrad = max_flow or max(rad.max(), 1e-6)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u * u + v * v)
    wheel = _make_colorwheel()
    ncols = len(wheel)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255
        col1 = wheel[k1, c] / 255
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)
        img[..., c] = np.floor(255 * col)
    img[bad] = 0
    return img


def visualize_sfm_2d(image: np.ndarray, map_index, image_id: int, color_by="visibility"):
    """Keypoints of a registered image coloured by track visibility
    (``hloc/visualization.py`` semantics). Returns (fig, ax)."""
    import matplotlib.pyplot as plt

    row = map_index.image_row[image_id]
    prow = map_index.p3d_rows_per_image[row]
    im = map_index.images[image_id]
    has3d = prow >= 0
    fig, axes = plot_images([image])
    ax = axes[0]
    if color_by == "visibility":
        vis = np.where(has3d, map_index.track_len[np.maximum(prow, 0)], 0)
        sc = ax.scatter(
            im.xys[:, 0], im.xys[:, 1], c=vis, cmap="jet", s=6, linewidths=0
        )
        fig.colorbar(sc, ax=ax)
    else:
        ax.scatter(im.xys[has3d, 0], im.xys[has3d, 1], c="lime", s=6)
        ax.scatter(im.xys[~has3d, 0], im.xys[~has3d, 1], c="red", s=6)
    return fig, ax
