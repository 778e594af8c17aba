"""Map statistics (model-analyzer parity).

Port of ``sfd2_tpu/sfm/stats.py`` (``colmap model_analyzer`` as consumed
by ``hloc/triangulation.py:149-166`` → statics.txt): registered images,
cameras, 3D points, observations, mean track length, mean observations
per image, mean reprojection error.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def analyze_model(cameras: Dict, images: Dict, points3d: Dict) -> Dict[str, float]:
    n_obs = sum(len(p.image_ids) for p in points3d.values())
    n_pts = len(points3d)
    n_img = len(images)
    errors = np.array([p.error for p in points3d.values()]) if n_pts else np.zeros(0)
    return {
        "num_cameras": len(cameras),
        "num_images": n_img,
        "num_reg_images": n_img,
        "num_points3D": n_pts,
        "num_observations": n_obs,
        "mean_track_length": (n_obs / n_pts) if n_pts else 0.0,
        "mean_observations_per_image": (n_obs / n_img) if n_img else 0.0,
        "mean_reprojection_error": float(errors.mean()) if n_pts else 0.0,
    }


def format_stats(stats: Dict[str, float]) -> str:
    return "\n".join([
        f"Cameras: {stats['num_cameras']}",
        f"Images: {stats['num_images']}",
        f"Registered images: {stats['num_reg_images']}",
        f"Points: {stats['num_points3D']}",
        f"Observations: {stats['num_observations']}",
        f"Mean track length: {stats['mean_track_length']:.6f}",
        f"Mean observations per image: {stats['mean_observations_per_image']:.6f}",
        f"Mean reprojection error: {stats['mean_reprojection_error']:.6f}px",
    ])
