"""NVM (VisualSfM) → COLMAP model conversion (host, numpy).

Port of ``sfd2_tpu/io/nvm.py`` (``hloc/colmap_from_nvm.py``): parse an
NVM_V3 model (camera lines ``name focal qw qx qy qz cx cy cz dist 0``,
translations as camera centres; point lines with their measurements),
pair it with an intrinsics list and image/camera ids (from a COLMAP
database or given directly), and return the model dicts. It builds the
RobotCar sfm-sift reference model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from sfd2_torch.geometry.cameras import CAMERA_MODEL_NAMES, Camera
from sfd2_torch.geometry.np_pose import qvec_to_rotmat
from sfd2_torch.io.colmap_model import Image, Point3D


def read_intrinsics_list(path) -> Dict[str, Camera]:
    """'name MODEL w h params…' per line → name → Camera (ids in file
    order from 1)."""
    cams = {}
    for i, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line:
            continue
        parts = line.split(" ")
        name, model, width, height = parts[:4]
        _, num_params = CAMERA_MODEL_NAMES[model]
        params = np.array(parts[4:], np.float64)
        if len(params) != num_params:
            raise ValueError(f"{name}: {model} takes {num_params} parameters, got {len(params)}")
        cams[name] = Camera(i + 1, model, int(width), int(height), params)
    return cams


def read_nvm_model(nvm_path, intrinsics_path, image_ids: Optional[Dict[str, int]] = None,
                   camera_ids: Optional[Dict[str, int]] = None, skip_points: bool = False):
    """Returns (cameras, images, points3d) dicts."""
    name_to_cam = read_intrinsics_list(intrinsics_path)
    lines = iter(Path(nvm_path).read_text().splitlines())

    def next_content():
        for line in lines:
            if line.strip() and not line.startswith("NVM_V3"):
                return line.strip()
        raise EOFError("truncated NVM file")

    num_images = int(next_content())
    image_data = [next_content().split(" ") for _ in range(num_images)]
    names = [d[0] for d in image_data]
    if image_ids is None:
        image_ids = {n: i + 1 for i, n in enumerate(sorted(names))}
    if camera_ids is None:
        camera_ids = {n: name_to_cam[n].camera_id for n in names}

    cameras = {}
    for n in names:
        cam = name_to_cam[n]
        cameras[camera_ids[n]] = Camera(camera_ids[n], cam.model, cam.width, cam.height,
                                        cam.params)

    num_points = 0 if skip_points else int(next_content())
    points3d: Dict[int, Point3D] = {}
    per_image_kp: Dict[int, list] = {}
    for pi in range(num_points):
        data = next_content().split(" ")
        xyz = np.array(data[:3], np.float64)
        rgb = np.array(data[3:6], np.float64).astype(np.uint8)
        obs_img, obs_kp = [], []
        for j in range(int(data[6])):
            s = 7 + 4 * j
            img_idx, kp_idx = int(data[s]), int(data[s + 1])
            per_image_kp.setdefault(img_idx, []).append(
                (kp_idx, float(data[s + 2]), float(data[s + 3]), pi))
            obs_img.append(image_ids[image_data[img_idx][0]])
            obs_kp.append(kp_idx)
        points3d[pi] = Point3D(pi, xyz, rgb, 1.0, np.array(obs_img, np.int32),
                               np.array(obs_kp, np.int32))

    images: Dict[int, Image] = {}
    for i, data in enumerate(image_data):
        name = data[0]
        qvec = np.array(data[2:6], np.float64)
        center = np.array(data[6:9], np.float64)
        tvec = -qvec_to_rotmat(qvec) @ center  # NVM stores camera centres
        if i in per_image_kp:
            kps = per_image_kp[i]
            kp_idx = np.array([k[0] for k in kps])
            n2d = int(kp_idx.max()) + 1
            xys = np.zeros((n2d, 2), np.float64)
            p3d = np.full(n2d, -1, np.int64)
            xys[kp_idx] = [[k[1], k[2]] for k in kps]
            p3d[kp_idx] = [k[3] for k in kps]
        else:
            xys = np.zeros((0, 2), np.float64)
            p3d = np.zeros(0, np.int64)
        images[image_ids[name]] = Image(image_ids[name], qvec, tvec, camera_ids[name], name,
                                        xys, p3d)
    return cameras, images, points3d
