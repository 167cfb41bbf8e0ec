"""Stereo rectification and mono undistortion processor (port of
lpslam_tpu/pipeline/rectify.py).

The remap grids are built once, in numpy, from the camera registry:
``geometry/camera.py::undistort_map_radtan`` for one camera,
``rectify_maps_stereo`` for a radtan pair (where the JAX package calls
``cv2.initUndistortRectifyMap`` and ``cv2.stereoRectify``). They stay on
the processor's device; each frame is uploaded, remapped there by
``kernels/remap.py::remap_bilinear`` and handed back as numpy. An RGB-D depth map
goes through the mono grid, so it stays registered with the image. Fisheye
and omni cameras are refused (ROADMAP Queue 1 item 23).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry.camera import rectify_maps_stereo, undistort_map_radtan
from ..kernels.remap import remap_bilinear
from .config import CameraConfig, ConfigOptions
from .processors import ProcessorBase
from .queues import CameraQueueEntry


def _K(cam: CameraConfig) -> np.ndarray:
    return np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])


class RectifyProcessor(ProcessorBase):
    """Rectifies stereo pairs (or undistorts mono frames) on `device`."""

    schema = ConfigOptions().optional("camera_number", int, 0)

    def __init__(self, config: Optional[dict] = None, camera: Optional[CameraConfig] = None,
                 camera_right: Optional[CameraConfig] = None, *, device="cuda"):
        super().__init__(config)
        self.device = torch.device(device)
        self._maps = None
        self.K_new = None
        self.focal_x_baseline = 0.0
        if camera is not None:
            self.configure(camera, camera_right)

    def configure(self, cam: CameraConfig, cam_right: Optional[CameraConfig] = None):
        if cam.model in ("fisheye", "omni"):
            raise NotImplementedError(
                f"{cam.model} rectification is not ported to lpslam_tpu_torch yet "
                "(ROADMAP Queue 1 item 23)")
        if cam.distortion.size == 8:
            raise NotImplementedError(
                "the rational (8-coefficient) distortion model is not ported to "
                "lpslam_tpu_torch yet (ROADMAP Queue 1 item 23)")
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        if cam_right is None or cam.rotation is None:
            # mono undistortion: identity rotation, the same K
            K = _K(cam)
            grid = undistort_map_radtan(K, cam.distortion, (cam.height, cam.width))
            self._maps = (to_dev(grid), None)
            self.K_new = K.astype(np.float32)
            return
        res = rectify_maps_stereo(
            _K(cam), cam.distortion.astype(np.float64),
            _K(cam_right), cam_right.distortion.astype(np.float64),
            cam.rotation, cam.translation, (cam.height, cam.width),
        )
        self._maps = (to_dev(res["map_l"]), to_dev(res["map_r"]))
        self.K_new = res["K_new"]
        self.focal_x_baseline = res["focal_x_baseline"]

    def _upload(self, img) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img, np.float32), device=self.device)

    def process_image(self, entry: CameraQueueEntry) -> CameraQueueEntry:
        if self._maps is None:
            return entry
        map_l, map_r = self._maps
        if map_r is not None and entry.image_second is not None:
            left = remap_bilinear(self._upload(entry.image), map_l)
            right = remap_bilinear(self._upload(entry.image_second), map_r)
            entry.image = left.cpu().numpy()
            entry.image_second = right.cpu().numpy()
        else:
            entry.image = remap_bilinear(self._upload(entry.image), map_l).cpu().numpy()
        if entry.aux is not None and np.ndim(entry.aux) == 2:
            entry.aux = remap_bilinear(self._upload(entry.aux), map_l).cpu().numpy()
        return entry
