"""Fisheye rectification for UMI GoPro-style cameras (the port's own copy
of ``real/fisheye.py``: the intrinsics parse in numpy; the rectify map and
the remap import OpenCV inside the converter).

Capability parity with the reference's cv_util fisheye helpers
(umi/common/cv_util.py: parse_fisheye_intrinsics + FisheyeRectConverter),
rebuilt on the public OpenCV fisheye (Kannala-Brandt) camera model: parse a
GoPro calibration json into (K, D), precompute an undistort-rectify map to a
pinhole camera of the requested output size/FoV once, and remap each frame.
Used as the CameraProcess ``transform`` hook so rectification runs in the
capture process, off the control loop (real/camera.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def parse_fisheye_intrinsics(json_data: Dict) -> Dict[str, np.ndarray]:
    """GoPro/UMI calibration json → {K (3,3), D (4,), resolution (w, h)}.

    Expects the OpenCV-fisheye (Kannala-Brandt) convention the UMI pipeline
    ships: ``intrinsic_type: FISHEYE_KANNALA_BRANDT`` with parameters
    fx/fy/cx/cy and k1..k4.
    """
    itype = json_data.get("intrinsic_type", "FISHEYE_KANNALA_BRANDT")
    if "KANNALA" not in itype.upper() and "FISHEYE" not in itype.upper():
        raise ValueError(f"not a fisheye calibration: {itype}")
    p = json_data["intrinsics"] if "intrinsics" in json_data else json_data
    fx = float(p.get("fx", p.get("focal_length_x", 0.0)))
    fy = float(p.get("fy", p.get("focal_length_y", fx)))
    cx = float(p.get("cx", p.get("principal_pt_x", 0.0)))
    cy = float(p.get("cy", p.get("principal_pt_y", 0.0)))
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float64)
    D = np.array(
        [float(p.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4")], np.float64
    )
    w = int(json_data.get("image_width", p.get("image_width", 0)))
    h = int(json_data.get("image_height", p.get("image_height", 0)))
    return {"K": K, "D": D, "resolution": np.array([w, h], np.int64)}


class FisheyeRectConverter:
    """Precomputed fisheye → pinhole rectification (one remap per frame)."""

    def __init__(
        self,
        K: np.ndarray,
        D: np.ndarray,
        in_size: Tuple[int, int],
        out_size: Tuple[int, int] = (224, 224),
        out_fov: float = 90.0,
        cal_size: Optional[Tuple[int, int]] = None,
    ):
        """``in_size`` = (w, h) of the frames actually fed to ``forward``;
        ``cal_size`` = the resolution K was calibrated at (e.g. the GoPro's
        2704×2028 against a 640×480 capture stream). When they differ, the
        intrinsics are rescaled to the stream's pixel space — fisheye
        distortion coefficients are resolution-invariant, K is not."""
        import cv2

        K = np.array(K, np.float64)
        in_w, in_h = in_size
        if cal_size is not None and tuple(cal_size) != (in_w, in_h):
            cal_w, cal_h = cal_size
            K = K.copy()
            K[0, :] *= in_w / cal_w   # fx, skew, cx
            K[1, :] *= in_h / cal_h   # fy, cy

        out_w, out_h = out_size
        # pinhole intrinsics for the requested output field of view
        f = (out_w / 2.0) / np.tan(np.deg2rad(out_fov) / 2.0)
        P = np.array(
            [
                [f, 0.0, out_w / 2.0 - 0.5],
                [0.0, f, out_h / 2.0 - 0.5],
                [0.0, 0.0, 1.0],
            ],
            np.float64,
        )
        self.map1, self.map2 = cv2.fisheye.initUndistortRectifyMap(
            K,
            np.asarray(D, np.float64).reshape(4, 1),
            np.eye(3),
            P,
            (out_w, out_h),
            cv2.CV_16SC2,
        )
        self.out_size = (out_w, out_h)

    def forward(self, img: np.ndarray) -> np.ndarray:
        import cv2

        return cv2.remap(
            img, self.map1, self.map2, interpolation=cv2.INTER_LINEAR
        )

    __call__ = forward
