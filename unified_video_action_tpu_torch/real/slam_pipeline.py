"""UMI SLAM-pipeline utilities (the port's copy of ``real/slam_pipeline.py``):
ArUco localization, camera masks, trajectory and mocap loaders, timecode
math and latency estimation, for the data pipeline's checks of recorded
demonstrations (the reference's umi/common/cv_util.py:123-461,
orb_slam_util.py, mocap_util.py, timecode_util.py, latency_util.py).

The masks, crops and ``image_transform`` run on numpy alone: polygons
filled with the pixels ``cv2.fillPoly`` draws (``envs/raster.fill_poly``)
and ``INTER_AREA`` resizing by OpenCV's area weights
(``data/augmentation.cv2_resize``). OpenCV is imported inside the ArUco
functions and the anti-aliased mask, pandas inside the CSV loaders and PyAV
inside ``mp4_start_datetime``; each raises ImportError naming the package
where it is absent (the card's machine has none of the three).

The canonical-coordinate polygons (mirror, gripper and finger regions) are
calibration data of the UMI GoPro rig and keep the reference's values.
"""

from __future__ import annotations

import datetime
from fractions import Fraction
from typing import Dict, Optional, Tuple, Union

import numpy as np

from unified_video_action_tpu_torch.data.augmentation import cv2_resize
from unified_video_action_tpu_torch.envs.raster import fill_poly


def _missing(what: str, package: str) -> ImportError:
    return ImportError(f"{what} needs {package}, which is not installed")


# ---------------------------------------------------------------------------
# ArUco detection + localization (reference cv_util.py:123-250)
# ---------------------------------------------------------------------------


def parse_aruco_config(cfg: dict) -> dict:
    """{"aruco_dict": {"predefined": "DICT_4X4_50"},
        "marker_size_map": {"default": 0.15, 12: 0.2}} ->
    {"aruco_dict": cv2.aruco.Dictionary, "marker_size_map": {id: meters}}"""
    adict = get_aruco_dict(**cfg["aruco_dict"])
    sizes = cfg["marker_size_map"]
    default = sizes.get("default")
    n = len(adict.bytesList)
    size_map = {i: sizes.get(i, default) for i in range(n)}
    return {"aruco_dict": adict, "marker_size_map": size_map}


def get_aruco_dict(predefined: str):
    try:
        import cv2
    except ImportError as e:
        raise _missing("get_aruco_dict", "OpenCV (cv2)") from e
    return cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, predefined))


def detect_aruco_tags(
    img: np.ndarray,
    aruco_dict,
    marker_size_map: Dict[int, float],
    fisheye_intr: Optional[Dict[str, np.ndarray]] = None,
    pinhole_intr: Optional[Dict[str, np.ndarray]] = None,
    refine_subpix: bool = True,
) -> Dict[int, Dict[str, np.ndarray]]:
    """Detect markers and localize each in the camera frame.

    Exactly one camera model is required: ``fisheye_intr`` ({"K", "D"})
    undistorts corners through the Kannala-Brandt model first (the UMI GoPro
    path); ``pinhole_intr`` ({"K", optional "D"}) solves directly on the
    pinhole model. Returns {id: {"rvec", "tvec", "corners"}}."""
    if (fisheye_intr is None) == (pinhole_intr is None):
        raise ValueError(
            "pass exactly one of fisheye_intr / pinhole_intr — localization "
            "is meaningless without camera intrinsics"
        )
    try:
        import cv2
    except ImportError as e:
        raise _missing("detect_aruco_tags", "OpenCV (cv2)") from e
    params = cv2.aruco.DetectorParameters()
    if refine_subpix:
        params.cornerRefinementMethod = cv2.aruco.CORNER_REFINE_SUBPIX
    detector = cv2.aruco.ArucoDetector(aruco_dict, params)
    corners, ids, _ = detector.detectMarkers(img)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    if ids is None:
        return out
    for tag_id, tag_corners in zip(np.asarray(ids).ravel(), corners):
        tag_id = int(tag_id)
        size = marker_size_map.get(tag_id)
        if size is None:
            continue
        if fisheye_intr is not None:
            K, D = fisheye_intr["K"], fisheye_intr["D"]
            pts = cv2.fisheye.undistortPoints(tag_corners, K, D, P=K)
            dist = np.zeros(5)
        else:
            K = pinhole_intr["K"]
            dist = np.asarray(pinhole_intr.get("D", np.zeros(5)))
            pts = tag_corners
        # solvePnP on the marker's canonical square (z=0 plane, CCW from
        # top-left) — the modern replacement for the deprecated
        # estimatePoseSingleMarkers
        half = size / 2.0
        obj = np.array(
            [[-half, half, 0], [half, half, 0],
             [half, -half, 0], [-half, -half, 0]],
            np.float32,
        )
        ok, rvec, tvec = cv2.solvePnP(
            obj, pts.reshape(4, 1, 2).astype(np.float32), K,
            dist, flags=cv2.SOLVEPNP_IPPE_SQUARE,
        )
        if not ok:
            continue
        out[tag_id] = {
            "rvec": rvec.squeeze(),
            "tvec": tvec.squeeze(),
            "corners": np.asarray(tag_corners).squeeze(),
        }
    return out


def gripper_width_from_tags(
    tag_dict: Dict[int, Dict[str, np.ndarray]],
    left_id: int,
    right_id: int,
    nominal_z: float = 0.072,
    z_tolerance: float = 0.008,
) -> Optional[float]:
    """Finger-tag x-separation -> gripper width; tags outside the nominal
    depth band are outliers; a single visible finger assumes symmetry
    (reference cv_util.py:224-249)."""
    def x_of(tag_id):
        if tag_id not in tag_dict:
            return None
        tvec = tag_dict[tag_id]["tvec"]
        if not (nominal_z - z_tolerance < tvec[-1] < nominal_z + z_tolerance):
            return None
        return float(tvec[0])

    lx, rx = x_of(left_id), x_of(right_id)
    if lx is not None and rx is not None:
        return rx - lx
    if lx is not None:
        return abs(lx) * 2
    if rx is not None:
        return abs(rx) * 2
    return None


def inpaint_tag(
    img: np.ndarray, corners: np.ndarray, tag_scale: float = 1.4,
    n_samples: int = 16,
) -> np.ndarray:
    """Paint over a detected tag with the median color sampled just outside
    its (scaled) boundary, so masked training frames carry no tag pixels
    (reference cv_util.py:413-434), in place, with ``cv2.fillPoly``'s
    pixels."""
    corners = np.asarray(corners, np.float64).reshape(4, 2)
    center = corners.mean(axis=0)
    scaled = tag_scale * (corners - center) + center
    ring = np.concatenate([scaled, scaled[:1]], axis=0)
    # uniform samples along the closed boundary polyline
    t = np.linspace(0, 4, n_samples, endpoint=False)
    seg = np.minimum(t.astype(int), 3)
    frac = (t - seg)[:, None]
    pts = (ring[seg] * (1 - frac) + ring[seg + 1] * frac).astype(np.int32)
    ys = np.clip(pts[:, 1], 0, img.shape[0] - 1)
    xs = np.clip(pts[:, 0], 0, img.shape[1] - 1)
    median = np.median(img[ys, xs], axis=0).astype(img.dtype)
    fill_poly(img, scaled.astype(np.int32), median)
    return img


# ---------------------------------------------------------------------------
# Canonical-coordinate camera masks (reference cv_util.py:252-411)
# ---------------------------------------------------------------------------

# UMI GoPro rig calibration (native 2028x2704); canonical coords are
# (pixel - center) / height so masks survive resolution changes
_RIG_RES = (2028, 2704)

_MIRROR_PTS_LEFT = [
    [540, 1700], [680, 1450], [590, 1070],
    [290, 1130], [290, 1770], [550, 1770],
]

_GRIPPER_PTS_LEFT = [
    [1352, 1730], [1100, 1700], [650, 1500],
    [0, 1350], [0, 2028], [1352, 2704],
]


def canonical_to_pixel(coords, img_shape: Tuple[int, int]):
    h, w = img_shape[:2]
    return np.asarray(coords) * h + np.array([w, h]) * 0.5


def pixel_to_canonical(pts, img_shape: Tuple[int, int] = _RIG_RES):
    h, w = img_shape[:2]
    return (np.asarray(pts, np.float64) - np.array([w, h]) * 0.5) / h


def mirror_polygons() -> np.ndarray:
    left = pixel_to_canonical(_MIRROR_PTS_LEFT)
    right = left * np.array([-1.0, 1.0])
    return np.stack([left, right])


def gripper_polygons() -> np.ndarray:
    left = pixel_to_canonical(_GRIPPER_PTS_LEFT)
    right = left * np.array([-1.0, 1.0])
    return np.stack([left, right])


def finger_polygon(
    height: float = 0.37, top_width: float = 0.25, bottom_width: float = 1.4
) -> np.ndarray:
    """Trapezoid over the finger region, parameterized in height-relative
    units (reference cv_util.py:318-350)."""
    h, w = _RIG_RES
    mid = (w / h) / 2.0
    top_y, bot_y = 1.0 - height, 1.0
    pts = np.array([
        [mid - bottom_width / 2, bot_y],
        [mid - top_width / 2, top_y],
        [mid + top_width / 2, top_y],
        [mid + bottom_width / 2, bot_y],
    ]) * h
    return pixel_to_canonical(pts[None])


def draw_predefined_mask(
    img: np.ndarray,
    color=(0, 0, 0),
    mirror: bool = True,
    gripper: bool = True,
    finger: bool = True,
    use_aa: bool = False,
) -> np.ndarray:
    """Fill the rig's mirror/gripper/finger regions (training-data masking,
    reference cv_util.py:353-370), in place: ``cv2.fillPoly``'s pixels
    (LINE_8) on numpy; ``use_aa`` (anti-aliased edges) through OpenCV."""
    polys = []
    if mirror:
        polys.extend(mirror_polygons())
    if gripper:
        polys.extend(gripper_polygons())
    if finger:
        polys.extend(finger_polygon())
    if use_aa:
        try:
            import cv2
        except ImportError as e:
            raise _missing("draw_predefined_mask(use_aa=True)", "OpenCV (cv2)") from e
    for coords in polys:
        pts = np.round(canonical_to_pixel(coords, img.shape[:2])).astype(np.int32)
        if use_aa:
            cv2.fillPoly(img, [pts], color=color, lineType=cv2.LINE_AA)
        else:
            fill_poly(img, pts, np.asarray(color, img.dtype))
    return img


def mirror_crop_slices(
    img_shape: Tuple[int, int] = (1080, 1920), left: bool = True
) -> Tuple[slice, slice]:
    """Bounding-box slices of one mirror region at any resolution
    (reference cv_util.py:286-299)."""
    box = pixel_to_canonical([[290, 1120], [650, 1480]])
    if not left:
        box = box * np.array([-1.0, 1.0])
    pts = np.round(canonical_to_pixel(box, img_shape)).astype(np.int32)
    return (
        slice(pts[:, 1].min(), pts[:, 1].max()),
        slice(pts[:, 0].min(), pts[:, 0].max()),
    )


def image_transform(
    in_res: Tuple[int, int],
    out_res: Tuple[int, int],
    crop_ratio: float = 1.0,
    bgr_to_rgb: bool = False,
):
    """Center-crop (height-relative) + INTER_AREA resize closure for the
    recording pipeline (reference cv_util.py:436-461), on numpy: OpenCV's
    area weights in float, a uint8 image rounded back to uint8."""
    iw, ih = in_res
    ow, oh = out_res
    ch = round(ih * crop_ratio)
    cw = round(ih * crop_ratio / oh * ow)
    ws = (iw - cw) // 2
    hs = (ih - ch) // 2
    cs = slice(None, None, -1) if bgr_to_rgb else slice(None)

    def transform(img: np.ndarray) -> np.ndarray:
        if img.shape != (ih, iw, 3):
            raise ValueError(f"image_transform of {in_res}: got {img.shape}")
        img = img[hs: hs + ch, ws: ws + cw, cs]
        out = cv2_resize(img.astype(np.float32), (oh, ow), area=True)
        if img.dtype == np.uint8:
            return np.clip(np.rint(out), 0, 255).astype(np.uint8)
        return out.astype(img.dtype)

    return transform


# ---------------------------------------------------------------------------
# SLAM / mocap trajectory loaders (reference orb_slam_util.py, mocap_util.py)
# ---------------------------------------------------------------------------


def _poses_from_pos_quat(pos: np.ndarray, quat_xyzw: np.ndarray) -> np.ndarray:
    from unified_video_action_tpu_torch.utils.rotation import quaternion_to_matrix

    # quaternion_to_matrix expects wxyz
    wxyz = np.concatenate([quat_xyzw[:, 3:4], quat_xyzw[:, :3]], axis=1)
    pose = np.zeros((len(pos), 4, 4), np.float32)
    pose[:, 3, 3] = 1
    pose[:, :3, 3] = pos
    pose[:, :3, :3] = np.asarray(quaternion_to_matrix(wxyz))
    return pose


def load_tum_trajectory(path: str) -> Dict[str, np.ndarray]:
    """TUM format: rows of ``t x y z qx qy qz qw`` (ORB-SLAM output)."""
    raw = np.loadtxt(path, delimiter=" ", dtype=np.float32)
    if raw.size == 0:
        return {"timestamp": np.array([]), "pose": np.array([])}
    raw = raw.reshape(-1, 8)
    return {
        "timestamp": raw[:, 0],
        "pose": _poses_from_pos_quat(raw[:, 1:4], raw[:, 4:8]),
    }


def load_slam_csv_trajectory(path: str) -> Dict[str, np.ndarray]:
    """The pipeline's camera_trajectory.csv: columns timestamp, x..z,
    q_x..q_w, is_lost; lost frames are dropped (raw rows kept)."""
    try:
        import pandas as pd
    except ImportError as e:
        raise _missing("load_slam_csv_trajectory", "pandas") from e

    df = pd.read_csv(path)
    if (~df.is_lost).sum() == 0:
        return {"raw_data": df}
    ok = df.loc[~df.is_lost]
    pos = ok[["x", "y", "z"]].to_numpy()
    quat = ok[["q_x", "q_y", "q_z", "q_w"]].to_numpy()
    return {
        "timestamp": ok["timestamp"].to_numpy(),
        "pose": _poses_from_pos_quat(pos, quat),
        "raw_data": df,
    }


def mocap_start_datetime(csv_path: str) -> datetime.datetime:
    """OptiTrack csv header row carries 'Capture Start Time'."""
    with open(csv_path) as f:
        cells = f.readline().rstrip("\n").split(",")
    meta = dict(zip(cells[0::2], cells[1::2]))
    return datetime.datetime.strptime(
        meta["Capture Start Time"], r"%Y-%m-%d %I.%M.%S.%f %p"
    )


def load_mocap_data(csv_path: str, rigid_body_name: str) -> Dict[str, np.ndarray]:
    """OptiTrack export -> {time_since_start, pose (N,4,4)} for one body."""
    try:
        import pandas as pd
    except ImportError as e:
        raise _missing("load_mocap_data", "pandas") from e

    df = pd.read_csv(csv_path, skiprows=2, index_col=0, header=[1, 3, 4])
    time_since_start = df.iloc[:, 0].to_numpy()
    pos = np.stack(
        [df[(rigid_body_name, "Position", ax)].to_numpy() for ax in "XYZ"],
        axis=1,
    )
    quat = np.stack(
        [df[(rigid_body_name, "Rotation", ax)].to_numpy() for ax in ("X", "Y", "Z", "W")],
        axis=1,
    )
    return {
        "time_since_start": time_since_start,
        "pose": _poses_from_pos_quat(pos, quat),
    }


# ---------------------------------------------------------------------------
# Timecode (reference timecode_util.py)
# ---------------------------------------------------------------------------


def timecode_to_seconds(
    timecode: str, frame_rate: Union[int, float, Fraction]
) -> float:
    """Non-drop-frame 'HH:MM:SS:FF' -> seconds since midnight (29.97 material
    counts frames at 30 and stretches by the true rate)."""
    int_rate = round(float(frame_rate))
    h, m, s, f = (int(x) for x in timecode.split(":"))
    frames = (3600 * h + 60 * m + s) * int_rate + f
    return frames / float(frame_rate)


def mp4_start_datetime(mp4_path: str) -> datetime.datetime:
    """High-precision first-frame wall time: creation date (day) + timecode
    (time of day). Needs PyAV; raises ImportError naming it when absent."""
    try:
        import av
    except ImportError as e:
        raise _missing("mp4_start_datetime", "PyAV (av)") from e

    with av.open(mp4_path) as container:
        stream = container.streams.video[0]
        secs = timecode_to_seconds(
            stream.metadata["timecode"], stream.average_rate
        )
        day = datetime.datetime.strptime(
            stream.metadata["creation_time"], r"%Y-%m-%dT%H:%M:%S.%fZ"
        ).replace(hour=0, minute=0, second=0, microsecond=0)
        return day + datetime.timedelta(seconds=secs)


# ---------------------------------------------------------------------------
# Latency estimation (reference latency_util.py)
# ---------------------------------------------------------------------------


def measure_latency(
    x_target: np.ndarray,
    t_target: np.ndarray,
    x_actual: np.ndarray,
    t_actual: np.ndarray,
    resample_dt: float = 1e-3,
    force_positive: bool = False,
) -> Tuple[float, Dict[str, np.ndarray]]:
    """Cross-correlation lag between a commanded and a measured signal on a
    common uniform grid -> actuator latency in seconds."""
    import scipy.signal as ss
    from scipy.interpolate import interp1d

    t0 = max(t_target[0], t_actual[0])
    t1 = min(t_target[-1], t_actual[-1])
    t = np.arange(int((t1 - t0) / resample_dt)) * resample_dt + t0

    def resample(x, tx):
        return interp1d(tx, x, bounds_error=False, fill_value=(x[0], x[-1]))(t)

    a = resample(x_target, t_target)
    b = resample(x_actual, t_actual)
    both = np.concatenate([a, b])
    a = (a - both.mean()) / both.std()
    b = (b - both.mean()) / both.std()
    corr = ss.correlate(b, a)
    lags = ss.correlation_lags(len(b), len(a)) * resample_dt
    if force_positive:
        latency = lags[lags >= 0][np.argmax(corr[lags >= 0])]
    else:
        latency = lags[np.argmax(corr)]
    return float(latency), {
        "t_samples": t, "x_target": a, "x_actual": b,
        "correlation": corr, "lags": lags,
    }
