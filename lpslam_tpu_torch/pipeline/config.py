"""Typed per-component configuration schema and the JSON config file (port
of lpslam_tpu/pipeline/config.py).

- ``ConfigOptions``: required and optional-with-default typed options,
  unknown keys rejected, underscore-prefixed keys ignored as comments;
- the JSON config file with sections manager / trackers / processors /
  datasources / cameras / markers, each component entry
  ``{"type": ..., "configuration": {...}}``. A camera's ``rotation_vec`` is
  turned into a matrix by the numpy Rodrigues formula
  (``geometry/camera.py::_rodrigues_mat``), where the JAX package calls
  ``cv2.Rodrigues``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..geometry.camera import _rodrigues_mat


class ConfigError(ValueError):
    pass


@dataclass
class _Opt:
    name: str
    typ: type
    required: bool
    default: Any = None


class ConfigOptions:
    """Typed option schema. Underscore-prefixed json keys are comments."""

    def __init__(self):
        self._opts: dict[str, _Opt] = {}

    def required(self, name: str, typ: type) -> "ConfigOptions":
        self._opts[name] = _Opt(name, typ, True)
        return self

    def optional(self, name: str, typ: type, default) -> "ConfigOptions":
        self._opts[name] = _Opt(name, typ, False, default)
        return self

    def defaults(self) -> dict:
        """Every optional option's default value."""
        return {n: o.default for n, o in self._opts.items() if not o.required}

    def parse(self, cfg: Optional[dict]) -> dict:
        cfg = {k: v for k, v in (cfg or {}).items() if not k.startswith("_")}
        for key in cfg:
            if key not in self._opts:
                raise ConfigError(f"unknown configuration key '{key}'")
        out = {}
        for name, opt in self._opts.items():
            if name in cfg:
                v = cfg[name]
                if opt.typ in (float, int) and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    v = opt.typ(v)
                if not isinstance(v, opt.typ):
                    raise ConfigError(
                        f"option '{name}' expects {opt.typ.__name__}, got {type(v).__name__}"
                    )
                out[name] = v
            elif opt.required:
                raise ConfigError(f"missing required option '{name}'")
            else:
                out[name] = opt.default
        return out


@dataclass
class CameraConfig:
    """One entry of the `cameras` section."""

    number: int = 0
    model: str = "no_distortion"      # perspective | fisheye | omni | no_distortion
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    distortion: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    width: int = 0
    height: int = 0
    fps: float = 30.0
    focal_x_baseline: float = 0.0
    rotation: Optional[np.ndarray] = None      # 3x3 (right camera w.r.t. left)
    translation: Optional[np.ndarray] = None   # (3,)
    mask_image: Optional[str] = None
    mask_radius: float = 0.0

    @classmethod
    def from_json(cls, d: dict) -> "CameraConfig":
        known = {
            "number", "model", "fx", "fy", "cx", "cy", "distortion", "resolution",
            "fps", "focal_x_baseline", "rotation", "rotation_vec", "translation",
            "mask_image", "mask_radius",
        }
        for k in d:
            if not k.startswith("_") and k not in known:
                raise ConfigError(f"unknown camera key '{k}'")
        c = cls()
        c.number = int(d.get("number", 0))
        c.model = d.get("model", "no_distortion")
        if c.model not in ("perspective", "fisheye", "omni", "no_distortion"):
            raise ConfigError(f"unknown camera model '{c.model}'")
        c.fx = float(d.get("fx", 0.0))
        c.fy = float(d.get("fy", 0.0))
        c.cx = float(d.get("cx", 0.0))
        c.cy = float(d.get("cy", 0.0))
        dist = np.asarray(d.get("distortion", []), np.float32)
        if c.model == "perspective" and dist.size not in (0, 4, 5, 8):
            raise ConfigError(
                f"perspective model expects 4/5/8 distortion values, got {dist.size}"
            )
        if c.model == "fisheye" and dist.size not in (0, 4):
            raise ConfigError(
                f"fisheye model expects 4 distortion values, got {dist.size}"
            )
        c.distortion = dist
        res = d.get("resolution", [0, 0])
        c.width, c.height = int(res[0]), int(res[1])
        c.fps = float(d.get("fps", 30.0))
        c.focal_x_baseline = float(d.get("focal_x_baseline", 0.0))
        if "rotation" in d:
            R = np.asarray(d["rotation"], np.float64)
            if R.size != 9:
                raise ConfigError("camera rotation expects 9 values")
            c.rotation = R.reshape(3, 3)
        elif "rotation_vec" in d:
            rv = np.asarray(d["rotation_vec"], np.float64)
            if rv.size != 3:
                raise ConfigError("rotation_vec expects 3 values")
            c.rotation = _rodrigues_mat(rv.reshape(3))
        if "translation" in d:
            tv = np.asarray(d["translation"], np.float64)
            if tv.size != 3:
                raise ConfigError("camera translation expects 3 values")
            c.translation = tv
        c.mask_image = d.get("mask_image")
        c.mask_radius = float(d.get("mask_radius", 0.0))
        return c


@dataclass
class ManagerConfig:
    record: bool = False
    record_images: bool = True
    show_live: bool = False
    thread_num: int = 0
    replay_chunks: int = 500


@dataclass
class MarkerConfig:
    """One entry of the `markers` section: a known fiducial's global pose."""

    marker_id: int = 0
    marker_type: str = "fixed"
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation_wxyz: np.ndarray = field(
        default_factory=lambda: np.asarray([1.0, 0, 0, 0])
    )


@dataclass
class FullConfig:
    manager: ManagerConfig
    trackers: list          # [(type, configuration-dict)]
    processors: list
    datasources: list
    cameras: dict           # number -> CameraConfig
    markers: list = field(default_factory=list)


def load_config_file(path: str) -> FullConfig:
    """Parse the JSON config file."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        raise ConfigError(f"configuration file not found: {path}")
    except json.JSONDecodeError as e:
        raise ConfigError(f"invalid JSON in {path}: {e}")

    mgr_schema = (
        ConfigOptions()
        .optional("record", bool, False)
        .optional("record_images", bool, True)
        .optional("show_live", bool, False)
        .optional("thread_num", int, 0)
        .optional("replay_chunks", int, 500)
    )
    mgr = ManagerConfig(**mgr_schema.parse(raw.get("manager", {})))

    def comp_list(section):
        out = []
        for entry in raw.get(section, []):
            if "type" not in entry:
                raise ConfigError(f"{section} entry missing 'type'")
            out.append((entry["type"], entry.get("configuration", {})))
        return out

    cameras = {}
    for cam_json in raw.get("cameras", []):
        cc = CameraConfig.from_json(cam_json)
        cameras[cc.number] = cc

    markers = []
    for mk in raw.get("markers", []):
        if "type" not in mk:
            raise ConfigError("markers entry missing 'type'")
        conf = mk.get("configuration", {})
        markers.append(
            MarkerConfig(
                marker_id=int(conf.get("id", 0)),
                marker_type=mk["type"],
                position=np.asarray(conf.get("position", [0, 0, 0]), np.float64),
                orientation_wxyz=np.asarray(
                    conf.get("orientation", [1, 0, 0, 0]), np.float64
                ),
            )
        )

    return FullConfig(
        manager=mgr,
        trackers=comp_list("trackers"),
        processors=comp_list("processors"),
        datasources=comp_list("datasources"),
        cameras=cameras,
        markers=markers,
    )
