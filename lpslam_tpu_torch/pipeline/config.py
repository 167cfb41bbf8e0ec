"""Typed per-component configuration schema (port of `ConfigOptions` from
lpslam_tpu/pipeline/config.py): required and optional-with-default typed
options, unknown keys rejected, underscore-prefixed keys ignored as
comments. The JSON config file and ``CameraConfig`` (which needs cv2) are
not ported yet."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


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
