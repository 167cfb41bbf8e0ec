"""Port parity, the JSON config file: lpslam_tpu_torch/pipeline/config.py
against lpslam_tpu/pipeline/config.py.

- The three shipped example files parse to equal FullConfigs (the
  zed_live_record.json sources and its recording refuse only when a
  manager builds them);
- bad camera entries raise the same ConfigError messages;
- `rotation_vec` gives cv2.Rodrigues' matrix within 1e-12;
- the manager and marker sections, and file errors, match.
"""
import dataclasses
import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

from lpslam_tpu.pipeline import config as jc
from lpslam_tpu_torch.pipeline import config as tc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.json")))


def _as_plain(x):
    """Dataclasses / arrays / containers -> comparable plain values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _as_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, dict):
        return {k: _as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_plain(v) for v in x]
    return x


def test_examples_cover_the_three_files():
    assert [os.path.basename(p) for p in EXAMPLES] == [
        "mono_synthetic.json", "stereo_rectified.json", "zed_live_record.json"]


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_files_parse_equal(path):
    assert _as_plain(tc.load_config_file(path)) == _as_plain(jc.load_config_file(path))


def test_zed_example_refuses_only_when_built():
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    cfg = tc.load_config_file(os.path.join(REPO, "examples", "zed_live_record.json"))
    assert cfg.manager.record and cfg.datasources[0][0] == "Zed"
    with pytest.raises(NotImplementedError, match="item 20"):
        SlamManager(cfg, device="cpu")                        # recording
    with pytest.raises(NotImplementedError, match="item 21"):
        SlamManager(dataclasses.replace(cfg, manager=tc.ManagerConfig()), device="cpu")


@pytest.mark.parametrize("entry", [
    {"model": "pinhole"},
    {"model": "perspective", "distortion": [0.1, 0.2, 0.3]},
    {"model": "fisheye", "distortion": [0.1, 0.2, 0.3, 0.4, 0.5]},
    {"rotation": [1, 0, 0, 0, 1, 0]},
    {"rotation_vec": [0.1, 0.2]},
    {"translation": [0.1]},
    {"fx": 100.0, "color": "red"},
])
def test_camera_errors_match(entry):
    with pytest.raises(jc.ConfigError) as ej:
        jc.CameraConfig.from_json(entry)
    with pytest.raises(tc.ConfigError) as et:
        tc.CameraConfig.from_json(entry)
    assert str(et.value) == str(ej.value)


def test_rotation_vec_matches_cv2_rodrigues():
    rng = np.random.default_rng(0)
    vecs = [rng.normal(size=3) * s for s in (1e-9, 1e-3, 0.5, 2.0, 3.1)] + [np.zeros(3)]
    for rv in vecs:
        c = tc.CameraConfig.from_json({"rotation_vec": rv.tolist(), "translation": [1, 0, 0]})
        want, _ = cv2.Rodrigues(rv)
        np.testing.assert_allclose(c.rotation, want, atol=1e-12, rtol=0)
        j = jc.CameraConfig.from_json({"rotation_vec": rv.tolist()})
        np.testing.assert_allclose(c.rotation, j.rotation, atol=1e-12, rtol=0)


def test_full_file_sections_and_errors(tmp_path):
    raw = {
        "_comment": "x",
        "manager": {"record_images": False, "thread_num": 4, "replay_chunks": 7},
        "cameras": [{"number": 1, "model": "perspective", "fx": 300, "fy": 301, "cx": 160,
                     "cy": 120, "distortion": [0.1, -0.02, 0.001, 0.0, 0.0],
                     "resolution": [320, 240], "rotation_vec": [0.0, 0.01, 0.0],
                     "translation": [-0.1, 0, 0], "mask_radius": 100, "mask_image": "m.png"}],
        "markers": [{"type": "fixed", "configuration": {"id": 3, "position": [1, 2, 3]}}],
        "trackers": [{"type": "VSLAM", "configuration": {"mode": "mono"}}],
        "datasources": [{"type": "File", "configuration": {"directory": "d"}}],
    }
    path = tmp_path / "c.json"
    path.write_text(json.dumps(raw))
    assert _as_plain(tc.load_config_file(str(path))) == _as_plain(jc.load_config_file(str(path)))
    bad = [("{", "invalid JSON"), (json.dumps({"manager": {"recrd": True}}), "unknown"),
           (json.dumps({"trackers": [{"configuration": {}}]}), "missing 'type'"),
           (json.dumps({"markers": [{"configuration": {}}]}), "missing 'type'")]
    for text, msg in bad:
        path.write_text(text)
        for mod in (tc, jc):
            with pytest.raises(mod.ConfigError, match=msg):
                mod.load_config_file(str(path))
    with pytest.raises(tc.ConfigError, match="not found"):
        tc.load_config_file(str(tmp_path / "none.json"))
