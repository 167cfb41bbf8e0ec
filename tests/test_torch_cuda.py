"""The port's hand-written CUDA kernels on the card (no JAX: the machine with
the card has none). Every test here needs an NVIDIA card and skips without
one; run them there with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

- The patch kernel must be bit-equal to its plain PyTorch version on the
  border, half-to-even and tail cases, and count exactly one launch.
- The FAST+NMS kernel must be bit-equal to its plain version in both forms
  (fixed ceiling; each frame's own ceiling, whose max pass must equal the
  plain maximum) at the operating point's level shapes, a level under 80
  rows, an odd size and a level barely over the 7 rows FAST needs, on a
  batch with a flat frame too; the score kernel counts one launch per call
  and the max pass one more in the frame-ceiling form. ``thr_hi < thr_lo``
  and CPU tensors raise.
- ``extract_orb`` on the card must launch the patch kernel and the FAST+NMS
  kernel once per pyramid level (the max pass too unless
  ``use_pallas=True``) and agree with the same extraction on the CPU.
  The level-0 score map is the kernels', bit-equal to the CPU's plain
  version, so level-0 keypoints must be equal in both forms. Matmuls sum in
  another order there, and descriptor pairs whose two taps nearly tie are
  decided by that rounding, so angles agree within 1e-4 rad and < 2% of the
  matched keypoints' descriptor bits differ. Readings on an H100 80GB
  HBM3 at 700 W (torch 2.11, CUDA 12.8), ten 240x320 textures (seeds
  11-20), with the composite still in plain PyTorch on the card: it gave
  overlap 1.0, angle differences up to 2.9e-5 rad
  and 0.60-0.86% of the bits differing; ``use_pallas=True`` gave equal
  level-0 keypoints on all ten, angle differences up to 2.9e-5 rad and
  0.25-0.36% of the bits differing (at most 7 on one keypoint).
- The descriptor modes binned, gather and exact on the card against the CPU,
  one extraction each: the patch kernel launches once per level in binned
  and never in gather / exact, the FAST kernels once per level in all;
  level-0 keypoints equal; angles from the moment maps (whose cumulative
  sums add in another order on the card) within 5e-4 rad where the
  centroid is strong (|m| > 1e3, tests/test_torch_brief_modes.py's bar);
  < 2% of those keypoints' descriptor bits differ (bins flip at their
  edges, near-tied taps flip with the blur's rounding).
- The Hamming kernel (csrc/hamming.cu, the tensor cores' single-bit
  product) bit-equal to its plain SWAR version at the tracker's 4096 x 1200,
  at 1 x 1, 257 x 131, 64 x 128 (one tile), 65 x 1204, all-equal and
  all-complement descriptors, one launch per call and none for 0 x 5; the
  matchers give the same indices and flags with and without the product.
- The fused projected matcher (csrc/hamming.cu lpslam_match_projected)
  bit-equal to match_projected_reference on the card and on the CPU, on
  random inputs and tie-heavy ones (descriptors from a pool of 8), at
  windows of 25, 6 and 50 px, an odd keypoint count, keypoints over two and
  three chunks, views off the 16-byte alignment, NaN pixels and pairs on
  the window's edge; one launch per call, none for Nq = 0; Nk = 0, CPU
  tensors and a tensor radius raise.
- The sorted segment sum (kernels/linalg.py) run twice on the card is
  bit-equal to itself and to the CPU's, and bundle_adjust_cg and
  correct_loop run twice on the card give the same result bit for bit.
- ``run_dataset --brief-mode`` on the card (its default device) for each of
  the four modes, on a small room: every frame fed, most tracked, the
  kernels launched (the patch kernel only where the mode uses patches).
- The HD720 pyramid of phase 13's stereo pair (720x1280, 600x1067,
  500x889 at B = 2): both kernels bit-equal to their plain versions.
- The pipeline on the card: RectifyProcessor's undistorted and rectified
  frames (a radtan pair, and the ZED's fisheye pair at 1280x720) equal its
  CPU run within 1e-4 gray levels (the grids are the same numpy arrays; the
  bilinear blend may contract differently); SlamManager
  with the synthetic source processes every frame with no worker error and
  launches the kernels; so does a session recorded with RecordEngine and
  replayed through the Replay source.
- Loop closing on the card against the same calls on the CPU: the shipped
  vocabulary's word ids and tf counts bit-equal (an fp32 ±1 product, exact
  with TF32 off); the normalized BoW vector within 1e-6 relative (its norm
  sums in another order: 2.7e-7 relative at one of 31,707 entries on an H100
  80GB HBM3 at 700 W); ``correct_loop`` on a synthetic circle map within 1e-3
  (the JAX parity bound of tests/test_torch_loop.py).
- dist/ and native/ on the card: ``distributed_bundle_adjust`` in a world of
  one over NCCL (and on the default mesh) against the CPU, and the native
  queue carrying CUDA tensors between threads.
- ``pose_only_optimize`` through its CUDA graphs bit-equal, field by field,
  to its eager body on the same inputs: track_frame's two calls (4096
  landmarks, 6 iterations, then 4 from the first call's pose, one graph
  each, captured once) and relocalization's (8 iterations, variances of
  ones); a call's result stays as it was after the next call replays the
  same graph with other inputs.
"""
import numpy as np
import pytest
import torch

from lpslam_tpu_torch.io.synthetic import make_texture
from lpslam_tpu_torch.kernels import fast_nms, match, orb, patch
from lpslam_tpu_torch.kernels.pyramid import build_pyramid, gaussian_blur
from lpslam_tpu_torch.loop import detector, vocab
from lpslam_tpu_torch.mapstore import store

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_patch_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(9)
    imgs = np.stack([make_texture(240, 320, seed=6), make_texture(240, 320, seed=7)])
    extra = np.array([[0, 0], [319, 239], [16, 16], [303, 223],
                      [20.5, 21.5], [-3, 400]], np.float32)
    xy = np.stack([
        np.concatenate([rng.uniform(0, [320, 240], (67, 2)).astype(np.float32), extra])
        for _ in range(2)
    ])
    img_d = torch.from_numpy(imgs).to(cuda_device)
    xy_d = torch.from_numpy(xy).to(cuda_device)
    before = patch.LAUNCHES
    got = patch.extract_patches(img_d, xy_d)
    torch.cuda.synchronize()
    assert patch.LAUNCHES == before + 1
    assert got.shape == (2, 73, 1024)
    assert torch.equal(got, patch.extract_patches_reference(img_d, xy_d))


@pytest.mark.parametrize("frame_ceiling", [False, True])
@pytest.mark.parametrize("b,h,w", [(2, 480, 640), (16, 400, 533), (16, 333, 444),
                                   (3, 79, 97), (1, 37, 45), (2, 8, 8), (1, 10, 33),
                                   (2, 720, 1280), (2, 600, 1067), (2, 500, 889)])
def test_fast_nms_kernel_matches_plain(cuda_device, b, h, w, frame_ceiling):
    rng = np.random.default_rng(h * w)
    x = (rng.random((b, h, w)) * 255).astype(np.float32)
    x[:, :, :4] = rng.choice([0.0, 255.0], (b, h, min(4, w)))  # border corners
    tex = np.stack([make_texture(max(h, 20), max(w, 20), seed=i)[:h, :w] for i in range(b)])
    uneven = x * (np.linspace(0.0, 1.0, b, dtype=np.float32)[:, None, None] ** 2)  # frame 0 flat
    for arr in (x, np.ascontiguousarray(tex), uneven):
        img = torch.from_numpy(arr).to(cuda_device)
        before, before_max = fast_nms.LAUNCHES, fast_nms.MAX_LAUNCHES
        got = fast_nms.fast_nms_score(img, 20.0, 7.0, frame_ceiling)
        torch.cuda.synchronize()
        assert fast_nms.LAUNCHES == before + 1
        assert fast_nms.MAX_LAUNCHES == before_max + int(frame_ceiling)
        assert torch.equal(got, fast_nms.fast_nms_score_reference(img, 20.0, 7.0, frame_ceiling))
        assert torch.equal(fast_nms.fast_lo_max_cuda(img, 7.0),
                           fast_nms.fast_lo_max_reference(img, 7.0))


@pytest.mark.parametrize("h,w,n", [(720, 1280, 474), (600, 1067, 396), (500, 889, 330)])
def test_patch_kernel_at_hd720_matches_plain(cuda_device, h, w, n):
    """The HD720 pyramid of a stereo pair (B = 2) with the level's keypoint
    budget, keypoints on the borders too."""
    rng = np.random.default_rng(h)
    img = torch.from_numpy((rng.random((2, h, w)) * 255).astype(np.float32)).to(cuda_device)
    xy = rng.uniform(0, [w, h], (2, n, 2)).astype(np.float32)
    xy[:, :4] = [[0, 0], [w - 1, h - 1], [w - 16.5, 15.5], [-2, h + 3]]
    xy_d = torch.from_numpy(xy).to(cuda_device)
    before = patch.LAUNCHES
    got = patch.extract_patches(img, xy_d)
    torch.cuda.synchronize()
    assert patch.LAUNCHES == before + 1
    assert torch.equal(got, patch.extract_patches_reference(img, xy_d))


def test_kernel_wrappers_refuse_misuse(cuda_device):
    img = torch.zeros((1, 40, 40))
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score_cuda(img)
    with pytest.raises(ValueError):
        fast_nms.fast_lo_max_cuda(img)
    with pytest.raises(ValueError):
        patch.extract_patches_cuda(img, torch.zeros((1, 3, 2)))
    with pytest.raises(ValueError):   # the kernel's early exits need thr_hi >= thr_lo
        fast_nms.fast_nms_score_cuda(img.to(cuda_device), 7.0, 20.0)
    with pytest.raises(TypeError):
        fast_nms.fast_nms_score_cuda(img.to(cuda_device, torch.float64))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_extract_orb_on_card_matches_cpu(cuda_device, use_pallas):
    img = torch.from_numpy(np.stack([make_texture(240, 320, seed=s) for s in (11, 12)]))
    params = orb.OrbParams(512, 3, use_pallas=use_pallas)
    before, before_fast, before_max = patch.LAUNCHES, fast_nms.LAUNCHES, fast_nms.MAX_LAUNCHES
    got = orb.extract_orb(img.to(cuda_device), params)
    torch.cuda.synchronize()
    assert patch.LAUNCHES == before + params.num_levels
    assert fast_nms.LAUNCHES == before_fast + params.num_levels
    assert fast_nms.MAX_LAUNCHES == before_max + (0 if use_pallas else params.num_levels)
    want = orb.extract_orb(img, params)
    k0 = orb._level_budgets(512, 3, 1.2)[0]
    for b in range(2):
        xy_g, xy_c = got.xy[b, :k0].cpu().numpy(), want.xy[b, :k0].numpy()
        v_g, v_c = got.valid[b, :k0].cpu().numpy(), want.valid[b, :k0].numpy()
        np.testing.assert_array_equal(xy_g, xy_c)   # level 0: the kernels' score map
        set_c = {tuple(p) for p in xy_c[v_c]}
        set_g = {tuple(p) for p in xy_g[v_g]}
        assert len(set_c) > 50
        overlap = len(set_c & set_g) / len(set_c)
        assert overlap >= 0.97, overlap
        m = (xy_g == xy_c).all(1) & v_g & v_c
        np.testing.assert_allclose(got.angle[b, :k0].cpu().numpy()[m],
                                   want.angle[b, :k0].numpy()[m], atol=1e-4)
        bits = np.unpackbits(
            (got.desc[b, :k0].cpu().numpy()[m] ^ want.desc[b, :k0].numpy()[m]).view(np.uint8)
        )
        assert bits.mean() < 0.02, bits.mean()


@pytest.mark.parametrize("mode", ["binned", "gather", "exact"])
def test_extract_orb_brief_modes_on_card_match_cpu(cuda_device, mode):
    img = torch.from_numpy(np.stack([make_texture(240, 320, seed=s) for s in (11, 12)]))
    params = orb.OrbParams(512, 3, brief_mode=mode)
    before = patch.LAUNCHES, fast_nms.LAUNCHES, fast_nms.MAX_LAUNCHES
    got = orb.extract_orb(img.to(cuda_device), params)
    torch.cuda.synchronize()
    after = patch.LAUNCHES, fast_nms.LAUNCHES, fast_nms.MAX_LAUNCHES
    levels = params.num_levels
    assert tuple(a - b for a, b in zip(after, before)) == (
        levels if mode == "binned" else 0, levels, levels)
    want = orb.extract_orb(img, params)
    k0 = orb._level_budgets(512, 3, 1.2)[0]
    blurred = gaussian_blur(build_pyramid(img, 3, 1.2)[0], sigma=2.0, radius=3)
    m10, m01 = (x.numpy() for x in orb.orientation_maps(blurred))
    for b in range(2):
        xy_g, xy_c = got.xy[b, :k0].cpu().numpy(), want.xy[b, :k0].numpy()
        v_g, v_c = got.valid[b, :k0].cpu().numpy(), want.valid[b, :k0].numpy()
        np.testing.assert_array_equal(xy_g, xy_c)
        np.testing.assert_array_equal(v_g, v_c)
        xi, yi = xy_c.astype(int).T
        m = v_c & (np.hypot(m10[b, yi, xi], m01[b, yi, xi]) > 1e3)
        assert m.sum() > 50
        da = np.angle(np.exp(1j * (got.angle[b, :k0].cpu().numpy() - want.angle[b, :k0].numpy())))
        assert np.abs(da[m]).max() <= 5e-4
        bits = np.unpackbits(
            (got.desc[b, :k0].cpu().numpy()[m] ^ want.desc[b, :k0].numpy()[m]).view(np.uint8))
        assert bits.mean() < 0.02, bits.mean()


def test_hamming_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(4)

    def desc(n):
        return torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32))

    a, b = desc(4096), desc(1200)
    cases = [(a, b), (a[:1], b[:1]), (a[:257], b[:131]), (b, b), (b, ~b), (a[:33], b[:129]),
             (a[:64], b[:128]), (a[:65], desc(1204))]
    for x, y in cases:
        before = match.LAUNCHES
        got = match.hamming_matrix(x.to(cuda_device), y.to(cuda_device))
        torch.cuda.synchronize()
        assert match.LAUNCHES == before + 1
        assert got.dtype == torch.int32 and got.shape == (len(x), len(y))
        assert torch.equal(got.cpu(), match.hamming_matrix_reference(x, y))
        assert torch.equal(got, match.hamming_matrix_reference(x.to(cuda_device),
                                                               y.to(cuda_device)))
    assert (torch.diagonal(match.hamming_matrix(b.to(cuda_device), (~b).to(cuda_device)))
            == 256).all()
    before = match.LAUNCHES
    assert match.hamming_matrix(a[:0].to(cuda_device), b[:5].to(cuda_device)).shape == (0, 5)
    assert match.LAUNCHES == before
    with pytest.raises(ValueError):
        match.hamming_matrix_cuda(a, b)                       # CPU tensors
    with pytest.raises(TypeError):
        match.hamming_matrix_cuda(a.to(cuda_device, torch.int64), b.to(cuda_device))
    with pytest.raises(ValueError):
        match.hamming_matrix_cuda(a[:, :4].to(cuda_device), b[:, :4].to(cuda_device))
    # the matchers launch the kernel once per call and pick the CPU's pairs
    va = torch.ones(4096, dtype=torch.bool)
    vb = torch.ones(1200, dtype=torch.bool)
    a_m = a.clone()
    a_m[:600] = b[:600] ^ 1                                   # near-duplicates
    want = match.match_mutual_nn(a_m, b, va, vb, 80, 0.9)
    before = match.LAUNCHES
    got = match.match_mutual_nn(a_m.to(cuda_device), b.to(cuda_device), va.to(cuda_device),
                                vb.to(cuda_device), 80, 0.9)
    assert match.LAUNCHES == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert int(want[1].sum()) >= 600


@pytest.mark.parametrize("mode", ["polar", "binned", "gather", "exact"])
def test_run_dataset_brief_modes_on_card(cuda_device, mode, tmp_path):
    import json

    from lpslam_tpu_torch.eval import run_dataset

    out = tmp_path / "out.json"
    before = patch.LAUNCHES, fast_nms.LAUNCHES
    assert run_dataset.main(["--bench", "room", "--width", "160", "--height", "120",
                             "--keypoints", "256", "--levels", "2", "--max-keyframes", "16",
                             "--max-landmarks", "2048", "--frames", "40", "--chunk", "8",
                             "--brief-mode", mode, "--json-out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"].startswith("cuda") and res["frames"] == 40
    assert res["tracked"] >= 25, res          # 31 of 40 on the CPU (init at frame 9)
    assert fast_nms.LAUNCHES > before[1]
    assert (patch.LAUNCHES > before[0]) == (mode in ("polar", "binned"))


def test_bow_on_card_matches_cpu(cuda_device):
    from lpslam_tpu_torch.pipeline.trackers import SHIPPED_VOCAB

    v_cpu = vocab.load_vocabulary(SHIPPED_VOCAB, "cpu")
    v_gpu = vocab.load_vocabulary(SHIPPED_VOCAB, cuda_device)
    rng = np.random.default_rng(3)
    words = v_cpu.words.numpy()
    desc = rng.integers(0, 2**32, (1200, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    desc[:200] = words[rng.integers(0, len(words), 200)]      # exact words
    desc[200:260] = 0                                          # one tied descriptor
    d_cpu = torch.from_numpy(desc)
    valid = torch.from_numpy(rng.random(1200) < 0.9)
    ids_cpu = vocab.assign_words(v_cpu, d_cpu, valid)
    ids_gpu = vocab.assign_words(v_gpu, d_cpu.to(cuda_device), valid.to(cuda_device))
    assert torch.equal(ids_gpu.cpu(), ids_cpu)
    tf = torch.bincount(ids_cpu[ids_cpu >= 0].long(), minlength=len(words))
    b_cpu = vocab.bow_vector(v_cpu, d_cpu, valid)
    b_gpu = vocab.bow_vector(v_gpu, d_cpu.to(cuda_device), valid.to(cuda_device)).cpu()
    assert torch.equal(b_gpu > 0, tf > 0)
    torch.testing.assert_close(b_gpu, b_cpu, rtol=1e-6, atol=0)


def _circle_map(device, K=12, N=64, M=600, seed=0):
    """Keyframes on a circle looking outward at a ring of landmarks; each
    keyframe observes the landmarks in front of it."""
    rng = np.random.default_rng(seed)
    m = store.empty_map(store.MapConfig(K + 4, M, N), device)
    ang = rng.uniform(0, 2 * np.pi, M)
    pts = np.stack([6 * np.sin(ang), rng.uniform(-1, 1, M), -6 * np.cos(ang)], 1)
    m = m._replace(lm_pos=torch.tensor(pts, dtype=torch.float32, device=device),
                   lm_valid=torch.ones(M, dtype=torch.bool, device=device),
                   lm_first_kf=torch.tensor(rng.integers(0, K, M), dtype=torch.int32,
                                            device=device),
                   n_lm=torch.tensor(M, dtype=torch.int32, device=device))
    for k in range(K):
        a = 2 * np.pi * k / K + 0.02 * k
        c = np.array([np.sin(a), 0.0, -np.cos(a)])
        z = c / np.linalg.norm(c)
        x = np.array([np.cos(a), 0.0, np.sin(a)])
        R_wc = np.stack([x, np.cross(z, x), z], 1)
        R, t = R_wc.T, -R_wc.T @ c
        seen = np.flatnonzero((pts - c) @ z > 2.0)[:N]
        lm = np.full(N, -1, np.int32)
        lm[:len(seen)] = seen
        m = store.insert_keyframe_slots(
            m, torch.tensor(R, dtype=torch.float32, device=device),
            torch.tensor(t, dtype=torch.float32, device=device),
            torch.zeros((N, 2), device=device),
            torch.zeros((N, 8), dtype=torch.int32, device=device),
            torch.tensor(lm >= 0, device=device), torch.tensor(lm, device=device), k)
    return m


def test_correct_loop_on_card_matches_cpu(cuda_device):
    m_cpu = _circle_map("cpu")
    m_gpu = _circle_map(cuda_device)
    ang = torch.tensor([0.02, -0.03, 0.01])
    from lpslam_tpu_torch.geometry.sim3 import sim3_exp

    S = sim3_exp(torch.cat([torch.tensor([0.1, -0.05, 0.2]), ang, torch.tensor([0.05])]))
    out_cpu = detector.correct_loop(m_cpu, 11, 1, S.R, S.t, S.s, min_shared=5)
    out_gpu = detector.correct_loop(m_gpu, 11, 1, S.R.to(cuda_device), S.t.to(cuda_device),
                                    S.s.to(cuda_device), min_shared=5)
    assert (out_cpu.kf_t - m_cpu.kf_t).abs().max() > 1e-2     # it did move
    for a, b in ((out_gpu.kf_R, out_cpu.kf_R), (out_gpu.kf_t, out_cpu.kf_t),
                 (out_gpu.lm_pos, out_cpu.lm_pos)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3)


def test_rectify_processor_on_card_matches_cpu(cuda_device):
    from lpslam_tpu_torch.io import SyntheticBenchmark
    from lpslam_tpu_torch.pipeline.config import CameraConfig
    from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
    from lpslam_tpu_torch.pipeline.rectify import RectifyProcessor

    ds = SyntheticBenchmark(num_frames=2, h=240, w=320, seed=0, stereo=True)
    intr = ds.intr
    fr = next(iter(ds))
    kw = dict(model="perspective", fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
              distortion=np.asarray(intr["dist"], np.float32), width=320, height=240)
    left = CameraConfig(number=0, rotation=np.eye(3),
                        translation=np.array([-intr["baseline"], 0.0, 0.0]), **kw)
    right = CameraConfig(number=1, **kw)
    for cams, second in (((CameraConfig(number=0, **kw),), None), ((left, right), fr.image_right)):
        out = []
        for dev in ("cpu", cuda_device):
            proc = RectifyProcessor(None, *cams, device=dev)
            e = proc.process_image(CameraQueueEntry(0.0, fr.image.copy(), second))
            out.append((e.image, e.image_second))
        for a, b in zip(*out):
            if a is not None:
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_fisheye_stereo_rectify_on_card_matches_cpu(cuda_device):
    """The ZED rig of examples/zed_live_record.json on both eyes (fisheye,
    12 cm), rectified on the card and on the CPU: the same numpy grids, so
    frames within 1e-4 gray levels as the radtan pair above."""
    from lpslam_tpu_torch.pipeline.config import CameraConfig
    from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
    from lpslam_tpu_torch.pipeline.rectify import RectifyProcessor

    kw = dict(model="fisheye", fx=700.0, fy=700.0, cx=640.0, cy=360.0,
              distortion=np.array([-0.17, 0.023, 0.0, 0.0], np.float32),
              width=1280, height=720)
    left = CameraConfig(number=0, rotation=np.eye(3), translation=np.array([-0.12, 0.0, 0.0]),
                        **kw)
    right = CameraConfig(number=1, **kw)
    imgs = [make_texture(720, 1280, seed=s) for s in (3, 4)]
    out = []
    for dev in ("cpu", cuda_device):
        proc = RectifyProcessor(None, left, right, device=dev)
        assert abs(proc.K_new[0, 0] - 600.57326876) < 1e-4
        assert abs(proc.focal_x_baseline - 72.06879225) < 1e-6
        e = proc.process_image(CameraQueueEntry(0.0, imgs[0].copy(), imgs[1].copy()))
        out.append((e.image, e.image_second))
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_manager_on_card_processes_frames(cuda_device):
    import time

    from lpslam_tpu_torch.pipeline.config import CameraConfig
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    mgr = SlamManager(device=cuda_device)
    src = mgr.add_source_by_name("Synthetic", {"num_frames": 12, "width": 320, "height": 240})
    K = src.K
    mgr.set_camera_configuration(CameraConfig(number=0, fx=float(K[0, 0]), fy=float(K[1, 1]),
                                              cx=float(K[0, 2]), cy=float(K[1, 2])))
    tracker = mgr.add_tracker_by_name("VSLAM", {"keypoints": 512, "max_keyframes": 16,
                                                "max_landmarks": 4096})
    before = patch.LAUNCHES
    mgr.start()
    t0 = time.time()
    while not (src.done and mgr.camera_queue.empty()) and time.time() - t0 < 300:
        time.sleep(0.05)
    mgr.stop()
    st = mgr.get_status()
    assert st.error == "" and st.frames_processed == 12, st
    assert tracker.engine.map.lm_pos.is_cuda
    assert patch.LAUNCHES >= before + 12


def test_replay_on_card_runs_the_kernels(cuda_device, tmp_path):
    import time

    from lpslam_tpu_torch.io.synthetic import make_sequence
    from lpslam_tpu_torch.pipeline.config import CameraConfig
    from lpslam_tpu_torch.pipeline.manager import SlamManager
    from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
    from lpslam_tpu_torch.pipeline.record import RecordEngine

    seq = make_sequence(num_frames=12, h=240, w=320, seed=0)
    path = str(tmp_path / "session.pb")
    rec = RecordEngine(jpeg_quality=95)
    rec.set_output_file(path)
    rec.start()
    for t, img in enumerate(seq.images):
        rec.store_camera_image(CameraQueueEntry(timestamp=t / 20.0, image=img))
    rec.stop()
    mgr = SlamManager(device=cuda_device)
    mgr.set_camera_configuration(CameraConfig(number=0, fx=float(seq.K[0, 0]),
                                              fy=float(seq.K[1, 1]), cx=float(seq.K[0, 2]),
                                              cy=float(seq.K[1, 2])))
    src = mgr.add_source_by_name("Replay", {"file": path})
    mgr.add_tracker_by_name("VSLAM", {"keypoints": 512, "max_keyframes": 16,
                                      "max_landmarks": 4096})
    before = (patch.LAUNCHES, fast_nms.LAUNCHES)
    mgr.start()
    t0 = time.time()
    while not (src.done and mgr.camera_queue.empty()) and time.time() - t0 < 300:
        time.sleep(0.05)
    mgr.stop()
    st = mgr.get_status()
    assert st.error == "" and st.frames_processed == 12, st
    assert patch.LAUNCHES >= before[0] + 12 and fast_nms.LAUNCHES >= before[1] + 12


def _dba_world(mesh, C, P, N):
    """distributed_bundle_adjust in a spawned world (NCCL on the card)."""
    from lpslam_tpu_torch.dist import distributed_bundle_adjust
    from lpslam_tpu_torch.eval.scaling import _camera, build_problem

    res = distributed_bundle_adjust(build_problem(C, P, N, device=mesh.device),
                                    _camera(mesh.device), mesh=mesh, iters=8)
    return {k: getattr(res, k).cpu().numpy() for k in ("cam_t", "points", "final_cost")}


def test_distributed_bundle_adjust_on_card_matches_cpu(cuda_device):
    """A world of one over NCCL on the card, and the default mesh (no
    process group) there, against the same solve on the CPU: the card sums
    in another order, so within 2e-4 on cam_t (the JAX package's spread
    across mesh sizes) and 1e-4 on the cost.
    Every camera sees every landmark: with 64 of 512 per camera, single-view
    landmarks make the solve chaotic in fp32, whichever solver runs it. At
    16 x 512 x 64, seeds 0-4, on an H100 80GB HBM3 at 700 W
    (tools/dist_card_spread.py), the card lands 4.4e-2 to 1.4e-1 (cam_t)
    from the CPU with this solver and 8.9e-3 to 4.1e-1 with the one-device
    backend.ba.bundle_adjust, and on the CPU fp32 lands 5.5e-3 to 2.2e-1
    from fp64 (JAX's own meshes of 1 and 8: 9e-3). At 8 x 256 x 256 every
    one of these is within 2.1e-5."""
    from lpslam_tpu_torch.dist import distributed_bundle_adjust
    from lpslam_tpu_torch.dist.mesh import run_world
    from lpslam_tpu_torch.eval.scaling import _camera, build_problem

    C, P, N = 8, 256, 256
    cpu = distributed_bundle_adjust(build_problem(C, P, N, device="cpu"), _camera("cpu"), iters=8)
    card = run_world(_dba_world, 1, C, P, N, backend="nccl", device="cuda", timeout=300.0)[0]
    local = distributed_bundle_adjust(build_problem(C, P, N, device=cuda_device),
                                      _camera(cuda_device), iters=8)
    for got in (card, {k: getattr(local, k).cpu().numpy() for k in card}):
        np.testing.assert_allclose(got["cam_t"], cpu.cam_t.numpy(), atol=2e-4)
        assert abs(float(got["final_cost"]) - float(cpu.final_cost)) <= 1e-4 * float(cpu.final_cost)
    assert float(cpu.final_cost) < float(cpu.initial_cost)


def test_native_queue_carries_card_tensors_between_threads(cuda_device):
    import threading

    from lpslam_tpu_torch.pipeline.queues import BoundedQueue, NativeBoundedQueue

    q = BoundedQueue(maxsize=4)
    assert isinstance(q, NativeBoundedQueue)
    sent = [torch.full((256, 256), float(i), device=cuda_device) for i in range(32)]
    got = []

    def consumer():
        while len(got) < len(sent):
            item = q.pop(timeout=5.0)
            if item is None:
                return
            got.append((item, float(item.sum())))

    t = threading.Thread(target=consumer)
    t.start()
    for x in sent:
        q.push(x, drop_oldest=False)        # blocks while the queue is full
    t.join(timeout=30)
    assert not t.is_alive()
    assert [g[0] is x for g, x in zip(got, sent)] == [True] * len(sent)
    assert [g[1] for g in got] == [256 * 256 * float(i) for i in range(len(sent))]


def _projected_inputs(rng, nq, nk, pool=None, spread=12.0):
    """Queries near keypoints in a 640 x 480 frame; descriptors random with
    half the queries a keypoint's with bits flipped, or all drawn from a
    pool (ties everywhere)."""
    def words(n):
        return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)

    src = rng.integers(0, nk, nq)
    if pool is None:
        dk = words(nk)
        flips = (rng.random((nq, 8)) < 0.5).astype(np.uint32) << rng.integers(
            0, 32, (nq, 8)).astype(np.uint32)
        dq = np.where((rng.random(nq) < 0.5)[:, None], dk[src] ^ flips, words(nq))
    else:
        table = words(pool)
        dk, dq = table[rng.integers(0, pool, nk)], table[rng.integers(0, pool, nq)]
    uk = rng.uniform(0, [640, 480], (nk, 2)).astype(np.float32)
    uq = (uk[src] + rng.normal(0, spread, (nq, 2))).astype(np.float32)
    uq[::11, 0] = np.nan
    uk[::13, 1] = np.nan
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return [T(dq.view(np.int32)), T(uq), T(rng.random(nq) > 0.1),
            T(dk.view(np.int32)), T(uk), T(rng.random(nk) > 0.1)]


@pytest.mark.parametrize("case", ["random", "pool of 8", "odd", "two chunks", "three chunks",
                                  "off alignment"])
def test_projected_matcher_kernel_matches_plain(cuda_device, case):
    rng = np.random.default_rng(8)
    nq, nk, pool = {"random": (4096, 1200, None), "pool of 8": (4096, 1200, 8),
                    "odd": (33, 1201, None), "two chunks": (300, 9001, None),
                    "three chunks": (257, 17000, 8), "off alignment": (101, 1203, None)}[case]
    full = _projected_inputs(rng, nq, nk, pool)
    start = 1 if case == "off alignment" else 0     # views 8 / 1 bytes off on the card
    args = [x[start:] for x in full]
    on = [x.to(cuda_device)[start:] for x in full]
    for radius in (25.0, 6.0, 50.0):
        want = match.match_projected_reference(*args, radius, 80)
        before, dense = match.PROJECTED_LAUNCHES, match.LAUNCHES
        got = match.match_projected(*on, radius, 80)
        torch.cuda.synchronize()
        assert match.PROJECTED_LAUNCHES == before + 1 and match.LAUNCHES == dense
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        plain = match.match_projected_reference(*on, radius, 80)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        if radius == 25.0 and nq >= 4096:
            assert int(want[1].sum()) > 500


def test_projected_matcher_kernel_edges(cuda_device):
    rng = np.random.default_rng(9)
    args = [x.to(cuda_device) for x in _projected_inputs(rng, 64, 64)]
    # whole-pixel queries see their own descriptor with 24 bits flipped at
    # offsets (3, 4) (on the edge of radius 5) and unchanged at (3, 4.0001)
    dq = torch.from_numpy(rng.integers(0, 2**32, (64, 8), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).to(cuda_device)
    uq = torch.floor(torch.nan_to_num(args[1], nan=7.0))
    one = torch.ones(64, dtype=torch.bool, device=cuda_device)
    edge = [dq, uq, one, torch.cat([dq ^ 7, dq]),
            torch.cat([uq + torch.tensor([3.0, 4.0], device=cuda_device),
                       uq + torch.tensor([3.0, 4.0001], device=cuda_device)]),
            torch.cat([one, one])]
    got = match.match_projected(*edge, 5.0, 80)
    want = match.match_projected_reference(*edge, 5.0, 80)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], torch.arange(64, device=cuda_device)) and got[1].all()
    before = match.PROJECTED_LAUNCHES
    idx, ok = match.match_projected(*(x[:0] if i < 3 else x for i, x in enumerate(args)),
                                    25.0, 80)
    assert idx.shape == ok.shape == (0,) and match.PROJECTED_LAUNCHES == before
    with pytest.raises(IndexError):
        match.match_projected(*(x[:0] if i >= 3 else x for i, x in enumerate(args)), 25.0, 80)
    with pytest.raises(ValueError):
        match.match_projected_cuda(*(x.cpu() for x in args), 25.0, 80)
    with pytest.raises(TypeError):
        match.match_projected_cuda(*args, torch.tensor(25.0, device=cuda_device), 80)


@pytest.mark.parametrize("shape", [(3,), (3, 3), (7, 7)], ids=str)
def test_segment_sum_on_card_repeats_and_equals_cpu(cuda_device, shape):
    from lpslam_tpu_torch.kernels.linalg import segment_plan, segment_sum

    rng = np.random.default_rng(10)
    m, n = 153_600, 24_576                    # global BA's observations and landmarks
    idx = torch.from_numpy(rng.integers(0, n, m) // rng.integers(1, 4, m))
    vals = torch.from_numpy(rng.normal(0, 1e3, (m, *shape)).astype(np.float32))
    want = segment_sum(vals, segment_plan(idx, n))
    plan = segment_plan(idx.to(cuda_device), n)
    first = segment_sum(vals.to(cuda_device), plan)
    again = segment_sum(vals.to(cuda_device), segment_plan(idx.to(cuda_device), n))
    assert torch.equal(first, again)
    assert torch.equal(first.cpu(), want)


def test_solvers_on_card_repeat_bit_for_bit(cuda_device):
    from lpslam_tpu_torch.backend.ba import bundle_adjust_cg
    from lpslam_tpu_torch.eval.scaling import build_problem
    from lpslam_tpu_torch.geometry.camera import PinholeCamera
    from lpslam_tpu_torch.geometry.sim3 import sim3_exp

    cam = PinholeCamera.make(460.0, 460.0, 376.0, 240.0, device=cuda_device)
    runs = [bundle_adjust_cg(build_problem(32, 4096, 256, seed=1, device=cuda_device), cam,
                             iters=6) for _ in range(2)]
    assert float(runs[0].final_cost) < float(runs[0].initial_cost)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    m = _circle_map(cuda_device)
    S = sim3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.01, 0.05], device=cuda_device))
    outs = [detector.correct_loop(m, 11, 1, S.R, S.t, S.s, min_shared=5) for _ in range(2)]
    for k in ("kf_R", "kf_t", "lm_pos"):
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k


def _pose_problem(device, n, seed):
    """A pose off the one that projects n landmarks to their pixels, with
    pixel noise, outliers, invalid rows and variances of three levels."""
    from lpslam_tpu_torch.geometry.camera import PinholeCamera
    from lpslam_tpu_torch.geometry.se3 import SE3
    from lpslam_tpu_torch.geometry.so3 import so3_exp

    rng = np.random.default_rng(seed)
    p_w = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 6, (n, 1))], 1)
    uv = p_w[:, :2] / p_w[:, 2:] * 380.0 + [320.0, 240.0] + rng.normal(0, 0.7, (n, 2))
    uv[: n // 10] += rng.uniform(-40, 40, (n // 10, 2))
    valid = torch.from_numpy(rng.uniform(size=n) > 0.05).to(device)

    def T(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    turn = rng.normal(0, 0.02, 3)
    pose0 = SE3(so3_exp(T(turn)), T(rng.normal(0, 0.04, 3)))
    cam = PinholeCamera.make(380.0, 380.0, 320.0, 240.0, device=device)
    return pose0, cam, T(p_w), T(uv), valid, T(1.44 ** rng.integers(0, 3, n))


def _fields(res):
    return (*res.pose, *res[1:])


def _assert_equal_results(got, want):
    for name, a, b in zip(("R", "t", *want._fields[1:]), _fields(got), _fields(want)):
        assert a.device == b.device and torch.equal(a, b), name


@pytest.mark.parametrize("case", ["track_frame", "relocalize"])
def test_graphed_pose_opt_equals_eager(cuda_device, monkeypatch, case):
    from lpslam_tpu_torch.frontend import pose_opt

    monkeypatch.setattr(pose_opt, "_GRAPHS", {})
    if case == "relocalize":
        pose0, cam, p_w, uv, valid, _ = _pose_problem(cuda_device, 1200, 3)
        ones = torch.ones_like(uv[:, 0])
        got = pose_opt.pose_only_optimize(pose0, cam, p_w, uv, valid, sigma2=ones, iters=8)
        want = pose_opt._pose_only_optimize_eager(pose0, cam, p_w, uv, valid, ones, 8)
        _assert_equal_results(got, want)
        assert len(pose_opt._GRAPHS) == 1 and int(got.n_inliers) > 900
        return
    pose0, cam, p_w, uv, valid, s2 = _pose_problem(cuda_device, 4096, 2)
    for rnd in range(2):                  # the second round replays, captures nothing
        got = pose_opt.pose_only_optimize(pose0, cam, p_w, uv, valid, sigma2=s2, iters=6)
        want = pose_opt._pose_only_optimize_eager(pose0, cam, p_w, uv, valid, s2, 6)
        _assert_equal_results(got, want)
        got = pose_opt.pose_only_optimize(got.pose, cam, p_w, uv, valid, sigma2=s2, iters=4)
        want = pose_opt._pose_only_optimize_eager(want.pose, cam, p_w, uv, valid, s2, 4)
        _assert_equal_results(got, want)
        assert len(pose_opt._GRAPHS) == 2 and int(got.n_inliers) > 3000


def test_graphed_pose_opt_results_survive_the_next_replay(cuda_device, monkeypatch):
    from lpslam_tpu_torch.frontend import pose_opt

    monkeypatch.setattr(pose_opt, "_GRAPHS", {})
    a = _pose_problem(cuda_device, 4096, 4)
    b = _pose_problem(cuda_device, 4096, 5)
    first = pose_opt.pose_only_optimize(*a, iters=6)
    kept = [x.clone() for x in _fields(first)]
    second = pose_opt.pose_only_optimize(*b, iters=6)
    assert len(pose_opt._GRAPHS) == 1
    for x, y in zip(_fields(first), kept):
        assert torch.equal(x, y)
    _assert_equal_results(first, pose_opt._pose_only_optimize_eager(*a, iters=6))
    _assert_equal_results(second, pose_opt._pose_only_optimize_eager(*b, iters=6))
    assert not torch.equal(first.pose.t, second.pose.t)
