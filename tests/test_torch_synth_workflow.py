"""The port's offline workflow tools against the JAX package's:
``isbfsar_tpu_torch/tools/extract_dataset.py`` against
``tools/extract_dataset.py`` (JAX's estimator and ``one_euro``) on the same
frames, its resume and completeness rules, and
``isbfsar_tpu_torch/tools/synth_workflow.py``'s manifest refusals and a
tiny end-to-end run whose receipt has the JAX tool's keys.

JAX's extraction reads videos with cv2; here its ``cv2.VideoCapture`` is
replaced by one that hands out the port's PNG frames, so both tools see
identical frames (the JAX workflow's ``mp4v`` codec loss is left out)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.train.posestack import CI_INTRINSICS as JAX_CI_INTRINSICS
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.tools import extract_dataset as ext
from isbfsar_tpu_torch.tools import synth_workflow as wf
from isbfsar_tpu_torch.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch.utils.png import write_png

N_FRAMES = 8
# The workflow's estimator (tools/synth_workflow.py: 128 YOLO input, 256
# crop, the 0.3 gate, 122 joints), compared stage by stage in float32,
# where the packages read 1.2e-6 m. In its bf16 default XLA's and oneDNN's
# convolutions round in other places: the detector's box moves 1-6 px on
# most frames and the crop, and so the pose, follow it (on the workflow's
# CI clip library the packages' bf16 poses part by up to 0.23 m, and by
# 0.039 m with JAX's box given to the port). So the bf16 run is held to
# JAX's float32 within BF16_FACTOR times JAX's own bf16 error there: on
# these clips the port reads 0.90 times it at the largest frame and 0.84
# times it on the mean.
EXTRACT_KW = dict(yolo_input_size=128, crop_size=256, yolo_thresh=0.3, skeleton=None,
                  compute_dtype="float32")
TOL_POSE = 1e-4
BF16_FACTOR = 1.5
# the keys of tools/synth_workflow.py::run_workflow's receipt
RECEIPT_KEYS = {"train_classes", "test_classes", "clips_per_class", "exemplar_clips",
                "fingerprint", "skipped_clips", "smooth", "way", "seq_len", "epochs",
                "train_fs_acc", "train_os_acc", "fsos", "fsos_std", "os_calibration",
                "fsos_calibrated", "wall_s"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def diverse():
    """The extraction-grade stack as numpy trees, which both packages take."""
    return pretrained.load("pose-diverse-256")


@pytest.fixture(scope="module")
def frames_root(tmp_path_factory):
    """Two classes of PNG clips: rendered motions, one clip with empty frames
    in between (a failing frame reuses the last pose) and one with no
    person at all (skipped)."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    empty = [rng.integers(20, 90, CI_FRAME_HW + (3,)).astype(np.uint8) for _ in range(12)]
    clips = {}
    for ci, motion in enumerate(("wave", "squat")):
        for k in range(2):
            frames, _ = render_motion_clip(motion, n_frames=12, frame_hw=CI_FRAME_HW,
                                           intrinsics=CI_INTRINSICS, seed=ci * 10 + k,
                                           center=(0.1 * k, 0.15, 2.1), cycles=1.5)
            clips[(motion, f"c{k}")] = frames
    wave = clips[("wave", "c0")]
    clips[("wave", "c2")] = [wave[i] if i % 3 == 0 else empty[i] for i in range(12)]
    clips[("squat", "c2")] = empty
    for (motion, name), frames in clips.items():
        d = root / motion / name
        os.makedirs(d)
        for i, f in enumerate(frames):
            write_png(str(d / f"{i}.png"), f)
    return str(root)


def _port_estimator(params):
    return HumanPoseEstimator(tc.HPEConfig(**EXTRACT_KW), CI_INTRINSICS, params=params,
                              backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25,
                              device="cpu")


def test_extraction_matches_jax_on_the_same_frames(diverse, frames_root, tmp_path, monkeypatch):
    import cv2

    from tools import extract_dataset as jax_ext

    class Capture:
        """cv2.VideoCapture over a port clip dir named by the video path."""

        def __init__(self, path):
            self.frames = ext.load_clip_frames(path[:-len(".avi")])

        def get(self, prop):
            assert prop == cv2.CAP_PROP_FRAME_COUNT
            return len(self.frames)

        def read(self):
            return (True, self.frames.pop(0)) if self.frames else (False, None)

        def release(self):
            pass

    # the JAX tool walks <class>/<clip>.avi and opens each with the capture
    videos = tmp_path / "videos"
    for motion in sorted(os.listdir(frames_root)):
        os.makedirs(videos / motion)
        for clip in sorted(os.listdir(os.path.join(frames_root, motion))):
            (videos / motion / f"{clip}.avi").write_bytes(b"")
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda p: Capture(os.path.join(frames_root, os.path.relpath(p, videos))))
    jax_est = JaxEstimator(jc.HPEConfig(**EXTRACT_KW), JAX_CI_INTRINSICS, params=diverse,
                           backbone_stages=JAX_V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25)
    jax_ext.extract_tree(jax_est, str(videos), str(tmp_path / "jax"), N_FRAMES, smooth=True)
    written = ext.extract_tree(_port_estimator(diverse), frames_root, str(tmp_path / "port"),
                               N_FRAMES, smooth=True)

    assert len(written) == 5  # squat/c2 holds no person
    for motion in ("wave", "squat"):
        assert sorted(os.listdir(tmp_path / "port" / motion)) == sorted(
            os.listdir(tmp_path / "jax" / motion))
    assert os.path.exists(tmp_path / "port" / "squat" / ".skip_2")
    for clip_dir in written:
        rel = os.path.relpath(clip_dir, tmp_path / "port")
        for i in range(N_FRAMES):
            ours = np.load(os.path.join(clip_dir, f"{i}.npy"))
            ref = np.load(str(tmp_path / "jax" / rel / f"{i}.npy"))
            assert ours.shape == ref.shape == (122, 3) and ours.dtype == np.float32
            np.testing.assert_allclose(ours, ref, atol=TOL_POSE, rtol=0, err_msg=f"{rel} {i}")
    # the clip with empty frames reused earlier poses: consecutive repeats
    # before smoothing make the smoothed sequence move less than a full clip
    assert np.load(os.path.join(tmp_path / "port" / "wave" / "2" / "0.npy")).any()


def test_bf16_extraction_error_near_jax_own_bf16_error(diverse, frames_root):
    """The estimator as the workflow runs it, in bf16, against JAX's in
    float32 on the rendered clips: the port's error is held within
    ``BF16_FACTOR`` times the error JAX's own bf16 makes, by the largest
    and by the mean over the frames JAX's float32 finds a person on."""
    jax_est = {dtype: JaxEstimator(jc.HPEConfig(**{**EXTRACT_KW, "compute_dtype": dtype}),
                                   JAX_CI_INTRINSICS, params=diverse, backbone_stages=JAX_V2_TINY,
                                   frame_shape=CI_FRAME_HW, yolo_width=0.25)
               for dtype in ("float32", "bfloat16")}
    ours = HumanPoseEstimator(tc.HPEConfig(**{**EXTRACT_KW, "compute_dtype": "bfloat16"}),
                              CI_INTRINSICS, params=diverse, backbone_stages=V2_TINY,
                              frame_shape=CI_FRAME_HW, yolo_width=0.25, device="cpu")
    err_jax, err_port = [], []
    for motion in ("wave", "squat"):
        for clip in ("c0", "c1"):
            frames = ext.load_clip_frames(os.path.join(frames_root, motion, clip))
            with torch.no_grad():
                pose = ours._estimate_impl(
                    ours.nets, torch.from_numpy(np.stack(frames).astype(np.float32)))[0].numpy()
            for i, f in enumerate(frames):
                ref, _, _, found, _ = jax_est["float32"]._estimate_jit(
                    jax_est["float32"].params, jnp.asarray(f))
                if not bool(found):
                    continue
                bf16 = jax_est["bfloat16"]._estimate_jit(jax_est["bfloat16"].params,
                                                         jnp.asarray(f))[0]
                err_jax.append(float(np.abs(np.asarray(bf16) - np.asarray(ref)).max()))
                err_port.append(float(np.abs(pose[i] - np.asarray(ref)).max()))
    err_jax, err_port = np.array(err_jax), np.array(err_port)
    assert len(err_jax) >= 40
    assert err_port.max() <= BF16_FACTOR * err_jax.max()
    assert err_port.mean() <= BF16_FACTOR * err_jax.mean()


def test_extract_clip_reuse_padding_and_images(diverse, frames_root):
    est = _port_estimator(diverse)
    frames = ext.load_clip_frames(os.path.join(frames_root, "wave", "c2"))
    poses, crops = ext.extract_clip(est, frames, N_FRAMES, with_images=True)
    assert len(poses) == len(crops) == N_FRAMES
    assert all(c.shape == (224, 224, 3) and c.dtype == np.uint8 for c in crops)
    # picks 0, 1, 3, 4, 6, 7, 9, 11 of 12 frames, of which 0, 3, 6, 9 hold
    # the person: each odd pick reuses the pose before it
    for i in (1, 3, 5, 7):
        np.testing.assert_array_equal(poses[i], poses[i - 1])
        np.testing.assert_array_equal(crops[i], crops[i - 1])
    assert not np.array_equal(poses[0], poses[2])
    # fewer frames than picks: the tail repeats the last pose
    short, _ = ext.extract_clip(est, frames[:1], 4, with_images=False)
    assert len(short) == 4 and all(np.array_equal(p, short[0]) for p in short)
    assert ext.extract_clip(est, [], 4, False) is None
    assert ext.extract_clip(est, ext.load_clip_frames(os.path.join(frames_root, "squat", "c2")),
                            4, False) is None


def test_extract_tree_resume_and_completeness(diverse, frames_root, tmp_path):
    """Done: a .skip marker and a clip dir with its last npy (and, with
    images, its last png); a partial clip dir re-extracts; a stray entry
    counts for nothing."""
    est = _port_estimator(diverse)
    out = tmp_path / "tree"
    os.makedirs(out / "wave" / "1")
    np.save(str(out / "wave" / "1" / "0.npy"), np.zeros((122, 3), np.float32))  # partial
    os.makedirs(out / "wave" / "0")
    for i in range(N_FRAMES):  # complete without images, incomplete with them
        np.save(str(out / "wave" / "0" / f"{i}.npy"), np.zeros((122, 3), np.float32))
    (out / "wave" / ".DS_Store").write_bytes(b"")
    (out / "wave" / ".skip_2").write_bytes(b"")
    os.makedirs(out / "squat")
    (out / "squat" / ".skip_0").write_bytes(b"")
    written = ext.extract_tree(est, frames_root, str(out), N_FRAMES)
    rel = sorted(os.path.relpath(w, out) for w in written)
    assert rel == ["squat/1", "wave/1"]
    assert np.load(str(out / "wave" / "0" / "0.npy")).sum() == 0  # kept
    assert ext.extract_tree(est, frames_root, str(out), N_FRAMES) == []
    # with images, wave/0 lacks its last png: re-extracted, crops written
    written = ext.extract_tree(est, frames_root, str(out), N_FRAMES, with_images=True)
    assert sorted(os.path.relpath(w, out) for w in written) == ["squat/1", "wave/0", "wave/1"]
    assert os.path.exists(out / "wave" / "0" / f"{N_FRAMES - 1}.png")


def test_workdir_manifest_refusals(diverse, tmp_path):
    kw = dict(frame_hw=CI_FRAME_HW, intrinsics=CI_INTRINSICS, n_epochs=0, log=False,
              device="cpu")
    work = tmp_path / "work"
    os.makedirs(work)
    (work / "manifest.json").write_text('{"fingerprint": "0123456789abcdef"}')
    with pytest.raises(ValueError, match="different configuration"):
        wf.run_workflow(diverse, str(work), **kw)
    legacy = tmp_path / "legacy"
    os.makedirs(legacy / "tree_train")
    with pytest.raises(ValueError, match="no manifest.json"):
        wf.run_workflow(diverse, str(legacy), **kw)
    fp = wf.workflow_fingerprint(diverse, seed=0)
    assert fp == wf.workflow_fingerprint(diverse, seed=0) != wf.workflow_fingerprint(diverse,
                                                                                       seed=1)


def test_tiny_workflow_writes_a_receipt_with_jax_keys(diverse, tmp_path):
    """6 + 6 classes of one 16-frame clip (the FSOS loader reads 16 frames),
    one epoch of 2 steps, one FSOS repeat, at the bf16 default."""
    classes = ("wave", "squat", "walk", "clap", "bow", "lean")
    receipt = wf.run_workflow(
        diverse, str(tmp_path / "wf"), CI_FRAME_HW, CI_INTRINSICS, train_classes=classes,
        test_classes=("march", "punch_l", "twist", "shrug", "sway", "touch_head"),
        clips_per_class=1, exemplar_clips=1, n_frames=16, seq_len=8, n_epochs=1,
        n_task=4, batch_size=2, fsos_repeats=1, log=False, device="cpu")
    assert set(receipt) == RECEIPT_KEYS
    assert receipt["train_classes"] == 6 and receipt["epochs"] == 1
    assert set(receipt["fsos"]) == {"FSOS-ACC", "FS-ACC", "OS-ACC"}
    assert set(receipt["wall_s"]) == {"render", "extract", "train", "fsos_eval"}
    # a second run resumes the renders and trees under the same manifest
    again = wf.run_workflow(
        diverse, str(tmp_path / "wf"), CI_FRAME_HW, CI_INTRINSICS, train_classes=classes,
        test_classes=("march", "punch_l", "twist", "shrug", "sway", "touch_head"),
        clips_per_class=1, exemplar_clips=1, n_frames=16, seq_len=8, n_epochs=1,
        n_task=4, batch_size=2, fsos_repeats=1, log=False, device="cpu")
    assert again["fingerprint"] == receipt["fingerprint"]
    assert again["wall_s"]["extract"] < receipt["wall_s"]["extract"]


def test_production_refuses_without_the_base(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(weights, "bundle_path", lambda name, *a: str(tmp_path / "missing"))
    assert wf.main(["--production", "--device", "cpu", "--workdir", str(tmp_path / "w")]) == 2
    assert "pose-prod-256" in capsys.readouterr().err
