"""How far the PyTorch port is from the JAX package on the CPU, per field.

    JAX_PLATFORMS=cpu python -m tests.torch_parity_report

Prints the largest absolute differences that the parity tests of
``tests/test_torch_pipeline.py``, ``tests/test_torch_models.py``,
``tests/test_torch_ops.py``, ``tests/test_torch_focus.py`` and
``tests/test_torch_pipeline_focus.py`` hold to their limits: the trained
CI stack's ``step`` and ``stream_batched`` against JAX, its batched
against its per-frame steps, the random-weight CI sizes, the estimator's
poses, the number of boxes whose homography is not bit-equal to XLA's,
and for focus the resize, the head-pose solve, the rotation vectors, the
normalization camera, the detector's forward on the face frames, bf16's
own error in the JAX nets, and the pipeline with focus. Not a test: it
reads the numbers from which the limits are set.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.ops import geometry as jg
from isbfsar_tpu.ops.image import bgr_to_i420
from isbfsar_tpu.runtime.source import SyntheticSource
from isbfsar_tpu.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch.focus import geometry as fg
from isbfsar_tpu_torch.focus.detector import resize_linear
from isbfsar_tpu_torch.kernel_bench import face_landmarks
from isbfsar_tpu_torch.ops import geometry as tg
from tests import test_torch_focus as tf
from tests import test_torch_models as tm
from tests import test_torch_pipeline as tp
from tests import test_torch_pipeline_focus as tpf


def report(what, ours, ref):
    diff = {}
    for a, b in zip(ours, ref, strict=True):
        for key in b:
            d = float(np.max(np.abs(np.asarray(a[key], np.float64) - np.asarray(b[key], np.float64))))
            diff[key] = max(diff.get(key, 0.0), d)
    print(f"[parity] {what}: " + " ".join(f"{k}={v:.3g}" for k, v in diff.items()), flush=True)


def pipelines():
    jpipe, pipe = tp._build(CI_FRAME_HW, CI_INTRINSICS, dict(yolo_input_size=128, crop_size=128),
                            pretrained.load("pose-ci-motions"), (tp.JAX_V2_TINY, tp.V2_TINY, 0.25))
    clip, _ = render_motion_clip("wave", n_frames=20, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=2.0)
    frames = [bgr_to_i420(f) for f in clip]
    jpipe.start()
    ref = [jpipe.step(f) for f in frames]
    jpipe.start()
    ref_batched = list(jpipe.stream_batched(frames, 8))
    pipe.start()
    ours = [pipe.step(f) for f in frames]
    pipe.start()
    ours_batched = list(pipe.stream_batched(frames, 8))
    report("trained CI step vs JAX", ours, ref)
    report("trained CI stream_batched vs JAX", ours_batched, ref_batched)
    report("trained CI stream_batched vs step", ours_batched, ours)

    jpipe, pipe = tp._build((120, 160), jc.CameraIntrinsics(width=160, height=120),
                            dict(yolo_input_size=128, crop_size=256, yolo_thresh=0.0), None,
                            (tp.JAX_V2_TINY, tp.V2_TINY, 0.25))
    src = SyntheticSource(160, 120)
    frames = [bgr_to_i420(src.read()[1]) for _ in range(18)]
    jpipe.start()
    pipe.start()
    report("random CI sizes vs JAX", [pipe.step(f) for f in frames], [jpipe.step(f) for f in frames])


def estimator():
    jax_est, ours = tm.ci_estimators.__wrapped__(pretrained.load("pose-ci-motions"))
    frames, _ = render_motion_clip("wave", n_frames=6, frame_hw=CI_FRAME_HW, intrinsics=CI_INTRINSICS)
    with torch.no_grad():
        pose = ours._estimate_impl(ours.nets, torch.from_numpy(np.stack(frames).astype(np.float32)))[0]
    d = max(float(np.abs(pose[i].numpy() - np.asarray(jax_est._estimate_jit(
        jax_est.params, jnp.asarray(f))[0])).max()) for i, f in enumerate(frames))
    print(f"[parity] estimator pose vs JAX: {d:.3g} m", flush=True)


def geometry(n: int = 300):
    for intr, out_dim in ((jc.CameraIntrinsics(), 256), (CI_INTRINSICS, 128)):
        k = intr.matrix().astype(np.float32)
        rng = np.random.default_rng(0)
        x1 = rng.integers(0, intr.width - 40, n)
        y1 = rng.integers(0, intr.height - 40, n)
        box = [v.astype(np.float32) for v in (
            x1, np.minimum(x1 + rng.integers(10, intr.width // 2, n), intr.width),
            y1, np.minimum(y1 + rng.integers(20, intr.height // 2, n), intr.height))]
        ref = jax.jit(jax.vmap(lambda *b: jg.warp_matrix(
            jnp.asarray(k), *(lambda nk, r: (nk[None], r))(*jg.virtual_camera(*b, jnp.asarray(k), out_dim)))[0]))
        h = tg.warp_matrix(torch.from_numpy(k), *tg.virtual_camera(
            *(torch.from_numpy(v) for v in box), torch.from_numpy(k), out_dim))
        unequal = int((h.numpy() != np.asarray(ref(*box))).any(axis=(1, 2)).sum())
        print(f"[parity] homography at {intr.width}x{intr.height}: {unequal} of {n} boxes "
              f"not bit-equal to XLA's", flush=True)


def focus():
    from isbfsar_tpu.focus import geometry as jfg

    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, (480, 640, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(frame), (128, 128, 3), "linear"))
    for aa in (True, False):
        x = torch.from_numpy(frame).permute(2, 0, 1)[None]
        ours = torch.nn.functional.interpolate(x, size=(128, 128), mode="bilinear",
                                               align_corners=False, antialias=aa)
        print(f"[parity] resize 480x640 -> 128 vs jax.image.resize, antialias={aa}: "
              f"{np.abs(ours[0].permute(1, 2, 0).numpy() - ref).max():.3g}", flush=True)
    assert resize_linear(torch.from_numpy(frame)[None], 128, 128).shape == (1, 128, 128, 3)

    k = tf.K
    lms = {"rendered": tf._rendered_landmarks(), "random faces": face_landmarks(64, rng),
           "uniform": rng.uniform([0, 0], [640, 480], (64, 6, 2)).astype(np.float32)}
    for name, lm in lms.items():
        jr, jc_ = tf._jax_head_pose(lm)
        r, c = fg.head_pose_from_landmarks(torch.from_numpy(lm), torch.from_numpy(k), 0.6)
        print(f"[parity] head pose ({name}) vs JAX: rot {np.abs(r.numpy() - jr).max():.3g}, "
              f"center {np.abs(c.numpy() - jc_).max():.3g} m", flush=True)
        rv = np.asarray(jax.vmap(jfg.rotmat_to_rotvec)(jnp.asarray(jr)))
        print(f"[parity] rotmat_to_rotvec ({name}) vs JAX: "
              f"{np.abs(fg.rotmat_to_rotvec(torch.from_numpy(jr)).numpy() - rv).max():.3g}", flush=True)
        jw, _ = jax.vmap(lambda v: jfg.normalization_camera(v, jnp.asarray(k), 0.6, 224))(
            jnp.asarray(jc_))
        w, _ = fg.normalization_camera(torch.from_numpy(jc_), torch.from_numpy(k), 0.6, 224)
        print(f"[parity] normalization_camera ({name}) vs JAX: warp "
              f"{np.abs(w.numpy() - np.asarray(jw)).max():.3g} of {np.abs(np.asarray(jw)).max():.3g}",
              flush=True)

    jd, td, frames = tf.detectors.__wrapped__(pretrained.load("focus-ci"))
    ref = jax.vmap(jd._forward_impl, in_axes=(None, 0))(jd.params, jnp.asarray(frames))
    ours = td._forward_impl(td.nets, torch.from_numpy(frames))
    print("[parity] FocusDetector forward vs JAX at CI_FOCUS_CFG: " + " ".join(
        f"{key}={np.abs(ours[key].float().numpy() - np.asarray(ref[key], np.float32)).max():.3g}"
        for key in ref), flush=True)

    from isbfsar_tpu.models import gaze as jgaze
    params = pretrained.load("focus-ci")
    for name, (jmod, _, size) in tf.NETS.items():
        x = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (2, size, size, 3)), jnp.float32)
        lo = jmod(dtype=jnp.bfloat16).apply(params[name], x)
        hi = jmod(dtype=jnp.float32).apply(params[name], x)
        lo, hi = (lo, hi) if isinstance(lo, tuple) else ((lo,), (hi,))
        print(f"[parity] JAX {name} bf16 vs float32: " + " ".join(
            f"{float(jnp.abs(a.astype(jnp.float32) - b).max()):.3g}" for a, b in zip(lo, hi)),
            flush=True)
    del jgaze

    pipe, frames, ref, _, ref_batched = tpf.focus_ci.__wrapped__()
    pipe.start()
    ours = [pipe.step(f) for f in frames]
    pipe.start()
    ours_batched = list(pipe.stream_batched(frames, 8))
    report("focus CI step vs JAX", ours, ref)
    report("focus CI stream_batched vs JAX", ours_batched, ref_batched)
    report("focus CI stream_batched vs step", ours_batched, ours)


if __name__ == "__main__":
    focus()
    geometry()
    estimator()
    pipelines()
