"""The PyTorch port and chip_smoke.py import nothing that the GPU machine
lacks: no jax, jaxlib, flax, optax, msgpack, ml_dtypes, cv2 or triton, and
nothing of the JAX package ``isbfsar_tpu``. A subprocess refuses those
imports, imports every module of the port and chip_smoke, and runs the
slice on the CPU for one frame at CI size with seeded torch weights."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(r"""
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes", "cv2", "triton",
               "isbfsar_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, os.environ["REPO"])

    import isbfsar_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(isbfsar_tpu_torch.__path__, "isbfsar_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401  (main() is not run)

    import numpy as np
    from isbfsar_tpu_torch.configs import CameraIntrinsics, HPEConfig, MainConfig, PipelineConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.ops.image import bgr_to_i420
    from isbfsar_tpu_torch.pipeline import FusedPipeline

    hpe_cfg = HPEConfig(yolo_input_size=128, crop_size=256, yolo_thresh=0.0, compute_dtype="float32")
    intr = CameraIntrinsics(width=160, height=120)
    cfg = PipelineConfig(main=MainConfig(cam_width=160, cam_height=120), intrinsics=intr, hpe=hpe_cfg)
    hpe = HumanPoseEstimator(hpe_cfg, intr, seed=0, backbone_stages=V2_TINY, frame_shape=(120, 160),
                             yolo_width=0.25, device="cpu")
    pipe = FusedPipeline(cfg, hpe=hpe, device="cpu")
    pipe.ar.train({"flag": "wave", "data": {"poses": np.ones((16, 90), np.float32)}})
    pipe.start()
    frame = bgr_to_i420(np.random.default_rng(0).integers(0, 256, (120, 160, 3), np.uint8))
    out = pipe.step(frame)
    assert out["pose"].shape == (30, 3) and np.isfinite(out["pose_abs"]).all()
    assert out["pose_ok"] in (0.0, 1.0) and abs(out["probs"].sum() - 1.0) < 1e-5
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK", len(names))
""")


def test_port_and_chip_smoke_import_nothing_the_gpu_machine_lacks():
    env = {**os.environ, "REPO": REPO}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")
    assert int(proc.stdout.split()[-1]) >= 20  # every module of the port was imported
