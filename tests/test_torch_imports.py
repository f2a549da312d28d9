"""The PyTorch port and chip_smoke.py import nothing that the GPU machine
lacks: no jax, jaxlib, flax, optax, msgpack, ml_dtypes, cv2, triton, orbax,
matplotlib or wandb, and nothing of the JAX package ``isbfsar_tpu``. A
subprocess refuses those imports, imports every module of the port and
chip_smoke, and runs the slice with focus on the CPU for one frame at CI
size, with seeded torch weights for the pose stack and the focus-ci bundle
read by the port's own decoder, then the serving layer on the same slice:
the orchestrator's fused and module paths for a frame each, and a
multi-stream step; an rgb and a hybrid step, each with the module path's
host crop; then the recognizer's training and evaluation: a
training epoch of 2 steps on a synthetic tree, a checkpoint written and
read back, and one FSOS repeat; then rgb training: a train step with remat
at a 32 crop, a PNG round trip, and a synthetic tree with PNG crops whose
clip the rgb loader reads; then a rendered humanoid clip, the humanoid
source, a 122-joint estimate with test-time augmentation, the extraction
of a PNG clip, the full YOLO postprocessing and the offline One-Euro; then
one step of each synthetic trainer (YOLO and heatmap with remat, the three
focus trainers, the gaze crop through the plain geometry), a bundle hit of
the parameter cache and the registry's ``verify``."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(r"""
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes", "cv2", "triton",
               "orbax", "matplotlib", "wandb", "isbfsar_tpu"}

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
    from isbfsar_tpu_torch import weights
    from isbfsar_tpu_torch.configs import CameraIntrinsics, HPEConfig, MainConfig, PipelineConfig
    from isbfsar_tpu_torch.focus.detector import FocusDetector
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.ops.image import bgr_to_i420
    from isbfsar_tpu_torch.pipeline import FusedPipeline
    from isbfsar_tpu_torch.profile_slice import CI_FOCUS_CFG

    hpe_cfg = HPEConfig(yolo_input_size=128, crop_size=256, yolo_thresh=0.0, compute_dtype="float32")
    intr = CameraIntrinsics(width=160, height=120)
    cfg = PipelineConfig(main=MainConfig(cam_width=160, cam_height=120), intrinsics=intr, hpe=hpe_cfg)
    hpe = HumanPoseEstimator(hpe_cfg, intr, seed=0, backbone_stages=V2_TINY, frame_shape=(120, 160),
                             yolo_width=0.25, device="cpu")
    focus = FocusDetector(CI_FOCUS_CFG, intr, params=weights.load_bundle("focus-ci"),
                          frame_shape=(120, 160), device="cpu")
    pipe = FusedPipeline(cfg, hpe=hpe, focus=focus, device="cpu")
    pipe.ar.train({"flag": "wave", "data": {"poses": np.ones((16, 90), np.float32)}})
    pipe.start()
    frame = bgr_to_i420(np.random.default_rng(0).integers(0, 256, (120, 160, 3), np.uint8))
    out = pipe.step(frame)
    assert out["pose"].shape == (30, 3) and np.isfinite(out["pose_abs"]).all()
    assert out["pose_ok"] in (0.0, 1.0) and abs(out["probs"].sum() - 1.0) < 1e-5
    assert out["f_found"] in (0.0, 1.0) and out["f_landmarks"].shape == (6, 2)
    assert all(np.isfinite(out[k]).all() for k in out if k.startswith("f_"))
    pipe.decode(out)

    from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator
    from isbfsar_tpu_torch.runtime.serve import parse_args
    from isbfsar_tpu_torch.serving import MultiStreamPipeline

    bgr = np.random.default_rng(1).integers(0, 256, (120, 160, 3), np.uint8)
    fused = Orchestrator(cfg, fused=pipe, fused_overlap=False)
    assert fused.get_frame(img=bgr)["fps"] > 0
    module = Orchestrator(cfg, hpe=hpe, focus=focus, ar=pipe.ar, device="cpu")
    assert "actions" in module.get_frame(img=bgr)
    multi = MultiStreamPipeline(n_streams=2, pipe=pipe)
    multi.start()
    assert len(multi.step(np.stack([frame, frame]))) == 2
    assert parse_args(["--fused"]).device == "cuda"

    # rgb (the detector alone) and hybrid: one fused step each, and the
    # module path's host crop with the numpy twin of cv2's resize
    import dataclasses
    from isbfsar_tpu_torch.configs import ARConfig
    for input_type in ("rgb", "hybrid"):
        rcfg = PipelineConfig(
            main=dataclasses.replace(MainConfig.for_input(input_type), cam_width=160, cam_height=120),
            intrinsics=intr, hpe=dataclasses.replace(hpe_cfg, just_box=input_type == "rgb"),
            ar=ARConfig.for_input(input_type, rgb_size=32))
        rhpe = HumanPoseEstimator(rcfg.hpe, intr, seed=0, backbone_stages=V2_TINY,
                                  frame_shape=(120, 160), yolo_width=0.25, device="cpu")
        rpipe = FusedPipeline(rcfg, hpe=rhpe, focus=focus, device="cpu")
        clip = {"imgs": np.zeros((8, 32, 32, 3), np.float32)}
        if input_type == "hybrid":
            clip["poses"] = np.ones((8, 90), np.float32)
        rpipe.ar.train({"flag": "wave", "data": clip})
        rpipe.start()
        out = rpipe.step(frame)
        assert all(np.isfinite(v).all() for v in out.values())
        assert (not out["pose"].any()) == (input_type == "rgb")
        module = Orchestrator(rcfg, hpe=rhpe, focus=focus, ar=rpipe.ar, device="cpu")
        assert module.get_frame(img=bgr)["img_preprocessed"].shape == (32, 32, 3)

    import tempfile
    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator
    from isbfsar_tpu_torch.train.fsos import evaluate_fsos
    from isbfsar_tpu_torch.train.synthetic import generate_dataset
    from isbfsar_tpu_torch.train.trainer import Trainer
    from isbfsar_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        generate_dataset(tmp + "/tree", n_classes=6, clips_per_class=2)
        ar_cfg = dataclasses.replace(ARConfig(), n_task=8, batch_size=4)
        trainer = Trainer(ar_cfg, log_dir=tmp + "/log", device="cpu")
        sampler = EpisodicSampler(tmp + "/tree", n_task=8, l=16, seed=0)
        summary = trainer.run_epoch(0, batch_iterator(sampler, 4), train=True)
        assert trainer.gradient_step == 2 and summary["train/fs_loss"] > 0
        path = checkpoint.save_checkpoint(tmp + "/ckpt", 0, trainer.state())
        trainer.load_state(checkpoint.load_checkpoint(
            path, {"params": None, "batch_stats": None, "opt_state": None}))
        res = evaluate_fsos(ar_cfg, trainer.params, tmp + "/tree", tmp + "/tree", n_repeats=1,
                            device="cpu")
        assert len(res["FSOS-ACC"]) == 1

        # rgb training with remat; the PNG codec and the rgb loader without cv2
        from isbfsar_tpu_torch.train.synthetic import episodic_batch
        from isbfsar_tpu_torch.utils import png
        rgb_cfg = ARConfig.for_input("rgb", rgb_size=32, batch_size=2, remat=True)
        trainer = Trainer(rgb_cfg, log_dir=tmp + "/rgb_log", device="cpu")
        metrics = trainer.step(episodic_batch(rgb_cfg, 2, 32, "rgb"))
        assert np.isfinite(float(metrics["fs_loss"])) and trainer.state()["batch_stats"]
        img = np.random.default_rng(2).integers(0, 256, (20, 30, 3), np.uint8)
        png.write_png(tmp + "/img.png", img)
        assert np.array_equal(png.read_png(tmp + "/img.png"), img)
        generate_dataset(tmp + "/rgb_tree", n_classes=2, clips_per_class=1, with_images=True,
                         image_size=32)
        clip = EpisodicSampler(tmp + "/rgb_tree", l=8, input_type="hybrid").load_clip(
            tmp + "/rgb_tree/action_00/0")
        assert clip["rgb"].shape == (8, 224, 224, 3) and clip["sk"].shape == (8, 90)

        # the humanoid renderer, its source, TTA with 122 joints, the full
        # YOLO postprocessing, the offline One-Euro and the extraction twin
        import torch
        from isbfsar_tpu_torch.ops.nms import postprocess_yolo
        from isbfsar_tpu_torch.ops.smooth import one_euro
        from isbfsar_tpu_torch.runtime.source import make_source
        from isbfsar_tpu_torch.tools.extract_dataset import extract_tree
        from isbfsar_tpu_torch.train.posestack import render_motion_clip
        from isbfsar_tpu_torch.utils.png import write_png
        frames, gts = render_motion_clip("wave", n_frames=3, frame_hw=(120, 160), intrinsics=intr)
        assert frames[0].shape == (120, 160, 3) and gts[0]["joints2d"].shape == (32, 2)
        ok, shot = make_source("humanoid", width=160, height=120, frames_per_motion=4).read()
        assert ok and shot.shape == (120, 160, 3)
        tta = HumanPoseEstimator(dataclasses.replace(hpe_cfg, skeleton=None, num_aug=5), intr,
                                 seed=0, backbone_stages=V2_TINY, frame_shape=(120, 160),
                                 yolo_width=0.25, device="cpu")
        assert tta.estimate(frames[0])["pose"].shape == (122, 3) and tta.edges is None
        for k, f in enumerate(frames):
            os.makedirs(f"{tmp}/frames/wave/0", exist_ok=True)
            write_png(f"{tmp}/frames/wave/0/{k}.png", f)
        import contextlib, io
        with contextlib.redirect_stdout(io.StringIO()):
            assert len(extract_tree(tta, tmp + "/frames", tmp + "/extracted", n_frames=4)) == 1
        dets, keep = postprocess_yolo(torch.rand(2, 100, 1, 4), torch.rand(2, 100, 80))
        assert dets.shape == (2, 64, 6) and keep.shape == (2, 64)
        assert np.array_equal(one_euro(np.ones((5, 3), np.float32)), np.ones((5, 3), np.float32))

        # the synthetic trainers: one step of each at a tiny size, a bundle
        # hit of the parameter cache and the registry's verify
        from isbfsar_tpu_torch import weights
        from isbfsar_tpu_torch.train import gazefocus as gf, posestack as ps
        from isbfsar_tpu_torch.utils.cache import cached_params
        sampler = ps.SyntheticHumanSampler((120, 160), intr, seed=0)
        det = ps.YoloTrainer(width=0.25, input_size=64, remat=True, device="cpu")
        norm = np.asarray([160, 120, 160, 120], np.float32)
        assert np.isfinite(det.train_step(ps.detector_batch(sampler, 2, 64, norm, 0.5)))
        pose = ps.HeatmapTrainer(intr, crop_size=64, stages=V2_TINY, remat=True, device="cpu")
        assert np.isfinite(pose.train_step(ps.pose_batch(sampler, 2, 0.08)))
        faces = gf.SyntheticFaceSampler((120, 160), seed=0)
        cfg = dataclasses.replace(gf.CI_FOCUS_CFG, gaze_image_size=32)
        assert np.isfinite(gf.BlazeFaceTrainer(cfg, device="cpu").train_step(
            gf.face_detector_batch(faces, 2)))
        assert np.isfinite(gf.LandmarkRefinerTrainer(cfg, device="cpu").train_step(
            gf.refiner_batch(faces, 2)))
        frames, lms, gazes = gf.gaze_batch(faces, 2, 0.005)
        crops, r_norm = gf.make_normalized_crop_fn(cfg, intr, with_rnorm=True, device="cpu")(
            frames, lms)
        assert np.isfinite(gf.GazeTrainer(cfg, device="cpu").train_step(
            {"crop": crops, "pitchyaw": gf.gaze_labels(gazes, r_norm)}))
        os.environ["ISBFSAR_TORCH_PARAMS_CACHE"] = tmp + "/params_cache"
        hit = cached_params(ps._CI_KEY_V[1](), lambda: 1 / 0, version=ps._CI_KEY_V[0])
        assert set(hit) == {"yolo", "bbone", "head"} and not os.path.exists(tmp + "/params_cache")
        assert len(weights.verify()) == 7
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
    assert int(proc.stdout.split()[-1]) >= 40  # every module of the port was imported
