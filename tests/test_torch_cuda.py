"""The PyTorch port's CUDA kernels and CUDA graphs on the GPU (skeleton,
rgb and hybrid steps), and its recognizer trainer and evaluators on the
card against the CPU. Every test here
needs an NVIDIA GPU and nvcc and skips elsewhere. The file imports neither
JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import time

import numpy as np
import pytest
import torch

from isbfsar_tpu_torch.configs import CameraIntrinsics
from isbfsar_tpu_torch.focus import geometry
from isbfsar_tpu_torch.kernel_bench import (TOL_HEAD, face_landmarks, head_pose_errors,
                                            newton_steps)
from isbfsar_tpu_torch.ops import fused_input, head_pose
from isbfsar_tpu_torch.ops.image import bgr_to_i420

pytestmark = pytest.mark.cuda

SHAPES = [(480, 640, 256), (240, 320, 128), (120, 160, 128)]  # H, W, S


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ci_pipes():
    """The trained CI stacks with focus on the card, with CUDA graphs and
    eager, sharing the nets and the support set, and 18 frames at their
    size, smoke and face frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: CUDA graphs have no CPU mode")
    from isbfsar_tpu_torch.profile_slice import build_ci, ci_frames, twin

    graphs = build_ci("cuda", cuda_graphs=True, with_focus=True)
    return graphs, twin(graphs, cuda_graphs=False), ci_frames(18, faces=True)


def _frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([bgr_to_i420(rng.integers(0, 256, (h, w, 3), np.uint8)) for _ in range(b)])


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("h,w,s", SHAPES)
def test_kernel_matches_plain_version(cuda, h, w, s, b):
    yuv = torch.from_numpy(_frames(b, h, w)).to(cuda)
    before = fused_input.fused_i420_inputs.launches
    bgr, yolo = fused_input.fused_i420_inputs(yuv, h, s)
    ref_bgr, ref_yolo = fused_input.fused_i420_reference(yuv, h, s)
    torch.cuda.synchronize()
    assert fused_input.fused_i420_inputs.launches == before + 1
    assert bgr.shape == (b, h, w, 3) and yolo.shape == (b, 1, s, s, 3)
    torch.testing.assert_close(bgr, ref_bgr, atol=0, rtol=0)
    torch.testing.assert_close(yolo, ref_yolo, atol=1e-5, rtol=0)
    assert yolo[:, 0].permute(0, 3, 1, 2).is_contiguous()


def test_single_frame_layout(cuda):
    yuv = torch.from_numpy(_frames(1, 120, 160)[0]).to(cuda)
    bgr, yolo = fused_input.fused_i420_inputs(yuv, 120, 128)
    assert bgr.shape == (120, 160, 3) and yolo.shape == (1, 128, 128, 3)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "rows", "odd_height", "width",
                                 "shared_memory"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    yuv = torch.from_numpy(_frames(2, 120, 160)).to(cuda)
    height, size = 120, 128
    if bad == "dtype":
        yuv = yuv.to(torch.int32)
    elif bad == "contiguity":
        yuv = yuv.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rows":
        yuv = yuv[:, :-2].contiguous()
    elif bad == "odd_height":
        height = 118
    elif bad == "width":  # the bulk copies need rows of a multiple of 32 bytes
        yuv = torch.zeros((1, 180, 176), dtype=torch.uint8, device=cuda)
    else:  # one output row's band of 64 source rows of 2048 pixels does not fit
        yuv, height, size = torch.zeros((1, 1536, 2048), dtype=torch.uint8, device=cuda), 1024, 16
    before = fused_input.fused_i420_inputs.launches
    with pytest.raises(ValueError):
        fused_input.fused_i420_inputs(yuv, height, size)
    assert fused_input.fused_i420_inputs.launches == before


def _run(pipe, frames):
    pipe.start()
    outs = [pipe.step(f) for f in frames]
    pipe.start()
    return outs + list(pipe.stream_batched(frames, 8))  # batches of 8 and a tail of 2


def test_graph_replay_equals_eager(ci_pipes):
    graphs, eager, frames = ci_pipes
    ours, ref = _run(graphs, frames), _run(eager, frames)
    assert sorted(graphs._graphs) == [1, 8] and all(g.graph is not None for g in graphs._graphs.values())
    assert not eager._graphs
    for i, (a, b) in enumerate(zip(ours, ref, strict=True)):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"output {i} {key}")


def test_tta_graph_replay_equals_eager(cuda):
    """num_aug=5 ("mean") inside the graphed step at the CI size: the
    augmentations' tensors live on the card, so capture takes the step and
    the replays equal the eager step, bit for bit."""
    from isbfsar_tpu_torch.profile_slice import build_ci, ci_frames, twin

    graphs = build_ci("cuda", cuda_graphs=True, hpe_overrides={"num_aug": 5})
    eager = twin(graphs, cuda_graphs=False)
    frames = ci_frames(18, faces=True)
    ours, ref = _run(graphs, frames), _run(eager, frames)
    assert sorted(graphs._graphs) == [1, 8]
    for i, (a, b) in enumerate(zip(ours, ref, strict=True)):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"output {i} {key}")
    assert any(o["pose_ok"] for o in ours)


def test_launches_are_counted_under_replay(ci_pipes):
    graphs, _, frames = ci_pipes
    graphs.step(frames[0])  # B=1 is captured by now
    kernels = (fused_input.fused_i420_inputs, head_pose.focus_geometry)
    assert [graphs._graphs[1].launches[k] for k in kernels] == [1, 1]
    before = [k.launches for k in kernels]
    outs = [graphs.step(f) for f in frames[:4]]
    assert [k.launches for k in kernels] == [n + 4 for n in before]
    # the kernels are in the graph: what the detectors see follows the frame
    confs = [float(o["conf"]) for o in outs]
    again = graphs.step(frames[0])
    assert len(set(confs)) > 1 and float(again["conf"]) == confs[0]
    assert len({tuple(o["f_head_position"]) for o in outs}) == 4
    np.testing.assert_array_equal(again["f_head_position"], outs[0]["f_head_position"])


# The focus-geometry kernel (head pose by QCP in float64, then the geometry
# after it) against its plain version (float32, cuSOLVER's SVD) on the same
# card, at kernel_bench.TOL_HEAD (rotation 1e-5, center 5e-6 of its
# distance, and the limits of the other four outputs, with their reasons).


def _k(device):
    return torch.from_numpy(CameraIntrinsics().matrix()).to(device)


def _check(err, what=""):
    assert all(err[f] <= TOL_HEAD[f] for f in TOL_HEAD), (what, err)


@pytest.mark.parametrize("b", [1, 8, 16])
def test_head_pose_kernel_matches_plain_version(cuda, b):
    lms = torch.from_numpy(face_landmarks(b, np.random.default_rng(b))).to(cuda)
    before = head_pose.focus_geometry.launches
    err = head_pose_errors(lms, _k(cuda))
    torch.cuda.synchronize()
    assert head_pose.focus_geometry.launches == before + 1
    assert set(err) == set(TOL_HEAD)
    _check(err)


def test_head_pose_kernel_on_face_frames_and_degenerate_landmarks(cuda):
    """The committed frames' true landmarks (both sizes, through their own
    intrinsics and at their crop sizes) and six landmarks at one pixel, the
    principal point among them: finite, the identity rotation in the
    degenerate case, and every output equal to the plain version."""
    from isbfsar_tpu_torch.profile_slice import CI_INTRINSICS, focus_frames

    for height, intr, size in ((480, CameraIntrinsics(), 224), (240, CI_INTRINSICS, 64)):
        k = torch.from_numpy(intr.matrix()).to(cuda)
        lms = torch.from_numpy(focus_frames(height)["landmarks"]).to(cuda)
        _check(head_pose_errors(lms, k, size), height)
    k = _k(cuda)
    pts = torch.tensor([[320.0, 240.0], [100.3, 50.7], [float(k[0, 2]), float(k[1, 2])]])
    lms = pts[:, None].expand(-1, 6, -1).contiguous().to(cuda)
    out = head_pose.focus_geometry(lms, k)
    assert all(torch.isfinite(t).all() for t in out)
    torch.testing.assert_close(out.rot, torch.eye(3, device=cuda).expand(3, 3, 3), atol=0, rtol=0)
    _check(head_pose_errors(lms, k))


def test_head_pose_newton_steps_and_the_plain_solve(cuda):
    """The kernel reports its Newton steps (the data-dependent work the
    bound counts): at least one per iteration and under the cap in every
    iteration on real faces, none on a degenerate frame."""
    k = _k(cuda)
    lms = torch.from_numpy(face_landmarks(4, np.random.default_rng(0))).to(cuda)
    lms[3] = 200.0
    steps = newton_steps(lms, k)
    assert (steps[:3, 0] >= 40).all() and (steps[:3, 1] < head_pose.MAX_NEWTON).all()
    assert steps[3].tolist() == [0, 0]
    out = head_pose.focus_geometry_reference(lms.cpu(), k.cpu())
    assert all(torch.isfinite(t).all() for t in out)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "intrinsics", "device", "steps",
                                 "iters", "out_size"])
def test_head_pose_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    lms = torch.from_numpy(face_landmarks(2, np.random.default_rng(0))).to(cuda)
    k = _k(cuda)
    kwargs = {}
    if bad == "dtype":
        lms = lms.double()
    elif bad == "shape":
        lms = lms[:, :5].contiguous()
    elif bad == "contiguity":
        lms = lms.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "intrinsics":
        k = k[:2]
    elif bad == "device":
        k = k.cpu()
    elif bad == "steps":  # one count per frame where the kernel writes two
        kwargs["steps"] = torch.zeros(2, dtype=torch.int32, device=cuda)
    elif bad == "iters":
        kwargs["iters"] = 0
    else:
        kwargs["out_size"] = 0
    before = head_pose.focus_geometry.launches
    with pytest.raises(ValueError):
        head_pose.focus_geometry(lms, k, **kwargs)
    assert head_pose.focus_geometry.launches == before


# The serving surface on the card: the overlap waits for the frame it reads
# and no other, results already handed out stay put, the module path's
# dispatch does not wait for the card, and the multi-stream graphs equal
# their eager steps.


def _busy(seconds: float = 0.5) -> None:
    """Keep the current stream busy for about ``seconds`` (a 2 GHz clock)."""
    torch.cuda._sleep(int(seconds * 2e9))


def test_overlap_fetches_without_a_full_sync(ci_pipes):
    graphs, _, frames = ci_pipes
    graphs.start()
    graphs.step(frames[0])  # B=1 is captured
    graphs.start()
    first = graphs.dispatch(frames[0])
    second = graphs.dispatch(frames[1])
    _busy()
    out = graphs.fetch(first)
    assert not torch.cuda.current_stream().query(), "fetch waited for the later work"
    held = {k: np.copy(v) for k, v in out.items()}
    graphs.fetch(second)
    for f in frames[2:4]:  # later replays reuse the static output
        graphs.fetch(graphs.dispatch(f))
    for k, v in held.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    graphs.start()
    np.testing.assert_array_equal(graphs.step(frames[0])["pose"], held["pose"])


@pytest.mark.parametrize("module", ["hpe", "focus"])
def test_estimate_async_does_not_wait_for_the_card(ci_pipes, module):
    """The module path's dispatch (the upload, the eager forward, the
    packed result's host copy) makes no call that waits for the card:
    PyTorch's sync debug mode raises on one, and the stream is still busy
    after it. One module at a time: the eager forwards launch kernels one
    by one, and two of them behind the busy stream fill the launch queue,
    whose backpressure waits too (a reason to graph the module path)."""
    from isbfsar_tpu_torch.ops.image import i420_to_bgr
    from isbfsar_tpu_torch.utils.transfer import to_device

    graphs, _, frames = ci_pipes
    det = getattr(graphs, module)
    h = graphs.hpe.frame_shape[0]
    bgr = torch.round(i420_to_bgr(torch.from_numpy(frames[1]), h)).to(torch.uint8).numpy()
    for _ in range(3):  # warm: a first call's allocations wait for the card
        det.estimate_collect(det.estimate_async(to_device(bgr, det.device)))
    torch.cuda.synchronize()
    _busy()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        token = det.estimate_async(to_device(bgr, det.device))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_s = time.perf_counter() - t
    assert not torch.cuda.current_stream().query(), f"the dispatch took {host_s:.3f} s"
    res = det.estimate_collect(token)
    if module == "hpe":
        assert res is None or res["pose"].shape == (30, 3)
    else:
        assert res is not None  # a face frame


def test_multistream_graphs_equal_eager(ci_pipes):
    from isbfsar_tpu_torch.serving import MultiStreamPipeline

    graphs, eager, frames = ci_pipes
    ticks = [np.stack([frames[(i + 3 * s) % len(frames)] for s in range(3)]) for i in range(10)]
    runs, multis = [], []
    for pipe in (graphs, eager):
        m = MultiStreamPipeline(n_streams=3, pipe=pipe)
        multis.append(m)
        m.start()
        before = [k.launches for k in (fused_input.fused_i420_inputs, head_pose.focus_geometry)]
        out = [m.step(t) for t in ticks[:2]]
        out += list(m.stream_batched(iter(ticks[2:10]), batch_size=4))
        out.append(m.step(ticks[0]))  # the B=1 graph again
        after = [k.launches for k in (fused_input.fused_i420_inputs, head_pose.focus_geometry)]
        assert [a - b for a, b in zip(after, before)] == [5, 5]  # one per dispatch
        runs.append(out)
    assert sorted(multis[0]._graphs) == [(3, 1), (3, 4)] and not multis[1]._graphs
    assert all(g.graph is not None for g in multis[0]._graphs.values()) and len(runs[0]) == 11
    for i, (a, b) in enumerate(zip(*runs, strict=True)):
        for s, (x, y) in enumerate(zip(a, b, strict=True)):
            for key in y:
                np.testing.assert_array_equal(x[key], y[key], err_msg=f"tick {i} stream {s} {key}")


def test_bgr_graphs_equal_eager(ci_pipes):
    """BGR input: no I420 kernel, the plain YOLO input inside the graph
    (its resize weights live on the card, so capture holds them)."""
    from isbfsar_tpu_torch.ops.image import i420_to_bgr
    from isbfsar_tpu_torch.pipeline import FusedPipeline

    graphs, _, frames = ci_pipes
    h = graphs.hpe.frame_shape[0]
    bgr = [torch.round(i420_to_bgr(torch.from_numpy(f), h)).to(torch.uint8).numpy()
           for f in frames]
    outs = []
    for cuda_graphs in (True, False):
        pipe = FusedPipeline(graphs.config, hpe=graphs.hpe, ar=graphs.ar, focus=graphs.focus,
                             input_format="bgr", device="cuda", cuda_graphs=cuda_graphs)
        before = fused_input.fused_i420_inputs.launches
        outs.append(_run(pipe, bgr))
        assert fused_input.fused_i420_inputs.launches == before
    for i, (a, b) in enumerate(zip(*outs, strict=True)):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"output {i} {key}")


# rgb and hybrid at the CI operating point (ResNet-50 at a 64 crop, float32,
# focus on): the card's stream_batched (B=8) against its step, and the card
# against the CPU, in the packed fields and the final feature ring; what an
# H100 read is in chip_smoke.py beside TOL_CI_RGB, whose limits these are.
TOL_RGB = {"pose": 1e-6, "pose_abs": 1e-6, "distance": 2e-6, "conf": 1e-6, "bbox": 0.0,
           "probs": 4e-5, "is_true": 1e-6, "f_score": 1e-6, "f_bbox": 2e-4,
           "f_landmarks": 6e-4, "f_head_position": 4e-6, "f_head_rotvec": 2e-5,
           "f_norm_head_rot2d": 2e-5, "f_gaze": 1.5e-5, "f_norm_gaze": 1.5e-5, "window": 4e-6}
EXACT = ("pose_ok", "ar_ready", "f_found")


@pytest.fixture(scope="module", params=["rgb", "hybrid"])
def rgb_pipes(request):
    """build_ci in rgb or hybrid on the card with CUDA graphs and eager,
    sharing the nets and the support set, and 18 frames at their size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: CUDA graphs have no CPU mode")
    from isbfsar_tpu_torch.profile_slice import build_ci, ci_frames, twin

    graphs = build_ci("cuda", cuda_graphs=True, input_type=request.param)
    return graphs, twin(graphs, cuda_graphs=False), ci_frames(18, faces=True)


def _assert_within(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        for key in b:
            if key in EXACT:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{what} {i} {key}")
            else:
                np.testing.assert_allclose(a[key], b[key], atol=tol[key], rtol=0,
                                           err_msg=f"{what} {i} {key}")


def test_rgb_graphs_equal_eager(rgb_pipes):
    graphs, eager, frames = rgb_pipes
    before = [k.launches for k in (fused_input.fused_i420_inputs, head_pose.focus_geometry)]
    ours = _run(graphs, frames)
    after = [k.launches for k in (fused_input.fused_i420_inputs, head_pose.focus_geometry)]
    assert [a - b for a, b in zip(after, before)] == [18 + 4, 18 + 4]  # one per dispatch
    ref = _run(eager, frames)
    assert sorted(graphs._graphs) == [1, 8] and any(o["ar_ready"] for o in ours)
    _assert_within(ours, ref, dict.fromkeys(TOL_RGB, 0.0), "graphs vs eager")
    np.testing.assert_array_equal(graphs._state.window.cpu(), eager._state.window.cpu())


def test_rgb_batched_matches_per_frame(rgb_pipes):
    graphs, _, frames = rgb_pipes
    outs = _run(graphs, frames)
    _assert_within(outs[18:], outs[:18], TOL_RGB, "stream_batched vs step")


def test_rgb_card_matches_cpu(rgb_pipes):
    from isbfsar_tpu_torch.profile_slice import build_ci

    graphs, _, frames = rgb_pipes
    cpu = build_ci("cpu", input_type=graphs.input_type)
    ours, ref = _run(graphs, frames), _run(cpu, frames)
    _assert_within(ours, ref, TOL_RGB, "card vs CPU")
    np.testing.assert_allclose(graphs._state.window.cpu().numpy(), cpu._state.window.numpy(),
                               atol=TOL_RGB["window"], rtol=0)
    if graphs.input_type == "rgb":
        assert all(not o["pose"].any() for o in ours)  # the detector alone


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """A synthetic training tree (8 classes x 3 clips) for the trainer on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trainer's card path has no CPU mode")
    from isbfsar_tpu_torch.train.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("train_tree"))
    generate_dataset(root, n_classes=8, clips_per_class=3, seed=0)
    return root


def _card_and_cpu_trainers(cfg, tmp_path):
    from isbfsar_tpu_torch.train.trainer import Trainer

    return {d: Trainer(cfg, log_dir=str(tmp_path / d), use_wandb=False, seed=2, device=d)
            for d in ("cuda", "cpu")}


def test_train_steps_on_card_match_cpu(train_tree, tmp_path):
    """Five steps with accumulation over 2 and the 100x drop after the first
    update, on the card and on the CPU from one init: every step's
    fs_correct and gate equal, the losses, parameters and accumulated
    gradients within chip_smoke.TOL_TRAIN, the counters equal."""
    import dataclasses

    from chip_smoke import TOL_TRAIN
    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator

    cfg = dataclasses.replace(ARConfig(), n_task=24, batch_size=8, optimize_every=2,
                              first_milestone=1, second_milestone=1)
    sampler = EpisodicSampler(train_tree, n_task=40, l=16, seed=0)
    batches = list(batch_iterator(sampler, 8, num_threads=1))
    pair = _card_and_cpu_trainers(cfg, tmp_path)
    assert next(pair["cuda"].model.parameters()).is_cuda
    for i, batch in enumerate(batches):
        got = {d: {k: v.detach().cpu().numpy() for k, v in t.step(batch).items()}
               for d, t in pair.items()}
        for k in ("fs_correct", "os_weights"):
            np.testing.assert_array_equal(got["cuda"][k], got["cpu"][k], err_msg=f"step {i} {k}")
        for k in ("fs_loss", "os_loss"):
            assert abs(got["cuda"][k] - got["cpu"][k]) <= TOL_TRAIN[k], (i, k)
    card, cpu = (t.state() for t in (pair["cuda"], pair["cpu"]))
    opt_card, opt_cpu = card["opt_state"], cpu["opt_state"]
    for k in ("mini_step", "gradient_step"):
        assert int(opt_card[k]) == int(opt_cpu[k])
    assert (int(opt_cpu["mini_step"]), int(opt_cpu["gradient_step"])) == (1, 2)
    for key, tree_card, tree_cpu in (("params", card["params"], cpu["params"]),
                                     ("acc_grads", opt_card["acc_grads"], opt_cpu["acc_grads"])):
        flat_card = torch.nn.utils.parameters_to_vector(list(_leaves(tree_card)))
        flat_cpu = torch.nn.utils.parameters_to_vector(list(_leaves(tree_cpu)))
        err = float((flat_card - flat_cpu).abs().max())
        print(f"card vs CPU after {len(batches)} steps: {key} max|diff| {err:.3g}")
        assert err <= TOL_TRAIN[key], (key, err)


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


def test_evaluate_fsos_on_card_matches_cpu(train_tree, tmp_path):
    """FSOS and the calibration with a briefly trained recognizer: raw
    scores within chip_smoke.TOL_FSOS_SCORE, known, fs_correct, the metrics
    and the calibrated threshold equal."""
    import dataclasses

    from chip_smoke import TOL_FSOS_SCORE
    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator
    from isbfsar_tpu_torch.train.fsos import calibrate_os_threshold, evaluate_fsos

    cfg = dataclasses.replace(ARConfig(), n_task=32, batch_size=8)
    trainer = _card_and_cpu_trainers(cfg, tmp_path)["cuda"]
    trainer.run_epoch(0, batch_iterator(EpisodicSampler(train_tree, n_task=32, l=16, seed=1), 8),
                      train=True)
    params = trainer.params
    kw = dict(k=5, n_repeats=2, batch_size=8, collect_raw=True)
    res = {d: evaluate_fsos(cfg, params, train_tree, train_tree, device=d, **kw)
           for d in ("cuda", "cpu")}
    for a, b in zip(res["cuda"]["_raw"], res["cpu"]["_raw"], strict=True):
        np.testing.assert_array_equal(a["known"], b["known"])
        np.testing.assert_array_equal(a["fs_correct"], b["fs_correct"])
        err = float(np.max(np.abs(a["scores"] - b["scores"])))
        print(f"FSOS scores, card vs CPU: max|diff| {err:.3g}")
        assert err <= TOL_FSOS_SCORE
    for k in ("FSOS-ACC", "FS-ACC", "OS-ACC"):
        assert res["cuda"][k] == res["cpu"][k], k
    calib = [calibrate_os_threshold(cfg, params, train_tree, n_repeats=2, device=d)
             for d in ("cuda", "cpu")]
    assert calib[0] == calib[1]


@pytest.mark.parametrize("mode", ["rgb", "hybrid"])
def test_rgb_train_steps_on_card_match_cpu(cuda, tmp_path, mode):
    """chip_smoke phase 9a: three train steps at the CI size (a 32 crop,
    batch 2), each from the card's state, on the card and on the CPU:
    fs_correct and the gate equal, the losses, parameters and running stats
    within chip_smoke.TOL_TRAIN_RGB."""
    from chip_smoke import TOL_TRAIN_RGB, check_rgb_train_small

    err = check_rgb_train_small(mode, str(tmp_path))
    print(f"{mode}, card vs CPU: {err}")
    for k, v in err.items():
        assert v <= TOL_TRAIN_RGB[k], (k, v)


@pytest.mark.parametrize("mode", ["rgb", "hybrid"])
def test_remat_cuts_the_train_steps_peak_memory(cuda, tmp_path, mode):
    """One train step with remat against one without (a 112 crop, batch 2,
    one init and batch, cuDNN deterministic): the peak memory drops to
    chip_smoke.REMAT_PEAK_RATIO or less, and the parameters and running
    stats after the step agree within chip_smoke.TOL_REMAT."""
    from chip_smoke import REMAT_PEAK_RATIO, TOL_REMAT, remat_pair
    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.synthetic import episodic_batch

    cfg = ARConfig.for_input(mode, rgb_size=112, batch_size=2)
    _, peak, err, losses = remat_pair(cfg, episodic_batch(cfg, 2, 112, mode), str(tmp_path))
    print(f"{mode}: peak {peak}, remat vs not {err}, losses {losses}")
    assert peak[True] <= REMAT_PEAK_RATIO * peak[False], peak
    for k, v in err.items():
        assert v <= TOL_REMAT[k], (k, v)


@pytest.mark.parametrize("kind", ["yolo", "heatmap"])
def test_synthetic_trainer_remat_equals_plain_on_card(cuda, kind):
    """The YOLO trainer with remat per CSP stage and the heatmap trainer
    with remat per MBConv, against the same trainers without, at the CI
    size (batch 2, one init and batch, cuDNN deterministic): the
    parameters and running stats after one step agree within
    chip_smoke.TOL_REMAT (exactly)."""
    from chip_smoke import TOL_REMAT, synth_batch, synth_remat_pair
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.train import posestack as ps

    if kind == "yolo":
        init = ps.YoloTrainer(width=0.25, input_size=128, device="cpu").variables
        make = lambda remat: ps.YoloTrainer(width=0.25, input_size=128, variables=init,  # noqa
                                            remat=remat, device="cuda")
    else:
        init = ps.HeatmapTrainer(ps.CI_INTRINSICS, crop_size=128, stages=V2_TINY,
                                 device="cpu").variables
        make = lambda remat: ps.HeatmapTrainer(ps.CI_INTRINSICS, crop_size=128,  # noqa
                                               stages=V2_TINY, variables=init, remat=remat,
                                               device="cuda")
    _, peak, err, losses = synth_remat_pair(make, synth_batch(kind))
    print(f"{kind}: peak {peak}, remat vs not {err}, losses {losses}")
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    for k, v in err.items():
        assert v <= TOL_REMAT[k], (k, v)


def test_synthetic_trainer_steps_on_card_match_cpu(cuda):
    """chip_smoke phase 11a: one CI-size step of each of the five synthetic
    trainers on the card and on the CPU from one init and batch, within
    that trainer's chip_smoke.TOL_SYNTH_TRAIN (the loss, the gradient, the
    update and the running stats)."""
    from chip_smoke import TOL_SYNTH_TRAIN, synth_step_errors

    for kind, tol in TOL_SYNTH_TRAIN.items():
        err = synth_step_errors(kind)
        print(kind, err)
        assert err["finite"], kind
        for k, v in tol.items():
            assert err[k] <= v, (kind, k, err[k])
