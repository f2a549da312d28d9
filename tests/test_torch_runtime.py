"""The port's serving layer: twins of tests/test_runtime.py (the orchestrator
and its command protocol, the IPC hub, the live service through a hub, the
fused orchestrator) and the port's Orchestrator against the JAX one.

The parity tests run both packages' orchestrators on the trained CI
operating point (``pose-ci-motions``, and ``focus-ci`` at the CI focus
config, 240x320, float32, the 0.3 gate) with the same weights, the same BGR
frames (a rendered motion clip with the committed face frames among them)
and the same ``FakeClock``, through the fused path (synchronous,
overlapped, batched) and the module path. Fields are held to the limits of
tests/test_torch_pipeline_focus.py (pose 1e-4 m, probs 2e-5, is_true 2e-6,
bbox exact, the face box 2e-4 px; the module path's estimator pose 1e-5 m);
the keys of every elements dict, the focus verdicts, the log strings and
the place of the ACK are held exactly. The AR window is 8 frames here
(``seq_len`` and ``window_size``), which halves the frames an acquisition
takes in both packages.

Every thread and socket has a deadline: a hang fails its test.
"""

import dataclasses
import queue
import threading

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu import pretrained
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.focus.detector import FocusDetector as JaxFocus
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.ops.image import bgr_to_i420 as jax_bgr_to_i420
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.runtime.orchestrator import Orchestrator as JaxOrchestrator
from isbfsar_tpu.train.gazefocus import CI_FOCUS_CFG as JAX_CI_FOCUS_CFG
from isbfsar_tpu.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.focus.detector import FocusDetector
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.ops.image import bgr_to_i420, i420_to_bgr
from isbfsar_tpu_torch.pipeline import FusedPipeline
from isbfsar_tpu_torch.profile_slice import CI_FOCUS_CFG, focus_frames
from isbfsar_tpu_torch.runtime import serve
from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator

torch.set_num_threads(2)

SEQ = 8
TOL = {"pose": 1e-4, "distance": 3e-4, "is_true": 2e-6, "actions": 2e-5, "face_bbox": 2e-4}
TOL_MODULE = {**TOL, "pose": 1e-5}  # the estimator alone reads 1.7e-6 m
DEADLINE_S = 60


class FakeClock:
    """Deterministic clock: each call advances 0.25 s."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


class FrameQueue:
    """In-queue stub cycling a fixed frame list, with optional commands."""

    def __init__(self, frames, msgs=()):
        self.frames, self.msgs, self.i = frames, list(msgs), 0

    def get(self):
        frame = self.frames[self.i % len(self.frames)]
        self.i += 1
        return {"rgb": frame, "msg": self.msgs.pop(0) if self.msgs else ""}


class Collector:
    def __init__(self):
        self.items = []

    def put(self, x):
        self.items.append(x)


@pytest.fixture(scope="module")
def ci():
    """Both packages' modules on the same trained CI weights, their
    configs, and 24 BGR frames: two of the rendered clip to one face."""
    pose_params, focus_params = pretrained.load("pose-ci-motions"), pretrained.load("focus-ci")
    h, w = CI_FRAME_HW
    hpe_kw = dict(compute_dtype="float32", yolo_input_size=128, crop_size=128)
    ar_kw = dict(seq_len=SEQ)
    jcfg = jc.PipelineConfig(
        main=dataclasses.replace(jc.MainConfig(cam_width=w, cam_height=h), window_size=SEQ),
        intrinsics=CI_INTRINSICS, hpe=jc.HPEConfig(**hpe_kw), ar=jc.ARConfig(**ar_kw),
        focus=JAX_CI_FOCUS_CFG, param_dtype="float32")
    intr = tc.CameraIntrinsics(fx=192.0, fy=192.0, ppx=160.0, ppy=120.0, width=w, height=h)
    tcfg = tc.PipelineConfig(
        main=dataclasses.replace(tc.MainConfig(cam_width=w, cam_height=h), window_size=SEQ),
        intrinsics=intr, hpe=tc.HPEConfig(**hpe_kw), ar=tc.ARConfig(**ar_kw),
        focus=CI_FOCUS_CFG, param_dtype="float32")
    jhpe = JaxEstimator(jcfg.hpe, CI_INTRINSICS, params=pose_params, backbone_stages=JAX_V2_TINY,
                        frame_shape=CI_FRAME_HW, yolo_width=0.25)
    jfocus = JaxFocus(JAX_CI_FOCUS_CFG, CI_INTRINSICS, params=focus_params,
                      frame_shape=CI_FRAME_HW)
    jar_params = JaxRecognizer(jcfg.ar, seed=0).params
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    thpe = HumanPoseEstimator(tcfg.hpe, intr, params=np_tree(pose_params), backbone_stages=V2_TINY,
                              frame_shape=CI_FRAME_HW, yolo_width=0.25, device="cpu")
    tfocus = FocusDetector(CI_FOCUS_CFG, intr, params=np_tree(focus_params),
                           frame_shape=CI_FRAME_HW, device="cpu")
    clip, _ = render_motion_clip("wave", n_frames=16, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=2.0)
    faces = [torch.round(i420_to_bgr(torch.from_numpy(f), h)).to(torch.uint8).numpy()
             for f in focus_frames(240)["i420"]]
    frames = []
    for i in range(8):
        frames += [clip[2 * i], clip[2 * i + 1], faces[i % len(faces)]]
    return {"jcfg": jcfg, "tcfg": tcfg, "jhpe": jhpe, "jfocus": jfocus, "jar_params": jar_params,
            "thpe": thpe, "tfocus": tfocus, "frames": frames, "np_tree": np_tree}


def _recognizers(ci):
    jar = JaxRecognizer(ci["jcfg"].ar, params=ci["jar_params"])
    ar = ActionRecognizer(ci["tcfg"].ar, params=ci["np_tree"](ci["jar_params"]), device="cpu")
    return jar, ar


def _orchestrators(ci, fused=False, msgs=(), input_format="i420", **kw):
    """The JAX and the port orchestrator on the same weights, queues and clocks."""
    jar, ar = _recognizers(ci)
    for d in (ci["jfocus"], ci["tfocus"]):
        d.focuses = []
    if fused:
        jfused = JaxPipeline(ci["jcfg"], hpe=ci["jhpe"], ar=jar, focus=ci["jfocus"],
                             with_focus=True, input_format=input_format)
        tfused = FusedPipeline(ci["tcfg"], hpe=ci["thpe"], ar=ar, focus=ci["tfocus"],
                               device="cpu", input_format=input_format)
        mods = ({"fused": jfused}, {"fused": tfused})
    else:
        mods = ({"hpe": ci["jhpe"], "focus": ci["jfocus"], "ar": jar},
                {"hpe": ci["thpe"], "focus": ci["tfocus"], "ar": ar, "device": "cpu"})
    out = []
    for cls, cfg, m in ((JaxOrchestrator, ci["jcfg"], mods[0]),
                        (Orchestrator, ci["tcfg"], mods[1])):
        out.append(cls(cfg, in_queue=FrameQueue(ci["frames"], msgs), out_queue=Collector(),
                       clock=FakeClock(), **m, **kw))
    return out


def _same_elements(ours, ref, tol, where=""):
    """One elements dict against the JAX one: the same keys, the fields
    within ``tol``, the rest exactly."""
    if "ACK" in ref:
        assert ours == ref, where
        return
    assert ours.keys() == ref.keys(), (where, sorted(ours), sorted(ref))
    assert ours["img"] is ref["img"] or np.array_equal(ours["img"], ref["img"]), where
    for key in ref:
        if key in ("img", "edges"):
            continue
        if key == "actions":
            assert ours[key].keys() == ref[key].keys(), where
            for name in ref[key]:
                np.testing.assert_allclose(ours[key][name], ref[key][name], atol=tol["actions"],
                                           rtol=0, err_msg=f"{where} {name}")
        elif key in tol:
            np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                       np.asarray(ref[key], np.float64), atol=tol[key], rtol=0,
                                       err_msg=f"{where} {key}")
        else:
            assert ours[key] == ref[key], (where, key, ours[key], ref[key])
    if "edges" in ref:
        np.testing.assert_array_equal(ours["edges"], ref["edges"])


def _drive_both(pair, n, tol, learn=True, **kw):
    """learn 'wave -focus' on both, then ``n`` get_frame calls; every
    published elements dict is compared."""
    jorch, torch_orch = pair
    for o in pair:
        if learn:
            o.learn_command(["wave", "-focus"])
        for _ in range(n):
            o.get_frame(**kw)
    ref, ours = pair[0]._out_queue.items, pair[1]._out_queue.items
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        _same_elements(a, b, tol, f"elements {i}")
    return ours


# ---------------------------------------------------------------- parity


def test_module_path_matches_jax(ci):
    ours = _drive_both(_orchestrators(ci), 14, TOL_MODULE)
    logs = [e.get("log") for e in ours]
    assert logs[:5] == ["WAIT..."] * 4 + ["GO!"] and "100.00%" in logs
    assert any("pose" in e for e in ours) and any(e.get("face_bbox") is not None for e in ours)
    assert ours[-1]["actions"] and set(ours[-1]["requires_focus"]) == {"wave"}
    assert {e["focus"] for e in ours if "focus" in e} == {True, False}


@pytest.mark.parametrize("overlap,transport", [(False, "i420"), (True, "i420"), (False, "bgr")])
def test_fused_path_matches_jax(ci, overlap, transport):
    """The fused path with the serve CLI's transports: i420 (encoded on the
    host, decoded by the fused input stage) and bgr (no decode: float frames
    and the plain YOLO input, in both packages)."""
    pair = _orchestrators(ci, fused=True, fused_overlap=overlap, input_format=transport)
    assert pair[1].fused.frame_shape() == ((240, 320, 3) if transport == "bgr" else (360, 320))
    ours = _drive_both(pair, 14, TOL)
    assert ours[-1]["actions"] and any("face_bbox" in e for e in ours)
    if overlap:  # the priming frame after the learn's support refresh
        assert ours[-14]["actions"] == {} and "pose" not in ours[-14]


def test_fused_batches_match_jax(ci):
    jorch, orch = _orchestrators(ci, fused=True)
    frames = ci["frames"]
    for o in (jorch, orch):
        o.learn_command(["wave"])
        o.get_frame_batch(frames[:8], log="sync")
        assert o.get_frame_batch(frames[8:16], overlap=True) == []
        o.get_frame_batch(frames[16:24], overlap=True, log="second")
    ref, ours = jorch._out_queue.items, orch._out_queue.items
    assert len(ours) == len(ref) and [e.get("log") for e in ours[-8:]] == ["second"] * 8
    assert all(a["img"] is b for a, b in zip(ours[-8:], frames[8:16]))
    for i, (a, b) in enumerate(zip(ours, ref)):
        _same_elements(a, b, TOL, f"elements {i}")


def test_run_loop_commands_and_ack_order_match_jax(ci, tmp_path):
    """The command protocol through run(): add (ACK before acquisition),
    save, remove, load, a bogus command, debug, quit; the out queues'
    sequences are the same, ACK included."""
    msgs = ["", "add wave -focus"] + [""] * 24 + ["save", "remove wave", "remove nothere", "load",
                                                  "bogus", "debug", ""] + [""] * 3 + ["quit"]
    pair = _orchestrators(ci, fused=True, msgs=msgs, save_dir=str(tmp_path))
    for o in pair:
        o.run()
    ref, ours = pair[0]._out_queue.items, pair[1]._out_queue.items
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        _same_elements(a, b, TOL, f"item {i}")
    assert ours[1] == {"ACK": True} and ours[2]["log"] == "WAIT..."
    logs = [e.get("log") for e in ours if e.get("log")]
    for want in ("Action wave learned successfully!", "Action wave removed",
                 "Action nothere is not in the support set", "Loaded 1 classes",
                 "Not a valid command!"):
        assert want in logs
    assert any(log.startswith("Classes saved successfully in ") for log in logs)


def test_estimator_estimate_and_box_match_jax(ci):
    jhpe, thpe = ci["jhpe"], ci["thpe"]
    jbox = JaxEstimator(ci["jcfg"].hpe, CI_INTRINSICS, params=jhpe.params,
                        backbone_stages=JAX_V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25,
                        just_box=True)
    tbox = HumanPoseEstimator(dataclasses.replace(ci["tcfg"].hpe, just_box=True),
                              ci["tcfg"].intrinsics, params=ci["np_tree"](jhpe.params),
                              backbone_stages=V2_TINY, frame_shape=CI_FRAME_HW, yolo_width=0.25,
                              device="cpu")
    found = 0
    for frame in ci["frames"][:6]:
        ref, ours = jhpe.estimate(frame), thpe.estimate(frame)
        assert (ours is None) == (ref is None)
        if ref is not None:
            found += 1
            assert ours["bbox"] == ref["bbox"] and all(type(v) is int for v in ours["bbox"])
            np.testing.assert_allclose(ours["pose"], ref["pose"], atol=1e-5, rtol=0)
            assert ours["pose"].shape == (30, 3) and ours["pose"].dtype == np.float32
            np.testing.assert_array_equal(ours["edges"], ref["edges"])
        box_ref, box = jbox.estimate(frame), tbox.estimate(frame)
        assert box == box_ref and (box is None or set(box) == {"bbox"})
    assert found >= 3


def test_bgr_to_i420_matches_the_cv2_encode():
    rng = np.random.default_rng(0)
    for shape in [(480, 640, 3), (240, 320, 3), (120, 160, 3)]:
        for frame in (rng.integers(0, 256, shape, np.uint8), np.zeros(shape, np.uint8),
                      np.full(shape, 255, np.uint8)):
            np.testing.assert_array_equal(bgr_to_i420(frame), jax_bgr_to_i420(frame))


# ---------------------------------------------------- twins of test_runtime


@pytest.fixture(scope="module")
def orchestrator(ci):
    _, ar = _recognizers(ci)
    return Orchestrator(ci["tcfg"], in_queue=FrameQueue(ci["frames"]), out_queue=Collector(),
                        hpe=ci["thpe"], focus=ci["tfocus"], ar=ar, clock=FakeClock(),
                        device="cpu")


class TestOrchestrator:
    def test_get_frame_elements_contract(self, orchestrator, ci):
        elements = orchestrator.get_frame(img=ci["frames"][0], log="hello")
        assert "img" in elements and "fps" in elements and elements["log"] == "hello"
        assert elements["pose"].shape == (30, 3)
        np.testing.assert_allclose(elements["pose"][0], 0.0, atol=1e-6)  # root-relative
        assert "distance" in elements and elements["actions"] == {}
        assert orchestrator._out_queue.items[-1] is elements

    def test_learn_then_recognize_and_forget(self, orchestrator):
        log = orchestrator.learn_command(["wave", "-focus"])
        assert "learned successfully" in log and orchestrator.ar.n_classes == 1
        assert orchestrator.ar.requires_focus == {"wave": True}
        for _ in range(2 * SEQ):
            elements = orchestrator.get_frame()
        assert "wave" in elements["actions"]
        assert orchestrator.forget_command("wave") == "Action wave removed"
        assert "not in the support set" in orchestrator.forget_command("wave")

    def test_save_load_roundtrip(self, orchestrator, tmp_path):
        orchestrator.save_dir = str(tmp_path)
        orchestrator.learn_command(["point"])
        assert "saved successfully" in orchestrator.save()
        orchestrator.forget_command("point")
        assert orchestrator.ar.n_classes == 0
        assert orchestrator.load() == "Loaded 1 classes"
        assert orchestrator.ar.n_classes == 1
        orchestrator.forget_command("point")

    def test_debug_summary(self, orchestrator):
        info = orchestrator.debug()
        assert set(info.keys()) == {"classes", "requires_focus", "support_data", "mask"}

    def test_run_loop_commands(self, orchestrator, ci):
        orchestrator._in_queue = FrameQueue(ci["frames"], ["", "bogus cmd", "remove nothere",
                                                           "quit"])
        out = orchestrator._out_queue = Collector()
        orchestrator.run()  # terminates on 'quit'
        logs = [e.get("log") for e in out.items if e.get("log")]
        assert "Not a valid command!" in logs
        assert any("not in the support set" in log for log in logs)
        orchestrator._in_queue = FrameQueue(ci["frames"])

    def test_rgb_and_hybrid_are_not_ported(self, ci):
        """The orchestrator once refused rgb and hybrid; it takes both now
        and feeds the recognizer the person's crop
        (tests/test_torch_rgb_serving.py holds them against the JAX one)."""
        for input_type in ("rgb", "hybrid"):
            ar_cfg = dataclasses.replace(tc.ARConfig.for_input(input_type), seq_len=SEQ, rgb_size=64)
            cfg = dataclasses.replace(ci["tcfg"], ar=ar_cfg, main=dataclasses.replace(
                ci["tcfg"].main, input_type=input_type))
            orch = Orchestrator(cfg, hpe=ci["thpe"], focus=ci["tfocus"],
                                ar=ActionRecognizer(ar_cfg, device="cpu"), device="cpu")
            elements = orch.get_frame(img=ci["frames"][0])
            assert elements["img_preprocessed"].shape == (64, 64, 3)
            assert ("pose" in elements) == (input_type == "hybrid")


class TestIPC:
    def test_hub_roundtrip(self):
        from isbfsar_tpu_torch.runtime.ipc import QueueClient, QueueHub

        hub = QueueHub(("127.0.0.1", 0)).start_background()
        addr = hub._server.address
        client = QueueClient(addr[0], addr[1])
        q1, q2 = client.get_queue("source_human"), client.get_queue("source_human")
        q1.put({"rgb": 1, "msg": "hi"})
        assert q2.get(timeout=DEADLINE_S) == {"rgb": 1, "msg": "hi"}

    def test_capacity_one_backpressure(self):
        from isbfsar_tpu_torch.runtime.ipc import LocalQueuePair, QueueClient, QueueHub

        hub = QueueHub(("127.0.0.1", 0)).start_background()
        addr = hub._server.address
        q = QueueClient(addr[0], addr[1]).get_queue("bp")
        q.put(1)
        with pytest.raises(queue.Full):
            q.put(2, False)  # capacity 1: a second put must fail
        assert q.get(timeout=DEADLINE_S) == 1
        pair = LocalQueuePair()
        pair.inbound.put(1)
        with pytest.raises(queue.Full):
            pair.inbound.put(2, False)


class TestLiveServiceIntegration:
    def test_threaded_service_add_command_no_deadlock(self, orchestrator, ci):
        """source -> hub -> orchestrator with a live `add`: the source takes
        the ACK as that cycle's elements, the acquisition runs, AR fires,
        'quit' ends the service. Both loops run in threads with a deadline."""
        from isbfsar_tpu_torch.runtime.ipc import QueueClient, QueueHub
        from isbfsar_tpu_torch.runtime.source import run_source

        hub = QueueHub(("127.0.0.1", 0)).start_background()
        addr = hub._server.address
        client = QueueClient(addr[0], addr[1])
        orchestrator._in_queue = client.get_queue("source_human")
        orchestrator._out_queue = client.get_queue("human_sink")
        orchestrator.ar.remove("wave")
        frames = FrameQueue(ci["frames"])

        class Source:
            def read(self):
                return True, frames.get()["rgb"]

            def stop(self):
                pass

        def commands():
            yield "add wave"
            for _ in range(45):
                yield ""
            yield "quit"

        collected, pushed = [], []

        class Collect:
            def show(self, elements):
                collected.append(elements)

        threads = [
            threading.Thread(target=orchestrator.run, daemon=True),
            threading.Thread(target=lambda: pushed.append(run_source(
                Source(), hub_host=addr[0], hub_port=addr[1], visualizer=Collect(),
                command_stream=commands(), max_frames=100)), daemon=True),
        ]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=DEADLINE_S)
            assert not any(t.is_alive() for t in threads), "the service did not finish"
        finally:
            orchestrator._in_queue = FrameQueue(ci["frames"])
            orchestrator._out_queue = Collector()
        assert pushed == [47] and len(collected) == 45  # the ACK and 'quit' have no elements
        logs = [e.get("log") for e in collected if e.get("log")]
        assert logs[0] == "WAIT..." and "Action wave learned successfully!" in logs
        assert any(e.get("actions") for e in collected), "AR never fired"
        orchestrator.ar.remove("wave")


class TestFusedOrchestrator:
    def test_fused_frame_path_and_commands(self, orchestrator, ci):
        fused = FusedPipeline(ci["tcfg"], hpe=ci["thpe"], ar=orchestrator.ar, with_focus=False,
                              device="cpu")
        orch = Orchestrator(ci["tcfg"], in_queue=FrameQueue(ci["frames"]), out_queue=Collector(),
                            fused=fused, clock=FakeClock())
        assert "learned successfully" in orch.learn_command(["spin"])
        for _ in range(2 * SEQ):
            elements = orch.get_frame()
        assert "spin" in elements["actions"] and elements["pose"].shape == (30, 3)
        assert orch.forget_command("spin") == "Action spin removed"
        assert orch.get_frame()["actions"] == {}

    def test_fused_overlap_one_frame_lag(self, orchestrator, ci):
        """Call i returns frame i-1's img and results; call 0 is a priming
        frame; the results equal the synchronous path's; an elements dict
        already returned does not change under later dispatches."""
        fused = FusedPipeline(ci["tcfg"], hpe=ci["thpe"], ar=orchestrator.ar, focus=ci["tfocus"],
                              device="cpu", cuda_graphs=True)
        orch = Orchestrator(ci["tcfg"], out_queue=Collector(), fused=fused, clock=FakeClock())
        assert orch.fused_overlap
        f0, f1, f2, f3 = ci["frames"][:4]
        e0 = orch.get_frame(img=f0)
        assert e0["actions"] == {} and "pose" not in e0 and e0["img"] is f0
        e1 = orch.get_frame(img=f1)
        held = {k: np.copy(v) for k, v in e1.items() if isinstance(v, np.ndarray)}
        e2 = orch.get_frame(img=f2)
        orch.get_frame(img=f3)
        assert e1["img"] is f0 and e2["img"] is f1
        for k, v in held.items():
            np.testing.assert_array_equal(e1[k], v, err_msg=k)

        sync = Orchestrator(ci["tcfg"], out_queue=Collector(), fused=fused, fused_overlap=False,
                            clock=FakeClock())
        s0, s1 = sync.get_frame(img=f0), sync.get_frame(img=f1)
        for got, want in ((e1, s0), (e2, s1)):
            assert got.keys() == want.keys()
            np.testing.assert_array_equal(got["pose"], want["pose"])

        orch.get_frame(img=f0)
        orch._refresh_support()  # a support edit drops the pending frame
        assert orch._fused_pending is None
        e = orch.get_frame(img=f1)
        assert e["actions"] == {} and "pose" not in e

    @pytest.mark.parametrize("static", [False, True])
    def test_warmup_leaves_a_fresh_state(self, orchestrator, ci, static):
        """warmup() steps an empty frame, then resets the AR window in place
        (the graphs' buffers keep their addresses)."""
        fused = FusedPipeline(ci["tcfg"], hpe=ci["thpe"], ar=orchestrator.ar, with_focus=False,
                              device="cpu", cuda_graphs=static)
        fused.start()
        window = fused._state.window
        fused.step(bgr_to_i420(ci["frames"][0]))
        fused.warmup()
        assert (fused._state.window is window) == static
        assert int(fused._state.n_valid) == 0 and not fused._state.window.any()
        assert not fused._state.smooth["init"]

    def test_fused_batched_serve_parity(self, orchestrator, ci):
        fused = FusedPipeline(ci["tcfg"], hpe=ci["thpe"], ar=orchestrator.ar, with_focus=False,
                              device="cpu")
        frames = ci["frames"][:4]
        outs = Orchestrator(ci["tcfg"], fused=fused, clock=FakeClock()).get_frame_batch(
            frames, log="hi")
        assert len(outs) == 4
        for img, e in zip(frames, outs):
            assert e["img"] is img and e["log"] == "hi" and "fps" in e
        sync = Orchestrator(ci["tcfg"], fused=fused, fused_overlap=False, clock=FakeClock())
        for img, e in zip(frames, outs):
            np.testing.assert_allclose(e["pose"], sync.get_frame(img=img)["pose"], atol=1e-5)
        ov = Orchestrator(ci["tcfg"], fused=fused, clock=FakeClock())
        assert ov.get_frame_batch(frames[:2], overlap=True) == []
        second = ov.get_frame_batch(frames[2:4], overlap=True)
        assert [e["img"] for e in second] == frames[:2]
        np.testing.assert_allclose(second[0]["pose"], outs[0]["pose"], atol=1e-5)
        ov._refresh_support()
        assert ov._fused_batch_pending is None


# ------------------------------------------------------------------ serve


def test_serve_on_a_missing_card_is_an_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.main(["--device", "cuda", "--fused"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert serve.parse_args([]).device == "cuda"


@pytest.mark.parametrize("error", [KeyError, FileNotFoundError])
def test_serve_auto_weights_fall_back_to_random_init(monkeypatch, capsys, error):
    from isbfsar_tpu_torch import weights

    def absent(*args, **kwargs):
        raise error("pose-prod-256")

    monkeypatch.setattr(weights, "load_calibrated", absent)
    assert serve.load_pose_stack("auto", 0.3) is None
    assert "bundle absent -> random init" in capsys.readouterr().out
    with pytest.raises(error):
        serve.load_pose_stack("pretrained", 0.3)
    assert serve.load_pose_stack("random", 0.3) is None
