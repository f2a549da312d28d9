"""The port's source CLI (``runtime/source_cli.py``): its parser against
JAX's, and a short live run on the CPU.

- Every argument of JAX's parser is in the port's with the same flags,
  default, type, choices and help, and both parse the same command lines
  to the same values; the port adds ``--hub-port`` alone (its ``serve``
  has it too).
- ``python -m isbfsar_tpu_torch.runtime.source_cli`` as a subprocess
  against a queue hub and the service loop (``Orchestrator.run``, what
  ``serve`` runs) on a CI-size pipeline on the CPU (V2_TINY, YOLO width
  0.25 at 128, a 128 crop, 640x480 frames, random weights at gate 0.0,
  float32, focus off, a fake clock for the acquisition's countdown), with
  the command script add, save, remove, load, a bogus command and quit on
  its stdin, driven by ``chip_smoke.drive_source_cli`` as the smoke drives
  it on the card: every command's log line appears on the console and both
  loops end.
"""

import argparse
import threading

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from isbfsar_tpu.runtime import source_cli as jcli
from isbfsar_tpu_torch.runtime import source_cli as tcli

torch.set_num_threads(2)


class _Captured(Exception):
    pass


def _jax_parser(monkeypatch):
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured):
        jcli.main()
    monkeypatch.undo()
    return seen[0]


def _port_parser(monkeypatch):
    seen = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.append(self)
        return real(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    tcli.parse_args([])
    monkeypatch.undo()
    return seen[0]


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, tuple(a.choices or ()), a.nargs,
                     a.const, a.required, a.help, type(a).__name__)
            for a in parser._actions}


def test_parser_matches_jax(monkeypatch):
    jax_actions, port_actions = _actions(_jax_parser(monkeypatch)), _actions(
        _port_parser(monkeypatch))
    assert set(port_actions) - set(jax_actions) == {"hub_port"}
    for dest, spec in jax_actions.items():
        assert port_actions[dest] == spec, dest


@pytest.mark.parametrize("argv", [
    [], ["--source", "video", "--path", "clip.mp4"], ["--hub", "shm", "--max-frames", "10"],
    ["--gui", "--os-threshold", "0.26", "--source", "humanoid"],
])
def test_same_values_as_jax(monkeypatch, argv):
    got = vars(tcli.parse_args(argv))
    want = vars(_jax_parser(monkeypatch).parse_args(argv))
    assert got.pop("hub_port") == 50000
    assert got == want


def _ci_service(save_dir):
    """An orchestrator on a CI-size fused pipeline that takes 640x480 frames."""
    from isbfsar_tpu_torch.configs import (ARConfig, CameraIntrinsics, HPEConfig, MainConfig,
                                           PipelineConfig)
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.pipeline import FusedPipeline
    from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator

    intr = CameraIntrinsics()
    hpe_cfg = HPEConfig(yolo_input_size=128, crop_size=128, yolo_thresh=0.0,
                        compute_dtype="float32")
    cfg = PipelineConfig(main=MainConfig(), intrinsics=intr, hpe=hpe_cfg, ar=ARConfig(),
                         param_dtype="float32")
    hpe = HumanPoseEstimator(hpe_cfg, intr, seed=0, backbone_stages=V2_TINY,
                             frame_shape=(480, 640), yolo_width=0.25, device="cpu")
    pipe = FusedPipeline(cfg, hpe=hpe, with_focus=False, device="cpu")

    class Clock:
        t = 0.0

        def __call__(self):
            self.t += 0.25
            return self.t

    return Orchestrator(cfg, save_dir=save_dir, clock=Clock(), fused=pipe, fused_overlap=False)


def test_source_cli_drives_the_service(tmp_path):
    from isbfsar_tpu_torch.runtime.ipc import QueueClient, QueueHub

    orch = _ci_service(str(tmp_path / "saved"))
    hub = QueueHub(("127.0.0.1", 0)).start_background()
    host, port = hub._server.address
    client = QueueClient(host, port)
    orch._in_queue = client.get_queue("source_human")
    orch._out_queue = client.get_queue("human_sink")
    service = threading.Thread(target=orch.run, daemon=True)
    service.start()
    try:
        lines, sent, rc = smoke.drive_source_cli(host, port, smoke.SERVE_SCRIPT, spacing=2,
                                                 deadline_s=240)
        service.join(timeout=30)
        assert not service.is_alive(), "the service did not stop on quit"
    finally:
        hub.stop()
    smoke.check_console(lines, sent, rc, smoke.SERVE_SCRIPT)
    assert [c for c, _ in sent] == [c for c, _ in smoke.SERVE_SCRIPT]
    heads = [ln for ln in lines if ln.startswith("fps")]
    assert any(ln.startswith("  a ") for ln in lines), "the learned action never scored"
    assert int(lines[-1].split()[-2]) == len(heads) + 2  # the add's ACK and quit show nothing
    assert (tmp_path / "saved").is_dir() and np.isfinite(float(heads[-1].split()[1]))
