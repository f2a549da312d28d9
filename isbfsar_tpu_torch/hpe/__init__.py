"""The pose estimator (see isbfsar_tpu_torch/__init__.py)."""

from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator  # noqa: F401
