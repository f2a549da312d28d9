"""Part of the PyTorch port (see isbfsar_tpu_torch/__init__.py)."""

from isbfsar_tpu_torch.focus.detector import Face, FocusDetector  # noqa: F401
from isbfsar_tpu_torch.focus.head_pose import HeadPoseDetector  # noqa: F401
from isbfsar_tpu_torch.focus.mutual import HeadDetector, MutualGazeDetector  # noqa: F401
