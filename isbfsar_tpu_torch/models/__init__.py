"""The port's nets (NCHW), with the JAX package's exports."""

from isbfsar_tpu_torch.models.detection import (  # noqa: F401
    FPN,
    BinaryGazeClassifier,
    EyeKeypointMLP,
    HeadDetectorNet,
)
from isbfsar_tpu_torch.models.effnetv2 import (  # noqa: F401
    V2_L,
    V2_S,
    V2_TINY,
    EfficientNetV2,
    MetrabsHead,
)
from isbfsar_tpu_torch.models.gaze import BlazeFaceLite, GazeNet, HopeNet  # noqa: F401
from isbfsar_tpu_torch.models.resnet import ResNet, resnet18, resnet50  # noqa: F401
from isbfsar_tpu_torch.models.trx import TRXOS, TemporalCrossTransformer  # noqa: F401
from isbfsar_tpu_torch.models.yolov4 import YOLOv4  # noqa: F401
