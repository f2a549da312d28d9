"""The port's compute ops, with the JAX package's exports: geometry,
heatmap decode, NMS, warp, smoothing, tuples."""

from isbfsar_tpu_torch.ops.geometry import (  # noqa: F401
    is_within_fov,
    look_at_rotation,
    project,
    rotation_z,
    to_homogeneous,
    tta_params,
    virtual_camera,
    warp_matrix,
)
from isbfsar_tpu_torch.ops.nms import best_person_box, nms_fixed, postprocess_yolo  # noqa: F401
from isbfsar_tpu_torch.ops.reconstruct import (  # noqa: F401
    back_project,
    reconstruct_absolute,
    reconstruct_reference_point,
)
from isbfsar_tpu_torch.ops.smooth import (  # noqa: F401
    one_euro,
    one_euro_gated_state,
    one_euro_gated_step,
    one_euro_init,
    one_euro_step,
)
from isbfsar_tpu_torch.ops.softargmax import (  # noqa: F401
    decode_heatmap2d,
    decode_heatmap3d,
    split_head_logits,
)
from isbfsar_tpu_torch.ops.tuples import frame_tuples, n_tuples  # noqa: F401
from isbfsar_tpu_torch.ops.warp import warp_image, warp_image_bilinear  # noqa: F401
