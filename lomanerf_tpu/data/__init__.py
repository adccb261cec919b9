"""Host data pipeline: Blender loader, synthetic scenes, ray batching."""

from lomanerf_tpu.data.blender import NeRFDataset  # noqa: F401
from lomanerf_tpu.data.synthetic import (  # noqa: F401
    GaussianBlobScene,
    look_at_pose,
    sphere_poses,
    synthetic_views,
    write_blender_dataset,
)
