"""Evaluation metrics of the port (``opendwm_tpu/metrics``): the streaming
Fréchet distance behind FID/FVD, the running mean, voxel IoU and
difference, the point-cloud Chamfer / MMD / JSD and the ray errors."""

from opendwm_tpu_torch.metrics.frechet import (  # noqa: F401
    FrechetDistance,
    FrechetPairedMetric,
    frechet_distance,
)
from opendwm_tpu_torch.metrics.general import CustomMeanMetric  # noqa: F401
from opendwm_tpu_torch.metrics.pc_metrics import (  # noqa: F401
    PointCloudChamfer,
    PointCloudJSD,
    PointCloudMMD,
    chamfer_distance,
    point_cloud_to_histogram,
)
from opendwm_tpu_torch.metrics.voxel_metrics import (  # noqa: F401
    VoxelDiff,
    VoxelIoU,
)
