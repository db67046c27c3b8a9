"""Multi-device training and serving of the port: device meshes, FSDP/DDP/
HSDP sharding, the GPipe schedule and the stage-sliced flagship DiT
(``opendwm_tpu/parallel/``)."""

from opendwm_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    make_mesh,
    mesh_for_policy,
)
from opendwm_tpu_torch.parallel.sharding import (  # noqa: F401
    param_shardings,
    shard_batch,
    shard_model,
)
