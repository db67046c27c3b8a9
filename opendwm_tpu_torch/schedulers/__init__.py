from opendwm_tpu_torch.schedulers.ddim import DDIMScheduler
from opendwm_tpu_torch.schedulers.ddpm import DDPMScheduler
from opendwm_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler

__all__ = ["DDIMScheduler", "DDPMScheduler", "FlowMatchEulerScheduler"]
