from opendwm_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler

__all__ = ["FlowMatchEulerScheduler"]
