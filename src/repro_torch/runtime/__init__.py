from repro_torch.runtime.elastic import replan_mesh
from repro_torch.runtime.fault import FaultInjector, retry_step
from repro_torch.runtime.monitor import StepMonitor

__all__ = ["FaultInjector", "retry_step", "StepMonitor", "replan_mesh"]
