"""Runtime primitives: the step-time watchdog (straggler.py) and the step
guard, fault handler and heartbeat monitor (fault.py), and the elastic
mesh plan (elastic.py)."""

from repro_torch.runtime.fault import (  # noqa: F401
    FaultHandler,
    GuardConfig,
    HeartbeatMonitor,
    guarded_update,
)
from repro_torch.runtime.straggler import StepTimeWatchdog, StragglerConfig  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    MeshPlan,
    shrink_plan,
    validate_batch_divisibility,
)
