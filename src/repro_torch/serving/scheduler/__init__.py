"""Continuous-batching scheduler: admission, block growth, preemption.

The engine executes; the scheduler decides.  See scheduler.py for the
policy surface (admission policy, priority classes, victim selection,
DP-aware placement) and SchedulerConfig for the knobs.
"""

from repro_torch.serving.scheduler.scheduler import (  # noqa: F401
    ADMISSION_POLICIES,
    RESUME_MODES,
    Scheduler,
    SchedulerConfig,
)
