"""Host-side wrapper layer of the port: copies of ``pogema_tpu/wrappers``
(upstream: pogema/wrappers/). They subclass gymnasium.Wrapper where
gymnasium is installed and a stand-in where it is not (``utils.gym_compat``).

The batched core already enforces the time limit and computes metrics
on the device; these classes exist for API parity with the reference (user
code that composes wrappers keeps working) and for wrapping arbitrary
multi-agent list-convention envs.
"""

from .metrics import (
    AbstractMetric,
    CSRMetric,
    EpLengthMetric,
    ISRMetric,
    LifeLongAttritionMetric,
    LifeLongAverageThroughputMetric,
    NonDisappearCSRMetric,
    NonDisappearEpLengthMetric,
    NonDisappearISRMetric,
    RuntimeMetricWrapper,
)
from .multi_time_limit import MultiTimeLimit
from .persistence import AgentState, PersistentWrapper

__all__ = [
    "MultiTimeLimit",
    "PersistentWrapper",
    "AgentState",
    "AbstractMetric",
    "ISRMetric",
    "CSRMetric",
    "EpLengthMetric",
    "LifeLongAverageThroughputMetric",
    "LifeLongAttritionMetric",
    "NonDisappearISRMetric",
    "NonDisappearCSRMetric",
    "NonDisappearEpLengthMetric",
    "RuntimeMetricWrapper",
]
