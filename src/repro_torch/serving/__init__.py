from .engine import ServingEngine, EngineConfig, StreamHandoff
from .pager import PageAllocator, SCRATCH_PAGE
from .prefix_cache import PrefixCache
from .cluster import (ServingCluster, ClusterDispatcher, Replica,
                      PrefillPhaseController)
from .api import Backend, RequestHandle, Server, WatchdogConfig
from .faults import (FaultPlan, HandoffFailure, PagePressureSpike,
                     ReplicaKill)
