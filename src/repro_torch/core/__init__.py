"""EPARA's primary contribution: task-categorized parallelism allocation,
distributed request handling, state-aware submodular service placement,
and ring information synchronization (paper §3)."""
from .allocator import (DPGroupRouter, MeshPlan, ParallelPlan, allocate,
                        categorize, mesh_submesh, plan_goodput)
from .categories import (ALL_CATEGORIES, CAT_FREQ_MULTI, CAT_FREQ_SINGLE,
                         CAT_LAT_MULTI, CAT_LAT_SINGLE, GPUSpec, Operator,
                         Request, Sensitivity, ServerSpec, ServiceSpec,
                         TaskCategory, operators_for)
from .cluster import EdgeCloudControlPlane, EdgeDevice
from .goodput import GoodputMeter, frequency_credit, latency_satisfied
from .handler import (Decision, Outcome, RequestHandler, ServerView,
                      ServiceState)
from .placement import (EPSILON_SERVER, PlacementProblem,
                        approximation_bound, evaluate, matroid_count,
                        place_lfu, place_lru, place_mfu, spf, sssp)
from .sync import ParameterServerSync, RingSynchronizer

__all__ = [n for n in dir() if not n.startswith("_")]
