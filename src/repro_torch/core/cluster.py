"""Edge-cloud control plane: servers, device registration (§4.2), the
centralized *messager* (static metadata) and *configurer* (periodic SSSP),
wired to the three temporal granularities of §3.4:

  fine    — request handling, decentralized, on-demand (RequestHandler);
  medium  — information synchronization, ring, every sync_interval;
  coarse  — service placement, centralized, every placement_interval.

Both the live serving engine and the event simulator drive one of these
objects; neither reimplements scheduling logic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from . import costmodel as cm
from .allocator import ParallelPlan, allocate, plan_goodput
from .categories import GPUSpec, Request, ServerSpec, ServiceSpec
from .goodput import GoodputMeter
from .handler import Decision, RequestHandler, ServerView, ServiceState
from .placement import (EPSILON_SERVER, Placement, PlacementProblem, sssp)
from .sync import RingSynchronizer


@dataclasses.dataclass
class EdgeDevice:
    """A registered edge device donating GPU capacity (§4.2): single-GPU
    services only (uncertain lifecycle — no inter-device parallelism)."""
    did: int
    host_server: int
    gpu: GPUSpec = dataclasses.field(
        default_factory=lambda: GPUSpec(name="jetson-like", tflops=20.0,
                                        vram_gb=8.0, mem_bw_gbs=200.0))
    service: Optional[str] = None
    registered_at: float = 0.0
    load_ready_at: float = 0.0


class EdgeCloudControlPlane:
    def __init__(self, servers: Sequence[ServerSpec],
                 services: Mapping[str, ServiceSpec], *,
                 sync_interval_s: float = 1.0,
                 placement_interval_s: float = 60.0,
                 sync_bandwidth_gbps: float = 1.0,
                 max_offload_count: int = 5,
                 peer_staleness_s: Optional[float] = None,
                 seed: int = 0):
        self.servers = list(servers)
        self.services = dict(services)
        self.sync_interval_s = sync_interval_s
        self.placement_interval_s = placement_interval_s
        gpu = self.servers[0].gpu if self.servers else GPUSpec()
        self.gpu = gpu
        # messager: stationary metadata (ids / "addresses")
        self.messager: Dict[int, ServerSpec] = {s.sid: s for s in servers}
        self.plans: Dict[str, ParallelPlan] = {
            name: allocate(svc, gpu) for name, svc in self.services.items()}
        self.sync = RingSynchronizer(
            [s.sid for s in servers], interval_s=sync_interval_s,
            bandwidth_gbps=sync_bandwidth_gbps,
            num_services=max(1, len(services)))
        # degraded-mode guard (§5.3.3): a peer whose digest is older than
        # this bound is treated as DOWN by every handler — a silently
        # crashed server stops refreshing, and its frozen view would
        # otherwise advertise pre-crash idle goodput.  The default gives
        # every publish a full ring traversal plus one spare interval of
        # slack before a peer is written off.
        if peer_staleness_s is None:
            peer_staleness_s = ((len(self.servers) + 1) * sync_interval_s
                                + self.sync.round_cost_s)
        self.peer_staleness_s = peer_staleness_s
        self.handlers: Dict[int, RequestHandler] = {
            s.sid: RequestHandler(s.sid,
                                  max_offload_count=max_offload_count,
                                  staleness_bound_s=peer_staleness_s,
                                  seed=seed)
            for s in servers}
        self.meter = GoodputMeter()
        self.placements: List[Placement] = []
        self.devices: Dict[int, EdgeDevice] = {}
        self._next_device_id = 0
        self._queue_time: Dict[Tuple[int, str], float] = {}

    # -- device management (§4.2) ----------------------------------------
    def register_device(self, host_server: int, now: float,
                        gpu: Optional[GPUSpec] = None) -> EdgeDevice:
        did = self._next_device_id
        self._next_device_id += 1
        dev = EdgeDevice(did=did, host_server=host_server,
                         registered_at=now,
                         **({"gpu": gpu} if gpu else {}))
        self.devices[did] = dev
        return dev

    def assign_device_service(self, did: int, service: str,
                              now: float, *, bw_gbs: float = 1.25) -> float:
        """Ship single-GPU weights to the device; returns ready time."""
        dev = self.devices[did]
        svc = self.services[service]
        if cm.min_mp_for_vram(svc, dev.gpu) > 1:
            raise ValueError(f"{service} needs >1 GPU; devices serve "
                             "single-GPU models only (§4.2)")
        dev.service = service
        dev.load_ready_at = now + cm.model_load_time(svc, bw_gbs)
        return dev.load_ready_at

    def deregister_device(self, did: int) -> None:
        self.devices.pop(did, None)

    # -- placement (coarse granularity) ---------------------------------------
    def build_problem(self, demand: Mapping[Tuple[str, int], float], *,
                      priority_list: Sequence[Placement] = ()) \
            -> PlacementProblem:
        return PlacementProblem(
            services=self.services, plans=self.plans, servers=self.servers,
            demand=dict(demand), period_s=self.placement_interval_s,
            priority_list=tuple(priority_list))

    def run_placement(self, demand: Mapping[Tuple[str, int], float], *,
                      priority_list: Sequence[Placement] = ()) \
            -> List[Placement]:
        problem = self.build_problem(demand, priority_list=priority_list)
        self.placements = sssp(problem)
        return self.placements

    # -- synchronized state (medium granularity) ---------------------------
    def local_view(self, sid: int, now: float) -> ServerView:
        services: Dict[str, ServiceState] = {}
        for svc_name, server_id in self.placements:
            if server_id not in (sid, EPSILON_SERVER):
                continue
            svc = self.services[svc_name]
            plan = self.plans[svc_name]
            cross = server_id == EPSILON_SERVER
            p_hat = plan_goodput(svc, self.gpu, plan, cross_server=cross)
            t = self.sync.round_cost_s
            p_act = self.meter.goodput(
                svc_name, window=(now - 2 * max(t, self.sync_interval_s),
                                  now - max(t, self.sync_interval_s)))
            state = services.setdefault(svc_name, ServiceState())
            state.theoretical_goodput += p_hat
            state.actual_goodput = p_act
            state.queue_time_s = self._queue_time.get((sid, svc_name), 0.0)
            state.cross_server = state.cross_server or cross
        # device-served models (lowest local priority)
        for dev in self.devices.values():
            if dev.host_server == sid and dev.service and \
                    now >= dev.load_ready_at:
                st = services.setdefault(dev.service, ServiceState())
                if st.theoretical_goodput == 0.0:
                    st.on_device = True
                st.theoretical_goodput += cm.throughput(
                    self.services[dev.service], dev.gpu)
        return ServerView(sid=sid, services=services)

    def publish_all(self, now: float) -> None:
        for s in self.servers:
            self.sync.publish_local(s.sid, self.local_view(s.sid, now), now)

    def sync_step(self, now: float) -> None:
        self.sync.step(now)

    def set_queue_time(self, sid: int, service: str, seconds: float) -> None:
        self._queue_time[(sid, service)] = seconds

    # -- failure handling (§5.3.3) ----------------------------------------
    def fail_server(self, sid: int, now: float) -> None:
        """Mark a server crashed: the ring heals around it (exchange
        rounds bypass it) and every peer view flags it unavailable.  The
        sid's queued-time feedback is dropped so a later restart starts
        from a clean signal instead of pre-crash backpressure."""
        self.sync.fail(sid)
        for key in [k for k in self._queue_time if k[0] == sid]:
            del self._queue_time[key]

    def repair_server(self, sid: int, now: float) -> None:
        """Restart rejoin: lift the failure flag (the restarted process
        comes back with an empty sync cache) and re-publish its local
        digest so ring rounds re-propagate a FRESH view — peers stop
        excluding it once the new stamp reaches them."""
        self.sync.repair(sid)
        self.sync.publish_local(sid, self.local_view(sid, now), now)

    @property
    def failed_servers(self) -> frozenset:
        return self.sync.failed

    # -- request handling (fine granularity) ---------------------------------
    def handle(self, req: Request, now: float, at_server: int) -> Decision:
        svc = self.services[req.service]
        local = self.local_view(at_server, now)
        peers = self.sync.views_for(at_server, now)
        if at_server in self.sync.failed:
            # degraded mode: a request can't originate AT a dead server —
            # its local state is gone, so only the offload ladder applies
            local = ServerView(sid=at_server, services={}, available=False)
        return self.handlers[at_server].handle(req, now, svc, local, peers)
