"""Serving launcher: deploy services through the EPARA control plane and
drive requests end to end, as the reference's launcher does.

Each edge server is an ``EparaServingEngine`` in this process.  The EPARA
allocator plans each service, the SSSP placement assigns services to
``--servers`` servers (4 GPUs each, demand 4.0 everywhere), every placement
gets its own ``ServiceRuntime`` (one copy of an arch's weights is shared by
every server hosting it), and every request enters at a drawn server and
is routed by the distributed handler (local first, then idle-goodput
weighted offload).  A ``ClusterSupervisor`` drives the rounds: it feeds
each runtime's queue-time estimate back to the handler, runs a ring sync
round every round, arms deadline-capped retry timeouts with exponential
backoff, evacuates a crashed server's requests to survivors, deduplicates
completions by ``(rid, sample)`` and gives a ``FAILED`` verdict only when
no avenue is left.  ``--fault-spec`` replays a ``FaultSpec`` (JSON) and
``--chaos-seed`` draws one; the launcher then prints the schedule and a
``fault tolerance:`` line, and exits 0 only when every request was served
or rejected with a verdict:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --servers 3 --chaos-seed 1

``--servers`` defaults to 1 here, where the reference's default is 3: on
one 80 GB card, three servers of minicpm-2b at the plan's 512 slots hold
77.0 GB of arenas beside 5.45 GB of weights.  On the card the launcher
sums the weights (once an arch), every placed runtime's arenas and the
draft arenas from the configs and plans before it allocates anything,
adds ``HEADROOM_BYTES`` for what a run holds beyond them, and refuses a
run that does not fit, naming the ``--servers`` count that does; two
servers of minicpm-2b (56.8 GB) fit.

On the card the services run at their full config; with ``--device cpu``
they run ``reduced(full)``, as the reference's CPU data plane does.  The
plan is computed for the allocator's default ``GPUSpec`` (the reference's
target hardware), so it matches the reference's plan.

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b

``--archs`` also takes mamba2-2.7b (the reference's default pair is
``minicpm-2b,mamba2-2.7b``) and whisper-large-v3, whose requests carry
zero frame embeddings, as the reference's do.  At full width neither plan
fits one 80 GB card: the allocator plans both at 512 slots, and a slot
holds 167.8 MB of SSD state (mamba2-2.7b, 86 GB in all) or 245.76 MB of
cross-attention K/V (whisper-large-v3, 125.8 GB).  On the card they run at
128 slots through ``chip_smoke.py``, which asks ``plan_for`` for them; on
the CPU the reduced configs serve at the plan's slots.

``--archs zamba2-7b`` (the hybrid family) fits one card at its own plan
with nothing cut: 256 slots and int8 K/V (a frequency service), 13.58 GB
of bf16 weights beside 45.29 GB of arenas at the default ``--max-seq-len``
256: 152.2 MB of conv and f32 SSD state a slot (38.96 GB) and 6.33 GB of
int8 K/V for the shared block's 13 applications; with ``HEADROOM_BYTES``
63.8 GB.  ``--kv-dtype bf16`` holds 64.8 GB static:

  PYTHONPATH=src python -m repro_torch.launch.serve --archs zamba2-7b

It takes the MoE archs mixtral-8x7b and grok-1-314b too, whose plans need
16 and 64 GPUs: more than a server's 4, so the placement puts them on no
server and, as in the reference, every request ends with a ``FAILED``
verdict.  Their full configs' bf16 weights (93.4 GB and 633 GB) do not
fit one card either, so on the card the launcher refuses them before
allocating anything; ``chip_smoke.py`` serves mixtral-8x7b at 16 of its
32 layers through a runtime of its own.

The radix prefix cache runs at the category's retention unless
``--prefix-cache`` says otherwise (0 turns it off, > 0 retains that many
idle blocks); the launcher prints its hits, reused and computed prompt
tokens, copy-on-write copies and LRU evictions.  ``--mode sync`` serves
run-to-completion batches, ``--kvcache-impl dense`` the pre-arena dense
cache, ``--no-chunked-prefill`` one-shot prefill at admission, as in the
reference (the cache needs chunked prefill on the paged arena, so these
turn it off):

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b \
      --mode sync

``--admission-policy sdf`` orders each step's queue by deadline slack,
sheds the requests that cannot make their ``--deadline-s`` (seconds from
the start of the run, 0 = none) with a verdict, and parks the laziest
decode slot for an urgent request (``--no-preempt`` turns parking off); the
run's clock is then the wall time since the first submission, as in the
reference.  ``--n-samples`` forks n-1 sibling slots off each request's
prompt (capped by the plan's category: minicpm-2b, a frequency service,
forks up to its batch size).  The launcher prints the verdicts,
preemptions and resumes, and exits 0 when every request was served or
rejected with a verdict:

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b \
      --admission-policy sdf --deadline-s 30 --requests 8

``--draft-arch`` names a draft model for speculative decoding: each
same-family same-vocabulary service of a latency plan speculates k tokens
a round (``--speculate``, -1 = the category's k, 4 for latency), the
others deploy without it and print a ``note:`` line.  Weights are seeded
by arch, so a draft of a deployed arch is a self-draft sharing its
tensors; on the card the draft runs its full config.  The launcher prints
the verify launches, the accepted tokens a launch, the draft steps and
the degraded slots:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --archs minicpm-2b,minitron-4b --draft-arch minitron-4b

``--pjit-decode`` splits every service by heads over the service mesh
(1, device count), EPARA's model-parallel mode (``launch/steps.py``
``ShardedPagedStep``); over several cards each draws and holds its shards
alone (``init_sharded``).  It serves the paged continuous path of all six
families: the paged-native decode and chunk steps, the dense-view step (a
ring layout, as mixtral-8x7b's past its 4096-token window) and
``--no-chunked-prefill``'s one-shot prefill (an audio request's frames
and a VLM request's image rows reach every shard), and for the dense and
MoE families also a draft (a self-draft shares its service's shards and
splits its draft arena; a draft of another arch runs whole on the first
card).  As in the reference, whose builder wraps the paged decode step
alone, ``--mode sync`` and ``--kvcache-impl dense`` run each service
whole on the first card: the launcher draws whole trees and prints a
line saying so.  It refuses, before allocating, head counts that would
split head_dim and more than one SSD group (ROADMAP.md Queue 1 item 15):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --pjit-decode --archs minitron-4b --draft-arch minitron-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --pjit-decode --no-chunked-prefill --archs whisper-large-v3

``--trace-out``, ``--metrics-out`` and ``--calibrate-out`` write the run's
spans (Chrome trace-event JSON), metrics (Prometheus text, or a JSONL
snapshot for a ``.jsonl`` path) and simulator calibration (JSON), through
one tracer and one registry shared by every runtime, as the reference's
``make obs-smoke`` does:

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b \
      --requests 6 --max-new-tokens 4 --trace-out trace.json \
      --metrics-out metrics.prom --calibrate-out calibration.json
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import zlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core import EdgeCloudControlPlane, ServerSpec
from repro_torch.core.allocator import allocate
from repro_torch.core.categories import GPUSpec, Sensitivity, ServiceSpec
from repro_torch.core.faults import (FaultInjector, FaultSpec,
                                     random_fault_spec)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import launch_counts
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.steps import (abstract_params,
                                      init_sharded, leaf_split,
                                      paged_decode_builder, state_split,
                                      tp_refusal)
from repro_torch.models.registry import model_api
from repro_torch.obs import (MetricsRegistry, Tracer, merge_telemetry,
                             telemetry_from_runtime, write_calibration)
from repro_torch.serving import kvcache
from repro_torch.serving.arena import KVArena, shard_size
from repro_torch.serving.engine import (PREFIX_CACHEABLE_FAMILIES,
                                        SELF_DRAFT, EparaServingEngine,
                                        GenerationRequest, ServiceRuntime)
from repro_torch.serving.failover import ClusterSupervisor, RetryPolicy

# reference flags that are accepted but only at their defaults: the value
# that would need an unported part names the ROADMAP.md item porting it
# (none left)
_UNPORTED_FLAGS: Tuple = ()
# what a run holds on the card beyond its weights and arenas.  Measured on
# an H100 80GB HBM3 (700 W): the caching allocator's peak reserve ran up to
# 4.15 GB above the static sum (--archs minicpm-2b,minitron-4b
# --draft-arch minitron-4b; 3.83 GB for two servers of minicpm-2b serving
# 64 requests of 32 new tokens), and the CUDA context and libraries hold
# 0.72 GB outside it.  chip_smoke.py's phase 13 prints each run's peaks
# beside its static sum
HEADROOM_BYTES = 4.9e9


def service_spec_for(cfg) -> ServiceSpec:
    return ServiceSpec(
        name=cfg.name,
        flops_per_request=2.0 * cfg.active_param_count() * 64,
        weights_bytes=cfg.param_count() * 2.0,
        vram_bytes=cfg.param_count() * 2.0 * 1.5 + 5e8,
        sensitivity=Sensitivity(cfg.epara_sensitivity),
        slo_latency_s=2.0, slo_fps=20.0 if
        cfg.epara_sensitivity == "frequency" else 0.0,
        arch=cfg.name, stateful=cfg.family in ("ssm", "hybrid"),
        prefix_cacheable=cfg.family in PREFIX_CACHEABLE_FAMILIES)


def plan_for(full, kv_dtype=-1, bs=None, prefix_cache=-1):
    """The allocator's plan for config ``full`` on the default ``GPUSpec``,
    with ``kv_dtype`` and ``prefix_cache`` (-1 = the category's choice for
    either), and ``bs`` slots if given (the allocator's own ``user_bs``;
    None = its profile)."""
    return dataclasses.replace(
        allocate(service_spec_for(full), GPUSpec(), user_bs=bs),
        prefix_cache=prefix_cache, kv_dtype=kv_dtype)


def control_plane(arch_ids, n_servers: int) -> EdgeCloudControlPlane:
    """The reference's control plane: ``n_servers`` servers of 4 GPUs, each
    arch's service spec from its full config, SSSP placement at demand 4.0
    for every (service, server) pair."""
    servers = [ServerSpec(sid=i, num_gpus=4) for i in range(n_servers)]
    cp = EdgeCloudControlPlane(
        servers, {a: service_spec_for(get_config(a)) for a in arch_ids})
    cp.run_placement({(a, s.sid): 4.0 for a in arch_ids for s in servers})
    return cp


def deployed_plan(cp: EdgeCloudControlPlane, svc: str, args):
    """``cp``'s plan for ``svc`` with the flags' knobs replaced in."""
    return dataclasses.replace(
        cp.plans[svc], prefix_cache=args.prefix_cache,
        kv_dtype=-1 if args.kv_dtype == "auto" else args.kv_dtype,
        admission=args.admission_policy, speculate=args.speculate)


def draft_compatible(cfg, draft_cfg) -> bool:
    """The draft pairs only with same-family same-vocab services of a
    cacheable family."""
    return (draft_cfg is not None and cfg.family == draft_cfg.family
            and cfg.vocab_size == draft_cfg.vocab_size
            and cfg.family in PREFIX_CACHEABLE_FAMILIES)


def self_drafts(svc: str, args, tp: int) -> bool:
    """Whether ``svc``'s draft runs through its own head-sharded step
    (``SELF_DRAFT``): over several model shards, a draft of the service's
    own arch shares its shards; a draft of another arch runs whole on the
    first card."""
    return tp > 1 and args.draft_arch == svc


def _arena_bytes(cfg, plan, args, kv_dtype: str, tp: int = 1) -> int:
    """One DP group's arena on the first device of ``tp`` model shards
    (its pools split by kv head, its per-slot state by ``state_split``),
    built on the meta device (nothing allocated)."""
    arena = KVArena(cfg, model_api(cfg).init_cache,
                    capacity=plan.max_in_flight, max_seq_len=args.max_seq_len,
                    block_size=args.block_size, kv_dtype=kv_dtype,
                    device="meta",
                    shard_devices=["meta"] * tp if tp > 1 else None,
                    state_split=lambda key: state_split(cfg, key))
    return arena.shard_bytes(0)


def _shard_weight_bytes(cfg, mesh) -> int:
    """Bytes of the first model shard's weights as the head-sharded step
    splits them (``steps.leaf_split`` over ``param_specs(fsdp=False)``),
    from the abstract tree: a split leaf's split sections divided by the
    shards, its whole ones and a whole leaf entire."""
    params = abstract_params(cfg)
    specs = dict(meshlib.tree_flatten_with_path(
        meshlib.param_specs(mesh, params, fsdp=False)))
    tp = mesh.shape["model"]
    total = 0
    for path, p in meshlib.tree_flatten_with_path(params):
        n = p.numel() * p.element_size()
        split = leaf_split(cfg, path, specs[path]) if tp > 1 else None
        if split is not None:
            dim, sections = split
            size = p.shape[dim]
            n = n // size * shard_size(sections or ((size, True),), tp)
        total += n
    return total


def runs_whole(args) -> bool:
    """Whether ``args``' services run whole on one device whatever the
    service mesh: sync and the dense cache, which the head-sharded step
    does not split (the runtime builds it on the paged continuous path
    only, as the reference's engine calls its builder there alone)."""
    return args.mode != "continuous" or args.kvcache_impl != "paged"


def _dense_cache_bytes(cfg, plan, args) -> int:
    """One DP group's dense cache (sync batches, the dense engine's merged
    batch) at the plan's batch and ``--max-seq-len``, built on the meta
    device."""
    return kvcache.cache_bytes(model_api(cfg).init_cache(
        cfg, plan.max_in_flight, args.max_seq_len, device="meta"))


def service_mesh(device):
    """``--pjit-decode``'s service mesh: (1, device count) over the card's
    devices, as the reference builds (1, jax.device_count()), or (1, 1) on
    the CPU."""
    if device.type == "cuda":
        n = torch.cuda.device_count()
        return meshlib.make_mesh((1, n), ("data", "model"),
                                 [torch.device("cuda", i) for i in range(n)])
    return meshlib.make_mesh((1, 1), ("data", "model"), [device])


def footprint(args, cp=None, mesh=None) -> Tuple[int, int]:
    """(weight bytes, arena bytes) that the run of ``args`` holds on the
    card at full width, computed from the configs and plans without
    allocating: each distinct arch's bf16 weights once (the draft's too),
    and the arenas of every placed runtime, one a DP group, with a bf16
    draft arena beside each group of a service that speculates.  With a
    service ``mesh`` of several model shards (``--pjit-decode``), the
    first card's share, the most any card holds: the first shard's
    weights (``init_sharded`` draws no whole tree), pools and per-slot
    state, a self-draft's arena split as its service's (``self_drafts``)
    and a draft of another arch whole, weights and arena.  A sync or
    dense-cache service (``runs_whole``) holds its whole weights and its
    dense caches, one a DP group, on the first card."""
    arch_ids = [a.strip() for a in args.archs.split(",")]
    if cp is None:
        cp = control_plane(arch_ids, args.servers)
    tp = 1 if mesh is None else mesh.shape["model"]
    archs = set(arch_ids) | ({args.draft_arch} if args.draft_arch else set())
    draft = get_config(args.draft_arch) if args.draft_arch else None
    placed = sorted({svc for svc, sid in cp.placements if sid >= 0})
    if tp == 1 or runs_whole(args):
        weights = sum(get_config(a).param_count() * 2 for a in archs)
    else:
        weights = sum(_shard_weight_bytes(get_config(a), mesh)
                      for a in arch_ids)
        if any(draft_compatible(get_config(svc), draft)
               and not self_drafts(svc, args, tp) for svc in placed):
            weights += draft.param_count() * 2
    arenas = 0
    for svc, sid in sorted(set(cp.placements)):
        if sid < 0:
            continue
        full, plan = get_config(svc), deployed_plan(cp, svc, args)
        if runs_whole(args):
            arenas += _dense_cache_bytes(full, plan, args) * max(1, plan.dp)
            continue
        group = _arena_bytes(full, plan, args, plan.resolved_kv_dtype(), tp)
        if draft_compatible(full, draft) \
                and plan.resolved_speculate(True) > 0:
            group += _arena_bytes(draft, plan, args, "bf16",
                                  tp if self_drafts(svc, args, tp) else 1)
        arenas += group * max(1, plan.dp)
    return weights, arenas


def _refuse_what_tp_cannot_serve(args, cfgs, cp, mesh, draft_cfg) -> None:
    """Raise before anything is allocated when ``--pjit-decode`` would put
    a placed service on a path the head-sharded step does not serve."""
    tp = mesh.shape["model"]
    for svc in sorted({s for s, sid in cp.placements if sid >= 0}):
        cfg = cfgs[svc]
        why = tp_refusal(cfg, tp, mode=args.mode,
                         kvcache_impl=args.kvcache_impl,
                         draft=draft_compatible(cfg, draft_cfg))
        if why is not None:
            raise ValueError(f"--pjit-decode: {why}")


PROMPT_TOKENS = 6               # the launcher's prompt length


def _refuse_requests_over_the_budget(args, cfgs) -> None:
    """Raise before anything is allocated when the launcher's requests
    cannot fit a slot: on the paged continuous path each takes its prompt,
    the VLM's image prefix and its new tokens out of ``--max-seq-len``
    (which the engine would otherwise refuse at submit, request by
    request)."""
    if args.mode != "continuous" or args.kvcache_impl != "paged":
        return
    for a, cfg in cfgs.items():
        extra = cfg.prefix_len if cfg.family == "vlm" else 0
        need = PROMPT_TOKENS + extra + args.max_new_tokens
        if need > args.max_seq_len:
            prefix = f" + {extra} image-prefix" if extra else ""
            raise ValueError(
                f"{a}'s requests need {PROMPT_TOKENS} prompt{prefix} + "
                f"{args.max_new_tokens} new = {need} cache tokens, over "
                f"--max-seq-len {args.max_seq_len}; pass --max-seq-len "
                f"{need} or more")


def _refuse_what_does_not_fit(args, arch_ids, cp, have: int,
                              mesh=None) -> None:
    """Raise before anything is allocated when the weights of an arch, or
    the whole run with ``HEADROOM_BYTES``, exceed the card's memory (the
    first card's share over a service ``mesh``)."""
    tp = 1 if mesh is None or runs_whole(args) else mesh.shape["model"]
    for a in arch_ids + ([args.draft_arch] if args.draft_arch else []):
        need = (get_config(a).param_count() * 2
                if tp == 1 or a not in arch_ids
                else _shard_weight_bytes(get_config(a), mesh))
        if need > have:
            smoke = ("chip_smoke.py serves it at 16 of its 32 layers, "
                     if a == "mixtral-8x7b" else "")
            shard = f" (one of {tp} shards)" if tp > 1 else ""
            raise RuntimeError(
                f"{a}'s bf16 weights{shard} ({need / 1e9:.1f} GB) exceed "
                f"the card's memory ({have / 1e9:.1f} GB) at full width; "
                f"{smoke}--device cpu serves its reduced config")
    weights, arenas = footprint(args, cp, mesh)
    if weights + arenas + HEADROOM_BYTES <= have:
        return
    fits = next((n for n in range(args.servers - 1, 0, -1)
                 if sum(footprint(argparse.Namespace(**{**vars(args),
                                                       "servers": n}),
                                  mesh=mesh))
                 + HEADROOM_BYTES <= have), None)
    hint = (f"--servers {fits} fits" if fits is not None else
            "no --servers count fits at these flags")
    raise RuntimeError(
        f"the run needs {(weights + arenas) / 1e9:.2f} GB on the card "
        f"({weights / 1e9:.2f} GB of weights, {arenas / 1e9:.2f} GB of "
        f"arenas over {args.servers} server(s)) plus "
        f"{HEADROOM_BYTES / 1e9:.1f} GB of headroom, over the card's "
        f"{have / 1e9:.2f} GB; {hint}, and --device cpu serves the reduced "
        f"configs")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="minicpm-2b")
    ap.add_argument("--servers", type=int, default=1,
                    help="edge servers, each an engine in this process "
                         "(the reference's default of 3 does not fit one "
                         "card at full width)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seq-len", type=int, default=256,
                    help="per-slot token budget the paged arena is sized "
                         "for (prompt + max_new_tokens)")
    ap.add_argument("--block-size", type=int, default=32,
                    help="paged-arena block size in tokens")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunk bucket size in tokens (0 = the plan's "
                         "category-derived default)")
    ap.add_argument("--kv-dtype", default="auto",
                    help="paged-KV pool precision: 'auto' = the plan's "
                         "category-derived choice, or 'bf16'/'int8'")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, full configs) or 'cpu' (reduced "
                         "configs)")
    ap.add_argument("--trace-out", default="",
                    help="write the request and engine spans here "
                         "(Chrome trace-event JSON)")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics here: a JSONL snapshot for a "
                         ".jsonl path, else Prometheus text")
    ap.add_argument("--calibrate-out", default="",
                    help="write the simulator calibration derived from the "
                         "run here (JSON)")
    ap.add_argument("--mode", choices=("continuous", "sync"),
                    default="continuous",
                    help="serving data plane: slot-based continuous "
                         "batching (default) or run-to-completion batches")
    ap.add_argument("--kvcache-impl", choices=("paged", "dense"),
                    default="paged",
                    help="cache data plane: the fixed-capacity paged KV "
                         "arena (default) or the dense merge path")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="prefill each prompt in one shot at admission "
                         "instead of in chunks inside the decode loop")
    ap.add_argument("--prefix-cache", type=int, default=-1,
                    help="radix prefix-cache retention: -1 = the plan's "
                         "category-derived bound (frequency retains the "
                         "whole pool, latency a quarter), 0 = disabled, "
                         ">0 = max idle cached blocks")
    ap.add_argument("--admission-policy", choices=("fifo", "sdf"),
                    default="fifo",
                    help="admission control: arrival-order fifo (default) "
                         "or strictest-deadline-first: slack-ordered "
                         "queues, explicit reject verdicts, and preemption "
                         "of lazy decodes by block-table parking")
    ap.add_argument("--no-preempt", action="store_true",
                    help="with --admission-policy=sdf, disable block-table "
                         "parking (shed-only admission control)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request completion deadline in seconds from "
                         "submission (0 = none)")
    ap.add_argument("--n-samples", type=int, default=1,
                    help="parallel samples per request: n-1 sibling slots "
                         "fork off the prompt's blocks by refcount and "
                         "diverge copy-on-write (capped by the plan's "
                         "resolved_n_samples)")
    ap.add_argument("--speculate", type=int, default=-1,
                    help="speculative decoding draft depth k: -1 = the "
                         "plan's category default (latency services "
                         "speculate when a draft is given, frequency "
                         "services do not), 0 = off, > 0 = propose k tokens "
                         "a fused verify launch (requires --draft-arch)")
    ap.add_argument("--draft-arch", default="",
                    help="arch id of the draft model that proposes tokens "
                         "for speculative decoding; services of another "
                         "family or vocabulary deploy without speculation")
    ap.add_argument("--fault-spec", default="",
                    help="replay a deterministic fault schedule from this "
                         "JSON file (core/faults.py FaultSpec) against "
                         "the run: crashes/restarts, stragglers, digest "
                         "corruption, dropped offload handoffs")
    ap.add_argument("--chaos-seed", type=int, default=-1,
                    help="generate a random (but seed-deterministic) "
                         "fault schedule instead of --fault-spec; -1 = "
                         "no injected faults (default)")
    ap.add_argument("--chaos-horizon-s", type=float, default=20.0,
                    help="time horizon the generated --chaos-seed "
                         "schedule spreads its events over (logical "
                         "rounds unless --admission-policy=sdf)")
    ap.add_argument("--retry-timeout-s", type=float, default=8.0,
                    help="base offload/handoff timeout before a request "
                         "retries on the next-best peer (exponential "
                         "backoff per attempt)")
    ap.add_argument("--retry-max-attempts", type=int, default=4,
                    help="placement attempts per request before a dead "
                         "avenue draws an explicit FAILED verdict")
    ap.add_argument("--pjit-decode", action="store_true",
                    help="serve each service split by heads over the "
                         "service mesh (1, device count): the paged decode "
                         "and chunk steps, the dense-view step and one-shot "
                         "prefill, and for the dense and MoE families "
                         "speculation's verify and draft, run shard by "
                         "shard (EPARA's model-parallel mode); --mode sync "
                         "and --kvcache-impl dense run whole on the first "
                         "device")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    for name, default, item in _UNPORTED_FLAGS:
        value = getattr(args, name)
        if value != default:
            flag = "--" + name.replace("_", "-")
            ap.error(f"{flag}={value!r} is not ported to repro_torch yet "
                     f"({item}); only {default!r} is")
    if args.servers < 1:
        ap.error(f"--servers must be >= 1, got {args.servers}")
    if args.block_size < 1:
        ap.error(f"--block-size must be positive, got {args.block_size}")
    if args.prefill_chunk < 0 or (args.prefill_chunk
                                  and args.prefill_chunk % args.block_size):
        ap.error(f"--prefill-chunk must be 0 (category default) or a "
                 f"positive multiple of --block-size={args.block_size}, "
                 f"got {args.prefill_chunk}")
    if args.prefix_cache < -1:
        ap.error(f"--prefix-cache must be -1 (category default), 0 "
                 f"(disabled) or a positive block count, got "
                 f"{args.prefix_cache}")
    if args.kv_dtype not in ("auto", "bf16", "int8"):
        ap.error(f"--kv-dtype must be auto (category default), bf16 or "
                 f"int8, got {args.kv_dtype!r}")
    if args.kv_dtype == "int8" and args.kvcache_impl != "paged":
        ap.error("--kv-dtype=int8 requires --kvcache-impl=paged (only "
                 "page pools are block-quantized)")
    if args.admission_policy != "fifo" and args.mode != "continuous":
        ap.error("--admission-policy=sdf requires --mode=continuous (the "
                 "controller acts between composer and slot engine)")
    if args.deadline_s < 0:
        ap.error(f"--deadline-s must be >= 0, got {args.deadline_s}")
    if args.speculate < -1:
        ap.error(f"--speculate must be -1 (category default), 0 "
                 f"(disabled) or a positive draft depth, got "
                 f"{args.speculate}")
    if args.speculate > 0 and not args.draft_arch:
        ap.error("--speculate > 0 requires --draft-arch (the model that "
                 "proposes the k tokens)")
    if args.draft_arch and args.draft_arch not in ARCH_IDS:
        ap.error(f"unknown --draft-arch {args.draft_arch!r}")
    if args.draft_arch and (args.mode != "continuous"
                            or args.kvcache_impl != "paged"
                            or args.no_chunked_prefill):
        ap.error("--draft-arch requires --mode=continuous, "
                 "--kvcache-impl=paged and chunked prefill (the draft "
                 "cache is chased through the paged chunk path)")
    if args.n_samples < 1:
        ap.error(f"--n-samples must be >= 1, got {args.n_samples}")
    if args.fault_spec and args.chaos_seed >= 0:
        ap.error("--fault-spec and --chaos-seed are mutually exclusive "
                 "(a replayed schedule IS the seed's output)")
    if args.retry_timeout_s <= 0:
        ap.error(f"--retry-timeout-s must be positive, got "
                 f"{args.retry_timeout_s}")
    if args.retry_max_attempts < 1:
        ap.error(f"--retry-max-attempts must be >= 1, got "
                 f"{args.retry_max_attempts}")
    arch_ids = [a.strip() for a in args.archs.split(",")]
    for a in arch_ids:
        if a not in ARCH_IDS:
            ap.error(f"unknown arch {a!r}; known: {ARCH_IDS}")
    device = resolve_device(args.device)

    cfgs = {a: get_config(a) if device.type == "cuda"
            else reduced(get_config(a)) for a in arch_ids}
    _refuse_requests_over_the_budget(args, cfgs)

    # control plane: EPARA allocator + SSSP placement + handler
    cp = control_plane(arch_ids, args.servers)
    placements = cp.placements
    mesh = step_builder = None
    if args.pjit_decode:
        mesh = service_mesh(device)
        draft_cfg = None
        if args.draft_arch:
            full = get_config(args.draft_arch)
            draft_cfg = full if device.type == "cuda" else reduced(full)
        _refuse_what_tp_cannot_serve(args, cfgs, cp, mesh, draft_cfg)
        step_builder = paged_decode_builder(mesh)
    if device.type == "cuda":
        _refuse_what_does_not_fit(
            args, arch_ids, cp,
            torch.cuda.get_device_properties(device).total_memory, mesh)
    plans = {a: deployed_plan(cp, a, args) for a in arch_ids}
    print("EPARA plans:")
    for a, plan in plans.items():
        print(f"  {a:20s} {plan.category} mp={plan.mp} bs={plan.bs} "
              f"mt={plan.mt} mf={plan.mf} dp={plan.dp} "
              f"kv={plan.resolved_kv_dtype()}")
    print(f"placements: {placements}")
    if mesh is not None:
        print(f"service mesh: {dict(mesh.shape)} over "
              f"{[str(d) for d in mesh.devices]} (tp={mesh.shape['model']})")
        if runs_whole(args):
            print(f"  note: --mode {args.mode} --kvcache-impl "
                  f"{args.kvcache_impl}: each service runs whole on "
                  f"{mesh.devices[0]} (the head-sharded step splits the "
                  f"paged continuous path only)")

    # data plane: one engine per server
    engines = {s.sid: EparaServingEngine() for s in cp.servers}
    # one tracer and one registry shared by every runtime: service names
    # become trace processes and metric labels
    tracer = Tracer() if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics_out else None
    # weights are seeded per arch: one copy an arch, shared by every
    # server hosting it, and a draft of a deployed arch is a self-draft
    weights = {}

    def params_of(arch, cfg):
        if arch not in weights:
            weights[arch] = model_api(cfg).init(
                zlib.crc32(arch.encode()) + args.seed, cfg, device)
        return weights[arch]

    def sharded_of(arch, cfg):
        """(None, a builder over the arch's shards) over several model
        shards: each card draws and holds its shards alone."""
        key = ("shards", arch)
        if key not in weights:
            weights[key] = init_sharded(
                zlib.crc32(arch.encode()) + args.seed, cfg, mesh)
        return None, paged_decode_builder(mesh, shards=weights[key])

    tp = 1 if mesh is None else mesh.shape["model"]
    split = tp > 1 and not runs_whole(args)
    draft_cfg = None
    if args.draft_arch:
        full = get_config(args.draft_arch)
        draft_cfg = full if device.type == "cuda" else reduced(full)

    def draft_of(svc):
        """(draft_params, draft_cfg) of a compatible service: over several
        model shards, a self-draft shares the service's shards
        (``SELF_DRAFT``: ``params_of`` would draw a whole tree that no
        card holds); otherwise the draft arch's whole tree."""
        if self_drafts(svc, args, tp):
            return SELF_DRAFT, None
        return params_of(args.draft_arch, draft_cfg), draft_cfg

    for svc, sid in placements:
        if sid < 0:
            continue
        cfg = cfgs[svc]
        # the rest deploy without speculation (an explicit --speculate > 0
        # still reaches the engine's gate)
        compat = draft_compatible(cfg, draft_cfg)
        if draft_cfg is not None and not compat and args.speculate <= 0:
            print(f"  note: {svc} incompatible with draft "
                  f"{args.draft_arch} (family/vocab) — non-speculative")
        params, builder = (sharded_of(svc, cfg) if split
                           else (params_of(svc, cfg), step_builder))
        draft_params, dcfg = draft_of(svc) if compat else (None, None)
        engines[sid].deploy(svc, ServiceRuntime(
            cfg, params, plans[svc], mode=args.mode,
            kvcache_impl=args.kvcache_impl, max_seq_len=args.max_seq_len,
            block_size=args.block_size,
            chunked_prefill=False if args.no_chunked_prefill else None,
            prefill_chunk=(args.prefill_chunk or None),
            preempt=not args.no_preempt, device=device,
            draft_params=draft_params, draft_cfg=dcfg,
            paged_step_builder=builder, tracer=tracer, metrics=metrics))

    # drive requests through handler -> engine, supervised: the supervisor
    # owns the ledger (every rid ends served or verdicted), the
    # deadline-capped retry timeouts and, under a fault schedule, crash
    # evacuation and failover
    cp.publish_all(0.0)
    for _ in range(len(cp.servers)):
        cp.sync_step(0.0)
    fault_spec = None
    if args.fault_spec:
        with open(args.fault_spec) as f:
            fault_spec = FaultSpec.from_json(f.read())
    elif args.chaos_seed >= 0:
        fault_spec = random_fault_spec(
            [s.sid for s in cp.servers], args.chaos_horizon_s,
            seed=args.chaos_seed)
    if fault_spec is not None:
        print(f"fault schedule ({len(fault_spec.events)} events): "
              + ", ".join(f"{e.kind}@{e.at_s:.1f}s->s{e.sid}"
                          for e in fault_spec.events))
    supervisor = ClusterSupervisor(
        cp, engines,
        retry=RetryPolicy(base_timeout_s=args.retry_timeout_s,
                          max_attempts=args.retry_max_attempts),
        injector=FaultInjector(fault_spec) if fault_spec else None,
        metrics=metrics, tracer=tracer)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        svc = arch_ids[i % len(arch_ids)]
        at = int(rng.integers(0, args.servers))
        cfg = cfgs[svc]
        prompt = rng.integers(0, cfg.vocab_size,
                              size=PROMPT_TOKENS).astype(np.int32)
        extras = None
        if cfg.family == "audio":
            extras = {"embeddings": np.zeros((cfg.encoder_len, cfg.d_model),
                                             np.float32)}
        elif cfg.family == "vlm":
            extras = {"embeddings": np.zeros((cfg.prefix_len, cfg.d_model),
                                             np.float32)}
        supervisor.submit(svc, GenerationRequest(
            rid=i, tokens=prompt, max_new_tokens=args.max_new_tokens,
            stream=i, extras=extras, n_samples=args.n_samples,
            deadline_s=args.deadline_s), at_server=at, now=0.0)
    launches0 = launch_counts()
    # monotonic, not wall-clock: deadlines must not jump when the system
    # clock is slewed.  Under sdf the data-plane clock is seconds since t0
    # (the deadlines and the admission controller's estimates live in
    # it); under fifo the supervisor's logical clock steps a round at a
    # time
    t0 = time.monotonic()
    clock = ((lambda: time.monotonic() - t0)
             if args.admission_policy == "sdf" else None)
    report = supervisor.run_until_idle(clock=clock)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    results = report.results
    toks = sum(len(r.tokens) for r in results)
    rts = [rt for eng in engines.values() for rt in eng.runtimes.values()]
    steps = sum(rt.decode_steps for rt in rts)
    chunks = sum(rt.prefill_chunk_calls for rt in rts)
    oneshot = sum(rt.oneshot_prefills for rt in rts)
    primaries = sum(1 for r in results if r.sample == 0)
    print(f"served {primaries}/{args.requests} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s, {steps} fused "
          f"decode steps, {chunks} prefill chunks, {oneshot} one-shot "
          f"prefills, mode={args.mode}, kvcache={args.kvcache_impl}, "
          f"device={device})  outcomes={report.outcomes}")
    print(f"prefix cache: {sum(rt.prefix_hits for rt in rts)} hits, "
          f"{sum(rt.prefix_hit_tokens for rt in rts)} prompt tokens reused, "
          f"{sum(rt.prefill_tokens_computed for rt in rts)} computed, "
          f"{sum(rt.prefix_cow_copies for rt in rts)} COW copies, "
          f"{sum(rt.prefix_evictions for rt in rts)} LRU evictions, "
          f"{oneshot} one-shot prefills")
    ver = sum(rt.verify_launches for rt in rts)
    acc = sum(rt.accepted_tokens for rt in rts)
    if ver or args.draft_arch:
        per = acc / ver if ver else 0.0
        print(f"speculative (draft={args.draft_arch or 'none'}): {ver} "
              f"verify launches, {acc} tokens accepted "
              f"({per:.2f}/launch), "
              f"{sum(rt.draft_steps for rt in rts)} draft steps, "
              f"{sum(rt.spec_degraded for rt in rts)} degraded, "
              f"{sum(rt.verify_traces for rt in rts)} verify compiles")
    forks = sum(rt.forks_spawned for rt in rts)
    if forks or args.n_samples > 1:
        print(f"parallel sampling (n={args.n_samples}): {forks} forks "
              f"spawned, {sum(rt.fork_shortfall for rt in rts)} shortfall")
    verdicts = {}
    for rt in rts:
        for v, n in rt.admission.verdicts.items():
            verdicts[v] = verdicts.get(v, 0) + n
    print(f"admission ({args.admission_policy}): "
          f"{verdicts or 'no verdicts'}, "
          f"{sum(rt.admission.preemptions for rt in rts)} preemptions, "
          f"{sum(rt.admission.resumes for rt in rts)} resumes, "
          f"{report.offload_retries} offload/timeout retries, "
          f"{len(report.rejects)} final rejects")
    if fault_spec is not None or report.failovers or report.duplicates:
        print(f"fault tolerance: {report.failovers} crash failovers, "
              f"{report.evacuated} requests evacuated, "
              f"{report.duplicates} duplicate completions deduplicated, "
              f"{report.dropped_offloads} handoffs dropped, "
              f"{report.heartbeat_misses} straggler rounds skipped, "
              f"{sum(rt.evacuations for rt in rts)} runtime evacuations")
    print("kernel launches: " + ", ".join(
        f"{k}={v - launches0[k]}" for k, v in launch_counts().items()))
    if tracer is not None:
        tracer.export(args.trace_out)
        print(f"trace: {tracer.emitted} events "
              f"({tracer.dropped} dropped by the ring) -> {args.trace_out}")
    if metrics is not None:
        if args.metrics_out.endswith(".jsonl"):
            metrics.append_jsonl(args.metrics_out)
        else:
            metrics.write_prometheus(args.metrics_out)
        print(f"metrics: {len(metrics._metrics)} series -> "
              f"{args.metrics_out}")
    if args.calibrate_out:
        tel = merge_telemetry(telemetry_from_runtime(name, rt)
                              for eng in engines.values()
                              for name, rt in eng.runtimes.items())
        cal = write_calibration(args.calibrate_out, tel)
        print(f"calibration: spec_accept_rate={cal.spec_accept_rate:.3f} "
              f"prefix_hit_rates={cal.prefix_hit_rates or {}} "
              f"prefill_token_s={cal.prefill_token_s:.2e} -> "
              f"{args.calibrate_out}")
    # every request is accounted for: served, or rejected with a verdict
    return 0 if report.accounted == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
