"""Dry run: trace every (architecture x input shape) step at its
production shape, with nothing allocated, and persist its roofline terms
(the port of the reference package's ``launch/dryrun.py``).

For each (arch, shape, mesh) the step of ``steps.build_step`` runs under
``FakeTensorMode`` on fake CPU tensors (the kernels' plain versions run
on them, and ``roofline/op_cost.py`` counts each kernel by its own rule):

* per-device static bytes from the spec trees: each argument's shard
  under the reference's sharding rules, summed; ``fits_hbm`` compares
  them with one card's 80 GB (activations and temporaries are not
  counted: the port compiles nothing that would report them);
* FLOPs from ``op_cost``: the port trains and serves these steps
  unsharded, so a device's FLOPs are the whole step's over the mesh's
  size (``"sharded_step": false``);
* bytes from the analytic traffic model (``roofline/analytic.py``), the
  dispatched ops' own bytes beside them.

A combination that cannot trace (an op that needs data fake tensors do
not have) writes ``ok: false`` and its reason, and no estimate.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  python -m repro_torch.launch.dryrun --all --both-meshes

``--multi-pod`` takes the two-server mesh (2, 1, 4); the default is one
edge server of 4 GPUs, (1, 4).  One JSON a (arch, shape, mesh), so the
sweep is resumable.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, config_for_shape,
                                 reduced)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.steps import build_step
from repro_torch.roofline import op_cost
from repro_torch.roofline.analysis import (CARD, HBM_BYTES, Roofline,
                                           format_table,
                                           model_flops_estimate)
from repro_torch.roofline.analytic import traffic


def _mesh_for(multi_pod: bool, mesh_shape: str):
    if mesh_shape:
        dims = tuple(int(x) for x in mesh_shape.split(","))
        axes = ("data", "model") if len(dims) == 2 \
            else ("pod", "data", "model")
        return meshlib.make_mesh(dims, axes)
    return meshlib.make_production_mesh(multi_server=multi_pod)


def static_bytes(mesh, trees, specs) -> int:
    """One device's bytes of the argument trees under their spec trees."""
    total = 0
    for tree, spec in zip(trees, specs):
        flat = dict(meshlib.tree_flatten_with_path(spec))
        for path, leaf in meshlib.tree_flatten_with_path(tree):
            if isinstance(leaf, torch.Tensor):
                total += meshlib.shard_bytes(mesh, leaf, flat[path])
    return total


def run_one(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
            fsdp_params: bool = True, pad_vocab: int = 0,
            microbatches: int = 0, variant: str = "", mesh_shape: str = "",
            reduce: bool = False, traces: Optional[Dict] = None,
            verbose: bool = True) -> dict:
    """Trace one combination and write its JSON (or return the one already
    written).  ``reduce`` traces the arch's reduced config at the same
    shape (tagged ``_reduced``).  ``traces`` caches op counts across
    meshes: the step is the same on every mesh unless its microbatch
    count differs."""
    mesh = _mesh_for(multi_pod, mesh_shape)
    mesh_tag = "mesh" + "x".join(str(n) for n in mesh.shape.values())
    vtag = (f"_{variant}" if variant else "") + ("_reduced" if reduce
                                                  else "")
    name = f"{arch}|{shape_name}|{mesh_tag}{vtag}"
    out_path = os.path.join(out_dir,
                            f"{arch}_{shape_name}_{mesh_tag}{vtag}.json")
    if os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    cfg = config_for_shape(arch, shape_name)
    if reduce:
        cfg = reduced(cfg)
    shape = SHAPES_BY_NAME[shape_name]
    record = dict(arch=arch, shape=shape_name, mesh=mesh_tag,
                  chips=mesh.size, peaks=CARD, sharded_step=False)
    t0 = time.time()
    try:
        bundle = build_step(arch, shape_name, mesh, fsdp_params=fsdp_params,
                            pad_vocab_multiple=pad_vocab or None,
                            microbatches=microbatches or None,
                            reduce=reduce)
        key = (arch, shape_name, bundle.microbatches, pad_vocab, reduce)
        cost = None if traces is None else traces.get(key)
        if cost is None:
            with bundle.mode, op_cost.count() as cost:
                bundle.fn(*bundle.args)
            if traces is not None:
                traces[key] = cost
    except Exception as e:   # noqa: BLE001 -- recorded, the sweep goes on
        if verbose:
            traceback.print_exc()
        record.update(ok=False, reason=f"{type(e).__name__}: {e}"[:500],
                      trace_s=time.time() - t0)
    else:
        static = static_bytes(mesh, bundle.args, bundle.in_specs)
        tb = traffic(cfg, shape, data_ax=mesh.shape["data"],
                     model_ax=mesh.shape["model"],
                     pod_ax=mesh.shape.get("pod", 1),
                     microbatches=bundle.microbatches,
                     optimizer=(bundle.optimizer
                                if bundle.optimizer != "none" else "adamw"),
                     fsdp=fsdp_params)
        roof = Roofline(
            name=name, chips=mesh.size,
            flops_per_device=cost.flops / mesh.size,
            bytes_per_device=tb.total, collective_wire_bytes=0.0,
            collective_counts={},
            memory_stats={"static_bytes_per_device": float(static)},
            model_flops=model_flops_estimate(cfg, shape),
            op_bytes_per_device=cost.bytes / mesh.size,
            traffic_breakdown=tb.to_dict())
        record.update(
            roof.to_dict(), static_bytes_per_device=static,
            fits_hbm=bool(static <= HBM_BYTES), step=bundle.name,
            microbatches=bundle.microbatches, optimizer=bundle.optimizer,
            kernel_calls=cost.kernel_calls, trace_s=time.time() - t0,
            long_context_variant=(
                shape_name == "long_500k"
                and cfg.sliding_window is not None
                and config_for_shape(arch, "train_4k").sliding_window
                is None),
            ok=True)
        if verbose:
            print(f"[{name}] compute={roof.compute_s:.4g}s "
                  f"memory={roof.memory_s:.4g}s dominant={roof.dominant} "
                  f"useful={roof.useful_flops_ratio:.3f} static/device="
                  f"{static / 1e9:.2f} GB (trace {record['trace_s']:.1f}s)")
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def table(records: List[dict]) -> str:
    """The sweep as ``format_table``'s rows, a failed combination as a
    line of its own."""
    rows, failed = [], []
    for r in records:
        if not r.get("ok"):
            failed.append(f"{r['arch']}|{r['shape']}|{r['mesh']}: "
                          f"not traced ({r['reason'][:80]})")
            continue
        rows.append(Roofline(
            name=f"{r['arch']}|{r['shape']}|{r['mesh']}", chips=r["chips"],
            flops_per_device=r["flops_per_device"],
            bytes_per_device=r["bytes_per_device"],
            collective_wire_bytes=r["collective_wire_bytes"],
            collective_counts=r["collective_counts"],
            memory_stats=r["memory_stats"], model_flops=r["model_flops"]))
    return "\n".join([format_table(rows), *failed])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the two-server mesh (2, 1, 4) over "
                         "(pod, data, model)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate weight rows over the data axis (pure TP)")
    ap.add_argument("--pad-vocab", type=int, default=0,
                    help="pad vocab_size to a multiple")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--variant", default="",
                    help="tag for the output filename")
    ap.add_argument("--mesh-shape", default="",
                    help="override the mesh, e.g. 1,8 (data,model)")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs at the same shapes")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES_BY_NAME]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    traces: Dict = {}
    records = [run_one(arch, shape, multi_pod=multi_pod, out_dir=args.out,
                       fsdp_params=not args.no_fsdp,
                       pad_vocab=args.pad_vocab,
                       microbatches=args.microbatches, variant=args.variant,
                       mesh_shape=args.mesh_shape, reduce=args.reduced,
                       traces=traces)
               for multi_pod in meshes for arch, shape in combos]
    print(table(records))
    failed = [r for r in records if not r.get("ok")]
    if failed:
        print(f"\n{len(failed)} of {len(records)} combos did not trace")
        return 1
    print(f"\nall {len(records)} combos traced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
