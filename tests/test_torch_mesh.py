"""The port's sharding rules, step-builder choices and roofline arithmetic
against the reference's, on meshes of shapes only.

For every arch at full width: the parameter, optimizer-state and cache
spec trees (the reference's from ``jax.eval_shape`` trees, the port's
from fake-tensor trees: nothing is allocated on either side) must be
equal leaf by leaf, on the meshes {"data": 4, "model": 8},
{"pod": 2, "data": 16, "model": 16} and {"data": 1, "model": 4}.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import config_for_shape as jconfig_for_shape
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models.config import SHAPES_BY_NAME as JSHAPES
from repro.models.registry import model_api as jmodel_api
from repro.roofline import analysis as janalysis
from repro.roofline import analytic as janalytic
from repro.training.optimizer import get_optimizer as jget_optimizer
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, config_for_shape
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.models.registry import model_api
from repro_torch.roofline import analysis, analytic
from repro_torch.training.optimizer import get_optimizer

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

MESHES = {"4x8": {"data": 4, "model": 8},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x4": {"data": 1, "model": 4}}
_TREES = {}


def _fake_mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _trees(arch):
    """(reference abstract params, port fake params, the port's mode) for
    ``arch``'s train_4k config, built once."""
    if arch not in _TREES:
        jcfg = jconfig_for_shape(arch, "train_4k")
        jp = jax.eval_shape(lambda k: jmodel_api(jcfg).init(k, jcfg),
                            jax.random.PRNGKey(0))
        mode = steps.FakeTensorMode()
        _TREES[arch] = (jp, steps.abstract_params(
            config_for_shape(arch, "train_4k"), mode), mode)
    return _TREES[arch]


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jmesh._path_str(p): tuple(s) for p, s in flat}


def _port_flat(tree):
    return {meshlib._path_str(p): tuple(s)
            for p, s in meshlib.tree_flatten_with_path(tree)}


def _same(ref_specs, port_specs):
    ref, port = _ref_flat(ref_specs), _port_flat(port_specs)
    assert ref.keys() == port.keys()
    diff = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert not diff
    return len(ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch):
    jp, tp, mode = _trees(arch)
    jcfg = jconfig_for_shape(arch, "decode_32k")
    cfg = config_for_shape(arch, "decode_32k")
    shape = SHAPES_BY_NAME["decode_32k"]
    jcache = jax.eval_shape(lambda: jmodel_api(jcfg).init_cache(
        jcfg, shape.global_batch, shape.seq_len))
    cache = model_api(cfg).init_cache(cfg, shape.global_batch,
                                      shape.seq_len, device="meta")
    jopts = {n: jax.eval_shape(jget_optimizer(n).init, jp)
             for n in ("adamw", "adafactor")}
    with mode:
        opts = {n: get_optimizer(n).init(tp) for n in ("adamw", "adafactor")}
    leaves = 0
    for mshape in MESHES.values():
        m = _fake_mesh(mshape)
        for fsdp in (True, False):
            for ep in (True, False):
                jspec = jmesh.param_specs(m, jp, fsdp=fsdp,
                                          expert_parallel=ep)
                spec = meshlib.param_specs(m, tp, fsdp=fsdp,
                                           expert_parallel=ep)
                leaves += _same(jspec, spec)
        jspec, spec = jmesh.param_specs(m, jp), meshlib.param_specs(m, tp)
        for n in jopts:
            leaves += _same(jmesh.opt_state_specs(m, jopts[n], jspec),
                            meshlib.opt_state_specs(m, opts[n], spec))
        for rep in (True, False):
            leaves += _same(jmesh.cache_specs(m, jcache, replicate_batch=rep),
                            meshlib.cache_specs(m, cache,
                                                replicate_batch=rep))
    assert leaves > 0


def test_batch_specs_and_mesh_helpers_equal_the_reference():
    batch = {"tokens": torch.zeros(256, 4096), "labels": torch.zeros(1, 8),
             "embeddings": torch.zeros(6, 16, 32)}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in batch.items()}
    for mshape in MESHES.values():
        m = _fake_mesh(mshape)
        assert jmesh.batch_axes(m) == meshlib.batch_axes(m)
        for name in (None, "data", "model", ("pod", "data"), "nope"):
            assert jmesh.axis_size(m, name) == meshlib.axis_size(m, name)
        for rep in (True, False):
            _same(jmesh.batch_specs(m, jbatch, replicate_batch=rep),
                  meshlib.batch_specs(m, batch, replicate_batch=rep))
    # the production meshes are the edge server's 4 GPUs, one or two
    one = meshlib.make_production_mesh()
    two = meshlib.make_production_mesh(multi_server=True)
    assert one.shape == {"data": 1, "model": 4} and one.size == 4
    assert two.shape == {"pod": 2, "data": 1, "model": 4}
    assert meshlib.batch_axes(two) == ("pod", "data")
    assert meshlib.P(None, "model") == (None, "model")


def test_optimizer_and_microbatch_choices_equal_the_reference():
    for arch in ARCH_IDS:
        for shape in SHAPES_BY_NAME:
            jcfg = jconfig_for_shape(arch, shape)
            cfg = config_for_shape(arch, shape)
            assert jsteps.choose_optimizer(jcfg) == \
                steps.choose_optimizer(cfg)
            for shards in (1, 2, 4, 16, 32):
                assert jsteps.choose_microbatches(
                    jcfg, JSHAPES[shape], shards) == \
                    steps.choose_microbatches(cfg, SHAPES_BY_NAME[shape],
                                              shards)
    assert steps.ADAFACTOR_THRESHOLD == jsteps.ADAFACTOR_THRESHOLD


def test_model_flops_and_traffic_equal_the_reference():
    n = 0
    for arch in ARCH_IDS:
        for shape in SHAPES_BY_NAME:
            jcfg, cfg = jconfig_for_shape(arch, shape), \
                config_for_shape(arch, shape)
            js, s = JSHAPES[shape], SHAPES_BY_NAME[shape]
            assert janalysis.model_flops_estimate(jcfg, js) == \
                analysis.model_flops_estimate(cfg, s)
            opt = steps.choose_optimizer(cfg)
            for m in MESHES.values():
                kw = dict(data_ax=m["data"], model_ax=m["model"],
                          pod_ax=m.get("pod", 1),
                          microbatches=steps.choose_microbatches(
                              cfg, s, m["data"] * m.get("pod", 1)),
                          optimizer=opt)
                for fsdp in (True, False):
                    want = janalytic.traffic(jcfg, js, fsdp=fsdp, **kw)
                    got = analytic.traffic(cfg, s, fsdp=fsdp,
                                           flash_block=janalytic.FLASH_BLOCK,
                                           **kw)
                    assert got.to_dict() == pytest.approx(want.to_dict())
                    n += 1
    assert n == len(ARCH_IDS) * len(SHAPES_BY_NAME) * len(MESHES) * 2
    # the port's own flash block is its q tile: more K/V re-reads
    cfg, s = config_for_shape("minicpm-2b", "train_4k"), \
        SHAPES_BY_NAME["train_4k"]
    kw = dict(data_ax=1, model_ax=4, microbatches=2)
    assert analytic.FLASH_BLOCK == 64
    assert analytic.traffic(cfg, s, **kw).kv_rereads == pytest.approx(
        8 * analytic.traffic(cfg, s, flash_block=512, **kw).kv_rereads)


def test_roofline_terms_use_the_h100_peaks():
    r = analysis.Roofline(name="x", chips=4, flops_per_device=989e12,
                          bytes_per_device=3.35e12 / 2,
                          collective_wire_bytes=450e9 / 4,
                          collective_counts={}, memory_stats={},
                          model_flops=989e12 * 2)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 0.5, 0.25)
    assert r.dominant == "compute" and r.useful_flops_ratio == 0.5
    assert "H100" in analysis.CARD and "700 W" in analysis.CARD
    assert analysis.bound_ms(3.35e9, 0.0) == (1.0, "bytes")
    assert analysis.bound_ms(0, 989e9)[1] == "operations"
    assert "x" in analysis.format_table([r])
