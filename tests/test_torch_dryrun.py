"""The port's dry run (``launch/dryrun.py``) on reduced configs at the
production shapes: each kind of step (train, prefill, decode) traces
under ``FakeTensorMode`` with nothing allocated and writes its JSON; a
combination that cannot trace writes ``ok: false`` with its reason and
no estimate."""
import json

import pytest
import torch

from repro_torch.configs import config_for_shape, reduced
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.roofline.analysis import model_flops_estimate

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_reduced_dry_run_writes_its_json(tmp_path, shape):
    rec = dryrun.run_one("minicpm-2b", shape, multi_pod=False,
                         out_dir=str(tmp_path), reduce=True, verbose=False)
    path = tmp_path / f"minicpm-2b_{shape}_mesh1x4_reduced.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert rec["ok"] and rec["chips"] == 4 and rec["mesh"] == "mesh1x4"
    assert rec["sharded_step"] is False and "H100" in rec["peaks"]
    assert rec["fits_hbm"] and 0 < rec["static_bytes_per_device"] < 80e9
    cfg = reduced(config_for_shape("minicpm-2b", shape))
    assert rec["model_flops"] == model_flops_estimate(cfg,
                                                      SHAPES_BY_NAME[shape])
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    # each kernel counted by its own rule: attention calls a layer
    calls = rec["kernel_calls"]
    if shape == "train_4k":
        mb = rec["microbatches"]
        assert rec["optimizer"] == "adamw" and mb == 2
        # forward and checkpointed recompute, then the backward
        assert calls == {"flash_attention": 2 * 2 * mb,
                         "flash_attention_bwd": 2 * mb}
    elif shape == "prefill_32k":
        assert calls == {"flash_attention": 2}
    else:
        assert calls == {"decode_attention": 2}
    # a second mesh reuses the trace: the same FLOPs over twice the chips
    again = dryrun.run_one("minicpm-2b", shape, multi_pod=True,
                           out_dir=str(tmp_path), reduce=True, verbose=False,
                           traces={})
    assert again["chips"] == 8 and again["mesh"] == "mesh2x1x4"


def test_a_combination_that_cannot_trace_records_why(tmp_path):
    # 256 rows do not split into 3 microbatches
    rec = dryrun.run_one("minicpm-2b", "train_4k", multi_pod=False,
                         out_dir=str(tmp_path), reduce=True, verbose=False,
                         microbatches=3)
    assert rec["ok"] is False and "microbatches 3" in rec["reason"]
    assert "flops_per_device" not in rec and "fits_hbm" not in rec
    assert "not traced" in dryrun.table([rec])
