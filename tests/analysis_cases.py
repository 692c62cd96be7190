"""The rank side of ``tests/test_torch_analysis.py``'s collective check:
one decode step of a dense smoke config on a rank's slices, and the
collectives its mesh recorded.  A spawned rank imports this module and
``repro_torch`` only; the stand-in mesh (``launch.mesh.CountingMesh``)
runs the same function in the test's own process."""
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.qmodel import QuantContext, QuantMode
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.analysis import CostMode
from repro_torch.models import model as M

ARCH = "qwen3_1_7b"
SHAPE = ShapeConfig("smoke_decode", 24, 4, "decode")


def decode_records(mesh) -> list:
    """The collectives (kind, result bytes, group size, link) the cost
    counter records in one decode step at ``SHAPE`` on ``mesh``'s rank,
    its params cut from the whole seeded ones and its cache zeros of its
    slice."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_kernel="flash")
    ctx = QuantContext(mode=QuantMode.FP)
    step, (_, cache_abs, p_spec, c_spec) = S.jit_serve_step(
        cfg, ctx, mesh, SHAPE, fsdp=False)
    whole = M.init_params(cfg, 0, device="cpu")
    params = shd.shard_tree(whole, p_spec, mesh, mesh.coords)
    cache = shd.rank_zeros(cache_abs, c_spec, mesh, "cpu")
    rows = SHAPE.global_batch // shd.data_shards(mesh)
    tokens = torch.arange(rows, dtype=torch.int32)[:, None] + 3
    with torch.no_grad(), CostMode() as mode:
        step(params, tokens, cache,
             torch.tensor(SHAPE.seq_len - 1, dtype=torch.int32))
    return mode.records
