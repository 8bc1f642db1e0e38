"""One rank of a case of tests/test_torch_mesh_multiprocess.py.

Started by vloam_tpu_torch.parallel.launch (torchrun's environment), as

    python tests/torch_mesh_worker.py CASE IN.npz OUT.npz

it builds a gloo mesh on the CPU, reads the case's inputs, runs the port's
distributed function, and rank 0 writes what the test compares. Imports
nothing of JAX: the configuration is the port's own copy of
tests/test_pipeline.py's small_cfg.
"""

import sys

import numpy as np
import torch

from vloam_tpu_torch import config
from vloam_tpu_torch.parallel import sharded

torch.set_num_threads(1)

# a collective gives up after this many seconds: under the test's LIMIT_S
# (360 s), so a hung collective is reported by the rank that waits
COLLECTIVE_S = 300


def small_cfg(nb: int, cap_c: int, cap_s: int):
    """tests/test_pipeline.py::small_cfg with the given map grid."""
    return config.PipelineConfig(
        lidar=config.LidarProfile(name="t64", n_scans=64, minimum_range=2.0,
                                  max_points=65536, ring_capacity=1024),
        scanreg=config.ScanRegistrationConfig(
            sharp_cap=1024, less_sharp_cap=8192, flat_cap=2048,
            less_flat_cap=16384),
        mapping=config.LaserMappingConfig(
            cube_width=11, cube_height=11, cube_depth=5, map_n_buckets=nb,
            corner_bucket_cap=cap_c, surf_bucket_cap=cap_s,
            corner_stack_cap=2048, surf_stack_cap=4096))


def alignment(mesh, data):
    from vloam_tpu_torch.parallel.sharded_mapping import sharded_map_alignment

    args = []
    for k in ("c_stack", "s_stack", "map_corner", "map_surf"):
        a = torch.from_numpy(data[k])
        args += [sharded.shard_batch(a, mesh),
                 sharded.shard_batch(torch.ones(len(a), dtype=torch.bool),
                                     mesh)]
    x, counts = sharded_map_alignment(
        mesh, *args, torch.from_numpy(data["x0"]),
        config.LaserMappingConfig(), return_counts=True)
    return {"x": x.numpy(), "counts": counts.numpy()}


def engine(mesh, data):
    from vloam_tpu_torch.lidar.loam_step import LoamEngine

    nb, cap_c, cap_s, window = (int(v) for v in data["grid"])
    eng = LoamEngine(small_cfg(nb, cap_c, cap_s), chunk=3, mesh=mesh,
                     mesh_window_rows=window, device="cpu")
    for k in range(int(data["n_frames"])):
        eng.push(data[f"scan_{k}"])
    return {"rows": eng.finish(),
            "window": np.asarray(eng.window_active_rows)}


def pose_graph(mesh, data):
    from types import SimpleNamespace

    from vloam_tpu_torch import convert
    from vloam_tpu_torch.parallel.pose_graph import optimize_pose_graph

    graph = SimpleNamespace(**{k: data[k] for k in (
        "poses", "edge_i", "edge_j", "meas", "weight")})
    mine = convert.split_pose_graph(graph, mesh.size, "cpu")[mesh.rank]
    return {"poses": optimize_pose_graph(mine, mesh=mesh, gn_iters=4,
                                         cg_iters=64).numpy()}


def main(case: str, inp: str, out: str) -> None:
    with sharded.spmd_mesh(device="cpu", timeout_s=COLLECTIVE_S) as mesh:
        result = {"alignment": alignment, "engine": engine,
                  "pose_graph": pose_graph}[case](mesh, np.load(inp))
        if mesh.rank == 0:
            np.savez(out, **result)


if __name__ == "__main__":
    main(*sys.argv[1:4])
