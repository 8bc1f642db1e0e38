"""State carried between the JAX reference and the port.

The system has no weights; its recurrent state (ring slabs, poses, both
map grids, the frame counter, and in the combined engine the previous
frame's keypoints, descriptors, image and depth grid) is what a run carries.
These helpers move a LoamState, a BatchLoamState, or a VloamEngine's
(VisionLoState, MapState) pair, across by field name, so this module needs
neither package's classes from the other side: a JAX state whose leaves were
made numpy (``jax.tree.map(np.asarray, state)``) goes in, the port's state
comes out, and the reverse gives the port's state with numpy leaves.

For a mesh of D ranks, a MapState splits into the ranks' blocks of the map
rows and joins back (the reference holds it as one array sharded over its
devices), and a pose graph splits into the ranks' edge shards.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .lidar.batch_mapping import BatchFeatureGrid, BatchGridMap
from .lidar.gridmap import FeatureGrid
from .lidar.loam_step import BatchLoamState, LoamState
from .lidar.mapping import GridMap
from .lidar.ring_assoc import RingSlab
from .parallel.mesh_fused import shard_map_state
from .parallel.pose_graph import PoseGraph, shard_graph
from .vision.depth_map import DepthGrid
from .vloam_step import MapState, VisionLoState, VisionState

_POSES = ("q_f2f", "t_f2f", "q_w", "t_w", "q_wmap_wodom", "t_wmap_wodom")
_LO_POSES = ("q_f2f", "t_f2f", "q_w", "t_w", "frame_idx")
_MAP_POSES = ("q_wmap_wodom", "t_wmap_wodom", "frame_idx")
_VISION = ("prev_kp", "prev_kp_mask", "prev_desc", "prev_img")


def _grid_from(g, device) -> FeatureGrid:
    return FeatureGrid(pts=torch.tensor(np.asarray(g.pts), device=device),
                       n_live=torch.tensor(np.asarray(g.n_live),
                                           device=device))


def loam_state_from_numpy(tree, device) -> LoamState:
    """Any LoamState-shaped tree with array leaves (JAX reference field
    names) -> the port's LoamState on `device`. Dtypes are kept."""
    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    return LoamState(
        corner_last=RingSlab(t(tree.corner_last.xyz)),
        surf_last=RingSlab(t(tree.surf_last.xyz)),
        cube=GridMap(corner=_grid_from(tree.cube.corner, device),
                     surf=_grid_from(tree.cube.surf, device),
                     center=t(tree.cube.center)),
        frame_idx=t(tree.frame_idx),
        **{k: t(getattr(tree, k)) for k in _POSES},
    )


def loam_state_to_numpy(st: LoamState) -> LoamState:
    """The port's LoamState -> the same tree with numpy leaves (field for
    field the JAX reference's LoamState layout)."""
    return _tree_to_numpy(st)


def batch_state_from_numpy(tree, device) -> BatchLoamState:
    """Any BatchLoamState-shaped tree with array leaves (JAX reference field
    names, [B, ...] per-stream leaves and the flat [B*nb, 3*cap] map tables)
    -> the port's BatchLoamState on `device`. Dtypes are kept."""
    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    def grid(g):
        return BatchFeatureGrid(pts=t(g.pts), n_live=t(g.n_live))

    return BatchLoamState(
        corner_last=RingSlab(t(tree.corner_last.xyz)),
        surf_last=RingSlab(t(tree.surf_last.xyz)),
        gm=BatchGridMap(corner=grid(tree.gm.corner), surf=grid(tree.gm.surf),
                        center=t(tree.gm.center)),
        frame_idx=t(tree.frame_idx),
        **{k: t(getattr(tree, k)) for k in _POSES},
    )


def batch_state_to_numpy(st: BatchLoamState) -> BatchLoamState:
    """The port's BatchLoamState -> the same tree with numpy leaves (field
    for field the JAX reference's BatchLoamState layout)."""
    return _tree_to_numpy(st)


def _tree_to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return type(x)(*(_tree_to_numpy(y) for y in x))


def _cube_from(cube, device) -> GridMap:
    return GridMap(corner=_grid_from(cube.corner, device),
                   surf=_grid_from(cube.surf, device),
                   center=torch.tensor(np.asarray(cube.center), device=device))


def vloam_state_from_numpy(tree, device) -> tuple[VisionLoState, MapState]:
    """A VloamEngine state pair (VisionLoState, MapState) with array leaves
    (JAX reference field names) -> the port's pair on `device`."""
    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    vl, ms = tree
    v = vl.vision
    vision = VisionState(
        prev_grid=DepthGrid(*(t(getattr(v.prev_grid, f))
                              for f in DepthGrid._fields)),
        **{k: t(getattr(v, k)) for k in _VISION})
    vstate = VisionLoState(
        vision=vision, corner_last=RingSlab(t(vl.corner_last.xyz)),
        surf_last=RingSlab(t(vl.surf_last.xyz)),
        **{k: t(getattr(vl, k)) for k in _LO_POSES})
    mstate = MapState(cube=_cube_from(ms.cube, device),
                      **{k: t(getattr(ms, k)) for k in _MAP_POSES})
    return vstate, mstate


def vloam_state_to_numpy(vstate: VisionLoState, mstate: MapState):
    """The port's (VisionLoState, MapState) -> the same trees with numpy
    leaves (field for field the JAX reference's layout)."""
    return _tree_to_numpy(vstate), _tree_to_numpy(mstate)


def _map_state_from(ms, device) -> MapState:
    return MapState(cube=_cube_from(ms.cube, device),
                    **{k: torch.tensor(np.asarray(getattr(ms, k)),
                                       device=device) for k in _MAP_POSES})


def split_map_state(tree, size: int, device) -> list[MapState]:
    """A MapState with array leaves and whole grids (the JAX reference's
    field names) -> the port's MapState of each of `size` ranks, rank r
    holding rows [r nb/size, (r+1) nb/size) of each grid
    (parallel.mesh_fused.shard_map_state)."""
    whole = _map_state_from(tree, device)
    return [shard_map_state(whole, SimpleNamespace(rank=r, size=size))
            for r in range(size)]


def join_map_states(states: list[MapState]) -> MapState:
    """The ranks' MapStates (in rank order) -> one MapState with numpy
    leaves and whole grids; the replicated fields are rank 0's."""
    first = _tree_to_numpy(states[0])

    def grid(name):
        g = getattr(first.cube, name)
        pts = np.concatenate([getattr(s.cube, name).pts.cpu().numpy()
                              for s in states])
        return FeatureGrid(pts=pts, n_live=g.n_live)

    return first._replace(cube=GridMap(grid("corner"), grid("surf"),
                                       first.cube.center))


def split_pose_graph(graph, size: int, device) -> list[PoseGraph]:
    """A pose graph with array leaves (the JAX reference's PoseGraph) -> the
    port's graph of each of `size` ranks: the poses whole, the edges in rank
    shards (parallel.pose_graph.shard_graph: padded with weight 0)."""
    def t(x, dtype=None):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    whole = PoseGraph(t(graph.poses), t(graph.edge_i, torch.int64),
                      t(graph.edge_j, torch.int64), t(graph.meas),
                      t(graph.weight))
    return [shard_graph(whole, SimpleNamespace(rank=r, size=size))
            for r in range(size)]
