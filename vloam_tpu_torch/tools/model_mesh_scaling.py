"""A scaling model of the mesh mapping chunk from a one-card run (port of
scripts/model_mesh_scaling.py).

    python -m vloam_tpu_torch.tools.model_mesh_scaling [--device cpu]
        [--tiny] [--window-rows W] [--runs N] [--replays N]

As the script, it measures on one device and models D = 2, 4, 8 from
counts and a cost model; every term is measured on this card or named as
an assumption:

1. MEASURES the D = 1 mesh mapping chunk (parallel/mesh_fused.py's
   make_mesh_mapping_chunk on a one-rank mesh: NCCL on the card, gloo on
   the CPU; the ring hops are no-ops, the all-reduces are not), on the
   script's drive: urban_scene(0, extent=80), drive_trajectory(4,
   speed=1.1, yaw_rate=0.01), polar range images seeded k, pushed through
   LoamEngine(mesh=, chunk=2, mesh_window_rows=W) for its map; then chunks
   of 8 copies of the last frame's stacks at the identity, as the script
   times them. t_mesh_d1 is a frame's device time (timing.stage_clocks:
   graph replay, or queued where the chunk cannot be captured).
2. SPLITS one frame of that chunk into its stages (mesh_fused's
   MeshFrameStages, run in order: the windows; the rounds' setup; per
   outer round the masked_knn sweep and the LM chain; the inserts and
   evicts; the chunk's tail), each with its host enqueue, wall, device time
   and kernel nodes; their nodes must sum to the one-frame chunk's. A stage
   that does not capture into a CUDA graph (a collective may not) is timed
   queued and its line says so; the sum is then taken over torch.profiler's
   launch counts of every stage and of the chunk alike.
   t_lm (the LM chains) and t_insert (inserts and evicts) come from the
   split, t_single from tools/profile_stages.py's mapping stage on the map
   a single LoamEngine leaves after the same frames.
3. COUNTS knn_macs and per_hop_bytes from the configuration and W (the
   script's static counts: counts()).
4. MODELS t(D) = (t_mesh_d1 - t_lm - t_insert) / D + t_lm + t_insert +
   outer_rounds (D - 1) hop(D), hop(D) = per_hop_bytes / D over the link's
   rate + the hop latency, efficiency t(1) / (D t(D)) (model(), the
   script's arithmetic). The link is an assumption, printed as one: NVLink
   4 between H100 SXM cards at 450 GB/s a direction (NVIDIA's data sheet),
   10 us a hop. No call has had two cards, so neither is measured.

The last line is JSON: the script's keys (t_single_device_ms,
t_mesh_d1_ms, window_rows, per_hop_bytes, knn_macs_per_frame, rows; its
ici_gbps_assumed as link_gbps_assumed) plus the link, stage_ms, the split's
sum check and the card line.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..lidar import scan_registration as sr
from ..lidar.voxel import voxel_downsample
from ..parallel.mesh_fused import MeshFrameStages, make_mesh_mapping_chunk
from ..parallel.sharded_mapping import round_knn, round_lm, rounds_setup
from .stages import StageTable, emit, profile, workers
from .timing import profiler_launches

LINK = {"name": "NVLink 4 between H100 SXM cards, one direction (NVIDIA's "
        "H100 data sheet: 900 GB/s both directions)", "gbps": 450.0,
        "hop_latency_us": 10.0, "measured": False}
SCRIPT = "scripts/model_mesh_scaling.py"
N_FRAMES = 4  # the script's drive
F = 8  # frames a timed chunk (the script's)
SIZES = (1, 2, 4, 8)


def counts(cfg, W: int) -> dict:
    """The script's static counts: the window sweep's operations a frame (4
    a (query, window slot) pair a round, as the script counts them) and the
    bytes of one ring hop (both grids' window coordinates, float32)."""
    m = cfg.mapping
    cap_c, cap_s = m.corner_bucket_cap, m.surf_bucket_cap
    Qc, Qs = m.corner_stack_cap, m.surf_stack_cap
    return {"knn_macs": m.outer_rounds * (Qc * W * cap_c + Qs * W * cap_s)
            * 4,
            "per_hop_bytes": (W * cap_c + W * cap_s) * 3 * 4,
            "rounds": m.outer_rounds}


def model(stage_ms: dict, cnt: dict, link: dict, sizes=SIZES) -> list[dict]:
    """The script's model over `sizes` from stage_ms {mesh_d1, lm, insert}
    (ms a frame), counts() and the link {gbps, hop_latency_us}."""
    t1, t_lm, t_ins = stage_ms["mesh_d1"], stage_ms["lm"], stage_ms["insert"]
    t_sharded_d1 = max(t1 - t_lm - t_ins, 0.1)
    rows = []
    for D in sizes:
        t_shard = t_sharded_d1 / D
        hop_ms = ((cnt["per_hop_bytes"] / D) / (link["gbps"] * 1e9) * 1e3
                  + link["hop_latency_us"] / 1e3)
        t_comm = cnt["rounds"] * (D - 1) * hop_ms
        t_d = t_shard + t_lm + t_ins + t_comm
        rows.append({"D": D, "t_ms": t_d, "t_shard": t_shard,
                     "t_comm": t_comm, "efficiency": t1 / (D * t_d)})
    return rows


def _polar(args):
    """A polar frame of the script's drive (simulate_scan_polar's default
    noise and range scale)."""
    from ..data import synthetic

    T, k, n_scans, n_az = args
    return synthetic.simulate_scan_polar(
        synthetic.urban_scene(0, extent=80.0), T, n_scans=n_scans,
        n_azimuth=n_az, seed=k)


def drive(n_scans: int, n_az: int, n_workers: int) -> list[np.ndarray]:
    from ..data import synthetic
    from .bench import _cached, _pool_map

    poses = synthetic.drive_trajectory(N_FRAMES, speed=1.1, yaw_rate=0.01)
    return _cached(f"mesh_model_{N_FRAMES}", (0, 80.0, n_scans, n_az),
                   lambda: _pool_map(_polar, [(T, k, n_scans, n_az)
                                              for k, T in enumerate(poses)],
                                     min(N_FRAMES, n_workers)))


def frame_stages(st: MeshFrameStages, mstate, c_xyz, c_m, s_xyz, s_m, q_w,
                 t_w, mcfg):
    """One frame of the chunk as its stages, in the chunk's order: a list
    of (key, label, fn), fn taking the outputs so far (a dict) and
    returning its own; the last stage's output is (mstate', out [1,
    MESH_MO_OUT]), what the chunk gives for that one frame. c_xyz ... s_m:
    the frame's [Cc, 3] / [Cs, 3] stacks."""
    mesh = st.mesh
    mc, ms = st.rank_slices(c_xyz[None], s_xyz[None])
    cs, cm, ss, sm = c_xyz[mc], c_m[mc], s_xyz[ms], s_m[ms]
    cube = mstate.cube

    def window(o):
        return st.window(mstate.q_wmap_wodom, mstate.t_wmap_wodom, q_w, t_w,
                         cube.corner.pts, cube.surf.pts)

    def setup(o):
        return rounds_setup(cs, ss, o["window"][0])

    def knn(r):
        def fn(o):
            x = o["window"][0] if r == 0 else o[f"lm{r - 1}"][0]
            return round_knn(cs, ss, o["window"][1], o["window"][2], x, mcfg)
        return fn

    def lm(r):
        def fn(o):
            x = o["window"][0] if r == 0 else o[f"lm{r - 1}"][0]
            is_edge, cp, _ = o["setup"]
            knn_c, knn_s = o[f"knn{r}"]
            return round_lm(cm, sm, cp, is_edge, knn_c, knn_s, x, mcfg, mesh)
        return fn

    last = f"lm{mcfg.outer_rounds - 1}"

    def update(o):
        return st.update(o[last][0], o["window"][0], c_xyz, c_m, s_xyz, s_m,
                         q_w, t_w, cube.corner.pts, cube.surf.pts,
                         cube.corner.n_live, cube.surf.n_live, cube.center)

    def tail(o):
        x, c_blk, s_blk, n_c, n_s, center, qwm, twm = o["update"]
        return st.tail(mstate, [x], [o["window"][3]], c_blk, s_blk, n_c,
                       n_s, center, qwm, twm, 1)

    stages = [("window", "windows (prediction, 2 x _window_block, ring "
               "shards) [row_gather x2]", window),
              ("setup", "the rounds' setup (stacked points, edge mask)",
               setup)]
    for r in range(mcfg.outer_rounds):
        stages += [(f"knn{r}", f"round {r}: masked_knn sweep, both grids "
                    "[masked_knn x2 a rank's shard]", knn(r)),
                   (f"lm{r}", f"round {r}: line / plane fits + LM chain "
                    "(normal equations all-reduced)", lm(r))]
    stages += [("update", "inserts [row_gather x2] + evicts (counts "
                "all-reduced) + transformUpdate", update),
               ("tail", "chunk tail (active rows all-reduced, output row)",
                tail)]
    return stages


def run_stages(stages) -> dict:
    """Run frame_stages' list in order (no timing): every stage's output."""
    out = {}
    for key, _, fn in stages:
        out[key] = fn(out)
    return out


def _sum_check(table: StageTable, keys: list[str], whole: str,
               fns: dict) -> dict:
    """The stages' kernel nodes summed against the whole chunk's; where any
    of them did not capture, torch.profiler's launch counts of all of them."""
    rows = [table.row(k) for k in keys]
    w = table.row(whole)
    if w["launches"] is None:  # the CPU: no launch is counted
        return {"ok": None, "how": "not counted on the CPU"}
    how = "kernel nodes of the captured graphs"
    parts = {r["key"]: r["launches"] for r in rows}
    total_whole = w["launches"]
    if any(r["capture_error"] for r in rows + [w]):
        how = ("torch.profiler's launch counts (a stage or the chunk did not "
               "capture)")
        parts = {k: profiler_launches(fns[k]) for k in keys}
        total_whole = profiler_launches(fns[whole])
    total = sum(parts.values())
    rec = {"parts": parts, "sum": total, "whole": total_whole,
           "ok": total == total_whole, "how": how,
           "device_ms_sum": sum(r["device_ms"] for r in rows),
           "device_ms_whole": w["device_ms"]}
    table.note(f"mesh chunk frame: the stages' launches sum to {total}, the "
               f"one-frame chunk's are {total_whole} "
               f"({'equal' if rec['ok'] else 'NOT EQUAL'}; {how}); device "
               f"{rec['device_ms_sum']:.3f} ms summed, "
               f"{rec['device_ms_whole']:.3f} ms whole")
    return rec


def run(device="cuda", tiny: bool = False, window_rows: int = 4096,
        runs: int = 3, replays: int = 20, frames=None) -> dict:
    """Measure, split, count and model; returns the JSON record. frames:
    the script's 4 range images where the caller has them."""
    from ..lidar.loam_step import engine_device
    from ..parallel.sharded import spmd_mesh

    dev = engine_device(device)
    with spmd_mesh(device=dev.type) as mesh:
        return _measure(mesh, dev, tiny, window_rows, runs, replays, frames)


def _measure(mesh, dev, tiny, window_rows, runs, replays, frames) -> dict:
    from ..data import synthetic
    from ..lidar.loam_step import LoamEngine
    from .profile_stages import mapping_stage

    cfg, n_az = profile(tiny)
    mcfg = cfg.mapping
    S = cfg.lidar.n_scans
    table = StageTable("model_mesh_scaling", dev, runs, replays, tiny)
    frames = frames if frames is not None else drive(S, n_az, workers(tiny))
    t0 = time.perf_counter()
    eng = LoamEngine(cfg, chunk=2, mesh=mesh, mesh_window_rows=window_rows,
                     device=dev)
    single = LoamEngine(cfg, chunk=2, device=dev)
    for f in frames:
        eng.push_polar(f)
        single.push_polar(f)
    eng.finish()
    single.finish()
    table.note(f"mesh engine (1 {mesh.backend} rank) and single engine over "
               f"the script's {len(frames)} frames in "
               f"{time.perf_counter() - t0:.1f} s")
    elev = torch.tensor(np.radians(synthetic.hdl64_elevations(S)),
                        dtype=torch.float32, device=dev)
    feats = sr.register_scan_polar(
        torch.from_numpy(frames[-1].astype(np.int32)).to(dev),
        sr.polar_directions(elev, n_az), cfg.lidar, cfg.scanreg)
    c_xyz, _, _, c_m = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask, mcfg.line_resolution,
        mcfg.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask, mcfg.plane_resolution,
        mcfg.surf_stack_cap)
    mstate = eng.state[1]
    W = eng._mesh_chunk.window_rows
    chunk = make_mesh_mapping_chunk(mesh, cfg, W)

    def rep(x, n):
        return x[None].expand((n,) + x.shape).contiguous()

    args = {n: (rep(c_xyz, n), rep(c_m, n), rep(s_xyz, n), rep(s_m, n),
                rep(torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev), n),
                torch.zeros((n, 3), device=dev)) for n in (1, F)}

    table.section((SCRIPT,), f"the D = 1 mesh mapping chunk ({F} frames of "
                  f"the last frame's stacks, {c_xyz.shape[0]} corner + "
                  f"{s_xyz.shape[0]} surf stack rows, window {W} rows), one "
                  "frame of it by stages, the single engine's mapping stage")
    fns = {"chunk": lambda: chunk(mstate, *args[F]),
           "chunk1": lambda: chunk(mstate, *args[1])}
    table.stage(f"mesh mapping chunk, D = 1, {F} frames", fns["chunk"],
                jax=f"mesh mapping chunk, D=1 ({F} frames)", key="chunk")
    want = table.stage("mesh mapping chunk, D = 1, 1 frame", fns["chunk1"],
                       key="chunk1")
    stages = frame_stages(MeshFrameStages(mesh, cfg, W), mstate,
                          c_xyz, c_m, s_xyz, s_m, args[1][4][0],
                          args[1][5][0], mcfg)
    out = {}
    for key, label, fn in stages:
        fns[key] = (lambda fn=fn, o=out: fn(o))
        out[key] = table.stage(label, fns[key], key=key)
    got = out["tail"]
    same = all(torch.equal(a, b) for a, b in (
        (got[1], want[1]), (got[0].cube.corner.pts, want[0].cube.corner.pts),
        (got[0].cube.surf.pts, want[0].cube.surf.pts)))
    table.note(f"the stages in order give the one-frame chunk's row and map "
               f"{'bit for bit' if same else 'NOT bit for bit'}")
    keys = [k for k, _, _ in stages]
    check = _sum_check(table, keys, "chunk1", fns)
    st_single = single.state
    lo = (None,) * 4 + (st_single.q_w, st_single.t_w)
    table.stage("single engine: mapping stage (tools/profile_stages.py)",
                lambda: mapping_stage(st_single, lo,
                                      (c_xyz, c_m, s_xyz, s_m), cfg),
                jax="t_single (profile_chained's mapping stage)",
                key="single")

    def ms(key):  # device ms where measured, else the host's wall
        r = table.row(key)
        return r["device_ms"] if r["device_ms"] is not None else r["wall_ms"]

    rounds = range(mcfg.outer_rounds)
    stage_ms = {"mesh_d1": ms("chunk") / F,
                "window": ms("window"),
                "setup": ms("setup"),
                "knn": sum(ms(f"knn{r}") for r in rounds),
                "lm": sum(ms(f"lm{r}") for r in rounds),
                "insert": ms("update"),
                "tail": ms("tail"),
                "chunk_1_frame": ms("chunk1"),
                "single": ms("single")}
    clock = ("device" if table.row("chunk")["device_ms"] is not None
             else "host wall")
    cnt = counts(cfg, W)
    rows = model(stage_ms, cnt, LINK)
    for r in rows:
        table.note(f"[model] D={r['D']}: {r['t_ms']:.3f} ms/frame (sharded "
                   f"{r['t_shard']:.3f} + lm {stage_ms['lm']:.3f} + insert "
                   f"{stage_ms['insert']:.3f} + comm {r['t_comm']:.4f}) eff "
                   f"{r['efficiency']:.3f}")
    table.note(f"link (an assumption, not measured): {LINK['name']}, "
               f"{LINK['gbps']} GB/s, {LINK['hop_latency_us']} us a hop; "
               f"stage times: {clock} ms")
    rec = table.result()
    rec.update({"t_single_device_ms": stage_ms["single"],
                "t_mesh_d1_ms": stage_ms["mesh_d1"], "window_rows": W,
                "per_hop_bytes": cnt["per_hop_bytes"],
                "knn_macs_per_frame": cnt["knn_macs"],
                "link_gbps_assumed": LINK["gbps"], "link": LINK,
                "stage_ms": stage_ms, "stage_clock": clock, "rows": rows,
                "split_sum": check, "split_identical": same,
                "card": table.card})
    return rec


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="model_mesh_scaling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--window-rows", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--replays", type=int, default=20)
    args = ap.parse_args(argv)
    rec = run(args.device, args.tiny, args.window_rows, args.runs,
              args.replays)
    emit(rec)
    return 0 if rec["split_identical"] and rec["split_sum"]["ok"] in (
        True, None) else 1


if __name__ == "__main__":
    raise SystemExit(main())
