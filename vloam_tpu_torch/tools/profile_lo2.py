"""LO association by parts (port of scripts/profile_lo2.py): the whole
solve_lo beside the shortlist association (tools/legacy_assoc.py), the surf
distance product at three precisions, the shortlist by top-k and the fused
low-precision shortlist with a float32 re-rank.

    python -m vloam_tpu_torch.tools.profile_lo2 [--device cpu] [--tiny]
        [--runs N] [--replays N]

The frames are the script's: urban_scene(0, extent=80) along
drive_trajectory(2, speed=1.1, yaw_rate=0.01), xyz scans of 1800 azimuth
bins, 1 cm of noise, frame k seeded k (tools/stages.py), registered by
register_scan; frame 1's sharp and flat clouds against frame 0's less-sharp
and less-flat ones, at the identity.

The precisions are the card's counterparts of the TPU's matmul precisions:
float32 with TF32 off for HIGHEST, TF32 for HIGH (the tool turns
torch.backends.cuda.matmul.allow_tf32 on for that row alone and restores
it), bf16 inputs with float32 accumulation (torch.mm's out_dtype; on the
CPU the inputs rounded to bf16 and multiplied in float32) for DEFAULT. The
product is a plain torch.matmul, as the script's is a plain jnp.dot outside
any kernel. The shortlists are exact torch.topk: the card has no
approximate top-k (the script's approx_min_k). Every row is timed by
timing.stage_clocks (host enqueue, wall, graph-replayed device time,
kernel nodes); on the CPU the host clocks only. The last line is JSON.
"""

from __future__ import annotations

import torch

from ..lidar import scan_registration as sr
from ..lidar.odometry import solve_lo
from .legacy_assoc import dist_sq, shortlist_ring_assoc
from .stages import StageTable, emit, n_points, parse, profile, xyz_frames

SCRIPTS = ("scripts/profile_lo2.py", "scripts/legacy_assoc.py")
SHORTLISTS = (8, 16, 24)
# (label, the TPU precision it stands for)
PRECISIONS = (("float32", "HIGHEST"), ("tf32", "HIGH"), ("bf16", "DEFAULT"))


def bf16_product(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q @ c.T from bf16 inputs accumulated in float32 (the TPU's DEFAULT
    precision with preferred_element_type float32): torch.mm's out_dtype on
    the card; on the CPU, which has no such kernel, the inputs rounded to
    bf16 and multiplied in float32 (the same products)."""
    a, b = q.to(torch.bfloat16), c.T.to(torch.bfloat16)
    if q.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def product(q: torch.Tensor, c: torch.Tensor, precision: str):
    """q @ c.T at one of PRECISIONS (tf32: the caller has allowed TF32)."""
    if precision == "bf16":
        return bf16_product(q, c)
    return torch.matmul(q, c.T)


def dist_by_product(q, c, precision: str) -> torch.Tensor:
    """The script's dist_only: max(|q|^2 + |c|^2 - 2 q.c, 0) with q.c a
    matmul at `precision`."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    cc = torch.sum(c * c, dim=-1)[None, :]
    return torch.clamp(qq + cc - 2.0 * product(q, c, precision), min=0.0)


class _TF32:
    """TF32 on for cuBLAS float32 products inside the block, the previous
    setting restored after it (the legacy flag, as chip_smoke.py sets it)."""

    def __enter__(self):
        self.before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.before


def run(device="cuda", tiny: bool = False, runs: int = 3,
        replays: int = 20) -> dict:
    """Every row; returns the JSON record."""
    from ..data import synthetic
    from ..lidar.loam_step import engine_device

    dev = engine_device(device)
    cfg, n_az = profile(tiny)
    S = cfg.lidar.n_scans
    table = StageTable("profile_lo2", dev, runs, replays, tiny)
    poses = synthetic.drive_trajectory(2, speed=1.1, yaw_rate=0.01)
    scans = xyz_frames(poses, range(2), S, n_az, cfg.lidar.max_points)
    f0, f1 = (sr.register_scan(torch.from_numpy(s).to(dev),
                               torch.tensor(n_points(s), device=dev),
                               cfg.lidar, cfg.scanreg) for s in scans)
    counts = {k: int(c.mask.sum()) for k, c in (
        ("sharp", f1.sharp), ("flat", f1.flat),
        ("corner_last", f0.less_sharp), ("surf_last", f0.less_flat))}
    table.extra["counts"] = counts
    table.note(" ".join(f"{k}={v}" for k, v in counts.items()))
    q0 = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t0 = torch.zeros(3, device=dev)
    sq, fq = f1.sharp.xyz, f1.flat.xyz
    cq, cr, cm = f0.less_sharp.xyz, f0.less_sharp.ring, f0.less_sharp.mask
    su, sr_, sm = f0.less_flat.xyz, f0.less_flat.ring, f0.less_flat.mask
    nearby = cfg.lo.nearby_scan
    surf_shape = f"{fq.shape[0]} x {su.shape[0]}"

    table.section(SCRIPTS, "solve_lo beside the shortlist association, the "
                  "surf distance product at three precisions, shortlists by "
                  "exact top-k (no approximate top-k on the card)")
    table.stage("solve_lo (full)", lambda: solve_lo(
        f1.sharp, f1.flat, f0.less_sharp_slab, f0.less_flat_slab, q0, t0,
        cfg.lo), jax="solve_lo (full)")
    picks = {}
    picks["corner"] = table.stage(
        "assoc corner (shortlist_ring_assoc, 24)",
        lambda: shortlist_ring_assoc(sq, cq, cr, cm, nearby, "corner", 24),
        jax="assoc corner (shortlist_ring_assoc)",
        shape=f"{sq.shape[0]} x {cq.shape[0]}")
    picks["surf"] = table.stage(
        "assoc surf (shortlist_ring_assoc, 24)",
        lambda: shortlist_ring_assoc(fq, su, sr_, sm, nearby, "surf", 24),
        jax="assoc surf (shortlist_ring_assoc)", shape=surf_shape)
    table.extra["picks_live"] = {
        m: {k: int(torch.isfinite(p[k]).sum()) for k in ("d0", "d2", "d3")}
        for m, p in picks.items()}
    for prec, tpu in PRECISIONS:
        def dist_only(prec=prec):
            return dist_by_product(fq, su, prec).sum()

        label = f"surf dist matmul {prec} (the TPU's {tpu})"
        if prec == "tf32":
            with _TF32():
                table.stage(label, dist_only, jax=f"surf dist matmul {tpu}",
                            shape=surf_shape)
        else:
            table.stage(label, dist_only, jax=f"surf dist matmul {tpu}",
                        shape=surf_shape)
    dmat = torch.where(sm[None, :], dist_sq(fq, su), float("inf"))
    for s in SHORTLISTS:
        table.stage(f"shortlist={s} (exact torch.topk)",
                    lambda s=s: torch.topk(dmat, s, dim=1, largest=False),
                    jax=f"approx_min_k shortlist={s}", shape=surf_shape)
    del dmat

    def fused_shortlist():
        d = torch.where(sm[None, :], dist_by_product(fq, su, "bf16"),
                        float("inf"))
        sl_i = torch.topk(d, 24, dim=1, largest=False).indices
        d_exact = torch.sum((su[sl_i] - fq[:, None, :]) ** 2, dim=-1)
        return d_exact.sum()

    table.stage("surf: bf16 dist + top-24 + f32 re-rank", fused_shortlist,
                jax="surf: bf16 dist + amk24 + f32 re-rank", shape=surf_shape)
    rec = table.result()
    rec["tf32_after"] = bool(torch.backends.cuda.matmul.allow_tf32)
    return rec


def main(argv=None) -> int:
    args = parse("vloam_tpu_torch.tools.profile_lo2", __doc__, argv)
    emit(run(args.device, args.tiny, args.runs, args.replays))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
