"""Tiny cells for the CPU tests: the port's small test profile, a short
circuit, a small camera."""

from __future__ import annotations

import dataclasses
import json

from benchmark import harness

TRAFFIC = json.loads((harness.BENCH / "traffic" / "stream.json").read_text())
TRAFFIC.update(circuit_frames=48, box_every=4, pole_every=4,
               box_offset_m=[4.0, 5.0], box_half_m=[1.0, 2.0],
               pole_offset_m=[2.0, 3.0], max_range_m=40.0)


def pipeline(detach: bool = True) -> dict:
    from vloam_tpu_torch.config import tiny_test_profile

    d = dataclasses.asdict(tiny_test_profile())
    d.pop("save_traj")
    d.pop("verbose_level")
    d["detach_VO_LO"] = detach
    return d


def cell(name: str = "tiny.stream", streams: int = 1, camera: bool = False,
         chunk: int = 4, limits: dict | None = None) -> harness.Cell:
    from vloam_tpu_torch.data.synthetic import default_cam_calib

    config = {"name": "tiny", "n_azimuth": 360, "range_scale_m": 0.005,
              "pipeline": pipeline(detach=not camera)}
    if camera:
        K, _, _, velo_T_cam = default_cam_calib(320, 96)
        config["camera"] = {"width": 320, "height": 96, "K": K.tolist(),
                            "velo_T_cam": velo_T_cam.tolist()}
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    base = "hdl64_vloam.stream" if camera else (
        "hdl64_lo.fleet8" if streams > 1 else "hdl64_lo.stream")
    params = harness.load_json(harness.BENCH / "cells" / f"{base}.json")
    params.update(chunk=chunk, checked_frames=3)
    if limits:
        params["limits"] = dict(params["limits"], **limits)
    return harness.Cell(
        name=name, chips=1, config=config,
        traffic=dict(TRAFFIC, streams=streams), params=params,
        end_to_end=spec["end_to_end"],
        per_layer=[m for m in spec["per_layer"]
                   if "workloads" not in m or not camera])
