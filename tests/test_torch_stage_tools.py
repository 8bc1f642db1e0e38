"""The stage profilers themselves on the CPU (vloam_tpu_torch/tools/
profile_stages.py, profile_vision_stages.py, profile_batch_stages.py and
tools/timing.py::stage_clocks), at the tiny profile:

- each tool's main(["--device", "cpu", "--tiny", ...]) prints a line for
  every stage it declares, each with a finite host enqueue and wall, no
  device fields, a header for every JAX script it ports, and a last line
  that parses as JSON with every stage's clocks;
- stage_clocks on the CPU times the call and leaves the device fields None;
  a capture error is named by the port's frame that raised it;
- the JAX scripts of the slice all exist and each has its counterpart
  section in one of the tools; no tool imports jax or the JAX package;
- without a card the tools refuse the default device.
"""

import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.tools import profile_batch_stages as pb
from vloam_tpu_torch.tools import profile_stages as ps
from vloam_tpu_torch.tools import profile_vision_stages as pv
from vloam_tpu_torch.tools import timing
from vloam_tpu_torch.tools.timing import stage_clocks

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# the JAX package's stage profilers the three tools port
SLICE = ("calibrate_timing", "profile_chained", "profile_stages",
         "profile_scanreg", "profile_polar", "profile_select", "profile_lo",
         "profile_lo_split", "profile_mapping", "profile_tail",
         "profile_loam_xyz_chunk", "profile_vision_stages",
         "profile_vision_chunk", "profile_batch_stages",
         "profile_batch_mapping", "profile_batch_flat", "profile_batch")
TOOLS = {"profile_stages": ps, "profile_vision_stages": pv,
         "profile_batch_stages": pb}
# the stage splits each tool holds against its whole frame
SPLITS = {"profile_stages": [f"{k}:{s}" for k in ("polar", "xyz")
                             for s in ps.TOP + ("frame",)],
          "profile_vision_stages": [f"vloam:{s}" for s in pv.TOP
                                    + ("frame",)],
          "profile_batch_stages": [f"{b}:{s}" for b, top in (
              (1, ps.TOP), (pb.BATCH, tuple(pb.hand(pb.BATCH))))
              for s in top + ("frame",)]}


@pytest.fixture
def tmp_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_prints_every_stage_on_the_cpu(name, tmp_cache, capsys):
    assert TOOLS[name].main(["--device", "cpu", "--tiny", "--runs", "1",
                             "--chunk", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["tool"] == name and rec["device"] == "cpu"
    assert rec["profile"] == "tiny_test_profile"
    keys = [r["key"] for r in rec["stages"]]
    assert len(keys) == len(set(keys)) and set(SPLITS[name]) <= set(keys)
    text = "\n".join(out[:-1])
    for r in rec["stages"]:
        assert math.isfinite(r["host_ms"]) and r["host_ms"] > 0, r
        assert math.isfinite(r["wall_ms"]) and r["wall_ms"] > 0, r
        assert r["device_ms"] is None and r["launches"] is None, r
        assert r["hand"] is None and r["capture_error"] is None, r
        line = next(x for x in out if x.startswith(f"  {r['label']} "))
        assert "host" in line and "wall" in line
    scripts = [s for sec in rec["sections"] for s in sec["scripts"]]
    assert sorted(set(scripts)) == sorted(TOOLS[name].SCRIPTS)
    for s in TOOLS[name].SCRIPTS:
        assert f"{s} (" in text
    # on the CPU no launch is counted, so no sum and no hand check is made
    assert rec["checks"] == {"sums": [], "hand": []}


def test_stage_clocks_on_the_cpu():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(64).cumsum(0)

    clk = stage_clocks(fn, runs=3, device="cpu")
    assert len(calls) == 4  # a warm-up and three timed calls
    assert 0 < clk["host_ms"] <= clk["wall_ms"] < 1e3
    for k in ("device_ms", "device_how", "launches", "launches_how", "hand",
              "capture_error"):
        assert clk[k] is None
    stage_clocks(fn, runs=2, device="cpu", warm=False)
    assert len(calls) == 6


def test_capture_error_names_the_op():
    with pytest.raises(ValueError) as err:
        kernels.row_gather(torch.zeros((4, 4)),
                           torch.zeros(2, dtype=torch.int64))
    where = timing._failed_op(err.value)
    assert where.startswith("vloam_tpu_torch/kernels/__init__.py:")
    assert "raise ValueError" in where
    assert timing._failed_op(RuntimeError("no traceback")) == "?"


def test_the_slice_scripts_have_their_counterparts():
    ported = [s for t in TOOLS.values() for s in t.SCRIPTS]
    assert len(ported) == len(set(ported))
    assert sorted(ported) == sorted(f"scripts/{s}.py" for s in SLICE)
    for s in ported:
        assert (REPO / s).is_file(), s


def test_stage_tools_never_import_jax():
    code = ("import sys, vloam_tpu_torch.tools.profile_stages, "
            "vloam_tpu_torch.tools.profile_vision_stages, "
            "vloam_tpu_torch.tools.profile_batch_stages, "
            "vloam_tpu_torch.tools.stages; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vloam_tpu')); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_stage_tools_refuse_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for tool in TOOLS.values():
        with pytest.raises(RuntimeError, match="is_available"):
            tool.run()
