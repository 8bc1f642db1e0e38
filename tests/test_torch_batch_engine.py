"""The port's lockstep batch engine (BatchLoamEngine, vloam_tpu_torch.lidar.
loam_step) against the JAX reference and against the port's own single-stream
engine, on the CPU at the small test profile (tests/test_pipeline.py::
small_cfg), B = 2 streams x 4 frames, chunk 2: the drive of
tests/test_batch_engine.py.

- push and push_polar against the JAX BatchLoamEngine: t_w_lo 1e-3 m, t_w_mo
  1e-2 m per frame (the port associates with exact distances, the JAX engine's
  default quantizes them, so end to end is a trajectory tolerance, as in
  tests/test_torch_loam_engine.py).
- against the port's single LoamEngine per stream: the same tolerances (the
  batch engine evicts per chunk, the single engine per frame, and the merged
  insert stores fixed-point fractions: tolerance, not equality).
- quantize_mm=5.0 (int16 staging, both engines) within 5e-2 m of the exact
  run, and the batch engine's quantized run within t_w_lo 1e-3 / t_w_mo 1e-2
  of the JAX batch engine's quantized run; the staged buffers equal the JAX
  engine's bit for bit.
- pack12 staging is exact: identical rows.
- a JAX BatchLoamState carried into the port through convert.py computes the
  same next frame: LO 1e-4, MO q 3e-4 / t 5e-3 (module tolerances of
  tests/test_torch_loam_engine.py); the round trip is bit-exact.
- every engine defaults to the card and raises where there is none.
"""

import jax
import numpy as np
import pytest
import torch

from vloam_tpu.data import synthetic
from vloam_tpu.lidar import loam_step as jls
from vloam_tpu_torch import convert
from vloam_tpu_torch.lidar import loam_step as tls

from test_pipeline import small_cfg

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

CFG = small_cfg()
B, N = 2, 4


def _drive(polar: bool, scale: float = 0.005):
    streams = []
    for seed in (31, 32):
        scene = synthetic.urban_scene(seed)
        poses = synthetic.drive_trajectory(N, speed=1.0,
                                           yaw_rate=0.01 * (seed - 30))
        if polar:
            streams.append([
                synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                              n_azimuth=900,
                                              seed=seed * 100 + k,
                                              range_scale=scale)
                for k, T in enumerate(poses)])
        else:
            streams.append([
                synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                        seed=seed * 100 + k)
                for k, T in enumerate(poses)])
    return streams


def _run_batch(eng, streams, method="push", **kw):
    for k in range(N):
        for b in range(B):
            getattr(eng, method)(b, streams[b][k], **kw)
    return eng.finish()


def _assert_close(outs, want, lo=1e-3, mo=1e-2):
    """outs [B, N, 24] against per-stream unpacked results."""
    for b in range(B):
        res = tls.unpack_outputs(outs[b])
        np.testing.assert_allclose(res["t_w_lo"], want[b]["t_w_lo"], atol=lo)
        np.testing.assert_allclose(res["t_w_mo"], want[b]["t_w_mo"], atol=mo)


@pytest.fixture(scope="module")
def xyz_drive():
    """The xyz drive through the JAX batch engine (state after the first
    chunk copied out before the next chunk donates it) and the port's."""
    streams = _drive(polar=False)
    eng = jls.BatchLoamEngine(CFG, batch=B, chunk=2)
    for k in range(2):
        for b in range(B):
            eng.push(b, streams[b][k])
    st2 = jax.tree.map(np.asarray, eng.states)
    for k in range(2, N):
        for b in range(B):
            eng.push(b, streams[b][k])
    outs_j = eng.finish()
    outs_t = _run_batch(tls.BatchLoamEngine(CFG, B, chunk=2, device="cpu"),
                        streams)
    return streams, st2, outs_j, outs_t


def test_batch_push_matches_jax_batch_engine(xyz_drive):
    _, _, outs_j, outs_t = xyz_drive
    assert outs_t.shape == outs_j.shape == (B, N, 24)
    assert outs_t.dtype == np.float32 and np.isfinite(outs_t).all()
    _assert_close(outs_t, [jls.unpack_outputs(outs_j[b]) for b in range(B)])
    np.testing.assert_array_equal(outs_t[:, :, 23], outs_j[:, :, 23])
    assert (outs_t[:, 1:, 21:23] > 100).all()  # LO had correspondences


def test_batch_push_matches_single_engines(xyz_drive):
    streams, _, _, outs_t = xyz_drive
    singles = []
    for scans in streams:
        eng = tls.LoamEngine(CFG, chunk=2, device="cpu")
        for s in scans:
            eng.push(s)
        singles.append(tls.unpack_outputs(eng.finish()))
    _assert_close(outs_t, singles)
    # the streams are different drives
    assert np.abs(singles[0]["t_w_mo"] - singles[1]["t_w_mo"]).max() > 1e-2


def test_batch_quantized_staging_stays_close(xyz_drive):
    streams, _, _, outs_t = xyz_drive
    exact = [tls.unpack_outputs(outs_t[b]) for b in range(B)]
    outs_q = _run_batch(
        tls.BatchLoamEngine(CFG, B, chunk=2, quantize_mm=5.0, device="cpu"),
        streams)
    assert np.abs(outs_q - outs_t).max() > 0  # staging did quantize
    for b in range(B):
        res = tls.unpack_outputs(outs_q[b])
        np.testing.assert_allclose(res["t_w_mo"], exact[b]["t_w_mo"],
                                   atol=5e-2)
    # and held to the JAX batch engine on the same int16 staging, as the
    # float32 path is: a wrong dequantize scale on the device would show
    outs_jq = _run_batch(
        jls.BatchLoamEngine(CFG, batch=B, chunk=2, quantize_mm=5.0), streams)
    assert np.abs(outs_jq - xyz_drive[2]).max() > 0
    _assert_close(outs_q, [jls.unpack_outputs(outs_jq[b]) for b in range(B)])


def test_single_engine_quantized_staging(xyz_drive):
    """LoamEngine(quantize_mm=5.0): the staged int16 buffer equals the JAX
    engine's, and the run stays within 5e-2 m of the exact one."""
    scans = xyz_drive[0][0]
    cap = CFG.lidar.max_points
    buf, n = tls.stage_scan(scans[0], cap, 5.0)
    want = jls.LoamEngine(CFG, quantize_mm=5.0)._stage(scans[0])
    assert buf.dtype == np.int16 and n == min(len(scans[0]), cap)
    np.testing.assert_array_equal(buf, want)
    far = np.asarray([[200.0, -200.0, 1.0]], np.float32)  # clamped
    np.testing.assert_array_equal(tls.stage_scan(far, 4, 5.0)[0][0],
                                  [32767, -32767, 200])
    runs = []
    for q in (0.0, 5.0):
        eng = tls.LoamEngine(CFG, chunk=2, quantize_mm=q, device="cpu")
        for s in scans:
            eng.push(s)
        runs.append(tls.unpack_outputs(eng.finish()))
    assert np.abs(runs[0]["t_w_mo"] - runs[1]["t_w_mo"]).max() > 0
    np.testing.assert_allclose(runs[1]["t_w_mo"], runs[0]["t_w_mo"],
                               atol=5e-2)


def test_carried_jax_batch_state_computes_the_same_frame(xyz_drive):
    streams, st2, outs_j, _ = xyz_drive
    st = convert.batch_state_from_numpy(st2, "cpu")
    assert int(st.frame_idx) == 2
    cap = CFG.lidar.max_points
    staged = [tls.stage_scan(streams[b][2], cap, 0.0) for b in range(B)]
    scans = torch.from_numpy(np.stack([s for s, _ in staged]))[:, None]
    ns = torch.tensor([[n] for _, n in staged])
    new, outs = tls.loam_run_chunk_batch(st, scans, ns, CFG)
    out, want = outs[:, 0].numpy(), outs_j[:, 2]
    np.testing.assert_allclose(out[:, :14], want[:, :14], atol=1e-4)
    np.testing.assert_allclose(out[:, 14:18], want[:, 14:18], atol=3e-4)
    np.testing.assert_allclose(out[:, 18:21], want[:, 18:21], atol=5e-3)
    assert np.abs(out[:, 21:23] - want[:, 21:23]).max() <= 2
    assert int(new.frame_idx) == 3
    assert (new.gm.corner.n_live > st.gm.corner.n_live).all()


def test_convert_batch_round_trip_is_exact(xyz_drive):
    st2 = xyz_drive[1]
    back = convert.batch_state_to_numpy(
        convert.batch_state_from_numpy(st2, "cpu"))
    assert type(back).__name__ == "BatchLoamState"
    a, b = jax.tree.leaves(st2), jax.tree.leaves(tuple(back))
    assert len(a) == len(b) == 14
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert back.gm.corner.pts.shape == (B * CFG.mapping.map_n_buckets,
                                        3 * CFG.mapping.corner_bucket_cap)


def test_batch_push_polar_matches_jax_batch_engine():
    streams = _drive(polar=True)
    outs_j = _run_batch(jls.BatchLoamEngine(CFG, batch=B, chunk=2), streams,
                        "push_polar")
    outs_t = _run_batch(tls.BatchLoamEngine(CFG, B, chunk=2, device="cpu"),
                        streams, "push_polar")
    assert outs_t.shape == (B, N, 24)
    _assert_close(outs_t, [jls.unpack_outputs(outs_j[b]) for b in range(B)])
    # and against the port's single engine on stream 1
    eng = tls.LoamEngine(CFG, chunk=2, device="cpu")
    for img in streams[1]:
        eng.push_polar(img)
    res, one = tls.unpack_outputs(outs_t[1]), tls.unpack_outputs(eng.finish())
    np.testing.assert_allclose(res["t_w_lo"], one["t_w_lo"], atol=1e-3)
    np.testing.assert_allclose(res["t_w_mo"], one["t_w_mo"], atol=1e-2)


def test_batch_pack12_matches_uint16():
    """pack12 staging is exact, so a pack12 engine gives identical rows;
    an odd tail (3 frames, chunk 2) is flushed by finish()."""
    scale = 0.03  # 122.8 m reach in 12 bits
    streams = [s[:3] for s in _drive(polar=True, scale=scale)]

    def run(packed):
        eng = tls.BatchLoamEngine(CFG, B, chunk=2, pack12=packed,
                                  device="cpu")
        for k in range(3):
            for b in range(B):
                eng.push_polar(b, streams[b][k], range_scale=scale)
        return eng.finish()

    a, b = run(True), run(False)
    assert a.shape == (B, 3, 24)
    np.testing.assert_array_equal(a, b)


def test_batch_engine_edges():
    eng = tls.BatchLoamEngine(CFG, B, device="cpu")
    assert eng.finish().shape == (B, 0, 24)
    eng.push(0, np.ones((10, 3), np.float32))
    with pytest.raises(ValueError, match="mix"):
        eng.push_polar(1, np.zeros((64, 900), np.uint16))
    eng = tls.BatchLoamEngine(CFG, B, device="cpu")
    eng.push_polar(0, np.zeros((64, 900), np.uint16))
    with pytest.raises(ValueError, match="mix"):
        eng.push(1, np.ones((10, 3), np.float32))
    st = tls.batch_states(CFG, 3, "cpu")
    assert st.q_w.shape == (3, 4) and st.corner_last.xyz.shape[0] == 3
    assert st.gm.surf.pts.shape[0] == 3 * CFG.mapping.map_n_buckets


@pytest.mark.parametrize("engine", ["LoamEngine", "BatchLoamEngine",
                                    "VloamEngine"])
def test_engines_default_to_the_card_and_raise_without_one(engine,
                                                           monkeypatch):
    """No device argument means the card; where torch.cuda.is_available()
    is false the constructor raises and nothing carries on on the CPU."""
    from vloam_tpu_torch import vloam_step as tvs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "LoamEngine": lambda **kw: tls.LoamEngine(CFG, **kw),
        "BatchLoamEngine": lambda **kw: tls.BatchLoamEngine(CFG, B, **kw),
        "VloamEngine": lambda **kw: tvs.VloamEngine(CFG, None, **kw),
    }[engine]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make(device="cuda:0")
