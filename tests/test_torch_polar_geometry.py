"""The port's polar geometry and its divisions by constants against the
jitted JAX package, bit for bit, on the CPU.

- Direction tables: scan_registration.polar_directions (the engines'
  table) against the JAX package's own decode of unit ranges
  (loam_step.polar_to_xyz, whose cos / sin / products are
  register_scan_polar's), at 16 and 64 rings and widths 2-4097 at a stride
  of 65 plus 360, 450, 900, 1800 and 4000. The port builds the table on the
  host with the C library's cosf / sinf, the functions XLA's CPU code
  calls, so no ulp separates the two.
- The azimuths against the reference's -jnp.linspace(0, 2 pi, A,
  endpoint=False) and the polar rel_time against its jnp.arange(A) / A,
  each jitted (XLA divides by A as a product by the float32 reciprocal).
- loam_step.polar_to_xyz against the JAX function on a seeded image; the
  layout (points and rel_time) of register_scan_polar against the jitted
  JAX function's full cloud.
- The tables each engine builds at its first push_polar (LoamEngine,
  BatchLoamEngine, VloamEngine's full and camera-FOV tables) against the
  reference's; LoamEngine.push_polar at 16 x 360 on tiny_test_profile
  against the JAX engine with its own directions: LO 1e-3 m, MO 1e-2 m.
- Every division by a constant that the port writes as a product by
  voxel.reciprocal_f32, against the reference's expression under jax.jit
  on seeded inputs: the voxel cell and the cube coordinate through the
  port's functions, the others as the site's expression, on inputs that
  make its operand exact in both packages (integer-valued sums) and that
  a true division rounds apart. Around them: the so3 functions on angles
  in their series branch, and both voxel filters on points at voxel faces
  (which points share a voxel follows the cell's rounding).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu import config as jcfg
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.geometry import so3 as jso3
from vloam_tpu.lidar import loam_step as jls
from vloam_tpu.lidar import mapping as jmap
from vloam_tpu.lidar import scan_registration as jsr
from vloam_tpu.lidar import voxel as jvox
from vloam_tpu_torch import config as tcfg
from vloam_tpu_torch import vloam_step as tvs
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.geometry import so3 as tso3
from vloam_tpu_torch.lidar import loam_step as tls
from vloam_tpu_torch.lidar import mapping as tmap
from vloam_tpu_torch.lidar import scan_registration as tsr
from vloam_tpu_torch.lidar import voxel as tvox
from vloam_tpu_torch.lidar.voxel import _cell_of, reciprocal_f32

torch.set_num_threads(1)

WIDTHS = list(range(2, 4098, 65)) + [360, 450, 900, 1800, 4000]
RINGS = (16, 64)


def _elev(S: int) -> np.ndarray:
    return np.radians(jsyn.hdl64_elevations(S)).astype(np.float32)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_bits_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@partial(jax.jit, static_argnums=1)
def _jax_table(elev, A):
    """The reference's direction table [S, A, 3]: its polar_to_xyz of
    unit ranges."""
    S = elev.shape[0]
    ones = jnp.ones((S, A), jnp.uint16)
    return jls.polar_to_xyz(ones, elev, 1.0).reshape(S, A, 3)


@partial(jax.jit, static_argnums=(1, 2))
def _jax_fov_table(elev, A, frac):
    """The reference combined engine's FOV table (vloam_tpu/vloam_step.py:
    382-389, 398) of unit ranges."""
    S = elev.shape[0]
    half = min(A, max(1, int(round(A * frac / 2.0))))
    az_full = -jnp.arange(A, dtype=jnp.float32) * (2.0 * jnp.pi / A)
    az = (jnp.concatenate([az_full[:half], az_full[A - half:]])
          if 2 * half < A else az_full)
    ones = jnp.ones((S, az.shape[0]), jnp.uint16)
    return jls.polar_to_xyz_cols(ones, elev, az, 1.0).reshape(S, -1, 3)


@pytest.mark.parametrize("A", WIDTHS)
@pytest.mark.parametrize("S", RINGS)
def test_polar_directions_equal_jax(S, A):
    elev = _elev(S)
    _assert_bits_equal(tsr.polar_directions(elev, A, "cpu"),
                       _jax_table(jnp.asarray(elev), A))


@pytest.mark.parametrize("A", WIDTHS)
def test_azimuths_equal_jax(A):
    want = jax.jit(lambda: -jnp.linspace(0.0, 2.0 * jnp.pi, A,
                                         endpoint=False))()
    _assert_bits_equal(tsr.azimuth_angles(A), want)


@pytest.mark.parametrize("A", WIDTHS)
def test_polar_rel_time_equals_jax(A):
    """polar_layout's rel_time of an image with every ray valid: row s is
    the column's rel_time."""
    S = 16
    img = torch.full((S, A), 1000, dtype=torch.int32)
    dirs = tsr.polar_directions(_elev(S), A, "cpu")
    _, rt, counts = tsr.polar_layout(img, dirs,
                                     tcfg.tiny_test_profile().lidar)
    assert counts.tolist() == [A] * S
    want = jax.jit(lambda: jnp.broadcast_to((jnp.arange(A) / A)[None, :],
                                            (S, A)))()
    _assert_bits_equal(rt, want)


@pytest.mark.parametrize("A", WIDTHS)
@pytest.mark.parametrize("S", RINGS)
def test_polar_to_xyz_equals_jax(S, A):
    rng = np.random.default_rng(S * 10000 + A)
    img = rng.integers(0, 20000, (S, A)).astype(np.uint16)
    img[:, ::7] = 0
    elev = _elev(S)
    want = jax.jit(jls.polar_to_xyz, static_argnums=2)(
        jnp.asarray(img), jnp.asarray(elev), 0.005)
    _assert_bits_equal(
        tls.polar_to_xyz(torch.from_numpy(img.astype(np.int32)),
                         elev, 0.005), want)


@pytest.fixture(scope="module")
def tiny_scene():
    return jsyn.urban_scene(21), jsyn.drive_trajectory(4, speed=1.0,
                                                       yaw_rate=0.02)


@pytest.mark.parametrize("A", [360, 450, 900, 1800])
def test_register_scan_polar_layout_equals_jax(tiny_scene, A):
    """The full cloud of register_scan_polar (the layout's points and
    rel_time) against the jitted JAX function, each package with its own
    directions."""
    scene, poses = tiny_scene
    cfg = jcfg.tiny_test_profile()
    img = jsyn.simulate_scan_polar(scene, poses[1], n_scans=16, n_azimuth=A,
                                   seed=3)
    elev = _elev(16)
    fj = jax.jit(jsr.register_scan_polar, static_argnums=(2, 3))(
        jnp.asarray(img), jnp.asarray(elev), cfg.lidar, cfg.scanreg)
    tc = tcfg.tiny_test_profile()
    ft = tsr.register_scan_polar(torch.from_numpy(img.astype(np.int32)),
                                 tsr.polar_directions(elev, A, "cpu"),
                                 tc.lidar, tc.scanreg)
    assert int(ft.full.mask.sum()) > 1000
    for name in ("xyz", "rel_time", "mask"):
        _assert_bits_equal(getattr(ft.full, name), getattr(fj.full, name))


def _calib():
    cfg = tcfg.tiny_test_profile()
    K, P_rect0, _, velo_T_cam = tsyn.default_cam_calib(cfg.vo.img_width,
                                                       cfg.vo.img_height)

    class Calib:
        pass

    calib = Calib()
    calib.K = K
    calib.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    calib.imu_T_velo = np.eye(4)
    calib.imu_T_cam0 = velo_T_cam
    return calib


@pytest.mark.parametrize("A", [360, 1800])
@pytest.mark.parametrize("engine", ["loam", "batch", "vloam_full",
                                    "vloam_fov"])
def test_engine_direction_tables_equal_jax(engine, A):
    """The table an engine builds at its first push_polar (one frame, under
    its chunk: nothing runs) against the reference's."""
    cfg = tcfg.tiny_test_profile()
    img = np.zeros((cfg.lidar.n_scans, A), np.uint16)
    elev = jnp.asarray(_elev(cfg.lidar.n_scans))
    if engine == "loam":
        eng = tls.LoamEngine(cfg, chunk=2, device="cpu")
        eng.push_polar(img)
        got = eng._dirs
    elif engine == "batch":
        eng = tls.BatchLoamEngine(cfg, 2, chunk=2, device="cpu")
        eng.push_polar(1, img)
        got = eng._dirs
    else:
        eng = tvs.VloamEngine(cfg, _calib(), chunk=2, device="cpu")
        eng.push_polar(img, np.zeros((cfg.vo.img_height, cfg.vo.img_width),
                                     np.uint8))
        got = eng._geom.dirs if engine == "vloam_full" else eng._geom.fov_dirs
    want = (_jax_table(elev, A) if engine != "vloam_fov"
            else _jax_fov_table(elev, A, cfg.vo.polar_fov_fraction))
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("frac", [1.0 / 3.0, 0.5, 1.0])
@pytest.mark.parametrize("A", [360, 450, 1800, 4000])
def test_fov_table_equals_jax(A, frac):
    elev = _elev(64)
    geom = tvs.PolarGeometry.create(elev, A, frac, "cpu")
    _assert_bits_equal(geom.fov_dirs,
                       _jax_fov_table(jnp.asarray(elev), A, frac))
    _assert_bits_equal(geom.dirs, _jax_table(jnp.asarray(elev), A))


def test_push_polar_16x360_matches_jax_engine(tiny_scene):
    """LoamEngine.push_polar at 16 x 360 on tiny_test_profile, each engine
    with its own ray directions."""
    scene, poses = tiny_scene
    imgs = [jsyn.simulate_scan_polar(scene, T, n_scans=16, n_azimuth=360,
                                     seed=k) for k, T in enumerate(poses)]
    outs = []
    for eng in (jls.LoamEngine(jcfg.tiny_test_profile(), chunk=2),
                tls.LoamEngine(tcfg.tiny_test_profile(), chunk=2,
                               device="cpu")):
        for img in imgs:
            eng.push_polar(img)
        outs.append(eng.finish())
    o_j = jls.unpack_outputs(np.asarray(outs[0]))
    o_t = tls.unpack_outputs(outs[1])
    np.testing.assert_allclose(o_t["t_w_lo"], o_j["t_w_lo"], atol=1e-3)
    np.testing.assert_allclose(o_t["t_w_mo"], o_j["t_w_mo"], atol=1e-2)
    gt = np.stack([T[:3, 3] for T in poses])
    assert np.linalg.norm(o_t["t_w_mo"] - gt, axis=1).max() < 0.3


def _nudge(rng, x: np.ndarray) -> np.ndarray:
    """Each float32 value moved by 3 random ulp steps up or down."""
    for _ in range(3):
        x = np.where(rng.random(x.shape) < 0.5,
                     np.nextafter(x, np.float32(-1e9)),
                     np.nextafter(x, np.float32(1e9))).astype(np.float32)
    return x


def _near_multiples(rng, step: float, n: int, span: int) -> np.ndarray:
    """float32 values within a few ulps of k * step, k != 0: where a
    division and a product by the reciprocal round to different sides (k =
    0 would give subnormals, which XLA's CPU code flushes to zero)."""
    k = rng.integers(1, span, n) * rng.choice([-1, 1], n)
    return _nudge(rng, (k * step).astype(np.float32))


def _int_valued(rng, shape, hi: int = 9) -> np.ndarray:
    return rng.integers(-hi, hi, shape).astype(np.float32)


def _site_voxel(rng, leaf):
    x = _near_multiples(rng, leaf, 30000, 2000).reshape(-1, 3)
    return (_cell_of(torch.from_numpy(x), leaf),
            jax.jit(lambda v: jnp.floor(v / leaf).astype(jnp.int32))(x))


def _site_cube_coord(rng):
    x = (_near_multiples(rng, 50.0, 30000, 40) - 25.0).reshape(-1, 3)
    return (tmap._cube_coord(torch.from_numpy(x), 50.0),
            jax.jit(jmap._cube_coord, static_argnums=1)(x, 50.0))


def _site_corner_cov(rng):
    knn = jcfg.LaserMappingConfig().knn
    dm = _int_valued(rng, (3, 4000, knn))
    return (tmap._gram(torch.from_numpy(dm)) * reciprocal_f32(knn),
            jax.jit(lambda d: jnp.einsum("iqk,jqk->qij", d, d) / knn)(dm))


def _site_expr(c, lo, hi):
    """x / c on uniform float32 draws from [lo, hi)."""
    def site(rng):
        x = rng.uniform(lo, hi, 20000).astype(np.float32)
        return (torch.from_numpy(x) * reciprocal_f32(c),
                jax.jit(lambda v: v / c)(x))
    return site


def _site_clahe(rng, h, tiles):
    """clahe's tile coordinate (yy - th / 2) / th along an image side."""
    t = -(-h // tiles)
    yy = np.arange(h, dtype=np.float32)
    return ((torch.from_numpy(yy) - t / 2.0) * reciprocal_f32(t),
            jax.jit(lambda y: (y - t / 2.0) / t)(yy))


def _site_zncc_mean(rng, p):
    patch = _int_valued(rng, (512, p * p), 255)
    return (torch.sum(torch.from_numpy(patch), dim=1, keepdim=True)
            * reciprocal_f32(p * p),
            jax.jit(lambda x: jnp.sum(x, axis=1, keepdims=True) / (p * p))(
                patch))


def _site_image_scale(rng):
    u8 = np.arange(256, dtype=np.uint8)[rng.permutation(256)]
    return (torch.from_numpy(u8).to(torch.float32) * reciprocal_f32(255.0),
            jax.jit(lambda u: u.astype(jnp.float32) / 255.0)(u8))


SITES = {
    # lidar/voxel.py voxel_downsample (mapping stacks) and
    # voxel_downsample_rows_slab (the less-flat filter): floor(x / leaf)
    "voxel_line_resolution": partial(_site_voxel, leaf=0.4),
    "voxel_plane_resolution": partial(_site_voxel, leaf=0.8),
    "voxel_less_flat_leaf": partial(_site_voxel, leaf=0.2),
    # lidar/mapping.py _cube_coord: (p + cube_size / 2) / cube_size
    "mapping_cube_coord": _site_cube_coord,
    # lidar/mapping.py corner_geometry: the covariance over cfg.knn
    "mapping_corner_cov": _site_corner_cov,
    # geometry/so3.py, the small-angle branches (theta2 < 1e-8):
    # quat_from_axis_angle's theta2 / 48, _rodrigues_coeffs' theta2 / 6 and
    # theta2 / 24
    "so3_quat_from_axis_angle": _site_expr(48.0, 0.0, 1e-8),
    "so3_rodrigues_s": _site_expr(6.0, 0.0, 1e-8),
    "so3_rodrigues_c1": _site_expr(24.0, 0.0, 1e-8),
    # vision/features.py clahe: the tile coordinates over th and tw
    "clahe_rows": partial(_site_clahe, h=375, tiles=8),
    "clahe_cols": partial(_site_clahe, h=1242, tiles=8),
    # vision/features.py zncc_describe_plain: the patch mean over p * p
    "zncc_mean_p24": partial(_site_zncc_mean, p=24),
    "zncc_mean_p13": partial(_site_zncc_mean, p=13),
    # vloam_step.py _vision_lo_frame: image_u8 / 255
    "image_scale": _site_image_scale,
}


@pytest.mark.parametrize("site", list(SITES))
def test_constant_division_equals_jitted_reference(site):
    rng = np.random.default_rng(sorted(SITES).index(site))
    got, want = SITES[site](rng)
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("fn", ["quat_from_axis_angle", "rotate_axis_angle"])
def test_so3_small_angle_branch_equals_jax(fn):
    """The functions around the so3 sites, on angles in their series
    branch."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((20000, 3))
         * rng.uniform(1e-7, 5e-5, (20000, 1))).astype(np.float32)
    args = [v] + ([rng.standard_normal(v.shape).astype(np.float32)]
                  if fn == "rotate_axis_angle" else [])
    _assert_bits_equal(getattr(tso3, fn)(*map(torch.from_numpy, args)),
                       jax.jit(getattr(jso3, fn))(*args))


def _voxel_points(rng, leaf: float, n: int = 6000) -> np.ndarray:
    """Points in 400 voxels (15 a voxel on average), a third of their
    coordinates within a few ulps of a voxel face away from 0."""
    cells = rng.integers(1, 60, (400, 3)) * rng.choice([-1, 1], (400, 3))
    x = ((cells[rng.integers(0, 400, n)] + rng.random((n, 3)))
         * leaf).astype(np.float32)
    k = np.round(x / leaf)
    faces = _nudge(rng, (k * leaf).astype(np.float32))
    return np.where((rng.random((n, 3)) < 0.33) & (k != 0), faces, x)


@pytest.mark.parametrize("leaf", [0.2, 0.4, 0.8])
@pytest.mark.parametrize("fn", ["voxel_downsample",
                                "voxel_downsample_rows_slab"])
def test_voxel_membership_on_faces_equals_jax(fn, leaf):
    """Both voxel filters on points at voxel faces: which points share a
    voxel follows the cell's rounding. The output mask is compared
    exactly, the centroids to 1e-3 m: their prefix sums round apart by up
    to 2.4e-4 m at these 48 m coordinates, and a point in the wrong voxel
    moves a centroid by ~leaf / 15 >= 0.013 m."""
    rng = np.random.default_rng(int(leaf * 10))
    x = _voxel_points(rng, leaf)
    mask = rng.random(x.shape[0]) < 0.9
    if fn == "voxel_downsample":
        args, kw = (x, mask), dict(leaf=leaf, out_cap=4096)
    else:
        args = (x.reshape(8, -1, 3), mask.reshape(8, -1))
        kw = dict(leaf=leaf, ring_cap=512)
    want = jax.jit(partial(getattr(jvox, fn), **kw))(*args)
    got = getattr(tvox, fn)(*map(torch.from_numpy, args), **kw)
    m_t, m_j = got[-1].numpy(), np.asarray(want[-1])
    np.testing.assert_array_equal(m_t, m_j)
    assert m_j.sum() > 300
    np.testing.assert_allclose(got[0].numpy()[m_j], np.asarray(want[0])[m_j],
                               rtol=0, atol=1e-3)
