"""Front end of the port against the JAX package (eager, CPU): pyramid,
blur, FAST (and the Pallas kernel in interpret mode), grid top-k, BRIEF
tables, bit packing, extract_orb and make_frame."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from send_slam_tpu.config import CameraConfig as JCam, OrbConfig as JOrb
from send_slam_tpu.models import frame as jframe
from send_slam_tpu.ops import fast as jfast, orb as jorb, pyramid as jpyr
from send_slam_tpu.ops.pallas.fast_kernel import fast_score_map_pallas
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.config import CameraConfig as TCam, OrbConfig as TOrb
from send_slam_tpu_torch.models import frame as tframe
from send_slam_tpu_torch.ops import fast as tfast, fast_cuda, orb as torb
from send_slam_tpu_torch.ops import pyramid as tpyr

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)


def texture(h, w, seed=3):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(80):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
        img[y:y + rng.integers(3, 10), x:x + rng.integers(3, 10)] = \
            rng.uniform(40, 250)
    return img


@pytest.fixture(scope="module")
def scene():
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=8)
    return np.round(w.render(Rs[3], tls[3])).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def test_level_shapes_match():
    for hw in ((480, 640), (240, 320), (100, 128)):
        assert tpyr.level_shapes(*hw, 8, 1.2) == jpyr.level_shapes(*hw, 8, 1.2)


def test_pyramid_and_blur_bit_identical(scene):
    lj = jpyr.build_pyramid(jnp.asarray(scene), 4, 1.2)
    lt = tpyr.build_pyramid(T(scene), 4, 1.2)
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(jpyr.gaussian_blur(a)),
                                      tpyr.gaussian_blur(b).numpy())


@pytest.mark.parametrize("th", [7.0, 20.0])
def test_fast_and_nms_bit_identical(scene, th):
    j = jfast.fast_score_map(jnp.asarray(scene), th)
    t = tfast.fast_score_map(T(scene), th)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(jfast.nms3x3(j)),
                                  tfast.nms3x3(t).numpy())


@pytest.mark.parametrize("h,w,th", [(120, 160, 20.0), (100, 128, 12.0)])
def test_fast_score_matches_pallas_kernel(h, w, th):
    """The TPU kernel itself (interpret mode) against the port's CPU
    dispatch, interior [4:-4] at atol 1e-5 as the JAX package's kernel
    test checks it; the ragged 100-row case included."""
    img = texture(h, w)
    got_raw, got_nms = tfast.fast_score(T(img), th, with_nms=True)
    ref = np.asarray(fast_score_map_pallas(jnp.asarray(img), th,
                                           interpret=True))
    ref_nms = np.asarray(fast_score_map_pallas(jnp.asarray(img), th,
                                               interpret=True, with_nms=True))
    np.testing.assert_allclose(got_raw.numpy()[4:-4, 4:-4], ref[4:-4, 4:-4],
                               atol=1e-5)
    np.testing.assert_allclose(got_nms.numpy()[4:-4, 4:-4],
                               ref_nms[4:-4, 4:-4], atol=1e-5)


def test_fast_dispatch_cpu_uses_plain_version():
    img = T(texture(64, 80))
    before = fast_cuda.LIBRARY.launches
    raw = tfast.fast_score(img, 7.0)
    raw2, nms = tfast.fast_score(img[None].expand(2, -1, -1).contiguous(),
                                 7.0, with_nms=True)
    assert fast_cuda.LIBRARY.launches == before
    assert torch.equal(raw, tfast.fast_score_map(img, 7.0))
    assert torch.equal(raw2[1], raw) and torch.equal(nms[0],
                                                     tfast.nms3x3(raw))
    with pytest.raises(ValueError):
        fast_cuda.fast_score_levels_cuda([img], 7.0)  # a CPU tensor never runs


def test_constant_tables_array_equal():
    np.testing.assert_array_equal(jorb.brief_pattern(), torb.brief_pattern())
    np.testing.assert_array_equal(jorb._binned_pattern_indices(),
                                  torb._binned_pattern_indices())
    for p in (31, 33):
        np.testing.assert_array_equal(jorb._ic_moment_matrix(p),
                                      torb._ic_moment_matrix(p))


def test_grid_topk_exact_with_ties():
    rng = np.random.default_rng(1)
    # Mostly-zero maps with many equal scores: tie order must follow
    # jax.lax.top_k (lowest index first).
    s_hi = (rng.integers(0, 4, (60, 80)) * (rng.random((60, 80)) < 0.05)
            ).astype(np.float32)
    s_lo = (rng.integers(0, 3, (60, 80))).astype(np.float32)
    s_hi[:30, :40] = 0.0
    uj, vj, okj = jorb._grid_topk(jnp.asarray(s_hi), jnp.asarray(s_lo), 150, 8)
    ut, vt, okt = torb._grid_topk(T(s_hi), T(s_lo), 150, 8)
    np.testing.assert_array_equal(np.asarray(uj), ut.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())


def test_pack_bits_exact():
    bits = np.random.default_rng(2).random((40, 256)) < 0.5
    j = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    t = torb.pack_bits(T(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(j, t)


def test_patch_angle_brief_exact(scene):
    blurred = np.asarray(jpyr.gaussian_blur(jnp.asarray(scene)))
    rng = np.random.default_rng(4)
    uv = np.stack([rng.integers(16, 304, 200), rng.integers(16, 224, 200)],
                  -1).astype(np.int32)
    pj = jorb._gather_patches(jnp.asarray(blurred), jnp.asarray(uv), 16)
    pt = torb._gather_patches(T(blurred), T(uv), 16)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    aj = np.asarray(jorb.ic_angle_from_patches(pj))
    at = torb.ic_angle_from_patches(pt).numpy()
    np.testing.assert_allclose(at, aj, atol=1e-5)
    dj = np.asarray(jorb.brief_from_patches(pj, jnp.asarray(aj)))
    dt = torb.brief_from_patches(pt, T(aj)).numpy().view(np.uint32)
    np.testing.assert_array_equal(dj, dt)


def test_subpixel_offsets_close(scene):
    raw = np.asarray(jfast.fast_score_map(jnp.asarray(scene), 7.0))
    uv = np.argwhere(raw > 0)[:, ::-1][:300].astype(np.int32)
    j = np.asarray(jorb._subpixel_offsets(jnp.asarray(raw), jnp.asarray(uv)))
    t = torb._subpixel_offsets(T(raw), T(uv)).numpy()
    np.testing.assert_array_equal(j, t)


def _bin_edge_distance(angle):
    step = 2 * np.pi / torb.N_ANGLE_BINS
    frac = np.mod(angle / step, 1.0)
    return np.abs(frac - 0.5) * step


@pytest.mark.parametrize("dist", [None, "radtan", "kb8"])
def test_make_frame_matches(scene, dist):
    kw = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
    if dist == "radtan":
        kw.update(k1=0.08, k2=-0.05, p1=0.001, p2=-0.002, k3=0.01)
    elif dist == "kb8":
        kw.update(model="KannalaBrandt8", k1=0.02, k2=-0.01, p1=0.003,
                  p2=-0.001)
    orb = dict(n_features=512, n_levels=4)
    fj = jframe.make_frame(jnp.asarray(scene), 0.25, JOrb(**orb), JCam(**kw))
    ft = tframe.make_frame(scene, 0.25, TOrb(**orb), TCam(**kw),
                           device="cpu")
    a, b = fj.feat, ft.feat
    np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())
    np.testing.assert_array_equal(np.asarray(a.octave), b.octave.numpy())
    np.testing.assert_array_equal(np.asarray(a.response), b.response.numpy())
    # uv within 1e-4 px: the same f32 operations, ULP-level difference.
    np.testing.assert_allclose(b.uv.numpy(), np.asarray(a.uv), atol=1e-4)
    # Undistortion iterates f32 fixed points: 1e-4 px.
    np.testing.assert_allclose(ft.uv_und.numpy(), np.asarray(fj.uv_und),
                               atol=1e-4)
    # Descriptors of valid keypoints bit-identical, except where the
    # angle lies within 1e-4 rad of a 32-bin boundary (atan2 and the
    # moment sums may differ in the last bit there and flip the bin).
    valid = np.asarray(a.valid)
    ang = np.asarray(a.angle)
    differ = (np.asarray(a.desc) != b.desc.numpy().view(np.uint32)).any(1)
    assert not (differ & valid & (_bin_edge_distance(ang) > 1e-4)).any()
    assert valid.sum() > 300


def test_ic_angle_and_brief_descriptors(scene):
    """The JAX package's ic_angle and brief_descriptors (the gather then
    the patch functions) on the port: angles at 1e-5, descriptors bit
    for bit given the same angles."""
    blurred = np.asarray(jpyr.gaussian_blur(jnp.asarray(scene)))
    rng = np.random.default_rng(9)
    uv = np.stack([rng.integers(16, 304, 300), rng.integers(16, 224, 300)],
                  -1).astype(np.int32)
    uv[:4] = [[0, 0], [319, 239], [5, 200], [310, 3]]      # clamped
    aj = np.asarray(jorb.ic_angle(jnp.asarray(scene), jnp.asarray(uv)))
    at = torb.ic_angle(T(scene), T(uv))
    np.testing.assert_allclose(at.numpy(), aj, atol=1e-5)
    dj = np.asarray(jorb.brief_descriptors(jnp.asarray(blurred),
                                           jnp.asarray(uv), jnp.asarray(aj)))
    dt = torb.brief_descriptors(T(blurred), T(uv), T(aj))
    np.testing.assert_array_equal(dj, dt.numpy().view(np.uint32))


def test_hamming_u32_names():
    """pack_bits_to_u32 / unpack_u32_to_bits under the JAX names: the
    same words and bits (the port's words are int32 holding the uint32
    bits; its bits float32 where the JAX ones are bfloat16)."""
    from send_slam_tpu.ops import hamming as jham
    from send_slam_tpu_torch.ops import hamming as tham
    bits = (np.random.default_rng(3).random((50, 256)) < 0.5)
    for b in (bits, bits.astype(np.float32), bits.astype(np.int32)):
        j = np.asarray(jham.pack_bits_to_u32(jnp.asarray(b)))
        t = tham.pack_bits_to_u32(T(b))
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(j, t.numpy().view(np.uint32))
        uj = np.asarray(jham.unpack_u32_to_bits(jnp.asarray(j)), np.float32)
        ut = tham.unpack_u32_to_bits(t)
        np.testing.assert_array_equal(uj, ut.numpy())
        np.testing.assert_array_equal(ut.numpy(), bits.astype(np.float32))


def test_ops_package_exports():
    """The port's ops package exports the JAX package's names."""
    import send_slam_tpu.ops as jo
    import send_slam_tpu_torch.ops as to
    names = {n for n in dir(jo) if not n.startswith("_")} - {
        "fast", "hamming", "orb", "pallas", "pyramid", "segsum"}
    assert names and names <= set(dir(to))
