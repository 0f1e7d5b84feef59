"""The port's camera lanes (send_slam_tpu_torch/parallel/) against the
JAX package's on the CPU.

- The mesh: ``make_mesh`` shapes as JAX's, for 1-8 devices and 1-D and
  2-D axis names; lanes in contiguous blocks.
- The batched front end: ``make_frames`` equals ``make_frame`` per lane
  bit for bit, makes one ``fast_score_levels`` call for all lanes, and
  equals JAX's ``vmap(make_frame)`` with exact descriptors.
- ``multicam_track_step`` at tests/test_parallel.py's tiny configuration,
  8 lanes on an 8-entry CPU mesh.
- ``multicam_slam_step`` with loop closing, 2 lanes on a 1-device mesh,
  on an out-and-back scene in which the lanes store a reference, veto a
  translation direction, commit, insert keyframes, hit the keyframe
  capacity (forced cull and compaction) and close a loop, with the JAX
  package's draws injected: the port running free from the start
  through the commits and the first keyframes, then one port step from
  each carried JAX state, and from carried states poisoned into the
  collapse reset, the LOST prior and the lane reset. One JAX step
  function serves every case (each compiles in ~30 s).

The whole-session twins of tests/test_parallel.py's slow tests run the
port alone and are marked slow, as those are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.models import frame as jframe
from send_slam_tpu.models.initializer import _sample_minimal_sets
from send_slam_tpu.models.map_state import MapState as JMap
from send_slam_tpu.ops.hamming import match_descriptors as jmatch
from send_slam_tpu.parallel import mesh as jmesh
from send_slam_tpu.parallel import multicam as jmc
from send_slam_tpu_torch.models import frame as tframe
from send_slam_tpu_torch.models.loop_closing import N_HYP
from send_slam_tpu_torch.ops import orb as torb
from send_slam_tpu_torch.parallel import mesh as tmesh
from send_slam_tpu_torch.parallel import multicam as tmc
from send_slam_tpu_torch.utils.synth import SyntheticWorld

torch.set_num_threads(1)

N_LANES = 2
N_STEPS = 22
FREE_STEPS = 7      # both lanes commit and insert their first keyframe


def tiny_cfg(C):
    """tests/test_parallel.py's tiny_cfg."""
    return C.EngineConfig(
        orb=C.OrbConfig(n_features=64, n_levels=2),
        camera=C.CameraConfig(width=96, height=64, fx=60.0, fy=60.0,
                              cx=48.0, cy=32.0),
        map=C.MapConfig(max_keyframes=8, max_landmarks=256, ba_window=4))


def lanes_cfg(C):
    """tests/test_parallel.py's 160x120 lanes with keyframes every one
    or two frames (so the 8-slot table fills) and a loop closure that
    can fire on an 8-slot table: a 3-keyframe gap, a low score floor, a
    2-keyframe cooldown and 6 verified matches."""
    return C.EngineConfig(
        orb=C.OrbConfig(n_features=256, n_levels=3),
        camera=C.CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                              cx=80.0, cy=60.0),
        map=C.MapConfig(max_keyframes=8, max_landmarks=1024, ba_window=4),
        tracking=C.TrackingConfig(init_min_matches=30, kf_min_interval=1,
                                  kf_max_interval=2, loop_min_gap_kf=3,
                                  loop_score_min=0.05, loop_cooldown_kf=2,
                                  loop_min_matches=6))


WORLD = SyntheticWorld(n_points=700, width=160, height=120, fx=130.0,
                       fy=130.0)


def lane_center(lane, s, n_steps=N_STEPS):
    """Out and back along x, lanes 0.35 m apart, a small y wiggle."""
    a = s / (n_steps - 1)
    x = 1.2 * (1 - abs(2 * a - 1))
    return np.array([0.35 * lane - 1.2 + x, 0.05 * np.sin(0.7 * s), 0.0])


def lane_images(s, n=N_LANES, blank=()):
    imgs = [np.zeros((120, 160)) if lane in blank
            else WORLD.render(np.eye(3), -lane_center(lane, s))
            for lane in range(n)]
    return np.stack(imgs).astype(np.float32), np.full(n, s / 30.0,
                                                      np.float32)


# ---------------------------------------------------------------------------
# Carrying states between the packages


def jax_to_numpy(js):
    d = {f: np.asarray(getattr(js, f)) for f in js._fields if f != "maps"}
    d["maps"] = {k: np.asarray(v) for k, v in js.maps._asdict().items()}
    return d


def numpy_to_jax(d, mesh):
    sh = NamedSharding(mesh, P("cam"))

    def put(x):
        return jax.device_put(jnp.asarray(x), sh)

    return jmc.MultiCamState(
        maps=JMap(**{k: put(v) for k, v in d["maps"].items()}),
        **{f: put(d[f]) for f in jmc.MultiCamState._fields if f != "maps"})


def copy_state(d):
    out = {k: np.array(v) for k, v in d.items() if k != "maps"}
    out["maps"] = {k: np.array(v) for k, v in d["maps"].items()}
    return out


# ---------------------------------------------------------------------------
# The JAX run, with the draws each lane's key gives


class JaxLanes:
    def __init__(self, make_cfg=lanes_cfg, loop_closing=True):
        self.cfg_j = make_cfg(jc)
        self.cfg_t = make_cfg(tc)
        self.loop_closing = loop_closing
        self.mesh = jmesh.make_mesh(1, ("cam",))
        self.step = jmc.multicam_slam_step(self.cfg_j, self.mesh,
                                           loop_closing=loop_closing)
        tr = self.cfg_j.tracking
        N = self.cfg_j.orb.n_features

        @jax.jit
        def draws(keys, ref_desc, ref_valid, ref_angle, desc, valid, angle):
            def one(key, rd, rv, ra, d, v, a):
                m = jmatch(rd, d, rv, v, max_dist=float(tr.hamming_th_low),
                           ratio=0.9, mutual=True, angles_a=ra, angles_b=a)
                k1 = jax.random.fold_in(key, 1)
                return (_sample_minimal_sets(key, m.valid,
                                             tr.init_ransac_iters, 8),
                        _sample_minimal_sets(k1, m.valid,
                                             tr.init_ransac_iters, 4),
                        jax.random.gumbel(k1, (N_HYP, N)))
            return jax.vmap(one)(keys, ref_desc, ref_valid, ref_angle, desc,
                                 valid, angle)

        self._draws = draws

    def draws(self, keys, state_np, imgs, tss):
        """The per-lane draws of the JAX step on ``keys`` from
        ``state_np``: the current frames' features are the port's
        (bit-equal to the JAX package's, test_make_frames_*)."""
        frames = tframe.make_frames(imgs, tss, self.cfg_t.orb,
                                    self.cfg_t.camera, device="cpu")
        desc = np.stack([f.feat.desc.numpy().view(np.uint32)
                         for f in frames])
        valid = np.stack([f.feat.valid.numpy() for f in frames])
        angle = np.stack([f.feat.angle.numpy() for f in frames])
        e, h, g = self._draws(keys, state_np["ref_desc"],
                              state_np["ref_valid"], state_np["ref_angle"],
                              desc, valid, angle)
        e, h, g = (np.array(x) for x in (e, h, g))
        return [dict(init=(torch.from_numpy(e[c]), torch.from_numpy(h[c])),
                     loop=torch.from_numpy(g[c]))
                for c in range(len(keys))]

    def run_step(self, state_np, imgs, tss, keys):
        js, summary = self.step(numpy_to_jax(state_np, self.mesh),
                                jnp.asarray(imgs), jnp.asarray(tss), keys)
        return jax_to_numpy(js), np.asarray(summary)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX lanes over the out-and-back scene: per step the state
    before, the inputs, the keys, the state after and the summary."""
    jl = JaxLanes()
    state = jax_to_numpy(jmc.init_multicam(jl.cfg_j, N_LANES))
    key = jax.random.PRNGKey(0)
    steps = []
    for s in range(N_STEPS):
        imgs, tss = lane_images(s)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, N_LANES)
        after, summary = jl.run_step(state, imgs, tss, keys)
        steps.append(dict(before=state, imgs=imgs, tss=tss, keys=keys,
                          after=after, summary=summary))
        state = after
    return jl, steps


def branch_steps(steps):
    """(step, lane) of the first occurrence of each branch in the run."""
    found = {}

    def mark(name, s, lane):
        found.setdefault(name, (s, lane))

    for s, st in enumerate(steps):
        b, a = st["before"], st["after"]
        for c in range(N_LANES):
            if b["mode"][c] == jmc.MODE_NO_REF and a["mode"][c] == \
                    jmc.MODE_HAS_REF:
                mark("ref_store", s, c)
            if a["init_rejects"][c] > b["init_rejects"][c]:
                mark("tdir_veto", s, c)
            if b["mode"][c] == jmc.MODE_HAS_REF and a["mode"][c] == \
                    jmc.MODE_TRACKING:
                mark("commit", s, c)
            inserted = a["kf_total"][c] == b["kf_total"][c] + 1
            if inserted and b["mode"][c] == jmc.MODE_TRACKING:
                mark("keyframe", s, c)
                if a["maps"]["n_kf"][c] <= b["maps"]["n_kf"][c]:
                    mark("capacity", s, c)
                if a["loops_total"][c] > b["loops_total"][c]:
                    mark("loop_apply", s, c)
                elif "loop_apply" in found and found["loop_apply"][1] == c:
                    mark("loop_cooldown", s, c)
    return found


# ---------------------------------------------------------------------------
# Comparisons

EXACT_LANE = ("mode", "frames_since_kf", "lost_frames", "kf_total",
              "loop_last_cand", "loop_run", "kf_since_loop", "loops_total",
              "init_rejects", "probe_armed", "collapse_resets", "ref_desc",
              "ref_valid", "ref_oct", "ref_ts")
# The stored reference's keypoints and angles at the front end's
# tolerances (test_make_frames_equals_jax_vmap); the t-direction of a
# candidate at the parallax floor is ill-conditioned (a few 1e-4 between
# solvers) and only meets a 12-degree cosine gate.
CLOSE_LANE = dict(R=1e-4, t=1e-4, init_v=1e-4, init_commit_ts=1e-6,
                  probe_t0=1e-6, probe_pos0=1e-4, ref_uv=1e-4,
                  ref_angle=1e-5, init_tdir=1e-3)
EXACT_MAP = ("n_kf", "kf_valid", "kf_chain_break", "kf_octave",
             "kf_kp_valid", "kf_desc", "kf_timestamp")


def assert_summary_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    exact = [0, 2, 3, 7, 8, 9]
    np.testing.assert_array_equal(got[:, exact], ref[:, exact])
    assert np.abs(got[:, 1] - ref[:, 1]).max() <= 2, (got[:, 1], ref[:, 1])
    np.testing.assert_allclose(got[:, 4:7], ref[:, 4:7], atol=1e-4)


def assert_state_close(got, ref):
    for f in EXACT_LANE:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert np.abs(got["inliers_at_kf"].astype(int)
                  - ref["inliers_at_kf"]).max() <= 2
    for f, tol in CLOSE_LANE.items():
        np.testing.assert_allclose(got[f], ref[f], atol=tol, err_msg=f)
    for f in EXACT_MAP:
        np.testing.assert_array_equal(got["maps"][f], ref["maps"][f],
                                      err_msg=f)
    for f in ("kf_R", "kf_t"):
        np.testing.assert_allclose(got["maps"][f], ref["maps"][f],
                                   atol=1e-3, err_msg=f)
    # Landmark rows: the counts agree, and the positions of the rows
    # both tables hold to 1e-3 of the scene's scale.
    gv, rv = got["maps"]["lm_valid"], ref["maps"]["lm_valid"]
    np.testing.assert_array_equal(gv.sum(1), rv.sum(1))
    both = gv & rv
    assert both.sum() >= 0.95 * rv.sum()
    np.testing.assert_allclose(got["maps"]["lm_pos"][both],
                               ref["maps"]["lm_pos"][both], atol=1e-3)


def port_step(jl, state_np, imgs, tss, keys, seed=0):
    mesh = tmesh.make_mesh(1, devices=["cpu"])
    step = tmc.multicam_slam_step(jl.cfg_t, mesh,
                                  loop_closing=jl.loop_closing)
    state = tmc.multicam_state_from_numpy(state_np, device="cpu", seed=seed)
    new, summary = step(state, imgs, tss,
                        draws=jl.draws(keys, state_np, imgs, tss))
    return tmc.multicam_state_to_numpy(new), summary.numpy()


# ---------------------------------------------------------------------------
# The mesh


@pytest.mark.parametrize("axes", [("cam",), ("cam", "feat")])
@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n, axes):
    got = tmesh.make_mesh(n, axes, devices=["cpu"] * 8)
    ref = jmesh.make_mesh(n, axes)
    assert got.shape == dict(ref.shape)
    assert got.devices.shape == ref.devices.shape
    assert got.axis_names == tuple(ref.axis_names)


def test_lane_blocks_are_contiguous():
    mesh = tmesh.make_mesh(4, ("cam",), devices=["cpu"] * 4)
    blocks = mesh.lane_blocks(8)
    assert [list(b) for _, b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        mesh.lane_blocks(6)


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmc.init_multicam(tiny_cfg(tc), 2)


# ---------------------------------------------------------------------------
# The batched front end


def _lane_batch(n=3):
    imgs, tss = lane_images(4, n=n)
    return imgs, tss


def test_make_frames_equals_make_frame_per_lane():
    cfg = lanes_cfg(tc)
    imgs, tss = _lane_batch()
    frames = tframe.make_frames(imgs, tss, cfg.orb, cfg.camera, device="cpu")
    for c, f in enumerate(frames):
        one = tframe.make_frame(imgs[c], float(tss[c]), cfg.orb, cfg.camera,
                                device="cpu")
        for a, b in zip(f.feat, one.feat):
            assert torch.equal(a, b)
        assert torch.equal(f.uv_und, one.uv_und)
        assert torch.equal(f.timestamp, one.timestamp)
        assert int(f.feat.valid.sum()) > 100


def test_make_frames_makes_one_fast_call(monkeypatch):
    calls = []
    real = torb.fast_score_levels

    def counting(levels, threshold, with_nms=False):
        calls.append([tuple(lv.shape) for lv in levels])
        return real(levels, threshold, with_nms)

    monkeypatch.setattr(torb, "fast_score_levels", counting)
    cfg = lanes_cfg(tc)
    imgs, tss = _lane_batch()
    tframe.make_frames(imgs, tss, cfg.orb, cfg.camera, device="cpu")
    assert calls == [[(3, 120, 160), (3, 100, 130), (3, 80, 105)]]


def test_make_frames_equals_jax_vmap():
    cfg_j, cfg_t = lanes_cfg(jc), lanes_cfg(tc)
    imgs, tss = _lane_batch()
    jf = jax.jit(jax.vmap(lambda img, ts: jframe.make_frame(
        img, ts, cfg_j.orb, cfg_j.camera)))(jnp.asarray(imgs),
                                            jnp.asarray(tss))
    frames = tframe.make_frames(imgs, tss, cfg_t.orb, cfg_t.camera,
                                device="cpu")
    for c, f in enumerate(frames):
        np.testing.assert_array_equal(f.feat.desc.numpy().view(np.uint32),
                                      np.asarray(jf.feat.desc[c]))
        np.testing.assert_array_equal(f.feat.valid.numpy(),
                                      np.asarray(jf.feat.valid[c]))
        np.testing.assert_array_equal(f.feat.octave.numpy(),
                                      np.asarray(jf.feat.octave[c]))
        np.testing.assert_allclose(f.uv_und.numpy(),
                                   np.asarray(jf.uv_und[c]), atol=1e-4)
        np.testing.assert_allclose(f.feat.angle.numpy(),
                                   np.asarray(jf.feat.angle[c]), atol=1e-5)


# ---------------------------------------------------------------------------
# multicam_track_step


def test_track_step_matches_jax():
    """8 lanes on an 8-entry mesh over three steps of a lanes scene. The
    caller sets each lane's pose to the true one before a step (with no
    map a lane cannot move itself), so the second keyframe triangulates
    against the first and the third step tracks on those landmarks."""
    n = 8
    cfg_j, cfg_t = tiny_cfg(jc), tiny_cfg(tc)
    jm = jmesh.make_mesh(n, ("cam",))
    jstep = jmc.multicam_track_step(cfg_j, jm)
    tstep = tmc.multicam_track_step(
        cfg_t, tmesh.make_mesh(n, ("cam",), devices=["cpu"] * n))
    world = SyntheticWorld(n_points=500, width=96, height=64, fx=60.0,
                           fy=60.0)
    sh = NamedSharding(jm, P("cam"))
    js = jax.tree.map(lambda x: jax.device_put(x, sh),
                      jmc.init_multicam(cfg_j, n))
    ts = tmc.init_multicam(cfg_t, n, device="cpu")
    inliers = []
    for s in range(3):
        centers = np.stack([[0.3 * c - 1.2 + 0.15 * s, 0.0, 0.0]
                            for c in range(n)]).astype(np.float32)
        imgs = np.stack([world.render(np.eye(3), -c)
                         for c in centers]).astype(np.float32)
        tss = np.full(n, s / 30.0, np.float32)
        js = js._replace(t=jax.device_put(jnp.asarray(-centers), sh))
        ts = ts._replace(t=torch.from_numpy(-centers))
        js, jn, jtot, jt = jmc_track(jstep, js, imgs, tss)
        ts, tn, ttot, tt = tstep(ts, imgs, tss)
        np.testing.assert_array_equal(tn.numpy(), jn)
        assert int(ttot) == int(jtot) == int(jn.sum())
        np.testing.assert_array_equal(ts.maps.n_kf.numpy(),
                                      np.asarray(js.maps.n_kf))
        np.testing.assert_allclose(tt.numpy(), jt, atol=1e-4)
        inliers.append(int(jtot))
    assert np.asarray(js.maps.n_kf).tolist() == [3] * n
    assert inliers[0] == 0 and inliers[2] > 8 * n, inliers


def jmc_track(step, js, imgs, tss):
    js, n_inl, total, all_t = step(js, jnp.asarray(imgs), jnp.asarray(tss))
    return js, np.asarray(n_inl), np.asarray(total), np.asarray(all_t)


# ---------------------------------------------------------------------------
# multicam_slam_step


def test_run_covers_every_branch(jax_run):
    _, steps = jax_run
    found = branch_steps(steps)
    assert set(found) >= {"ref_store", "tdir_veto", "commit", "keyframe",
                          "capacity", "loop_apply", "loop_cooldown"}, found
    assert steps[-1]["summary"][:, 0].tolist() == [jmc.MODE_TRACKING] * 2


def test_slam_step_free_run_matches_jax(jax_run):
    """The port from a fresh state through both lanes' commits and first
    keyframes, with the JAX draws: summaries every step."""
    jl, steps = jax_run
    mesh = tmesh.make_mesh(1, devices=["cpu"])
    step = tmc.multicam_slam_step(jl.cfg_t, mesh, loop_closing=True)
    state = tmc.init_multicam(jl.cfg_t, N_LANES, device="cpu")
    for st in steps[:FREE_STEPS]:
        state_np = tmc.multicam_state_to_numpy(state)
        state, summary = step(state, st["imgs"], st["tss"],
                              draws=jl.draws(st["keys"], state_np,
                                             st["imgs"], st["tss"]))
        assert_summary_close(summary.numpy(), st["summary"])
    assert (summary[:, 0] == jmc.MODE_TRACKING).all()
    assert (summary[:, 8] >= 3).all()


@pytest.mark.parametrize("branch", ["ref_store", "tdir_veto", "commit",
                                    "keyframe", "capacity", "loop_apply",
                                    "loop_cooldown"])
def test_slam_step_from_carried_state(jax_run, branch):
    jl, steps = jax_run
    s, lane = branch_steps(steps)[branch]
    st = steps[s]
    got, summary = port_step(jl, st["before"], st["imgs"], st["tss"],
                             st["keys"])
    assert_summary_close(summary, st["summary"])
    assert_state_close(got, st["after"])


def _poisoned(jl, steps, kind):
    """(state before, imgs, tss, keys) of one step from a carried state
    altered into a branch the scene does not take by itself."""
    s = {"collapse": 9, "lost_prior": 12, "lane_reset": 5}[kind]
    st = steps[s]
    d = copy_state(st["before"])
    imgs, tss = st["imgs"], st["tss"]
    if kind == "collapse":
        # A young map whose streamed motion runs 50x slower than its
        # init baseline: the armed probe evaluates and resets lane 0.
        twc = -np.einsum("ji,j->i", d["R"][0], d["t"][0])
        d["probe_armed"][0] = True
        d["probe_t0"][0] = tss[0] - 0.25
        d["probe_pos0"][0] = twc
        d["init_v"][0] = 50.0
        d["init_commit_ts"][0] = tss[0] - 0.3
    elif kind == "lost_prior":
        d["mode"][0] = jmc.MODE_LOST
        d["lost_frames"][0] = 1
    else:
        d["mode"][0] = jmc.MODE_LOST
        d["lost_frames"][0] = 11
        imgs, tss = lane_images(s, blank=(0,))
    return d, imgs, tss, st["keys"]


@pytest.mark.parametrize("kind", ["collapse", "lost_prior", "lane_reset"])
def test_slam_step_from_poisoned_state(jax_run, kind):
    jl, steps = jax_run
    d, imgs, tss, keys = _poisoned(jl, steps, kind)
    ref, ref_summary = jl.run_step(d, imgs, tss, keys)
    got, summary = port_step(jl, d, imgs, tss, keys)
    assert_summary_close(summary, ref_summary)
    assert_state_close(got, ref)
    if kind == "lost_prior":
        assert ref["mode"][0] == jmc.MODE_TRACKING
    else:
        assert ref["mode"][0] == jmc.MODE_NO_REF
        assert ref["maps"]["n_kf"][0] == 0
    if kind == "collapse":
        assert ref["collapse_resets"][0] == 1


def _ring_merge_both(jl, maps_np, seed):
    """The ring merge of ``maps_np`` in both packages with the same
    draws: (JAX maps, ok, n_imported), (port maps, ok, n_imported)."""
    from send_slam_tpu.parallel.map_merge import multicam_merge_step
    from send_slam_tpu_torch.models.map_state import (
        map_from_numpy, map_to_numpy,
    )
    from send_slam_tpu_torch.parallel.map_merge import (
        multicam_merge_step as t_merge_step,
    )
    keys = jax.random.split(jax.random.PRNGKey(seed), N_LANES)
    jm, jok, jn = multicam_merge_step(jl.cfg_j, jl.mesh)(
        JMap(**{k: jnp.asarray(v) for k, v in maps_np.items()}), keys)
    ML = maps_np["lm_pos"].shape[1]
    noises = torch.from_numpy(np.stack([np.array(jax.random.gumbel(
        k, (N_HYP, ML))) for k in keys]))
    tm, tok, tn = t_merge_step(jl.cfg_t, tmesh.make_mesh(
        1, devices=["cpu"]))(map_from_numpy(maps_np, device="cpu"), noises)
    return (({k: np.asarray(v) for k, v in jm._asdict().items()},
             np.asarray(jok), np.asarray(jn)),
            (map_to_numpy(tm), tok.numpy(), tn.numpy()))


def test_ring_merge_of_the_lanes_matches_jax(jax_run):
    jl, steps = jax_run
    (jm, jok, jn), (tm, tok, tn) = _ring_merge_both(
        jl, steps[-1]["after"]["maps"], seed=5)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tn, jn)
    assert tok.all() and (tn >= 5).all(), tn
    for k, v in jm.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(tm[k], v, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(tm[k], v, err_msg=k)


def test_merge_imports_survive_the_capacity_step(jax_run):
    """Merged into the maps before the run's first capacity step (a
    keyframe, the forced cull, the compaction), the imports (ref_kf =
    -1, no observations) survive that step in both packages, and the
    step matches the JAX package's."""
    jl, steps = jax_run
    s, lane = branch_steps(steps)["capacity"]
    st = steps[s]
    d = copy_state(st["before"])
    _, (merged, ok, n_imp) = _ring_merge_both(jl, d["maps"], seed=6)
    assert ok[lane] and n_imp[lane] > 0
    d["maps"] = merged
    ref, ref_summary = jl.run_step(d, st["imgs"], st["tss"], st["keys"])
    got, summary = port_step(jl, d, st["imgs"], st["tss"], st["keys"])
    assert_summary_close(summary, ref_summary)
    assert_state_close(got, ref)
    assert ref["kf_total"][lane] == d["kf_total"][lane] + 1
    assert ref["maps"]["n_kf"][lane] <= d["maps"]["n_kf"][lane]
    imported = merged["lm_valid"][lane] & (merged["lm_ref_kf"][lane] < 0)
    assert imported.sum() == n_imp[lane]
    # The zero-observation prune, the forced cull's re-anchoring and the
    # compaction keep every import; in the step the new keyframe's twin
    # fusion absorbs some (14% here, the same rows in both packages):
    # an import that projects onto a keypoint bound to another landmark
    # is folded into that older row.
    from send_slam_tpu_torch.models.covisibility import (
        compact_keyframes, cull_redundant_keyframes,
    )
    from send_slam_tpu_torch.models.map_state import (
        map_from_numpy, prune_zero_obs_landmarks,
    )
    from send_slam_tpu_torch.parallel.multicam import lane_map
    m = lane_map(map_from_numpy(merged, device="cpu"), lane)
    m = prune_zero_obs_landmarks(m)
    m, n_cull = cull_redundant_keyframes(m, redundancy_th=0.0,
                                         keep_latest=3, max_cull=1)
    m, _ = compact_keyframes(m)
    assert int(n_cull) == 1
    assert m.lm_valid.numpy()[imported].all()
    assert (m.lm_ref_kf.numpy()[imported] == -1).all()
    kept = got["maps"]["lm_valid"][lane][imported]
    np.testing.assert_array_equal(
        kept, ref["maps"]["lm_valid"][lane][imported])
    assert kept.mean() >= 0.8, kept.mean()
    assert (got["maps"]["lm_ref_kf"][lane][imported][kept] == -1).all()


def test_two_entry_mesh_moves_each_lane_and_brings_it_home(jax_run,
                                                          monkeypatch):
    """The block moves of a two-entry mesh (ROADMAP C.3), on the CPU:
    the entries are two distinct device objects, and a spy on the move
    helper records which entry each move targets. From a carried state
    whose lanes are in different modes, lane 1's every lane and map field
    moves to entry 1 and nowhere else, every result comes back to entry
    0 (the state's own device), and the step and the ring merge equal a
    one-entry mesh's bit for bit."""
    from send_slam_tpu_torch.parallel.map_merge import (
        merge_noise, multicam_merge_step,
    )
    jl, steps = jax_run
    st = next(x for x in steps if len(set(x["before"]["mode"])) > 1)
    draws = jl.draws(st["keys"], st["before"], st["imgs"], st["tss"])
    two = tmesh.make_mesh(2, devices=["cpu", "cpu"])
    devs = two.flat_devices()
    assert devs[0] is not devs[1] and len(two.lane_blocks(N_LANES)) == 2
    calls = []
    real = tmc._to

    def spy(x, device):
        calls.append(next((i for i, d in enumerate(devs) if d is device),
                          None))
        return real(x, device)

    monkeypatch.setattr(tmc, "_to", spy)
    out = {}
    for name, mesh in (("one", tmesh.make_mesh(1, devices=["cpu"])),
                       ("two", two)):
        calls.clear()
        step = tmc.multicam_slam_step(jl.cfg_t, mesh,
                                      loop_closing=jl.loop_closing)
        state = tmc.multicam_state_from_numpy(st["before"], device="cpu")
        new, summary = step(state, st["imgs"], st["tss"], draws=draws)
        step_calls = list(calls)
        calls.clear()
        merged, ok, n_imp = multicam_merge_step(jl.cfg_t, mesh)(
            new.maps, merge_noise(N_LANES, jl.cfg_t.map.max_landmarks,
                                  seed=2))
        out[name] = (tmc.multicam_state_to_numpy(new), summary.numpy(),
                     {f: getattr(merged, f).numpy()
                      for f in tmc._MAP_FIELDS},
                     ok.numpy(), n_imp.numpy(), step_calls, list(calls))
    n_lane, n_map = len(tmc._LANE_FIELDS), len(tmc._MAP_FIELDS)
    step_calls, merge_calls = out["two"][5], out["two"][6]
    # The step: lane 0's fields to entry 0, lane 1's to entry 1, then
    # every stacked result (maps, lane fields, summary rows) to entry 0.
    assert step_calls == [0] * (n_lane + n_map) + [1] * (n_lane + n_map) \
        + [0] * (N_LANES * (n_map + n_lane) + N_LANES)
    # The merge: each lane's map to its entry, the merged maps home.
    assert merge_calls == [0] * n_map + [1] * n_map + [0] * N_LANES * n_map
    (sa, ra, ma, oka, na, _, _), (sb, rb, mb, okb, nb, _, _) = \
        out["one"], out["two"]
    np.testing.assert_array_equal(ra, rb)
    for f in sa:
        if f == "maps":
            for k in sa["maps"]:
                np.testing.assert_array_equal(sa["maps"][k], sb["maps"][k])
        else:
            np.testing.assert_array_equal(sa[f], sb[f])
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k])
    np.testing.assert_array_equal(oka, okb)
    np.testing.assert_array_equal(na, nb)


def test_state_round_trip(jax_run):
    _, steps = jax_run
    d = steps[-1]["after"]
    got = tmc.multicam_state_to_numpy(
        tmc.multicam_state_from_numpy(d, device="cpu"))
    for f in tmc.MultiCamState._fields:
        if f == "rng":
            continue
        if f == "maps":
            for k, v in d["maps"].items():
                np.testing.assert_array_equal(got["maps"][k], v)
                assert got["maps"][k].dtype == v.dtype
        else:
            np.testing.assert_array_equal(got[f], d[f])
            assert got[f].dtype == d[f].dtype, f


def test_same_seed_replays_and_seeds_differ():
    """The lanes' own generators: a same-seed rerun is bit-equal, the
    lanes draw differently, and init_multicam resets them."""
    cfg = lanes_cfg(tc)
    mesh = tmesh.make_mesh(1, devices=["cpu"])
    step = tmc.multicam_slam_step(cfg, mesh)
    runs = []
    for _ in range(2):
        state = tmc.init_multicam(cfg, N_LANES, device="cpu", seed=3)
        for s in range(4):
            state, summary = step(state, *lane_images(s))
        runs.append((tmc.multicam_state_to_numpy(state), summary.numpy(),
                     state.rng))
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    for k, v in runs[0][0]["maps"].items():
        np.testing.assert_array_equal(v, runs[1][0]["maps"][k])
    assert not torch.equal(runs[0][2][0], runs[0][2][1])
    fresh = tmc.init_multicam(cfg, N_LANES, device="cpu", seed=3)
    assert not torch.equal(fresh.rng, runs[0][2])
    assert torch.equal(fresh.rng[1], tmc.lane_generator(3, 1).get_state())


# ---------------------------------------------------------------------------
# Whole sessions of the port alone: tests/test_parallel.py's slow twins


def _session_cfg_of(C, **tr):
    """tests/test_parallel.py's 160x120 session configuration in package
    ``C`` (``mk`` / ``ml``: the table sizes; the rest tracking options)."""
    return C.EngineConfig(
        orb=C.OrbConfig(n_features=256, n_levels=3),
        camera=C.CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                              cx=80.0, cy=60.0),
        map=C.MapConfig(max_keyframes=tr.pop("mk", 8),
                        max_landmarks=tr.pop("ml", 1024), ba_window=4),
        tracking=C.TrackingConfig(init_min_matches=30, **tr))


def _session_cfg(**tr):
    return _session_cfg_of(tc, **tr)


def _run_session(cfg, centers, n_steps, dt, loop_closing=False, n=8,
                 record=False):
    mesh = tmesh.make_mesh(1, devices=["cpu"])
    step = tmc.multicam_slam_step(cfg, mesh, loop_closing=loop_closing)
    state = tmc.init_multicam(cfg, n, device="cpu")
    hist = []
    for s in range(n_steps):
        imgs = np.stack([WORLD.render(np.eye(3), -centers(c, s))
                         for c in range(n)]).astype(np.float32)
        state, summary = step(state, imgs, np.full(n, s * dt, np.float32))
        if record:
            hist.append(summary.numpy())
    return state, summary.numpy(), hist


@pytest.mark.slow
def test_eight_lanes_initialize_and_map():
    cfg = _session_cfg(kf_max_interval=3)
    _, summary, _ = _run_session(
        cfg, lambda c, s: np.array([0.35 * c - 1.2 + 0.12 * s, 0.0, 0.0]),
        10, 1 / 30.0)
    assert (summary[:, 0] == tmc.MODE_TRACKING).all(), summary
    assert (summary[:, 2] >= 2).all() and (summary[:, 3] > 30).all()


@pytest.mark.slow
def test_long_multilane_accuracy_past_capacity():
    """tests/test_parallel.py's long session (8 lanes, 60 steps out and
    back, several times the 8-slot keyframe table) in both packages, the
    JAX draws injected into the port: the final modes, kf_total and
    table sizes equal and each lane's Sim(3)-aligned ATE within 1 cm of
    the JAX package's. The reference's own bars are not all met by the
    reference (lanes 5 and 6 end re-initialising, ROADMAP C.3); those it
    meets hold here: live tables within capacity, and every lane that
    tracked half the session lands under 0.25 m."""
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    n, n_steps = 8, 60
    jl = JaxLanes(lambda C: _session_cfg_of(C, kf_min_interval=1,
                                            kf_max_interval=2),
                  loop_closing=False)
    tstep = tmc.multicam_slam_step(jl.cfg_t,
                                   tmesh.make_mesh(1, devices=["cpu"]))

    def centre(c, s):
        a = s / (n_steps - 1)
        return np.array([0.3 * c - 1.2 + 1.4 * (1 - abs(2 * a - 1)), 0, 0])

    js = jax_to_numpy(jmc.init_multicam(jl.cfg_j, n))
    ts = tmc.init_multicam(jl.cfg_t, n, device="cpu")
    key = jax.random.PRNGKey(7)
    hist = {"jax": [], "port": []}
    for s in range(n_steps):
        imgs = np.stack([WORLD.render(np.eye(3), -centre(c, s))
                         for c in range(n)]).astype(np.float32)
        tss = np.full(n, float(s), np.float32)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, n)
        draws = jl.draws(keys, js, imgs, tss)
        js, jsum = jl.run_step(js, imgs, tss, keys)
        ts, tsum = tstep(ts, imgs, tss, draws=draws)
        hist["jax"].append(jsum)
        hist["port"].append(tsum.numpy())
    ref, got = hist["jax"][-1], hist["port"][-1]
    np.testing.assert_array_equal(got[:, [0, 2, 8]], ref[:, [0, 2, 8]])
    assert (ts.maps.n_kf.numpy() <= 8).all()
    gts = np.arange(n_steps, dtype=float)
    for c in range(n):
        ates = {}
        for name, h in hist.items():
            ok = [s for s in range(n_steps) if h[s][c, 0] == tmc.MODE_TRACKING]
            ates[name] = (len(ok), float("inf") if len(ok) < 3 else ate_rmse(
                np.asarray(ok, float), np.stack([h[s][c, 4:7] for s in ok]),
                gts, np.stack([centre(c, s) for s in range(n_steps)])))
        assert ates["port"][0] == ates["jax"][0], (c, ates)
        if np.isfinite(ates["jax"][1]):
            assert abs(ates["port"][1] - ates["jax"][1]) < 0.01, (c, ates)
        else:       # fewer than 3 tracked steps in both
            assert not np.isfinite(ates["port"][1]), (c, ates)
        if ates["port"][0] >= n_steps // 2:
            assert ates["port"][1] < 0.25, (c, ates)


@pytest.mark.slow
def test_per_lane_loop_closing():
    cfg = _session_cfg(mk=24, ml=2048, kf_min_interval=1, kf_max_interval=2,
                       loop_min_gap_kf=6, loop_cooldown_kf=6,
                       loop_score_min=0.2)
    n_steps = 40

    def centers(c, s):
        a = s / (n_steps - 1)
        return np.array([0.3 * c - 1.2 + 1.2 * (1 - abs(2 * a - 1)), 0, 0])

    _, summary, _ = _run_session(cfg, centers, n_steps, 1 / 30.0,
                                 loop_closing=True)
    assert (summary[:, 0] == tmc.MODE_TRACKING).sum() >= 7, summary
    assert summary[:, 9].max() >= 1, summary


@pytest.mark.slow
def test_tdir_gate_defers_then_commits():
    cfg = _session_cfg(kf_max_interval=3)
    state, summary, hist = _run_session(
        cfg, lambda c, s: np.array([0.35 * c - 1.2 + 0.12 * s, 0.0, 0.0]),
        12, 1 / 30.0, record=True)
    assert (summary[:, 0] == tmc.MODE_TRACKING).all(), summary
    assert (hist[1][:, 0] != tmc.MODE_TRACKING).all()
    assert (state.init_rejects.numpy()
            <= cfg.tracking.init_tdir_max_rejects).all()


@pytest.mark.slow
def test_collapse_probe_resets_rotten_young_map():
    cfg = _session_cfg(kf_max_interval=3)
    n = 8
    mesh = tmesh.make_mesh(1, devices=["cpu"])
    step = tmc.multicam_slam_step(cfg, mesh)

    def images(s):
        return (np.stack([WORLD.render(np.eye(3), -np.array(
            [0.35 * c - 1.2 + 0.12 * s, 0.0, 0.0])) for c in range(n)])
            .astype(np.float32), np.full(n, s / 30.0, np.float32))

    state = tmc.init_multicam(cfg, n, device="cpu")
    for s in range(8):
        state, summary = step(state, *images(s))
    assert (summary[:, 0] == tmc.MODE_TRACKING).all()
    kf_before = state.maps.n_kf.clone()
    poison = torch.arange(n) % 2 == 0
    state = state._replace(
        init_v=torch.where(poison, torch.tensor(50.0), state.init_v),
        init_commit_ts=torch.full((n,), 7.0 / 30.0),
        probe_t0=torch.full((n,), -1.0), probe_armed=poison,
        collapse_resets=torch.zeros(n, dtype=torch.int32))
    saw_reset = torch.zeros(n, dtype=torch.bool)
    for s in range(8, 28):
        state, summary = step(state, *images(s))
        saw_reset |= summary[:, 0] != tmc.MODE_TRACKING
    resets = state.collapse_resets
    assert (resets[poison] >= 1).all() or saw_reset[poison].all()
    assert not saw_reset[~poison].any()
    assert (state.maps.n_kf[~poison] >= kf_before[~poison]).all()
    assert (summary[:, 0] == tmc.MODE_TRACKING).all(), summary


@pytest.mark.slow
def test_post_merge_landmarks_consistent_in_every_lane():
    """tests/test_parallel.py's merge-consistency session on the port: 8
    lanes, 14 steps, the ring merge, 4 more steps on the merged maps;
    that test's bars on the merge, the lanes' trajectories, the imports'
    in-view fraction and the structure tail. Its bar on the median of the
    lanes' structure medians (0.6 m) is left out: the JAX package misses
    it on this scene itself (0.606 m, its lanes 1.19 / 0.61 / 7.53 / 0.56
    / 0.59 / 0.80 / 0.55 m, the JAX test on the CPU)."""
    from scipy.spatial import cKDTree
    from send_slam_tpu_torch.io.evaluate import umeyama_alignment
    from send_slam_tpu_torch.parallel.map_merge import (
        merge_noise, multicam_merge_step,
    )
    n, n_steps = 8, 14
    cfg = _session_cfg(kf_max_interval=3)
    mesh = tmesh.make_mesh(1, devices=["cpu"])
    step = tmc.multicam_slam_step(cfg, mesh)

    def centre(lane, s):
        return np.array([0.35 * lane - 1.2 + 0.12 * s,
                         0.05 * np.sin(0.7 * s), 0.05 * s])

    def images(s):
        return (np.stack([WORLD.render(np.eye(3), -centre(c, s))
                          for c in range(n)]).astype(np.float32),
                np.full(n, s / 30.0, np.float32))

    state = tmc.init_multicam(cfg, n, device="cpu", seed=11)
    est = [[] for _ in range(n)]
    for s in range(n_steps):
        state, summary = step(state, *images(s))
        for c in range(n):
            if int(summary[c, 0]) == tmc.MODE_TRACKING:
                est[c].append((s, summary[c, 4:7].numpy().copy()))
    assert (summary[:, 0] == tmc.MODE_TRACKING).all(), summary

    pre_valid = state.maps.lm_valid.numpy().copy()
    maps2, ok, n_imp = multicam_merge_step(cfg, mesh)(
        state.maps, merge_noise(n, cfg.map.max_landmarks, seed=11))
    ok, n_imp = ok.numpy(), n_imp.numpy()
    assert ok.sum() >= n - 1, (ok, n_imp)
    assert (n_imp[ok] >= 5).all(), n_imp

    tree = cKDTree(WORLD.points)
    lm_pos, lm_valid = maps2.lm_pos.numpy(), maps2.lm_valid.numpy()
    meds, fracs, ates = [], [], []
    for c in range(n):
        e = np.stack([p for _, p in est[c]])
        g = np.stack([centre(c, s) for s, _ in est[c]])
        s_l, R_l, t_l = umeyama_alignment(e, g, with_scale=True)
        resid = (s_l * (R_l @ e.T)).T + t_l - g
        ates.append(float(np.sqrt(np.mean(np.sum(resid ** 2, -1)))))
        imported = lm_valid[c] & ~pre_valid[c]
        if not ok[c] or not imported.any():
            continue
        world = (s_l * (R_l @ lm_pos[c][imported].T)).T + t_l
        meds.append(float(np.median(tree.query(world)[0])))
        pc = lm_pos[c][imported] @ state.R[c].numpy().T + state.t[c].numpy()
        z = pc[:, 2]
        u = 130.0 * pc[:, 0] / np.maximum(z, 1e-6) + 80.0
        v = 130.0 * pc[:, 1] / np.maximum(z, 1e-6) + 60.0
        fracs.append(float(((z > 0.1) & (u >= -40) & (u < 200) & (v >= -30)
                            & (v < 150)).mean()))
    assert len(meds) >= n - 1
    assert sum(m_ < 1.5 for m_ in meds) >= len(meds) - 3, meds
    assert float(np.median(fracs)) > 0.25, fracs
    assert float(np.median(ates)) < 0.08, ates
    assert max(ates) < 0.25, ates

    state = state._replace(maps=maps2)
    for s in range(n_steps, n_steps + 4):
        state, summary = step(state, *images(s))
    assert (summary[:, 0] == tmc.MODE_TRACKING).all(), summary
