"""chip_smoke.py's main path, its loop session, its long session or its
atlas scene on the CPU, in either package.

    JAX_PLATFORMS=cpu python scripts/cpu_reference_run.py --package jax
    python scripts/cpu_reference_run.py --package torch
    python scripts/cpu_reference_run.py --package torch --scene laps \
        --frames 260
    python scripts/cpu_reference_run.py --package torch --scene long
    JAX_PLATFORMS=cpu python scripts/cpu_reference_run.py --package jax \
        --scene atlas
    JAX_PLATFORMS=cpu python scripts/cpu_reference_run.py --package jax \
        --scale 1.3
    JAX_PLATFORMS=cpu python scripts/cpu_reference_run.py --package jax \
        --scene lanes --seed 2

Runs ``System.track_monocular`` at chip_smoke.py's configuration
(640x480, 1250 features, 8 levels, 256 keyframes, 16384 landmarks, BA
window 8, the JAX package's default options, loop closing on) over the
synthetic bench scene (seed 11): ``--scene bench`` is the main path's
90-frame arc, ``--scene laps`` the long bench's revisit trajectory
(``trajectory_laps`` over 1000 frames and 6 laps), of which the first
``--frames`` frames run, with the ORB pyramid at ``--scale`` (1.2 by
default; chip_smoke.py's scale_path runs 1.3). Poses are counted as
bench.py counts them
(live OK outputs, backfill triples, the final drain). Prints one JSON
line: tracked, live, backfilled, unique timestamps, the streamed ATE,
keyframes, the init commit time and every failed collapse probe (commit
time, probe time, velocity ratio); with loop closing, every loop attempt
with the frame that recorded it, the frame of the first applied closure
and the keyframe ATE just before it and at the end.

``--scene long`` is chip_smoke.py's long_session (tests/
test_covisibility.py's 140-frame arc at 640x480, the flagship ORB and
landmark table, a 10-keyframe table, BA window 4 and that test's
tracking overrides) and ``--scene atlas`` its atlas_path (tests/
test_atlas.py's 210-frame occlusion scene at 640x480, the flagship ORB
and map, that test's overrides); both take their frame count from the
scene, and add the compactions and forced culls, each freeze and weld
with its frame, every cross-map Sim(3) verification (frame, verdict,
matches, inliers), and the frames OK (tracking state 2) among the last
10.

``--scene lanes`` is chip_smoke.py's lanes_path: two lanes of
``multicam_slam_step`` at that configuration with loop closing on, lane
0 on the bench arc's path at twice its pace and lane 1 on the same path
shifted 0.35 m along +x, one ring merge after step 70 and 10 more
steps. It prints each lane's
commit step, the steps at which it fell out of tracking (resets),
tracked share after the commit, kf_total, keyframes, landmarks, loops,
Sim(3)-aligned ATE, and the merge's verdicts, imports and the imports'
median distance to the true structure through the lane's gauge. The
JAX package draws from jax.random keys (PRNGKey(``--seed``), split per
step as tests/test_parallel.py does) and merges lane by lane
(``merge_from_partner`` jitted once, to bound its memory); the port
from its lanes' generators (``init_multicam(seed=--seed)``) and
chip_smoke.py's merge draws, as on the card (scripts/lanes_seeds.py
runs the port's seeds there). Several minutes; the JAX merge at 16384 landmarks holds a
few GB.

The port draws its RANSAC samples from a CPU generator on every device,
so ``--package torch`` here takes the same draws as the port's run on
the card; ``--package jax`` is the reference at the same configuration.
The main path takes one to two minutes; the loop session at 260 frames
several.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--scene", choices=("bench", "laps", "long", "atlas",
                                        "lanes"),
                    default="bench")
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--seed", type=int, default=0,
                    help="--scene lanes: the lanes' draws (the JAX "
                         "package's PRNGKey, the port's init_multicam seed)")
    ap.add_argument("--scale", type=float, default=1.2,
                    help="the ORB pyramid's scale factor")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.scene == "lanes":
        return lanes(args.package, args.seed)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from send_slam_tpu import config as C
        from send_slam_tpu.models import system as S
        make = (lambda cfg: S.System(cfg))
    else:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
        from send_slam_tpu_torch import config as C
        from send_slam_tpu_torch.models import system as S
        make = (lambda cfg: S.System(cfg, device="cpu"))
    import chip_smoke
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.utils.synth import SyntheticWorld

    cam = C.CameraConfig(width=640, height=480, fx=520.0, fy=520.0,
                         cx=320.0, cy=240.0)
    cfg = C.EngineConfig(camera=cam,
                         orb=C.OrbConfig(scale_factor=args.scale))
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    poses = None
    if args.scene == "laps":
        ts, Rs, tls = world.trajectory_laps(n_frames=1000, laps=6)
        ts, Rs, tls = ts[:args.frames], Rs[:args.frames], tls[:args.frames]
    elif args.scene == "long":
        cfg = C.EngineConfig(
            camera=cam, map=C.MapConfig(max_keyframes=chip_smoke.LONG_MK,
                                        max_landmarks=16384, ba_window=4),
            tracking=C.TrackingConfig(init_min_matches=50, kf_max_interval=6,
                                      pipeline_depth=1, pipeline_stretch=1))
        world = SyntheticWorld(n_points=900, width=640, height=480,
                               fx=520.0, fy=520.0)
        poses = chip_smoke._arc_poses(chip_smoke.LONG_FRAMES)
    elif args.scene == "atlas":
        cfg = C.EngineConfig(camera=cam, tracking=C.TrackingConfig(
            pipeline_stretch=1, init_min_matches=40, kf_max_interval=5,
            atlas_reloc_patience=8, atlas_min_kf=5))
        world = chip_smoke._atlas_world()
        poses = chip_smoke.atlas_poses()
    else:
        ts, Rs, tls = world.trajectory(n_frames=args.frames)
    if poses is not None:
        args.frames = len(poses)
        ts = np.arange(len(poses)) / 30.0
        Rs = [p[0] if p else None for p in poses]
        tls = [p[1] if p else None for p in poses]
    seen = [k for k in range(args.frames) if Rs[k] is not None]
    gt_ts = np.asarray(ts)[seen]
    gt = np.asarray([-Rs[k].T @ tls[k] for k in seen])
    s = make(cfg)
    probes = []
    retry = S.System._collapse_retry

    def spy(self, ts_rel):
        trc = self._collapse_trace
        span = trc[-1][0] - trc[0][0]
        v = float(np.linalg.norm(trc[-1][1] - trc[0][1])) / span
        probes.append((self.init_commit_ts, ts_rel, v / self._init_v))
        return retry(self, ts_rel)

    S.System._collapse_retry = spy

    def kf_ate():
        kts, kpos, _ = s.keyframe_poses()
        return (ate_rmse(np.asarray(kts), np.asarray(kpos), gt_ts, gt)
                if len(kts) >= 3 else float("inf"))

    frame, applies = [0], []
    apply = s._loop_apply

    def spy_apply(*a):
        applies.append(dict(frame=frame[0], kf_ate_before=kf_ate()))
        return apply(*a)

    s._loop_apply = spy_apply
    events = dict(compact_steps=0, forced_culls=0, freezes=[], welds=[])

    def count_calls(name, key):
        fn = getattr(s, name)

        def call(*a):
            out = fn(*a)
            if isinstance(events[key], list):
                events[key].append(frame[0])
            else:
                events[key] += 1
            return out
        setattr(s, name, call)

    verifications = []
    sim3 = s._atlas_sim3

    def spy_sim3(*a):
        out = sim3(*a)
        verifications.append((frame[0], out))
        return out

    s._atlas_sim3 = spy_sim3
    for name, key in (("_compact_step", "compact_steps"),
                      ("_forced_cull_step", "forced_culls"),
                      ("_freeze_to_atlas", "freezes"),
                      ("_atlas_weld", "welds")):
        count_calls(name, key)
    states = []
    live = backfilled = 0
    est, attempts = [], []
    t0 = time.perf_counter()

    def take(out):
        nonlocal live, backfilled
        if out.tracking_state == 2:
            live += 1
            est.append((out.timestamp, out.position))
        backfilled += len(out.backfill)
        est.extend((b[0], b[1]) for b in out.backfill)

    for k in range(args.frames):
        frame[0] = k
        img = (np.zeros((world.H, world.W), np.uint8) if Rs[k] is None else
               np.round(world.render(Rs[k], tls[k])).astype(np.uint8))
        out = s.track_monocular(img, float(ts[k]))
        states.append(out.tracking_state)
        take(out)
        while len(attempts) < len(s.loop_attempts):
            att = s.loop_attempts[len(attempts)]
            attempts.append(dict(frame=k, attempt=list(att)))
    for out in s._flush_pipeline(final=True):
        take(out)
    est.sort(key=lambda e: e[0])
    ate = ate_rmse([e[0] for e in est], np.asarray([e[1] for e in est]),
                   gt_ts, gt) if len(est) >= 3 else float("inf")
    applied = [a for a in attempts if a["attempt"][3] is True]
    print(json.dumps(dict(
        package=args.package, scene=args.scene, frames=args.frames,
        scale=args.scale,
        tracked=len(est), tracked_live=live, backfilled=backfilled,
        tracked_unique=len({e[0] for e in est}), ate_m=ate,
        keyframes=int(s._n_kf_host), init_commit_ts=s.init_commit_ts,
        failed_collapse_probes=probes, loop_attempts=attempts,
        loops_closed=s.loops_closed, applies=applies,
        first_applied_verdict_frame=applied[0]["frame"] if applied else None,
        kf_ate_end_m=kf_ate(),
        ok_frames=sum(st == 2 for st in states),
        ok_last_10=sum(st == 2 for st in states[-10:]),
        compactions=events["compact_steps"] - events["forced_culls"],
        forced_culls=events["forced_culls"], freeze_frames=events["freezes"],
        weld_frames=events["welds"],
        weld_verifications=[
            dict(frame=k, ok=bool(r.ok), n_matches=int(r.n_matches),
                 n_inliers=int(r.sim3.n_inliers)) for k, r in verifications],
        welds_done=s.welds_done, atlas_left=len(s.atlas),
        seconds=time.perf_counter() - t0)), flush=True)
    return 0


def lanes(package: str, seed: int) -> int:
    """chip_smoke.py's lanes_path in ``package`` on the CPU, its draws
    from ``seed``."""
    import chip_smoke as cs
    world, ts, poses, centres = cs.lanes_scene()
    n_steps = cs.LANES_MERGE_AFTER + cs.LANES_AFTER

    def images(k):
        return (np.stack([np.round(world.render(*poses[c][k]))
                          .astype(np.uint8) for c in range(2)])
                .astype(np.float32),
                np.full(2, ts[k], np.float32))

    t0 = time.perf_counter()
    rows = []
    if package == "jax":
        import jax
        import jax.numpy as jnp
        jax.config.update("jax_platforms", "cpu")
        from send_slam_tpu import config as C
        from send_slam_tpu.parallel import (
            init_multicam, make_mesh, multicam_slam_step,
        )
        from send_slam_tpu.parallel.map_merge import merge_from_partner
        cfg = C.EngineConfig(camera=C.CameraConfig(
            width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0))
        step = multicam_slam_step(cfg, make_mesh(1, ("cam",)),
                                  loop_closing=True)
        merge_one = jax.jit(merge_from_partner, static_argnums=(5,))
        state = init_multicam(cfg, 2)
        key = jax.random.PRNGKey(seed)
        for k in range(n_steps):
            if k == cs.LANES_MERGE_AFTER:
                pre = {f: np.asarray(getattr(state.maps, f))
                       for f in ("lm_valid", "lm_pos")}
                key, sub = jax.random.split(key)
                outs = [merge_one(
                    jax.tree.map(lambda x: x[c], state.maps),
                    state.maps.lm_pos[1 - c], state.maps.lm_desc[1 - c],
                    state.maps.lm_valid[1 - c], kc, cfg.tracking)
                    for c, kc in enumerate(jax.random.split(sub, 2))]
                merged = jax.tree.map(lambda *x: jnp.stack(x),
                                      *[o[0] for o in outs])
                ok = [bool(o[1]) for o in outs]
                n_imp = [int(o[2]) for o in outs]
                state = state._replace(maps=merged)
            imgs, tss = images(k)
            key, sub = jax.random.split(key)
            state, summary = step(state, jnp.asarray(imgs), jnp.asarray(tss),
                                  jax.random.split(sub, 2))
            rows.append(np.asarray(summary))
        post = {f: np.asarray(getattr(merged, f))
                for f in ("lm_valid", "lm_pos")}
    else:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
        from send_slam_tpu_torch.parallel import (
            init_multicam, make_mesh, multicam_slam_step,
        )
        from send_slam_tpu_torch.parallel.map_merge import (
            merge_noise, multicam_merge_step,
        )
        cfg = cs.flagship_config()
        mesh = make_mesh(1, devices=["cpu"])
        step = multicam_slam_step(cfg, mesh, loop_closing=True)
        state = init_multicam(cfg, 2, device="cpu", seed=seed)
        for k in range(n_steps):
            if k == cs.LANES_MERGE_AFTER:
                pre = {f: getattr(state.maps, f).numpy()
                       for f in ("lm_valid", "lm_pos")}
                merged, ok_t, n_t = multicam_merge_step(cfg, mesh)(
                    state.maps, merge_noise(2, cfg.map.max_landmarks,
                                            seed=15))
                ok, n_imp = ok_t.tolist(), n_t.tolist()
                state = state._replace(maps=merged)
            state, summary = step(state, *images(k))
            rows.append(summary.numpy())
        post = {f: getattr(merged, f).numpy()
                for f in ("lm_valid", "lm_pos")}
    rows = np.asarray(rows)
    ates = cs.lane_ates(rows, ts, centres)
    out = []
    for c in range(2):
        tracked = rows[:, c, 0] == 2
        first = int(np.argmax(tracked)) if tracked.any() else None
        n_imported, med = cs.import_structure(
            pre["lm_valid"][c], post["lm_valid"][c], post["lm_pos"][c],
            ates[c][1], world.points)
        resets = [k for k in range(1, len(rows))
                  if rows[k - 1, c, 0] == 2 and rows[k, c, 0] != 2]
        out.append(dict(
            commit_step=first, reset_steps=resets,
            tracking_share_after_commit=(float(tracked[first:].mean())
                                         if first is not None else 0.0),
            kf_total=int(rows[-1, c, 8]), n_kf=int(rows[-1, c, 2]),
            landmarks=int(rows[-1, c, 3]), loops=int(rows[-1, c, 9]),
            final_mode=int(rows[-1, c, 0]), ate_m=ates[c][0],
            merge_ok=ok[c], imported=n_imp[c],
            import_median_to_structure_m=med))
    print(json.dumps(dict(package=package, scene="lanes", seed=seed,
                          steps=n_steps,
                          merge_after=cs.LANES_MERGE_AFTER, lanes=out,
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
