"""Where do the card and the CPU part in the lanes' commit bundle
adjustment? (ROADMAP C.1.)

    python scripts/ba_trace.py            # on a machine with a CUDA card

Runs chip_smoke.py's two flagship lanes (lanes_path's scene, seed 0) on
the card up to the first step in which a lane commits its init, and
keeps the input of that commit's bundle adjustment (``bootstrap_map``'s
``local_bundle_adjustment``: 10 iterations, one keyframe fixed). Then,
from that input, on the card and on the CPU:

1. the whole adjustment, its error per written field (kf_R, kf_t,
   lm_pos) card against CPU;
2. iteration by iteration from the CPU's chain (each iteration's input
   the CPU's output of the one before, on both devices): the error of
   each iteration's output, and inside the first iteration that differs
   what each stage of ``models/local_ba.py`` returns, in order
   (residuals and Jacobians, the block sums, the landmark block
   inverses, the Schur solve's steps, the cost): the first that differs
   is where the two devices part;
3. the reduced camera system's conditioning in float64 (singular
   values, and the share of the weakest direction that lies along the
   free keyframe's translation, the scale gauge that one fixed keyframe
   leaves free).

Prints one JSON line. Needs one card (exits 2 without one).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def move(m, dev):
    """A MapState with every field on ``dev``."""
    from send_slam_tpu_torch.models.map_state import MapState
    return MapState(**{f.name: getattr(m, f.name).to(dev)
                       for f in dataclasses.fields(MapState)})


def parallax_report(a, b):
    """The init's landmarks (maps ``a`` and ``b`` as numpy, keyframes 0
    and 1): each valid landmark's parallax between the two keyframes'
    centres and the difference of its position between the two maps;
    the worst landmark, and the median difference below and above 1
    degree of parallax."""
    valid = a["lm_valid"] & b["lm_valid"]
    X = a["lm_pos"][valid].astype(np.float64)
    centres = [-(a["kf_R"][i].T @ a["kf_t"][i]) for i in (0, 1)]
    r0, r1 = X - centres[0], X - centres[1]
    cos = (r0 * r1).sum(-1) / (np.linalg.norm(r0, axis=-1)
                               * np.linalg.norm(r1, axis=-1))
    par = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    err = np.abs(a["lm_pos"][valid] - b["lm_pos"][valid]).max(-1)
    w = int(np.argmax(err))
    low = par < 1.0
    return dict(
        landmarks=int(valid.sum()), worst_err=float(err[w]),
        worst_parallax_deg=float(par[w]),
        worst_depth=float(np.linalg.norm(r0[w])),
        median_err_below_1deg=(float(np.median(err[low])) if low.any()
                               else None),
        median_err_above_1deg=(float(np.median(err[~low])) if (~low).any()
                               else None),
        share_below_1deg=float(low.mean()))


def rel_err(a, b) -> float:
    a = a.detach().cpu().double()
    b = b.detach().cpu().double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


# The stages of one ``local_bundle_adjustment`` iteration, in order: each
# function of ``models/local_ba.py`` and the names of what it returns.
STAGES = {
    "_obs_terms": ("residual_u", "residual_v", "huber_weight", "jac_pose_u",
                   "jac_pose_v", "jac_point_u", "jac_point_v", "depth"),
    "_block_assembly": ("H_pp", "b_p", "lm_blocks", "H_pl"),
    "_lm_block_inverse": ("lm_block_inverse", "lm_rhs"),
    "_schur_solve": ("delta_pose", "delta_point"),
    "_robust_cost": ("cost_before",),
}


def iteration_terms(m, K, cfg_map, damping, n_fixed):
    """One iteration of ``local_bundle_adjustment`` (default window,
    damping ``damping``), with what each of its stages returns, in order:
    ``models/local_ba.py``'s own functions, wrapped for the call. Also
    the window's poses (``kf_t``) and the free-pose mask."""
    from send_slam_tpu_torch.models import local_ba as B
    out, meta = {}, {}
    real = {name: getattr(B, name) for name in STAGES}

    def wrap(name):
        def f(*a, **kw):
            r = real[name](*a, **kw)
            for key, v in zip(STAGES[name], r if isinstance(r, tuple)
                              else (r,)):
                out.setdefault(key, v)
            if name == "_obs_terms":
                meta.setdefault("kf_t", a[1])
            if name == "_schur_solve":
                meta.setdefault("pose_free", a[6])
            return r
        return f

    for name in STAGES:
        setattr(B, name, wrap(name))
    try:
        B.local_bundle_adjustment(m, K, cfg_map, iters=1, damping=damping,
                                  n_fixed=n_fixed, prune=False)
    finally:
        for name, f in real.items():
            setattr(B, name, f)
    return out, meta


def reduced_system(m, K, cfg_map, damping, n_fixed):
    """The damped reduced camera system (6W, 6W) of the first iteration,
    in float64 on the CPU, as ``_schur_solve`` builds it."""
    import torch
    from send_slam_tpu_torch.models import local_ba as B
    captured = {}
    solve = torch.linalg.solve_ex

    def spy(A, b, *a, **kw):
        captured["A"] = A.detach().cpu().double()
        return solve(A, b, *a, **kw)

    torch.linalg.solve_ex = spy
    try:
        B.local_bundle_adjustment(m, K, cfg_map, iters=1, damping=damping,
                                  n_fixed=n_fixed, prune=False)
    finally:
        torch.linalg.solve_ex = solve
    return captured["A"]


def system_keyframe(torch, cs):
    """The main path's first keyframe insertion past the bootstrap (the
    System's, as chip_smoke.py's step_parity keeps it), split: the
    insertion alone card vs CPU from the kept input, then the local BA
    that follows it card vs CPU from the CPU's inserted map."""
    from send_slam_tpu_torch.models.covisibility import covis_window_ids
    from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
    from send_slam_tpu_torch.models.local_mapping import (
        insert_keyframe_with_triangulation,
    )
    from send_slam_tpu_torch.models.map_state import (
        map_from_numpy, map_to_numpy,
    )
    from send_slam_tpu_torch.models.system import System
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    cfg = cs.flagship_config()
    tr = cfg.tracking
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=cs.N_FRAMES)
    s = System(cfg, device="cuda")
    with cs.keep_ba_inputs(torch, s) as kept:
        for k in range(cs.N_FRAMES):
            s.track_monocular(np.round(world.render(Rs[k], tls[k]))
                              .astype(np.uint8), float(ts[k]))
            if "keyframe" in kept:
                break
    m_np, args, kw = kept["keyframe"]
    K = torch.tensor([[cfg.camera.fx, 0.0, cfg.camera.cx],
                      [0.0, cfg.camera.fy, cfg.camera.cy],
                      [0.0, 0.0, 1.0]], dtype=torch.float32)
    inserted = {}
    for dev in ("cuda", "cpu"):
        a = cs._tree_to(torch, args, dev)
        a = (*a[:5], K.to(dev), *a[6:])
        m, _, n_new = insert_keyframe_with_triangulation(
            map_from_numpy(m_np, device=dev), *a,
            **{k2: cs._tree_to(torch, v, dev) for k2, v in kw.items()})
        inserted[dev] = (map_to_numpy(m), int(n_new))
    ins_diff = cs._diff_fields(inserted["cuda"][0], inserted["cpu"][0])
    base = inserted["cpu"][0]
    ba = {}
    for dev in ("cuda", "cpu"):
        m = map_from_numpy(base, device=dev)
        ba[dev] = map_to_numpy(local_bundle_adjustment(
            m, K.to(dev), cfg.map, iters=tr.kf_insert_ba_iters,
            damping=tr.ba_slice_damping,
            window_ids=covis_window_ids(m, cfg.map.ba_window)[0],
            prune=True))
    valid = base["lm_valid"]
    new = valid & ~m_np["lm_valid"]
    pos_err = np.abs(ba["cuda"]["lm_pos"] - ba["cpu"]["lm_pos"]).max(-1)
    worst = int(np.argmax(pos_err))
    return dict(
        frame=k, n_kf_before=int(m_np["n_kf"]),
        new_landmarks=dict(cuda=inserted["cuda"][1],
                           cpu=inserted["cpu"][1]),
        insertion_card_vs_cpu=ins_diff,
        ba_card_vs_cpu_from_cpu_insertion=cs._diff_fields(ba["cuda"],
                                                          ba["cpu"]),
        ba_lm_pos_err_over_1e_3=int((pos_err > 1e-3).sum()),
        ba_worst_landmark=dict(
            row=worst, err=float(pos_err[worst]), valid=bool(valid[worst]),
            new=bool(new[worst]),
            pos=ba["cpu"]["lm_pos"][worst].tolist(),
            observations=int((base["kf_obs_lm"] == worst).sum())))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ba_trace: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from send_slam_tpu_torch.models import local_mapping
    from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    from send_slam_tpu_torch.parallel import (
        init_multicam, make_mesh, multicam_slam_step,
    )
    torch.set_num_threads(4)
    cfg = cs.flagship_config()
    world, ts, poses, _ = cs.lanes_scene()
    step = multicam_slam_step(cfg, make_mesh(1, devices=["cuda"]),
                              loop_closing=True)
    kept = {}
    real = local_mapping.local_bundle_adjustment

    def spy(m, K, cfg_map, iters=5, n_fixed=2, **kw):
        if iters == 10 and n_fixed == 1 and "m" not in kept:
            kept.update(m=m, K=K, cfg_map=cfg_map, kw=kw)
        return real(m, K, cfg_map, iters=iters, n_fixed=n_fixed, **kw)

    local_mapping.local_bundle_adjustment = spy
    try:
        state = init_multicam(cfg, 2, device="cuda", seed=0)
        k = 0
        while "m" not in kept and k < 20:
            imgs = np.stack([np.round(world.render(*poses[c][k]))
                             .astype(np.uint8) for c in range(2)])
            before = state
            state, _ = step(state, imgs, np.full(2, ts[k], np.float32))
            k += 1
        card_input = kept.pop("m", None)
        # The same commit step on the CPU, from the card's state before
        # it: the bundle adjustment's input there.
        if card_input is not None:
            step_cpu = multicam_slam_step(
                cfg, make_mesh(1, devices=["cpu"]), loop_closing=True)
            step_cpu(cs._lane_state_to(before, "cpu"), imgs,
                     np.full(2, ts[k - 1], np.float32))
            cpu_input = kept["m"]
            kept["m"] = card_input
    finally:
        local_mapping.local_bundle_adjustment = real
    if card_input is None:
        print("ba_trace: no commit in 20 steps", file=sys.stderr)
        return 1
    commit_input_diff = cs._diff_fields(map_to_numpy(card_input),
                                    map_to_numpy(cpu_input))
    commit_parallax = parallax_report(map_to_numpy(card_input),
                                      map_to_numpy(cpu_input))
    m_card, K_card, cfg_map = kept["m"], kept["K"], kept["cfg_map"]

    def on(dev):
        return move(m_card, dev), K_card.to(dev)

    m_cpu, K_cpu = on("cpu")
    # 1. The whole adjustment.
    whole = {d: local_bundle_adjustment(*on(d), cfg_map, iters=10,
                                        n_fixed=1)
             for d in ("cuda", "cpu")}
    whole_err = {f: float((getattr(whole["cuda"], f).cpu()
                           - getattr(whole["cpu"], f)).abs().max())
                 for f in ("kf_R", "kf_t", "lm_pos")}
    # 2. Iteration by iteration from the CPU's chain.
    lam0 = torch.tensor(1e-3, dtype=torch.float32)
    chain, iters, first_part = m_cpu, [], None
    for it in range(10):
        lam = torch.clamp(lam0 * (0.5 ** it), min=lam0 * 1e-2)
        outs = {}
        for d in ("cuda", "cpu"):
            outs[d] = local_bundle_adjustment(
                move(chain, d), K_cpu.to(d), cfg_map, iters=1,
                damping=lam.to(d), n_fixed=1, prune=False)
        errs = {f: float((getattr(outs["cuda"], f).cpu()
                          - getattr(outs["cpu"], f)).abs().max())
                for f in ("kf_R", "kf_t", "lm_pos")}
        iters.append(dict(iteration=it, damping=float(lam), **errs))
        if first_part is None and any(e > 0 for e in errs.values()):
            first_part = it
            terms = {d: iteration_terms(move(chain, d), K_cpu.to(d), cfg_map,
                                        lam.to(d), 1)[0]
                     for d in ("cuda", "cpu")}
            ops = [dict(op=name, rel_err=rel_err(terms["cuda"][name], v))
                   for name, v in terms["cpu"].items()]
        chain = outs["cpu"]
    # 3. The reduced system's conditioning.
    # The free keyframes' rows and columns only: a fixed or empty slot's
    # block is the identity.
    _, meta = iteration_terms(m_cpu, K_cpu, cfg_map, lam0, 1)
    free = meta["pose_free"].nonzero().flatten().tolist()
    rows = [6 * w + i for w in free for i in range(6)]
    A = reduced_system(m_cpu, K_cpu, cfg_map, lam0, 1)[rows][:, rows]
    _, sv, Vt = torch.linalg.svd(A)
    v_min = Vt[-1]
    along = []
    for j, w in enumerate(free):
        t = meta["kf_t"][w].double().cpu()
        dirn = torch.zeros(A.shape[0], dtype=torch.float64)
        dirn[6 * j: 6 * j + 3] = t / t.norm()
        along.append(float(abs(v_min @ dirn)))
    keyframe = system_keyframe(torch, cs)
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), commit_step=k - 1,
        commit_ba_input_card_vs_cpu=commit_input_diff,
        commit_input_by_parallax=commit_parallax,
        system_keyframe=keyframe,
        n_kf=int(m_cpu.n_kf), landmarks=int(m_cpu.lm_valid.sum()),
        whole_abs_err=whole_err, iterations=iters,
        first_iteration_parting=first_part,
        ops_of_that_iteration=ops if first_part is not None else [],
        first_op_parting=next((o["op"] for o in ops if o["rel_err"] > 0),
                              None) if first_part is not None else None,
        reduced_system=dict(
            free_keyframes=free, size=A.shape[0], singular_max=float(sv[0]),
            singular_min=float(sv[-1]),
            singular_values=[float(x) for x in sv],
            condition=float(sv[0] / sv[-1]),
            weakest_along_free_translation=along),
        whole_maps_equal_fields=[f for f, v in map_to_numpy(
            whole["cuda"]).items()
            if np.array_equal(v, map_to_numpy(whole["cpu"])[f])])),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
