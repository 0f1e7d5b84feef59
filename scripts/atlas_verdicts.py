"""The card's failed cross-map verifications in chip_smoke.py's atlas
scene, held against the JAX package's verdict on the same inputs.

    python scripts/atlas_verdicts.py --dump OUT.npz        # on the card
    JAX_PLATFORMS=cpu python scripts/atlas_verdicts.py --check OUT.npz

``--dump`` runs chip_smoke.py's atlas_path on the card (printing its
JSON line) and writes the first cross-map Sim(3) verification that
failed at or past frame ``chip_smoke.ATLAS_FAILED_FROM`` to an npz: the
active and the frozen map, both keyframe ids, the Gumbel draw the
session took for it and the card's verdict (ok, matches, inliers, s).

``--check`` runs, on the CPU, the JAX package's ``cross_map_sim3`` on
those inputs with the same draw in place of its ``jax.random.gumbel``
draw, and the port's ``cross_map_sim3`` on the CPU, and prints one JSON
line with the card's, the port's and the JAX package's verdicts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def atlas_tracking(C):
    """chip_smoke.py's atlas_path tracking overrides, in package ``C``'s
    TrackingConfig."""
    return C.TrackingConfig(pipeline_stretch=1, init_min_matches=40,
                            kf_max_interval=5, atlas_reloc_patience=8,
                            atlas_min_kf=5)


def dump(path: str) -> int:
    import torch
    import chip_smoke
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    from send_slam_tpu_torch.models.system import System
    if not torch.cuda.is_available():
        print("atlas_verdicts: --dump needs a CUDA card", file=sys.stderr)
        return 2
    chip_smoke.load_kernels()
    _, kept = chip_smoke.atlas_path(torch, System,
                                    chip_smoke.flagship_config())
    rec = kept["sim3_failed"]
    if rec is None:
        print("atlas_verdicts: no verification failed at or past frame "
              f"{chip_smoke.ATLAS_FAILED_FROM}", file=sys.stderr)
        return 1
    active, frozen, ka, kf, noise = rec["args"]
    out = rec["out"]
    arrays = {f"active/{k}": v for k, v in map_to_numpy(active).items()}
    arrays.update({f"frozen/{k}": v for k, v in map_to_numpy(frozen).items()})
    np.savez_compressed(
        path, **arrays, active_kf=np.int32(int(ka)),
        frozen_kf=np.int32(int(kf)),
        noise=noise.cpu().numpy(), frame=np.int32(rec["frame"]),
        card_ok=bool(out.ok), card_n_matches=int(out.n_matches),
        card_n_inliers=int(out.sim3.n_inliers), card_s=float(out.sim3.s))
    print(json.dumps(dict(dumped=path, frame=rec["frame"],
                          ok=bool(out.ok), n_matches=int(out.n_matches),
                          n_inliers=int(out.sim3.n_inliers))), flush=True)
    return 0


def check(path: str) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from send_slam_tpu import config as jc
    from send_slam_tpu.models import atlas as ja
    from send_slam_tpu.models.map_state import MapState as JMap
    from send_slam_tpu_torch import config as tc
    from send_slam_tpu_torch.models import atlas as ta
    from send_slam_tpu_torch.models.map_state import map_from_numpy

    z = np.load(path)
    maps = {side: {k.split("/", 1)[1]: z[k] for k in z.files
                   if k.startswith(side + "/")}
            for side in ("active", "frozen")}
    ka, kf, noise = int(z["active_kf"]), int(z["frozen_kf"]), z["noise"]

    def verdict(r):
        return dict(ok=bool(r.ok), n_matches=int(r.n_matches),
                    n_inliers=int(r.sim3.n_inliers), s=float(r.sim3.s),
                    inlier=np.asarray(r.sim3.inlier))

    tr_t = atlas_tracking(tc)
    port = verdict(ta.cross_map_sim3(
        map_from_numpy(maps["active"], "cpu"),
        map_from_numpy(maps["frozen"], "cpu"), ka, kf,
        torch.from_numpy(noise), tr_t, min_matches=tr_t.loop_min_matches))

    # The session's draw in place of the JAX package's own.
    gumbel = jax.random.gumbel
    jax.random.gumbel = lambda key, shape, *a, **k: jnp.asarray(
        noise).reshape(shape)
    try:
        tr_j = atlas_tracking(jc)
        ref = verdict(ja.cross_map_sim3(
            JMap(**{k: jnp.asarray(v) for k, v in maps["active"].items()}),
            JMap(**{k: jnp.asarray(v) for k, v in maps["frozen"].items()}),
            jnp.asarray(ka, jnp.int32), jnp.asarray(kf, jnp.int32),
            jax.random.PRNGKey(0), tr_j, min_matches=tr_j.loop_min_matches))
    finally:
        jax.random.gumbel = gumbel
    card = dict(ok=bool(z["card_ok"]), n_matches=int(z["card_n_matches"]),
                n_inliers=int(z["card_n_inliers"]), s=float(z["card_s"]))
    same_inliers = bool(np.array_equal(port.pop("inlier"),
                                       ref.pop("inlier")))
    print(json.dumps(dict(
        frame=int(z["frame"]), active_kf=ka, frozen_kf=kf,
        active_keyframes=int(maps["active"]["kf_valid"].sum()),
        frozen_keyframes=int(maps["frozen"]["kf_valid"].sum()),
        card=card, port_cpu=port, jax_cpu=ref,
        port_jax_inliers_equal=same_inliers)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--dump", metavar="NPZ")
    mode.add_argument("--check", metavar="NPZ")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    return dump(args.dump) if args.dump else check(args.check)


if __name__ == "__main__":
    sys.exit(main())
