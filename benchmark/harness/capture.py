"""What the comparison keeps from the window: the stages of the program
whose outputs ``correct`` judges, by the names their callers look up.

- ``frontend``: each image ``make_frames`` turned into a Frame (the
  System's ``make_frame`` calls it);
- ``match``: the descriptor matcher as tracking calls it;
- ``gn``: the robust pose-only Gauss-Newton tracking runs (both passes,
  the init backfill's and relocalization's included);
- ``ba``: local bundle adjustment of several iterations at the
  configured damping, as keyframe insertion and the init's map bootstrap
  run it. The one-iteration slices between keyframes are not kept: at
  their small damping (down to 3e-5) the reduced pose system is so
  ill-conditioned that float32's rounding alone moves their result by
  some 1e-3 px on the card;
- ``tri``: the two-view triangulation of new landmarks that keyframe
  insertion runs against each earlier keyframe.

Sample sizes are per run; each sample is drawn from the seed. A kept
map is the references to the arrays its stage reads or wrote: the
program replaces a map's arrays and never writes into them, so nothing
is copied inside the window.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.stash import Stash

P = "send_slam_tpu_torch."


def _keep_frames(args, kwargs, frames):
    imgs = args[0]
    if isinstance(imgs, torch.Tensor):
        imgs = imgs.numpy()
    return [(np.asarray(imgs[i]), f) for i, f in enumerate(frames)]


def _keep_call(args, kwargs, out):
    return (args, kwargs, out)


BA_ARGS = ("m", "K", "cfg", "iters", "huber_delta", "damping",
           "scale_factor", "n_fixed", "window_ids", "prune",
           "chi2_prune_mult")
BA_DEFAULTS = dict(iters=5, huber_delta=2.447, damping=1e-3,
                   scale_factor=1.2, n_fixed=2, window_ids=None, prune=True,
                   chi2_prune_mult=4.0)
BA_READS = ("kf_R", "kf_t", "kf_uv", "kf_octave", "kf_obs_lm",
            "kf_kp_valid", "kf_valid", "lm_valid", "lm_pos", "n_kf")
TRI_ARGS = ("m", "kf_new", "kf_ref")


def bind(names, defaults, args, kwargs):
    out = dict(defaults)
    out.update(zip(names, args))
    out.update(kwargs)
    return out


def _keep_ba(args, kwargs, out):
    a = bind(BA_ARGS, BA_DEFAULTS, args, kwargs)
    m = a.pop("m")
    a["ba_window"] = a.pop("cfg").ba_window
    del a["K"]
    return dict(args=a, before={k: getattr(m, k) for k in BA_READS},
                after=dict(kf_R=out.kf_R, kf_t=out.kf_t, lm_pos=out.lm_pos))


def _keep_tri(args, kwargs, out):
    a = bind(TRI_ARGS, {}, args, kwargs)
    m, after = a["m"], out[0]
    return dict(kf_new=a["kf_new"], kf_ref=a["kf_ref"],
                before=dict(kf_R=m.kf_R, kf_t=m.kf_t, kf_uv=m.kf_uv,
                            lm_valid=m.lm_valid),
                after=dict(lm_valid=after.lm_valid, lm_pos=after.lm_pos,
                           kf_obs_lm=after.kf_obs_lm))


def _keep_adjustment(args, kwargs, out):
    item = _keep_ba(args, kwargs, out)
    return item if int(item["args"]["iters"]) > 1 else []


def stash(seed: int) -> Stash:
    return Stash(seed, {
        "frontend": (3, [(P + "models.frame", "make_frames")], _keep_frames),
        "match": (4, [(P + "models.tracking", "match_descriptors")],
                  _keep_call),
        "gn": (32, [(P + "models.tracking", "pose_only_gn")], _keep_call),
        "ba": (8, [(P + "models.system", "local_bundle_adjustment"),
                   (P + "models.local_mapping", "local_bundle_adjustment")],
               _keep_adjustment),
        "tri": (8, [(P + "models.local_mapping", "create_new_landmarks")],
                _keep_tri),
    })
