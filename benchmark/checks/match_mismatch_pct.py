"""``match_mismatch_pct``: of the rows either side matched in the sampled
matcher calls, the share (%) matched otherwise.

Stage ``match``: the descriptor matcher as tracking calls it.

No control of its own: the TF32 switch keeps products of 0/1 bits exact,
so the control leaves this an exact comparison.
"""

from __future__ import annotations

from typing import Dict, Optional

from harness.capture import bind, keep_call as keep  # noqa: F401
from harness.correct import to_np, words
from reference import tracking as ref_tracking

STAGE = "match"
SAMPLE = 4
SITES = [("send_slam_tpu_torch.models.tracking", "match_descriptors")]

ARGS = ("desc_a", "desc_b", "valid_a", "valid_b", "max_dist", "ratio",
        "mutual", "extra_mask", "angles_a", "angles_b", "return_col")
DEFAULTS = dict(max_dist=100.0, ratio=0.9, mutual=True, extra_mask=None,
                angles_a=None, angles_b=None, return_col=False)


def mismatch_pct(items) -> Optional[float]:
    bad = total = 0
    for args, kwargs, out in items:
        a = bind(ARGS, DEFAULTS, args, kwargs)
        em = a["extra_mask"]
        idx, _, ok, col_idx, col_ok = ref_tracking.match(
            words(a["desc_a"]), words(a["desc_b"]), to_np(a["valid_a"]),
            to_np(a["valid_b"]), float(a["max_dist"]), float(a["ratio"]),
            bool(a["mutual"]), None if em is None else to_np(em))
        row = out[0] if a["return_col"] else out
        p_ok, p_idx = to_np(row.valid), to_np(row.idx)
        either = p_ok | ok
        bad += int((either & ((p_ok != ok) | (p_idx != idx))).sum())
        total += int(either.sum())
        if a["return_col"]:
            col = out[1]
            c_ok, c_idx = to_np(col.valid), to_np(col.idx)
            c_either = c_ok | col_ok
            bad += int((c_either & ((c_ok != col_ok)
                                    | (c_idx != col_idx))).sum())
            total += int(c_either.sum())
    return None if total == 0 else 100.0 * bad / total


def value(items, config: Dict) -> Optional[float]:
    return mismatch_pct(items)
