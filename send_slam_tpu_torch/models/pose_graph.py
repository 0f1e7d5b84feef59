"""Sim(3) pose-graph optimization for loop correction.

Counterpart of ``send_slam_tpu/models/pose_graph.py``: the essential
graph is a set of dense edge tensors (i, j, relative Sim(3)
measurement, validity, weight), and the solve is a damped Gauss-Newton
over per-keyframe sim(3) log-corrections with node 0 fixed.

Each edge's (7, 2, 7) Jacobian is the forward-mode derivative of its
residual in the two node corrections, as the reference's
``vmap(jacfwd)`` computes it: ``torch.func.vmap`` over the 14 basis
tangents of one ``torch.func.jvp`` of the residual batched over every
edge (edges are independent, so each edge's slice is its own
Jacobian). Mapping over edges instead would make each edge's scale and
angle 0-dim tensors, which ``torch.func`` promotes to float64 against a
Python float (``x + 1e-24``), so the batch stays on the data. The
(MK, MK, 7, 7) Hessian blocks and the (MK, 7) gradient are summed per
block in a fixed order (``ops/segsum.fixed_order_sum``; on the card one
kernel launch a sum over segment maps built once a solve), so a run
on the card replays bit for bit; the reduced (7 MK)^2 system is one
dense solve.

Convention: node i carries S_iw (world-to-keyframe-i similarity); edge
(i, j) measures S_ji = S_jw o S_iw^-1. Residual: log(S_ji_meas^-1 o
S_jw o S_iw^-1) in R^7.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jvp, vmap

from send_slam_tpu_torch.geometry.sim3 import (
    sim3_compose, sim3_exp, sim3_inverse, sim3_log,
)
from send_slam_tpu_torch.ops.segsum import SegmentMap, fixed_order_sum


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor        # (E,) int32 source node
    j: torch.Tensor        # (E,) int32 target node
    s: torch.Tensor        # (E,) measured scale of S_ji
    R: torch.Tensor        # (E,3,3)
    t: torch.Tensor        # (E,3)
    valid: torch.Tensor    # (E,) bool
    weight: torch.Tensor   # (E,) loop edges can be up-weighted


def relative_edges(kf_R, kf_t, i, j, valid, weight) -> PoseGraphEdges:
    """Edges (i, j) measuring S_ji = T_j o T_i^-1 from the current pose
    estimates, unit scale."""
    il, jl = i.long(), j.long()
    Ri, ti, Rj, tj = kf_R[il], kf_t[il], kf_R[jl], kf_t[jl]
    Rii = Ri.transpose(-1, -2)
    tii = -(Rii @ ti[..., None])[..., 0]
    return PoseGraphEdges(
        i=i.to(torch.int32), j=j.to(torch.int32),
        s=torch.ones(i.shape[0], dtype=kf_R.dtype, device=kf_R.device),
        R=Rj @ Rii, t=(Rj @ tii[..., None])[..., 0] + tj, valid=valid,
        weight=weight)


def build_sequential_edges(kf_R, kf_t, kf_valid, n_kf) -> PoseGraphEdges:
    """Chain edges i -> i+1 from the current keyframe estimates, unit
    scale."""
    MK = kf_R.shape[0]
    i = torch.arange(MK - 1, dtype=torch.int32, device=kf_R.device)
    j = i + 1
    valid = (j < n_kf) & kf_valid[:-1] & kf_valid[1:]
    return relative_edges(kf_R, kf_t, i, j, valid,
                          torch.ones(MK - 1, dtype=kf_R.dtype,
                                     device=kf_R.device))


def concat_edges(a: PoseGraphEdges, b: PoseGraphEdges) -> PoseGraphEdges:
    return PoseGraphEdges(*[torch.cat([x, y]) for x, y in zip(a, b)])


def _edge_residual(xi2, Ri, ti, Rj, tj, sm, Rm, tm):
    """xi2: (…,2,7) correction logs of (node i, node j) -> (…,7)
    residual."""
    one = torch.ones((), dtype=xi2.dtype, device=xi2.device)
    dsi, dRi, dti = sim3_exp(xi2[..., 0, :])
    si_, Ri_, ti_ = sim3_compose(dsi, dRi, dti, one, Ri, ti)
    dsj, dRj, dtj = sim3_exp(xi2[..., 1, :])
    sj_, Rj_, tj_ = sim3_compose(dsj, dRj, dtj, one, Rj, tj)
    sii, Rii, tii = sim3_inverse(si_, Ri_, ti_)
    s_ji, R_ji, t_ji = sim3_compose(sj_, Rj_, tj_, sii, Rii, tii)
    se, Re, te = sim3_compose(sm, Rm, tm, s_ji, R_ji, t_ji)
    return sim3_log(se, Re, te)


def _edge_jacobians(xi2, *edge):
    """xi2 (E,2,7) and the edges' poses and measurement inverses ->
    ((E,7,2,7) Jacobians, (E,7) residuals)."""
    E = xi2.shape[0]
    basis = torch.eye(14, dtype=xi2.dtype, device=xi2.device) \
        .reshape(14, 1, 2, 7).expand(14, E, 2, 7)
    r, dr = vmap(lambda v: jvp(lambda x: _edge_residual(x, *edge), (xi2,),
                               (v,)))(basis)
    return dr.permute(1, 2, 0).reshape(E, 7, 2, 7), r[0]


def optimize_pose_graph(kf_R, kf_t, kf_valid, edges: PoseGraphEdges,
                        iters: int = 20, damping: float = 1e-4
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns corrected (s_iw (MK,), R_iw, t_iw). Node 0 is fixed."""
    MK = kf_R.shape[0]
    dev, dt = kf_R.device, kf_R.dtype
    ii = torch.clamp(edges.i.long(), 0, MK - 1)
    jj = torch.clamp(edges.j.long(), 0, MK - 1)
    smi, Rmi, tmi = sim3_inverse(edges.s, edges.R, edges.t)
    Ri, ti, Rj, tj = kf_R[ii], kf_t[ii], kf_R[jj], kf_t[jj]

    free = kf_valid & (torch.arange(MK, device=dev) != 0)
    w_e = edges.valid.to(dt) * edges.weight
    mask = free.to(dt).repeat_interleave(7)
    # Block ids of the four Hessian scatters and the two gradient ones.
    h_map = SegmentMap(torch.cat([ii * MK + ii, jj * MK + jj, ii * MK + jj,
                                  jj * MK + ii]), MK * MK)
    b_map = SegmentMap(torch.cat([ii, jj]), MK)
    eye = torch.eye(MK * 7, dtype=dt, device=dev)

    xis = torch.zeros((MK, 7), dtype=dt, device=dev)
    for _ in range(iters):
        xi2 = torch.stack([xis[ii], xis[jj]], 1)               # (E,2,7)
        J, r_e = _edge_jacobians(xi2, Ri, ti, Rj, tj, smi, Rmi, tmi)
        Ji, Jj = J[:, :, 0, :], J[:, :, 1, :]
        Hii = torch.einsum('era,e,erb->eab', Ji, w_e, Ji)
        Hjj = torch.einsum('era,e,erb->eab', Jj, w_e, Jj)
        Hij = torch.einsum('era,e,erb->eab', Ji, w_e, Jj)
        bi = torch.einsum('era,e,er->ea', Ji, w_e, r_e)
        bj = torch.einsum('era,e,er->ea', Jj, w_e, r_e)
        H = fixed_order_sum(
            torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]).reshape(-1, 49),
            h_map).reshape(MK, MK, 7, 7)
        b = fixed_order_sum(torch.cat([bi, bj]), b_map)

        A = H.permute(0, 2, 1, 3).reshape(MK * 7, MK * 7)
        A = A * (mask[:, None] * mask[None, :])
        A = A + damping * eye + torch.diag(1.0 - mask)
        rhs = b.reshape(-1) * mask
        delta = -torch.linalg.solve(A, rhs[:, None])[:, 0]
        xis = xis + delta.reshape(MK, 7) * free[:, None]

    ds, dR, dtr = sim3_exp(xis)
    one = torch.ones(MK, dtype=dt, device=dev)
    return sim3_compose(ds, dR, dtr, one, kf_R, kf_t)
