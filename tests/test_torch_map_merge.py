"""The port's shared-map merge (send_slam_tpu_torch/parallel/map_merge.py)
against the JAX package's on the CPU.

``merge_from_partner`` runs on tests/test_map_merge.py's pair (a partner
map of the same scene under a known Sim(3) gauge) and on unrelated maps,
with the JAX package's Gumbel draws: every map field compared, integers
and booleans exactly, floats to 1e-5. The ring merge runs 4 lanes on a
1-device mesh (more lanes than devices: each lane merges its global
successor) and 8 lanes on an 8-entry mesh, against
``multicam_merge_step``. The row-blocked nearest distance equals the
one-shot broadcast bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.models.map_state import MapState as JMap
from send_slam_tpu.models.map_state import empty_map as jempty
from send_slam_tpu.parallel import map_merge as jmm
from send_slam_tpu.parallel import mesh as jmesh
from send_slam_tpu_torch.models.loop_closing import N_HYP
from send_slam_tpu_torch.models.map_state import (
    map_from_numpy, map_to_numpy, prune_zero_obs_landmarks,
)
from send_slam_tpu_torch.parallel import map_merge as tmm
from send_slam_tpu_torch.parallel import mesh as tmesh
from send_slam_tpu_torch.parallel.multicam import lane_map, stack_maps

torch.set_num_threads(1)


def make_pair(rng, n_shared=120, n_extra=60, ML=512):
    """tests/test_map_merge.py's pair: my map and a partner map of the
    same scene under a Sim(3) gauge difference (scale 1.7), sharing
    n_shared landmarks. Returns (my map as numpy fields, partner (pos,
    desc, valid) as numpy)."""
    world = rng.uniform([-4, -3, 3], [4, 3, 9],
                        (n_shared + n_extra, 3)).astype(np.float32)
    descs = rng.integers(0, 2**32, (n_shared + n_extra, 8), dtype=np.uint32)
    mine = {k: np.array(v) for k, v in jempty(
        jc.MapConfig(max_keyframes=8, max_landmarks=ML), 64)._asdict().items()}
    mine["lm_pos"][:n_shared] = world[:n_shared]
    mine["lm_desc"][:n_shared] = descs[:n_shared]
    mine["lm_valid"][:n_shared] = True
    mine["lm_ref_kf"][:n_shared] = 0
    Rg = Rotation.from_rotvec([0.1, -0.2, 0.15]).as_matrix().astype(
        np.float32)
    s, tg = 1.7, np.array([0.5, -1.2, 2.0], np.float32)
    part_world = ((world - tg) @ np.linalg.inv(s * Rg).T).astype(np.float32)
    p_pos = np.zeros((ML, 3), np.float32)
    p_desc = np.zeros((ML, 8), np.uint32)
    p_valid = np.zeros((ML,), bool)
    p_pos[:len(part_world)] = part_world
    p_desc[:len(descs)] = descs
    p_valid[:len(descs)] = True
    return mine, (p_pos, p_desc, p_valid)


def assert_maps_close(got, ref, atol=1e-5):
    """Every field: integers and booleans exact, floats to ``atol``."""
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def both_merges(mine, partner, key):
    ML = mine["lm_pos"].shape[0]
    p_pos, p_desc, p_valid = partner
    jm, jok, jn = jax.jit(jmm.merge_from_partner, static_argnums=(5,))(
        JMap(**{k: jnp.asarray(v) for k, v in mine.items()}),
        jnp.asarray(p_pos), jnp.asarray(p_desc), jnp.asarray(p_valid), key,
        jc.TrackingConfig())
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (N_HYP, ML))))
    tm, tok, tn = tmm.merge_from_partner(
        map_from_numpy(mine, device="cpu"), torch.from_numpy(p_pos),
        torch.from_numpy(p_desc.view(np.int32)), torch.from_numpy(p_valid),
        noise, tc.TrackingConfig())
    return ({k: np.asarray(v) for k, v in jm._asdict().items()}, bool(jok),
            int(jn)), (map_to_numpy(tm), bool(tok), int(tn))


def test_merge_aligns_and_imports_novel_as_jax():
    mine, partner = make_pair(np.random.default_rng(21))
    (jm, jok, jn), (tm, tok, tn) = both_merges(mine, partner,
                                               jax.random.PRNGKey(0))
    assert jok and tok and 40 <= tn <= 70 and tn == jn
    assert_maps_close(tm, jm)
    new = tm["lm_valid"] & ~mine["lm_valid"]
    assert new.sum() == tn and (tm["lm_ref_kf"][new] == -1).all()
    # No observations: the imports' rows are never written into a
    # keyframe, and the zero-observation prune exempts them.
    np.testing.assert_array_equal(tm["kf_obs_lm"], mine["kf_obs_lm"])
    pruned = prune_zero_obs_landmarks(map_from_numpy(tm, device="cpu"))
    assert pruned.lm_valid.numpy()[new].all()


def test_no_import_on_unrelated_maps_as_jax():
    rng = np.random.default_rng(22)
    mine, _ = make_pair(rng)
    ML = mine["lm_pos"].shape[0]
    partner = (rng.uniform(-5, 5, (ML, 3)).astype(np.float32),
               rng.integers(0, 2**32, (ML, 8), dtype=np.uint32),
               np.ones((ML,), bool))
    (jm, jok, jn), (tm, tok, tn) = both_merges(mine, partner,
                                               jax.random.PRNGKey(1))
    assert not jok and not tok and jn == tn == 0
    assert_maps_close(tm, jm)


def ring_maps(n, ML=256, seed=0):
    """tests/test_map_merge.py's ring maps: every lane the same 60
    landmarks (identity gauge) plus 20 of its own."""
    rng = np.random.default_rng(seed)
    one = {k: np.array(v) for k, v in jempty(
        jc.MapConfig(max_keyframes=8, max_landmarks=ML), 64)._asdict().items()}
    maps = {k: np.stack([v] * n) for k, v in one.items()}
    shared = rng.uniform([-4, -3, 3], [4, 3, 9], (60, 3)).astype(np.float32)
    sdesc = rng.integers(0, 2**32, (60, 8), dtype=np.uint32)
    for c in range(n):
        maps["lm_pos"][c, :60] = shared
        maps["lm_pos"][c, 60:80] = rng.uniform([-4, -3, 3], [4, 3, 9],
                                               (20, 3))
        maps["lm_desc"][c, :60] = sdesc
        maps["lm_desc"][c, 60:80] = rng.integers(0, 2**32, (20, 8),
                                                 dtype=np.uint32)
        maps["lm_valid"][c, :80] = True
        maps["lm_ref_kf"][c, :80] = 0
    return maps


@pytest.mark.parametrize("n_lanes,n_dev", [(4, 1), (8, 8)])
def test_ring_merge_matches_jax(n_lanes, n_dev):
    cfg_j = jc.EngineConfig(map=jc.MapConfig(max_keyframes=8,
                                             max_landmarks=256))
    cfg_t = tc.EngineConfig(map=tc.MapConfig(max_keyframes=8,
                                             max_landmarks=256))
    maps = ring_maps(n_lanes)
    keys = jax.random.split(jax.random.PRNGKey(0), n_lanes)
    jstep = jmm.multicam_merge_step(cfg_j, jmesh.make_mesh(n_dev, ("cam",)))
    jm, jok, jn = jstep(JMap(**{k: jnp.asarray(v) for k, v in maps.items()}),
                        keys)
    noises = torch.from_numpy(np.stack([np.array(jax.random.gumbel(
        k, (N_HYP, 256))) for k in keys]))
    mesh = tmesh.make_mesh(n_dev, ("cam",), devices=["cpu"] * n_dev)
    tm, tok, tn = tmm.multicam_merge_step(cfg_t, mesh)(
        map_from_numpy(maps, device="cpu"), noises)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tok.all() and (tn >= 10).all(), tn
    assert_maps_close(map_to_numpy(tm),
                      {k: np.asarray(v) for k, v in jm._asdict().items()})
    # Lane i imported its successor's own 20 landmarks.
    for i in range(n_lanes):
        j = (i + 1) % n_lanes
        new = map_to_numpy(tm)["lm_pos"][i][80:80 + int(tn[i])]
        np.testing.assert_allclose(np.sort(new, 0),
                                   np.sort(maps["lm_pos"][j][60:80][
                                       :int(tn[i])], 0), atol=1e-4)


def test_lane_maps_split_and_stack():
    maps = map_from_numpy(ring_maps(3), device="cpu")
    back = stack_maps([lane_map(maps, c) for c in range(3)], "cpu")
    for k, v in map_to_numpy(maps).items():
        np.testing.assert_array_equal(map_to_numpy(back)[k], v)


@pytest.mark.parametrize("block_elems", [1, 1000, 1 << 24])
def test_nearest_distance_blocks_equal_the_broadcast(block_elems):
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.normal(0, 3, (300, 3)).astype(np.float32))
    table = torch.from_numpy(rng.normal(0, 3, (700, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(700) < 0.7)
    got = tmm.nearest_distance(pts, table, valid, block_elems=block_elems)
    d = pts[:, None, :] - table[None, :, :]
    d = d * d
    d2 = torch.where(valid[None, :], d[..., 0] + d[..., 1] + d[..., 2],
                     torch.tensor(float("inf")))
    assert torch.equal(got, torch.sqrt(d2.amin(1)))
    # ... and the reference's own expression.
    ref = np.asarray(jnp.sqrt(jnp.min(jnp.where(
        jnp.asarray(valid.numpy())[None, :],
        jnp.sum((jnp.asarray(pts.numpy())[:, None, :]
                 - jnp.asarray(table.numpy())[None, :, :]) ** 2, -1),
        jnp.inf), axis=1)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    none = tmm.nearest_distance(pts, table, torch.zeros(700, dtype=bool))
    assert torch.isinf(none).all()


def test_merge_noise_is_seeded_on_the_cpu():
    a = tmm.merge_noise(2, 64, seed=4)
    b = tmm.merge_noise(2, 64, seed=4)
    assert a.shape == (2, N_HYP, 64) and a.device.type == "cpu"
    assert torch.equal(a, b)
    assert not torch.equal(a, tmm.merge_noise(2, 64, seed=5))
