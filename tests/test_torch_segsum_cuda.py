"""The CUDA segment sum (ops/segsum_cuda.py, csrc/segsum_kernel.cu)
against the plain version of ``fixed_order_sum`` (ops/segsum.py).

Cases marked ``cuda`` skip without a card; on the GPU machine:
``python -m pytest -q --noconftest -m cuda tests/test_torch_segsum_cuda.py``.
The others run on the CPU: the segment index against a NumPy
construction, CPU tensors take the plain path and never the kernel, and
a transcription of the kernel (its index walk, both sorting networks and
the sums from +0) gives the plain version's bits."""

import numpy as np
import pytest
import torch

from send_slam_tpu_torch.ops import segsum_cuda
from send_slam_tpu_torch.ops.segsum import (
    ObsMap, SegmentMap, _segment_index, fixed_order_sum,
    fixed_order_sum_plain, segment_counts,
)
from send_slam_tpu_torch.utils.synth import (
    SEGSUM_CASES, segsum_problem, segsum_values,
)

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

BA_CASES = [k for k, c in SEGSUM_CASES.items() if "W" in c]
SEED = 2020


def bits(x):
    return x.contiguous().view(torch.int32)


def ba_segs(name):
    """A BA case's problem (``ids``, ``L``, ``W``, ``N``) and its segment
    ids ``{B: seg}`` for B = 1 and B = W blocks."""
    p = segsum_problem(name, SEED)
    ids = torch.from_numpy(p["ids"])
    om = ObsMap(ids, p["L"])
    return p, {B: om._seg(B).seg for B in (1, p["W"])}


def numpy_index(seg, n_seg):
    """The index built the obvious way: valid rows in stable id order,
    the counts' exclusive cumsum, the segments of more than SHORT rows."""
    seg = np.asarray(seg)
    valid = seg < n_seg
    rows = np.flatnonzero(valid)
    perm = rows[np.argsort(seg[rows], kind="stable")]
    counts = np.bincount(seg[rows], minlength=n_seg)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return perm, offsets, np.flatnonzero(counts > segsum_cuda.SHORT)


def index_of(seg, n_seg):
    return _segment_index(seg, n_seg, segment_counts(seg, n_seg))


def check_index(seg, n_seg):
    idx = index_of(seg, n_seg)
    perm, offsets, longs = numpy_index(seg.numpy(), n_seg)
    n_valid = len(perm)
    assert torch.equal(idx.offsets, torch.from_numpy(offsets))
    assert torch.equal(idx.perm[:n_valid], torch.from_numpy(perm))
    # The spill rows never enter the index.
    assert (idx.perm[n_valid:] == -1).all()
    spill = set(np.flatnonzero(seg.numpy() == n_seg).tolist())
    assert not spill & set(idx.perm.tolist())
    n_long = int(idx.n_long)
    assert n_long == len(longs)
    assert torch.equal(idx.long_seg[:n_long], torch.from_numpy(longs))
    assert idx.long_seg.shape == (segsum_cuda.long_capacity(len(seg)),)
    return idx


@pytest.mark.parametrize("name", BA_CASES)
def test_index_of_a_ba_window(name):
    p, segs = ba_segs(name)
    for B, seg in segs.items():
        check_index(seg, B * p["L"])


@pytest.mark.parametrize("which", ["h", "b"])
def test_index_of_the_pose_graph(which):
    p = segsum_problem("pose_graph", SEED)
    seg = torch.from_numpy(p[f"{which}_seg"])
    idx = check_index(seg, p[f"n_{which}"])
    assert int(idx.n_long) > 0          # hubs: the block path's segments


def test_index_edges():
    """All spill, no row at all, and one segment over every row."""
    check_index(torch.full((50,), 7, dtype=torch.int64), 7)
    check_index(torch.zeros(0, dtype=torch.int64), 7)
    idx = check_index(torch.full((5000,), 3, dtype=torch.int64), 9)
    assert int(idx.n_long) == 1 and int(idx.long_seg[0]) == 3


def plain_reference(values, seg, n_seg):
    """The plain version as it stood before the kernel: kept here so the
    CPU path is held to the very ops it ran."""
    counts = segment_counts(seg, n_seg)
    v, by_value = torch.sort(values, dim=0, stable=True)
    _, by_seg = torch.sort(seg[by_value], dim=0, stable=True)
    v = torch.gather(v, 0, by_seg)
    return torch.segment_reduce(v, "sum", lengths=counts, axis=0,
                                unsafe=True)[:n_seg]


@pytest.mark.parametrize("name", ["local_8", "pose_graph"])
def test_cpu_takes_the_plain_path(name, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(segsum_cuda, "segment_sum", refuse)
    n0 = segsum_cuda.LIBRARY.launches
    if name == "pose_graph":
        p = segsum_problem(name, SEED)
        seg = torch.from_numpy(p["h_seg"])
        vals = torch.from_numpy(segsum_values(len(seg), 49, 1))
        segs = SegmentMap(seg, p["n_h"])
        assert torch.equal(fixed_order_sum(vals, segs),
                           plain_reference(vals, seg, p["n_h"]))
        assert segs.index is None           # no index is built on the CPU
    else:
        p, segs = ba_segs(name)
        W, N, L = p["W"], p["N"], p["L"]
        om = ObsMap(torch.from_numpy(p["ids"]), L)
        v12 = torch.from_numpy(segsum_values(12, W * N, 2))
        assert torch.equal(om.seg_sum_t(v12),
                           plain_reference(v12.T, segs[1], L).T)
        v18 = torch.from_numpy(segsum_values(W * 18, N, 3)).reshape(W, 18, N)
        ref = plain_reference(v18.permute(0, 2, 1).reshape(-1, 18), segs[W],
                              W * L).reshape(W, L, 18).permute(0, 2, 1)
        got = om.seg_sum_batched_t(v18)
        assert torch.equal(got, ref) and got.stride() == ref.stride()
        assert om._seg(1).index is None     # no index is built on the CPU
        assert om._seg(W).index is None
    assert segsum_cuda.LIBRARY.launches == n0


def test_wrapper_refuses_cpu_tensors():
    seg = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        segsum_cuda.segment_sum(torch.ones(4, 2), seg, index_of(seg, 1), 1)


# --- a transcription of the kernel, on NumPy float32 -----------------------

def _order(v, i, j):
    if v[i] > v[j]:
        v[i], v[j] = v[j], v[i]


def short_sum(vals, log):
    """short_sum<LOG>: pad with +inf to 2^LOG, the register network, the
    sum from +0 over the real values."""
    n = 1 << log
    v = list(vals) + [np.float32(np.inf)] * (n - len(vals))
    for lk in range(1, log + 1):
        k, h = 1 << lk, 1 << (lk - 1)
        for t in range(n // 2):
            _order(v, (t // h) * k + t % h, (t // h) * k + k - 1 - t % h)
        for lm in range(lk - 2, -1, -1):
            m = 1 << lm
            for t in range(n // 2):
                i = (t // m) * 2 * m + t % m
                _order(v, i, i + m)
    acc = np.float32(0.0)
    with np.errstate(invalid="ignore"):         # inf - inf, as on the card
        for x in v[:len(vals)]:
            acc = np.float32(acc + x)
    return acc


def block_sum(vals):
    """block_sort over the next power of two with the comparators past n
    skipped, then one thread's sum from +0."""
    v, n = list(vals), len(vals)
    p = 1
    while p < n:
        p <<= 1
    k = 2
    while k <= p:
        h = k >> 1
        for t in range(p // 2):
            base, off = (t // h) * k, t % h
            if base + k - 1 - off < n:
                _order(v, base + off, base + k - 1 - off)
        m = k >> 2
        while m >= 1:
            for t in range(p // 2):
                i = (t // m) * 2 * m + t % m
                if i + m < n:
                    _order(v, i, i + m)
            m >>= 1
        k <<= 1
    acc = np.float32(0.0)
    with np.errstate(invalid="ignore"):
        for x in v:
            acc = np.float32(acc + x)
    return acc


def kernel_transcription(values, seg, n_seg):
    """segsum_kernel over the index, per (segment, column), in NumPy."""
    idx = index_of(seg, n_seg)
    perm, off = idx.perm.numpy(), idx.offsets.numpy()
    vals = values.numpy()
    D = vals.shape[1]
    out = np.zeros((n_seg, D), np.float32)
    longs = set(idx.long_seg[:int(idx.n_long)].tolist())
    for i in range(int(off[n_seg])):
        s = int(seg[perm[i]])
        if off[s] != i:
            continue
        rows = perm[off[s]:off[s + 1]]
        n = len(rows)
        assert (n > segsum_cuda.SHORT) == (s in longs)
        for d in range(D):
            col = vals[rows, d]
            if n > segsum_cuda.SHORT:
                out[s, d] = block_sum(col)
            else:
                out[s, d] = short_sum(col, max(0, (n - 1).bit_length()))
    return torch.from_numpy(out)


def special_values(rows, cols, seed):
    """Mixed magnitudes with +-0, +-inf, NaN and denormals planted."""
    rng = np.random.default_rng(seed)
    v = segsum_values(rows, cols, seed)
    pick = rng.random((rows, cols))
    v[pick < 0.05] = 0.0
    v[(pick >= 0.05) & (pick < 0.10)] = -0.0
    v[(pick >= 0.10) & (pick < 0.15)] = (rng.normal(size=1)
                                         * 1e-40).astype(np.float32)[0]
    v[(pick >= 0.15) & (pick < 0.16)] = np.inf
    v[(pick >= 0.16) & (pick < 0.17)] = -np.inf
    v[(pick >= 0.17) & (pick < 0.175)] = np.nan
    return v


def same_bits_or_nan(got, ref):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(bits(got)[~nan], bits(ref)[~nan])


@pytest.mark.parametrize("lengths", [
    [1, 1, 2, 3, 4, 5],                 # the BA's segments
    [6, 7, 8, 9, 15, 16, 17, 31, 32],   # every register tier's edge
    [33, 40, 64, 65, 257],              # the block path (hubs)
])
@pytest.mark.parametrize("special", [False, True])
def test_transcription_equals_the_plain_version(lengths, special):
    rng = np.random.default_rng(sum(lengths))
    n_seg = 2 * len(lengths) + 1
    segs = rng.permutation(n_seg)[:len(lengths)]
    seg = np.concatenate([np.full(n, s) for s, n in zip(segs, lengths)]
                         + [np.full(23, n_seg)])          # spill rows
    seg = torch.from_numpy(rng.permutation(seg).astype(np.int64))
    D = 3
    vals = torch.from_numpy(special_values(len(seg), D, 7) if special
                            else segsum_values(len(seg), D, 7))
    got = kernel_transcription(vals, seg, n_seg)
    ref = fixed_order_sum_plain(vals, SegmentMap(seg, n_seg))
    if special:
        same_bits_or_nan(got, ref)
    else:
        assert torch.equal(bits(got), bits(ref))


def test_zero_sums_are_plus_zero():
    """Only -0 rows: the plain version and the kernel start from +0."""
    seg = torch.tensor([0, 0, 1, 2, 2, 2], dtype=torch.int64)
    vals = torch.full((6, 2), -0.0)
    ref = fixed_order_sum_plain(vals, SegmentMap(seg, 4))
    assert torch.equal(bits(kernel_transcription(vals, seg, 4)), bits(ref))
    assert (bits(ref) == 0).all()


# --- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def held(got, ref, what):
    """Bit-equal, NaN payloads included."""
    assert got.shape == ref.shape, what
    assert torch.equal(bits(got), bits(ref)), what


@pytest.mark.cuda
@pytest.mark.parametrize("name", BA_CASES)
def test_card_ba_forms_equal_the_plain_version(name):
    """seg_sum (D = 1), seg_sum_t (D = 12), seg_sum_batched_t (B = W,
    D = 18) against the plain version on the card and on the CPU, with
    the plain version's strides."""
    _card()
    p = segsum_problem(name, SEED)
    W, N, L = p["W"], p["N"], p["L"]
    ids = torch.from_numpy(p["ids"]).cuda()
    om = ObsMap(ids, L)
    ones = torch.ones((W * N, 1), device="cuda")
    v12 = torch.from_numpy(segsum_values(12, W * N, 1)).cuda()
    v18 = torch.from_numpy(segsum_values(W * 18, N, 2)).cuda() \
        .reshape(W, 18, N)
    n0 = segsum_cuda.LIBRARY.launches
    got = [om.seg_sum(ones), om.seg_sum_t(v12), om.seg_sum_batched_t(v18)]
    assert segsum_cuda.LIBRARY.launches == n0 + 3
    ref = [fixed_order_sum_plain(ones, om._seg(1)),
           fixed_order_sum_plain(v12.T, om._seg(1)).T,
           fixed_order_sum_plain(v18.permute(0, 2, 1), om._seg(W))
           .reshape(W, L, 18).permute(0, 2, 1)]
    cpu = ObsMap(ids.cpu(), L)
    on_cpu = [cpu.seg_sum(ones.cpu()), cpu.seg_sum_t(v12.cpu()),
              cpu.seg_sum_batched_t(v18.cpu())]
    for what, g, r, c in zip(("seg_sum", "seg_sum_t", "batched"), got, ref,
                             on_cpu):
        held(g, r, f"{name} {what}")
        held(g.cpu(), c, f"{name} {what} against the CPU")
        assert g.stride() == r.stride(), what
    # The index is built once per map and block count: a repeat reuses it.
    assert torch.equal(om.seg_sum_batched_t(v18), got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("which,D", [("h", 49), ("b", 7)])
def test_card_pose_graph_equals_the_plain_version(which, D):
    _card()
    p = segsum_problem("pose_graph", SEED)
    seg = torch.from_numpy(p[f"{which}_seg"]).cuda()
    n_seg = p[f"n_{which}"]
    vals = torch.from_numpy(segsum_values(len(seg), D, 5)).cuda()
    segs = SegmentMap(seg, n_seg)
    n0 = segsum_cuda.LIBRARY.launches
    got = fixed_order_sum(vals, segs)
    assert segsum_cuda.LIBRARY.launches == n0 + 1
    assert int(segs.index.n_long) > 0
    held(got, fixed_order_sum_plain(vals, segs), f"pose graph {which}")
    held(got.cpu(), fixed_order_sum_plain(vals.cpu(),
                                          SegmentMap(seg.cpu(), n_seg)),
         f"pose graph {which} against the CPU")
    held(fixed_order_sum(vals, SegmentMap(seg, n_seg)), got,
         "without a prebuilt index")


EDGES = {
    # name: (segment lengths, spill rows, D)
    "all_spill": ([], 300, 4),
    "no_row": ([], 0, 4),
    "one_row_segments": ([1] * 500, 40, 6),
    "tiers": ([1, 2, 3, 4, 5, 8, 9, 16, 17, 32], 10, 5),
    "block_path": ([33, 100, 513, 4096], 7, 3),
    "past_shared_memory": ([4097, 9000, 3], 11, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EDGES))
@pytest.mark.parametrize("special", [False, True])
def test_card_edge_cases(name, special):
    """Every length and the IEEE corners: +-0, NaN, +-inf, denormals."""
    _card()
    lengths, n_spill, D = EDGES[name]
    rng = np.random.default_rng(len(lengths) + n_spill)
    n_seg = 2 * len(lengths) + 3
    segs = rng.permutation(n_seg)[:len(lengths)]
    seg = np.concatenate([np.full(n, s) for s, n in zip(segs, lengths)]
                         + [np.full(n_spill, n_seg)]).astype(np.int64)
    seg = torch.from_numpy(rng.permutation(seg)).cuda()
    R = len(seg)
    vals = torch.from_numpy(special_values(R, D, 9) if special
                            else segsum_values(R, D, 9)).cuda()
    n0 = segsum_cuda.LIBRARY.launches
    segs = SegmentMap(seg, n_seg)
    got = fixed_order_sum(vals, segs)
    assert segsum_cuda.LIBRARY.launches == n0 + 1
    held(got, fixed_order_sum_plain(vals, segs), name)
    if R:
        # Its transpose and a blocked form read the same rows.
        held(fixed_order_sum(vals.T.contiguous().T, segs), got,
             f"{name} column-major")
    held(fixed_order_sum(vals, segs), got, f"{name} repeat")


@pytest.mark.cuda
def test_card_counter_and_no_sync():
    """One ``kernel.segsum`` count per launch; a launch inside a CUDA
    graph capture (which forbids syncs and host reads) works."""
    _card()
    from send_slam_tpu_torch.utils import profiling
    p, segs = ba_segs("local_8")
    om = ObsMap(torch.from_numpy(p["ids"]).cuda(), p["L"])
    v12 = torch.from_numpy(segsum_values(12, p["W"] * p["N"], 1)).cuda()
    ref = om.seg_sum_t(v12)
    profiling.set_tracing(True)
    try:
        profiling.drain()
        om.seg_sum_t(v12)
        om.seg_sum_t(v12)
        counts = profiling.drain().counts
    finally:
        profiling.set_tracing(False)
    assert counts.get("kernel.segsum") == 2
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        om.seg_sum_t(v12)
        torch.cuda.current_stream().synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = om.seg_sum_t(v12)
    graph.replay()
    torch.cuda.synchronize()
    held(out, ref, "inside a graph")
