"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip without a CUDA device (the kernels have
no CPU mode). This file imports no JAX, so it runs on a machine with only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.core import combiners as cb
from repro_torch.core import message as msg
from repro_torch.core import routing
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from repro_torch.kernels import ops, ref
from repro_torch.pregel.engine import Engine
from repro_torch.pregel.serve import QueryQueue


def bits_equal(a, b):
    """Bit-identical tensors (NaN payloads and -0.0 included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,m", [(8, (1 << 12) + 3), (31, 5000), (63, 100)])
def test_bucket_ranks_kernel_matches_plain(cuda, b, m):
    keys = torch.randint(0, b + 1, (3, m), dtype=torch.int32, device=cuda)
    rank, counts = ops.bucket_ranks(keys, b)
    want_r, want_c = ref.bucket_ranks_ref(keys, b)
    torch.cuda.synchronize()
    assert torch.equal(rank, want_r) and torch.equal(counts, want_c)


# One tile of the bucket kernels is 512 threads x 16 keys.
RANK_TILE = 8192


def _rank_keys(case, rows, m, b):
    """Keys of a named case, made on the CPU from a seed: cases where a
    chained scan over tiles can break."""
    g = torch.Generator().manual_seed(len(case) + m)
    if case == "hub":  # one bucket: ranks up to M - 1, a long tile chain
        return torch.full((rows, m), 3, dtype=torch.int32)
    if case == "sentinel":
        return torch.full((rows, m), b, dtype=torch.int32)
    keys = torch.randint(0, b + 1, (rows, m), generator=g, dtype=torch.int32)
    if case == "sorted":  # runs of 0, 1, ..., then the sentinel tail
        keys = torch.sort(keys, dim=1)[0]
        keys[:, m // 2:] = b
    elif case == "out of range":  # -1 and B + 3: rank 0, no count
        pick = torch.rand(rows, m, generator=g)
        keys[pick < 0.1] = -1
        keys[(pick >= 0.1) & (pick < 0.2)] = b + 3
    return keys


_RANK_CASES = [("hub", 2, (1 << 21) + 5, 8),
               ("sorted", 8, 3 * RANK_TILE + 17, 8),
               ("random", 8, 3 * RANK_TILE + 17, 8),
               ("sentinel", 3, RANK_TILE + 1, 8), ("random", 8, 1, 8),
               ("random", 1, RANK_TILE - 1, 8), ("random", 1, RANK_TILE, 8),
               ("random", 1, RANK_TILE + 1, 8), ("random", 3, 5000, 63),
               ("sorted", 1, 40 * RANK_TILE, 63),
               ("out of range", 4, 3 * RANK_TILE + 5, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,rows,m,b", _RANK_CASES)
def test_bucket_ranks_kernel_chain_cases(cuda, case, rows, m, b):
    """Exact against the plain version where the look-back can go wrong."""
    keys = _rank_keys(case, rows, m, b).to(cuda)
    rank, counts = ops.bucket_ranks(keys, b)
    want_r, want_c = ref.bucket_ranks_ref(keys, b)
    torch.cuda.synchronize()
    assert torch.equal(rank, want_r) and torch.equal(counts, want_c)
    if case == "out of range":
        assert not rank[(keys < 0) | (keys > b)].any()


def _lane_bits(keys, q, b, seed):
    """Membership, half the lanes of each real entry, none of a sentinel
    entry (the union route's contract); out-of-range entries carry bits."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(keys.shape + (q,), generator=g) < 0.5) & \
        (keys != b)[..., None]


_LANE_CASES = [(c, 4, 2 * RANK_TILE + 3, 8, q)
               for c in ("sorted", "random") for q in (1, 5, 16, 32, 33, 64)]
_LANE_CASES += [("hub", 1, (1 << 20) + 5, 8, 32),
                ("sentinel", 3, RANK_TILE + 1, 8, 32), ("random", 8, 1, 8, 32),
                ("random", 1, RANK_TILE + 1, 63, 7),
                ("random", 2, 100, 8, 0),
                ("out of range", 4, 3 * RANK_TILE + 5, 8, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,rows,m,b,q", _LANE_CASES)
def test_bucket_ranks_lanes_kernel_chain_cases(cuda, case, rows, m, b, q):
    """Exact against the plain version; rows 1 of the multi-row cases hold
    only sentinels."""
    keys = _rank_keys(case, rows, m, b)
    if rows > 1:
        keys[1] = b
    lanes = _lane_bits(keys, q, b, m).to(cuda)
    keys = keys.to(cuda)
    got = ops.bucket_ranks_lanes(keys, lanes, b)
    want = ref.bucket_ranks_lanes_ref(keys, lanes, b)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ROADMAP fault 11: shapes the narrow kernels refused. W = 64, 256, 1,024
# run the wide kernel with its counts in shared memory, W = 4,096 with
# them in global memory; 70,000 rows fold into the grid's x dimension.
_WIDE_CASES = [(c, rows, m, w) for w in (64, 256, 1024)
               for c, rows, m in (("sorted", 8, 3 * RANK_TILE + 17),
                                  ("random", 8, 3 * RANK_TILE + 17),
                                  ("random", 1, 40 * RANK_TILE + 3))]
_WIDE_CASES += [("sorted", 2, 5 * RANK_TILE + 1, 4096),
                ("random", 2, 5 * RANK_TILE + 1, 4096),
                ("hub", 1, 5 * RANK_TILE + 1, 1024),
                ("out of range", 3, 2 * RANK_TILE + 9, 256),
                ("random", 70_000, 1000, 8), ("sorted", 70_000, 1000, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,rows,m,b", _WIDE_CASES)
def test_bucket_ranks_kernel_takes_wide_and_tall_shapes(cuda, case, rows, m,
                                                        b):
    """Bit for bit against the plain version past 63 buckets and 65,535
    rows."""
    from repro_torch.kernels import bucket_route as kbucket

    keys = _rank_keys(case, rows, m, b).to(cuda)
    rank, counts = kbucket.bucket_ranks_cuda(keys, b)
    want_r, want_c = ref.bucket_ranks_ref(keys, b)
    torch.cuda.synchronize()
    assert torch.equal(rank, want_r) and torch.equal(counts, want_c)


_WIDE_LANE_CASES = [("random", 2, 2 * RANK_TILE + 3, 8, 1024),
                    ("sorted", 2, 2 * RANK_TILE + 3, 8, 1024),
                    ("random", 2, RANK_TILE + 3, 8, 4096),
                    ("random", 1, RANK_TILE + 3, 8, 6500),  # lanes global
                    ("random", 8, 3 * RANK_TILE + 17, 64, 32),
                    ("sorted", 8, 3 * RANK_TILE + 17, 64, 32),
                    ("random", 2, 2 * RANK_TILE + 1, 1024, 32),
                    ("random", 2, RANK_TILE + 1, 4096, 16),  # counts global
                    ("random", 70_000, 100, 8, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,rows,m,b,q", _WIDE_LANE_CASES)
def test_bucket_ranks_lanes_kernel_takes_wide_and_tall_shapes(cuda, case,
                                                              rows, m, b, q):
    """Bit for bit against the plain version: lane tiles past 32 KB (the
    opt-in), past the opt-in (global atomics), past 63 buckets and 65,535
    rows; the lane accumulator left zero for the next call."""
    from repro_torch.kernels import bucket_route as kbucket

    keys = _rank_keys(case, rows, m, b)
    lanes = _lane_bits(keys, q, b, m).to(cuda)
    keys = keys.to(cuda)
    for _ in range(2):  # the second call finds the accumulator zeroed
        got = kbucket.bucket_ranks_lanes_cuda(keys, lanes, b)
        want = ref.bucket_ranks_lanes_ref(keys, lanes, b)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    zero = kbucket.scratch_of(cuda).zero
    assert not zero.any()


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", [("sum", torch.float32),
                                        ("min", torch.int32)])
def test_segment_combine_kernel_takes_70000_rows(cuda, name, dtype):
    """Past 65,535 rows each block loops over rows; float32 sums within
    reassociation of the plain version, int32 min exact, and both bit for
    bit the two calls of at most 65,535 rows (one block a row) that the
    rows split into."""
    g = torch.Generator().manual_seed(11)
    rows, e, n = 70_000, 40, 24
    seg = torch.sort(torch.randint(0, n + 3, (rows, e), generator=g),
                     dim=1)[0].to(torch.int32)
    if dtype == torch.float32:
        vals = torch.rand(rows, e, generator=g)
    else:
        vals = torch.randint(-1000, 1000, (rows, e), generator=g,
                             dtype=torch.int32)
    vals, seg = vals.to(cuda), seg.to(cuda)
    got = ops.segment_combine(vals, seg, n, name)
    want = ref.segment_combine_ref(vals, seg, n, name)
    torch.cuda.synchronize()
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    half = rows // 2
    split = torch.cat([ops.segment_combine(vals[:half], seg[:half], n, name),
                       ops.segment_combine(vals[half:], seg[half:], n, name)])
    assert torch.equal(got, split)


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["wcc:basic", "sv:composed"])
@pytest.mark.parametrize("mode", ["host", "fused"])
def test_64_workers_on_the_card_match_the_cpu_run(cuda, key, mode):
    """W = 64 (65 buckets, the wide kernel) at scale 16: outputs,
    supersteps and bytes and msgs per channel equal the CPU's host run."""
    spec = REGISTRY[key]
    graph = spec.make_graph(16, 0)
    inputs = spec.inputs(graph, 0)
    tables = pgraph.partition_tables(graph, 64, "random", build=spec.build)
    cpu = Engine(mode="host", device="cpu").run(
        spec.factory(**inputs), pgraph.from_arrays(*tables, device="cpu"))
    pg = pgraph.from_arrays(*tables, device=cuda)
    ops.reset_launch_counts()
    card = Engine(mode=mode, device=cuda).run(spec.factory(**inputs), pg)
    np.testing.assert_array_equal(card.output, cpu.output)
    assert (card.steps, card.halted) == (cpu.steps, cpu.halted)
    assert card.bytes_by_channel == cpu.bytes_by_channel
    assert card.msgs_by_channel == cpu.msgs_by_channel
    spec.check(graph, pg, card, inputs)
    assert ops.launch_counts()["bucket_ranks"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case,pad,q,dtype", [
    ("random", 1, 32, torch.bool), ("sorted", 16, 32, torch.bool),
    ("random", 16, 32, torch.uint8), ("random", 16, 5, torch.bool),
    ("random", 3, 64, torch.bool)])
def test_bucket_ranks_lanes_kernel_reads_rows_in_place(cuda, case, pad, q,
                                                      dtype):
    """Membership rows that lie apart, as the union CombinedMessage leaves
    them (a slice of a (rows, M * Q + pad) buffer), read where they lie,
    aligned for 16-byte loads or not; uint8 0/1 membership as bool. Exact."""
    keys = _rank_keys(case, 4, 2 * RANK_TILE + 3, 8)
    rows, m = keys.shape
    buf = torch.zeros(rows, m * q + pad, dtype=dtype)
    buf[:, :m * q] = _lane_bits(keys, q, 8, pad).reshape(rows, m * q)
    lanes = buf.to(cuda)[:, :m * q].reshape(rows, m, q)
    assert not lanes.is_contiguous()
    keys = keys.to(cuda)
    got = ops.bucket_ranks_lanes(keys, lanes, 8)
    want = ref.bucket_ranks_lanes_ref(keys, lanes, 8)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.gpu
def test_bucket_kernels_are_bit_identical_over_50_launches(cuda):
    """50 launches of each kernel, two shapes in turn, so every call meets
    status words and a ticket left by a call of another shape: the epoch
    and the zero-restored scratch must keep them apart."""
    small = _rank_keys("random", 8, 3 * RANK_TILE + 17, 8).to(cuda)
    big = _rank_keys("random", 8, 40 * RANK_TILE + 1, 8).to(cuda)
    lanes = _lane_bits(small.cpu(), 32, 8, 1).to(cuda)
    first = {}
    for i in range(50):
        for name, keys in (("small", small), ("big", big)):
            got = ops.bucket_ranks(keys, 8)
            first.setdefault(name, got)
            assert all(torch.equal(a, w) for a, w in zip(got, first[name]))
        got = ops.bucket_ranks_lanes(small, lanes, 8)
        first.setdefault("lanes", got)
        assert all(torch.equal(a, w) for a, w in zip(got, first["lanes"]))
    torch.cuda.synchronize()
    for name, keys in (("small", small), ("big", big)):
        want = ref.bucket_ranks_ref(keys, 8)
        assert all(torch.equal(a, w) for a, w in zip(first[name], want))
    want = ref.bucket_ranks_lanes_ref(small, lanes, 8)
    assert all(torch.equal(a, w) for a, w in zip(first["lanes"], want))


# One tile of the segment kernel is 256 threads x 8 entries.
TILE = 2048


def _segment_case(case, dtype, dev):
    """(vals, seg, n) of a named case, made on the CPU from a seed. Values
    of the long sums are small integers, so a float32 sum is exact in any
    order."""
    g = torch.Generator().manual_seed(len(case))
    d = {"random": 3, "d5": 5, "gaps": 3}.get(case, 1)
    if case in ("random", "d1", "d5"):
        rows, e, n = 4, 3000, 64
        seg = torch.sort(torch.randint(0, 70, (rows, e), generator=g))[0]
    elif case == "hub":  # one segment over 110 tiles in row 0
        rows, e, n = 2, 120 * TILE + 77, 50
        seg = torch.sort(torch.randint(0, n, (rows, e), generator=g))[0]
        seg[0, 5 * TILE + 3:115 * TILE + 9] = seg[0, 5 * TILE + 3]
        seg = torch.sort(seg)[0]
    elif case == "dropped":  # every id outside [0, n)
        rows, e, n = 3, 5 * TILE + 1, 64
        seg = torch.where(torch.rand(rows, e, generator=g) < 0.3, -4, n + 2)
        seg = torch.sort(seg)[0]
    elif case == "n1":
        rows, e, n = 3, 3 * TILE + 5, 1
        seg = torch.sort(torch.randint(-1, 3, (rows, e), generator=g))[0]
    elif case == "gaps":  # gaps of 1..9000 empty segments at tile edges
        rows, e, n = 2, 6 * TILE, 60000
        pos = torch.arange(e)
        seg = (pos // TILE) * 9000 + (pos % TILE) // 300 * 7
        seg = seg.expand(rows, e).clone()
        seg[1] += 11
    elif case == "tail":  # the real entries, then half the row as pad n
        rows, e, n = 3, 40 * TILE, 30000
        real = torch.sort(torch.randint(0, n // 2, (rows, e // 2),
                                        generator=g))[0]
        seg = torch.cat([real, torch.full((rows, e // 2), n)], dim=1)
    elif case == "nan_inf":
        rows, e, n = 2, 3 * TILE, 500
        seg = torch.sort(torch.randint(0, n, (rows, e), generator=g))[0]
    else:  # "wrap": int32 sums that overflow
        rows, e, n = 2, 4 * TILE, 40
        seg = torch.sort(torch.randint(0, n, (rows, e), generator=g))[0]
    shape = (rows, e, d)
    if case == "wrap":
        vals = torch.randint(2**30, 2**31 - 1, shape, generator=g,
                             dtype=torch.int32)
    elif dtype == torch.bool:
        vals = torch.rand(shape, generator=g) < 0.2
    elif case in ("hub", "tail", "gaps", "n1", "dropped") or \
            dtype == torch.int32:
        vals = torch.randint(-99, 99, shape, generator=g).to(dtype)
    else:
        vals = torch.randn(shape, generator=g)
    if case == "nan_inf":
        pick = torch.rand(shape, generator=g)
        vals[pick < 0.01] = float("nan")
        vals[(pick >= 0.01) & (pick < 0.05)] = float("inf")
        vals[(pick >= 0.05) & (pick < 0.09)] = -float("inf")
    return vals.to(dev), seg.to(torch.int32).to(dev), n


_SEG_CASES = [("random", "sum", torch.float32), ("random", "min", torch.float32),
              ("random", "max", torch.float32), ("random", "sum", torch.int32),
              ("random", "min", torch.int32), ("random", "or", torch.bool)]
_SEG_CASES += [(c, name, torch.float32)
               for c in ("hub", "dropped", "n1", "gaps", "tail", "d1", "d5")
               for name in ("sum", "min", "max")]
_SEG_CASES += [("hub", "sum", torch.int32), ("gaps", "max", torch.int32),
               ("dropped", "or", torch.bool), ("tail", "or", torch.bool),
               ("nan_inf", "min", torch.float32),
               ("nan_inf", "max", torch.float32),
               ("wrap", "sum", torch.int32), ("d5", "sum", torch.int32),
               ("d5", "min", torch.int32), ("d5", "or", torch.bool)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,name,dtype", _SEG_CASES)
def test_segment_combine_kernel_matches_plain(cuda, case, name, dtype):
    vals, seg, n = _segment_case(case, dtype, cuda)
    got = ops.segment_combine(vals, seg, n, name)
    want = ref.segment_combine_ref(vals, seg, n, cb.get(name))
    torch.cuda.synchronize()
    if name == "sum" and dtype == torch.float32:
        # reassociation only: another summation order than index_add
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        again = ops.segment_combine(vals, seg, n, name)
        assert torch.equal(got, again), "two launches differ"
    else:  # exact; NaN where the plain version has NaN
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_segment_combine_kernel_takes_a_long_square_row(cuda):
    """E = N = 2^20 in one row launches (a 512-tile grid row)."""
    e = 1 << 20
    seg = torch.arange(e, dtype=torch.int32, device=cuda) // 3 * 2
    vals = torch.ones(1, e, device=cuda)
    got = ops.segment_combine(vals, seg[None], e, "sum")
    want = ref.segment_combine_ref(vals, seg[None], e, cb.SUM)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_route_refuses_the_sort_baseline_on_the_card(cuda):
    dst = torch.randint(0, 64, (4, 100), dtype=torch.int32, device=cuda)
    valid = torch.ones_like(dst, dtype=torch.bool)
    ctx = ChannelContext(4, 16, cuda)
    with pytest.raises(ValueError, match="sort"):
        routing.route(ctx, dst, valid, {}, 100, impl="sort")
    before = ops.launch_counts()["bucket_ranks"]
    routing.route(ctx, dst, valid, {}, 100)
    assert ops.launch_counts()["bucket_ranks"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,q", [(8, (1 << 12) + 3, 32), (31, 5000, 5),
                                   (63, 100, 1), (8, 3000, 33)])
def test_bucket_ranks_lanes_kernel_matches_plain(cuda, b, m, q):
    """Exact: integer counts, integer atomics. Sentinel rows carry no
    lane bits, as the union route guarantees."""
    keys = torch.randint(0, b + 1, (3, m), dtype=torch.int32, device=cuda)
    lanes = (torch.rand(3, m, q, device=cuda) < 0.4) & (keys < b)[..., None]
    rank, counts, lane_counts = ops.bucket_ranks_lanes(keys, lanes, b)
    want = ref.bucket_ranks_lanes_ref(keys, lanes, b)
    torch.cuda.synchronize()
    assert torch.equal(rank, want[0]) and torch.equal(counts, want[1])
    assert torch.equal(lane_counts, want[2])


@pytest.mark.gpu
def test_batched_combined_send_launches_the_lanes_kernel(cuda):
    w, n_loc, q, m = 4, 16, 3, 50
    ctx = ChannelContext(w, n_loc, cuda, num_queries=q)
    dst = torch.randint(0, w * n_loc, (w, m), dtype=torch.int32, device=cuda)
    valid = torch.rand(w, q, m, device=cuda) < 0.5
    vals = torch.rand(w, q, m, device=cuda)
    before = ops.launch_counts()
    out, got, ovf = msg.combined_send(ctx, dst, valid, vals, "min",
                                      capacity=n_loc)
    after = ops.launch_counts()
    assert after["bucket_ranks_lanes"] == before["bucket_ranks_lanes"] + 1
    assert after["bucket_ranks"] == before["bucket_ranks"]
    assert out.shape == (w, q, n_loc) and not ovf.any()


@pytest.mark.gpu
def test_use_kernel_false_with_cuda_tensors_raises(cuda):
    keys = torch.zeros(4, 10, dtype=torch.int32, device=cuda)
    lanes = torch.zeros(4, 10, 2, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="use_kernel=False with a CUDA"):
        ops.bucket_ranks_lanes(keys, lanes, 4, use_kernel=False)
    with pytest.raises(ValueError, match="use_kernel=False with a CUDA"):
        ops.bucket_ranks(keys, 4, use_kernel=False)


INT32_MAX, INT32_MIN = 2**31 - 1, -2**31


def _sv_min_case(plan, n_loc, side, case):
    """(vals, seg, n) of the S-V neighbour minimum's int32 ``min`` on a
    scatter plan (CPU tensors): the sender side (per-edge values into
    ``u_cap`` segments) or the receiver side (the received wire in
    ``recv_order`` into ``n_loc`` segments). ``ids``: vertex ids;
    ``extremes``: INT32_MAX (what pads carry) and INT32_MIN among them;
    ``hub``: row 0 one segment; ``dropped``: every id out of range."""
    g = torch.Generator().manual_seed(len(case) + len(side))
    if side == "send":
        seg, n = plan.edge_seg.clone(), plan.u_cap
    else:
        seg, n = plan.recv_sorted.clone(), n_loc
    shape = seg.shape + (1,)
    vals = torch.randint(0, plan.num_workers * n_loc, shape, generator=g,
                         dtype=torch.int32)
    if case == "extremes":
        pick = torch.rand(shape, generator=g)
        vals[pick < 0.3] = INT32_MAX
        vals[(pick >= 0.3) & (pick < 0.4)] = INT32_MIN
    elif case == "hub":
        seg[0] = 0
    elif case == "dropped":
        seg[:] = n
    return vals, seg, n


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ids", "extremes", "hub", "dropped"])
@pytest.mark.parametrize("side", ["send", "recv"])
def test_segment_combine_int32_min_on_the_sv_plan(cuda, side, case):
    """The S-V neighbour minimum's combine: exact against plain."""
    spec = REGISTRY["sv:composed"]
    pg = pgraph.partition_graph(spec.make_graph(10, 0), 8, "random",
                                build=spec.build, device="cpu")
    vals, seg, n = _sv_min_case(pg.scatter_out, pg.n_loc, side, case)
    want = ref.segment_combine_ref(vals, seg, n, cb.MIN)
    got = ops.segment_combine(vals.to(cuda), seg.to(cuda), n, "min")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if case == "dropped":
        assert (want == INT32_MAX).all()


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["sv:composed", "pj:reqresp"])
def test_slice_on_the_card_matches_the_cpu_run(cuda, key):
    """Scale 10, W = 8, the same plan on both devices: labels, supersteps
    and per-channel counts identical; the run launches the kernels."""
    spec = REGISTRY[key]
    graph = spec.make_graph(10, 0)
    inputs = spec.inputs(graph, 0)
    tables = pgraph.partition_tables(graph, 8, "random", build=spec.build)
    runs = {}
    for dev in ("cpu", "cuda"):
        pg = pgraph.from_arrays(*tables, device=dev)
        ops.reset_launch_counts()
        runs[dev] = Engine(mode="host", device=dev).run(
            spec.factory(**inputs), pg)
        launches = ops.launch_counts()
    cpu, card = runs["cpu"], runs["cuda"]
    np.testing.assert_array_equal(card.output, cpu.output)
    assert (card.steps, card.halted) == (cpu.steps, cpu.halted)
    assert card.bytes_by_channel == cpu.bytes_by_channel
    assert card.msgs_by_channel == cpu.msgs_by_channel
    spec.check(graph, pg, card, inputs)
    assert launches["bucket_ranks"] > 0
    if key == "sv:composed":
        assert launches["segment_combine"] > 0


def _by_first_case(case, dtype, d, dev):
    """(vals, seg, n) of a ``min_by_first`` case, made on the CPU from a
    seed: keys in column 0, payload in the rest. ``ties``: small integer
    keys, so most segments hold several equal minima (the last one must
    win); ``hub``: row 0 one segment over 110 tiles whose keys all tie;
    ``special``: +-inf and NaN keys (a NaN that opens its segment wins
    it, any other loses); ``dropped``: every id out of range."""
    g = torch.Generator().manual_seed(len(case) + d)
    rows, e, n = 4, 3 * TILE + 77, 500
    if case == "hub":
        rows, e, n = 2, 120 * TILE + 77, 50
    seg = torch.sort(torch.randint(0, n + 3, (rows, e), generator=g))[0]
    if case == "hub":
        seg[0] = 7
    elif case == "dropped":
        seg = torch.where(torch.rand(rows, e, generator=g) < 0.3, -4, n + 2)
        seg = torch.sort(seg)[0]
    vals = torch.randint(-999, 999, (rows, e, d), generator=g).to(dtype)
    vals[..., 0] = torch.randint(0, 4, (rows, e), generator=g).to(dtype)
    if case == "hub":
        vals[0, :, 0] = 2
    if case == "special" and dtype == torch.float32:
        pick = torch.rand(rows, e, generator=g)
        key = vals[..., 0]
        key[pick < 0.05] = float("nan")
        key[(pick >= 0.05) & (pick < 0.1)] = float("inf")
        key[(pick >= 0.1) & (pick < 0.15)] = -float("inf")
        key[(pick >= 0.15) & (pick < 0.2)] = -0.0
    return vals.to(dev), seg.to(torch.int32).to(dev), n


_BY_FIRST_CASES = [(c, dt, d) for c in ("ties", "hub", "dropped")
                   for dt in (torch.float32, torch.int32) for d in (1, 4)]
_BY_FIRST_CASES += [("special", torch.float32, d) for d in (1, 3, 4, 5)]
_BY_FIRST_CASES += [("ties", torch.float32, 3), ("ties", torch.int32, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype,d", _BY_FIRST_CASES)
def test_segment_combine_min_by_first_matches_plain(cuda, case, dtype, d):
    """Bit-exact against the plain sorted scan (``core.segmented``):
    the winner's whole row, later entries winning ties, empty segments
    ``identity_like`` (key +inf or INT32_MAX, payload 0)."""
    vals, seg, n = _by_first_case(case, dtype, d, cuda)
    got = ops.segment_combine(vals, seg, n, "min_by_first")
    want = ref.segment_combine_ref(vals, seg, n, cb.MIN_BY_FIRST)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (vals.shape[0], n, d)
    assert bits_equal(got, want)
    if case == "hub":  # all keys tie: the row's last entry wins
        last = (seg[0] == 7).nonzero().max()
        assert torch.equal(got[0, 7], vals[0, last])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "hub", "dropped", "d5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_segment_combine_prod_matches_plain(cuda, case, dtype):
    """int32 exact (wrapping); float32 within rtol 1e-4 — reassociation
    of products of values in [0.99, 1.01], up to 2^17 of them a segment
    in the hub case (each rounding at most 2^-24 relative)."""
    vals, seg, n = _segment_case(case, torch.float32, cuda)
    g = torch.Generator().manual_seed(3)
    if dtype == torch.int32:
        vals = torch.randint(-3, 4, vals.shape, generator=g,
                             dtype=torch.int32).to(cuda)
    else:
        vals = (0.99 + 0.02 * torch.rand(vals.shape, generator=g)).to(cuda)
    got = ops.segment_combine(vals, seg, n, "prod")
    want = ref.segment_combine_ref(vals, seg, n, cb.PROD)
    torch.cuda.synchronize()
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sum", "min_by_first"])
def test_order_sensitive_combined_send_is_bit_identical(cuda, name):
    """A float CombinedMessage with many values a destination (every
    worker sends 4000 values to 37 vertices) twice on the card: the two
    results are bit-identical, and each send ran the kernel on both
    sides (no float atomics)."""
    w, n_loc, m = 4, 64, 4000
    ctx = ChannelContext(w, n_loc, cuda)
    g = torch.Generator().manual_seed(9)
    dst = torch.randint(0, 37, (w, m), generator=g, dtype=torch.int32)
    d = 1 if name == "sum" else 4
    vals = torch.rand(w, m, d, generator=g)
    vals[..., 0] = torch.randint(0, 50, (w, m), generator=g).float()
    dst, vals = dst.to(cuda), vals.to(cuda)
    valid = torch.ones_like(dst, dtype=torch.bool)
    runs = []
    for _ in range(2):
        before = ops.launch_counts()["segment_combine"]
        runs.append(msg.combined_send(ctx, dst, valid, vals, name,
                                      capacity=n_loc))
        assert ops.launch_counts()["segment_combine"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    want = msg.combined_send(ChannelContext(w, n_loc, "cpu"), dst.cpu(),
                             valid.cpu(), vals.cpu(), name, capacity=n_loc)
    if name == "sum":
        torch.testing.assert_close(runs[0][0].cpu(), want[0], rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.equal(runs[0][0].cpu(), want[0])
    assert torch.equal(runs[0][1].cpu(), want[1])


@pytest.mark.gpu
def test_order_sensitive_dispatch_refuses_use_kernel_false(cuda):
    vals = torch.rand(2, 10, 1, device=cuda)
    seg = torch.zeros(2, 10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="use_kernel=False with a CUDA"):
        ops.segment_reduce(vals, seg, 3, "sum", use_kernel=False)
    # lattice combiners keep the plain scatter reduction on the card
    out = ops.segment_reduce(vals, seg, 3, "min", use_kernel=False)
    assert torch.equal(out, ref.segment_combine_ref(vals, seg, 3, "min"))


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["pagerank:basic", "msf:channels",
                                 "msf:monolithic"])
def test_new_programs_on_the_card(cuda, key):
    """Scale 10, W = 8, the same plan on both devices: supersteps and
    per-channel counts identical, the registry oracle holds on the card,
    two card runs bit-identical, and the run launched both kernels."""
    spec = REGISTRY[key]
    graph = spec.make_graph(10, 0)
    tables = pgraph.partition_tables(graph, 8, "random", build=spec.build)
    knobs = {"iters": 10} if key.startswith("pagerank") else {}
    cpu_pg = pgraph.from_arrays(*tables, device="cpu")
    cpu = Engine(mode="host", device="cpu").run(spec.factory(**knobs), cpu_pg)
    pg = pgraph.from_arrays(*tables, device="cuda")
    ops.reset_launch_counts()
    card = Engine(mode="host", device="cuda").run(spec.factory(**knobs), pg)
    launches = ops.launch_counts()
    again = Engine(mode="host", device="cuda").run(spec.factory(**knobs), pg)
    assert (card.steps, card.halted) == (cpu.steps, cpu.halted)
    assert card.bytes_by_channel == cpu.bytes_by_channel
    assert card.msgs_by_channel == cpu.msgs_by_channel
    spec.check(graph, pg, card, {})
    for name, x in card.state.items():
        assert torch.equal(x, again.state[name]), name
    assert launches["bucket_ranks"] > 0 and launches["segment_combine"] > 0
    if key.startswith("msf"):
        np.testing.assert_array_equal(card.output["labels"],
                                      cpu.output["labels"])
        assert card.output["edges"] == cpu.output["edges"]


def _long_gap_case(seed, rows, n, d, dtype):
    """Ids from two narrow bands of a wide id space — long gaps of empty
    segments in the middle and at the end of each row, longer than the
    kernel's two-chunk limit, so their whole chunks are stored by its
    second pass — plus a dropped tail."""
    g = torch.Generator().manual_seed(seed)
    e = 6000
    seg = torch.cat([torch.randint(0, 3000, (rows, e // 2), generator=g),
                     torch.randint(n // 2, n // 2 + 3000, (rows, e // 4),
                                   generator=g),
                     torch.full((rows, e // 4), n)], dim=1)
    seg = torch.sort(seg, dim=1)[0].to(torch.int32)
    vals = torch.randint(-50, 50, (rows, e, d), generator=g).to(dtype)
    return vals, seg


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,d", [
    ("min_by_first", torch.float32, 4), ("min_by_first", torch.int32, 3),
    ("min_by_first", torch.float32, 1), ("sum", torch.float32, 1),
    ("min", torch.int32, 3), ("prod", torch.float32, 4),
    ("max", torch.float32, 5)])
def test_segment_combine_long_gaps(cuda, name, dtype, d):
    """Rows whose empty segments form gaps of up to 10^6 output elements:
    exact against plain (small-integer values: every order gives the
    same float sums and products), in three launches of two shapes in
    turn, so a launch meets the chunk marks of an earlier one."""
    first = _long_gap_case(1, 3, 1 << 20, d, dtype)
    other = _long_gap_case(2, 5, 300_000, d, dtype)
    for vals, seg in (first, other, first):
        vals, seg = vals.to(cuda), seg.to(cuda)
        n = int(seg.max())
        if name == "prod":
            vals = torch.where(vals > 0, 1.0, -1.0).to(dtype)
        got = ops.segment_combine(vals, seg, n, name)
        want = ref.segment_combine_ref(vals, seg, n, cb.get(name))
        torch.cuda.synchronize()
        assert bits_equal(got, want)
    dropped = torch.full_like(seg, n)
    got = ops.segment_combine(vals, dropped, n, name)
    assert bits_equal(got, ref.segment_combine_ref(vals, dropped, n,
                                                   cb.get(name)))



def _prop_min_case(pg, side):
    """(vals, seg, n) of the Propagation channel's int32 ``min`` on the
    ``wcc:prop`` plan (CPU tensors), as its first round hands them to the
    kernel: ``int_dst`` the local fixpoint (vertex ids gathered by
    ``int_src`` into n_loc segments), ``cut_send`` the cut plan's sender
    (by ``edge_src`` into ``u_cap``), ``cut_recv`` its receiver (random
    ids on the wire, in ``recv_order``, into n_loc)."""
    plan = pg.prop_out
    ids = pg.global_ids()
    if side == "int_dst":
        return (ids.gather(1, plan.int_src.long())[..., None], plan.int_dst,
                pg.n_loc)
    if side == "cut_send":
        return (ids.gather(1, plan.cut.edge_src.long())[..., None],
                plan.cut.edge_seg, plan.cut.u_cap)
    g = torch.Generator().manual_seed(3)
    vals = torch.randint(0, pg.n_pad, plan.cut.recv_sorted.shape + (1,),
                         generator=g, dtype=torch.int32)
    return vals, plan.cut.recv_sorted, pg.n_loc


@pytest.mark.gpu
@pytest.mark.parametrize("side", ["int_dst", "cut_send", "cut_recv"])
def test_segment_combine_int32_min_on_the_prop_plan(cuda, side):
    """The propagation fixpoint's and cut exchange's combines: ids sorted
    at plan build, no sort at run time, exact against plain."""
    spec = REGISTRY["wcc:prop"]
    pg = pgraph.partition_graph(spec.make_graph(12, 0), 8, "random",
                                build=spec.build, device="cpu")
    vals, seg, n = _prop_min_case(pg, side)
    assert bool((seg[:, 1:] >= seg[:, :-1]).all())
    want = ref.segment_combine_ref(vals, seg, n, cb.MIN)
    ops.reset_launch_counts()
    got = ops.segment_combine(vals.to(cuda), seg.to(cuda), n, "min")
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_combine"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("key,mirror", [
    ("wcc:prop", None), ("wcc:prop", 16), ("sssp:prop", None),
    ("scc:basic", None), ("scc:prop", None)])
def test_prop_programs_on_the_card(cuda, key, mirror):
    """Scale 10, W = 8, the same plan on both devices: outputs,
    supersteps, per-channel counts and per-worker iterations identical,
    the registry oracle holds on the card, and the run launched the
    segment kernel (and the bucket kernel for ``scc:basic``)."""
    spec = REGISTRY[key]
    graph = spec.make_graph(10, 0)
    inputs = spec.inputs(graph, 0)
    tables = pgraph.partition_tables(graph, 8, "random", build=spec.build,
                                     mirror_threshold=mirror)
    cpu = Engine(mode="host", device="cpu").run(
        spec.factory(**inputs), pgraph.from_arrays(*tables, device="cpu"))
    pg = pgraph.from_arrays(*tables, device="cuda")
    ops.reset_launch_counts()
    card = Engine(mode="host", device="cuda").run(spec.factory(**inputs), pg)
    launches = ops.launch_counts()
    np.testing.assert_array_equal(card.output, cpu.output)
    assert (card.steps, card.halted) == (cpu.steps, cpu.halted)
    assert card.bytes_by_channel == cpu.bytes_by_channel
    assert card.msgs_by_channel == cpu.msgs_by_channel
    counter = "iters" if key.startswith("scc") else "info"
    assert torch.equal(card.state[counter].cpu(), cpu.state[counter])
    spec.check(graph, pg, card, inputs)
    assert launches["segment_combine"] > 0
    assert (launches["bucket_ranks"] > 0) == (key == "scc:basic")
    if mirror is not None:
        assert pg.prop_out.cut.hub_cap > 0


def _replays(fn, statics, fresh, plain, replays=3):
    """Capture ``fn()`` (over the ``statics`` tensors) into a CUDA graph
    under a scratch scope, after one warm-up call that sizes the scratch,
    then replay it ``replays`` times, each time with ``fresh(r)`` copied
    into the statics: every replay must equal ``plain`` of its inputs —
    what a frozen epoch or a stale mark would break."""
    from repro_torch.kernels import scratch

    token = ("gpu-test", id(fn))
    try:
        with scratch.scope(token):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
        for r in range(replays):
            inputs = fresh(r)
            for st, x in zip(statics, inputs):
                st.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            want = plain(*inputs)
            got = out if isinstance(out, tuple) else (out,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(bits_equal(a, b) for a, b in zip(got, want)), r
    finally:
        scratch.release(token)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [False, True])
def test_bucket_kernels_replay_in_a_captured_graph(cuda, lanes):
    """The look-back's epoch is read and advanced on the device, so three
    replays of one captured call, each on fresh keys, rank them right."""
    rows, m, b, q = 8, 40 * RANK_TILE + 1, 8, 32
    keys = torch.zeros((rows, m), dtype=torch.int32, device=cuda)
    member = torch.zeros((rows, m, q), dtype=torch.bool, device=cuda)

    def fresh(r):
        k = _rank_keys("random", rows, m, b)
        k = k.roll(r * 4097, dims=1).to(cuda)
        return (k, _lane_bits(k.cpu(), q, b, r).to(cuda))

    if lanes:
        _replays(lambda: ops.bucket_ranks_lanes(keys, member, b),
                 (keys, member), fresh,
                 lambda k, ln: ref.bucket_ranks_lanes_ref(k, ln, b))
    else:
        _replays(lambda: ops.bucket_ranks(keys, b), (keys,),
                 lambda r: fresh(r)[:1],
                 lambda k: ref.bucket_ranks_ref(k, b))


def _gap_ids(rows, e, n, seed):
    """Sorted ids with a long empty gap whose place moves with the seed:
    the first half in a window near 0, the rest near a seeded point past
    it, so the kernel marks whole chunks of the gap for its fill pass."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.randint(0, 200, (rows, e // 2), generator=g)
    start = int(torch.randint(n // 4, n - 400, (1,), generator=g))
    hi = torch.randint(start, start + 300, (rows, e - e // 2), generator=g)
    return torch.cat([lo, hi], 1).sort(dim=1).values.to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,d", [("min", torch.int32, 1),
                                          ("min_by_first", torch.float32, 4),
                                          ("sum", torch.float32, 32)])
def test_segment_combine_replays_in_a_captured_graph(cuda, name, dtype, d):
    """The chunk table's marks are cleared by the launch that set them, so
    three replays, each with the empty gap elsewhere, fill only their own
    gap with the identity."""
    rows, e, n = 4, 3 * TILE + 5, 200_000
    vals = torch.zeros((rows, e, d), dtype=dtype, device=cuda)
    seg = torch.zeros((rows, e), dtype=torch.int32, device=cuda)

    def fresh(r):
        g = torch.Generator().manual_seed(10 + r)
        v = (torch.randint(-1000, 1000, (rows, e, d), generator=g)
             .to(dtype))
        return (v.to(cuda), _gap_ids(rows, e, n, r).to(cuda))

    _replays(lambda: ops.segment_combine(vals, seg, n, name), (vals, seg),
             fresh, lambda v, s: ref.segment_combine_ref(v, s, n, name))


@pytest.mark.gpu
def test_bucket_epoch_wraps_on_the_device(cuda):
    """Four calls across the epoch limit: each exact, the call at the limit
    leaves every status word zero, and the epoch starts its lap again."""
    from repro_torch.kernels import bucket_route as kbucket
    from repro_torch.kernels import scratch

    keys = _rank_keys("random", 8, 9 * RANK_TILE + 3, 8).to(cuda)
    want = ref.bucket_ranks_ref(keys, 8)
    limit = kbucket.epoch_limit()
    token = ("gpu-test", "wrap")
    try:
        with scratch.scope(token):
            ops.bucket_ranks(keys, 8)
            sc = kbucket.scratch_of(cuda)
            torch.cuda.synchronize()
            sc.ctrl[0] = (limit - 2) << 32  # the next call runs limit - 1
            for call in range(4):
                got = ops.bucket_ranks(keys, 8)
                torch.cuda.synchronize()
                assert all(torch.equal(a, w) for a, w in zip(got, want))
                if call == 1:  # the call at the limit
                    assert not sc.status.any()
            assert int(sc.ctrl[0]) == 2 << 32 and int(sc.ctrl[1]) == 0
    finally:
        scratch.release(token)


@pytest.mark.gpu
def test_kernels_count_their_launches_on_the_device(cuda):
    """Each launch adds one to its kernel's count on the device, eager or
    replayed from a captured graph, as each wrapper call adds one to its
    host count."""
    g = torch.Generator(device="cpu").manual_seed(3)
    keys = torch.randint(0, 9, (4, 5000), generator=g).to(cuda, torch.int32)
    vals = torch.rand(4, 5000, generator=g).to(cuda)
    seg = torch.sort(torch.randint(0, 700, (4, 5000), generator=g),
                     dim=-1).values.to(cuda, torch.int32)

    def calls():
        ops.bucket_ranks(keys, 8)
        ops.bucket_ranks(keys, 8)
        ops.segment_combine(vals, seg, 700, "min")

    before = ops.device_launch_counts()
    ops.reset_launch_counts()
    calls()
    after = ops.device_launch_counts()
    assert ops.launch_counts() == {"bucket_ranks": 2,
                                   "bucket_ranks_lanes": 0,
                                   "segment_combine": 1}
    assert {k: after[k] - before[k] for k in after} == {
        "bucket_ranks": 2, "bucket_ranks_lanes": 0, "segment_combine": 1,
        "segment_combine_join": 1}
    from repro_torch.kernels import scratch

    token = ("gpu-test", "launch counts")
    side = torch.cuda.Stream(cuda)
    graph = torch.cuda.CUDAGraph()
    try:
        with scratch.scope(token):
            side.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(side):
                calls()  # sizes the scope's scratch before the capture
            torch.cuda.current_stream(cuda).wait_stream(side)
            with torch.cuda.graph(graph):
                calls()
        before = ops.device_launch_counts()
        for _ in range(3):
            graph.replay()
        after = ops.device_launch_counts()
    finally:
        del graph
        scratch.release(token)
    assert {k: after[k] - before[k] for k in after} == {
        "bucket_ranks": 6, "bucket_ranks_lanes": 0, "segment_combine": 3,
        "segment_combine_join": 3}


def _counting_loops(nest, go, n, out):
    """Under an IF node on ``go``: a WHILE that counts to ``n[0]``; a WHILE
    of ``n[1]`` rounds holding a WHILE of ``n[2]`` iterations, counting
    both; a WHILE whose condition is false on entry. The four counts go
    to ``out``."""
    with nest.if_node(go):
        a = torch.zeros((), dtype=torch.int32, device=go.device)
        more_a = a < n[0]
        with nest.while_node(more_a):
            a.add_(1)
            more_a.copy_(a < n[0])
        rounds = torch.zeros_like(a)
        inner = torch.zeros_like(a)
        more_r = rounds < n[1]
        with nest.while_node(more_r):
            j = torch.zeros_like(a)
            more_j = j < n[2]
            with nest.while_node(more_j):
                j.add_(1)
                inner.add_(1)
                more_j.copy_(j < n[2])
            rounds.add_(1)
            more_r.copy_(rounds < n[1])
        z = torch.zeros_like(a)
        never = z > 0
        with nest.while_node(never):
            z.add_(1)
            never.copy_(z < 100)
        out.copy_(torch.stack([a, rounds, inner, z]))


@pytest.mark.gpu
def test_while_nodes_nest_in_a_captured_graph(cuda):
    """One captured graph: a WHILE inside an IF, a WHILE inside a WHILE
    inside an IF, and a zero-trip WHILE, replayed from fresh inputs: each
    loop runs exactly as often as its condition says, and a false IF runs
    none of them."""
    from repro_torch.kernels import graph_if

    go = torch.ones((), dtype=torch.bool, device=cuda)
    n = torch.zeros(3, dtype=torch.int32, device=cuda)
    out = torch.zeros(4, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    nest = graph_if.Nest(cuda)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream(cuda))
    try:
        with torch.cuda.graph(graph, stream=side):
            try:
                _counting_loops(nest, go, n, out)
            finally:
                nest.close()
        assert len(nest.streams) == 3  # IF body, rounds, iterations
        for trips, run in (((5, 3, 7), True), ((1, 6, 0), True),
                           ((2, 2, 2), False), ((64, 1, 33), True)):
            n.copy_(torch.tensor(trips, dtype=torch.int32))
            go.fill_(run)
            out.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            a, r, j = trips
            want = [a, r, r * j, 0] if run else [-1] * 4
            assert out.tolist() == want, (trips, run)
    finally:
        del graph
        nest.release()


def _device_mode_against_host(cuda, key, mode, k, scale):
    """The captured loop against the host loop on one card at ``scale``,
    W = 8 — outputs, supersteps, halts, per-channel counts and kernel
    launches identical (the runtime's counts for its replays, and the
    kernels' own counts on the device); a second run is a cache hit and
    leaves the first result as it was."""
    spec = REGISTRY[key]
    graph = spec.make_graph(scale, 0)
    inputs = spec.inputs(graph, 0)
    pg = pgraph.partition_graph(graph, 8, "random", build=spec.build)
    ops.reset_launch_counts()
    host = Engine(mode="host", device=cuda).run(spec.factory(**inputs), pg)
    host_launches = ops.launch_counts()
    eng = Engine(mode=mode, chunk_size=k, device=cuda)
    prog = spec.factory(**inputs)
    ops.reset_launch_counts()
    res = eng.run(prog, pg)
    assert ops.launch_counts() == host_launches
    first = {name: v.clone() for name, v in res.state.items()}
    again = eng.run(prog, pg)
    assert again.cache_hit and not res.cache_hit and eng.compiles == 1
    for run in (res, again):
        assert (run.steps, run.halted) == (host.steps, host.halted)
        assert run.bytes_by_channel == host.bytes_by_channel
        assert run.msgs_by_channel == host.msgs_by_channel
        assert all(bits_equal(run.state[n], host.state[n])
                   for n in host.state)
    assert all(bits_equal(res.state[n], first[n]) for n in first)
    before = ops.device_launch_counts()
    eng.run(prog, pg)
    after = ops.device_launch_counts()
    on_device = {k: after[k] - before[k] for k in after}
    assert on_device.pop("segment_combine_join") == on_device[
        "segment_combine"]
    assert on_device == host_launches
    assert res.dispatches == -(-host.steps // min(k, prog.max_steps))
    spec.check(graph, pg, res, inputs)
    eng.clear_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("mode,k", [("fused", 64), ("chunked", 3)])
@pytest.mark.parametrize("key", ["wcc:basic", "pagerank:scatter", "sv:both",
                                 "pj:reqresp"])
def test_device_modes_match_host_on_the_card(cuda, key, mode, k):
    """Scale 10 (see :func:`_device_mode_against_host`)."""
    _device_mode_against_host(cuda, key, mode, k, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,k", [("fused", 64), ("chunked", 3)])
@pytest.mark.parametrize("key", ["sv:composed", "msf:channels",
                                 "msf:monolithic", "scc:basic", "scc:prop",
                                 "wcc:prop", "sssp:prop"])
def test_inner_loop_programs_match_host_on_the_card(cuda, key, mode, k):
    """The seven programs whose inner loops are WHILE nodes of the
    captured graph, at scale 12 (see :func:`_device_mode_against_host`):
    their kernels launch as often as the host run's inner loops call
    them."""
    _device_mode_against_host(cuda, key, mode, k, 12)


@pytest.mark.gpu
def test_a_capture_that_meets_a_host_sync_raises(cuda):
    """A step that reads a flag back to the host cannot be captured: the
    capture raises, naming the program, and nothing runs eagerly."""
    from repro_torch.pregel import runtime

    pg = pgraph.partition_graph(REGISTRY["wcc:basic"].make_graph(8, 0), 8,
                                "random", build=("raw_out",))

    def step(ctx, gs, state, i):
        x = state["x"] + 1
        return {"x": x}, bool((x > 3).all())

    x0 = {"x": torch.zeros_like(pg.v_mask, dtype=torch.int32)}
    assert runtime.run_supersteps(pg, step, x0).steps == 4  # host mode
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="sync-probe: .*capturing"):
        runtime.DeviceLoop(pg, step, x0, mode="fused", max_steps=10,
                           name="sync-probe")
    # the loop still runs a capture-safe step on this card
    res = runtime.run_supersteps(
        pg, lambda c, g, s, i: ({"x": s["x"] + 1}, (s["x"] >= 3).all(dim=1)),
        x0, mode="fused")
    assert res.steps == 4 and res.halted


@pytest.mark.gpu
@pytest.mark.parametrize("mode,k", [("fused", 64), ("chunked", 3)])
@pytest.mark.parametrize("key", ["reach:basic", "sssp:basic"])
def test_batched_device_modes_match_host_on_the_card(cuda, key, mode, k):
    """``run_batch`` of 20 sources (12 pad lanes of the cap-32 bucket) at
    scale 10, W = 8, captured against the host loop on one card: every
    lane, the pad audit and the state bit-identical, ``bucket_ranks_lanes``
    launched as often (the runtime's counts and the kernel's own); a
    second batch of 24 sources replays the same graph with its own pad
    lanes and equals the host run of those sources."""
    spec = REGISTRY[key]
    graph = spec.make_graph(10, 0)
    pg = pgraph.partition_graph(graph, 8, "random", build=spec.build)
    queries = spec.queries(graph, 0, 24)
    host_eng, eng = (Engine(mode="host", device=cuda),
                     Engine(mode=mode, chunk_size=k, device=cuda))
    prog = spec.factory()
    for n in (20, 24):
        ops.reset_launch_counts()
        host = host_eng.run_batch(prog, pg, queries[:n])
        want = ops.launch_counts()
        ops.reset_launch_counts()
        before = ops.device_launch_counts()
        res = eng.run_batch(prog, pg, queries[:n])
        after = ops.device_launch_counts()
        assert ops.launch_counts() == want
        assert want["bucket_ranks_lanes"] == host.steps > 0
        assert res.cache_hit == (n == 24)
        assert (res.steps, res.num_pad_lanes, res.pad_steps,
                res.pad_bytes) == (host.steps, 32 - n, 0, 0)
        for qi in range(n):
            np.testing.assert_array_equal(res.outputs[qi], host.outputs[qi])
            assert res.query_bytes(qi) == host.query_bytes(qi)
            assert res.query_msgs(qi) == host.query_msgs(qi)
        np.testing.assert_array_equal(res.query_steps, host.query_steps)
        assert all(bits_equal(res.state[x], host.state[x])
                   for x in host.state)
        if n == 24:  # a replay: launches only from the graph
            assert after["bucket_ranks_lanes"] - before[
                "bucket_ranks_lanes"] == want["bucket_ranks_lanes"]
    eng.clear_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [2, 64])
def test_serve_on_the_card_equals_solo_runs(cuda, chunk):
    """``Engine.serve`` of a Poisson stream of 12 ``sssp:basic`` queries
    through 3 lanes at scale 10: every record equals a solo host-mode run
    of its source, ``bucket_ranks_lanes`` launches once a superstep the
    session ran (as the kernel counts), and a second session replays."""
    spec = REGISTRY["sssp:basic"]
    graph = spec.make_graph(10, 0)
    pg = pgraph.partition_graph(graph, 8, "random", build=spec.build)
    schedule = spec.stream(graph, 0, 12, rate=0.5)
    eng, host = Engine(device=cuda), Engine(mode="host", device=cuda)
    prog = spec.factory()
    for hit in (False, True):
        before = ops.device_launch_counts()
        res = eng.serve(prog, pg, QueryQueue.from_schedule(schedule),
                        num_lanes=3, chunk_size=chunk)
        after = ops.device_launch_counts()
        assert res.cache_hit == hit and res.num_queries == 12
        launched = after["bucket_ranks_lanes"] - before["bucket_ranks_lanes"]
        assert launched == res.supersteps + (0 if hit else 1)  # warm-up
        for rec in res.records:
            solo = host.run(spec.factory(source=rec.query), pg)
            np.testing.assert_array_equal(rec.output, solo.output)
            assert (rec.steps, rec.halted) == (solo.steps, solo.halted)
            assert rec.bytes_by_channel == solo.bytes_by_channel
    eng.clear_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("key,route_batch", [
    ("pagerank:personal", "union"), ("pj:reqresp", "union"),
    ("pj:reqresp", "lane"), ("reach:basic", "lane")])
def test_new_batched_paths_equal_solo_runs_on_the_card(cuda, key,
                                                       route_batch):
    """``run_batch`` of 12 queries (four pad lanes) at scale 10, W = 8, in
    host and fused mode on the card: every lane bit-identical to the solo
    host-mode run of its query, both modes equal, and every kernel
    launched as often in both (the runtime's counts)."""
    spec = REGISTRY[key]
    graph = spec.make_graph(10, 0)
    pg = pgraph.partition_graph(graph, 8, "random", build=spec.build)
    queries = spec.queries(graph, 0, 12)
    prog = spec.factory(**spec.inputs(graph, 0))
    solo = Engine(mode="host", device=cuda)
    counts = []
    results = []
    for mode in ("host", "fused"):
        eng = Engine(mode=mode, device=cuda, route_batch=route_batch)
        eng.run_batch(prog, pg, queries)
        ops.reset_launch_counts()
        results.append(eng.run_batch(prog, pg, queries))
        counts.append(ops.launch_counts())
        eng.clear_cache()
    host, fused = results
    assert counts[0] == counts[1]
    assert host.route_batch == fused.route_batch == route_batch
    kernel = ("segment_combine" if key == "pagerank:personal" else
              "bucket_ranks" if route_batch == "lane" else
              "bucket_ranks_lanes")
    assert counts[0][kernel] > 0
    for qi, query in enumerate(queries):
        ref_run = solo.run(spec.factory(**{spec.query_knob: query}), pg)
        for res in results:
            np.testing.assert_array_equal(res.outputs[qi], ref_run.output)
            assert res.query_bytes(qi) == ref_run.bytes_by_channel
            assert int(res.query_steps[qi]) == ref_run.steps
    assert all(bits_equal(fused.state[x], host.state[x])
               for x in host.state)


def _column_case(shape, name, dtype, d):
    """(vals, seg, n) on the CPU from a seed for a D-column combine.
    ``"lanes"``: a batched combine's 32 lanes (8 rows of 50,000 entries
    into 4,096; a min's lanes half +inf). ``"wide"``: row 0 one hub over
    101 tiles, then a dropped tail; row 1 a gap of about 39,500 empty
    segments (the chunk table's fill) between two dense windows.
    ``"tall"``: 70,000 rows of 40 entries (the grid's rows loop). Float
    products multiply +-1 and a few 2 and 0.5, exact in any order."""
    g = torch.Generator().manual_seed(d * 31 + len(name) + len(shape))
    if shape == "lanes":
        g = torch.Generator().manual_seed(5 if name == "sum" else 6)
        rows, e, n = 8, 50_000, 4096
        seg = torch.sort(torch.randint(0, n + 5, (rows, e), generator=g,
                                       dtype=torch.int32), dim=1)[0]
    elif shape == "wide":
        rows, e, n = 2, 101 * TILE + 3000, 40_000
        hub = torch.full((e,), 7)
        hub[101 * TILE + 1000:] = n + 3
        lo = torch.randint(0, 200, (e // 2,), generator=g)
        hi = torch.randint(n - 300, n + 2, (e - e // 2,), generator=g)
        seg = torch.stack([hub, torch.cat([lo, hi]).sort().values])
    else:
        rows, e, n = 70_000, 40, 9
        seg = torch.sort(torch.randint(0, n + 1, (rows, e), generator=g),
                         dim=1)[0]
    shape_v = (rows, e, d)
    if dtype == torch.bool:
        vals = torch.rand(shape_v, generator=g) < 0.1
    elif dtype == torch.int32:
        vals = torch.randint(-1000, 1000, shape_v, generator=g,
                             dtype=torch.int32)
    elif name == "prod":
        pick = torch.rand(shape_v, generator=g)
        vals = torch.where(pick < 0.5, -1.0, 1.0)
        vals[pick < 2e-4] = 2.0
        vals[(pick >= 2e-4) & (pick < 4e-4)] = 0.5
    else:
        vals = torch.rand(shape_v, generator=g)
        if name == "min":
            vals[torch.rand(shape_v, generator=g) < 0.5] = float("inf")
    return vals, seg.to(torch.int32), n


_COLUMN_CASES = [("lanes", "sum", torch.float32, 32),
                 ("lanes", "min", torch.float32, 32),
                 ("wide", "or", torch.bool, 32)]
_COLUMN_CASES += [("wide", name, dtype, d)
                  for d in (2, 3, 4, 5, 8, 31, 32, 33, 64, 96)
                  for name in ("sum", "min", "max", "prod")
                  for dtype in (torch.float32, torch.int32)]
_COLUMN_CASES += [("tall", name, dtype, 4)
                  for name in ("sum", "min", "max", "prod")
                  for dtype in (torch.float32, torch.int32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,name,dtype,d", _COLUMN_CASES)
def test_segment_combine_columns_equal_their_d1_calls_on_the_card(
        cuda, shape, name, dtype, d):
    """A combine over D columns (a batched ScatterCombine's or
    Propagation's lanes as columns; the multi-column path where D % 4 ==
    0, one column at a time else): each column equals, bit for bit, the
    kernel's D=1 call on that column alone, since the combine order
    depends only on entry positions; the whole equals the plain version
    (float sum within rtol 1e-4, atol 1e-5: reassociation; exact
    otherwise)."""
    vals, seg, n = _column_case(shape, name, dtype, d)
    vals, seg = vals.to(cuda), seg.to(cuda)
    out = ops.segment_combine(vals, seg, n, name)
    for j in range(d):
        one = ops.segment_combine(vals[..., j:j + 1].contiguous(), seg, n,
                                  name)
        assert bits_equal(out[..., j:j + 1].contiguous(), one), j
    want = ref.segment_combine_ref(vals, seg, n, cb.get(name))
    if name == "sum" and dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    else:
        assert bits_equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,offset", [(8, 0), (32, 0), (33, 0), (3, 0),
                                      (32, 1), (12, 2)])
def test_segment_combine_plan_is_the_kernels(cuda, d, offset):
    """``launch_plan`` gives the scratch words and the group width the C
    library has, and the path the kernels count themselves launching: the
    multi-column kernels for the vector path, the one-column kernels else
    (D % 4 != 0, or values not 16-byte aligned: a view ``offset``
    elements into its storage); both give the plain version's result."""
    from repro_torch.kernels import segment_combine as kseg

    words = kseg._library()[1]
    for rows, e in ((1, 1), (8, 1 << 20), (3, 5 * TILE + 7), (70_000, 40)):
        for op, code in kseg._OPS.items():
            assert words(rows, e, d, code) == kseg.launch_plan(
                rows, e, d, op, True).scratch_words
    assert kseg.group_columns() == kseg.GROUP
    g = torch.Generator().manual_seed(d + offset)
    rows, e, n = 3, 4 * TILE + 9, 1000
    seg = torch.sort(torch.randint(0, n + 2, (rows, e), generator=g),
                     dim=1)[0].to(torch.int32).to(cuda)
    flat = torch.randint(-99, 99, (rows * e * d + offset,), generator=g,
                         dtype=torch.int32).to(cuda)
    vals = flat[offset:].view(rows, e, d)
    want = ref.segment_combine_ref(vals, seg, n, cb.SUM)
    for v in (vals, vals.clone()):
        plan = kseg.launch_plan(rows, e, d, "sum", v.data_ptr() % 16 == 0)
        before = kseg.device_launches(), kseg.group_launches()
        got = kseg.segment_combine_cuda(v, seg, n, cb.SUM)
        after = kseg.device_launches(), kseg.group_launches()
        grouped = int(plan.path == "vector")
        assert [a - b for a, b in zip(after[0], before[0])] == [1, 1]
        assert [a - b for a, b in zip(after[1], before[1])] == [grouped] * 2
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_batched_sssp_prop_on_the_card_equals_solo_runs(cuda):
    """``run_batch`` of 12 ``sssp:prop`` sources (four pad lanes) at scale
    10 in host, fused and chunked mode: every lane (distances, ``info``,
    bytes) equal to its solo run, the modes equal, ``segment_combine``
    launched as often in each."""
    spec = REGISTRY["sssp:prop"]
    graph = spec.make_graph(10, 0)
    pg = pgraph.partition_graph(graph, 8, "random", build=spec.build)
    queries = spec.queries(graph, 0, 12)
    prog = spec.factory()
    solo = Engine(mode="host", device=cuda)
    counts, results = [], []
    for mode, k in (("host", 64), ("fused", 64), ("chunked", 4)):
        eng = Engine(mode=mode, chunk_size=k, device=cuda)
        eng.run_batch(prog, pg, queries)
        ops.reset_launch_counts()
        results.append(eng.run_batch(prog, pg, queries))
        counts.append(ops.launch_counts())
        eng.clear_cache()
    assert counts[0]["segment_combine"] > 0
    assert counts[0] == counts[1] == counts[2]
    for qi, source in enumerate(queries):
        ref_run = solo.run(spec.factory(source=source), pg)
        for res in results:
            np.testing.assert_array_equal(res.outputs[qi], ref_run.output)
            assert torch.equal(res.state["info"][:, qi],
                               ref_run.state["info"])
            assert res.query_bytes(qi) == ref_run.bytes_by_channel
    assert (results[1].pad_bytes, results[1].pad_steps) == (0, 0)


@pytest.mark.gpu
def test_checkpoint_resume_replays_the_captured_loop(cuda, tmp_path):
    """A chunked ``wcc:basic`` run at scale 12 checkpointed every two
    supersteps; a resume from each checkpoint replays the cached CUDA
    graph (no new capture) and equals the uninterrupted run."""
    from repro_torch.pregel import checkpoint as ckpt_io

    spec = REGISTRY["wcc:basic"]
    pg = pgraph.partition_graph(spec.make_graph(12, 0), 8, "random",
                                build=spec.build)
    prog = spec.factory()
    eng = Engine(mode="chunked", chunk_size=2, device=cuda)
    full = eng.run(prog, pg, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    paths = sorted(tmp_path.glob("*.ckpt"))
    assert paths and eng.compiles == 1
    for path in paths:
        res = eng.run(prog, pg, resume=str(path))
        assert res.cache_hit and eng.compiles == 1
        assert res.resumed_from == ckpt_io.load(str(path)).step
        assert (res.steps, res.halted) == (full.steps, full.halted)
        assert res.bytes_by_channel == full.bytes_by_channel
        assert res.msgs_by_channel == full.msgs_by_channel
        assert all(bits_equal(res.state[n], full.state[n])
                   for n in full.state)
    eng.clear_cache()


@pytest.mark.gpu
def test_escalation_recaptures_on_the_card(cuda):
    """``sv:composed`` at scale 12 from an eighth of every capacity: each
    escalation captures a new graph, the recovered run equals the plain
    one, and a second run is a cache hit with no recovery."""
    spec = REGISTRY["sv:composed"]
    pg = pgraph.partition_graph(spec.make_graph(12, 0), 8, "random",
                                build=spec.build)
    prog = spec.factory()
    plain = Engine(mode="host", device=cuda).run(prog, pg)
    eng = Engine(device=cuda, cap_scales={"*": 0.125},
                 on_overflow="escalate")
    res = eng.run(prog, pg)
    assert res.recovery and eng.compiles == len(res.recovery) + 1
    assert eng.cache_size == 1
    again = eng.run(prog, pg)
    assert again.cache_hit and again.recovery is None
    for run in (res, again):
        np.testing.assert_array_equal(run.output, plain.output)
        assert run.steps == plain.steps
        assert run.bytes_by_channel == plain.bytes_by_channel
    eng.clear_cache()


@pytest.mark.gpu
def test_engine_refuses_the_plain_paths_on_the_card(cuda):
    """A given Plan with ``use_kernel=False`` or ``route_impl="sort"``
    raises at construction on the card, and neither is an engine knob;
    nothing falls back."""
    from repro_torch.plan import Plan

    with pytest.raises(ValueError, match="use_kernel=False"):
        Engine(plan=Plan(use_kernel=False))
    with pytest.raises(ValueError, match="route_impl='sort'"):
        Engine(plan=Plan(route_impl="sort"))
    with pytest.raises(TypeError):
        Engine(use_kernel=False)
    with pytest.raises(TypeError):
        Engine(route_impl="sort")
    Engine(plan=Plan())  # the card's values


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["host", "fused", "chunked"])
def test_planned_runs_equal_hand_set_runs_on_the_card(cuda, mode, tmp_path,
                                                      monkeypatch):
    """The card's plan takes the kernels, the bucket route and the
    default threshold, and times no probe; the planned run equals the
    hand-set run with its knobs bit for bit and launches each kernel as
    often; planning leaves ``stats()`` alone."""
    from repro_torch.plan import Planner

    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))
    spec = REGISTRY["wcc:switch"]
    graph = spec.make_graph(10, 0)
    pg = pgraph.partition_graph(graph, 4, "random", build=spec.build,
                                device=cuda)
    prog = spec.factory()
    auto = Engine(plan="auto", mode=mode, chunk_size=4)
    plan = auto.resolve_plan(prog, pg)
    assert auto.stats()["runs"] == 0 and auto.cache_size == 0
    assert (plan.use_kernel, plan.route_impl, plan.dense_threshold) == (
        True, "bucket", 0.1)
    assert plan.fingerprint.backend == "cuda"
    measured = {c[0]: c[2] for c in plan.decision("route_impl").candidates}
    assert measured == {"bucket": None, "sort": None}
    assert not list(tmp_path.iterdir())
    # a plan to be explained times the probes on the card, decides alike
    explained = Planner(explain=True).plan(
        prog, pg, overrides={"mode": mode, "chunk_size": 4})
    assert explained.knobs() == plan.knobs()
    for knob in ("route_impl", "use_kernel"):
        assert all(c[2] > 0 for c in explained.decision(knob).candidates)
    hand = Engine(mode=mode, chunk_size=4, route_batch=plan.route_batch,
                  dense_threshold=plan.dense_threshold)
    runs = []
    for eng in (auto, hand):
        eng.run(prog, pg)
        ops.reset_launch_counts()
        res = eng.run(prog, pg)
        runs.append((res, ops.launch_counts()))
    (a, la), (h, lh) = runs
    assert la == lh and la["bucket_ranks"] > 0
    assert all(bits_equal(a.state[k], h.state[k]) for k in h.state)
    assert (a.steps, a.bytes_by_channel, a.msgs_by_channel) == (
        h.steps, h.bytes_by_channel, h.msgs_by_channel)
    if mode != "host":
        assert a.cache_hit and set(auto._cache) == set(hand._cache)


# ---------------------------------------------------------------------------
# Engine(backend="dist") on the card: four ranks share it over gloo
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_dist_gloo_probe_on_the_card(cuda):
    """Every workers-layer operation on four gloo ranks that hold CUDA
    tensors on one card, each rank's row bit for bit against
    ``LocalWorkers`` on all rows on the same card (NaN payloads
    included, which the card and the CPU make differently)."""
    import test_torch_dist as ranks
    from repro_torch.distributed.workers import LocalWorkers
    from repro_torch.launch import workers as launch

    w = 4
    probes = launch.spawn(ranks.layer_probe, w, device="cuda", timeout_s=60,
                          join_timeout_s=240)
    inp = ranks.layer_inputs(w)
    local = LocalWorkers(w)

    def t(a):
        return torch.from_numpy(a).to(cuda)

    def same(got, want):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()

    for rank, got in enumerate(probes):
        row = slice(rank, rank + 1)
        same(got["me"], np.arange(w)[row])
        for k, a in inp["exchange"].items():
            same(got["exchange"][k],
                 local.exchange(t(a)).cpu().numpy()[row])
        for k, a in inp["exchange_lanes"].items():
            same(got["exchange_lanes"][k],
                 local.exchange(t(a), peer_dim=2).cpu().numpy()[row])
        for (k, c), v in got["reduce"].items():
            same(v, local.reduce(t(inp["reduce"][k]),
                                 cb.get(c)).cpu().numpy()[row])
        for k, a in inp["votes"].items():
            assert got["any"][k] == bool(a.any())
            assert got["all"][k] == bool(a.all())
        same(got["gather"], inp["gather"])


@pytest.mark.gpu
def test_dist_programs_on_the_card_match_local(cuda):
    """``wcc:basic`` and ``pagerank:scatter`` at scale 16 on four gloo
    ranks of one card, bit for bit against the single-process host run on
    the card, each kernel launched on each rank as often as the local
    wrappers count."""
    from repro_torch.launch import jobs as J
    from repro_torch.launch import workers as launch

    jobs = [J.Job("wcc:basic", 16), J.Job("pagerank:scatter", 16)]
    per_rank = launch.spawn(J.rank_jobs, 4, jobs, device="cuda",
                            timeout_s=60, join_timeout_s=400)
    problems = J.Problems()
    for i, job in enumerate(jobs):
        local = J.run_job(job, cuda, problems=problems)
        assert local["launches"]["bucket_ranks" if job.key.startswith("wcc")
                                 else "segment_combine"] > 0
        for rank, got in enumerate(per_rank):
            assert J.differences(got[i], local) == [], (job.name, rank)
        J.check_oracle(job, local, cuda, problems)


@pytest.mark.gpu
def test_device_loops_on_a_gloo_group_match_the_captured_local_runs(cuda):
    """``wcc:basic`` and ``sv:composed`` fused and a served
    ``reach:basic`` session (6 queries, 2 lanes, chunk 2) at scale 12 on
    four gloo ranks of one card: the ranks run the device loops
    uncaptured (``captured`` False), the single-process runs replay a
    captured CUDA graph (``captured`` True), and the two agree bit for
    bit, each kernel launched on each rank as often as locally."""
    from repro_torch.launch import jobs as J
    from repro_torch.launch import workers as launch

    jobs = [J.Job("wcc:basic", 12, mode="fused"),
            J.Job("sv:composed", 12, mode="fused"),
            J.Job("reach:basic", 12, queries=6, lanes=2, mode="chunked",
                  chunk_size=2)]
    per_rank = launch.spawn(J.rank_jobs, 4, jobs, device="cuda",
                            timeout_s=60, join_timeout_s=400)
    problems = J.Problems()
    for i, job in enumerate(jobs):
        local = J.run_job(job, cuda, problems=problems)
        assert local["captured"] is True
        assert sum(local["launches"].values()) > 0
        for rank, got in enumerate(per_rank):
            assert got[i]["captured"] is False
            assert J.differences(got[i], local) == [], (job.name, rank)


LM_ARCHS = ["musicgen-medium", "mamba2-130m", "chatglm3-6b", "granite-8b",
            "qwen1.5-32b", "qwen2-7b", "mixtral-8x7b", "qwen2-moe-a2.7b",
            "internvl2-2b", "jamba-1.5-large-398b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_config_on_the_card(cuda, arch):
    """A registry smoke config (float32): the card's forward equals the
    CPU's on the same weights within 1e-3; prefill plus four decode steps
    equal the full forward within 2e-3; greedy generate twice is
    bit-identical."""
    from repro_torch.configs import registry
    from repro_torch.models import model as M, params as Pm
    from repro_torch.serve import decode as D

    cfg = registry.ARCHS[arch].smoke
    cpu_p = Pm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p = Pm.tree_map(lambda t: t.to(cuda), cpu_p)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 13), generator=g)
    batch = {"tokens": toks}
    if cfg.frontend_tokens:
        batch["embeds"] = 0.02 * torch.randn(2, cfg.frontend_tokens,
                                             cfg.d_model, generator=g)
    with torch.no_grad():
        want, _ = M.forward(cfg, cpu_p, batch)
        got, _ = M.forward(cfg, p, {k: v.to(cuda) for k, v in batch.items()})
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
        toks = toks.to(cuda)
        full, _ = M.forward(cfg, p, {"tokens": toks})
        cache = M.init_cache(cfg, 2, 13, device=cuda)
        _, cache = D.make_prefill_step(cfg)(p, {"tokens": toks[:, :9]}, cache)
        step = D.make_decode_step(cfg)
        for pos in range(9, 13):
            _, logits, cache = step(p, cache, toks[:, pos:pos + 1], pos)
            torch.testing.assert_close(logits, full[:, pos], rtol=2e-3,
                                       atol=2e-3)
    first = D.generate(cfg, p, toks[:, :9], 8)
    assert torch.equal(first, D.generate(cfg, p, toks[:, :9], 8))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_on_the_card(cuda, arch):
    """A registry smoke config (float32): the card's loss and grad_norm
    within rtol 1e-5 of the CPU's step from the same weights and batch,
    one step twice from one state bit-identical, microbatches 2 within
    2e-6 of 1 (a 1e-5 first update)."""
    from repro_torch.configs import registry
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import data, train_step as ts
    from repro_torch.train.optimizer import AdamW

    cfg, opt = registry.ARCHS[arch].smoke, AdamW(lr=1e-3)

    def state_on(dev):
        st = ts.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                 device="cpu")
        params = tree_map(lambda t: t.to(dev), st.params)
        return ts.TrainState(params, opt.init(params))

    batch = data.SyntheticLM(cfg, 16, 4, device="cpu").batch_at(0)
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    step = ts.make_train_step(cfg, opt)
    _, want = step(state_on("cpu"), batch)
    runs = [step(state_on(cuda), cbatch) for _ in range(2)]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(runs[0][1][k]), float(want[k]),
                                   rtol=1e-5)
        assert bits_equal(runs[0][1][k], runs[1][1][k])
    (a, _), (b, _) = runs
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt.m)
                    + tree_leaves(a.opt.v),
                    tree_leaves(b.params) + tree_leaves(b.opt.m)
                    + tree_leaves(b.opt.v)):
        assert bits_equal(x, y)
    mb, _ = ts.make_train_step(cfg, opt, microbatches=2)(state_on(cuda),
                                                         cbatch)
    for x, y in zip(tree_leaves(mb.params), tree_leaves(a.params)):
        assert float((x - y).abs().max()) <= 2e-6
