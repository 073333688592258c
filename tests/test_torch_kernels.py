"""The port's kernel layer (repro_torch.kernels) against the JAX package.

On the CPU every wrapper takes its plain PyTorch version; those are held
to the JAX reference (and to the JAX Pallas kernels in interpret mode)
on the same numpy inputs. The reference's known faults appear as named
cases (ROADMAP "Faults found"). The CUDA kernels themselves are held to
their plain versions on the card by tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import combiners as jcb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import combiners as cb
from repro_torch.kernels import bucket_route as kbucket
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_combine as kseg

INF = float("inf")


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# bucket_ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,m,seed", [(4, 1000, 0), (8, 1536, 1), (1, 7, 2),
                                      (31, 600, 3)])
def test_bucket_ranks_ref_matches_jax(b, m, seed):
    """Exact: integer counts. Keys include the sentinel bucket b."""
    keys = np.random.default_rng(seed).integers(0, b + 1, m).astype(np.int32)
    rank, counts = ref.bucket_ranks_ref(torch.from_numpy(keys), b)
    j_rank, j_counts = jref.bucket_ranks_ref(jnp.asarray(keys), b)
    k_rank, k_counts = jops.bucket_ranks(jnp.asarray(keys), b,
                                         use_kernel=True, interpret=True)
    for want_r, want_c in ((j_rank, j_counts), (k_rank, k_counts)):
        np.testing.assert_array_equal(rank.numpy(), _np(want_r))
        np.testing.assert_array_equal(counts.numpy(), _np(want_c))


def test_bucket_ranks_rows_are_independent():
    keys = np.random.default_rng(5).integers(0, 5, (3, 200)).astype(np.int32)
    rank, counts = ref.bucket_ranks_ref(torch.from_numpy(keys), 4)
    for r in range(3):
        j_rank, j_counts = jref.bucket_ranks_ref(jnp.asarray(keys[r]), 4)
        np.testing.assert_array_equal(rank[r].numpy(), _np(j_rank))
        np.testing.assert_array_equal(counts[r].numpy(), _np(j_counts))


def test_bucket_ranks_kernel_rejects_too_many_buckets():
    """Up to 63 buckets the narrow kernel; above it the wide one, its
    (16 + 2) x (B + 1) int32 counts in shared memory while they fit the
    H100's 232,448-byte opt-in less the 8,192 bytes kept for static
    arrays, else in one global slab a block. Only B + 1 above 2^22 - 1
    (a key + 1 in 22 bits of a slot) is refused."""
    plan = kbucket.launch_plan
    assert plan(63, 8, 1 << 21) == kbucket.LaunchPlan(False, True, False, 0, 0)
    for w in (64, 256, 1024):  # W workers: B + 1 = W + 1 buckets
        assert plan(w, 8, 1 << 21) == kbucket.LaunchPlan(
            True, True, False, 18 * (w + 1) * 4, 0)
    room = kbucket.H100_SMEM_OPTIN - kbucket.STATIC_RESERVE
    assert 18 * 3114 * 4 <= room < 18 * 3115 * 4
    assert plan(3113, 1, 10)[:2] == (True, True)
    tiles = 2 * 13  # two rows of 100,000 keys: 13 tiles of 8,192 each
    assert plan(3114, 2, 100_000) == kbucket.LaunchPlan(
        True, False, False, 0, tiles * 18 * 3115)
    assert plan(4096, 2, 100_000).work_words == tiles * 18 * 4097
    # a smaller opt-in moves the counts out sooner
    assert not plan(1024, 1, 10, smem_optin=48 * 1024).counts_shared
    # the wrapper takes these bucket counts; on the CPU it stops at the
    # device check, after every size check
    keys = torch.zeros(4, dtype=torch.int32)
    for nb in (64, 1024, kbucket.MAX_BUCKETS - 1):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            kbucket.bucket_ranks_cuda(keys, nb)
    with pytest.raises(ValueError, match="at most 4194302 buckets"):
        kbucket.bucket_ranks_cuda(keys, kbucket.MAX_BUCKETS)


# ---------------------------------------------------------------------------
# bucket_ranks_lanes
# ---------------------------------------------------------------------------


def _lane_inputs(seed, rows, m, b, q):
    """Keys with the sentinel b, membership all-False on sentinel rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, b + 1, (rows, m)).astype(np.int32)
    lanes = (rng.random((rows, m, q)) < 0.4) & (keys < b)[..., None]
    return keys, lanes


@pytest.mark.parametrize("b,m,q,seed", [(4, 700, 1, 0), (8, 1100, 5, 1),
                                        (3, 513, 33, 2), (8, 512, 5, 3)])
def test_bucket_ranks_lanes_ref_matches_jax(b, m, q, seed):
    """Exact: integer counts. M not a multiple of the Pallas block (512)
    except in the last case; each worker row against its own JAX call,
    both the JAX reference and the Pallas kernel in interpret mode."""
    keys, lanes = _lane_inputs(seed, 3, m, b, q)
    rank, counts, lane_counts = ref.bucket_ranks_lanes_ref(
        torch.from_numpy(keys), torch.from_numpy(lanes), b)
    assert lane_counts.shape == (3, b, q) and lane_counts.dtype == torch.int32
    for r in range(3):
        jk, jl = jnp.asarray(keys[r]), jnp.asarray(lanes[r])
        wants = [jref.bucket_ranks_lanes_ref(jk, jl, b),
                 jops.bucket_ranks_lanes(jk, jl, b, use_kernel=True,
                                         interpret=True)]
        for want in wants:
            np.testing.assert_array_equal(rank[r].numpy(), _np(want[0]))
            np.testing.assert_array_equal(counts[r].numpy(), _np(want[1]))
            np.testing.assert_array_equal(lane_counts[r].numpy(),
                                          _np(want[2]))


def test_bucket_ranks_lanes_ref_matches_the_pallas_kernel_unpadded():
    """The Pallas kernel itself at a block multiple (no padding by the
    dispatch): its (B + 1, Q) histogram minus the sentinel row."""
    keys, lanes = _lane_inputs(4, 1, 1024, 6, 7)
    _, _, lane_counts = ref.bucket_ranks_lanes_ref(
        torch.from_numpy(keys[0]), torch.from_numpy(lanes[0]), 6)
    from repro.kernels import bucket_route as jbucket
    j_rank, _, j_lanes = jbucket.bucket_ranks_lanes_pallas(
        jnp.asarray(keys[0]), jnp.asarray(lanes[0]), num_buckets=6,
        interpret=True)
    np.testing.assert_array_equal(lane_counts.numpy(), _np(j_lanes)[:6])
    assert not _np(j_lanes)[6].any()  # sentinel rows carry no lane bits


def test_bucket_ranks_lanes_sentinel_bucket_is_dropped():
    """Lane bits on a sentinel row (outside the contract) do not reach
    lane_counts: the sentinel bucket is dropped, as in JAX."""
    keys = torch.tensor([[2, 0, 2, 1]], dtype=torch.int32)
    lanes = torch.ones(1, 4, 2, dtype=torch.bool)
    rank, counts, lane_counts = ref.bucket_ranks_lanes_ref(keys, lanes, 2)
    assert rank.tolist() == [[0, 0, 1, 0]] and counts.tolist() == [[1, 1]]
    assert lane_counts.tolist() == [[[1, 1], [1, 1]]]


@pytest.mark.parametrize("b,q,seed", [(4, 5, 6), (8, 33, 7)])
def test_bucket_ranks_out_of_range_keys_get_rank_zero_and_no_count(b, q, seed):
    """Keys -1 and B + 3 lie outside the [0, B] contract. The Pallas
    kernels give them rank 0 and count them in no bucket and no lane, and
    so do the plain versions (the CUDA kernels: tests/test_torch_gpu.py).
    The JAX reference agrees on every count and on the rank of every key
    in range; its rank of an out-of-range key is what take_along_axis
    gathers there (ROADMAP fault 6), so ranks are held to it in range
    only. Out-of-range entries carry lane bits, which every version drops."""
    rng = np.random.default_rng(seed)
    m = 700
    keys = rng.integers(0, b + 1, m).astype(np.int32)
    bad = rng.random(m) < 0.2
    keys[bad] = np.where(rng.random(int(bad.sum())) < 0.5, -1, b + 3)
    lanes = (rng.random((m, q)) < 0.4) & (keys != b)[:, None]
    inside = ~bad
    rank, counts = ref.bucket_ranks_ref(torch.from_numpy(keys), b)
    l_rank, l_counts, lane_counts = ref.bucket_ranks_lanes_ref(
        torch.from_numpy(keys), torch.from_numpy(lanes), b)
    assert (rank.numpy()[bad] == 0).all()
    np.testing.assert_array_equal(l_rank.numpy(), rank.numpy())
    np.testing.assert_array_equal(l_counts.numpy(), counts.numpy())
    jk, jl = jnp.asarray(keys), jnp.asarray(lanes)
    k_rank, k_counts = jops.bucket_ranks(jk, b, use_kernel=True,
                                         interpret=True)
    kl_rank, kl_counts, kl_lanes = jops.bucket_ranks_lanes(
        jk, jl, b, use_kernel=True, interpret=True)
    for want in (k_rank, kl_rank):
        np.testing.assert_array_equal(rank.numpy(), _np(want))
    j_rank, j_counts = jref.bucket_ranks_ref(jk, b)
    _, jl_counts, jl_lanes = jref.bucket_ranks_lanes_ref(jk, jl, b)
    np.testing.assert_array_equal(rank.numpy()[inside], _np(j_rank)[inside])
    for want in (k_counts, kl_counts, j_counts, jl_counts):
        np.testing.assert_array_equal(counts.numpy(), _np(want))
    for want in (kl_lanes, jl_lanes):
        np.testing.assert_array_equal(lane_counts.numpy(), _np(want))


def test_bucket_kernels_reject_too_many_rows():
    """Up to 65,535 rows (the grid's y dimension) the narrow kernel; past
    them the wide one, whose tiles of all rows share the grid's x
    dimension: any number of rows while the tiles (one block each, 8,192
    keys) stay within 2^31 - 1. segment_combine takes any number of
    rows."""
    assert kbucket.launch_plan(4, 65_535, 1000) == kbucket.LaunchPlan(
        False, True, False, 0, 0)
    assert kbucket.launch_plan(4, 70_000, 1000) == kbucket.LaunchPlan(
        True, True, False, 18 * 5 * 4, 0)
    assert kbucket.launch_plan(8, 70_000, 1000, 32) == kbucket.LaunchPlan(
        True, True, True, (18 + 33) * 9 * 4, 0)
    kbucket.launch_plan(4, kbucket.MAX_BLOCKS, 1)
    with pytest.raises(ValueError, match="at most 2147483647 tiles"):
        kbucket.launch_plan(4, kbucket.MAX_BLOCKS + 1, 1)
    with pytest.raises(ValueError, match="at most 2147483647 tiles"):
        kbucket.launch_plan(4, 1 << 20, 1 << 24)
    keys = torch.zeros(70_000, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kbucket.bucket_ranks_cuda(keys, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kbucket.bucket_ranks_lanes_cuda(
            keys, torch.zeros(70_000, 1, 1, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kseg.segment_combine_cuda(torch.zeros(70_000, 3),
                                  torch.zeros(70_000, 3, dtype=torch.int32),
                                  5, cb.get("sum"))


def test_bucket_scratch_epochs_and_growth():
    """The kernels' scratch: the epoch lives on the device in ``ctrl``,
    which the kernel keeps and no growth replaces; the status and zero
    words are replaced, zeroed, only when a call needs more of them."""
    s = kbucket._Scratch(torch.device("cpu"))
    status, ctrl, zero = s.take(10)
    assert status.numel() == 10 and ctrl.numel() == 2 and zero.numel() == 0
    assert not status.any() and not ctrl.any()
    again, ctrl2, zero2 = s.take(6)
    assert again is status and ctrl2 is ctrl and zero2 is zero
    status.fill_(7)  # what launches leave: tagged words, a later epoch
    ctrl[0] = 5 << 32
    grown, ctrl3, zero3 = s.take(11, 9)
    assert grown.numel() == 11 and not grown.any()
    assert zero3.numel() == 9 and not zero3.any()
    assert ctrl3 is ctrl and int(ctrl[0]) == 5 << 32  # the epoch goes on
    assert s.take(4, 3)[2] is zero3


def test_segment_chunk_table_growth_and_scratch_scopes():
    """The chunk table only grows, zeroed; under a scratch scope every
    launch on a device shares one scratch whatever its stream, and
    releasing the scope drops it."""
    from repro_torch.kernels import scratch

    t = kseg._Chunks(torch.device("cpu"))
    table = t.take(5)
    assert table.numel() == 5 and not table.any() and t.take(3) is table
    assert t.take(8).numel() == 8
    dev = torch.device("cpu")
    with scratch.scope("probe"):
        assert scratch.key(dev) == (None, "scope", "probe")
        kept = kbucket.scratch_of(dev)
        assert kbucket.scratch_of(dev) is kept
        assert kseg.chunks_of(dev) is kseg.chunks_of(dev)
    scratch.release("probe")
    with scratch.scope("probe"):
        assert kbucket.scratch_of(dev) is not kept
    scratch.release("probe")


def test_bucket_ranks_lanes_kernel_rejects_what_it_cannot_hold():
    """The (B + 1) x (Q + 1) int32 lane tile: in the narrow kernel's
    shared memory up to the opt-in less the static reserve (past 48 KB
    with the opt-in), beside the wide kernel's counts while both fit, and
    else not staged at all: each tile adds into the row's global
    accumulator. Keys and lanes that do not match are still refused."""
    plan, lp = kbucket.launch_plan, kbucket.LaunchPlan
    room = kbucket.H100_SMEM_OPTIN - kbucket.STATIC_RESERVE
    assert plan(8, 8, 1 << 20, 32) == lp(False, True, True, 9 * 33 * 4, 0)
    assert plan(8, 8, 1 << 20, 1024) == lp(False, True, True, 36_900, 0)
    assert plan(8, 8, 1 << 20, 4096) == lp(False, True, True, 147_492, 0)
    big_q = room // (9 * 4)  # the first Q whose tile passes the room
    assert 9 * big_q * 4 <= room < 9 * (big_q + 1) * 4
    assert plan(8, 1, 10, big_q) == lp(True, True, False, 18 * 9 * 4, 0)
    assert plan(64, 8, 1 << 20, 32) == lp(True, True, True,
                                          (18 + 33) * 65 * 4, 0)
    assert plan(4096, 1, 10, 32) == lp(True, False, False, 0, 18 * 4097)
    keys = torch.zeros(2, 4, dtype=torch.int32)
    for b, q in ((kbucket.MAX_BUCKETS - 1, 1), (8, 1000), (8, 100_000),
                 (64, 32)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            kbucket.bucket_ranks_lanes_cuda(
                keys, torch.zeros(2, 4, q, dtype=torch.bool), b)
    with pytest.raises(ValueError, match="at most 4194302 buckets"):
        kbucket.bucket_ranks_lanes_cuda(
            keys, torch.zeros(2, 4, 1, dtype=torch.bool), kbucket.MAX_BUCKETS)
    with pytest.raises(ValueError, match="do not match keys"):
        kbucket.bucket_ranks_lanes_cuda(
            keys, torch.zeros(2, 5, 3, dtype=torch.bool), 8)


# ---------------------------------------------------------------------------
# segment_combine
# ---------------------------------------------------------------------------


def _seg_inputs(seed, e=300, n=40, d=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n + 5, e).astype(np.int32)  # some ids >= n: dropped
    if dtype == np.int32:
        vals = rng.integers(-1000, 1000, (e, d)).astype(np.int32)
    elif dtype == np.bool_:
        vals = rng.random((e, d)) < 0.3
    else:
        vals = rng.normal(size=(e, d)).astype(np.float32)
    return vals, seg, n


@pytest.mark.parametrize("name,dtype", [
    ("min", np.float32), ("max", np.float32), ("min", np.int32),
    ("max", np.int32), ("sum", np.int32)])
def test_segment_combine_ref_matches_jax_exact(name, dtype):
    """Lattice combiners and int32 sum: bit for bit (the JAX Pallas
    kernel refuses int32 sum — ROADMAP fault 2; the port supports it)."""
    vals, seg, n = _seg_inputs(7, dtype=dtype)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n, name)
    want = jref.segment_combine_ref(jnp.asarray(vals), jnp.asarray(seg), n,
                                    name)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_segment_combine_f32_sum_fault4_tolerance():
    """ROADMAP fault 4: float32 sum differs between the JAX kernel and its
    reference by reassociation (~4.8e-7), so float-sum parity is held to
    rtol 1e-6 / atol 1e-6 against both, not bit for bit."""
    vals, seg, n = _seg_inputs(8)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n, "sum").numpy()
    want_ref = _np(jref.segment_combine_ref(jnp.asarray(vals),
                                            jnp.asarray(seg), n, "sum"))
    want_kernel = _np(jops.segment_combine(
        jnp.asarray(vals), jnp.asarray(seg), n, "sum", use_kernel=True,
        interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-6, atol=1e-6)


def test_segment_combine_fault1_inf_probe():
    """ROADMAP fault 1: the JAX Pallas kernel's one-hot extraction turns
    +inf into NaN for the whole row block. The port keeps inf, as the
    JAX reference does."""
    vals = np.array([[INF], [INF], [5.0], [INF], [2.0], [INF]], np.float32)
    seg = np.array([0, 0, 1, 2, 2, 3], np.int32)
    for name, want in (("min", [INF, 5.0, 2.0, INF]),
                       ("max", [INF, 5.0, INF, INF]),
                       ("sum", [INF, 5.0, INF, INF])):
        got = ref.segment_combine_ref(torch.from_numpy(vals),
                                      torch.from_numpy(seg), 4, name)
        np.testing.assert_array_equal(got[:, 0].numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(),
            _np(jref.segment_combine_ref(jnp.asarray(vals), jnp.asarray(seg),
                                         4, name)))


def test_segment_combine_fault3_or_empty_segments():
    """ROADMAP fault 3: the JAX reference's ``or`` fills empty segments
    with True (a segment_max cast); the port holds the identity False
    there, like the JAX kernel, and matches the reference elsewhere."""
    vals, seg, n = _seg_inputs(9, e=30, n=40, d=1, dtype=np.bool_)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n, "or").numpy()
    want = _np(jref.segment_combine_ref(jnp.asarray(vals), jnp.asarray(seg),
                                        n, "or"))
    empty = np.bincount(seg[seg < n], minlength=n) == 0
    assert empty.any() and not got[empty].any()
    assert want[empty].all()  # the reference's fault, pinned
    np.testing.assert_array_equal(got[~empty], want[~empty])


def _by_first_inputs(seed, e=80, n=40, d=4, dtype=np.float32):
    """Sorted or not, ids partly out of range (dropped), keys from a few
    small integers so most segments hold tied minima."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(-2, n + 5, e).astype(np.int32)
    vals = rng.integers(-99, 99, (e, d)).astype(dtype)
    vals[:, 0] = rng.integers(0, 3, e)
    return vals, seg, n


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("d", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_combine_min_by_first_matches_jax(seed, d, dtype):
    """Bit for bit against the JAX ``Combiner.segment_reduce`` and
    ``segment_combine_ref``: the later of tied keys wins, dropped ids,
    empty segments ``identity_like`` (key +inf / INT32_MAX, payload 0 —
    the port's side of ROADMAP fault 4)."""
    vals, seg, n = _by_first_inputs(seed, d=d, dtype=dtype)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n, "min_by_first")
    want = _np(jref.segment_combine_ref(jnp.asarray(vals), jnp.asarray(seg),
                                        n, "min_by_first"))
    np.testing.assert_array_equal(got.numpy(), want)
    same = _np(jcb.MIN_BY_FIRST.segment_reduce(jnp.asarray(vals),
                                               jnp.asarray(seg), n))
    np.testing.assert_array_equal(got.numpy(), same)
    empty = np.bincount(seg[(seg >= 0) & (seg < n)], minlength=n) == 0
    assert empty.any()
    key_ident = np.inf if dtype == np.float32 else np.iinfo(np.int32).max
    assert (got.numpy()[empty, 0] == key_ident).all()
    assert (got.numpy()[empty, 1:] == 0).all()


def test_segment_combine_min_by_first_rows_and_tie_rule():
    """(W, E, D) rows reduce independently; in a segment of equal keys
    the last entry's whole row wins (``take_later = later <= earlier``)."""
    vals = np.array([[[1, 10], [1, 11], [0, 12], [0, 13], [5, 14]],
                     [[2, 20], [2, 21], [2, 22], [7, 23], [7, 24]]],
                    np.float32)
    seg = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 0, 0]], np.int32)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), 3, "min_by_first")
    np.testing.assert_array_equal(got.numpy(), [
        [[1, 11], [0, 13], [INF, 0]], [[7, 24], [2, 22], [INF, 0]]])
    for r in range(2):
        np.testing.assert_array_equal(
            got[r].numpy(),
            _np(jref.segment_combine_ref(jnp.asarray(vals[r]),
                                         jnp.asarray(seg[r]), 3,
                                         "min_by_first")))


def test_segment_combine_min_by_first_nan_and_inf_keys():
    """NaN and +-inf keys. Where every evaluation order agrees (a NaN
    that opens its segment wins it, a NaN that closes it loses, -inf
    wins, +inf ties later-wins) the port equals the JAX reference. A NaN
    inside a segment is ROADMAP fault 7: ``_min_by_first`` is not
    associative there, so the JAX scan's answer depends on its tree —
    [2, NaN, 0] gives the 2 — while the port gives what folding the
    pairwise rule in position order gives, the 0, in every order."""
    nan = float("nan")
    vals = np.array([[nan, 1], [3, 2], [1, 3],       # NaN opens: wins
                     [5, 4], [nan, 5],               # NaN closes: loses
                     [INF, 6], [INF, 7], [-INF, 8], [0, 9],  # -inf wins
                     [INF, 10], [INF, 11],           # +inf tie: later
                     [2, 12], [nan, 13], [0, 14]],   # fault 7
                    np.float32)
    seg = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4], np.int32)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), 6,
                                  "min_by_first").numpy()
    want = _np(jref.segment_combine_ref(jnp.asarray(vals), jnp.asarray(seg),
                                        6, "min_by_first"))
    np.testing.assert_array_equal(got[:4], want[:4])
    np.testing.assert_array_equal(got[:4, 1], [1, 4, 8, 11])
    np.testing.assert_array_equal(got[5], want[5])
    assert got[4, 1] == 14 and want[4, 1] == 12  # fault 7, pinned
    # the port's answer does not depend on how the segment is split
    for cut in range(11, 14):
        head = cb.MIN_BY_FIRST.segment_reduce(
            torch.from_numpy(vals[11:cut + 1]),
            torch.zeros(cut - 10, dtype=torch.int32), 1)
        tail = torch.from_numpy(vals[cut + 1:14])
        fold = head[0]
        for row in tail:
            keep = not bool(row[0] <= fold[0])
            fold = fold if keep else row
        assert float(fold[1]) == 14


def test_segment_combine_min_by_first_fault4_pallas_empty_payload():
    """ROADMAP fault 4, the min_by_first half: the JAX Pallas kernel fills
    an empty segment's payload with +inf, its reference with 0
    (``identity_like``); the port holds 0, like the reference."""
    vals, seg, n = _by_first_inputs(4, e=40, n=30, d=3)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n,
                                  "min_by_first").numpy()
    kernel = _np(jops.segment_combine(jnp.asarray(vals), jnp.asarray(seg), n,
                                      "min_by_first", use_kernel=True,
                                      interpret=True))
    empty = np.bincount(seg[(seg >= 0) & (seg < n)], minlength=n) == 0
    assert empty.any()
    np.testing.assert_array_equal(got[~empty], kernel[~empty])
    assert (got[empty, 1:] == 0).all() and (kernel[empty, 1:] == INF).all()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_combine_prod_matches_jax(dtype):
    """int32 exact (wrapping products); float32 within rtol 1e-6 —
    products in another order; empty segments hold 1."""
    rng = np.random.default_rng(12)
    seg = rng.integers(0, 45, 300).astype(np.int32)
    if dtype == np.int32:
        vals = rng.integers(-3, 4, (300, 2)).astype(np.int32)
    else:
        vals = rng.uniform(0.5, 1.5, (300, 2)).astype(np.float32)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), 40, "prod").numpy()
    want = _np(jref.segment_combine_ref(jnp.asarray(vals), jnp.asarray(seg),
                                        40, "prod"))
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got[np.bincount(seg[seg < 40], minlength=40) == 0] == 1).all()


@pytest.mark.parametrize("name", ["prod", "min_by_first", "sum", "max"])
def test_reduce_workers_and_identity_match_jax(name):
    """``reduce_workers`` folds the W workers as the JAX ``psum_like``
    does (``prod`` and ``min_by_first`` in worker order over an
    ``all_gather``); ``identity_like`` as the JAX one."""
    rng = np.random.default_rng(13)
    x = rng.integers(1, 4, (4, 3, 2)).astype(np.float32)
    want = jax.vmap(lambda v: jcb.get(name).psum_like(v, "w"),
                    axis_name="w")(jnp.asarray(x))
    got = cb.get(name).reduce_workers(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    for dtype in (np.float32, np.int32):
        z = np.zeros((2, 3), dtype)
        np.testing.assert_array_equal(
            cb.get(name).identity_like(torch.from_numpy(z)).numpy(),
            _np(jcb.get(name).identity_like(jnp.asarray(z))))


@pytest.mark.parametrize("name,dtype,sensitive", [
    ("sum", torch.float32, True), ("prod", torch.float32, True),
    ("prod", torch.int32, True), ("min_by_first", torch.float32, True),
    ("min_by_first", torch.int32, True), ("sum", torch.int32, False),
    ("min", torch.float32, False), ("max", torch.int32, False),
    ("or", torch.bool, False)])
def test_segment_reduce_dispatch_sorts_into_the_kernel(monkeypatch, name,
                                                       dtype, sensitive):
    """The channels' reduction over unsorted ids: on the card an
    order-sensitive combiner stable-sorts the ids, gathers the values in
    that order and runs the ``segment_combine`` kernel (no float
    atomics); the others keep the plain scatter reduction. The card is
    stood in for by forcing the kernel branch and recording what the
    kernel would be given (its plain version computes the result)."""
    calls = []

    def fake_kernel(vals, seg, n, combiner):
        calls.append((vals, seg))
        return ref.segment_combine_ref(vals, seg, n, combiner)

    monkeypatch.setattr(ops, "_launches_kernel", lambda x, u, what: True)
    monkeypatch.setattr(ops.kseg, "segment_combine_cuda", fake_kernel)
    rng = np.random.default_rng(14)
    seg = torch.from_numpy(rng.integers(-1, 23, (3, 200)).astype(np.int64))
    vals = torch.from_numpy(rng.integers(0, 5, (3, 200, 3))).to(dtype)
    assert ops.order_sensitive(name, dtype) is sensitive
    got = ops.segment_reduce(vals, seg, 20, name)
    want = cb.get(name).segment_reduce(vals, seg, 20)
    assert len(calls) == int(sensitive)
    if sensitive:
        kv, ks = calls[0]
        assert torch.equal(ks, torch.sort(seg, dim=-1, stable=True)[0])
        order = torch.sort(seg, dim=-1, stable=True)[1]
        assert torch.equal(kv, vals.gather(1, order[..., None].expand_as(
            vals)))
    assert torch.equal(got, want)


def test_segment_combine_batched_rows():
    """(W, E, D) rows reduce independently (the channels' layout)."""
    rng = np.random.default_rng(10)
    vals = rng.normal(size=(3, 50, 2)).astype(np.float32)
    seg = np.sort(rng.integers(0, 12, (3, 50)), axis=1).astype(np.int32)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), 10, "max")
    for r in range(3):
        np.testing.assert_array_equal(
            got[r].numpy(),
            _np(jref.segment_combine_ref(jnp.asarray(vals[r]),
                                         jnp.asarray(seg[r]), 10, "max")))


def _seg_shape(case, seed):
    """(vals (E, D) float32, sorted seg (E,), N) of a shape the CUDA
    kernel splits across tiles. Values are small integers, so every sum
    is exact in any order and all three paths agree bit for bit."""
    rng = np.random.default_rng(seed)
    d = 5 if case == "d5" else 1
    if case == "hub":  # one segment of 2000 of the 3000 entries
        e, n = 3000, 200
        seg = rng.integers(0, n, e)
        seg[400:2400] = 77
    elif case == "gaps":  # gaps of 3..1500 empty segments at block edges
        e, n = 2048, 6000
        pos = np.arange(e)
        seg = (pos // 512) * 1500 + (pos % 512) // 64 * 3
    elif case == "tail":  # real ids, then half the row dropped past n
        e, n = 3000, 400
        seg = np.concatenate([rng.integers(0, n, e // 2),
                              rng.integers(n, n + 3, e - e // 2)])
    else:  # "d5": five columns, a few ids dropped
        e, n = 1500, 120
        seg = rng.integers(0, n + 4, e)
    vals = rng.integers(-50, 50, (e, d)).astype(np.float32)
    return vals, np.sort(seg).astype(np.int32), n


@pytest.mark.parametrize("name", ["sum", "min", "max"])
@pytest.mark.parametrize("case", ["hub", "gaps", "tail", "d5"])
def test_segment_combine_ref_matches_jax_on_tile_crossing_shapes(case, name):
    """The oracle the CUDA kernel is held to, against the JAX reference
    and the Pallas kernel in interpret mode, at a long hub, long gaps of
    empty segments, a dropped tail of half the row and D = 5."""
    vals, seg, n = _seg_shape(case, 11)
    got = ref.segment_combine_ref(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n, name).numpy()
    jv, js = jnp.asarray(vals), jnp.asarray(seg)
    want_ref = _np(jref.segment_combine_ref(jv, js, n, name))
    want_kernel = _np(jops.segment_combine(jv, js, n, name, use_kernel=True,
                                           interpret=True,
                                           assume_sorted=True))
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_kernel)


# ---------------------------------------------------------------------------
# dispatch and build
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version():
    ops.reset_launch_counts()
    keys = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    for use_kernel in (None, True):
        rank, counts = ops.bucket_ranks(keys, 2, use_kernel=use_kernel)
        assert rank.tolist() == [0, 0, 1, 0] and counts.tolist() == [2, 1]
        out = ops.segment_combine(torch.ones(4, 1), keys, 2, "sum",
                                  use_kernel=use_kernel)
        assert out[:, 0].tolist() == [2.0, 1.0]
        _, _, lane_counts = ops.bucket_ranks_lanes(
            keys, torch.tensor([[1], [0], [1], [0]], dtype=torch.bool), 2,
            use_kernel=use_kernel)
        assert lane_counts.tolist() == [[2], [0]]
    assert ops.launch_counts() == {"bucket_ranks": 0,
                                   "bucket_ranks_lanes": 0,
                                   "segment_combine": 0}


class _OnCard:
    """Stands in for a CUDA tensor: only ``is_cuda`` is read before the
    dispatch refuses."""

    is_cuda = True


def test_use_kernel_false_on_the_card_raises():
    with pytest.raises(ValueError, match="use_kernel=False with a CUDA"):
        ops.bucket_ranks(_OnCard(), 4, use_kernel=False)
    with pytest.raises(ValueError, match="use_kernel=False with a CUDA"):
        ops.segment_combine(_OnCard(), None, 4, "sum", use_kernel=False)
    with pytest.raises(ValueError, match="use_kernel=False with a CUDA"):
        ops.bucket_ranks_lanes(_OnCard(), None, 4, use_kernel=False)


def test_build_keys_libraries_by_source_and_writes_inside_checkout():
    root = kbuild.BUILD_DIR.parents[1]
    assert (root / "src" / "repro_torch").is_dir()
    assert "build/" in (root / ".gitignore").read_text().splitlines()
    for name in kbuild.SOURCES:
        path = kbuild.library_path(name)
        assert path.parent == kbuild.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
