"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip without a CUDA device (the kernels have
no CPU mode). This file imports no JAX, so it runs on a machine with only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import combiners as cb
from repro_torch.core import message as msg
from repro_torch.core import routing
from repro_torch.core.channel import ChannelContext
from repro_torch.kernels import ops, ref


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


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", [
    ("sum", torch.float32), ("min", torch.float32), ("max", torch.float32),
    ("sum", torch.int32), ("min", torch.int32), ("or", torch.bool)])
def test_segment_combine_kernel_matches_plain(cuda, name, dtype):
    seg = torch.sort(torch.randint(0, 70, (4, 3000), device=cuda))[0]
    if dtype == torch.float32:
        vals = torch.randn(4, 3000, 3, device=cuda)
    elif dtype == torch.int32:
        vals = torch.randint(-99, 99, (4, 3000, 3), device=cuda,
                             dtype=torch.int32)
    else:
        vals = torch.rand(4, 3000, 3, device=cuda) < 0.2
    got = ops.segment_combine(vals, seg, 64, name)
    want = ref.segment_combine_ref(vals, seg, 64, cb.get(name))
    if name == "sum" and dtype == torch.float32:
        # reassociation only: another summation order than index_add
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
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
