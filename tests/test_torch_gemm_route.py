"""The grouped GEMM's route (``repro_torch.kernels.grouped_matmul.route``).

The wrapper sends operands that a TMA tensor map can describe (bf16, last
axes dense, K and N multiples of 8, 16-byte-aligned data pointers, outer
strides that are positive multiples of 8 elements) to the kernel on
``wgmma`` fed by TMA, and everything else to the kernel on ``mma.sync``.
The choice is a plain function of dtype, shapes, strides and pointers, so
it is held here on CPU tensors and views; nothing launches.
"""
import pytest
import torch

from repro_torch.kernels import grouped_matmul

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

BF16 = torch.bfloat16


def _dense(E, C, K, N, dtype=BF16):
    return torch.zeros(E, C, K, dtype=dtype), torch.zeros(E, K, N,
                                                          dtype=dtype)


def _offset(shape, dtype=BF16):
    """A contiguous tensor whose data pointer is one element past a
    16-byte boundary."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.zeros(n + 16, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    return buf[1:1 + n].view(*shape)


def _wide(shape, extra, dtype=BF16):
    """A view of the first shape[-1] columns of a wider buffer: the row
    stride is shape[-1] + extra."""
    *lead, last = shape
    return torch.zeros(*lead, last + extra, dtype=dtype)[..., :last]


CASES = {
    # id: (make operands, expected route)
    "bf16_aligned": (lambda: _dense(8, 20, 64, 128), "tma"),
    "bf16_decode_shape": (lambda: _dense(2, 512, 4096, 256), "tma"),
    "one_row": (lambda: _dense(3, 1, 64, 128), "tma"),
    "lhs_row_stride_multiple_of_8": (
        lambda: (_wide((3, 70, 256), 24), torch.zeros(3, 256, 200,
                                                      dtype=BF16)), "tma"),
    "float32": (lambda: _dense(8, 20, 64, 128, torch.float32), "mma_sync"),
    "k_not_multiple_of_8": (lambda: _dense(4, 50, 70, 128), "mma_sync"),
    "n_not_multiple_of_8": (lambda: _dense(4, 50, 64, 33), "mma_sync"),
    "k_zero": (lambda: _dense(2, 4, 0, 16), "mma_sync"),
    "lhs_misaligned": (lambda: (_offset((2, 8, 64)),
                                torch.zeros(2, 64, 64, dtype=BF16)),
                       "mma_sync"),
    "rhs_misaligned": (lambda: (torch.zeros(2, 8, 64, dtype=BF16),
                                _offset((2, 64, 64))), "mma_sync"),
    "lhs_row_stride_not_multiple_of_8": (
        lambda: (_wide((2, 33, 96), 3), torch.zeros(2, 96, 64,
                                                    dtype=BF16)),
        "mma_sync"),
    "rhs_row_stride_not_multiple_of_8": (
        lambda: (torch.zeros(2, 33, 96, dtype=BF16),
                 _wide((2, 96, 64), 5)), "mma_sync"),
    "rhs_expert_stride_zero": (
        lambda: (torch.zeros(4, 16, 64, dtype=BF16),
                 torch.zeros(1, 64, 64, dtype=BF16).expand(4, 64, 64)),
        "mma_sync"),
    "lhs_last_axis_strided": (
        lambda: (torch.zeros(2, 64, 16, dtype=BF16).transpose(1, 2),
                 torch.zeros(2, 64, 64, dtype=BF16)), "mma_sync"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_is_a_function_of_dtype_shape_stride_and_pointer(case):
    make, want = CASES[case]
    lhs, rhs = make()
    before = dict(grouped_matmul.launches)
    before_routes = dict(grouped_matmul.route_launches)
    assert grouped_matmul.route(lhs, rhs) == want
    assert grouped_matmul.route(lhs, rhs) == want          # no state
    assert grouped_matmul.launches == before
    assert grouped_matmul.route_launches == before_routes


def test_routes_are_counted_beside_the_kernel():
    assert set(grouped_matmul.route_launches) == set(grouped_matmul.ROUTES)
    grouped_matmul.route_launches["tma"] += 3
    grouped_matmul.launches["grouped_matmul"] += 3
    grouped_matmul.reset_launches()
    assert grouped_matmul.launches == {"grouped_matmul": 0}
    assert all(n == 0 for n in grouped_matmul.route_launches.values())


def test_wrapper_refuses_cpu_tensors_before_routing():
    lhs, rhs = _dense(2, 4, 64, 64)
    before = dict(grouped_matmul.route_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        grouped_matmul.grouped_matmul(lhs, rhs)
    assert grouped_matmul.route_launches == before
