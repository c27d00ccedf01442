"""The SSD scan's copy route (``repro_torch.kernels.ssd_scan.route``).

The kernel stages x, B and C with 16-byte copies (``"vec16"``) when every
row of them, and the initial state, starts on 16 bytes: x, B, C and the
initial state 16-byte aligned, and the batch and time strides of x, B and
C multiples of 8 elements.  Otherwise it takes 4-byte copies (``"vec4"``);
the wrapper accepts rows that are only 4-byte aligned with even strides.
The kernel's entry point decides from the same pointers and strides, and
the wrapper counts each launch under ``route``'s answer.  The choice is a
plain function of pointers and strides, so it is held here on CPU tensors
and views; nothing launches.
"""
import pytest
import torch

from repro_torch.kernels import ssd_scan

BF16 = torch.bfloat16


def _proj(Bb, L, H, P, G, N, extra=0, offset=0):
    """x, B and C sliced from one (Bb, L, H*P + 2*G*N + extra) projection,
    as the model passes them, starting ``offset`` elements into a 16-byte
    aligned buffer."""
    width = H * P + 2 * G * N + extra
    buf = torch.zeros(Bb * L * width + offset + 8, dtype=BF16)
    assert buf.data_ptr() % 16 == 0
    proj = buf[offset:offset + Bb * L * width].view(Bb, L, width)
    x = proj[..., :H * P].unflatten(-1, (H, P))
    Bm = proj[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = proj[..., H * P + G * N:H * P + 2 * G * N].unflatten(-1, (G, N))
    return x, Bm, Cm


def _state(Bb, H, P, N, offset=0):
    buf = torch.zeros(Bb * H * P * N + offset, dtype=torch.float32)
    return buf[offset:].view(Bb, H, P, N)


CASES = {
    # id: (make (x, B, C, initial state), expected route)
    "model_projection": (lambda: (*_proj(1, 128, 80, 64, 1, 128), None),
                         "vec16"),
    "model_projection_with_state": (
        lambda: (*_proj(2, 32, 80, 64, 1, 128), _state(2, 80, 64, 128)),
        "vec16"),
    "contiguous_small": (
        lambda: (torch.zeros(2, 40, 4, 16, dtype=BF16),
                 torch.zeros(2, 40, 2, 16, dtype=BF16),
                 torch.zeros(2, 40, 2, 16, dtype=BF16),
                 _state(2, 4, 16, 16)), "vec16"),
    "projection_plus_6": (lambda: (*_proj(2, 70, 4, 64, 2, 128, extra=6),
                                   _state(2, 4, 64, 128)), "vec4"),
    "projection_plus_8": (lambda: (*_proj(2, 70, 4, 64, 2, 128, extra=8),
                                   None), "vec16"),
    "projection_off_16_bytes": (
        lambda: (*_proj(1, 16, 4, 64, 1, 64, offset=2), None), "vec4"),
    "state_off_16_bytes": (
        lambda: (*_proj(1, 16, 4, 64, 1, 64), _state(1, 4, 64, 64, 1)),
        "vec4"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_is_a_function_of_pointers_and_strides(case):
    make, want = CASES[case]
    x, Bm, Cm, h0 = make()
    before = dict(ssd_scan.launches)
    before_routes = dict(ssd_scan.route_launches)
    assert ssd_scan.route(x, Bm, Cm, h0) == want
    assert ssd_scan.route(x, Bm, Cm, h0) == want            # no state
    assert ssd_scan.launches == before
    assert ssd_scan.route_launches == before_routes


def test_batch_stride_alone_decides_for_one_slot():
    """A batch stride that is not a multiple of 8 leaves the 16-byte route
    even for one slot: the rule reads strides, not shapes."""
    x, Bm, Cm = _proj(1, 8, 4, 64, 1, 64)
    assert ssd_scan.route(x, Bm, Cm) == "vec16"
    odd = torch.zeros(1, 8, 4, 64, dtype=BF16).as_strided(
        (1, 8, 4, 64), (2 * 8 * 4 * 64 + 2, 4 * 64, 64, 1))
    assert ssd_scan.route(odd, Bm, Cm) == "vec4"


def test_routes_are_counted_beside_the_kernel():
    assert set(ssd_scan.route_launches) == set(ssd_scan.ROUTES)
    ssd_scan.route_launches["vec16"] += 2
    ssd_scan.launches["ssd_scan"] += 2
    ssd_scan.reset_launches()
    assert ssd_scan.launches == {"ssd_scan": 0}
    assert all(n == 0 for n in ssd_scan.route_launches.values())


def test_wrapper_refuses_cpu_tensors_before_counting():
    x, Bm, Cm = _proj(1, 8, 4, 16, 1, 16)
    dt = torch.zeros(1, 8, 4)
    A = torch.zeros(4)
    before = dict(ssd_scan.route_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan.ssd_scan(x, dt, A, Bm, Cm)
    assert ssd_scan.route_launches == before
