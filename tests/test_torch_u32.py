"""uint32 helpers of the PyTorch port (snap_rnaseq_tpu_torch/ops/u32.py)
against numpy uint32 arithmetic, including the wrap-around corners."""
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu_torch.ops import u32

_CORNERS = np.array([0, 1, 2, 7, 0x7FFFFFFF, 0x80000000, 0x80000001,
                     0xFFFFFFFE, 0xFFFFFFFF, 0x55555555, 0xAAAAAAAA],
                    np.uint32)


def _values(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([_CORNERS, v])


def _pairs(seed):
    a = _values(seed)
    b = np.roll(_values(seed + 1), 3)
    grid_a, grid_b = np.meshgrid(_CORNERS, _CORNERS)
    return (np.concatenate([a, grid_a.ravel()]),
            np.concatenate([b, grid_b.ravel()]))


def test_roundtrip_and_const():
    a = _values(0)
    t = u32.from_numpy(a)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(u32.to_numpy(t), a)
    for v in _CORNERS:
        assert np.int32(u32.const(int(v))) == np.asarray(v).view(np.int32)


@pytest.mark.parametrize("s", [1, 3, 4, 13, 16, 31])
def test_shifts(s):
    a = _values(s)
    t = u32.from_numpy(a)
    np.testing.assert_array_equal(u32.to_numpy(u32.shr(t, s)), a >> np.uint32(s))
    np.testing.assert_array_equal(u32.to_numpy(t << s), a << np.uint32(s))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "xor"])
def test_wrapping_arithmetic(op):
    a, b = _pairs(11)
    ta, tb = u32.from_numpy(a), u32.from_numpy(b)
    with np.errstate(over="ignore"):
        want = {"add": a + b, "sub": a - b, "mul": a * b, "xor": a ^ b}[op]
    got = {"add": ta + tb, "sub": ta - tb, "mul": ta * tb, "xor": ta ^ tb}[op]
    np.testing.assert_array_equal(u32.to_numpy(got), want)


def test_unsigned_compares_and_min():
    a, b = _pairs(5)
    ta, tb = u32.from_numpy(a), u32.from_numpy(b)
    np.testing.assert_array_equal(u32.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(u32.ule(ta, tb).numpy(), a <= b)
    np.testing.assert_array_equal(u32.to_numpy(u32.umin(ta, tb)),
                                  np.minimum(a, b))
    # scalar right-hand sides, as the engine compares against genome sizes
    for v in (0, 5, 0x80000000, 0xFFFFFFFF):
        np.testing.assert_array_equal(u32.ult(ta, v).numpy(),
                                      a < np.uint32(v))


def test_order_map_and_widening():
    a = _values(9)
    t = u32.from_numpy(a)
    order = np.argsort(a, kind="stable")
    got = torch.sort(u32.ord32(t), stable=True).indices.numpy()
    np.testing.assert_array_equal(a[got], a[order])
    np.testing.assert_array_equal(u32.to_i64(t).numpy(), a.astype(np.int64))
    np.testing.assert_array_equal(
        u32.to_numpy(u32.from_i64(u32.to_i64(t) * 3 + 7)),
        (a.astype(np.uint64) * 3 + 7).astype(np.uint32))
