"""The port's float scatter-add (``segments.index_add_float``) and its
ordered route (``segments.ordered_index_add_``: drop, stable sort, the
``seg_sum`` kernel's serial sums), on the CPU. The ordered route, called
directly, must equal the CPU's ``index_add_`` bit for bit on adversarial
floats (many rows on few slots, magnitudes from 2^-60 to 2^60, signed
zeros, a dropped slot); the same rows in a shuffled order must give
other bits, so the comparison can fail. The kernel itself is held to its
plain version on the card by tests/test_torch_cuda.py and
``chip_smoke.py`` phase 2."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from spades_for_blackbird_tpu_torch.ops import segments  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import seg_sum  # noqa: E402


def _adversarial(n, M, cols, dtype, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n + 1, M)
    hot = rng.random(M) < 0.7                  # most rows on 3 slots
    idx[hot] = rng.integers(0, 3, hot.sum())
    vals = rng.standard_normal((M, cols)) * np.exp2(
        rng.integers(-60, 60, (M, cols)))
    vals[rng.random((M, cols)) < 0.01] = -0.0
    shape = (M,) if cols == 1 else (M, cols)
    return (torch.from_numpy(idx),
            torch.from_numpy(vals.reshape(shape)).to(dtype))


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cols", [1, 5])
def test_ordered_route_equals_index_add_bit_for_bit(dtype, cols):
    n, M = 40, 20_000
    idx, vals = _adversarial(n, M, cols, dtype, seed=cols)
    shape = (n + 1,) if cols == 1 else (n + 1, cols)
    init = torch.zeros(shape, dtype=dtype)
    init[5] = 1e20                               # a slot that starts full
    want = init.clone().index_add_(0, idx, vals)[:n]
    got = segments.ordered_index_add_(init.clone(), idx, vals, limit=n)[:n]
    assert torch.equal(_bits(got), _bits(want))
    # the same rows in another order: other bits, so the test can fail
    perm = torch.from_numpy(np.random.default_rng(9).permutation(M))
    other = init.clone().index_add_(0, idx[perm], vals[perm])[:n]
    assert not torch.equal(_bits(other), _bits(want))


def test_drop_scatter_and_unique_counts_sum_floats_in_row_order():
    idx, vals = _adversarial(30, 5000, 1, torch.float32, seed=3)
    want = torch.zeros(31).index_add_(0, idx, vals)[:30]
    got = segments.drop_scatter(30, idx, vals)
    assert torch.equal(_bits(got), _bits(want))
    # amax / amin drop the dropped slot's rows first: the same values
    for reduce, init in (("amax", -1.0), ("amin", 1.0)):
        ref = torch.full((31,), init).scatter_reduce_(
            0, idx, vals, reduce, include_self=True)[:30]
        assert torch.equal(segments.drop_scatter(30, idx, vals, reduce,
                                                 init=init), ref)
    keys = torch.tensor([[1], [1], [2], [3], [3], [3]])
    valid = torch.tensor([True, True, True, True, False, True])
    w = torch.tensor([0.1, 0.2, 1e-8, 3.0, 5.0, 1e8])
    _, counts, _, num = segments.unique_counts(keys, valid, w)
    assert int(num) == 3
    assert torch.equal(counts[:3], torch.stack([
        w[0] + w[1], w[2], w[3] + w[5]]))


def test_empty_and_all_dropped_rows():
    out = torch.full((4,), 2.5)
    segments.ordered_index_add_(out, torch.tensor([4, 4]),
                                torch.tensor([1.0, 2.0]), limit=4)
    assert out.tolist() == [2.5] * 4
    empty = torch.zeros((0, 3))
    assert segments.ordered_index_add_(
        empty, torch.zeros(0, dtype=torch.long), torch.zeros((0, 3))
    ).shape == (0, 3)


def test_the_card_route_refuses_integer_sums():
    """On the card the wrapper takes float32 and float64 only (integer
    sums keep ``index_add_``, exact in any order); checked before any
    launch, so the refusal shows without a card's tensors too."""
    kernel = seg_sum.SegSumKernel()
    with pytest.raises(ValueError, match="float"):
        kernel(torch.zeros(3, 1, dtype=torch.int64, device="meta"),
               torch.zeros(2, dtype=torch.int64, device="meta"),
               torch.zeros(2, 1, dtype=torch.int64, device="meta"))
    assert kernel.launches == 0
    # on the CPU the wrapper is its plain version
    out = kernel(torch.zeros(3, 1), torch.tensor([0, 0, 2]),
                 torch.tensor([[1.0], [2.0], [4.0]]))
    assert out[:, 0].tolist() == [3.0, 0.0, 4.0] and kernel.launches == 0


def _route_case(case):
    """(out, index, src, limit) of one adversarial scatter for the route."""
    rng = np.random.default_rng(len(case))
    tile = seg_sum.tile_rows(1, torch.float32)
    if case == "one slot holds every row":
        n, M, cols, dtype = 6, 30_000, 1, torch.float32
        idx = np.full(M, 4)
    elif case == "a run longer than any tile":
        n, M, cols, dtype = 50, 3 * tile + 5_000, 1, torch.float32
        idx = rng.integers(0, n + 1, M)
        idx[rng.permutation(M)[:3 * tile + 7]] = 17
    elif case == "C = 21 float32":
        n, M, cols, dtype = 300, 12_000, 21, torch.float32
        idx = rng.integers(0, n + 1, M)
        idx[rng.random(M) < 0.5] = 2
    else:  # float64 with signed zeros and the dropped slot
        n, M, cols, dtype = 40, 20_000, 3, torch.float64
        idx = rng.integers(0, n + 1, M)
        idx[rng.random(M) < 0.3] = n
    vals = rng.standard_normal((M, cols)) * np.exp2(
        rng.integers(-60, 60, (M, cols)))
    vals[rng.random((M, cols)) < 0.05] = -0.0
    vals[rng.random((M, cols)) < 0.05] = 0.0
    shape = (n + 1,) if cols == 1 else (n + 1, cols)
    out = torch.zeros(shape, dtype=dtype)
    out[n] = 7.0                                    # the dropped slot
    out[1] = -0.0
    src = torch.from_numpy(vals if cols > 1 else vals[:, 0]).to(dtype)
    return out, torch.from_numpy(idx), src, n


@pytest.mark.parametrize("case", ["one slot holds every row",
                                  "a run longer than any tile",
                                  "C = 21 float32",
                                  "float64 with signed zeros and the "
                                  "dropped slot"])
def test_route_cases_equal_index_add_bit_for_bit(case):
    """The route (int32 keys, the dropped rows keyed at the limit, the
    rows read through the permutation) equals the CPU's ``index_add_``
    bit for bit, the dropped slot's value untouched; the same rows
    shuffled give other bits, so the comparison can fail."""
    out, idx, src, n = _route_case(case)
    keep = idx < n
    want = out.clone()
    want[:n].index_add_(0, idx[keep], src[keep])
    got = segments.ordered_index_add_(out.clone(), idx, src, limit=n)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got[n]), _bits(out[n]))
    perm = torch.from_numpy(np.random.default_rng(1).permutation(len(idx)))
    other = out.clone()
    other[:n].index_add_(0, idx[perm][keep[perm]], src[perm][keep[perm]])
    assert not torch.equal(_bits(other), _bits(want))


def test_sorted_slots_keys_int32_below_2_31_and_drop_last():
    idx = torch.tensor([5, 2, 9, 2, 1 << 40, 0, 5])
    slot, perm = segments.sorted_slots(idx, 6)
    assert slot.dtype == torch.int32
    assert slot.tolist() == [0, 2, 2, 5, 5, 6, 6]
    assert perm.tolist() == [5, 1, 3, 0, 6, 2, 4]   # stable: row order kept
    slot, perm = segments.sorted_slots(idx, 1 << 31)
    assert slot.dtype == torch.int64
    assert slot.tolist() == [0, 2, 2, 5, 5, 9, 1 << 31]
    assert seg_sum.tile_rows(1, torch.float32) * 4 == seg_sum.TILE_BYTES
    assert seg_sum.tile_rows(21, torch.float32) >= 1
