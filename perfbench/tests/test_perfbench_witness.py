"""The witness generator: deterministic in the seed, uniform below P."""

import numpy as np
import pytest

from perfbench.harness import witness
from perfbench.reference.field import P, mont_rows_to_ints


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**64 + 3, -12])
def test_deterministic_and_below_p(seed):
    a = witness.field_rows(witness.generator(seed, "s"), 4096)
    b = witness.field_rows(witness.generator(seed, "s"), 4096)
    assert a.dtype == np.uint64 and a.shape == (4096, 4)
    assert np.array_equal(a, b)
    vals = witness.as_ints(a)
    assert all(0 <= v < P for v in vals)
    # about half the 255-bit draws are below P: the top bits vary
    assert max(vals) > P // 2 and min(vals) < P // 64


def test_streams_and_seeds_differ():
    base = witness.field_rows(witness.generator(5, "s"), 64)
    for other in (witness.generator(6, "s"), witness.generator(-5, "s"),
                  witness.generator(5, "t")):
        assert not np.array_equal(base, witness.field_rows(other, 64))


def test_rejection_keeps_rows_at_p_out():
    p_row = np.array([[(P >> (64 * i)) & (2**64 - 1) for i in range(4)]],
                     dtype=np.uint64)
    below = p_row.copy()
    below[0, 0] -= np.uint64(1)
    assert not witness._below_p(p_row)[0]
    assert witness._below_p(below)[0]


def test_limb_views_carry_the_same_bytes():
    rows = witness.field_rows(witness.generator(3, "s"), 16)
    limbs = witness.as_limbs_int32(rows)
    assert limbs.dtype == np.int32 and limbs.shape == (16, 8)
    assert limbs.tobytes() == rows.tobytes()
    # the field value of a Montgomery row x is x / 2^256
    x = witness.as_ints(rows)[0]
    assert mont_rows_to_ints(rows[:1])[0] * (1 << 256) % P == x % P
