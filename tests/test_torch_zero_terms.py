"""The identity behind bf16 K2's left-out terms (``loss_kernel`` on 64-column
tiles, ``gfedntm_tpu_torch/ops/csrc/fused_decoder.cu``): a row's loss and
row-dot terms ``x * log(p + 1e-10)`` and ``x * p / (p + 1e-10)``, added in
column order in float32, give bitwise the same sums when the terms with
x = 0 are left out, one at a time or eight at a time. A term with x = 0 is
+0 or -0 (-0 where the log is negative), and adding either to a sum that
started at +0 leaves it as it is: such a sum is never -0. On the CPU, in
numpy's float32."""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

FLOOR = np.float32(1e-10)


def row_sums(x, p, keep):
    """(loss, rd) over the columns where ``keep``, in column order."""
    loss, rd = np.float32(0.0), np.float32(0.0)
    for xv, pv, k in zip(x, p, keep):
        if k:
            q = np.float32(pv + FLOOR)
            loss = np.float32(loss + np.float32(xv * np.log(q)))
            rd = np.float32(rd + np.float32(xv * np.float32(pv / q)))
    return loss, rd


def bits(v):
    return int(np.float32(v).view(np.uint32))


X = st.one_of(st.just(0.0), st.just(-0.0), st.integers(1, 6).map(float))
P = st.one_of(st.just(0.0), st.just(1.0), st.just(1e-45), st.just(1e-38),
              st.floats(0.0, 1.0, width=32))
ROWS = st.lists(st.tuples(X, P), min_size=1, max_size=160)


@settings(max_examples=300, deadline=None)
@given(ROWS, st.booleans())
def test_left_out_zero_terms_change_no_bit(row, all_zero):
    x = np.array([0.0 if all_zero else xv for xv, _ in row], dtype=np.float32)
    x[np.array([xv == 0.0 and np.signbit(xv) for xv, _ in row])] = np.float32(-0.0)
    p = np.array([pv for _, pv in row], dtype=np.float32)
    every = row_sums(x, p, np.ones(len(x), bool))
    one_at_a_time = row_sums(x, p, x != 0)
    # Eight columns at a time, as a warp leaves a group out where all its x are 0.
    groups = np.repeat([bool((x[i:i + 8] != 0).any()) for i in range(0, len(x), 8)], 8)
    eight_at_a_time = row_sums(x, p, groups[: len(x)])
    for got in (one_at_a_time, eight_at_a_time):
        assert [bits(v) for v in got] == [bits(v) for v in every]
    assert not any(np.signbit(v) and v == 0 for v in every)


def test_zero_terms_are_signed_zeros_that_add_nothing():
    """The -0.0 products: x = +0 or -0 against a negative log, and against
    log(1) = 0; each added to +0 and to a nonzero sum."""
    logs = np.log(np.array([1e-10, 0.5, 1.0], dtype=np.float32) + FLOOR)
    assert logs[0] < 0 and logs[1] < 0 and logs[2] == 0
    terms = [np.float32(xv * lv) for xv in (np.float32(0.0), np.float32(-0.0)) for lv in logs]
    assert any(np.signbit(t) for t in terms) and all(t == 0 for t in terms)
    for start in (np.float32(0.0), np.float32(-3.25), np.float32(7.5e-39)):
        for t in terms:
            assert bits(np.float32(start + t)) == bits(start)
