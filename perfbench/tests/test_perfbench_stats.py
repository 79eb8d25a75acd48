"""The metric arithmetic on synthetic inputs."""

import statistics

import pytest

from perfbench.harness import stats, tracing
from perfbench.harness.readers import ReadContext


def test_percentile_is_over_every_value():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 0) == 1 and stats.percentile(xs, 100) == 100
    assert stats.percentile([5.0], 95) == 5.0
    # one slow proof among twenty lifts the 95th percentile
    assert stats.percentile([1.0] * 19 + [10.0], 95) == pytest.approx(1.45)


def test_rate_counts_whole_proofs_over_the_window():
    spans = [(0.0, 1.0), (1.0, 2.0), (2.0, 3.5)]
    assert stats.window(spans) == (0.0, 3.5)
    assert stats.rate(spans, 3) == pytest.approx(3 / 3.5)
    # a proof that failed holds the window open but is not counted
    assert stats.rate(spans, 2) == pytest.approx(2 / 3.5)


def test_union_merges_overlaps_and_clips():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert stats.union(iv, 0, 10) == [(0, 3), (5, 6), (8, 10)]
    assert stats.covered(iv, 0, 10) == pytest.approx(6)
    # a sum of durations would count the overlaps twice
    assert sum(e - s for s, e in iv) > stats.covered(iv, 0, 12)
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (6, 8)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_spread_uses_python_quartiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_short_kernel_names():
    assert tracing.short_name(
        "void poseidon_permute_warp_kernel<17>(unsigned int const*, "
        "unsigned int*, long, ChainConsts)") == \
        "poseidon_permute_warp_kernel<17>"
    assert tracing.short_name("fr_fold_kernel(unsigned int const*)") == \
        "fr_fold_kernel"
    assert tracing.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"


def _trace(offset_us):
    """Two traced proofs at 10-20 s and 20-30 s on the harness clock."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.SETTLE_SPAN,
         "ts": 0 + offset_us, "dur": 9e6},
        {"ph": "X", "cat": "user_annotation", "name": tracing.PROOF_SPAN,
         "ts": 10e6 + offset_us, "dur": 10e6},
        {"ph": "X", "cat": "user_annotation", "name": tracing.PROOF_SPAN,
         "ts": 20e6 + offset_us, "dur": 10e6},
        # device work: two overlapping kernels, a copy, one in the settle
        {"ph": "X", "cat": "kernel", "ts": 12e6 + offset_us, "dur": 2e6,
         "name": "void poseidon_permute_kernel<17>(unsigned int const*)"},
        {"ph": "X", "cat": "kernel", "ts": 13e6 + offset_us, "dur": 2e6,
         "name": "void poseidon_permute_warp_kernel<9>(long)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 25e6 + offset_us, "dur": 1e6,
         "name": "Memcpy DtoH (Device -> Pageable)"},
        {"ph": "X", "cat": "kernel", "ts": 1e6 + offset_us, "dur": 1e6,
         "name": "fr_fold_kernel(int)"},
        {"ph": "X", "cat": "cpu_op", "ts": 11e6 + offset_us, "dur": 5e6,
         "name": "aten::add"},
    ]
    return ev


@pytest.mark.parametrize("offset_us", [0.0, 1.7e15])
def test_read_stretch(offset_us):
    phases = [("ali/host_absorb", 15.0, 21.0), ("fri/build_f0", 10.0, 21.5),
              ("fri/queries", 26.0, 29.0)]
    st = tracing.read_stretch(_trace(offset_us), [(10.0, 20.0),
                                                  (20.0, 30.0)], phases)
    assert st.proofs == 2
    assert st.window_s == pytest.approx(20.0)
    assert st.busy_s == pytest.approx(4.0)          # 12-15 and 25-26
    assert st.kernel_seconds(r"^poseidon_permute(_warp)?_kernel<") == \
        pytest.approx(4.0)
    assert st.top_ops()[0][1] == pytest.approx(2.0)
    names = dict((round(s, 6), n) for n, s in st.idle_gaps)
    assert names[10.0] == "ali/host_absorb"         # 15-25: the innermost
    assert names[2.0] == "fri/build_f0"             # 10-12
    assert names[4.0] == "fri/queries"              # 26-30
    ctx = ReadContext({}, {}, {}, 2, {}, st)
    from perfbench.harness import registry
    assert registry.metric_reader("device_idle_share").read(ctx) == \
        pytest.approx(0.8)


def test_read_stretch_without_marks_reads_nothing():
    assert tracing.read_stretch([], [(0.0, 1.0)], []) is None


def test_phase_means():
    ctx = ReadContext({}, {}, {}, 4, {"a": 2.0, "b": 0.4}, None)
    assert ctx.phase_ms("a") == pytest.approx(500.0)
    assert ctx.phase_ms("a", "b", "c") == pytest.approx(600.0)
    assert ctx.phase_ms("c") is None
