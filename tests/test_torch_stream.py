"""The port's streaming window dataset against the reference's, on the CPU.

Counterparts of ``tests/test_dataset_stream.py``.  Everything here is
NumPy on both sides, so each comparison is bitwise: the keep-set (blake2b
digests of the same bytes), the batch stream for one seeded generator,
``subsample``'s draw, and ``materialize`` against ``build_windows`` /
``concat_datasets`` — for both dedup scopes.  ``train_tao_impl`` on a
streaming dataset is bitwise the run on its materialized twin (the same
batches, the same eager step).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dataset as ref_dataset  # noqa: E402
from repro.core import features as ref_features  # noqa: E402

from repro_torch.core import dataset as port_dataset  # noqa: E402
from repro_torch.core import features as port_features  # noqa: E402
from repro_torch.core.features import NUM_OPCODES  # noqa: E402
from repro_torch.core.model import TaoConfig  # noqa: E402
from repro_torch.core.transfer import train_tao_impl  # noqa: E402
from repro_torch.uarch.isa import NUM_REGS  # noqa: E402

N_QUEUE, N_MEM, WINDOW = 4, 6, 17
CFG = TaoConfig(window=WINDOW, d_model=32, n_heads=2, n_layers=1, d_ff=64, d_cat=16,
                features=port_features.FeatureConfig(n_buckets=32, n_queue=N_QUEUE, n_mem=N_MEM))


def arrays(n, seed=0, with_labels=True, dup_block=None):
    """Random feature arrays; ``dup_block=(window, every)`` copies the first
    window-aligned block over every ``every``-th block, so windows repeat
    byte for byte."""
    rng = np.random.default_rng(seed)
    out = {
        "opcode": rng.integers(0, NUM_OPCODES, n).astype(np.int32),
        "regbits": (rng.random((n, NUM_REGS)) < 0.1).astype(np.float32),
        "flags": (rng.random((n, 5)) < 0.3).astype(np.float32),
        "brhist": rng.integers(-1, 2, (n, N_QUEUE)).astype(np.float32),
        "memdist": rng.standard_normal((n, N_MEM)).astype(np.float32),
        "labels": None,
    }
    if with_labels:
        out["labels"] = {
            "fetch_lat": rng.integers(0, 8, n).astype(np.float32),
            "exec_lat": rng.integers(1, 12, n).astype(np.float32),
            "mispred": (rng.random(n) < 0.1).astype(np.float32),
            "dlevel": rng.integers(0, 4, n).astype(np.int32),
            "icache_miss": (rng.random(n) < 0.05).astype(np.float32),
            "tlb_miss": (rng.random(n) < 0.02).astype(np.float32),
            "is_branch": (rng.random(n) < 0.2).astype(np.float32),
            "is_mem": (rng.random(n) < 0.3).astype(np.float32),
        }
    if dup_block:
        w, every = dup_block
        leaves = [v for k, v in out.items() if k != "labels"] + list((out["labels"] or {}).values())
        for k in range(every, n // w, every):
            for arr in leaves:
                arr[k * w:(k + 1) * w] = arr[:w]
    return out


def both(a):
    """The same arrays as a reference ``FeatureSet`` and a port one."""
    return ref_features.FeatureSet(**a), port_features.FeatureSet(**a)


def parts_of(specs):
    pairs = [both(arrays(*s)) for s in specs]
    return [r for r, _ in pairs], [p for _, p in pairs]


def assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "labels":
            assert_batches_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_datasets_equal(a, b):
    assert len(a) == len(b)
    assert_batches_equal(a.inputs, b.inputs)
    assert (a.labels is None) == (b.labels is None)
    if a.labels is not None:
        assert_batches_equal(a.labels, b.labels)


# (n, seed, with_labels, dup_block) per trace
STREAM_CASES = {
    "one_trace_collisions": [(3000, 1, True, (WINDOW, 3))],
    "three_traces_one_repeated": [(2000, 1, True, (WINDOW, 4)), (1500, 2, True, None),
                                  (2000, 1, True, (WINDOW, 4))],
    "no_labels": [(1200, 4, False, (WINDOW, 2)), (900, 5, False, None)],
}


@pytest.mark.parametrize("scope", ["trace", "global"])
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_keep_set_batches_and_subsample_match_reference(case, scope):
    ref_parts, port_parts = parts_of(STREAM_CASES[case])
    ref = ref_dataset.StreamingWindowDataset(ref_parts, WINDOW, dedup_scope=scope)
    got = port_dataset.StreamingWindowDataset(port_parts, WINDOW, dedup_scope=scope)
    assert len(got) == len(ref) and got.num_dropped == ref.num_dropped
    assert got.window == ref.window == WINDOW and got.has_labels == ref.has_labels
    np.testing.assert_array_equal(got._part_id, ref._part_id)
    np.testing.assert_array_equal(got._local, ref._local)
    if ref.num_dropped:
        assert len(got) < sum(port_dataset.num_windows(s[0], WINDOW, WINDOW)
                              for s in STREAM_CASES[case])
    assert_datasets_equal(got.materialize(), ref.materialize())
    for drop_last in (True, False):
        rb = list(ref.batches(16, rng=np.random.default_rng(11), drop_last=drop_last))
        gb = list(got.batches(16, rng=np.random.default_rng(11), drop_last=drop_last))
        assert len(gb) == len(rb) > 1
        for a, b in zip(gb, rb):
            assert_batches_equal(a, b)
    sub, ref_sub = got.subsample(24, seed=9), ref.subsample(24, seed=9)
    assert isinstance(sub, port_dataset.StreamingWindowDataset)
    assert sub._parts is got._parts  # the views are shared, not copied
    assert_datasets_equal(sub.materialize(), ref_sub.materialize())
    assert got.subsample(10**9) is got
    # the trace scope is the materialized pipeline's keep-set and stream
    if scope == "trace":
        mat = port_dataset.concat_datasets([port_dataset.build_windows(p, WINDOW) for p in port_parts])
        assert_datasets_equal(got.materialize(), mat)
        for a, b in zip(got.batches(16, rng=np.random.default_rng(3)),
                        mat.batches(16, rng=np.random.default_rng(3))):
            assert_batches_equal(a, b)


def test_global_scope_drops_repeats_across_traces():
    _, port_parts = parts_of(STREAM_CASES["three_traces_one_repeated"])
    glob = port_dataset.StreamingWindowDataset(port_parts, WINDOW, dedup_scope="global")
    assert len(glob) == len(port_dataset.StreamingWindowDataset(port_parts[:2], WINDOW))
    assert len(glob) < len(port_dataset.StreamingWindowDataset(port_parts, WINDOW))


def test_dedup_mask_reservoir_matches_reference():
    a = arrays(2000, seed=8, dup_block=(WINDOW, 3))
    views = [{k: port_dataset.window_view(a[k], WINDOW, WINDOW) for k in port_dataset.INPUT_KEYS},
             {k: port_dataset.window_view(a["labels"][k], WINDOW, WINDOW)
              for k in port_dataset._LABEL_KEYS}]
    seen_ref, seen_port = set(), set()
    for _ in range(2):  # the second pass finds every window in the reservoir
        got = port_dataset._dedup_mask(*views, seen=seen_port)
        np.testing.assert_array_equal(got, ref_dataset._dedup_mask(*views, seen=seen_ref))
    assert seen_port == seen_ref and not got.any()


def test_undeduped_and_single_feature_set():
    ref_fs, port_fs = both(arrays(1200, seed=4, with_labels=False, dup_block=(WINDOW, 2)))
    got = port_dataset.StreamingWindowDataset(port_fs, WINDOW, dedup=False)
    ref = ref_dataset.StreamingWindowDataset(ref_fs, WINDOW, dedup=False)
    assert len(got) == len(ref) == port_dataset.num_windows(1200, WINDOW, WINDOW)
    batch = next(got.batches(8))
    assert "labels" not in batch and batch["opcode"].shape == (8, WINDOW)
    assert_batches_equal(batch, next(ref.batches(8)))


def test_mixed_geometry_bad_scope_and_empty_raise():
    _, long = both(arrays(400, seed=0))
    _, short = both(arrays(9, seed=1))  # 9 < window: a truncated window
    _, unlabelled = both(arrays(400, seed=2, with_labels=False))
    with pytest.raises(ValueError, match="mixed effective windows"):
        port_dataset.StreamingWindowDataset([long, short], WINDOW)
    with pytest.raises(ValueError, match="dedup_scope"):
        port_dataset.StreamingWindowDataset(long, WINDOW, dedup_scope="session")
    with pytest.raises(ValueError, match=">= 1 FeatureSet"):
        port_dataset.StreamingWindowDataset([], WINDOW)
    with pytest.raises(ValueError, match="agree on labels"):
        port_dataset.StreamingWindowDataset([long, unlabelled], WINDOW)


def test_train_on_streaming_dataset_bitwise_equals_materialized():
    _, port_parts = parts_of([(1500, 3, True, (WINDOW, 4)), (1200, 4, True, None)])
    stream = port_dataset.StreamingWindowDataset(port_parts, WINDOW)
    mat = stream.materialize()
    kw = dict(epochs=2, batch_size=8, lr=1e-3, seed=0, device="cpu")
    a = train_tao_impl(CFG, stream.subsample(40, seed=1), **kw)
    b = train_tao_impl(CFG, mat.subsample(40, seed=1), **kw)
    assert a.steps == b.steps == 10
    assert a.losses == b.losses  # bit for bit, not approximately
    for (k, x), y in zip(a.params.state_dict().items(), b.params.state_dict().values()):
        assert torch.equal(x, y), k
