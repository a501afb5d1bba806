"""The port's content keys, typed-path trees, checkpoints and artifact
store against the reference's, on the CPU.

Inputs come from a NumPy seed (and the reference's functional simulator,
for a structured trace); each comparison is bitwise:

  * ``array_digest`` / ``tree_digest`` / ``config_token`` /
    ``content_key`` equal the reference's on int, float, bool and int8
    arrays, bfloat16 (the reference's ``ml_dtypes`` array, the port's
    ``torch.bfloat16`` tensor with the same bits), a structured functional
    trace, nested dict / list trees holding ``None``, and ``FeatureConfig``
    of both packages; ``FeatureSet.digest`` equals the reference's.
  * typed-path trees go both ways: a tree written by one package is read
    by the other bitwise, and the same tree gives the same manifest and
    array files from both, byte for byte.
  * ``save_pytree`` / ``restore_pytree``, ``latest_step`` and
    ``CheckpointManager`` mirror ``tests/test_ckpt_data.py``; the store
    mirrors ``tests/test_store.py``, and an entry put by either package's
    ``ArtifactStore`` is read by the other's under the same key.
"""
import dataclasses
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from repro.ckpt import checkpoint as ref_ckpt  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import model as ref_model  # noqa: E402
from repro.store import ArtifactStore as RefStore  # noqa: E402
from repro.store import content as ref_content  # noqa: E402
from repro.store import features_to_tree as ref_features_to_tree  # noqa: E402
from repro.uarch import get_benchmark, run_functional  # noqa: E402

from repro_torch.ckpt import (  # noqa: E402
    CheckpointManager,
    latest_step,
    load_array_tree,
    restore_pytree,
    save_array_tree,
    save_pytree,
    write_array_tree,
)
from repro_torch.core.features import FeatureConfig, extract_features  # noqa: E402
from repro_torch.core.model import TaoConfig  # noqa: E402
from repro_torch.store import (  # noqa: E402
    ArtifactStore,
    array_digest,
    config_token,
    content_key,
    features_to_tree,
    tree_digest,
    tree_to_features,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def trace():
    return run_functional(get_benchmark("lee"), 2000)


def bf16_pair(rng, shape):
    """The same bfloat16 bits as an ``ml_dtypes`` array (the reference's
    leaf) and a ``torch.bfloat16`` tensor (the port's)."""
    bits = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
    return bits.view(ml_dtypes.bfloat16), torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def as_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def trees(trace, seed=0):
    """One tree in each package's leaves: nested dicts and lists, a
    structured trace, bf16, int8, bool, a 0-d leaf and a ``None``."""
    rng = np.random.default_rng(seed)
    ref_bf, port_bf = bf16_pair(rng, (3, 5))
    ints = rng.integers(-1000, 1000, (2, 3)).astype(np.int32)
    floats = rng.standard_normal((4, 2)).astype(np.float32)
    i8 = rng.integers(-128, 128, 7).astype(np.int8)
    ref = {"z": {"b": [ints, floats], "a": np.array(True), "none": None},
           "trace": trace, "bf": ref_bf, "i8": i8, "step": np.array(7, np.int64)}
    port = {"z": {"b": [as_torch(ints), as_torch(floats)], "a": torch.tensor(True), "none": None},
            "trace": trace, "bf": port_bf, "i8": as_torch(i8), "step": torch.tensor(7)}
    return ref, port


def host(x):
    """A leaf as NumPy with bfloat16 as its uint16 words."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        x, y = host(a), host(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def drop_none(tree):
    if isinstance(tree, dict):
        return {k: drop_none(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, list):
        return [drop_none(v) for v in tree]
    return tree


def assert_same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


# ---------------------------------------------------------------------------
# content keys
# ---------------------------------------------------------------------------

ARRAYS = {
    "int32": np.arange(-5, 7, dtype=np.int32).reshape(3, 4),
    "int64": np.arange(10, dtype=np.int64) * (1 << 40),
    "float32": np.linspace(-1, 1, 9, dtype=np.float32),
    "float64": np.linspace(-1, 1, 9),
    "bool": np.array([True, False, True]),
    "int8": np.array([-128, -1, 0, 1, 127], dtype=np.int8),
    "scalar": np.array(3.5, np.float32),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_array_digest_matches_reference(name):
    arr = ARRAYS[name]
    ref = ref_content.array_digest(arr)
    assert array_digest(arr) == ref
    assert array_digest(torch.from_numpy(arr)) == ref  # a tensor hashes as its host view


def test_array_digest_bf16_and_structured_match_reference(trace):
    ref_bf, port_bf = bf16_pair(np.random.default_rng(1), (4, 6))
    assert np.dtype(ml_dtypes.bfloat16).str == "<V2"
    assert array_digest(port_bf) == ref_content.array_digest(ref_bf) == array_digest(ref_bf)
    assert array_digest(trace) == ref_content.array_digest(trace)
    # the dtype is part of the identity: the same bytes as int16 differ
    assert array_digest(port_bf.view(torch.int16)) != array_digest(port_bf)


def test_tree_digest_matches_reference(trace):
    ref, port = trees(trace)
    assert tree_digest(port) == ref_content.tree_digest(ref)
    assert tree_digest(ref) == ref_content.tree_digest(ref)
    # None leaves and positions enter the hash
    assert tree_digest({"a": None}) == ref_content.tree_digest({"a": None})
    assert tree_digest({"a": None}) != tree_digest({})
    assert tree_digest([ARRAYS["int8"], ARRAYS["bool"]]) != tree_digest([ARRAYS["bool"], ARRAYS["int8"]])


def test_config_token_and_content_key_match_reference():
    parts = ("run", 3, 0.1, -2.5e-300, True, None, b"raw", ("a", [1, 2]), {"z": 1, "a": 2.0},
             ARRAYS["int32"], np.int64(5), np.float32(0.25))
    assert content_key("features", *parts) == ref_content.content_key("features", *parts)
    assert config_token(parts) == ref_content.config_token(parts)
    # FeatureConfig has the reference's name and fields: the same token and key
    port_f, ref_f = FeatureConfig(256, 16, 32), ref_features.FeatureConfig(256, 16, 32)
    assert config_token(port_f) == ref_content.config_token(ref_f)
    assert content_key("features", "d", port_f) == ref_content.content_key("features", "d", ref_f)
    # the port's TaoConfig has no use_pallas field: it keys differently
    fields = {f.name for f in dataclasses.fields(ref_model.TaoConfig)} - {
        f.name for f in dataclasses.fields(TaoConfig)}
    assert fields == {"use_pallas"}
    assert content_key("params", TaoConfig()) != ref_content.content_key("params", ref_model.TaoConfig())
    with pytest.raises(TypeError, match="canonicalize"):
        config_token(object())


def test_feature_set_digest_matches_reference(trace):
    fcfg = (64, 4, 8)
    port = extract_features(trace, FeatureConfig(*fcfg))
    ref = ref_features.extract_features(trace, ref_features.FeatureConfig(*fcfg))
    assert port.digest == ref.digest
    assert port.digest == port.digest  # cached
    assert extract_features(trace[:1000], FeatureConfig(*fcfg)).digest != port.digest


# ---------------------------------------------------------------------------
# typed-path trees, both ways
# ---------------------------------------------------------------------------


def test_typed_path_tree_port_to_reference_and_back(tmp_path, trace):
    ref, port = trees(trace)
    write_array_tree(port, str(tmp_path / "p"), {"note": 1})
    got, extra = ref_ckpt.load_array_tree(str(tmp_path / "p"))
    assert extra == {"note": 1}
    assert_trees_equal(got, drop_none(ref))
    ref_ckpt.write_array_tree(ref, str(tmp_path / "r"), {"note": 2})
    got, extra = load_array_tree(str(tmp_path / "r"))
    assert extra == {"note": 2}
    assert_trees_equal(got, drop_none(port))
    assert got["bf"].dtype == torch.bfloat16 and got["bf"].device.type == "cpu"
    assert isinstance(got["z"]["b"], list) and got["trace"].dtype == trace.dtype


def test_typed_path_tree_files_are_the_references_byte_for_byte(tmp_path, trace):
    ref, port = trees(trace)
    write_array_tree(port, str(tmp_path / "p"), {"k": [1, 2]})
    ref_ckpt.write_array_tree(ref, str(tmp_path / "r"), {"k": [1, 2]})
    assert_same_files(tmp_path / "p", tmp_path / "r")


@pytest.mark.parametrize("case", ["root_leaf", "extra_only", "root_bf16", "trace_only", "list_root"])
def test_typed_path_edge_trees_both_ways(tmp_path, trace, case):
    ref_bf, port_bf = bf16_pair(np.random.default_rng(2), (2, 2))
    ref, port = {
        "root_leaf": (ARRAYS["float32"], torch.from_numpy(ARRAYS["float32"])),
        "extra_only": ({}, {}),
        "root_bf16": (ref_bf, port_bf),
        "trace_only": ({"t": trace}, {"t": trace}),
        "list_root": ([ARRAYS["int8"], {"x": ARRAYS["bool"]}],
                      [torch.from_numpy(ARRAYS["int8"]), {"x": torch.from_numpy(ARRAYS["bool"])}]),
    }[case]
    save_array_tree(port, str(tmp_path / "p"), {"case": case})
    ref_ckpt.save_array_tree(ref, str(tmp_path / "r"), {"case": case})
    assert_same_files(tmp_path / "p", tmp_path / "r")
    assert not os.path.exists(str(tmp_path / "p") + ".tmp")
    for d in ("p", "r"):
        got, extra = load_array_tree(str(tmp_path / d))
        assert extra == {"case": case}
        assert_trees_equal(got, port)
        got, _ = ref_ckpt.load_array_tree(str(tmp_path / d))
        assert_trees_equal(got, ref)


def test_truncated_or_foreign_tree_raises(tmp_path, trace):
    _, port = trees(trace)
    write_array_tree(port, str(tmp_path / "e"))
    with open(tmp_path / "e" / "arr_0.bin", "r+b") as f:
        f.truncate(3)
    with pytest.raises(ValueError, match="truncated"):
        load_array_tree(str(tmp_path / "e"))
    save_pytree(port, str(tmp_path / "s"))  # string paths, not typed
    with pytest.raises(ValueError, match="typed-path"):
        load_array_tree(str(tmp_path / "s"))
    with pytest.raises(FileNotFoundError):
        load_array_tree(str(tmp_path / "missing"))


def test_typed_paths_refuse_a_namedtuple(tmp_path):
    from repro_torch.train.optim import adamw_init

    opt = adamw_init({"w": torch.zeros(2)})
    with pytest.raises(TypeError, match="typed-path"):
        write_array_tree(opt, str(tmp_path / "o"))
    write_array_tree(opt._asdict(), str(tmp_path / "o"))  # as a dict it goes


# ---------------------------------------------------------------------------
# save_pytree / restore_pytree / CheckpointManager (mirrors test_ckpt_data.py)
# ---------------------------------------------------------------------------


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2,), dtype=torch.bfloat16), "d": torch.tensor(7, dtype=torch.int32)},
    }


def _ref_tree():
    import jax.numpy as jnp

    return {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "b": {"c": jnp.ones((2,), jnp.bfloat16), "d": jnp.int32(7)},
    }


def test_save_restore_roundtrip_onto_template(tmp_path):
    t = _tree()
    d = str(tmp_path / "step_5")
    save_pytree(t, d, extra={"step": 5})
    r = restore_pytree(t, d)
    assert_trees_equal(r, t)
    # the template decides dtype and device: a float64 template, a numpy one
    tmpl = {"a": torch.zeros(3, 4, dtype=torch.float64), "b": {"c": torch.zeros(2, dtype=torch.float32),
                                                                "d": np.zeros((), np.int64)}}
    r = restore_pytree(tmpl, d)
    assert r["a"].dtype == torch.float64 and torch.equal(r["a"], t["a"].double())
    assert r["b"]["c"].dtype == torch.float32 and torch.equal(r["b"]["c"], torch.ones(2))
    assert isinstance(r["b"]["d"], np.ndarray) and r["b"]["d"].dtype == np.int64 and r["b"]["d"] == 7


def test_save_pytree_files_match_reference_and_restore_both_ways(tmp_path):
    save_pytree(_tree(), str(tmp_path / "p"), extra={"n": 1})
    ref_ckpt.save_pytree(_ref_tree(), str(tmp_path / "r"), extra={"n": 1})
    assert_same_files(tmp_path / "p", tmp_path / "r")
    assert_trees_equal(restore_pytree(_tree(), str(tmp_path / "r")), _tree())
    got = ref_ckpt.restore_pytree(_ref_tree(), str(tmp_path / "p"))
    assert_trees_equal({k: v for k, v in got.items()}, _ref_tree())


def test_atomic_commit_no_tmp_left(tmp_path):
    d = str(tmp_path / "step_1")
    save_pytree(_tree(), d)
    assert os.path.isdir(d)
    assert not os.path.exists(d + ".tmp")


def test_latest_step_ignores_partial(tmp_path):
    root = str(tmp_path)
    save_pytree(_tree(), os.path.join(root, "step_10"))
    save_pytree(_tree(), os.path.join(root, "step_20"))
    # a crash mid-write: an uncommitted tmp dir and a manifest-less dir
    os.makedirs(os.path.join(root, "step_30.tmp"))
    os.makedirs(os.path.join(root, "step_40"))
    assert latest_step(root) == 20
    assert latest_step(str(tmp_path / "none")) is None


def test_manager_auto_resume_and_gc(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep=2, use_async=False)
    t = _tree()
    for s in (1, 2, 3, 4):
        t = {"a": t["a"] + 1, "b": {"c": t["b"]["c"] + 1, "d": t["b"]["d"]}}
        mgr.save(t, s, extra={"note": s})
    restored, extra = mgr.restore_latest(t)
    assert extra["step"] == 4 and extra["note"] == 4
    assert_trees_equal(restored, t)
    assert sorted(n for n in os.listdir(root) if n.startswith("step_")) == ["step_3", "step_4"]
    mgr.close()
    assert CheckpointManager(str(tmp_path / "empty"), use_async=False).restore_latest(t) == (None, None)


def test_manager_async_save_copies_before_enqueue(tmp_path):
    mgr = CheckpointManager(str(tmp_path), use_async=True)
    t = _tree()
    want = {"a": t["a"].clone(), "b": {"c": t["b"]["c"].clone(), "d": t["b"]["d"].clone()}}
    mgr.save(t, 1)
    t["a"].add_(100.0)  # the loop updates in place after the save
    t["b"]["c"].add_(3.0)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 1
    assert_trees_equal(restore_pytree(_tree(), str(tmp_path / "step_1")), want)
    mgr.close()
    assert not mgr._thread.is_alive()


# ---------------------------------------------------------------------------
# ArtifactStore (mirrors test_store.py)
# ---------------------------------------------------------------------------


def test_store_roundtrip_and_counters(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    key = content_key("features", "abc")
    assert st.get("features", key) is None  # miss
    assert st.put("features", key, {"x": torch.arange(3.0)}, {"n": 3})
    assert not st.put("features", key, {"x": torch.arange(3.0)})  # immutable
    assert st.has("features", key)
    tree, extra = st.get("features", key)
    np.testing.assert_array_equal(tree["x"], np.arange(3.0, dtype=np.float32))
    assert extra == {"n": 3}
    s = st.stats()
    assert s["entries"] == 1 and s["hits"] == 1 and s["misses"] == 1
    assert s["puts"] == 1 and s["bytes"] > 0
    assert list(st.list_extras("features")) == [(key, {"n": 3})]
    assert not hasattr(st, "xla_cache_dir")


def test_store_corruption_quarantined(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    key = content_key("params", "k")
    st.put("params", key, {"w": np.arange(50.0)})
    edir = st._entry_dir("params", key)
    for name in os.listdir(edir):
        if name.endswith(".bin"):
            with open(os.path.join(edir, name), "r+b") as f:
                f.truncate(4)
    assert st.get("params", key) is None  # corrupt -> miss
    assert st.counters["corrupt_dropped"] == 1
    assert not st.has("params", key)  # quarantined (deleted)
    assert st.put("params", key, {"w": np.arange(50.0)})  # recompute and re-put
    assert st.get("params", key) is not None


def test_store_gc_budget_and_age(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    for i in range(4):
        st.put("features", content_key("features", i), {"x": np.arange(100.0)})
    assert st.stats()["entries"] == 4
    out = st.gc(max_bytes=st.stats()["bytes"] // 2)
    assert out["evicted"] >= 1
    assert st.stats()["entries"] < 4
    st.gc(max_age_s=0.0)  # everything is "old"
    assert st.stats()["entries"] == 0
    # stale staging dirs are swept, fresh ones are left alone
    os.makedirs(os.path.join(st.root, "tmp", "torn-123-1"))
    os.utime(os.path.join(st.root, "tmp", "torn-123-1"), (0, 0))
    os.makedirs(os.path.join(st.root, "tmp", "fresh-123-2"))
    st.gc()
    assert not os.path.exists(os.path.join(st.root, "tmp", "torn-123-1"))
    assert os.path.exists(os.path.join(st.root, "tmp", "fresh-123-2"))


def test_store_self_gc_with_max_bytes(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"), max_bytes=1)
    st.put("features", content_key("features", 1), {"x": np.arange(100.0)})
    st.put("features", content_key("features", 2), {"x": np.arange(100.0)})
    assert st.stats()["entries"] <= 1  # each put GCs to budget


def test_store_pin_blocks_gc_same_host(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    k1, k2 = content_key("features", 1), content_key("features", 2)
    st.put("features", k1, {"x": np.arange(10.0)})
    st.put("features", k2, {"x": np.arange(10.0) + 1})
    other = ArtifactStore(str(tmp_path / "s"))  # GC from "elsewhere"
    with st.pin("features", k1) as pinned:
        assert pinned
        other.gc(max_age_s=0.0)
        assert st.has("features", k1)  # the pinned entry survives
        assert not st.has("features", k2)  # the unpinned one is collected
        assert other.counters["gc_pin_skips"] == 1
        other.gc(max_bytes=0)  # the byte-budget pass skips it too
        assert st.has("features", k1)
        pinned.release()
        pinned.release()  # idempotent
    other.gc(max_age_s=0.0)  # pin released
    assert not st.has("features", k1)
    # an explicit delete is an operator decision: it ignores pins
    st.put("features", k1, {"x": np.arange(10.0)})
    with st.pin("features", k1):
        assert st.delete("features", k1)
    assert not st.has("features", k1)
    assert not st.delete("features", k1)


def test_store_pin_missing_entry_and_stale_pid(tmp_path):
    st = ArtifactStore(str(tmp_path / "s"))
    with st.pin("features", content_key("features", "never")) as pinned:
        assert not pinned
    k = content_key("features", "x")
    st.put("features", k, {"x": np.arange(3.0)})
    open(os.path.join(st._entry_dir("features", k), ".pin-999999999-1"), "x").close()
    st.gc(max_age_s=0.0)
    assert not st.has("features", k)
    assert st.counters["gc_pin_skips"] == 0
    assert st.counters["stale_pins_swept"] == 1


_PIN_CHILD = r"""
import sys
from repro_torch.store import ArtifactStore
st = ArtifactStore(sys.argv[1])
with st.pin(sys.argv[2], sys.argv[3]) as pinned:
    print("PINNED" if pinned else "MISSING", flush=True)
    sys.stdin.readline()                  # hold the pin until released
print("DONE", flush=True)
"""


def test_store_pin_cross_process(tmp_path):
    """A reader in another process pins an entry: GC here skips it until
    the reader lets go."""
    root = str(tmp_path / "s")
    st = ArtifactStore(root)
    k = content_key("serve_model", "served")
    st.put("serve_model", k, {"w": np.arange(20.0)})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    p = subprocess.Popen([sys.executable, "-c", _PIN_CHILD, root, "serve_model", k],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert p.stdout.readline().strip() == "PINNED"
        st.gc(max_age_s=0.0)
        assert st.has("serve_model", k)  # the reader keeps it alive
        assert st.counters["gc_pin_skips"] == 1
    finally:
        p.stdin.write("\n")
        p.stdin.flush()
        assert p.wait(timeout=120) == 0
    st.gc(max_age_s=0.0)
    assert not st.has("serve_model", k)


# ---------------------------------------------------------------------------
# one store, two packages
# ---------------------------------------------------------------------------


def test_store_entries_cross_packages(tmp_path, trace):
    """A FeatureSet put by the reference's store is read by the port's
    under the key the port computes for it, and the other way round."""
    root = str(tmp_path / "s")
    fcfg = (64, 4, 8)
    ref_fs = ref_features.extract_features(trace, ref_features.FeatureConfig(*fcfg))
    port_fs = extract_features(trace, FeatureConfig(*fcfg))
    ref_key = ref_content.content_key("features", ref_fs.digest, ref_features.FeatureConfig(*fcfg))
    key = content_key("features", port_fs.digest, FeatureConfig(*fcfg))
    assert key == ref_key
    assert RefStore(root).put("features", ref_key, ref_features_to_tree(ref_fs), {"n": len(trace)})
    st = ArtifactStore(root)
    tree, extra = st.get("features", key)
    got = tree_to_features(tree)
    assert extra == {"n": len(trace)} and got.labels is None
    assert got.digest == port_fs.digest
    # the other way: the port puts, the reference reads
    ref_bf, port_bf = bf16_pair(np.random.default_rng(3), (8,))
    k2 = content_key("params", "bf16", array_digest(port_bf))
    assert k2 == ref_content.content_key("params", "bf16", ref_content.array_digest(ref_bf))
    assert st.put("params", k2, {"w": port_bf, "fs": features_to_tree(port_fs)})
    ref_tree, _ = RefStore(root).get("params", k2)
    assert_trees_equal(ref_tree["w"], ref_bf)
    assert_trees_equal(ref_tree["fs"], ref_features_to_tree(ref_fs))
