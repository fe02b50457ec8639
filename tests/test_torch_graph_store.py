"""The port's graph store and the config hash it rides on
(``repro_torch.ckpt``) against the JAX package's: the same hash, stores
that cross-load in both directions with equal arrays and CRCs, loud
failures on stale specs and wrong meshes, atomic saves, retention, the
``.tmp_*`` sweep, and corrupted shards repaired from the stream to the
stored CRC; then disk -> traversal against the reference's
``plan_bfs_from_store``.  On the CPU, tolerance 0."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as r_checkpoint
from repro.ckpt import graph_store as r_store
from repro.configs.base import BFSConfig as RConfig
from repro.configs.build_specs import BUILD_SPECS as R_SPECS
from repro.graph import dist_build as R
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.graph_store import (FORMAT_VERSION, GraphStore,
                                          plan_bfs_from_store, shard_crc32)
from repro_torch.configs.base import BFSConfig
from repro_torch.configs.build_specs import BUILD_SPECS
from repro_torch.core.engine import plan_bfs
from repro_torch.graph import dist_build as T
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from repro_torch.runtime.faultinject import corrupt_shard
from _torch_threads import one_thread  # noqa: F401

SPEC = T.BuildSpec(scale=8, edge_factor=8, seed=3)
R_SPEC = R.BuildSpec(scale=8, edge_factor=8, seed=3)
KW = dict(align=32, cap_pad=32)


def _graph(dec="1ds", grid=1):
    mesh = make_local_mesh(*grid, device="cpu") if dec == "2d" \
        else make_local_mesh_1d(grid, device="cpu")
    return T.dist_build(SPEC, dec, mesh, grid, **KW)[0]


def _store(path, **kw):
    return GraphStore(str(path), device="cpu", **kw)


def _same(got, want):
    ga, wa = got.device_arrays(), want.device_arrays()
    assert set(ga) == set(wa)
    for k in ga:
        assert np.array_equal(np.asarray(ga[k]), np.asarray(wa[k])), k
    for c in ("m", "m_input", "cap", "cap_nzc", "cap_seg", "maxdeg_col"):
        assert getattr(got, c, None) == getattr(want, c, None), c


def test_format_version_is_the_reference_one():
    assert FORMAT_VERSION == r_store.FORMAT_VERSION


@pytest.mark.parametrize("obj", [
    *BUILD_SPECS.values(), {"a": 1, "b": [2, 3]}, {"b": (2, 3),
                                                   "a": np.int64(1)},
    {"x": [1.5, None, True, "s", {"z": np.float32(0.25)}]}, [], "s", 7])
def test_config_hash_equals_reference(obj):
    want = obj
    if dataclasses.is_dataclass(obj):
        want = R.BuildSpec(**dataclasses.asdict(obj))
    assert checkpoint.config_hash(obj) == r_checkpoint.config_hash(want)


def test_config_hash_rejects_arbitrary_objects():
    with pytest.raises(TypeError, match="memory address"):
        checkpoint.config_hash(object())
    with pytest.raises(TypeError):
        checkpoint.config_hash({"f": lambda: 0})
    assert [checkpoint.config_hash(s) for s in BUILD_SPECS.values()] == \
        [r_checkpoint.config_hash(s) for s in R_SPECS.values()]


@pytest.mark.parametrize("dec,grid", [("1ds", 1), ("1d", 4), ("2d", (1, 1)),
                                      ("2d", (2, 2))])
def test_stores_cross_load_between_the_packages(tmp_path, dec, grid):
    """The port's store loads in the reference and the reference's in the
    port: equal arrays, capacities and per-shard CRCs, the same meta
    keys, and the spec hash accepted both ways."""
    g = _graph(dec, grid)
    port = _store(tmp_path / "port")
    sdir = port.save_graph("g", g, spec=SPEC)
    ref = r_store.GraphStore(str(tmp_path / "ref"))
    rdir = ref.save_graph("g", r_store.GraphStore(str(tmp_path / "port"))
                          .load_graph("g", expect_spec=R_SPEC), spec=R_SPEC)
    mp = json.load(open(os.path.join(sdir, "meta.json")))
    mr = json.load(open(os.path.join(rdir, "meta.json")))
    assert set(mp) == set(mr)
    for k in set(mp) - {"saved_at"}:
        assert mp[k] == mr[k], k
    back = _store(tmp_path / "ref").load_graph("g", expect_spec=SPEC)
    _same(back, g)
    assert isinstance(back.nnz, torch.Tensor) and back.nnz.device.type == \
        "cpu"
    for k in range(mp["shards"]):
        with np.load(os.path.join(rdir, f"shard_{k:05d}.npz")) as z:
            assert shard_crc32(dict(z)) == r_store.shard_crc32(dict(z)) == \
                mp["shard_crc32"][k]


def test_load_lands_on_the_mesh_device_and_checks_axes(tmp_path):
    store = _store(tmp_path)
    store.save_graph("g2", _graph("1d", 2), spec=SPEC)     # built for p=2
    with pytest.raises(ValueError, match="partitioned for data=2 but the "
                                         "mesh has data=1"):
        store.load_graph("g2", mesh=make_local_mesh_1d(1, device="cpu"))
    g = store.load_graph("g2", mesh=make_local_mesh_1d(2, device="cpu"))
    assert g.part.p == 2 and g.jc.shape[0] == 2
    assert store.load_graph("g2").part.p == 2               # no mesh: host
    store.save_graph("b", _graph("2d", (2, 2)), spec=SPEC)
    with pytest.raises(ValueError, match="model=2 but the mesh has model=1"):
        store.load_graph("b", mesh=make_local_mesh(2, 1, device="cpu"))
    assert store.load_graph("b", mesh=make_local_mesh(
        2, 2, device="cpu")).edge_src.shape[:2] == (2, 2)


def test_stale_spec_hash_and_format_fail_loudly(tmp_path):
    store = _store(tmp_path)
    sdir = store.save_graph("g", _graph(), spec=SPEC)
    with pytest.raises(ValueError, match="spec_hash"):
        store.load_graph("g", expect_spec=dataclasses.replace(SPEC, seed=9))
    with pytest.raises(FileNotFoundError, match="no graph steps"):
        store.load_graph("missing")
    with pytest.raises(TypeError, match="cannot store graph"):
        store.save_graph("x", object())
    meta = json.load(open(os.path.join(sdir, "meta.json")))
    meta["format_version"] = 1
    json.dump(meta, open(os.path.join(sdir, "meta.json"), "w"))
    with pytest.raises(ValueError, match="format_version=1"):
        store.load_graph("g")


def test_interrupted_save_is_atomic(tmp_path, monkeypatch):
    """A writer killed mid-save leaves the previous step intact and
    publishes nothing partial."""
    store = _store(tmp_path)
    g = _graph()
    store.save_graph("g", g, spec=SPEC)
    gdir = os.path.join(str(tmp_path), "graphs", "g")
    before = checkpoint.latest_step(gdir)

    def dying_savez(*a, **kw):
        raise OSError("simulated crash mid-write")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(OSError):
        store.save_graph("g", g, spec=SPEC)
    monkeypatch.undo()
    assert checkpoint.latest_step(gdir) == before == 0
    assert not [d for d in os.listdir(gdir) if d.startswith(".tmp_")]
    assert store.load_graph("g", expect_spec=SPEC).m == g.m


def test_retention_and_tmp_sweep(tmp_path):
    store = _store(tmp_path, keep=2)
    g = _graph()
    for _ in range(5):
        store.save_graph("g", g, spec=SPEC)
    gdir = os.path.join(str(tmp_path), "graphs", "g")
    assert sorted(d for d in os.listdir(gdir) if d.startswith("step_")) == \
        ["step_0000000003", "step_0000000004"]
    assert checkpoint.latest_step(gdir) == 4
    assert checkpoint.latest_step(str(tmp_path / "nope")) is None
    orphan = os.path.join(gdir, ".tmp_interrupted")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "shard_00000.npz"), "wb") as f:
        f.write(b"partial")
    store2 = _store(tmp_path)
    assert not os.path.exists(orphan)
    assert store2.swept == [orphan]
    assert store2.load_graph("g", expect_spec=SPEC).m == g.m
    assert _store(tmp_path / "fresh").swept == []


@pytest.mark.parametrize("dec,grid,mode", [("1ds", 1, "flip"),
                                           ("1d", 4, "truncate"),
                                           ("2d", (2, 2), "flip"),
                                           ("2d", (1, 1), "truncate")])
def test_corrupted_shard_is_quarantined_and_regenerated(tmp_path, dec, grid,
                                                        mode):
    """The seeded corruption is caught by the CRC check, the shard
    regenerated from the stream on the store's device to the stored
    CRC, the repaired file clean on the next load."""
    g = _graph(dec, grid)
    store = _store(tmp_path)
    sdir = store.save_graph("g", g, spec=SPEC)
    path = corrupt_shard(store, "g", seed=2, mode=mode)
    loaded = store.load_graph("g", expect_spec=SPEC)
    rep = store.last_load_report
    k = int(os.path.basename(path)[6:11])
    assert [r["shard"] for r in rep["repaired"]] == [k]
    assert os.path.exists(path + ".quarantined")
    _same(loaded, g)
    with np.load(path) as z:
        crc = shard_crc32(dict(z))
    assert crc == json.load(open(os.path.join(sdir, "meta.json")))[
        "shard_crc32"][k]
    store.load_graph("g", expect_spec=SPEC)
    assert store.last_load_report["repaired"] == []


def test_repair_disabled_or_without_spec_raises(tmp_path):
    store = _store(tmp_path)
    store.save_graph("g", _graph(), spec=SPEC)
    corrupt_shard(store, "g", seed=2, mode="flip")
    with pytest.raises(RuntimeError, match="repair disabled"):
        store.load_graph("g", expect_spec=SPEC, repair=False)
    store.save_graph("h", _graph())             # no BuildSpec in the meta
    corrupt_shard(store, "h", seed=2, mode="flip")
    with pytest.raises(RuntimeError, match="stored without a BuildSpec"):
        store.load_graph("h")


def test_plan_bfs_from_store_equals_reference(tmp_path):
    """Disk -> traversal: the port's store-loaded session (dense, as the
    reference's) gives the reference's parents and levels from its own
    store; compile(store=) finds no program and persists none."""
    root = 5
    ref = r_store.GraphStore(str(tmp_path / "ref"))
    rg, _ = R.dist_build(R_SPEC, "1d", r_mesh_1d(1), 1, **KW)
    ref.save_graph("g", rg, spec=R_SPEC)
    want = r_store.plan_bfs_from_store(
        ref, "g", RConfig(decomposition="1d", instrument=False),
        r_mesh_1d(1), expect_spec=R_SPEC).compile(store=ref).run(root)
    files = sorted(str(x) for x in (tmp_path / "ref").rglob("*"))
    store = _store(tmp_path / "ref")
    mesh = make_local_mesh_1d(1, device="cpu")
    eng = plan_bfs_from_store(
        store, "g", BFSConfig(decomposition="1d", instrument=False), mesh,
        expect_spec=SPEC).compile(store=store)
    got = eng.run(root)
    assert np.array_equal(got.parents, want.parents)
    assert got.n_levels == want.n_levels
    assert not eng.exec_from_store and eng.exec_load_s == 0.0
    assert store.save_executable(eng) is None
    assert store.load_executable(eng.plan) is None
    assert sorted(str(x) for x in (tmp_path / "ref").rglob("*")) == files
    direct = plan_bfs(_graph("1d", 1), BFSConfig(decomposition="1d"),
                      mesh).compile().run(root)
    assert np.array_equal(direct.parents, want.parents)
