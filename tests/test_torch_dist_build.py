"""The port's born-sharded build (``repro_torch.graph.dist_build``), its
closed forms (``core/comm_model.py``), the build pins
(``configs/build_specs.py``) and ``ckpt/elastic.py::repartition_graph``
against the JAX package's and the port's host builders, tolerance 0 (every
output is an integer array).  The 4-, 7- and 16-strip and 2x2/2x4/4x4
builds against the JAX package's on forced host devices are in
``test_torch_dist_build_mesh.py``."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.ckpt import graph_store as r_store
from repro.core import comm_model as r_comm
from repro.graph import dist_build as R
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d
from repro.configs import build_specs as r_specs
from repro_torch.ckpt.checkpoint import config_hash
from repro_torch.ckpt.elastic import repartition_graph
from repro_torch.ckpt.graph_store import GraphStore
from repro_torch.configs import build_specs
from repro_torch.core import comm_model
from repro_torch.graph import dist_build as T
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from repro_torch.runtime.retry import CapacityOverflow
from _torch_threads import one_thread  # noqa: F401

SPEC = T.BuildSpec(scale=9, edge_factor=8, seed=3)
R_SPEC = R.BuildSpec(scale=9, edge_factor=8, seed=3)
KW = dict(align=32, cap_pad=32)


def _mesh(dec, grid):
    if dec == "2d":
        return make_local_mesh(*grid, device="cpu")
    return make_local_mesh_1d(grid, device="cpu")


def _host(dec, grid, **kw):
    edges = rmat_graph(SPEC.scale, SPEC.edge_factor, seed=SPEC.seed,
                       generator="counter", device="cpu")
    if dec == "2d":
        return build_blocked(edges, *grid, **KW)
    return build_blocked_1d(edges, grid, **KW, **kw)


def _same_graph(got, want, tag=""):
    for c in ("cap", "cap_nzc", "cap_seg", "maxdeg_col", "m", "m_input"):
        assert getattr(got, c, None) == getattr(want, c, None), (tag, c)
    ga, wa = got.device_arrays(), want.device_arrays()
    assert set(ga) == set(wa), (tag, sorted(ga), sorted(wa))
    for k in ga:
        assert torch.equal(ga[k], wa[k]), (tag, k)


def test_build_spec_is_the_reference_dataclass():
    """Class name, field order and defaults are the JAX package's (the
    store's config hash is tagged with them), as are the properties and
    the validation errors."""
    f = [(x.name, x.default) for x in dataclasses.fields(T.BuildSpec)]
    assert f == [(x.name, x.default) for x in dataclasses.fields(R.BuildSpec)]
    assert T.BuildSpec.__name__ == R.BuildSpec.__name__
    assert (SPEC.n, SPEC.m_input) == (R_SPEC.n, R_SPEC.m_input) == (512,
                                                                    4096)
    assert config_hash(SPEC) == r_store.checkpoint.config_hash(R_SPEC)
    with pytest.raises(dataclasses.FrozenInstanceError):
        SPEC.scale = 3
    for bad, match in ((T.BuildSpec(scale=31), "int32"),
                       (T.BuildSpec(scale=30, edge_factor=8), "uint32")):
        with pytest.raises(ValueError, match=match) as e:
            bad.validate()
        with pytest.raises(ValueError) as r:
            R.BuildSpec(**dataclasses.asdict(bad)).validate()
        assert str(e.value) == str(r.value)
    T.BuildSpec(scale=18).validate()


@pytest.mark.parametrize("p", [1, 2, 3, 4, 7, 16, 64])
def test_build_closed_forms_equal_reference(p):
    for m in (1, 4096, 268_435_456, (16 << 30) - 1):
        assert comm_model.build_route_1d_words(m, p) == \
            r_comm.build_route_1d_words(m, p)
        for pc in (1, 2, 4, 16):
            assert comm_model.build_route_2d_words(m, p, pc) == \
                r_comm.build_route_2d_words(m, p, pc)
    for cap in (0, 32, 16_793_632):
        assert comm_model.build_route_padded_words(p, cap) == \
            r_comm.build_route_padded_words(p, cap)
    for records in (0, 1, 8192, 33_554_432, 536_870_912):
        for a, b in ((0.57, 0.19), (0.65, 0.15), (0.25, 0.25)):
            for slack in (0.01, 0.3, 1.5, 3.0):
                for pad in (1, 32):
                    assert comm_model.plan_cap_route(
                        records, p, a, b, slack=slack, pad=pad) == \
                        r_comm.plan_cap_route(records, p, a, b, slack=slack,
                                              pad=pad)


@pytest.mark.parametrize("dec,grid", [("1d", 1), ("1d", 4), ("1d", 7),
                                      ("2d", (1, 1)), ("2d", (2, 2)),
                                      ("2d", (1, 4))])
def test_dist_build_equals_the_host_builders(dec, grid):
    """The born graph is ``build_blocked*`` of the counter stream, field
    for field and capacity for capacity (p=7 does not divide m_input:
    the last slice stops at the stream's end)."""
    g, info = T.dist_build(SPEC, dec, _mesh(dec, grid), grid, **KW)
    _same_graph(g, _host(dec, grid), f"{dec} {grid}")
    assert info["m"] == g.m and info["build_teps"] > 0
    assert info["retry_log"] == []
    assert set(info) == {"build_s", "gen_route_s", "format_s", "cap_route",
                         "m", "m_input", "build_teps", "route_words_measured",
                         "route_words_expected", "route_words_padded",
                         "retry_log"}


def test_dist_build_at_p1_equals_reference_and_its_info():
    rg, ri = R.dist_build(R_SPEC, "1d", r_mesh_1d(1), 1, **KW)
    tg, ti = T.dist_build(SPEC, "1d", _mesh("1d", 1), 1, **KW)
    for k, v in rg.device_arrays().items():
        assert np.array_equal(np.asarray(v), tg.device_arrays()[k].numpy()), k
    for k in ("cap_route", "m", "m_input", "route_words_measured",
              "route_words_expected", "route_words_padded", "retry_log"):
        assert ri[k] == ti[k], k


def test_route_overflow_raises():
    """Starved routing buckets raise, never truncate edges."""
    for build in (lambda: T.dist_build_1d(SPEC, 1, _mesh("1d", 1), **KW,
                                          route_slack=0.01),
                  lambda: T.dist_build_2d(SPEC, 1, 1, _mesh("2d", (1, 1)),
                                          **KW, route_slack=0.01)):
        with pytest.raises(CapacityOverflow, match="route_slack") as e:
            build()
        assert e.value.cap_name == "route_slack"
        assert e.value.cap_value == 0.01


def test_dist_build_checks_the_mesh():
    with pytest.raises(ValueError, match="data=4 but the mesh has data=2"):
        T.dist_build(SPEC, "1d", _mesh("1d", 2), 4, **KW)
    with pytest.raises(ValueError, match="unknown decomposition"):
        T.dist_build(SPEC, "3d", _mesh("1d", 1), 1)


def test_dist_build_heals_as_the_reference_does():
    """route_slack 0.3 overflows twice at p=1 and heals at 1.2, with the
    reference's retry_log (messages included); the healed graph is a
    first build's at the final slack; exhaustion raises again with the
    reference's message and history."""
    mesh = _mesh("1d", 1)
    g, info = T.dist_build(SPEC, "1d", mesh, 1, route_slack=0.3)
    _, want = R.dist_build(R_SPEC, "1d", r_mesh_1d(1), 1, route_slack=0.3)
    assert info["retry_log"] == want["retry_log"]
    assert [e["cap_value"] for e in info["retry_log"]] == [0.3, 0.6, 1.2]
    _same_graph(g, T.dist_build_1d(SPEC, 1, mesh, route_slack=1.2)[0])
    with pytest.raises(CapacityOverflow, match="escalation history") as e:
        T.dist_build(SPEC, "1d", mesh, 1, route_slack=0.001, max_attempts=2)
    with pytest.raises(RuntimeError) as r:
        R.dist_build(R_SPEC, "1d", r_mesh_1d(1), 1, route_slack=0.001,
                     max_attempts=2)
    assert str(e.value) == str(r.value)
    assert [a.to_json() for a in e.value.history] == \
        [a.to_json() for a in r.value.history]


def test_dedup_and_first_occurrence_equal_reference():
    """The helpers against the reference's on seeded records with
    duplicates, self-loops dropped upstream: the same unique records, and
    (jc, cp) with the mode="drop" scatter when the capacity is short."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 40, 500).astype(np.int32)
    v = rng.integers(0, 30, 500).astype(np.int32)
    groups = [(torch.from_numpy(u[:200] + 7), torch.from_numpy(v[:200] + 3)),
              (torch.from_numpy(u[200:] + 7), torch.from_numpy(v[200:] + 3))]
    cu, cv = T._dedup_sorted(groups, 7, 3, 30)
    assert groups == []
    ru, rv, nnz = R._dedup_sorted(u, v, 40, 30)
    assert int(nnz) == cu.numel()
    assert np.array_equal(np.asarray(ru)[: int(nnz)], cu.numpy())
    assert np.array_equal(np.asarray(rv)[: int(nnz)], cv.numpy())
    nzc = int(torch.unique(cu).numel())
    for cap_nz in (nzc + 8, nzc, nzc - 1, nzc - 5):
        jc, cp = T._first_occurrence(cu, 40, cap_nz)
        rjc, rcp, _, _ = R._first_occurrence(ru, nnz, 40, cap_nz)
        assert np.array_equal(np.asarray(rjc), jc.numpy()), cap_nz
        assert np.array_equal(np.asarray(rcp), cp.numpy()), cap_nz


@pytest.mark.parametrize("dec,grid,col_ptr", [
    ("1d", 1, False), ("1d", 4, False), ("1d", 4, True),
    ("2d", (1, 1), False), ("2d", (2, 2), False)])
def test_regen_shard_equals_reference_on_every_shard(tmp_path, dec, grid,
                                                     col_ptr):
    """Each shard regenerated from the stream (the port on the CPU, the
    reference in numpy) from a stored graph's meta: the stored arrays,
    the stored CRC, and the reference's regeneration, field for field;
    a host build with the strip col_ptr regenerates it too."""
    g = _host(dec, grid, with_col_ptr=True) if col_ptr else \
        T.dist_build(SPEC, dec, _mesh(dec, grid), grid, **KW)[0]
    store = GraphStore(str(tmp_path), device="cpu")
    sdir = store.save_graph("g", g, spec=SPEC)
    meta = json.load(open(os.path.join(sdir, "meta.json")))
    scalars, fields = json.loads(meta["scalars"]), json.loads(meta["fields"])
    part = r_store._part_from_meta(meta)
    assert ("col_ptr" in fields) == (col_ptr or dec == "2d")
    for k in range(meta["shards"]):
        got = T.regen_shard(SPEC, meta["graph_kind"], g.part, k, scalars,
                            fields, device="cpu")
        want = R.regen_shard(R_SPEC, meta["graph_kind"], part, k, scalars,
                             fields)
        stored = dict(np.load(os.path.join(sdir, f"shard_{k:05d}.npz")))
        assert set(got) == set(want) == set(stored)
        for f in got:
            assert np.array_equal(got[f], want[f]), (k, f)
            assert np.asarray(got[f]).dtype == np.asarray(want[f]).dtype
            assert np.array_equal(got[f], stored[f]), (k, f)
        assert r_store.shard_crc32(got) == meta["shard_crc32"][k]
    with pytest.raises(ValueError, match="cannot regenerate"):
        T.regen_shard(SPEC, "EdgeList", g.part, 0, scalars, fields,
                      device="cpu")


def test_build_specs_equal_reference():
    assert list(build_specs.BUILD_SPECS) == list(r_specs.BUILD_SPECS)
    for name, spec in build_specs.BUILD_SPECS.items():
        spec.validate()
        want = r_specs.BUILD_SPECS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(want)
        assert config_hash(spec) == r_store.checkpoint.config_hash(want)
        assert build_specs.get_build_spec(name) is spec
        for dec in ("1d", "1ds", "2d"):
            assert build_specs.store_name(name, dec) == \
                r_specs.store_name(name, dec)
    with pytest.raises(KeyError, match="unknown build spec 'nope'"):
        build_specs.get_build_spec("nope")


def test_repartition_from_spec_equals_host_reblock():
    """A BuildSpec re-blocked onto a new grid through dist_build is the
    host re-block of the same stream (strips and checkerboard), and an
    EdgeList re-blocks through build_blocked."""
    g1 = repartition_graph(spec=SPEC, mesh=_mesh("1d", 4), pr=4, pc=1,
                           decomposition="1ds", **KW)
    _same_graph(g1, _host("1d", 4))
    g2 = repartition_graph(spec=SPEC, mesh=_mesh("2d", (2, 2)), pr=2, pc=2,
                           decomposition="2d", **KW)
    _same_graph(g2, _host("2d", (2, 2)))
    edges = rmat_graph(SPEC.scale, SPEC.edge_factor, seed=SPEC.seed,
                       generator="counter", device="cpu")
    _same_graph(repartition_graph(edges, 2, 2, **KW), g2)


def test_repartition_argument_errors():
    with pytest.raises(ValueError, match="mesh"):
        repartition_graph(spec=SPEC)
    with pytest.raises(ValueError, match="EdgeList or a"):
        repartition_graph()
