"""The port's store, pubkey cache, slot clock and state-root scenario
(store/{kv,metadata,hot_cold}.py, chain/pubkey_cache.py,
utils/slot_clock.py, loadgen/{scenarios,state_root}.py) on the CPU against
the JAX package's.

- the same key-value operations leave the same columns, byte for byte;
- schema stamping, the v1 -> v2 migration and the split, anchor, blob and
  pruning records: every hot column equal;
- HotColdDB over a short chain (the reference harness on "fake", 32
  validators, 9 blocks, carried across as SSZ): the puts, the gets,
  migrate_to_freezer with a restore point every 4 slots, the root
  iterators, a pruned state rebuilt from a restore point by the port's
  BlockReplayer, and reconstruct_historic_states: every hot and cold
  column equal to the reference's after the same operations;
- ValidatorPubkeyCache: mont_coords (the port packs with
  crypto/torchbls/limbs.py) np.array_equal to the reference's for every
  key, the store column equal, and the cache reloaded from the store;
- ManualSlotClock's slots and offsets;
- run_state_root_scenario at the state_root scenario's smoke variant: the
  same roots slot by slot and the same report fields but the times, the
  port on its "device" hash backend (the engine on the plain versions)
  and on "host", the reference on its "host".

Tolerance: exact (bytes, roots, arrays). No JAX compile: the reference runs
"fake" BLS and its host hash lane.
"""

import numpy as np
import pytest

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.store import hot_cold as jhc
from lighthouse_tpu.store import kv as jkv
from lighthouse_tpu.store import metadata as jmd
from lighthouse_tpu.types.containers import spec_types as j_spec_types
from lighthouse_tpu.types.spec import ForkName as JForkName
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec

N = 32
BLOCKS = 9
SPRP = 4                      # slots per restore point

# the port loads when this file's first test runs, not at collection
carry = hc = kv = md = minimal_spec = spec_types = ForkName = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global carry, hc, kv, md, minimal_spec, spec_types, ForkName
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.store import hot_cold as hc
    from lighthouse_tpu_torch.store import kv
    from lighthouse_tpu_torch.store import metadata as md
    from lighthouse_tpu_torch.testing import carry
    from lighthouse_tpu_torch.torchhash import router
    from lighthouse_tpu_torch.types.containers import spec_types
    from lighthouse_tpu_torch.types.spec import ForkName, minimal_spec

    prev_hash, prev = router._state["backend"], bls.api._active_backend
    router.set_hash_backend("host")
    jprev = jbls.get_backend().name
    yield
    router.set_hash_backend(prev_hash)
    bls.api._active_backend = prev
    jbls.set_backend(jprev)


def columns(store, module):
    """Every column of a key-value store, as sorted (key, value) lists."""
    return {c.value: sorted(store.iter_column(c)) for c in module.Column}


def both_columns(jdb, pdb):
    return ({"hot": columns(jdb.hot, jkv), "cold": columns(jdb.cold, jkv)},
            {"hot": columns(pdb.hot, kv), "cold": columns(pdb.cold, kv)})


def test_memory_store_operations_match_jax():
    assert [c.value for c in kv.Column] == [c.value for c in jkv.Column]
    stores = []
    for m in (jkv, kv):
        s = m.MemoryStore()
        s.put(m.Column.block, b"k1", b"v1")
        s.do_atomically([m.KeyValueOp.put(m.Column.block, b"k2", b"v2"),
                         m.KeyValueOp.put(m.Column.state, b"s1", b"x"),
                         m.KeyValueOp.delete(m.Column.block, b"k1")])
        s.put(m.Column.pubkey_cache, (7).to_bytes(8, "little"), b"\x01" * 48)
        s.delete(m.Column.state, b"absent")
        assert s.get(m.Column.block, b"k1") is None and s.exists(m.Column.state, b"s1")
        stores.append(columns(s, m))
    assert stores[0] == stores[1]


def test_schema_and_metadata_records_match_jax():
    out = []
    for hcm, kvm, mdm, spec in ((jhc, jkv, jmd, j_minimal_spec()), (hc, kv, md, minimal_spec())):
        fresh = hcm.HotColdDB(spec)
        legacy = kvm.MemoryStore()
        mdm.put_schema_version(legacy, 1)
        migrated = hcm.HotColdDB(spec, hot=legacy)
        mdm.put_split(migrated.hot, mdm.Split(slot=64))
        migrated.put_anchor_info(mdm.AnchorInfo(
            anchor_slot=64, oldest_block_slot=3, oldest_block_parent=b"\x05" * 32,
            state_upper_limit=64, state_lower_limit=0))
        migrated.put_blob_info(mdm.BlobInfo(oldest_blob_slot=9, blobs_db=True))
        mdm.put_pruning_checkpoint(migrated.hot, mdm.PruningCheckpoint(epoch=2, root=b"\x07" * 32))
        out.append((fresh.schema_version(), fresh.schema_migrations_applied,
                    migrated.schema_migrations_applied, columns(fresh.hot, kvm),
                    columns(migrated.hot, kvm)))
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def chain():
    """The reference harness's chain on "fake" (deneb, minimal) and the same
    genesis, blocks and states carried into the port's types."""
    from lighthouse_tpu.testing.harness import StateHarness, clone_state

    jbls.set_backend("fake")
    jspec = j_minimal_spec()
    harness = StateHarness(spec=jspec, keypairs=jbls.interop_keypairs(N))
    jtypes = j_spec_types(jspec.preset, JForkName.deneb)
    jgenesis = clone_state(harness.state)
    jblocks, snapshots = [], []
    for _ in range(BLOCKS):
        jblocks.append(harness.extend_chain(1)[0])
        snapshots.append((int(harness.state.slot), jtypes.BeaconState.hash_tree_root(harness.state),
                          jtypes.BeaconState.serialize(harness.state)))
    spec = minimal_spec()
    types = spec_types(spec.preset, ForkName.deneb)
    genesis = carry.carry_state(jgenesis, jtypes, types)
    blocks = [carry.carry_signed_block(b, jtypes, types) for b in jblocks]
    return {"jax": (jspec, jtypes, jgenesis, jblocks), "port": (spec, types, genesis, blocks),
            "snapshots": snapshots, "keypairs": harness.keypairs}


def populate(hcm, spec, types, genesis, blocks, snapshots, compact=True, **kv_stores):
    """The reference test's freezer: genesis and every block's state put
    hot, then migrated below the last slot + 1 (on `kv_stores`' hot and cold
    stores where given, else on MemoryStores)."""
    db = hcm.HotColdDB(spec, config=hcm.StoreConfig(slots_per_restore_point=SPRP,
                                                    compact_on_migration=compact), **kv_stores)
    g_root = types.BeaconState.hash_tree_root(genesis)
    db.put_state(g_root, genesis, types)
    segment = [(0, b"\x00" * 32, g_root)]
    for signed, (slot, sroot, raw) in zip(blocks, snapshots):
        broot = types.BeaconBlock.hash_tree_root(signed.message)
        db.put_block(broot, signed, types)
        db.put_state(sroot, types.BeaconState.deserialize(raw), types)
        segment.append((slot, broot, sroot))
    db.put_blobs(segment[3][1], b"\x00\x00\x00\x00")
    db.put_chain_item(b"persisted-head", segment[-1][1])
    before = {"hot": columns(db.hot, hcm)}
    db.migrate_to_freezer(snapshots[-1][0] + 1, segment, types)
    return db, before, segment


@pytest.fixture(scope="module")
def stores(chain):
    jdb, jbefore, jseg = populate(jhc, *chain["jax"], chain["snapshots"])
    pdb, pbefore, pseg = populate(hc, *chain["port"], chain["snapshots"])
    return jdb, pdb, jbefore, pbefore, jseg, pseg


def test_hot_cold_puts_gets_and_freezer_match_jax(chain, stores):
    jdb, pdb, jbefore, pbefore, jseg, pseg = stores
    _s, types, _g, blocks = chain["port"]
    assert pseg == jseg
    assert pbefore == jbefore                      # the hot puts, before the migration
    jcols, pcols = both_columns(jdb, pdb)
    assert pcols == jcols                          # and both DBs after it
    assert pdb.split_slot == jdb.split_slot == chain["snapshots"][-1][0] + 1
    for slot, broot, sroot in pseg:
        assert pdb.freezer_block_root_at_slot(slot) == jdb.freezer_block_root_at_slot(slot)
        assert pdb.freezer_state_root_at_slot(slot) == sroot
        assert not pdb.state_exists(sroot)
        if slot % SPRP == 0:
            assert types.BeaconState.hash_tree_root(pdb.get_restore_point_state(sroot, types)) == sroot
    for signed, (_slot, broot, _sroot) in zip(blocks, pseg[1:]):
        assert types.SignedBeaconBlock.serialize(pdb.get_block(broot, types)) == \
            types.SignedBeaconBlock.serialize(signed)
    last = chain["snapshots"][-1][0]
    assert list(pdb.forwards_block_roots_iterator(0, last)) == \
        list(jdb.forwards_block_roots_iterator(0, last))
    assert list(pdb.reverse_block_roots_iterator(last, 0)) == \
        list(jdb.reverse_block_roots_iterator(last, 0))
    assert pdb.get_blobs(pseg[3][1]) == jdb.get_blobs(jseg[3][1])
    assert pdb.get_chain_item(b"persisted-head") == jdb.get_chain_item(b"persisted-head")


def test_pruned_state_rebuilt_as_jax(chain, stores):
    jdb, pdb, *_ = stores
    _s, types, _g, _b = chain["port"]
    _js, jtypes, _jg, _jb = chain["jax"]
    slot, sroot, raw = chain["snapshots"][5]
    assert slot == 6
    rebuilt = pdb.load_cold_state_by_slot(slot)
    assert types.BeaconState.serialize(rebuilt) == raw
    assert jtypes.BeaconState.serialize(jdb.load_cold_state_by_slot(slot)) == raw
    assert types.BeaconState.hash_tree_root(rebuilt) == sroot


def test_reconstruct_historic_states_matches_jax(chain):
    out = []
    for hcm, mdm, kvm, side in ((jhc, jmd, jkv, "jax"), (hc, md, kv, "port")):
        spec, types, genesis, blocks = chain[side]
        db, _before, _seg = populate(hcm, spec, types, genesis, blocks, chain["snapshots"])
        for slot, sroot, _raw in chain["snapshots"]:
            if slot % SPRP == 0:
                db.cold.delete(kvm.Column.freezer_chunks, sroot)
        last = chain["snapshots"][-1][0]
        db.put_anchor_info(mdm.AnchorInfo(anchor_slot=last, oldest_block_slot=0,
                                          oldest_block_parent=b"\x00" * 32,
                                          state_upper_limit=last, state_lower_limit=0))
        assert db.reconstruct_historic_states(batch_slots=2)
        assert db.get_anchor_info() is None
        out.append({"hot": columns(db.hot, kvm), "cold": columns(db.cold, kvm)})
    assert out[1] == out[0]
    restored = dict(out[1]["cold"][kv.Column.freezer_chunks.value])    # the restore points, rebuilt
    for slot, sroot, raw in chain["snapshots"]:
        if slot % SPRP == 0:
            assert restored[sroot] == raw


def test_pubkey_cache_mont_coords_match_jax(chain):
    from lighthouse_tpu.chain import pubkey_cache as jpc
    from lighthouse_tpu_torch.chain import pubkey_cache as pc

    for kp in chain["keypairs"]:                        # interned, as a node's registry is
        kp.pk.serialize()
    carry.carry_keypairs(chain["keypairs"])
    _js, jtypes, jgenesis, _jb = chain["jax"]
    spec, types, genesis, _b = chain["port"]
    jdb, pdb = jhc.HotColdDB(j_minimal_spec()), hc.HotColdDB(spec)
    jcache, cache = jpc.ValidatorPubkeyCache(jdb), pc.ValidatorPubkeyCache(pdb)
    jcache.import_new_pubkeys(jgenesis)
    cache.import_new_pubkeys(genesis)
    assert len(cache) == len(jcache) == N
    assert cache.pubkey_bytes == jcache.pubkey_bytes
    for i in range(N):
        got, want = cache.mont_coords(i), jcache.mont_coords(i)
        assert all(np.array_equal(g, np.asarray(w)) for g, w in zip(got, want, strict=True))
        assert got[0].dtype == np.asarray(want[0]).dtype
        assert cache.get(i).point == jcache.get(i).point
    assert cache.get_index(cache.pubkey_bytes[5]) == jcache.get_index(jcache.pubkey_bytes[5]) == 5
    assert columns(pdb.hot, kv) == columns(jdb.hot, jkv)
    # a second cache over the same store reloads every key, in order
    again = pc.ValidatorPubkeyCache(pdb)
    assert again.pubkey_bytes == cache.pubkey_bytes
    assert all(np.array_equal(a, b) for a, b in zip(again.mont_coords(N - 1), cache.mont_coords(N - 1)))
    getter = again.pubkey_getter()
    assert getter(3) is again.get(3) and getter.by_bytes(cache.pubkey_bytes[3]) is again.get(3)
    # the import is incremental: a longer registry adds only the new keys
    cache.import_new_pubkeys(genesis)
    assert len(cache) == N


def test_manual_slot_clock_matches_jax():
    from lighthouse_tpu.utils import slot_clock as jsc
    from lighthouse_tpu_torch.utils import slot_clock as sc

    out = []
    for m in (jsc, sc):
        clock = m.ManualSlotClock(1_600_000_000, 12)
        seen = [clock.now()]
        clock.set_slot(5)
        seen += [clock.now(), clock.slot_start(5), clock.seconds_into_slot(),
                 clock.duration_to_next_slot()]
        clock.advance_slot()
        clock.set_time(1_600_000_000 + 12 * 9 + 7.5)
        seen += [clock.now(), clock.seconds_into_slot(), clock.duration_to_next_slot()]
        clock.set_time(1_600_000_000 - 1)
        seen.append(clock.now())
        out.append(seen)
    assert out[1] == out[0]


def run_scenario(scenarios, state_root, fixtures, harness, backend):
    """The state_root scenario's smoke variant on `backend`: its report
    without the times, and the root of every state it hashed, in order
    (the states it cloned, then the final one)."""
    sc = scenarios.state_root_smoke_variant(
        scenarios.get_state_root_scenario("state_root", hash_backend=backend))
    states, clone, uncached = [], harness.clone_state, fixtures.uncached_state_root

    def cloned(state, spec=None):
        states.append(state)
        return clone(state, spec)

    def final(types, state):
        states.append(state)
        final.types = types
        return uncached(types, state)

    harness.clone_state, fixtures.uncached_state_root = cloned, final
    try:
        report = state_root.run_state_root_scenario(sc)
    finally:
        harness.clone_state, fixtures.uncached_state_root = clone, uncached
    timeless = {k: v for k, v in report.items()
                if k not in ("cold_ms", "reroot_p50_ms", "roots_per_sec", "elapsed_secs",
                             "verify_observations", "tree_hash_routes", "hash_backend")}
    return timeless, [final.types.BeaconState.hash_tree_root(s) for s in states], report


def test_state_root_scenario_smoke_matches_jax(monkeypatch):
    from lighthouse_tpu.loadgen import scenarios as jscenarios
    from lighthouse_tpu.loadgen import state_root as jstate_root
    from lighthouse_tpu.testing import harness as jharness
    from lighthouse_tpu.testing import state_fixtures as jfx
    from lighthouse_tpu_torch.loadgen import scenarios, state_root
    from lighthouse_tpu_torch.testing import harness, state_fixtures
    from lighthouse_tpu_torch.torchhash import engine

    monkeypatch.setenv("LIGHTHOUSE_TPU_FIXTURE_CACHE", "off")
    assert scenarios.STATE_ROOT_SCENARIOS == {
        k: scenarios.StateRootScenario(**vars(v)) for k, v in jscenarios.STATE_ROOT_SCENARIOS.items()}
    engine.set_device("cpu")
    # a process's second run finds the first's memoized roots (the tree
    # cache's root outcomes move), so the i-th runs are compared
    for backend in ("device", "host"):
        want, want_roots, jreport = run_scenario(jscenarios, jstate_root, jfx, jharness, "host")
        assert jreport["hash_backend"] == "host" and jreport["conservation"]["ok"]
        assert len(want_roots) == jreport["roots"] == 5         # the cold root, then 4 slots
        got, roots, report = run_scenario(scenarios, state_root, state_fixtures, harness, backend)
        assert got == want, backend
        assert roots == want_roots, backend
        assert report["hash_backend"] == backend
        routes = report["tree_hash_routes"]
        assert bool(routes.get("device/ok")) == (backend == "device")
        assert not routes.get("host/device_error")


# ------------------------------------------------- the native store, doctor


def log_engine(package: str, engine: str):
    """PurePythonKVStore, or the port's NativeKVStore (its g++ build)."""
    import importlib

    native_kv = importlib.import_module(f"{package}.store.native_kv")
    if engine == "python":
        return native_kv.PurePythonKVStore
    assert package == "lighthouse_tpu_torch"      # the reference's would build beside itself
    return native_kv.NativeKVStore


def relative(report, datadir: str):
    """A doctor report with its datadir's path taken out."""
    import json

    return json.loads(json.dumps(report, default=str).replace(datadir, "<datadir>"))


@pytest.fixture(scope="module")
def datadirs(chain, tmp_path_factory):
    """The freezer's datadir written through each engine: the reference's
    PurePythonKVStore, the port's PurePythonKVStore and its NativeKVStore
    (fsync off: the bytes are what is compared; the migration's compaction
    is left to the test, as the C++ engine rewrites the live records in its
    hash map's order)."""
    import pickle

    out = {}
    for package, engine, hcm, side in (("lighthouse_tpu", "python", jhc, "jax"),
                                       ("lighthouse_tpu_torch", "python", hc, "port"),
                                       ("lighthouse_tpu_torch", "native", hc, "port")):
        d = tmp_path_factory.mktemp(f"{package}-{engine}")
        Store = log_engine(package, engine)
        hot, cold = Store(d / "hot.db", fsync="never"), Store(d / "cold.db", fsync="never")
        db, _before, seg = populate(hcm, *chain[side], chain["snapshots"], compact=False,
                                    hot=hot, cold=cold)
        # a resume record whose anchor block and state are in the hot log
        types, (slot, broot, sroot) = chain[side][1], seg[-1]
        db.put_state(sroot, types.BeaconState.deserialize(chain["snapshots"][-1][2]), types)
        db.put_chain_item(b"persisted-head", pickle.dumps({
            "head_root": broot, "finalized_root": broot, "finalized_epoch": 0,
            "anchor_root": broot, "block_slots": {broot: slot},
            "state_root_by_block": {broot: sroot}}))
        hot.close()
        cold.close()
        out[(package, engine)] = (d, Store)
    return out


@pytest.mark.parametrize("engine", ["python", "native"])
def test_kv_logs_and_doctor_match_jax(datadirs, engine):
    """The port's engine writes the reference's record log byte for byte;
    scan_log and fsck_datadir give the reference's reports on the clean
    datadir and after a flipped bit in the hot log's last record."""
    import shutil

    from lighthouse_tpu.loadgen import storefaults as jsf
    from lighthouse_tpu.store import doctor as jdoctor
    from lighthouse_tpu_torch.loadgen import storefaults as sf
    from lighthouse_tpu_torch.store import doctor, native_kv

    jdir, _ = datadirs[("lighthouse_tpu", "python")]
    pdir, Store = datadirs[("lighthouse_tpu_torch", engine)]
    if engine == "native":
        assert Store is native_kv.NativeKVStore and not native_kv._fallback_warned
        assert native_kv._lib_path().is_relative_to(native_kv.BUILD_ROOT)
    for name in doctor.DB_FILES:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name
    reports = []
    for root, dm, sfm in ((jdir, jdoctor, jsf), (pdir, doctor, sf)):
        work = root.parent / f"{root.name}-flipped"
        shutil.copytree(root, work)
        clean = dm.fsck_datadir(work)
        start, _end = sfm.last_record_span(work / "hot.db")
        sfm.flip_bit(work / "hot.db", start + 8 + 2)
        scanned = dm.scan_log(work / "hot.db")
        flipped, repaired = dm.fsck_datadir(work), dm.fsck_datadir(work, repair=True)
        reports.append(relative([clean, scanned, flipped, repaired, dm.fsck_datadir(work)],
                                str(work)))
        shutil.rmtree(work)
    assert reports[1] == reports[0]
    clean, scanned, flipped, repaired, after = reports[1]
    assert clean["ok"] and not flipped["ok"] and scanned["tail_error"]
    # the repair truncates the flipped record, the resume record, so the
    # prefix's older one (populate's bare root) is the live one again
    assert repaired["repaired"] and after["logs"]["hot.db"]["tail_error"] is None
    assert after["problems"] == [p for p in flipped["problems"] if "tail" not in p]
    assert after["anchor"] == {"persisted": True, "readable": False}
    # compacted, on a copy: the same live records (the C++ engine writes
    # them in its own order), the same doctor report; and the port's engine
    # reopens the reference's log with the same contents
    views = []
    for root, Engine, kvm, dm in ((jdir, log_engine("lighthouse_tpu", "python"), jkv, jdoctor),
                                  (pdir, Store, kv, doctor)):
        work = root.parent / f"{root.name}-compacted"
        shutil.copytree(root, work)
        store = Engine(work / "hot.db", fsync="never")
        store.compact()
        store.close()
        reopened = Store(work / "hot.db", fsync="never")
        try:
            views.append(({c.value: sorted(reopened.iter_column(c)) for c in kvm.Column},
                          relative(dm.fsck_datadir(work), str(work))))
        finally:
            reopened.close()
        shutil.rmtree(work)
    assert views[1] == views[0] and views[1][1]["ok"]


def test_native_load_failure_falls_back_as_jax(tmp_path, monkeypatch):
    """The reference's degradation: when the library cannot load,
    NativeKVStore(path) gives the pure-Python engine and warns once."""
    from lighthouse_tpu_torch.store import native_kv
    from lighthouse_tpu_torch.utils.logging import RECENT

    def boom():
        raise OSError("GLIBCXX_9.9.99 not found (simulated)")

    monkeypatch.setattr(native_kv, "_load", boom)
    monkeypatch.setattr(native_kv, "_fallback_warned", False)
    s = native_kv.NativeKVStore(tmp_path / "kv.log")
    assert isinstance(s, native_kv.PurePythonKVStore)
    s.put(kv.Column.block, b"k", b"v")
    assert s.get(kv.Column.block, b"k") == b"v"
    s.close()
    native_kv.NativeKVStore(tmp_path / "kv2.log").close()
    warns = [r for r in RECENT if r[2] == "store" and "falling back" in r[3]]
    assert len(warns) == 1 and "GLIBCXX_9.9.99" in warns[-1][4]["error"]


@pytest.mark.parametrize("plan", [{"tear_at": 4, "tear_keep_bytes": 9}, {"crash_at": 3},
                                  {"flip_crc_at": 2}])
def test_faulty_store_matches_jax(tmp_path, plan):
    """storefaults.FaultyKVStore under the same fault plan: the same bytes
    on disk, the same fault, and the same contents after a reopen."""
    import importlib

    out = []
    for package in ("lighthouse_tpu", "lighthouse_tpu_torch"):
        sf = importlib.import_module(f"{package}.loadgen.storefaults")
        kvm = importlib.import_module(f"{package}.store.kv")
        path = tmp_path / package / "hot.db"
        store = sf.FaultyKVStore(path, plan=sf.FaultPlan(**plan), fsync="never")
        fault = None
        try:
            for i in range(6):
                store.put(kvm.Column.block, bytes([i]) * 32, bytes([i]) * (10 + i))
        except (sf.SimulatedCrash, sf.StoreCrashed) as e:
            fault = (type(e).__name__, str(e))
        written = path.read_bytes()
        store._log.close()
        reopened = sf.PurePythonKVStore(path, fsync="never")
        out.append((fault, store.writes, written, path.read_bytes(),
                    sorted(reopened.iter_column(kvm.Column.block))))
        reopened.close()
    assert out[1] == out[0]


# ------------------------------------------------------------ task executor


def test_task_executor_and_lockfile_match_jax(tmp_path):
    """tests/test_task_executor.py's four cases on both packages."""
    import importlib
    import os
    import time

    def cases(te):
        out = []
        ex, ran = te.TaskExecutor(), []

        def svc(exit_signal):
            ran.append(True)
            exit_signal.wait(5)
            ran.append("stopped")

        ex.spawn(svc, "svc")
        time.sleep(0.05)
        ex.shutdown("test over")
        ex.join()
        out.append(ran)
        for critical in (True, False):
            fatal = []
            ex = te.TaskExecutor(on_fatal=fatal.append)

            def bad(exit_signal):
                raise RuntimeError("boom")

            ex.spawn(bad, "bad", critical=critical)
            ex.join()
            out.append((ex.exit_signal.is_set(), ex.panicked, ["bad" in f for f in fatal]))
        path = str(tmp_path / f"{te.__name__}.lock")
        with te.Lockfile(path):
            try:
                te.Lockfile(path).acquire()
                out.append("acquired twice")
            except te.LockfileError:
                out.append("refused")
        lk = te.Lockfile(path)
        lk.acquire()
        lk.release()
        with open(path, "w") as f:
            f.write("999999999")
        stale = te.Lockfile(path)
        stale.acquire()
        out.append(int(open(path).read()) == os.getpid())
        stale.release()
        return out

    want, got = (cases(importlib.import_module(f"{p}.utils.task_executor"))
                 for p in ("lighthouse_tpu", "lighthouse_tpu_torch"))
    assert got == want
    assert got == [[True, "stopped"], (True, "bad", [True]), (False, "bad", []), "refused", True]
