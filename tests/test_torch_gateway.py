"""The port's gateway tier (``fakepta_tpu_torch.gateway``) and its load
generator against the JAX package's, on the CPU.

Each of tests/test_gateway.py's tests is mirrored: the same scripted
sequence runs through a JAX gateway and a port gateway, each in front of
a stub fleet of its own package (``_FakeFleet``, deterministic responses
per ``(seed, n)``), and the port must give the JAX gateway's
``gateway_summary()`` / ``tenant_summary()`` counts (the latency-derived
fields aside) and its store behaviour: request keys, fingerprint and
schema rejects, index corruption and the LRU bounds. Beside them:

- ``make_tenant_requests`` draws the JAX identities and picks exactly;
- ``run_gateway_loadgen`` on a tiny spec with two CPU replicas passes
  every gate of its row, and each identity's stored response lies within
  the bf16 bound (1e-2 of the curve scale) of the JAX gateway's (the
  port's fleet serves the ``fused`` path's bf16 operands, the JAX fleet
  XLA f32);
- a single-flight entry whose dispatch ``fleet.submit`` refuses with an
  error other than ``ServeBusy`` is aborted in the port (the JAX gateway
  leaves it open, and a later identical request waits on it forever);
- a gateway over a CPU fleet fingerprints the CPU without a GPU, and an
  entry the JAX package wrote into the same directory is a loud miss.
"""

import dataclasses
import json
import threading
import types
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import jax
import numpy as np
import pytest
import torch

import fakepta_tpu.gateway as jgw
import fakepta_tpu.obs.flightrec as jflightrec
import fakepta_tpu.obs.promfmt as jpromfmt
import fakepta_tpu.obs.topview as jtopview
import fakepta_tpu.serve as jserve
import fakepta_tpu.serve.loadgen as jloadgen
import fakepta_tpu.serve.scheduler as jscheduler
import fakepta_tpu.tune.defaults as jdefaults
import fakepta_tpu_torch.gateway as pgw
import fakepta_tpu_torch.obs.flightrec as pflightrec
import fakepta_tpu_torch.obs.promfmt as ppromfmt
import fakepta_tpu_torch.obs.topview as ptopview
import fakepta_tpu_torch.serve as pserve
import fakepta_tpu_torch.serve.loadgen as ploadgen
import fakepta_tpu_torch.serve.scheduler as pscheduler
import fakepta_tpu_torch.tune.defaults as pdefaults
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.tune.fingerprint import fingerprint as jax_fingerprint
from fakepta_tpu_torch.tune.fingerprint import fingerprint

T_OUT = 300
BF16_RTOL = 1e-2
#: tenant-summary fields read off the clock (latency ring, window qps)
CLOCK_FIELDS = ("p50_ms", "p99_ms", "qps")


def _ns(gw, serve, scheduler, flightrec, promfmt, topview, defaults,
        fingerprint):
    return types.SimpleNamespace(
        gw=gw, serve=serve, ServeResult=scheduler.ServeResult,
        flightrec=flightrec, promfmt=promfmt, topview=topview,
        defaults=defaults, fingerprint=fingerprint)


JAX = _ns(jgw, jserve, jscheduler, jflightrec, jpromfmt, jtopview,
          jdefaults, lambda: jax_fingerprint())
PORT = _ns(pgw, pserve, pscheduler, pflightrec, ppromfmt, ptopview,
           pdefaults, lambda: fingerprint(["cpu"]))
PKGS = (JAX, PORT)


def _spec(pkg):
    return pkg.serve.ArraySpec(npsr=3, ntoa=16)


class _FakeFleet:
    """Duck-typed fleet (tests/test_gateway.py's): deterministic
    ServeResults per (seed, n) of its package, so the gateway's admission
    / caching / coalescing paths run without a real pool. ``auto=False``
    parks dispatches until ``release_all``; ``busy_exc`` is raised by
    ``submit``."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.dispatches = 0
        self.auto = True
        self.busy_exc = None
        self._pending = []
        self._lock = threading.Lock()

    def result_for(self, req):
        rng = np.random.default_rng((int(req.seed), int(req.n)))
        return self.pkg.ServeResult(
            curves=rng.standard_normal((req.n, 5)),
            autos=rng.standard_normal(req.n),
            bin_centers=np.linspace(0.0, 1.0, 5),
            service_s=0.25, bucket=int(req.n), replica="fake-0")

    def submit(self, req):
        if self.busy_exc is not None:
            raise self.busy_exc
        fut: Future = Future()
        with self._lock:
            self.dispatches += 1
            auto = self.auto
            if not auto:
                self._pending.append((req, fut))
        if auto:
            fut.set_result(self.result_for(req))
        return fut

    def release_all(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for req, fut in pending:
            fut.set_result(self.result_for(req))

    def slo_summary(self):
        return {}

    def telemetry_rollup(self):
        return {}

    def reset_stats(self):
        pass

    def close(self):
        pass


def _gw(pkg, path, **kw):
    tenants = [pkg.gw.Tenant("alice", "tok-alice", weight=2.0),
               pkg.gw.Tenant("bob", "tok-bob", weight=1.0)]
    fleet = _FakeFleet(pkg)
    gw = pkg.gw.Gateway(fleet, tenants, store=pkg.gw.ResultStore(path),
                        **kw)
    return gw, fleet


def _counts(gw) -> dict:
    """The gateway's and its tenants' summaries without the clock."""
    tenants = {tid: {k: v for k, v in row.items() if k not in CLOCK_FIELDS}
               for tid, row in gw.tenant_summary().items()}
    return {"gateway": gw.gateway_summary(), "tenants": tenants}


def _both(tmp_path, script, **kw):
    """Run ``script(pkg, gw, fleet)`` through a JAX and a port gateway;
    the port's counts must equal the JAX gateway's. Returns the port's
    gateway, its fleet and the script's two results."""
    out = []
    for pkg in PKGS:
        name = "jax" if pkg is JAX else "port"
        gw, fleet = _gw(pkg, tmp_path / name / "gw", **kw)
        out.append((gw, fleet, script(pkg, gw, fleet)))
    (jg, _jf, jres), (pg, pf, pres) = out
    assert _counts(pg) == _counts(jg)
    return pg, pf, jres, pres


# -- auth -------------------------------------------------------------------
def test_auth_rejects_unknown_token(tmp_path):
    def script(pkg, gw, fleet):
        req = pkg.serve.SimRequest(spec=_spec(pkg), n=4, seed=7)
        with pytest.raises(pkg.gw.GatewayAuthError):
            gw.submit(req, token=None)
        with pytest.raises(pkg.gw.GatewayAuthError):
            gw.submit(req, token="tok-mallory")
        res = gw.serve(req, token="tok-alice", timeout=T_OUT)
        assert np.array_equal(res.curves, fleet.result_for(req).curves)
        return res.curves

    gw, _fleet, jres, pres = _both(tmp_path, script)
    assert np.array_equal(jres, pres)
    assert gw.gateway_summary()["requests"] == 1   # rejects never admit
    assert issubclass(pgw.GatewayAuthError, pserve.ServeError)


def test_tenant_table_validation():
    for pkg in PKGS:
        T = pkg.gw.Tenant
        for bad in ([], [T("a", "t1"), T("a", "t2")],
                    [T("a", "t1"), T("b", "t1")], [T("a", "t1", weight=0.0)]):
            with pytest.raises(ValueError):
                pkg.gw.TenantTable(bad)
    jt = jgw.TenantTable([jgw.Tenant("a", "t1", weight=3.0),
                          jgw.Tenant("b", "t2")], max_inflight=10)
    pt = pgw.TenantTable([pgw.Tenant("a", "t1", weight=3.0),
                          pgw.Tenant("b", "t2")], max_inflight=10)
    assert [pt.share(t) for t in "ab"] == [jt.share(t) for t in "ab"] \
        == [7, 2]
    assert pt.summary() == jt.summary()
    assert pt.retry_hint(pt.states["a"]) == jt.retry_hint(jt.states["a"]) \
        == pdefaults.GATEWAY_RETRY_MIN_S
    for tbl in (jt, pt):
        tbl.states["a"].latencies_ms.extend([40.0, 10.0, 30.0])
        tbl.states["a"].inflight = 14
    assert pt.retry_hint(pt.states["a"]) == jt.retry_hint(jt.states["a"]) \
        == pytest.approx(0.06)


# -- fair-share admission ---------------------------------------------------
def test_fair_share_throttles_hot_tenant_without_starving_cold(tmp_path):
    # max_inflight=4, weights 2:1 -> alice holds 2 slots, bob 1
    def script(pkg, gw, fleet):
        Sim, spec = pkg.serve.SimRequest, _spec(pkg)
        fleet.auto = False
        futs = [gw.submit(Sim(spec=spec, n=4, seed=s), token="tok-alice")
                for s in (1, 2)]
        with pytest.raises(pkg.gw.GatewayBusy) as ei:
            gw.submit(Sim(spec=spec, n=4, seed=3), token="tok-alice")
        assert ei.value.tenant == "alice"
        assert ei.value.retry_after_s >= \
            pkg.defaults.GATEWAY_RETRY_MIN_S
        # alice's backlog does not occupy bob's slot
        futs.append(gw.submit(Sim(spec=spec, n=4, seed=4), token="tok-bob"))
        with pytest.raises(pkg.gw.GatewayBusy) as ei:
            gw.submit(Sim(spec=spec, n=4, seed=5), token="tok-bob")
        assert ei.value.tenant == "bob"
        fleet.release_all()
        for f in futs:
            assert f.result(timeout=T_OUT).replica == "fake-0"

    gw, _fleet, _j, _p = _both(tmp_path, script, max_inflight=4)
    s = gw.gateway_summary()
    assert s["throttles"] == 2 and s["inflight"] == 0
    ts = gw.tenant_summary()
    assert ts["alice"]["throttles"] == 1 and ts["bob"]["throttles"] == 1
    assert ts["alice"]["share_slots"] == 2 and ts["bob"]["share_slots"] == 1
    assert ts["alice"]["completed"] == 2 and "p99_ms" in ts["alice"]


def test_fleet_busy_surfaces_as_this_tenants_429(tmp_path):
    def script(pkg, gw, fleet):
        fleet.busy_exc = pkg.serve.ServeBusy("fleet full",
                                             retry_after_s=0.7)
        with pytest.raises(pkg.gw.GatewayBusy) as ei:
            gw.submit(pkg.serve.SimRequest(spec=_spec(pkg), n=4, seed=1),
                      token="tok-bob")
        assert ei.value.tenant == "bob"
        assert ei.value.retry_after_s == pytest.approx(0.7)

    gw, _fleet, _j, _p = _both(tmp_path, script)
    s = gw.gateway_summary()
    assert s["throttles"] == 1 and s["inflight"] == 0


# -- single-flight + result store -------------------------------------------
def test_single_flight_coalesces_then_store_serves_hits(tmp_path):
    def script(pkg, gw, fleet):
        Sim, spec = pkg.serve.SimRequest, _spec(pkg)
        fleet.auto = False
        req = Sim(spec=spec, n=4, seed=7)
        lead = gw.submit(req, token="tok-alice")
        follow = gw.submit(Sim(spec=spec, n=4, seed=7), token="tok-bob")
        assert fleet.dispatches == 1      # identical keys share a flight
        fleet.release_all()
        assert lead.result(timeout=T_OUT) is follow.result(timeout=T_OUT)
        s = gw.gateway_summary()
        assert s["coalesced"] == 1 and s["dispatched"] == 1 \
            and s["hits"] == 0
        # the flight's response is now content-addressed: a repeat is a
        # store hit, zero dispatches, the producer's service_s credited
        hit = gw.serve(req, token="tok-alice", timeout=T_OUT)
        assert fleet.dispatches == 1
        assert hit.replica == "gateway-cache"
        assert np.array_equal(hit.curves, lead.result().curves)
        assert np.array_equal(hit.autos, lead.result().autos)
        return hit.curves

    gw, _fleet, jres, pres = _both(tmp_path, script)
    assert np.array_equal(jres, pres)
    s = gw.gateway_summary()
    assert s["hits"] == 1 and s["device_s_saved"] == pytest.approx(0.25)
    assert gw.tenant_summary()["alice"]["hits"] == 1


def test_singleflight_table_is_bounded_with_bypass(tmp_path):
    def script(pkg, gw, fleet):
        Sim, spec = pkg.serve.SimRequest, _spec(pkg)
        fleet.auto = False
        f1 = gw.submit(Sim(spec=spec, n=4, seed=1), token="tok-alice")
        f2 = gw.submit(Sim(spec=spec, n=4, seed=2), token="tok-alice")
        assert fleet.dispatches == 2      # table full: dispatch, don't grow
        assert gw.gateway_summary()["coalesce_bypass"] == 1
        assert gw.gateway_summary()["flights_open"] == 1
        fleet.release_all()
        assert f1.result(timeout=T_OUT) is not f2.result(timeout=T_OUT)

    _both(tmp_path, script, singleflight_cap=1)


def test_corrupt_cached_payload_is_loud_miss_and_recompute(tmp_path):
    def script(pkg, gw, fleet):
        req = pkg.serve.SimRequest(spec=_spec(pkg), n=4, seed=9)
        first = gw.serve(req, token="tok-alice", timeout=T_OUT)
        assert fleet.dispatches == 1
        [payload] = list(gw.store.dir.glob("*.npz"))
        payload.write_bytes(payload.read_bytes()[:-3] + b"xyz")
        gw.store._mem.clear()             # force the disk read path
        pkg.flightrec.clear()
        with pytest.warns(RuntimeWarning, match="torn gateway result"):
            again = gw.serve(req, token="tok-alice", timeout=T_OUT)
        assert fleet.dispatches == 2      # recomputed, not served stale
        assert np.array_equal(again.curves, first.curves)
        assert gw.gateway_summary()["cache_rejects"] >= 1
        assert "gateway_store_corrupt_entry" in \
            [e["name"] for e in pkg.flightrec.snapshot()]
        # the recompute re-cached it: clean hit again, no third dispatch
        assert gw.serve(req, token="tok-alice",
                        timeout=T_OUT).replica == "gateway-cache"
        assert fleet.dispatches == 2

    _both(tmp_path, script)


# -- ResultStore lifecycle (mirrors the tune store's contract) --------------
def _put(pkg, store, spec_hash, fp, seed=3, n=8):
    key = pkg.gw.request_key(spec_hash, ("lane", spec_hash), seed, n, fp)
    store.put(key, {"spec_hash": spec_hash, "fp": fp.hash,
                    "service_s": 0.1, "bucket": n},
              {"curves": np.full((n, 5), float(seed))})
    return key


def test_request_keys_match_the_jax_package(tmp_path):
    """Equal specs and requests give equal content addresses: the spec,
    lane and (seed, n) parts always, the whole key under one fingerprint
    hash (the two packages' fingerprints differ by construction)."""
    fp = types.SimpleNamespace(hash="0123456789ab")
    for lane, seed, n in ((("sim",), 7, 4), (("os", ("hd",), "noise", True),
                                             1001, 32)):
        assert pgw.request_key("spec1", lane, seed, n, fp) == \
            jgw.request_key("spec1", lane, seed, n, fp)
    pg, _pf = _gw(PORT, tmp_path / "port")
    jg, _jf = _gw(JAX, tmp_path / "jax")
    for kw in (dict(npsr=3, ntoa=16), dict(npsr=8, ntoa=64, data_seed=101)):
        for make in ("SimRequest", "OSRequest"):
            pk = pg._request_key(getattr(pserve, make)(
                spec=pserve.ArraySpec(**kw), n=4, seed=7))
            jk = jg._request_key(getattr(jserve, make)(
                spec=jserve.ArraySpec(**kw), n=4, seed=7))
            assert pk.split("/")[1:] == jk.split("/")[1:]
            assert pk.split("/")[0] == pg.fp.hash != jk.split("/")[0]
    # stream kinds and named specs are not content-addressed in either
    for pkg, g in ((PORT, pg), (JAX, jg)):
        assert g._request_key(pkg.serve.StreamRequest(stream="s")) is None
        assert g._request_key(pkg.serve.SimRequest(spec="named", n=4)) \
            is None


def test_store_fingerprint_mismatch_is_loud_miss(tmp_path):
    for pkg in PKGS:
        fp = pkg.fingerprint()
        store = pkg.gw.ResultStore(tmp_path / id(pkg).__str__())
        _put(pkg, store, "spec123", fp)
        foreign = dataclasses.replace(fp, platform="tpu",
                                      device_kind="TPU v5e")
        pkg.flightrec.clear()
        foreign_key = pkg.gw.request_key("spec123", ("lane", "spec123"), 3,
                                         8, foreign)
        assert store.get(foreign_key, foreign, "spec123") is None
        assert store.rejects == 1
        assert "gateway_fingerprint_mismatch" in \
            [e["name"] for e in pkg.flightrec.snapshot()]


def test_jax_written_entry_is_a_loud_miss_for_the_port(tmp_path):
    """An entry the JAX gateway stored in the same directory is refused
    by the port's gateway (its fingerprint differs), never served."""
    jg, _jf = _gw(JAX, tmp_path / "gw")
    jres = jg.serve(jserve.SimRequest(spec=_spec(JAX), n=4, seed=9),
                    token="tok-alice", timeout=T_OUT)
    pg, pf = _gw(PORT, tmp_path / "gw")
    pflightrec.clear()
    res = pg.serve(pserve.SimRequest(spec=_spec(PORT), n=4, seed=9),
                   token="tok-alice", timeout=T_OUT)
    assert pf.dispatches == 1 and res.replica == "fake-0"
    assert np.array_equal(res.curves, jres.curves)
    assert pg.gateway_summary()["cache_rejects"] == 1
    assert "gateway_fingerprint_mismatch" in \
        [e["name"] for e in pflightrec.snapshot()]


def test_store_schema_version_bump_is_ignored(tmp_path):
    for pkg in PKGS:
        fp = pkg.fingerprint()
        root = tmp_path / str(id(pkg))
        store = pkg.gw.ResultStore(root)
        key = _put(pkg, store, "spec123", fp)
        idx = root / pkg.defaults.GATEWAY_INDEX_FILENAME
        raw = json.loads(idx.read_text())
        raw["entries"][key]["version"] = \
            pkg.defaults.GATEWAY_STORE_VERSION + 1
        idx.write_text(json.dumps(raw))
        fresh = pkg.gw.ResultStore(root)
        pkg.flightrec.clear()
        assert fresh.get(key, fp, "spec123") is None
        assert fresh.rejects == 1
        assert "gateway_entry_schema_mismatch" in \
            [e["name"] for e in pkg.flightrec.snapshot()]
        # file-level bump: the whole index is ignored, loudly
        raw["version"] = pkg.defaults.GATEWAY_STORE_VERSION + 1
        idx.write_text(json.dumps(raw))
        with pytest.warns(RuntimeWarning, match="schema"):
            assert len(pkg.gw.ResultStore(root)) == 0
    assert (pdefaults.GATEWAY_STORE_SCHEMA, pdefaults.GATEWAY_STORE_VERSION,
            pdefaults.GATEWAY_INDEX_FILENAME) == \
        (jdefaults.GATEWAY_STORE_SCHEMA, jdefaults.GATEWAY_STORE_VERSION,
         jdefaults.GATEWAY_INDEX_FILENAME)


def test_store_index_corruption_empties_loudly(tmp_path):
    for pkg in PKGS:
        root = tmp_path / str(id(pkg))
        store = pkg.gw.ResultStore(root)
        _put(pkg, store, "spec123", pkg.fingerprint())
        (root / pkg.defaults.GATEWAY_INDEX_FILENAME).write_text("not json {")
        with pytest.warns(RuntimeWarning, match="corrupt gateway"):
            assert len(pkg.gw.ResultStore(root)) == 0


def test_store_and_decoded_cache_are_lru_bounded(tmp_path):
    seen = []
    for pkg in PKGS:
        fp = pkg.fingerprint()
        store = pkg.gw.ResultStore(tmp_path / str(id(pkg)), cache_cap=2,
                                   store_cap=3)
        keys = [_put(pkg, store, f"spec{i}", fp) for i in range(5)]
        assert len(store) == 3 and len(store._mem) <= 2
        for key in keys[:2]:              # oldest evicted, payloads gone
            assert store._payload_path(key).exists() is False
            assert store.get(key, fp, key.split("/")[1]) is None
        survivor = store.get(keys[-1], fp, "spec4")
        assert survivor is not None
        assert float(survivor[1]["curves"][0, 0]) == 3.0
        seen.append(([k.split("/", 1)[1] for k in store._entries_locked()],
                     [k.split("/", 1)[1] for k in store._mem],
                     store.hits, store.rejects, store.puts))
    assert seen[0] == seen[1]


def test_default_gateway_dir_sits_beside_the_tune_store(tmp_path,
                                                       monkeypatch):
    from fakepta_tpu_torch.tune.store import default_store_path

    monkeypatch.delenv(pdefaults.GATEWAY_DIR_ENV, raising=False)
    monkeypatch.setenv(pdefaults.TUNE_DIR_ENV, str(tmp_path / "tune"))
    assert pgw.default_gateway_dir() == \
        default_store_path().parent / "gateway" == \
        tmp_path / "tune" / "gateway"
    monkeypatch.setenv(pdefaults.GATEWAY_DIR_ENV, str(tmp_path / "gw"))
    assert pgw.default_gateway_dir() == tmp_path / "gw"
    assert pdefaults.GATEWAY_DIR_ENV == jdefaults.GATEWAY_DIR_ENV
    assert pgw.ResultStore().dir == tmp_path / "gw"


def test_gateway_knobs_match_the_jax_package():
    names = [n for n in vars(jdefaults) if n.startswith("GATEWAY_")]
    assert len(names) == 13
    assert {n: getattr(pdefaults, n) for n in names} == \
        {n: getattr(jdefaults, n) for n in names}
    from fakepta_tpu_torch.serve import streams

    assert not hasattr(streams, "CUTOVER_RTOL")


# -- observability surfaces -------------------------------------------------
def test_promfmt_and_topview_render_gateway_sections(tmp_path):
    def script(pkg, gw, fleet):
        req = pkg.serve.SimRequest(spec=_spec(pkg), n=4, seed=5)
        gw.serve(req, token="tok-alice", timeout=T_OUT)
        gw.serve(req, token="tok-bob", timeout=T_OUT)     # store hit
        text = pkg.promfmt.render(gw.telemetry_rollup())
        assert "fakepta_gateway_cache_hits_total 1" in text
        assert 'fakepta_gateway_tenant_requests_total{tenant="alice"} 1' \
            in text
        assert 'fakepta_gateway_tenant_hit_rate{tenant="bob"} 1' in text
        for name in ("fakepta_gateway_device_seconds_saved",
                     "fakepta_gateway_cutovers_total",
                     "fakepta_gateway_cache_rejects_total"):
            assert name in pkg.promfmt.PROM_METRICS and name in text
        table = pkg.topview.render_table(gw.telemetry_rollup())
        assert "TENANT" in table and "alice" in table and "bob" in table
        assert "gateway: requests=2" in table
        return [ln for ln in text.splitlines()
                if ln.startswith("fakepta_gateway_")
                and "qps" not in ln]

    _gw_, _f, jlines, plines = _both(tmp_path, script)
    assert plines == jlines


# -- gateway-managed cutover ------------------------------------------------
def _stream_spec(pkg):
    return pkg.serve.ArraySpec(npsr=4, ntoa=40, tspan_years=3.0, n_red=3,
                               n_dm=3, gwb_ncomp=3)


def _append_req(pkg, seed, spec=None):
    tspan_s = 3.0 * 365.25 * 86400.0
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 0.9 * tspan_s, (4, 4)), axis=1)
    return pkg.serve.AppendRequest(stream="gw-cut", toas=t,
                                   residuals=rng.normal(0.0, 1e-7, (4, 4)),
                                   spec=spec)


def test_gateway_cutover_conserves_toas_under_concurrent_appends(tmp_path):
    """The fence protocol end to end through both gateways (a bare pool
    each): appends racing a cutover either land on the old state (and are
    replayed) or queue behind the fence; the TOA counts, the cutover's
    row and the post-swap append agree with the JAX gateway's."""
    got = {}
    for pkg in PKGS:
        if pkg is JAX:
            pool = jserve.ServePool(mesh=jax_mesh(jax.devices()[:1]))
        else:
            pool = pserve.ServePool(device="cpu")
        gw = pkg.gw.Gateway(pool, [pkg.gw.Tenant("alice", "tok-a")],
                            store=pkg.gw.ResultStore(tmp_path / str(id(pkg))))
        try:
            r1 = gw.serve(_append_req(pkg, 9, spec=_stream_spec(pkg)),
                          token="tok-a", timeout=T_OUT)
            assert r1["kind"] == "append" and r1["n_toas"] == 16
            n_blocks = [1]
            errs = []

            def racer():
                try:
                    for seed in (20, 21, 22):
                        gw.serve(_append_req(pkg, seed), token="tok-a",
                                 timeout=T_OUT)
                        n_blocks[0] += 1
                except Exception as exc:  # noqa: BLE001 (surfaced below)
                    errs.append(exc)

            th = threading.Thread(target=racer)
            th.start()
            wider = dataclasses.replace(_stream_spec(pkg), tspan_years=6.0)
            info = gw.cutover("gw-cut", wider)
            th.join(timeout=T_OUT)
            assert not errs, errs
            assert info["stream"] == "gw-cut" and info["managed_ms"] > 0
            assert info["new_tspan_s"] > info["old_tspan_s"]
            stats = gw.serve(pkg.serve.StreamRequest(stream="gw-cut"),
                             token="tok-a", timeout=T_OUT)
            assert stats["n_toas"] == 16 * n_blocks[0]   # zero dropped
            post = gw.serve(_append_req(pkg, 30), token="tok-a",
                            timeout=T_OUT)
            assert post["n_toas"] == stats["n_toas"] + 16
            assert gw.gateway_summary()["cutovers"] == 1
            # a bare-ServePool gateway still renders metrics (the pool's
            # single-replica rollup + the gateway/tenant sections)
            text = gw.metrics_text()
            assert "fakepta_gateway_cutovers_total 1" in text
            assert 'fakepta_gateway_tenant_requests_total{tenant="alice"}' \
                in text
            got[pkg is PORT] = (
                {k: info[k] for k in ("stream", "new_tspan_s",
                                      "old_tspan_s")},
                post["n_toas"], _counts(gw)["gateway"]["requests"])
        finally:
            gw.close()
    assert got[True] == got[False]


def test_cutover_of_unopened_stream_is_an_error(tmp_path):
    def script(pkg, gw, fleet):
        with pytest.raises(pkg.serve.ServeError):
            gw.cutover("nope", _stream_spec(pkg))

    gw, _fleet, _j, _p = _both(tmp_path, script)
    assert gw.gateway_summary()["cutovers"] == 0
    # a stream held by a socket replica is out of the gateway's reach
    remote = types.SimpleNamespace(replicas={"p0": types.SimpleNamespace()})
    with pytest.raises(pserve.ServeError, match="socket replica"):
        pgw.cutover_stream(remote, "s", _stream_spec(PORT))


# -- the single-flight fault of the JAX gateway ----------------------------
def test_failed_dispatch_aborts_its_flight(tmp_path):
    """A dispatch that ``fleet.submit`` refuses with ServeClosed: the JAX
    gateway releases the leader's slot but leaves its flight open, so the
    next identical request attaches to it as a follower and waits forever,
    holding a slot of its tenant's share. The port aborts the flight: the
    retry is dispatched and served, and no slot stays held."""
    for pkg in PKGS:
        gw, fleet = _gw(pkg, tmp_path / str(id(pkg)))
        req = pkg.serve.SimRequest(spec=_spec(pkg), n=4, seed=3)
        fleet.busy_exc = pkg.serve.ServeClosed("fleet is closed")
        with pytest.raises(pkg.serve.ServeClosed):
            gw.submit(req, token="tok-alice")
        fleet.busy_exc = None
        retry = gw.submit(req, token="tok-alice")
        s = gw.gateway_summary()
        if pkg is JAX:
            # the leak: the stale flight swallows the retry
            assert s["flights_open"] == 1 and s["coalesced"] == 1
            with pytest.raises(FutureTimeout):
                retry.result(timeout=0.2)
            assert s["inflight"] == 1 and fleet.dispatches == 0
        else:
            assert retry.result(timeout=T_OUT).replica == "fake-0"
            s = gw.gateway_summary()
            assert s["flights_open"] == 0 and s["coalesced"] == 0
            assert s["inflight"] == 0 and fleet.dispatches == 1
        gw.close()


def test_followers_of_a_refused_dispatch_fail_with_it(tmp_path):
    """A follower that attached while the leader's dispatch was being
    refused fails with the leader's error and gives its slot back."""
    gw, fleet = _gw(PORT, tmp_path / "gw")
    req = pserve.SimRequest(spec=_spec(PORT), n=4, seed=3)
    entered, go = threading.Event(), threading.Event()
    follower = {}

    def submit(_req):
        entered.set()
        go.wait(T_OUT)
        raise pserve.ServeError("no live replica")

    fleet.submit = submit
    th = threading.Thread(target=lambda: pytest.raises(
        pserve.ServeError, gw.submit, req, token="tok-alice"))
    th.start()
    assert entered.wait(T_OUT)
    follower["f"] = gw.submit(req, token="tok-bob")
    go.set()
    th.join(T_OUT)
    with pytest.raises(pserve.ServeError, match="no live replica"):
        follower["f"].result(timeout=T_OUT)
    s = gw.gateway_summary()
    assert s["flights_open"] == 0 and s["inflight"] == 0
    assert s["coalesced"] == 1
    assert gw.tenant_summary()["bob"]["completed"] == 0


def test_gateway_admit_fault_fires_before_any_state_moves(tmp_path):
    from fakepta_tpu_torch import faults

    gw, fleet = _gw(PORT, tmp_path / "gw")
    req = pserve.SimRequest(spec=_spec(PORT), n=4, seed=3)
    plan = faults.FaultPlan([faults.FaultSpec("gateway.admit", "transient",
                                              at=(0,))])
    with faults.inject(plan):
        with pytest.raises(faults.TransientFault):
            gw.submit(req, token="tok-alice")
        assert gw.gateway_summary()["requests"] == 0
        assert gw.serve(req, token="tok-alice",
                        timeout=T_OUT).replica == "fake-0"
    assert plan.fired == [("gateway.admit", "transient", 0)]
    with pytest.raises(pgw.GatewayAuthError):
        with faults.inject(faults.FaultPlan([faults.FaultSpec(
                "gateway.admit", "fatal", at=(0,))])):
            gw.submit(req, token="tok-mallory")   # auth comes first
    assert gw.gateway_summary()["requests"] == 1 and fleet.dispatches == 1


# -- the default fingerprint ------------------------------------------------
def test_gateway_over_a_cpu_fleet_fingerprints_the_cpu(tmp_path):
    flt = pserve.ServeFleet([pserve.LocalReplica(
        f"r{i}", device="cpu", index=i,
        config=pserve.ServeConfig(buckets=(4,))) for i in range(2)])
    try:
        gw = pgw.Gateway(flt, [pgw.Tenant("a", "tok-a")],
                         store=pgw.ResultStore(tmp_path / "gw"))
        assert gw.fp == fingerprint(["cpu"])
        assert gw.fp.platform == "cpu" and gw.fp.n_devices == 1
        for target in (flt.replicas["r0"], flt.replicas["r0"].pool):
            assert pgw.Gateway(target, [pgw.Tenant("a", "tok-a")],
                               store=pgw.ResultStore(tmp_path)).fp == gw.fp
        # a stub fleet names no device: keyed by the visible cards, or by
        # the CPU on a machine without one
        stub = _gw(PORT, tmp_path / "stub")[0]
        assert stub.fp.platform == ("gpu" if torch.cuda
                                    .is_available() else "cpu")
    finally:
        flt.close()


# -- the gateway load generator ---------------------------------------------
def test_make_tenant_requests_matches_the_jax_identities():
    pspecs = [pserve.ArraySpec(npsr=8, ntoa=64, data_seed=100 + i)
              for i in range(3)]
    jspecs = [jserve.ArraySpec(npsr=8, ntoa=64, data_seed=100 + i)
              for i in range(3)]
    for kw in (dict(n_requests=96, sizes=(1, 2, 4), seed=11),
               dict(n_requests=40, sizes=(3,), seed=0, n_identities=5,
                    zipf_s=2.0)):
        preqs, pidx = ploadgen.make_tenant_requests(pspecs, **kw)
        jreqs, jidx = jloadgen.make_tenant_requests(jspecs, **kw)
        assert pidx == jidx
        assert [(r.spec.spec_hash(), r.seed, r.n) for r in preqs] == \
            [(r.spec.spec_hash(), r.seed, r.n) for r in jreqs]


LG_SPEC = dict(npsr=8, ntoa=64, n_red=4, n_dm=4, gwb_ncomp=4)
#: config 16's traffic shape, cut to 64 requests over 2 specs and one
#: bucket (the JAX fleet's XLA builds are the file's cost)
LG_KW = dict(n_tenants=3, n_requests=64, sizes=(1, 2, 4), seed=11,
             n_specs=2, n_identities=12, n_replicas=2)


def _stored(pkg, root) -> dict:
    """{(spec_hash, seed, n): (curves, autos)} of a store directory."""
    store = pkg.gw.ResultStore(root)
    out = {}
    for key, meta in list(store._entries_locked().items()):
        fp = types.SimpleNamespace(hash=key.split("/")[0])
        _meta, arrays = store.get(key, fp, meta["spec_hash"])
        out[(meta["spec_hash"], meta["seed"], meta["n"])] = (
            arrays["curves"], arrays["autos"])
    return out


@pytest.fixture(scope="module")
def loadgen_rows(tmp_path_factory):
    root = tmp_path_factory.mktemp("gw-loadgen")
    jrow = jloadgen.run_gateway_loadgen(
        jserve.ArraySpec(**LG_SPEC), store_dir=root / "jax",
        config=jserve.ServeConfig(buckets=(16,)), **LG_KW)
    prow = ploadgen.run_gateway_loadgen(
        pserve.ArraySpec(**LG_SPEC), store_dir=root / "port", device="cpu",
        config=pserve.ServeConfig(buckets=(16,)), **LG_KW)
    return {"jax": jrow, "port": prow,
            "jax_store": _stored(JAX, root / "jax"),
            "port_store": _stored(PORT, root / "port")}


def test_gateway_loadgen_row_passes_every_gate(loadgen_rows):
    row = loadgen_rows["port"]
    assert set(row) == set(loadgen_rows["jax"])
    assert row["gw_tenants"] == 3
    assert row["gw_hit_rate"] >= 0.5 and row["gw_device_s_saved"] > 0
    assert row["gw_verified"] > 0 and row["gw_cutover_ms"] > 0
    # every request was admitted at some point (the appender's too)
    assert row["gw_requests"] >= LG_KW["n_requests"]


def test_gateway_loadgen_responses_match_the_jax_gateway(loadgen_rows):
    """Every identity either gateway computed is in both stores, and the
    port's response lies within the bf16 bound of the JAX one."""
    pst, jst = loadgen_rows["port_store"], loadgen_rows["jax_store"]
    assert pst and set(pst) == set(jst)
    for ident, (pc, pa) in pst.items():
        jc, ja = jst[ident]
        scale = float(np.abs(jc).max())
        np.testing.assert_allclose(pc, jc, rtol=0, atol=BF16_RTOL * scale)
        np.testing.assert_allclose(pa, ja, rtol=BF16_RTOL)


def test_gateway_loadgen_refuses_a_compile_cache_and_defaults_to_the_card():
    with pytest.raises(NotImplementedError, match="compile_cache_dir"):
        ploadgen.run_gateway_loadgen(compile_cache_dir="/nonexistent")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ploadgen.run_gateway_loadgen(pserve.ArraySpec(**LG_SPEC),
                                         n_requests=4)
