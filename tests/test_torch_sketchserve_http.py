"""repro_torch.sketchserve's HTTP frontend on the CPU: request round trips
over localhost equal the in-process answers, the Response→status-code
contract (ok 200 / rejected 429 with Retry-After / error 400), malformed
input, unknown paths and healthz — the cases of tests/test_sketchserve_http.py
— and the same wire bodies as the reference's frontend for the same
requests. Every server binds port 0 and closes in ``finally``."""
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import repro.api as japi
import repro.sketchserve as jserve
from repro_torch.api import Plan
from repro_torch.sketchserve import SketchService, serve_http
from repro_torch.sketchserve.snapshot import plan_to_json
from torch_layout import prng_layout  # noqa: F401  (the port's draws in JAX's layout)

P = 32
BS = 64



def _plan(**kw):
    base = dict(backend="stream", gamma=0.5, batch_size=BS)
    base.update(kw)
    return Plan(**base)


def _call(url, body=None):
    """POST json (or GET when body is None); (code, body, headers) — HTTP
    error codes are part of the protocol, not failures."""
    if body is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(url, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _create(url, tid, kind, plan, key, **params):
    return _call(url + "/admin", {"op": "create_tenant", "params": {
        "tid": tid, "kind": kind, "key": key, "plan": plan_to_json(plan), "params": params}})


def test_http_round_trip_matches_in_process():
    rows = np.random.default_rng(0).normal(size=(2 * BS, P))
    with SketchService(device="cpu") as svc:
        fe = serve_http(svc)
        try:
            code, body, _ = _create(fe.url, "t", "pca", _plan(cov_path="lowrank", rank=12), 3,
                                    n_components=3)
            assert code == 200 and body["status"] == "ok", body
            code, body, _ = _call(fe.url + "/ingest", {"target": "t", "rows": rows.tolist()})
            assert code == 200 and body["info"]["count"] == 2 * BS
            code, body, _ = _call(fe.url + "/query?tenant=t&op=components")
            assert code == 200
            want = svc.query("t", "components").unwrap()
            assert np.array_equal(np.asarray(body["result"]["components"], np.float32),
                                  want["components"])
            code, body, _ = _call(fe.url + "/query",
                                  {"tenant": "t", "op": "transform", "x": rows[:4].tolist()})
            assert code == 200 and np.asarray(body["result"]).shape == (4, 3)
            code, body, _ = _call(fe.url + "/healthz")
            assert code == 200 and body["result"] == {"workers": 1, "tenants": 1, "evicted": 0}
        finally:
            fe.close()


def test_http_bodies_match_reference_frontend():
    """The same wire requests to the reference's frontend and the port's
    give the same codes, statuses, infos and (within 1e-5) results."""
    rows = np.random.default_rng(1).normal(size=(BS, P)).tolist()
    bodies = []
    for mod, plan in ((jserve, japi.Plan(backend="stream", gamma=0.5, batch_size=BS)),
                      (None, _plan())):
        svc = jserve.SketchService() if mod is jserve else SketchService(device="cpu")
        serve = jserve.serve_http if mod is jserve else serve_http
        with svc:
            fe = serve(svc)
            try:
                got = [_create(fe.url, "t", "mean", plan, 1)[:2],
                       _call(fe.url + "/ingest", {"target": "t", "rows": rows})[:2],
                       _call(fe.url + "/query?tenant=t&op=mean")[:2],
                       _call(fe.url + "/query?tenant=t&op=stats")[:2],
                       _call(fe.url + "/query?tenant=t&op=centers")[:2]]
            finally:
                fe.close()
        bodies.append(got)
    ref, port = bodies
    for (rc, rb), (pc, pb) in zip(ref, port):
        assert rc == pc and rb["status"] == pb["status"] and rb["info"] == pb["info"]
        assert (rb["error"] is None) == (pb["error"] is None)
    np.testing.assert_allclose(port[2][1]["result"], ref[2][1]["result"], rtol=1e-5, atol=1e-5)
    assert port[3][1]["result"] == ref[3][1]["result"]


def test_http_backpressure_is_429_with_retry_after():
    with SketchService(max_pending_rows=BS, device="cpu") as svc:
        fe = serve_http(svc)
        try:
            assert _create(fe.url, "t", "mean", _plan(), 1)[0] == 200
            code, body, hdrs = _call(fe.url + "/ingest",
                                     {"target": "t", "rows": np.zeros((BS + 1, P)).tolist()})
            assert code == 429
            assert body["status"] == "rejected" and "pending" in body["error"]
            assert hdrs["Retry-After"] == "1"
            code, _, _ = _call(fe.url + "/ingest",
                               {"target": "t", "rows": np.zeros((8, P)).tolist()})
            assert code == 200
            assert svc.stats["rejected"] == 1
        finally:
            fe.close()


def test_http_errors_and_unknown_paths():
    with SketchService(device="cpu") as svc:
        fe = serve_http(svc)
        try:
            code, body, _ = _call(fe.url + "/query?tenant=nope&op=mean")
            assert code == 400 and "unknown tenant" in body["error"]
            assert _call(fe.url + "/ingest", {"target": "nope", "rows": [[1.0] * P]})[0] == 400
            req = urllib.request.Request(fe.url + "/ingest", b"{not json",
                                         {"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=30)
            assert exc.value.code == 400
            assert "bad JSON" in json.loads(exc.value.read())["error"]
            assert _call(fe.url + "/ingest", {"rows": [[1.0] * P]})[0] == 400
            code, body, _ = _call(fe.url + "/query?tenant=t")
            assert code == 400 and "op=" in body["error"]
            assert _call(fe.url + "/admin", {"op": "create_tenant", "params": {
                "tid": "x", "kind": "mean", "plan": dict(plan_to_json(_plan()), impl="jnp")}})[0] == 400
            assert _call(fe.url + "/admin", {"op": "nope"})[0] == 400
            assert _call(fe.url + "/nope", {})[0] == 404
            assert _call(fe.url + "/nope")[0] == 404
        finally:
            fe.close()
