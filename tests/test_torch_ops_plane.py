"""The ops plane in the port, on the CPU, held to the JAX package's: the ops
endpoint, fleet telemetry, SLOs and incident dumps.

- The copies: ``utils/slo.py`` whole, and each function and class the port
  copied into ``utils/observability.py`` (fleet merges, ``FleetRegistry``,
  Prometheus rendering, ``OpsServer``, run summaries), are the originals'
  sources but for their imports.
- Prometheus text, byte for byte the JAX rendering of the same registry
  and fleet; ``FleetRegistry`` merges, summaries and its cardinality guard
  as the JAX registry's on the same reports.
- The ``SLOEngine`` state machine on ``tests/test_slo.py``'s cases, with
  the same transitions, states and events in both packages.
- ``OpsServer`` routes and bodies.
- A port server's ``/status`` against a JAX server's for the same
  federation: the same keys, nested keys included.
- Incident dumps: a firing SLO writes the server's bundle and solicits the
  clients' rings through the next poll, with port and JAX nodes on either
  side.
"""

import ast
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
from gfedntm_tpu.federation.client import Client as JClient
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu.utils import observability as jo
from gfedntm_tpu.utils import slo as jslo
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.server import FederatedServer
from gfedntm_tpu_torch.utils import observability as to
from gfedntm_tpu_torch.utils import slo as tslo

REPO = Path(__file__).resolve().parents[1]
MODEL_KWARGS = dict(n_components=4, hidden_sizes=(16, 16), batch_size=8, num_epochs=2, seed=0)
COPIED = ("merge_metric_snapshots", "merge_node_snapshots", "decode_telemetry_report",
          "FleetRegistry", "render_fleet_prometheus", "sample_process_metrics", "_hist_stats",
          "collect_data_plane", "summarize_model_quality", "summarize_privacy", "_prom_name",
          "_prom_label", "render_prometheus", "_accepts_kwarg", "OpsServer",
          "StragglerDetector", "encode_telemetry_report", "TelemetryShipper")


def _strip(tree, package):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _defs(path: Path, package: str) -> dict:
    """Top-level definitions of a module, docstrings stripped and
    ``package`` imports renamed to the JAX package's, as AST dumps."""
    tree = _strip(ast.parse(path.read_text().replace(f"{package}.", "gfedntm_tpu.")), package)
    return {getattr(n, "name", None): ast.dump(n) for n in tree.body}


def test_slo_copy_is_the_original():
    port = _strip(ast.parse((REPO / "gfedntm_tpu_torch/utils/slo.py").read_text()
                            .replace("gfedntm_tpu_torch.", "gfedntm_tpu.")), "")
    jax_ = _strip(ast.parse((REPO / "gfedntm_tpu/utils/slo.py").read_text()), "")
    assert ast.dump(port) == ast.dump(jax_)


@pytest.mark.parametrize("name", COPIED)
def test_observability_copies_are_the_originals(name):
    port = _defs(REPO / "gfedntm_tpu_torch/utils/observability.py", "gfedntm_tpu_torch")
    jax_ = _defs(REPO / "gfedntm_tpu/utils/observability.py", "gfedntm_tpu")
    assert port[name] == jax_[name]


# ---- Prometheus and the fleet, byte for byte -------------------------------------

def _registries(kind):
    regs = [to.MetricRegistry(), jo.MetricRegistry()]
    rng = np.random.default_rng(0)
    lat = rng.exponential(0.05, size=300).tolist()
    for reg in regs:
        if kind in ("mixed", "capped"):
            reg.counter("rpc_calls/FederationClient.TrainStep").inc(7)
            reg.gauge("quality_npmi").set(-0.25)
            reg.gauge("unset")
            for v in lat:
                reg.histogram("client_poll_s").observe(v)
        if kind == "capped":
            for c in range(12):
                reg.gauge(f"client_contribution_cos/client{c}").set(c / 12)
                reg.histogram(f"client_poll_s/client{c}").observe(0.01 * c)
        if kind == "names":
            reg.counter("9starts with a digit").inc()
            reg.gauge('odd/key "with" \\ quotes\nand newline').set(1.0)
    return regs


@pytest.mark.parametrize("kind,cap", [("mixed", 256), ("capped", 5), ("capped", 0),
                                      ("names", 256)])
def test_render_prometheus_is_the_jax_text(kind, cap):
    regs = _registries(kind)
    assert regs[0].snapshot() == regs[1].snapshot()
    text = to.render_prometheus(regs[0].snapshot(), max_series=cap)
    assert text == jo.render_prometheus(regs[1].snapshot(), max_series=cap)
    if kind == "capped" and cap:
        assert 'gfedntm_series_overflow_total{family="client_contribution_cos"} 7' in text


def _reports(seed):
    """Per-node registry snapshots of a small fleet, with one node whose
    histogram has other edges (unmergeable) and a counter in two nodes."""
    nodes = {}
    rng = np.random.default_rng(seed)
    for c in range(3):
        reg = to.MetricRegistry()
        reg.counter("rpc_calls").inc(c + 1)
        reg.gauge("g").set(float(c))
        for v in rng.exponential(0.1, size=20):
            reg.histogram("step_s").observe(float(v))
        nodes[f"client{c + 1}"] = reg.snapshot()
    nodes["client3"]["step_s"]["edges"] = nodes["client3"]["step_s"]["edges"][1:]
    nodes["client3"]["step_s"]["counts"] = nodes["client3"]["step_s"]["counts"][1:]
    return nodes


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_merges_and_rendering_are_the_jax_ones(seed):
    nodes = _reports(seed)
    assert to.merge_node_snapshots(nodes) == jo.merge_node_snapshots(nodes)
    assert "step_s" not in to.merge_node_snapshots(nodes)  # unmergeable: dropped
    assert to.merge_node_snapshots(nodes)["rpc_calls"]["value"] == 6.0
    assert to.render_fleet_prometheus(nodes, max_series=2) == jo.render_fleet_prometheus(
        nodes, max_series=2)
    fleets = [mod.FleetRegistry(metrics=mod.MetricsLogger(keep_records=True)) for mod in (to, jo)]
    for node, snap in nodes.items():
        data = to.encode_telemetry_report({node: snap}, full=True)
        assert data == jo.encode_telemetry_report({node: snap}, full=True)
        assert all(f.ingest_bytes(data) for f in fleets)
    assert fleets[0].merged() == fleets[1].merged()
    summaries = [f.summary(top_k=2) for f in fleets]
    for s in summaries:
        for row in s["top_nodes"]:
            row.pop("report_age_s")
    assert summaries[0] == summaries[1]
    assert not fleets[0].ingest_bytes(b"garbage") and not fleets[1].ingest_bytes(b"garbage")
    assert [f.metrics.registry.counter("fleet_reports_invalid").value for f in fleets] == [1, 1]
    with pytest.raises(ValueError):
        to.decode_telemetry_report(b"\x78\x9c")


@pytest.mark.parametrize("limit", ["max_nodes", "max_series_per_node"])
def test_fleet_cardinality_guard_is_the_jax_ones(limit):
    kw = dict(max_nodes=2, max_series_per_node=100) if limit == "max_nodes" \
        else dict(max_nodes=100, max_series_per_node=2)
    logs = [to.MetricsLogger(keep_records=True), jo.MetricsLogger(keep_records=True)]
    fleets = [mod.FleetRegistry(metrics=log, **kw) for mod, log in zip((to, jo), logs)]
    results = []
    for f in fleets:
        results.append([f.ingest(f"n{i}", {"a": {"type": "counter", "value": 1.0},
                                           "b": {"type": "counter", "value": 2.0},
                                           "c": {"type": "counter", "value": 3.0}})
                        for i in range(3)])
    assert results[0] == results[1] and not all(results[0])
    assert fleets[0].node_snapshots() == fleets[1].node_snapshots()
    events = [[(r["node"], r["reason"]) for r in log.events("fleet_overflow")] for log in logs]
    assert events[0] == events[1] and events[0] and all(r == limit for _n, r in events[0])
    assert [log.registry.counter("fleet_reports_dropped").value for log in logs] == [3.0, 3.0] \
        or logs[0].registry.counter("fleet_reports_dropped").value == \
        logs[1].registry.counter("fleet_reports_dropped").value


# ---- the SLO engine on tests/test_slo.py's cases -------------------------------

def _spec(**over):
    base = dict(name="errs", metric="serving_errors", agg="value", op="<=", threshold=0.0)
    base.update(over)
    return base


def _lifecycle(mod, m):
    snap = {"serving_errors": {"type": "counter", "value": 0.0}}
    engine = mod.SLOEngine([_spec(for_s=5.0)], snapshot_fn=lambda: snap, metrics=m)
    out = [engine.evaluate(now=100.0)]
    snap["serving_errors"]["value"] = 3.0
    out += [engine.evaluate(now=101.0), engine.evaluate(now=103.0), engine.evaluate(now=106.5)]
    snap["serving_errors"]["value"] = 0.0
    out.append(engine.evaluate(now=110.0))
    return engine, out


def _short_violation(mod, m):
    snap = {"serving_errors": {"type": "counter", "value": 0.0}}
    engine = mod.SLOEngine([_spec(for_s=10.0)], snapshot_fn=lambda: snap, metrics=m)
    out = [engine.evaluate(now=0.0)]
    snap["serving_errors"]["value"] = 1.0
    out.append(engine.evaluate(now=1.0))
    snap["serving_errors"]["value"] = 0.0
    out.append(engine.evaluate(now=2.0))
    return engine, out


def _no_data(mod, m):
    snap = {"serving_errors": {"type": "counter", "value": 2.0}}
    engine = mod.SLOEngine([_spec(for_s=0.0)], snapshot_fn=lambda: dict(snap), metrics=m)
    out = [engine.evaluate(now=0.0)]
    del snap["serving_errors"]
    out.append(engine.evaluate(now=10.0))
    return engine, out


def _percentiles(mod, m):
    h = m.registry.histogram("serve_latency_s")
    for v in [0.01] * 95 + [2.0] * 5:
        h.observe(v)
    m.registry.gauge("serving_queue_depth").set(3.0)
    engine = mod.SLOEngine(
        [{"name": "p99", "metric": "serve_latency_s", "agg": "p99", "op": "<=",
          "threshold": 0.25},
         {"name": "p50", "metric": "serve_latency_s", "agg": "p50", "op": "<=",
          "threshold": 0.25},
         {"name": "mean", "metric": "serve_latency_s", "agg": "mean", "op": "<=",
          "threshold": 0.25, "window_s": 30},
         {"name": "queue", "metric": "serving_queue_depth", "agg": "value", "op": "<",
          "threshold": 8}],
        snapshot_fn=m.registry.snapshot, metrics=m)
    return engine, [engine.evaluate(now=0.0)]


def _windowed_rate(mod, m):
    c = m.registry.counter("serving_requests_shed")
    engine = mod.SLOEngine(
        [{"name": "shed-rate", "metric": "serving_requests_shed", "agg": "rate", "op": "<=",
          "threshold": 0.5, "window_s": 5.0}], snapshot_fn=m.registry.snapshot, metrics=m)
    out = [engine.evaluate(now=0.0)]
    c.inc(100)
    out += [engine.evaluate(now=2.0), engine.evaluate(now=8.0), engine.evaluate(now=14.0)]
    return engine, out


SLO_CASES = {
    "lifecycle": (_lifecycle, {"errs": ("resolved", True)}),
    "short violation": (_short_violation, {"errs": ("ok", False)}),
    "no data holds": (_no_data, {"errs": ("firing", True)}),
    "percentiles": (_percentiles, {"p99": ("firing", True), "p50": ("ok", False),
                                   "mean": ("ok", False), "queue": ("ok", False)}),
    "windowed rate": (_windowed_rate, {"shed-rate": ("resolved", True)}),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_state_machine_is_the_jax_ones(case):
    run, want = SLO_CASES[case]
    results = []
    for mod, obs in ((tslo, to), (jslo, jo)):
        m = obs.MetricsLogger(keep_records=True, node="server")
        engine, transitions = run(mod, m)
        events = [{k: v for k, v in r.items() if k != "time"} for r in m.records
                  if r["event"] != "metrics_snapshot"]
        results.append((transitions, engine.status(), events, engine.ever_fired(),
                        m.registry.snapshot()))
    assert results[0] == results[1]
    status = results[0][1]
    assert {a["alert"]: (a["state"], a["ever_fired"]) for a in status["alerts"]} == want


def test_slo_specs_and_stream_evaluation_are_the_jax_ones(tmp_path):
    for bad in (_spec(agg="p42"), _spec(op="=="), _spec(agg="rate"), _spec(name=""),
                _spec(typo=1), {"name": "x", "metric": "m"}):
        for mod in (tslo, jslo):
            with pytest.raises(ValueError):
                mod.SLOSpec.from_dict(bad)
    with pytest.raises(ValueError, match="duplicate"):
        tslo.SLOEngine([_spec(), _spec()], snapshot_fn=dict)
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"slos": [_spec(name="a"), _spec(name="b", window_s=3)]}))
    assert [s.objective() for s in tslo.load_slo_specs(str(path))] == \
        [s.objective() for s in jslo.load_slo_specs(str(path))]
    nodes = {n: [{"event": "metrics_snapshot", "time": 1000.0 + i, "node": n,
                  "metrics": {"steps": {"type": "counter", "value": float(v)}}}
                 for i, v in enumerate([1, 2, 3])] for n in ("client1", "client2")}
    specs = [{"name": "total", "metric": "steps", "agg": "value", "op": "<=", "threshold": 5.0}]
    assert tslo.evaluate_stream(nodes, specs).ever_fired() == ["total"]
    assert tslo.evaluate_stream({"client1": nodes["client1"]}, specs).ever_fired() == []
    assert tslo.evaluate_stream(nodes, specs).status() == jslo.evaluate_stream(nodes,
                                                                              specs).status()


# ---- the ops endpoint ---------------------------------------------------------

def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


@pytest.mark.parametrize("ready", [None, True, False])
def test_ops_server_routes_and_bodies(ready):
    reg = to.MetricRegistry()
    reg.counter("rpc_calls").inc(3)
    fleet = to.FleetRegistry()
    fleet.ingest("client1", {"rpc_calls": {"type": "counter", "value": 2.0}})
    fleet.ingest("client2", {"rpc_calls": {"type": "counter", "value": 5.0}})
    calls = []

    def status(full=False):
        calls.append(full)
        return {"round": 4, "full": full}

    ops = to.OpsServer(registry=reg, status_fn=status, port=0, fleet=fleet,
                       ready_fn=None if ready is None else (lambda: ready),
                       alerts_fn=lambda: {"alerts": [], "firing": 0},
                       routes={"/echo": lambda body, query: (200, "text/plain", body[::-1])})
    port = ops.start()
    try:
        assert _get(port, "/healthz")[::2] == (200, b"ok\n")
        assert _get(port, "/ready")[0] == (503 if ready is False else 200)
        code, ctype, body = _get(port, "/metrics")
        text = body.decode()
        assert code == 200 and ctype.startswith("text/plain")
        assert "gfedntm_rpc_calls_total 3.0" in text
        assert "gfedntm_fleet_rpc_calls_total 7.0" in text  # the exact merge
        assert 'gfedntm_node_rpc_calls_total{node="client2"} 5.0' in text
        assert "gfedntm_process_uptime_s" in text
        assert json.loads(_get(port, "/status")[2]) == {"round": 4, "full": False}
        assert json.loads(_get(port, "/status?full=1")[2])["full"] is True
        assert calls == [False, True]
        assert json.loads(_get(port, "/status.fleet")[2])["nodes"] == 2
        assert json.loads(_get(port, "/alerts")[2]) == {"alerts": [], "firing": 0}
        assert _get(port, "/nope")[0] == 404
        req = urllib.request.Request(f"http://127.0.0.1:{port}/echo", data=b"abc")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.read() == b"cba"
    finally:
        ops.stop()


def test_status_fn_errors_are_500s_and_the_endpoint_lives_on():
    def broken(full=False):
        raise RuntimeError("boom")

    ops = to.OpsServer(status_fn=broken, port=0)
    port = ops.start()
    try:
        code, _ctype, body = _get(port, "/status")
        assert code == 500 and b"boom" in body
        assert _get(port, "/healthz")[0] == 200
        assert _get(port, "/status.fleet")[0] == 404  # no fleet mounted
    finally:
        ops.stop()


# ---- federations: /status keys, incident dumps -----------------------------------

def _documents(n_clients=2, docs=18, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"word{i:03d}" for i in range(90)]
    return [[" ".join(rng.choice(words[20 * c:20 * c + 60], size=25))
             for _ in range(docs + 22 * c)] for c in range(n_clients)]


#: One SLO that holds and one that fires at the first round's tick.
SLOS = [{"name": "poll-p99", "metric": "client_poll_s", "agg": "p99", "op": "<=",
         "threshold": 600.0},
        {"name": "one-poll", "metric": "client_polls", "agg": "value", "op": "<=",
         "threshold": 1.0}]


def _federate(tmp_path, server_side, client_side, fetch_at=3):
    docs = _documents()
    ref = tmp_path / "ref.txt"
    tmp_path.mkdir(parents=True, exist_ok=True)
    ref.write_text("\n".join(d for c in docs for d in c) + "\n")
    kw = dict(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS, max_iters=200,
              save_dir=str(tmp_path / "server"), ops_port=0, slo_specs=SLOS,
              dump_dir=str(tmp_path / "incidents"), quality_every=1, quality_ref=str(ref),
              dp="server", dp_sigma=0.05)
    if server_side == "jax":
        server = JServer(metrics=jo.MetricsLogger(keep_records=True, node="server"), **kw)
    else:
        server = FederatedServer(metrics=to.MetricsLogger(keep_records=True, node="server"),
                                 device="cpu", **kw)
    addr = server.start("[::]:0")
    clients = []
    for c, d in enumerate(docs):
        common = dict(client_id=c + 1, server_address=addr, max_features=80,
                      dump_dir=str(tmp_path / f"client{c + 1}"))
        if client_side == "port":
            clients.append(Client(corpus=RawCorpus(documents=d), device="cpu",
                                  metrics=to.MetricsLogger(keep_records=True,
                                                           node=f"client{c + 1}"), **common))
        else:
            clients.append(JClient(corpus=JRawCorpus(documents=d),
                                   metrics=jo.MetricsLogger(keep_records=True,
                                                            node=f"client{c + 1}"), **common))
    threads = [threading.Thread(target=cl.run, daemon=True) for cl in clients]
    fetched = {}
    try:
        for t in threads:
            t.start()
        while not server.wait_done(timeout=0.05):
            if not fetched and server.global_iterations >= fetch_at:
                for route in ("/status", "/status?full=1", "/status.fleet", "/alerts",
                              "/metrics"):
                    fetched[route] = _get(server.ops_actual_port, route)
        assert server.wait_done(timeout=120.0)
        for t in threads:
            t.join(timeout=30.0)
        assert all(not t.is_alive() for t in threads)
    finally:
        server.stop(grace=0.2, join_timeout=10.0)
        for cl in clients:
            cl.shutdown(grace=0.2)
    return server, clients, fetched


def _keys(tree, prefix=""):
    """Dotted key paths of a JSON tree's dicts (lists' dict items merged)."""
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if k in ("clients", "history", "stragglers") and isinstance(v, (dict, list)) \
                    and prefix in ("", "model_quality.contributions."):
                # Per-client rosters: keyed by client ids.
                out.add(path)
                continue
            out.add(path)
            out |= _keys(v, path + ".")
    elif isinstance(tree, list):
        for item in tree:
            out |= _keys(item, prefix)
    return out


#: ``/status`` keys of JAX server planes the port has not ported yet: none
#: differs for a sync federation (pacing's view is the sync engine's).
QUEUED_STATUS_KEYS: set = set()


@pytest.fixture(scope="module")
def jax_federation(tmp_path_factory):
    return _federate(tmp_path_factory.mktemp("jax"), "jax", "jax")


def test_status_keys_are_the_jax_servers(tmp_path, jax_federation):
    port, _clients, fetched = _federate(tmp_path, "port", "port")
    jserver, _jclients, jfetched = jax_federation
    for route in ("/status", "/status?full=1"):
        got = json.loads(fetched[route][2])
        want = json.loads(jfetched[route][2])
        assert _keys(got) ^ _keys(want) <= QUEUED_STATUS_KEYS, route
    assert fetched["/status"][0] == jfetched["/status"][0] == 200
    # The live payloads: the same planes on, the same views of them.
    for key in ("privacy", "model_quality", "fleet", "pacing"):
        assert (json.loads(fetched["/status"][2])[key] is None) == \
            (json.loads(jfetched["/status"][2])[key] is None)
    assert json.loads(fetched["/status"][2])["fleet"]["nodes"] == 3
    assert sorted(n["node"] for n in json.loads(fetched["/status.fleet"][2])["top_nodes"]) == \
        ["client1", "client2", "server"]
    final = [s._status(full=True) for s in (port, jserver)]
    assert _keys(final[0]) ^ _keys(final[1]) <= QUEUED_STATUS_KEYS
    assert final[0]["privacy"]["steps"] == port.global_iterations
    assert final[0]["pacing"] == {"policy": "sync", "staleness_alpha": 0.5,
                                  "last_cohort": final[0]["pacing"]["last_cohort"]}


def _bundles(server_dir: Path) -> dict:
    incidents = {}
    for f in server_dir.iterdir():
        ident, _, node = f.name[len("inc-"):-len(".json")].partition("__")
        incidents.setdefault(ident, set()).add(node)
    return incidents


@pytest.mark.parametrize("server_side,client_side", [("port", "port"), ("port", "jax"),
                                                     ("jax", "port"), ("jax", "jax")])
def test_incident_bundles_carry_the_clients_solicited_rings(tmp_path, server_side, client_side,
                                                            jax_federation):
    if (server_side, client_side) == ("jax", "jax"):
        server, clients, _f = jax_federation
    else:
        server, clients, _f = _federate(tmp_path, server_side, client_side)
    incidents = _bundles(Path(server.dump_dir))
    reasons = sorted(r["reason"] for r in server.metrics.events("incident_captured"))
    assert reasons == ["slo_alert"]  # dp_budget 0: the ledger is tracked, never exceeded
    (nodes,) = incidents.values()
    assert nodes == {"server", "client1", "client2"}
    (ident,) = incidents
    for node in ("client1", "client2"):
        bundle = json.loads((Path(server.dump_dir) / f"inc-{ident}__{node}.json").read_text())
        assert bundle["node"] == node and bundle["reason"] == "remote_capture"
        assert any(r.get("kind") == "train_step" for r in bundle["ring"])
    server_bundle = json.loads(
        (Path(server.dump_dir) / f"inc-{ident}__server.json").read_text())
    assert server_bundle["status"]["fleet"]["nodes"] == 3
    assert server_bundle["trigger"]["alert"] == "one-poll"
    assert len(server.metrics.events("flightrec_received")) == 2
    alerts = {a["alert"]: a["ever_fired"] for a in server.slo.status()["alerts"]}
    assert alerts == {"poll-p99": False, "one-poll": True}
    assert all(Path(cl.dump_dir).is_dir() for cl in clients)


def test_dump_dir_off_constructs_nothing():
    m = to.MetricsLogger(keep_records=True)
    server = FederatedServer(min_clients=1, device="cpu", metrics=m)
    assert server._incident_trigger is None and m.recorder is None
    assert server.flightrec_token() == "" and server.slo is None
    assert server._ops_server is None and server.ops_port is None
