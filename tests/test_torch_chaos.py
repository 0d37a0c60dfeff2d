"""Process-level chaos in the port: the twin of ``tests/chaos/harness.py``
and ``tests/chaos/test_process_chaos.py`` (slow-marked).

The server, every relay and every client are separate ``python -m
gfedntm_tpu_torch ... --device cpu`` processes, and the kills are real
``SIGKILL``s, so recovery is proven against real process death: no shared
interpreter, no in-memory state surviving the crash. The harness functions
live in this file.

1. SIGKILL the server mid-round: a respawn with the IDENTICAL argv (zero
   operator flags) resumes from the round journal, >= 3 of 4 clients
   reconnect by their session tokens, and the run reaches finite betas
   within tolerance of a no-crash baseline.
2. SIGKILL one client mid-step: the rounds complete by quorum, the
   replacement process rejoins as a fresh session, and ``codec_ref_miss``
   and ``rpcs_deduplicated`` stay 0 under the delta wire codec.
3. SIGKILL one relay of a two-tier hierarchy mid-round: a respawn with the
   IDENTICAL argv recovers the shard from its journal (``relay_recovered``),
   its members reconnect by token, every member finishes, the root's
   counters stay 0, and the final betas match a no-crash hierarchical
   baseline within tolerance.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from gfedntm_tpu_torch.eval.metrics import topic_similarity_score

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def make_archive(path: str, n_nodes: int = 4, seed: int = 7) -> None:
    """A small synthetic multi-node corpus archive for the CLI's
    ``--data_type synthetic`` path."""
    from gfedntm_tpu_torch.data.synthetic import (
        generate_synthetic_corpus,
        save_reference_npz,
    )

    corpus = generate_synthetic_corpus(
        vocab_size=60, n_topics=4, n_docs=40, nwords=(20, 40),
        n_nodes=n_nodes, frozen_topics=2, seed=seed,
    )
    save_reference_npz(corpus, path)


def _spawn(argv: list[str], log_path: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "gfedntm_tpu_torch", *argv, "--device", "cpu"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
        )


def spawn_server(save_dir: str, port: int, archive: str,
                 extra: list[str] = (), n_clients: int = 4,
                 max_iters: int = 400,
                 num_epochs: int = 4) -> subprocess.Popen:
    """The federation server role (``--id 0``), zero recovery flags — a
    respawn with the SAME argv must auto-recover on its own.
    ``num_epochs`` paces the run length: kills are timed against the
    round journal, so the federation must comfortably outlive the
    orchestration latency (subprocess spawn + the interpreter's imports) or the run ends before the chaos lands."""
    argv = [
        "--id", "0", "--source", archive,
        "--min_clients_federation", str(n_clients),
        "--max_iters", str(max_iters),
        "--listen_port", str(port), "--save_dir", save_dir,
        "--n_components", "3", "--num_epochs", str(num_epochs),
        "--batch_size", "8",
        "--seed", "0", "--checkpoint_every", "0", "--verbose",
        *extra,
    ]
    return _spawn(argv, os.path.join(save_dir, "server_stdout.log"))


def spawn_relay(relay_id: int, save_dir: str, port: int,
                upstream_port: int, archive: str, n_members: int = 2,
                extra: list[str] = ()) -> subprocess.Popen:
    """The mid-tier aggregator role (``--role relay``): terminates
    ``n_members`` members on ``port`` and joins the root at
    ``upstream_port`` as client ``relay_id``. Zero recovery flags — a
    respawn with the SAME argv must auto-recover the shard on its own
    (the CLI calls ``maybe_autorecover()`` before serving)."""
    argv = [
        "--role", "relay", "--id", str(relay_id), "--source", archive,
        "--server_address", f"localhost:{upstream_port}",
        "--min_clients_federation", str(n_members),
        "--listen_port", str(port), "--save_dir", save_dir,
        # Fast dead-root detection + a patient upstream reconnect
        # window, mirroring the member posture below.
        "--liveness_timeout", "30", "--reconnect_window", "300",
        "--verbose",
        *extra,
    ]
    os.makedirs(save_dir, exist_ok=True)
    return _spawn(
        argv, os.path.join(save_dir, f"relay{relay_id}_stdout.log")
    )


def spawn_client(client_id: int, save_dir: str, port: int, archive: str,
                 extra: list[str] = (),
                 num_epochs: int = 4) -> subprocess.Popen:
    argv = [
        "--id", str(client_id), "--source", archive,
        "--server_address", f"localhost:{port}",
        "--save_dir", save_dir,
        "--n_components", "3", "--num_epochs", str(num_epochs),
        "--batch_size", "8",
        "--seed", "0",
        # Fast dead-server detection + a patient reconnect window: the
        # respawned server needs time to import + recover.
        "--liveness_timeout", "30", "--reconnect_window", "300",
        "--verbose",
        *extra,
    ]
    os.makedirs(save_dir, exist_ok=True)
    return _spawn(
        argv, os.path.join(save_dir, f"client{client_id}_stdout.log")
    )


def wait_for_port(port: int, timeout: float = 180.0) -> None:
    """Block until the server process actually listens: the CLI spends
    seconds importing torch and the port before binding, and a client
    spawned too early would exhaust its join retries against a
    connection-refused socket (operators start the server first for the
    same reason)."""
    import socket

    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return
        except OSError:
            time.sleep(0.5)
    raise AssertionError(
        f"server never listened on port {port} within {timeout:.0f}s"
    )


def sigkill(proc: subprocess.Popen) -> None:
    """The real thing — no cleanup handlers run, no sockets linger by
    agreement, nothing graceful."""
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)


def wait_for(predicate, timeout: float, what: str, poll_s: float = 0.5):
    """Poll ``predicate`` until truthy; raise with ``what`` on timeout."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(poll_s)
    raise AssertionError(f"timed out after {timeout:.0f}s waiting for {what}")


def journal_round(save_dir: str):
    """The journal's last fully-pushed round, or None before the first
    write (ignores in-flight torn reads — this polls a live server)."""
    path = os.path.join(save_dir, "checkpoints", "journal.json")
    try:
        with open(path) as fh:
            return json.load(fh).get("round")
    except (OSError, ValueError):
        return None


def read_events(metrics_path: str, event: str) -> list[dict]:
    if not os.path.exists(metrics_path):
        return []
    out = []
    with open(metrics_path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line of a killed process
            if rec.get("event") == event:
                out.append(rec)
    return out


def final_counter(metrics_path: str, name: str) -> float:
    """The counter's value in the LAST metrics snapshot (0 if absent)."""
    value = 0.0
    with open(metrics_path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("event") == "metrics_snapshot":
                metric = rec["metrics"].get(name)
                if metric is not None:
                    value = float(metric["value"])
    return value


def load_server_betas(save_dir: str) -> np.ndarray:
    with np.load(os.path.join(save_dir, "server_model.npz")) as data:
        return np.asarray(data["betas"])


def drain(procs: list[subprocess.Popen], timeout: float) -> list[int]:
    """Wait for every process to exit; SIGKILL stragglers (test failure
    surfaces via the returned codes)."""
    deadline = time.time() + timeout
    codes = []
    for proc in procs:
        remaining = max(1.0, deadline - time.time())
        try:
            codes.append(proc.wait(timeout=remaining))
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            codes.append(-9)
    return codes


pytestmark = [pytest.mark.slow, pytest.mark.chaos]


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_baseline(tmp_path, archive, n_clients=4):
    """A no-crash federation over the same archive/seeds: the betas the
    crashed-and-recovered run must stay close to."""
    port = _free_port()
    save_dir = str(tmp_path / "baseline")
    os.makedirs(save_dir, exist_ok=True)
    server = spawn_server(save_dir, port, archive,
                                  n_clients=n_clients)
    wait_for_port(port)
    clients = [
        spawn_client(i + 1, str(tmp_path / f"base_c{i + 1}"),
                             port, archive)
        for i in range(n_clients)
    ]
    codes = drain([server, *clients], timeout=600)
    assert codes == [0] * (n_clients + 1), f"baseline exit codes {codes}"
    return load_server_betas(save_dir)


def test_server_sigkill_zero_flag_autorecovery(tmp_path):
    archive = str(tmp_path / "corpus.npz")
    make_archive(archive, n_nodes=4)
    baseline = _run_baseline(tmp_path, archive)

    port = _free_port()
    save_dir = str(tmp_path / "crash")
    os.makedirs(save_dir, exist_ok=True)
    server1 = spawn_server(save_dir, port, archive)
    wait_for_port(port)
    clients = [
        spawn_client(i + 1, str(tmp_path / f"crash_c{i + 1}"),
                             port, archive)
        for i in range(4)
    ]
    try:
        # mid-round: past the first journaled rounds, well before the end
        wait_for(
            lambda: (journal_round(save_dir) or -1) >= 2,
            timeout=420, what="round 2 in the journal",
        )
        sigkill(server1)
        time.sleep(2.0)

        # the replacement: IDENTICAL argv — recovery must be zero-flag
        server2 = spawn_server(save_dir, port, archive)
        codes = drain([server2, *clients], timeout=600)
    finally:
        drain([server1, *clients], timeout=10)
    assert codes[0] == 0, "recovered server did not exit cleanly"
    assert codes[1:].count(0) == 4, f"client exit codes {codes[1:]}"

    metrics = os.path.join(save_dir, "metrics.jsonl")
    recovered = read_events(metrics, "server_recovered")
    assert recovered and recovered[-1]["source"] == "journal"
    assert recovered[-1]["round"] >= 2
    restores = {
        e["client"] for e in read_events(metrics, "session_restored")
    }
    assert len(restores) >= 3, f"only {sorted(restores)} reconnected"
    reconnects = {
        e["client"]
        for i in range(4)
        for e in read_events(
            os.path.join(str(tmp_path / f"crash_c{i + 1}"),
                         f"client{i + 1}", "metrics.jsonl"),
            "client_reconnected",
        )
    }
    assert len(reconnects) >= 3

    betas = load_server_betas(save_dir)
    assert np.isfinite(betas).all()
    assert betas.shape == baseline.shape
    # within tolerance of the no-crash baseline: topic-set similarity
    # (Bhattacharyya match per topic, max = n_topics) — robust to the
    # replayed round's extra local steps, sensitive to a wrong restore
    tss = topic_similarity_score(betas, baseline)
    assert tss >= 0.75 * baseline.shape[0], (
        f"recovered betas diverged from baseline (tss={tss:.2f} of "
        f"{baseline.shape[0]})"
    )


def _spawn_hierarchy(tmp_path, archive, tag, epochs):
    """Root + two relays (two members each) as real processes. Shard
    layout: members 1,2 → relay 1; members 3,4 → relay 2. Returns the
    processes plus the ports/dirs a respawn-with-identical-argv needs."""
    root_port = _free_port()
    root_dir = str(tmp_path / f"{tag}_root")
    os.makedirs(root_dir, exist_ok=True)
    # The root terminates the two relays, not the four members. A dead
    # relay's polls fail FAST (connection refused, not a deadline), so
    # the default 3-round probation would permanently drop the shard
    # seconds into a respawn (a fresh interpreter start-up) — a
    # 2-shard operator configures patience, the respawn stays zero-flag.
    root = spawn_server(root_dir, root_port, archive,
                                n_clients=2, num_epochs=epochs,
                                extra=["--probation_rounds", "60"])
    wait_for_port(root_port)
    relay_ports = [_free_port(), _free_port()]
    relay_dirs = [str(tmp_path / f"{tag}_r{r + 1}") for r in range(2)]
    relays = [
        spawn_relay(r + 1, relay_dirs[r], relay_ports[r],
                            root_port, archive, n_members=2)
        for r in range(2)
    ]
    for port in relay_ports:
        wait_for_port(port)
    clients = [
        spawn_client(
            cid, str(tmp_path / f"{tag}_c{cid}"),
            relay_ports[(cid - 1) // 2], archive, num_epochs=epochs,
        )
        for cid in (1, 2, 3, 4)
    ]
    topo = {
        "root_dir": root_dir, "root_port": root_port,
        "relay_dirs": relay_dirs, "relay_ports": relay_ports,
    }
    return root, relays, clients, topo


def test_relay_sigkill_shard_autorecovery(tmp_path):
    archive = str(tmp_path / "corpus.npz")
    make_archive(archive, n_nodes=4)
    # A long-epoch run, like the client-kill scenario: the respawned
    # relay pays a fresh interpreter start-up and the federation
    # must still be mid-run when the recovered shard re-forms.
    epochs = 24

    # no-crash hierarchical baseline over the same archive/seeds
    root, relays, clients, topo = _spawn_hierarchy(
        tmp_path, archive, "base", epochs
    )
    codes = drain([root, *relays, *clients], timeout=600)
    assert codes == [0] * 7, f"baseline exit codes {codes}"
    baseline = load_server_betas(topo["root_dir"])

    root, relays, clients, topo = _spawn_hierarchy(
        tmp_path, archive, "crash", epochs
    )
    victim_dir = topo["relay_dirs"][0]
    # the shard journal lives under the relay's per-node subdirectory
    victim_node_dir = os.path.join(victim_dir, "relay1")
    try:
        wait_for(
            lambda: (journal_round(victim_node_dir) or -1) >= 2,
            timeout=420, what="round 2 in relay 1's shard journal",
        )
        sigkill(relays[0])
        time.sleep(2.0)
        # the replacement: IDENTICAL argv — shard recovery is zero-flag
        relay1b = spawn_relay(
            1, victim_dir, topo["relay_ports"][0], topo["root_port"],
            archive, n_members=2,
        )
        codes = drain(
            [root, relays[1], relay1b, *clients], timeout=600
        )
    finally:
        drain([root, *relays, *clients], timeout=10)
    assert codes[0] == 0, "root did not exit cleanly"
    assert codes[1] == 0, "surviving relay did not exit cleanly"
    assert codes[2] == 0, "recovered relay did not exit cleanly"
    assert codes[3:].count(0) == 4, f"member exit codes {codes[3:]}"

    # the respawned relay announced its recovery and resumed at (or just
    # behind) the kill point; its orphaned members token-reconnected
    relay_metrics = os.path.join(victim_node_dir, "metrics.jsonl")
    recovered = read_events(relay_metrics, "relay_recovered")
    assert recovered and recovered[-1]["round"] >= 1
    assert recovered[-1]["members"] >= 2
    restores = {
        e["client"]
        for e in read_events(relay_metrics, "session_restored")
    }
    assert restores, "no member token-reconnected to the recovered relay"

    # acceptance invariants at the root: the shard bounce cost time,
    # never reference-chain integrity or double counting — and nobody
    # was re-homed (the shard came BACK; failover never engaged)
    root_metrics = os.path.join(topo["root_dir"], "metrics.jsonl")
    assert final_counter(root_metrics, "codec_ref_miss") == 0
    assert final_counter(root_metrics, "rpcs_deduplicated") == 0
    assert read_events(root_metrics, "member_rehomed") == []

    betas = load_server_betas(topo["root_dir"])
    assert np.isfinite(betas).all()
    assert betas.shape == baseline.shape
    tss = topic_similarity_score(betas, baseline)
    assert tss >= 0.75 * baseline.shape[0], (
        f"recovered-shard betas diverged from baseline (tss={tss:.2f} "
        f"of {baseline.shape[0]})"
    )


def test_client_sigkill_quorum_completes_and_dedup(tmp_path):
    archive = str(tmp_path / "corpus.npz")
    make_archive(archive, n_nodes=3)
    port = _free_port()
    save_dir = str(tmp_path / "server")
    os.makedirs(save_dir, exist_ok=True)
    extra = ["--wire_codec", "delta", "--quorum_fraction", "0.5"]
    # A longer run than the server-kill scenario: the replacement client
    # pays a fresh interpreter start-up and must still land
    # INSIDE the running federation to prove the mid-run rejoin.
    epochs = 24
    server = spawn_server(save_dir, port, archive, extra=extra,
                                  n_clients=3, num_epochs=epochs)
    wait_for_port(port)
    clients = [
        spawn_client(i + 1, str(tmp_path / f"c{i + 1}"), port,
                             archive, extra=["--wire_codec", "delta"],
                             num_epochs=epochs)
        for i in range(3)
    ]
    victim_dir = str(tmp_path / "c3_respawn")
    try:
        wait_for(
            lambda: (journal_round(save_dir) or -1) >= 2,
            timeout=420, what="round 2 in the journal",
        )
        sigkill(clients[2])  # mid-step, no goodbye
        # rounds keep completing via quorum while the seat is empty
        seen = journal_round(save_dir)
        wait_for(
            lambda: (journal_round(save_dir) or -1) >= seen + 2,
            timeout=420, what="two quorum rounds past the client kill",
        )
        # the replacement process: same identity, fresh everything
        replacement = spawn_client(3, victim_dir, port, archive,
                                           extra=["--wire_codec", "delta"],
                                           num_epochs=epochs)
        codes = drain(
            [server, clients[0], clients[1], replacement], timeout=600
        )
    finally:
        drain([server, *clients], timeout=10)
    assert codes[0] == 0, "server did not exit cleanly"
    assert codes[1] == 0 and codes[2] == 0, f"survivor codes {codes[1:3]}"
    assert codes[3] == 0, "replacement client did not exit cleanly"

    metrics = os.path.join(save_dir, "metrics.jsonl")
    # the acceptance invariants: nothing double-counted, and the delta
    # codec's reference discipline survived the churn end to end
    assert final_counter(metrics, "codec_ref_miss") == 0
    assert final_counter(metrics, "rpcs_deduplicated") == 0
    # the dead process's seat was handed over: the replacement joined as
    # a FRESH session (mint via GetGlobalSetup), not a token restore
    assert read_events(metrics, "session_restored") == []
    betas = load_server_betas(save_dir)
    assert np.isfinite(betas).all()
