"""One client over several devices, and a federation's clients over ranks:
the port's client layouts (``parallel/mesh.py``), the data-parallel
``FederatedStepper``, ``Client(mesh_devices=N)`` (``MeshStepper``), the
``FederatedTrainer`` over client ranks and ``--mesh_devices``, on the CPU
with gloo ranks, against the JAX package's layouts, mesh stepper and client
mesh trainer (on the JAX tests' forced CPU devices) and against the port's
own one-device paths.

- The layouts: the padded client count and the rank count of
  ``make_client_mesh`` are the JAX mesh's for every count of clients and
  devices; ``stack_and_pad`` is the JAX function's bit for bit; the slice
  layout refuses what the JAX one refuses; the distributed variants fall
  back to this process without a launcher's environment.
- The mesh stepper at 2 ranks keeps β within 1e-4 of the one-rank stepper
  over 6 steps (``tests/test_multichip.py:277-302``); its ``StepStatus``
  sequence, sample counts, padded schedule and snapshot layout are the JAX
  mesh stepper's, a JAX mesh snapshot sets into both ranks bitwise, and
  both ranks hold the same state bit for bit.
- The trainer over 2 ranks (3 clients, one padded) is the one-device
  trainer bit for bit, a checkpoint written on either layout resumes on the
  other to the same bits, the slice layout's FedAvg spans both axes (2 × 2
  ranks), and the final epoch loss is within 5% of the JAX trainer's on a
  two-device client mesh (the generators differ, as in
  ``tests/test_torch_slice.py``).
- ``Client(mesh_devices=2)`` over loopback gRPC: its ranks hold the same
  state; against the same federation with a one-device client every entry
  is within 1e-4 but the five whose exact gradient is zero (the biases
  under the encoder's affine-free BatchNorms, their running means, and the
  prior mean, which Adam moves by ±lr on float noise in any two reduction
  orders); under a JAX server it answers as a port client does. Its
  followers die with rank 0, idle or inside a step's collective; it runs
  beside a default process group without touching it; a follower's error
  reaches rank 0.
- The command line: ``--mesh_devices`` parses as the JAX parser's,
  ``simulate --mesh_devices 2`` writes the bits of ``--mesh_devices 1``,
  and the client role builds a mesh client.
"""

import json
import multiprocessing
import os
import shutil
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gfedntm_tpu.data.datasets import BowDataset as JBowDataset
from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
from gfedntm_tpu.federated.stepper import FederatedAVITM as JFederatedAVITM
from gfedntm_tpu.federated.trainer import FederatedTrainer as JFederatedTrainer
from gfedntm_tpu.federation.client import Client as JClient
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.parallel import mesh as jmesh
from gfedntm_tpu_torch import cli
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federated.stepper import FederatedStepper
from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.mesh_client import MeshStepper, mesh_layout
from gfedntm_tpu_torch.federation.server import FederatedServer
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.params import SHARE_ALL
from gfedntm_tpu_torch.parallel import mesh, programs
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.utils.observability import MetricsLogger

V, K, H = 60, 5, (8, 8)
#: The stepper's client: 37 documents at B=9, so 2 ranks pad each batch to 10.
STEP_KW = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=9, num_epochs=2,
               seed=3)
#: The trainer's clients: 3 over 2 ranks (one padded client), 2 epochs.
TRAIN_KW = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=8, num_epochs=2,
                seed=1)
TRAIN_SIZES = (20, 13, 17)
#: Against the JAX trainer (``tests/test_torch_slice.py``'s widths).
ENV_V, ENV_DOCS, ENVELOPE = 300, 128, 0.05
ENV_KW = dict(input_size=ENV_V, n_components=6, hidden_sizes=(17, 13), batch_size=16,
              num_epochs=2, lr=1e-2, fused_decoder=False)
#: State entries whose exact gradient is zero (Adam moves them by ±lr on the
#: float noise of any reduction order), and the running means that carry them.
DEGENERATE = ("params/inf_net/f_mu/bias", "params/inf_net/f_sigma/bias", "params/prior_mean",
              "batch_stats/inf_net/f_mu_batchnorm/running_mean",
              "batch_stats/inf_net/f_sigma_batchnorm/running_mean")
TIMEOUT_S = 300.0


def step_corpus():
    return np.random.default_rng(0).integers(0, 3, size=(37, V)).astype(np.float32)


def train_corpora(sizes=TRAIN_SIZES, v=V, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 3, size=(n, v)).astype(np.float32) for n in sizes]


def datasets_of(corpora, v=V):
    return [BowDataset(X=X, idx2token={i: f"wd{i}" for i in range(v)}) for X in corpora]


def one_device(corpora, kw=TRAIN_KW, **fit_kw):
    trainer = FederatedTrainer(AVITM(device="cpu", **kw), n_clients=len(corpora), device="cpu")
    return trainer, trainer.fit(datasets_of(corpora, kw["input_size"]), **fit_kw)


def states_of(result) -> list[dict]:
    return [{**{k: v.numpy() for k, v in p.items()}, **{k: v.numpy() for k, v in b.items()}}
            for p, b in zip(result.client_params, result.client_batch_stats)]


def assert_states_equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, (c, key)
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"client {c} {key}")


def jax_mesh_stepper(X, steps):
    j = JFederatedAVITM(JAVITM(**{k: v for k, v in STEP_KW.items()}),
                        mesh=jmesh.make_param_mesh(axis_name="data", n_devices=2))
    j.pre_fit(JBowDataset(X=X, idx2token={i: f"wd{i}" for i in range(V)}))
    statuses, samples = [], []
    for _ in range(steps):
        snap = j.train_mb_delta()
        samples.append(j._last_batch_size)
        s = j.delta_update_fit(snap)
        statuses.append((s.current_mb, s.current_epoch, s.epoch_ended, s.finished))
    meta = {k: (tuple(v.shape), str(v.dtype)) for k, v in snap.items()}
    return dict(statuses=statuses, samples=samples, meta=meta,
                shape=tuple(j._schedule.indices.shape), snapshot=j.train_mb_delta())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank program of this module, in one group of 2 ranks and one of
    4, and the one-device and JAX references they are held against."""
    root = tmp_path_factory.mktemp("client_mesh")
    X = step_corpus()
    jax_run = jax_mesh_stepper(X, 6)
    corpora = train_corpora()
    # A one-device checkpoint at step 2, for the 2-rank run to resume from.
    _, one_ckpt = one_device(corpora, checkpoint_dir=str(root / "one"), checkpoint_every=2)
    (root / "one_at_2").mkdir()
    shutil.copy(root / "one" / "step_2.pt", root / "one_at_2" / "step_2.pt")
    env_corpora = train_corpora((ENV_DOCS, ENV_DOCS), ENV_V, seed=3)

    two = [
        (programs.mesh_steps, (STEP_KW, X, 6, None, jax_run["snapshot"])),
        (programs.federated_fit, (TRAIN_KW, corpora)),
        (programs.federated_fit, (TRAIN_KW, corpora, None, {
            "checkpoint_dir": str(root / "two"), "checkpoint_every": 2})),
        (programs.federated_fit, (TRAIN_KW, corpora, None, {
            "checkpoint_dir": str(root / "one_at_2"), "resume": True})),
        (programs.federated_fit, (ENV_KW, env_corpora)),
    ]
    four = [
        (programs.federated_fit, (TRAIN_KW, train_corpora((20, 13, 17, 9)), None, None, 2)),
        (programs.federated_fit, (TRAIN_KW, train_corpora((10,) * 6), None, None, 2)),
    ]
    with ThreadPoolExecutor(2) as pool:
        f2 = pool.submit(run_ranks, programs.run_each, 2, "gloo", ["cpu"] * 2, TIMEOUT_S,
                         (two,))
        f4 = pool.submit(run_ranks, programs.run_each, 4, "gloo", ["cpu"] * 4, TIMEOUT_S,
                         (four,))
        r2, r4 = f2.result(), f4.result()

    j_trainer = JFederatedTrainer(JAVITM(**ENV_KW), n_clients=2, devices=jax.devices()[:2])
    j_env = j_trainer.fit([JBowDataset(X=X_, idx2token={i: f"wd{i}" for i in range(ENV_V)})
                           for X_ in env_corpora])
    return dict(root=root, X=X, jax=jax_run, corpora=corpora, one_ckpt=one_ckpt,
                stepper=[r[0] for r in r2], trainer=[r[1] for r in r2],
                checkpointed=[r[2] for r in r2], resumed=[r[3] for r in r2],
                env=[r[4] for r in r2], j_env=j_env,
                slices=[r[0] for r in r4], slices6=[r[1] for r in r4])


# ---- the layouts ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [1, 2, 3, 8])
@pytest.mark.parametrize("n_clients", [1, 2, 5, 9])
def test_client_layout_pads_as_the_jax_mesh(n_ranks, n_clients):
    layout, c_pad = mesh.make_client_mesh(n_clients, ranks=n_ranks)
    j_mesh, j_pad = jmesh.make_client_mesh(n_clients, jax.devices()[:n_ranks])
    assert c_pad == j_pad == layout.c_pad
    assert layout.ranks == j_mesh.devices.size
    assert c_pad % layout.ranks == 0 and c_pad >= n_clients
    blocks = [list(layout.block(r)) for r in range(layout.ranks)]
    assert sum(blocks, []) == list(range(c_pad))
    assert all(layout.owner(c) == r for r, b in enumerate(blocks) for c in b)


def test_fewer_clients_than_ranks_uses_one_rank_a_client():
    layout, c_pad = mesh.make_client_mesh(2, ranks=8)
    j_mesh, j_pad = jmesh.make_client_mesh(2, jax.devices())
    assert (layout.ranks, c_pad) == (j_mesh.devices.size, j_pad) == (2, 2)


def test_stack_and_pad_is_the_jax_function():
    arrays = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.ones((5, 4), np.float32) * 7]
    got = mesh.stack_and_pad(arrays, 4)
    want = jmesh.stack_and_pad(arrays, 4)
    assert got.dtype == want.dtype and got.shape == want.shape == (4, 5, 4)
    np.testing.assert_array_equal(got, want)
    assert got[0, 3:].sum() == 0 and got[2:].sum() == 0


def test_slice_layout_refuses_too_few_ranks():
    with pytest.raises(ValueError, match="need 4 ranks"):
        mesh.make_slice_client_mesh(2, 2, ranks=2)
    with pytest.raises(ValueError):
        jmesh.make_slice_client_mesh(2, 2, jax.devices()[:2])
    layout = mesh.make_slice_client_mesh(2, 2, ranks=4)
    assert layout.shape == (2, 2) and layout.axis_names == ("slice", "clients")


def test_distributed_slice_layout_refuses_uneven_contributions():
    """The JAX test's three refusals with hosts in place of devices."""
    with pytest.raises(ValueError, match="exactly 2 ranks"):
        mesh.distributed_slice_client_mesh(hosts=[0, 0, 0, 1], n_proc=2)
    with pytest.raises(ValueError, match="every process"):
        mesh.distributed_slice_client_mesh(hosts=[0, 0, 0, 0], n_proc=2)
    with pytest.raises(ValueError, match="divide evenly"):
        mesh.distributed_slice_client_mesh(hosts=[0, 0, 0], n_proc=2)
    with pytest.raises(ValueError, match="consecutive"):
        mesh.distributed_slice_client_mesh(hosts=[0, 1, 0, 1], n_proc=2)


def test_distributed_slice_layout_on_one_process():
    layout = mesh.distributed_slice_client_mesh()
    assert layout.shape == (1, 1) and layout.ranks == 1 and layout.rank == 0


def test_distributed_client_layout_without_an_environment(monkeypatch):
    """No launcher's environment: this process alone, and no default group
    initialized (the JAX variant falls back to the local devices)."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    layout, c_pad = mesh.distributed_client_mesh(3)
    assert (layout.ranks, c_pad, layout.rank, layout.group) == (1, 3, 0, None)
    assert not torch.distributed.is_initialized()


def test_distributed_client_layout_initializes_from_an_init_method(tmp_path):
    init = (tmp_path / "rdv").as_uri()
    try:
        layout, c_pad = mesh.distributed_client_mesh(3, init_method=init, world_size=1, rank=0)
        assert torch.distributed.is_initialized() and torch.distributed.get_world_size() == 1
        assert (layout.ranks, c_pad) == (1, 3)
    finally:
        torch.distributed.destroy_process_group()


def test_a_layout_of_several_ranks_needs_a_group():
    with pytest.raises(ValueError, match="process group"):
        FederatedTrainer(AVITM(device="cpu", **TRAIN_KW), n_clients=3, devices=2, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        FederatedTrainer(AVITM(device="cpu", **TRAIN_KW), n_clients=3, devices=1,
                         mesh=mesh.make_client_mesh(3)[0], device="cpu")


# ---- the mesh stepper ----------------------------------------------------------------------

def test_mesh_stepper_tracks_the_one_rank_stepper(ranks):
    """β within 1e-4 after every one of 6 steps (the JAX pin); the one-rank
    stepper takes the fused decode's plain version, the 2-rank one the
    unfused decode ("auto")."""
    one = FederatedStepper(AVITM(device="cpu", **STEP_KW))
    one.pre_fit(BowDataset(X=ranks["X"]))
    for beta in ranks["stepper"][0]["betas"]:
        one.delta_update_fit(one.train_mb_delta())
        assert np.abs(beta - one.model.model.beta.detach().numpy()).max() < 1e-4


def test_mesh_stepper_status_schedule_and_snapshot_are_the_jax_mesh_steppers(ranks):
    got, want = ranks["stepper"][0], ranks["jax"]
    assert got["statuses"] == want["statuses"]
    assert got["samples"] == want["samples"]
    assert got["schedule_shape"] == want["shape"] == (5, 10)
    assert got["snapshot"] == want["meta"]


def test_mesh_stepper_ranks_hold_the_same_state(ranks):
    assert ranks["stepper"][0]["digest"] == ranks["stepper"][1]["digest"]


def test_a_jax_mesh_snapshot_sets_into_both_ranks_bitwise(ranks):
    snap = ranks["jax"]["snapshot"]
    for rank in ranks["stepper"]:
        back = rank["read_back"]
        assert sorted(back) == sorted(snap)
        for key, value in snap.items():
            assert back[key].dtype == value.dtype, key
            np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_a_layout_of_one_rank_is_the_meshless_stepper():
    X = step_corpus()
    plain = FederatedStepper(AVITM(device="cpu", **STEP_KW))
    layered = FederatedStepper(AVITM(device="cpu", **STEP_KW),
                               mesh=mesh.data_layout(1, None, 0))
    assert layered.mesh is None and layered._fused == plain._fused
    for s in (plain, layered):
        s.pre_fit(BowDataset(X=X))
    for _ in range(4):
        a, b = plain.train_mb_delta(), layered.train_mb_delta()
        assert plain.loss == layered.loss
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        plain.delta_update_fit(a)
        layered.delta_update_fit(b)


def test_explicit_fused_decoder_refuses_a_layout_and_auto_resolves_unfused():
    with pytest.raises(ValueError, match="fused_decoder=True"):
        FederatedStepper(AVITM(device="cpu", fused_decoder=True, **STEP_KW),
                         mesh=mesh.data_layout(2, None, 0))
    auto = FederatedStepper(AVITM(device="cpu", **STEP_KW), mesh=mesh.data_layout(2, None, 0))
    assert auto.model.fused_decoder and not auto._fused
    assert FederatedStepper(AVITM(device="cpu", **STEP_KW))._fused


def test_jax_mesh_stepper_refuses_the_fused_decoder_too():
    j = JAVITM(**STEP_KW)
    j.module.fused_decoder = True
    from gfedntm_tpu.train.steps import build_train_step

    with pytest.raises(ValueError, match="fused"):
        build_train_step(j.module, j.tx, j.family, j._beta_weight(),
                         dshard=(jmesh.make_param_mesh(axis_name="data", n_devices=2), "data"))


# ---- the trainer over client ranks -----------------------------------------------------------

def test_trainer_over_two_ranks_is_the_one_device_trainer(ranks):
    _, want = one_device(ranks["corpora"])
    for rank in ranks["trainer"]:
        assert (rank["ranks"], rank["c_pad"], rank["mesh_devices"]) == (2, 4, 2.0)
        np.testing.assert_array_equal(rank["losses"], want.losses)
        assert rank["epoch_losses"] == want.epoch_losses
    assert ranks["trainer"][0]["digests"] == ranks["trainer"][1]["digests"]
    assert_states_equal(ranks["trainer"][0]["states"], states_of(want))


def test_checkpoints_resume_across_layouts(ranks):
    """The 2-rank run's checkpoint at step 2 resumes on one device, and the
    one-device checkpoint at step 2 resumes on 2 ranks, each to the bits of
    the uninterrupted run."""
    root = ranks["root"]
    _, want = one_device(ranks["corpora"])
    assert_states_equal(ranks["checkpointed"][0]["states"], states_of(want))
    assert_states_equal(ranks["resumed"][0]["states"], states_of(want))
    np.testing.assert_array_equal(ranks["resumed"][0]["losses"], want.losses)
    assert_states_equal(states_of(ranks["one_ckpt"]), states_of(want))
    (root / "two_at_2").mkdir(exist_ok=True)
    shutil.copy(root / "two" / "step_2.pt", root / "two_at_2" / "step_2.pt")
    _, resumed = one_device(ranks["corpora"], checkpoint_dir=str(root / "two_at_2"),
                            resume=True)
    assert_states_equal(states_of(resumed), states_of(want))
    np.testing.assert_array_equal(resumed.losses, want.losses)


@pytest.mark.parametrize("case", ["slices", "slices6"])
def test_slice_layout_fedavg_spans_both_axes(ranks, case):
    sizes = (20, 13, 17, 9) if case == "slices" else (10,) * 6
    _, want = one_device(train_corpora(sizes))
    got = ranks[case]
    assert all(r["ranks"] == 4 for r in got)
    assert got[0]["c_pad"] == (4 if case == "slices" else 8)
    assert len({json.dumps(r["digests"], sort_keys=True) for r in got}) == 1
    states = got[0]["states"]
    assert_states_equal(states, states_of(want))
    for key in ("beta", "prior_mean", "inf_net.input_layer.weight"):
        for c in range(1, len(sizes)):
            np.testing.assert_array_equal(states[c][key], states[0][key])


def test_trainer_over_ranks_final_loss_within_envelope_of_the_jax_client_mesh(ranks):
    port = np.mean([e[-1] for e in ranks["env"][0]["epoch_losses"]])
    jax_ = np.mean([e[-1] for e in ranks["j_env"].epoch_losses])
    assert abs(port - jax_) / jax_ < ENVELOPE, (port, jax_)


def test_training_over_ranks_launches_no_kernel_on_the_cpu(ranks):
    for rank in ranks["trainer"] + ranks["stepper"]:
        assert set(rank["launches"].values()) == {0}


# ---- Client(mesh_devices=N) ------------------------------------------------------------------

FED_KW = dict(n_components=4, hidden_sizes=(16, 16), batch_size=8, num_epochs=1, seed=0)


def documents(n_clients=2, docs=18, seed=0):
    """``tests/test_federation_net.py``'s corpora: 18 and 40 documents."""
    rng = np.random.default_rng(seed)
    words = [f"word{i:03d}" for i in range(90)]
    return [[" ".join(rng.choice(words[20 * c:20 * c + 60], size=25))
             for _ in range(docs + 22 * c)] for c in range(n_clients)]


def federate(tmp_path, server_side, clients, model_kw=FED_KW):
    """One federation to its end: ``clients`` is a list of ``("port", N)``
    (a port client of ``mesh_devices`` N) or ``("jax", 0)``. Returns (server,
    clients, the StepReply accounting the server saw per client)."""
    common = dict(min_clients=len(clients), family="avitm", model_kwargs=dict(model_kw),
                  max_iters=200, save_dir=str(tmp_path / "server"), wire_codec="none")
    server = JServer(**common) if server_side == "jax" else FederatedServer(device="cpu",
                                                                             **common)
    replies: dict = {}
    collect = server._collect_snapshots

    def recording(rs, *args, **kwargs):
        for rec, reply in rs:
            replies.setdefault(rec.client_id, []).append(
                (reply.current_mb, reply.current_epoch, reply.finished, reply.nr_samples))
        return collect(rs, *args, **kwargs)

    server._collect_snapshots = recording
    addr = server.start("[::]:0")
    nodes = []
    for c, ((side, n), docs) in enumerate(zip(clients, documents(len(clients)))):
        if side == "port":
            nodes.append(Client(client_id=c + 1, corpus=RawCorpus(documents=docs),
                                server_address=addr, max_features=80, device="cpu",
                                mesh_devices=n, metrics=MetricsLogger(node=f"client{c + 1}")))
        else:
            nodes.append(JClient(client_id=c + 1, corpus=JRawCorpus(documents=docs),
                                 server_address=addr, max_features=80))
    threads = [threading.Thread(target=n.run, daemon=True) for n in nodes]
    try:
        for t in threads:
            t.start()
        assert server.wait_done(timeout=TIMEOUT_S), "federated training did not finish"
        for t in threads:
            t.join(timeout=60.0)
        assert all(n.stopped.is_set() for n in nodes)
    finally:
        server.stop(grace=0.2, join_timeout=10.0)
        for n in nodes:
            n.shutdown(grace=0.2)
    return server, nodes, replies


def mesh_check(client) -> dict:
    (rec,) = [r for r in client.metrics.records
              if r.get("event") == "phase" and r.get("phase") == "mesh_ranks"]
    return rec


@pytest.fixture(scope="module")
def port_federations(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_fed")
    return (federate(root / "mesh", "port", [("port", 2), ("port", 0)]),
            federate(root / "plain", "port", [("port", 0), ("port", 0)]))


def test_mesh_client_ranks_hold_one_state(port_federations):
    (_, clients, _), _ = port_federations
    rec = mesh_check(clients[0])
    assert rec["ranks"] == 2 and rec["equal"] is True
    assert isinstance(clients[0].stepper, MeshStepper)
    assert clients[0].stepper.mesh_ranks.procs == []  # stopped at finalization
    assert clients[0].results is not None
    assert np.allclose(clients[0].results["thetas"].sum(1), 1.0)


def test_mesh_client_federation_within_1e4_of_the_one_device_federation(port_federations):
    (_, mesh_clients, mesh_replies), (_, plain_clients, plain_replies) = port_federations
    assert mesh_replies == plain_replies
    for got_client, want_client in zip(mesh_clients, plain_clients):
        got, want = got_client.stepper.get_gradients(), want_client.stepper.get_gradients()
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            if key not in DEGENERATE:
                err = np.abs(got[key].astype(np.float64) - want[key]).max()
                assert err < 1e-4, (key, err)


def test_mesh_client_under_a_jax_server(tmp_path):
    """A JAX server, a port mesh client and a JAX client: the run finishes,
    the server polls the mesh client with the accounting a JAX client
    gives, and its ranks hold one state."""
    server, clients, replies = federate(tmp_path / "mixed", "jax", [("port", 2), ("jax", 0)])
    _, _, jax_replies = federate(tmp_path / "jax", "jax", [("jax", 0), ("jax", 0)])
    assert replies == jax_replies
    assert mesh_check(clients[0])["equal"] is True
    assert np.isfinite(server.global_betas).all()


def test_mesh_layout_on_the_cpu_and_on_one_card(monkeypatch):
    assert mesh_layout(torch.device("cpu"), 3) == ("gloo", ["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_layout(torch.device("cuda:0"), 2) == ("gloo", ["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_layout(torch.device("cuda:0"), 2) == ("nccl", ["cuda:0", "cuda:1"])


def test_mesh_stepper_in_process_and_a_follower_error():
    """A MeshStepper in this process: 3 steps within 1e-4 of the one-device
    stepper, one state on both ranks; a follower that fails reaches rank 0
    as an error with its traceback."""
    X = step_corpus()
    kw = {k: v for k, v in STEP_KW.items() if k != "input_size"}
    stepper = MeshStepper(AVITM(device="cpu", **STEP_KW), 2, "avitm", V, kw,
                          grads_to_share=SHARE_ALL)
    try:
        one = FederatedStepper(AVITM(device="cpu", **STEP_KW))
        for s in (stepper, one):
            s.pre_fit(BowDataset(X=X))
        for _ in range(3):
            snap = stepper.train_mb_delta()
            stepper.delta_update_fit(snap)
            one.delta_update_fit(one.train_mb_delta())
            assert np.abs(snap["params/beta"] - one.get_gradients()["params/beta"]).max() < 1e-4
        digests = stepper.rank_digests()
        assert digests[0] == digests[1]
        stepper.mesh_ranks.send("no such command")
        deadline = time.monotonic() + 30.0
        with pytest.raises(RuntimeError, match="mesh rank 1"):
            while time.monotonic() < deadline:
                stepper.mesh_ranks.check()
                time.sleep(0.2)
    finally:
        stepper.close()
    assert stepper.mesh_ranks.procs == []


def test_mesh_client_beside_a_default_group(tmp_path):
    """A MeshStepper built in a process whose default group exists: its
    ranks hold the state of the 2-rank stepper of the ranks test, and the
    default group still answers."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    X = step_corpus()
    proc = ctx.Process(target=programs.beside_default_group, args=(
        results, (tmp_path / "rdv").as_uri(), programs.mesh_steps,
        (STEP_KW, X, 6, None, None, 2)))
    proc.start()
    try:
        kind, out, probe = results.get(timeout=TIMEOUT_S)
    finally:
        proc.join(30.0)
    assert kind == "ok", out
    assert probe == 1.0
    assert out["client_digests"][0] == out["client_digests"][1] == out["digest"]
    ref = run_ranks(programs.mesh_steps, 2, "gloo", ["cpu"] * 2, TIMEOUT_S,
                    args=(STEP_KW, X, 6))
    assert out["digest"] == ref[0]["digest"]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except (FileNotFoundError, IndexError):
        return False


@pytest.mark.parametrize("blocked", [False, True], ids=["idle", "in_a_collective"])
def test_followers_die_with_rank_0(tmp_path, blocked):
    ctx = multiprocessing.get_context("spawn")
    pid_file = str(tmp_path / "pids")
    proc = ctx.Process(target=programs.hold_mesh_client,
                       args=(pid_file, STEP_KW, step_corpus(), 3, blocked))
    proc.start()
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not os.path.exists(pid_file):
            assert proc.is_alive() and time.monotonic() < deadline
            time.sleep(0.2)
        pids = [int(p) for p in Path(pid_file).read_text().split()]
        assert len(pids) == 2 and all(_alive(p) for p in pids)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(10.0)
    deadline = time.monotonic() + 30.0
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not any(_alive(p) for p in pids)


# ---- the command line ------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--role", "client", "--id", "1", "--mesh_devices", "8"],
    ["--role", "server", "--id", "0"],
    ["--source", "x.npz", "--mesh_devices", "2"],
])
def test_mesh_devices_parses_as_the_jax_parser(argv):
    from gfedntm_tpu.cli import build_parser as j_build_parser

    assert (cli.build_parser().parse_args(argv).mesh_devices
            == j_build_parser().parse_args(argv).mesh_devices)


def test_client_role_builds_a_mesh_client(tmp_path, monkeypatch):
    """``--role client --mesh_devices 2`` builds ``Client(mesh_devices=2)``
    (which replaced the exit with code 2)."""
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus, save_reference_npz
    from gfedntm_tpu_torch.federation import client as client_mod

    archive = tmp_path / "a.npz"
    save_reference_npz(generate_synthetic_corpus(vocab_size=40, n_topics=3, n_docs=6,
                                                 n_nodes=2, seed=0), str(archive))
    seen = {}

    class Built(Exception):
        pass

    def fake(**kwargs):
        seen.update(kwargs)
        raise Built

    monkeypatch.setattr(client_mod, "Client", fake)
    with pytest.raises(Built):
        cli.main(["--id", "1", "--source", str(archive), "--mesh_devices", "2",
                  "--save_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert seen["mesh_devices"] == 2 and str(seen["device"]) == "cpu"


def test_simulate_over_two_ranks_writes_the_one_device_bits(tmp_path):
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus, save_reference_npz

    archive = tmp_path / "tiny.npz"
    save_reference_npz(generate_synthetic_corpus(
        vocab_size=60, n_topics=4, n_docs=12, nwords=(15, 25), n_nodes=2, frozen_topics=2,
        seed=0), str(archive))
    argv = ["--source", str(archive), "--num_epochs", "2", "--n_components", "4",
            "--batch_size", "8", "--device", "cpu"]
    assert cli.main(argv + ["--save_dir", str(tmp_path / "one"), "--mesh_devices", "1"]) == 0
    assert cli.main(argv + ["--save_dir", str(tmp_path / "two"), "--mesh_devices", "2"]) == 0
    for name in ("global_model.npz", "client1/model.npz", "client2/model.npz"):
        with np.load(tmp_path / "one" / name) as a, np.load(tmp_path / "two" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {key}")
    records = [json.loads(line) for line in (tmp_path / "two" / "metrics.jsonl").open()]
    gauges = [r["metrics"]["federated_mesh_devices"]["value"] for r in records
              if r["event"] == "metrics_snapshot" and "federated_mesh_devices" in r["metrics"]]
    assert gauges == [2.0]
