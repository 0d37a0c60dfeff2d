"""Federated checkpoint/resume, metrics and the segment callback on the CPU,
and the checkpoint and telemetry copies against the JAX package.

- a ``FederatedTrainer.fit`` checkpointed every few steps, interrupted by
  its ``segment_callback`` and resumed in a fresh trainer repeats the
  uninterrupted run bit for bit (losses and every client's state), at
  ``local_steps`` 1 and 3 and in bf16 compute, as the JAX package's resume
  does (``tests/test_checkpoint.py:39``, ``:133``); so does a run resumed
  complete, and a checkpointed run that is not interrupted;
- the callback fires once per segment with the absolute step and copies of
  the clients' state;
- the records of a metrics run pass the JAX package's ``validate_record``,
  and its ``summarize_metrics`` reads their phases, step-time histogram and
  gauges; the schema table and the registry are the JAX package's;
- ``CheckpointManager`` keeps the newest three steps, reads back with
  ``weights_only=True``, restores onto a target's devices after checking
  its structure, refuses to overwrite a step; an atomic write that fails
  before its rename leaves the previous file whole and no staging file;
  the integrity errors of a sidecar are the JAX package's.
"""

import json
import os

import numpy as np
import pytest
import torch

from gfedntm_tpu.train import checkpoint as jckpt
from gfedntm_tpu.utils import observability as jobs
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.train import checkpoint as tckpt
from gfedntm_tpu_torch.utils import observability as tobs

V, C = 32, 2


def datasets():
    rng = np.random.default_rng(3)
    return [BowDataset(X=rng.integers(0, 3, size=(12, V)).astype(np.float32),
                       idx2token={i: f"wd{i}" for i in range(V)}) for _ in range(C)]


def trainer(local_steps=1, compute_dtype="float32"):
    # 2 clients x 12 docs, B=8: 2 steps per epoch, 4 epochs = 8 global steps.
    template = AVITM(input_size=V, n_components=4, hidden_sizes=(8, 8), batch_size=8,
                     num_epochs=4, seed=0, device="cpu", compute_dtype=compute_dtype)
    return FederatedTrainer(template, n_clients=C, seed=1, local_steps=local_steps,
                            device="cpu")


def assert_same_run(got, want):
    np.testing.assert_array_equal(got.losses, want.losses)
    assert got.epoch_losses == want.epoch_losses
    for tree in ("client_params", "client_batch_stats"):
        for g, w in zip(getattr(got, tree), getattr(want, tree)):
            assert g.keys() == w.keys()
            for key in w:
                assert torch.equal(g[key], w[key]), (tree, key)
    for key in want.global_params:
        assert torch.equal(got.global_params[key], want.global_params[key]), key


class Interrupt(Exception):
    pass


class Opaque:
    """Not a tensor, number, string or plain container."""


@pytest.mark.parametrize("local_steps,seg,compute_dtype",
                         [(1, 3, "float32"), (3, 4, "float32"), (3, 5, "float32"),
                          (1, 4, "bfloat16")])
def test_resume_repeats_the_uninterrupted_run_bitwise(tmp_path, local_steps, seg,
                                                      compute_dtype):
    data = datasets()
    full = trainer(local_steps, compute_dtype).fit(data)
    ckpt = str(tmp_path / "ckpt")
    calls = []

    def interrupt_at_second_segment(step, params, batch_stats):
        calls.append(step)
        if len(calls) == 2:
            raise Interrupt

    with pytest.raises(Interrupt):
        trainer(local_steps, compute_dtype).fit(
            data, checkpoint_dir=ckpt, checkpoint_every=seg,
            segment_callback=interrupt_at_second_segment)
    assert calls == [seg, min(2 * seg, 8)]
    assert tckpt.CheckpointManager(ckpt).all_steps() == [seg]

    logger = tobs.MetricsLogger()
    resumed = trainer(local_steps, compute_dtype).fit(
        data, checkpoint_dir=ckpt, checkpoint_every=seg, resume=True, metrics=logger)
    assert [r["step"] for r in logger.events("resume")] == [seg]
    assert_same_run(resumed, full)
    assert tckpt.CheckpointManager(ckpt).latest_step() == 8

    # Resumed complete: nothing runs, nothing is saved again.
    again = trainer(local_steps, compute_dtype).fit(
        data, checkpoint_dir=ckpt, checkpoint_every=seg, resume=True)
    assert_same_run(again, full)


def test_checkpointed_run_equals_the_plain_run(tmp_path):
    data = datasets()
    full = trainer().fit(data)
    checkpointed = trainer().fit(data, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert_same_run(checkpointed, full)
    manager = tckpt.CheckpointManager(str(tmp_path))
    assert manager.all_steps() == [4, 6, 8]  # max_to_keep=3
    state = manager.restore()
    assert state["step"] == 8 and len(state["models"]) == C
    np.testing.assert_array_equal(state["losses"].numpy(), full.losses)
    assert state["generator"].dtype == torch.uint8


def test_segment_callback_gets_absolute_steps_and_copies():
    seen = []

    def callback(step, params, batch_stats):
        seen.append((step, params, batch_stats))

    result = trainer().fit(datasets(), checkpoint_every=3, segment_callback=callback)
    assert [s for s, _, _ in seen] == [3, 6, 8]
    step, params, batch_stats = seen[-1]
    assert len(params) == len(batch_stats) == C
    for c in range(C):
        assert params[c].keys() == result.client_params[c].keys()
        for key, value in params[c].items():
            assert torch.equal(value, result.client_params[c][key])
        for key, value in batch_stats[c].items():
            assert torch.equal(value, result.client_batch_stats[c][key])
    # Copies: the first segment's beta is not the final one.
    assert not torch.equal(seen[0][1][0]["beta"], params[0]["beta"])


def test_metrics_records_pass_the_jax_schema_and_summary(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    with tobs.MetricsLogger(path, validate=True, node="trainer") as logger:
        trainer().fit(datasets(), checkpoint_every=2, metrics=logger)
    records = tobs.read_metrics(path)
    assert records == jobs.read_metrics(path)
    for record in records:
        jobs.validate_record(record)
    events = [r["event"] for r in records]
    assert events.count("federated_segment") == 4
    assert [r["step"] for r in records if r["event"] == "federated_segment"] == [2, 4, 6, 8]
    summary = jobs.summarize_metrics(records)
    assert set(summary["phases"]) == {"build_schedules", "stage_data", "program_segment"}
    assert summary["phases"]["program_segment"]["count"] == 4
    # The first segment of a length stays out of the step-time histogram.
    assert summary["step_time"]["trainer_step_s"]["count"] == 3
    gauges = summary["gauges"]
    assert gauges["federated_mesh_devices"] == 1.0
    assert gauges["docs_per_s"] > 0 and gauges["docs_per_s_per_device"] == gauges["docs_per_s"]
    assert records[-1]["event"] == "metrics_snapshot" and records[-1]["step"] == 8


def test_observability_copies_match_jax():
    assert tobs.EVENT_SCHEMAS == jobs.EVENT_SCHEMAS
    assert tobs.DEFAULT_TIME_BUCKETS_S == jobs.DEFAULT_TIME_BUCKETS_S
    assert tobs.DEFAULT_BYTE_BUCKETS == jobs.DEFAULT_BYTE_BUCKETS
    rng = np.random.default_rng(0)
    values = rng.exponential(0.05, size=200).tolist() + [0.0001, 1000.0]
    regs = []
    for mod in (tobs, jobs):
        reg = mod.MetricRegistry()
        for v in values:
            reg.histogram("step_s").observe(v)
        reg.counter("n").inc(3)
        reg.gauge("g").set(2.5)
        regs.append(reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert regs[0].histogram("step_s").quantile(q) == regs[1].histogram("step_s").quantile(q)
    for bad in ({"event": "phase", "time": 1.0}, {"event": "nope", "time": 1.0}, {"time": 1.0}):
        with pytest.raises(ValueError):
            tobs.validate_record(bad)
        with pytest.raises(ValueError):
            jobs.validate_record(bad)


def current_span_walk(mod) -> list:
    """``mod.current_span()``'s name (or None) outside any span, inside two
    nested spans, after the inner one exits, after both, and on a second
    thread while the first is inside a span, before and inside its own."""
    import threading

    logger = mod.MetricsLogger(keep_records=True)
    name = lambda: getattr(mod.current_span(), "name", None)  # noqa: E731
    seen = [name()]
    with mod.span(logger, "round"):
        seen.append(name())
        with mod.span(logger, "poll"):
            seen.append(name())
            other = []

            def thread():
                other.append(name())
                with mod.span(logger, "serve"):
                    other.append(name())
                other.append(name())

            t = threading.Thread(target=thread)
            t.start()
            t.join()
            seen.append(name())
        seen.append(name())
    seen.append(name())
    assert mod.span(None, "nothing") is not None and name() is None
    return seen + other


def test_current_span_is_the_jax_ones():
    want = current_span_walk(jobs)
    assert want == [None, "round", "poll", "poll", "round", None, None, "serve", None]
    assert current_span_walk(tobs) == want


def test_phase_timer_and_events():
    logger = tobs.MetricsLogger()
    with tobs.phase_timer(logger, "stage_data", steps=3):
        pass
    (record,) = logger.events("phase")
    assert record["phase"] == "stage_data" and record["steps"] == 3 and record["seconds"] >= 0
    jobs.validate_record(record)
    with pytest.raises(RuntimeError, match="keep_records"):
        tobs.MetricsLogger(path=os.devnull).events("phase")


def test_manager_keeps_three_and_refuses_to_overwrite(tmp_path):
    manager = tckpt.CheckpointManager(str(tmp_path))
    for step in (1, 2, 3, 5):
        manager.save(step, {"w": torch.full((2,), float(step))})
    assert manager.all_steps() == [2, 3, 5] and manager.latest_step() == 5
    assert torch.equal(manager.restore(step=3)["w"], torch.full((2,), 3.0))
    with pytest.raises(FileExistsError):
        manager.save(5, {"w": torch.zeros(2)}, force=True)
    assert sorted(os.listdir(tmp_path)) == ["step_2.pt", "step_3.pt", "step_5.pt"]
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore()


def test_restore_checks_the_target_and_loads_weights_only(tmp_path):
    manager = tckpt.CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(3.0), "nested": {"b": [torch.ones(2, 2), 4]}, "s": "x"}
    manager.save(1, state)
    got = manager.restore({"a": torch.zeros(3), "nested": {"b": [torch.zeros(2, 2), 0]},
                           "s": ""})
    assert torch.equal(got["a"], state["a"]) and got["nested"]["b"][1] == 4 and got["s"] == "x"
    with pytest.raises(tckpt.CheckpointIntegrityError, match="a"):
        manager.restore({"a": torch.zeros(4), "nested": {"b": [torch.zeros(2, 2), 0]},
                         "s": ""})
    with pytest.raises(tckpt.CheckpointIntegrityError, match="keys"):
        manager.restore({"a": torch.zeros(3)})
    manager.save(2, {"obj": Opaque()})
    with pytest.raises(Exception, match="[Ww]eights only"):
        manager.restore(step=2)


def test_atomic_write_survives_a_failure_before_the_rename(tmp_path, monkeypatch):
    path = str(tmp_path / "state.json")
    tckpt.atomic_write_json(path, {"round": 1})

    def broken_replace(src, dst):
        raise OSError("injected failure before the rename")

    monkeypatch.setattr(tckpt.os, "replace", broken_replace)
    with pytest.raises(OSError, match="injected"):
        tckpt.atomic_write_json(path, {"round": 2})
    with pytest.raises(OSError, match="injected"):
        tckpt.CheckpointManager(str(tmp_path / "ck")).save(1, {"w": torch.ones(1)})
    monkeypatch.undo()
    assert json.load(open(path)) == {"round": 1}
    assert sorted(os.listdir(tmp_path)) == ["ck", "state.json"]
    assert os.listdir(tmp_path / "ck") == []


def test_atomic_write_bytes_matches_jax(tmp_path):
    for mod, name in ((jckpt, "jax.json"), (tckpt, "port.json")):
        mod.atomic_write_json(str(tmp_path / name), {"round": 3, "average_keys": ["beta"]})
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()


@pytest.mark.parametrize("content,match", [("{not json", "truncated or corrupt"),
                                           ('{"round": 1}', "missing required keys")])
def test_sidecar_integrity_errors_match_jax(tmp_path, content, match):
    path = tmp_path / "meta.json"
    path.write_text(content)
    errors = []
    for mod in (tckpt, jckpt):
        with pytest.raises(mod.CheckpointIntegrityError, match=match) as info:
            mod._load_sidecar_meta(str(path), "sidecar", "rerun")
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert tckpt._load_sidecar_meta(str(tmp_path / "absent.json"), "sidecar", "rerun") is None
