"""Rank programs for :func:`~gfedntm_tpu_torch.parallel.launch.run_ranks`.

Each is ``fn(rank, device, *args)``, importable by a freshly spawned
interpreter (this module imports torch, numpy and the port only), and
returns numpy arrays and plain Python values, which pickle back to the
caller. ``chip_smoke.py`` and the multi-process tests drive V-sharded
training through them:

- :func:`collective_probe` — one ``all_reduce`` of ones (optionally after a
  rank stalls), to check a group forms and to exercise timeouts;
- :func:`describe_layout` — where the rank sits in a ``dp x mp`` layout and
  who shares its groups;
- :func:`synced_batchnorm` — the data group's sum-forward/sum-backward
  collective and the synced ``MaskedBatchNorm`` on this rank's rows of full
  inputs, forward and input gradients;
- :func:`vsharded_op` — K5 and its plain version on this rank's shard of
  full inputs, forward and backward, and optionally their times;
Models are built by :func:`build_model` from keyword arguments: a CTM when
they name an ``inference_type``, else an AVITM; a corpus ``X`` is a BoW
matrix, or a dict of a CTM's ``X``, ``X_ctx`` and ``labels`` (each one an
array or a path, :func:`corpus`).

- :func:`fit` — ``fit_sharded`` of an AVITM or CTM on a ``dp x mp`` layout,
  with its first step's
  gradients (:func:`step_gradients`), launch counts, the gathered model's
  state (world rank 0's; every rank's :func:`state_digest`) and topics,
  optionally its steady ms per step, and with a validation set its
  validation losses, early-stopping outcome and, per validation, what
  :func:`replay_validation` needs to take the same validation unsharded;
- :func:`fit_each` — :func:`fit` of several models on one layout in the
  same ranks (one spawn);
- :func:`fit_data` — ``fit_data_sharded`` of an unfused AVITM or CTM over
  dp ranks, with its summary, losses, gathered state and metrics records;
- :func:`forced_steps` — the sharded gradients at given points of another
  fit's :func:`trajectory` (teacher forcing: that fit's state, batch and
  noise);
- :func:`profile_steps` — steady V-sharded training steps, timed and then
  traced with ``torch.profiler``;
- :func:`federated_fit` — ``FederatedTrainer.fit`` over a client layout of
  the group (1-D, or ``(slice, clients)``), with its launch counts, the
  gathered clients' state and every rank's digest of it;
- :func:`mesh_steps` — one client's ``FederatedStepper`` over a data layout
  of the whole group (or a mesh client's ``MeshStepper`` over ranks of its
  own), stepped and set with its own snapshot, with β after every step and
  every rank's digest.

Two programs run in a process of their own (``multiprocessing``'s
``spawn``, not :func:`run_ranks`, whose ranks are daemonic and cannot start
a mesh client's followers): :func:`beside_default_group` runs a program
beside a default group of one rank, and :func:`hold_mesh_client` holds a
mesh client's followers until its process is killed.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from gfedntm_tpu_torch.data.datasets import (
    BowDataset,
    CTMDataset,
    EpochSchedule,
    make_epoch_schedule,
)
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.ctm import CTM
from gfedntm_tpu_torch.ops import fused_decoder as fd
from gfedntm_tpu_torch.models.layers import window
from gfedntm_tpu_torch.parallel.collectives import (
    gather_by_sum,
    merge_softmax,
    sum_in_rank_order,
)
from gfedntm_tpu_torch.parallel.mesh import (
    DpMpGroups,
    data_layout,
    make_client_mesh,
    make_dp_mp_groups,
    make_slice_client_mesh,
)
from gfedntm_tpu_torch.parallel.sharded import (
    DocShard,
    fit_data_sharded,
    fit_sharded,
    gather_state_dict,
    local_network,
    vshard_of,
)
from gfedntm_tpu_torch.train.steps import (
    batch_loss,
    fused_batch_loss,
    grad_step,
    sum_gradients,
    take,
)
from gfedntm_tpu_torch.utils.observability import MetricsLogger


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_digest(state: dict) -> dict:
    """Each leaf's dtype, shape and SHA-256 of its bytes: equal digests are
    bitwise equal states. A rank sends this back in place of a full state
    that world rank 0 already sends."""
    return {key: (str(v.dtype), tuple(v.shape),
                  hashlib.sha256(np.ascontiguousarray(v).data).hexdigest())
            for key, v in state.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def corpus(X):
    """``X`` itself, or the array that ``np.save`` wrote at the path ``X``,
    mapped read-only; for a dict (a CTM corpus), the dict of each value's.
    A caller hands a large corpus to many ranks as a path: each rank then
    maps it from the host's page cache, instead of receiving a pickled copy
    through its spawn pipe, which the parent fills one rank at a time."""
    if isinstance(X, dict):
        return {key: corpus(value) for key, value in X.items()}
    if isinstance(X, (str, os.PathLike)):
        return np.load(X, mmap_mode="r")
    return X


def dataset(X, idx2token: dict | None = None) -> BowDataset:
    """The dataset of a corpus (:func:`corpus`): a ``BowDataset`` of a BoW
    matrix, or a ``CTMDataset`` of a dict with ``X``, ``X_ctx`` and
    optionally ``labels``."""
    X = corpus(X)
    if isinstance(X, dict):
        return CTMDataset(X=X["X"], X_ctx=X["X_ctx"], labels=X.get("labels"),
                          idx2token=idx2token or {})
    return BowDataset(X=X, idx2token=idx2token or {})


def build_model(device, kw: dict) -> AVITM:
    """``CTM(device=device, **kw)`` when ``kw`` names an ``inference_type``,
    else ``AVITM(device=device, **kw)``."""
    return (CTM if "inference_type" in kw else AVITM)(device=device, **kw)


def assemble(per_rank: list, dp: int, mp: int, name: str, path: str | None = "kernel"):
    """The full-size array of one :func:`vsharded_op` output from every
    rank's local one (``per_rank[r][path][name]``, or ``per_rank[r][name]``
    when ``path`` is ``None``): rows concatenate over data ranks, columns
    over model ranks, and g_beta's per-data-rank partials add up."""
    def part(r):
        return per_rank[r][path][name] if path else per_rank[r][name]

    if name in ("rl", "g_theta", "m", "l"):
        return np.concatenate([part(d * mp) for d in range(dp)])
    if name in ("mean", "var"):
        return np.concatenate([part(m) for m in range(mp)])
    return sum(np.concatenate([part(d * mp + m) for m in range(mp)], axis=1)
               for d in range(dp))


def collective_probe(rank, device, stall_rank: int = -1, stall_s: float = 0.0) -> float:
    """The world size, as the SUM of every rank's 1 (``stall_rank`` first
    sleeps ``stall_s`` seconds)."""
    if rank == stall_rank:
        time.sleep(stall_s)
    one = torch.ones(1, device=device)
    dist.all_reduce(one)
    return float(one)


def describe_layout(rank, device, dp: int, mp: int, vocab_size: int) -> dict:
    """This rank's (d, m), V slice, and the world ranks of its model and data
    groups (gathered over each group)."""
    groups = make_dp_mp_groups(dp, mp)
    me = torch.tensor(float(rank), device=device)
    cols = groups.v_slice(vocab_size)
    return {
        "data_rank": groups.data_rank, "model_rank": groups.model_rank,
        "v_slice": (cols.start, cols.stop),
        "model_members": _np(gather_by_sum(me, groups.model_group)).astype(int).tolist(),
        "data_members": _np(gather_by_sum(me, groups.data_group)).astype(int).tolist(),
    }


def synced_batchnorm(rank, device, dp: int, cases: list) -> list:
    """For each case (a whole batch ``x`` [B, F], ``mask`` [B] or ``None``,
    a cotangent ``g`` [B, F]): this rank's rows of the batch padded with
    masked rows to a multiple of dp, through a ``MaskedBatchNorm`` synced
    over the data group of a ``dp x 1`` layout; returns its output and the
    gradient of ``sum(out * g)`` on those rows, the running statistics, and
    the gradient of ``sum(w_r * S)`` for ``S`` the sum-forward/sum-backward
    of each rank's ``x`` rows' column sums (``w_r`` = rank + 1)."""
    from gfedntm_tpu_torch.models.layers import MaskedBatchNorm
    from gfedntm_tpu_torch.parallel.collectives import sum_forward_sum_backward
    from gfedntm_tpu_torch.parallel.mesh import pad_to_multiple

    groups = make_dp_mp_groups(dp, 1)
    out = []
    for case in cases:
        b, f = case["x"].shape
        b_pad = pad_to_multiple(b, dp)
        span = groups.row_slice(b_pad)

        def rows(a):
            a = np.concatenate([a, np.zeros((b_pad - len(a), *a.shape[1:]), a.dtype)])
            return torch.from_numpy(np.ascontiguousarray(a[span])).to(device)

        x = rows(case["x"]).requires_grad_(True)
        mask = None if case["mask"] is None else rows(case["mask"])
        bn = MaskedBatchNorm(f).to(device)
        bn.group = groups.data_group
        y = bn(x, mask)
        (y * rows(case["g"])).sum().backward()
        t = x.detach().clone().requires_grad_(True)
        (float(rank + 1) * sum_forward_sum_backward(t.sum(0), groups.data_group)).sum().backward()
        out.append({"span": (span.start, span.stop), "out": _np(y), "grad": _np(x.grad),
                    "running_mean": _np(bn.running_mean), "running_var": _np(bn.running_var),
                    "sum_grad": _np(t.grad)})
    return out


def vsharded_op(rank, device, dp: int, mp: int, cases: list) -> list:
    """For each case (full numpy ``theta, beta, x, run_mean, run_var, mask``,
    a row cotangent ``g``, ``training``, optionally ``storage`` (a
    ``storage_dtype``, default float32) and ``reps``): this rank's
    shard through ``prodlda_recon_loss_vsharded`` ("kernel") and its plain
    version ("plain"), forward outputs and the gradients of ``sum(rl * g)``;
    the merged softmax statistics ``m``, ``l`` of K1's shard partials (rows
    replicated over the model group only); and, with ``reps``, each one's
    forward + backward time in ms over ``reps`` calls, timed plain, kernel,
    kernel, plain."""
    groups = make_dp_mp_groups(dp, mp)
    out = []
    for case in cases:
        rows = groups.row_slice(case["theta"].shape[0])
        cols = groups.v_slice(case["beta"].shape[1])

        def put(name, *index):
            return torch.from_numpy(np.ascontiguousarray(case[name][index])).to(device)

        t = dict(theta=put("theta", rows), beta=put("beta", slice(None), cols),
                 x=put("x", rows, cols), run_mean=put("run_mean", cols),
                 run_var=put("run_var", cols), mask=put("mask", rows), g=put("g", rows))
        training = bool(case["training"])
        storage = case.get("storage", "float32")

        def run(fn, keep):
            theta = t["theta"].clone().requires_grad_(True)
            beta = t["beta"].clone().requires_grad_(True)
            rl, mean, var = fn(theta, beta, t["x"], t["run_mean"], t["run_var"], t["mask"],
                               groups=groups, training=training, storage_dtype=storage)
            (rl * t["g"]).sum().backward()
            if keep:
                return {"rl": _np(rl), "mean": _np(mean), "var": _np(var),
                        "g_theta": _np(theta.grad), "g_beta": _np(beta.grad)}
            return None

        res = {"kernel": run(fd.prodlda_recon_loss_vsharded, True),
               "plain": run(fd.prodlda_recon_loss_vsharded_reference, True)}
        if not (training and groups.data_group is not None):
            _, _, m_loc, s_loc = fd.stats(t["theta"], fd.store(t["beta"], storage), t["mask"],
                                          t["run_mean"], t["run_var"], training,
                                          storage_dtype=storage)
            m, l = merge_softmax(m_loc, s_loc, groups.model_group)
            res["m"], res["l"] = _np(m), _np(l)
        reps = int(case.get("reps", 0))
        if reps:
            times = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = (fd.prodlda_recon_loss_vsharded if name == "kernel"
                      else fd.prodlda_recon_loss_vsharded_reference)
                run(fn, False)  # warm
                dist.barrier()
                _sync(device)
                start = time.perf_counter()
                for _ in range(reps):
                    run(fn, False)
                _sync(device)
                times[name].append((time.perf_counter() - start) / reps * 1e3)
            res["ms"] = times
        out.append(res)
    return out


def _batch(model: AVITM, n_docs: int, step: int) -> tuple[np.ndarray, np.ndarray]:
    """Row indices and mask of global step ``step`` of ``model``'s epoch
    schedules, drawn from its numpy generator (a fresh model: the schedule
    its ``fit`` runs)."""
    for _ in range(step // -(-n_docs // model.batch_size) + 1):
        sched = make_epoch_schedule(n_docs, model.batch_size, model._np_rng)
    i = step % sched.steps_per_epoch
    return sched.indices[i], sched.mask[i]


def step_gradients(model: AVITM, X, groups: DpMpGroups | None = None,
                   state: dict | None = None, step: int = 0,
                   noise: np.ndarray | None = None, with_stats: bool = False):
    """Loss and every parameter's gradient of the training loss (the fused
    one for a fused model) on the batch of global step ``step`` of a fresh
    ``model``'s schedule: unsharded, or (``groups``) on the rank-local
    network and the rank's rows, the gradients summed over the data group as
    ``grad_step`` sums them and gathered to full shapes. ``X`` is a corpus
    as :func:`dataset` takes it. ``state`` (a full numpy state dict)
    replaces the model's own first, and ``noise`` [B, K] the
    reparameterization draw from its generator, so the step can be taken
    from any point of another fit's trajectory. The one-step parity check of
    the whole network: Adam would hide a gradient that is wrong by a
    constant factor, such as the model group's size. ``with_stats`` also
    returns the gathered BatchNorm buffers after the step's forward."""
    if state is not None:
        model.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                     for k, v in state.items()})
    data = dataset(X)
    indices, mask = _batch(model, len(data), step)
    sched = EpochSchedule(indices[None], mask[None])
    net, vshard, docs = model.model, None, DocShard(model._device_data(data))
    if groups is not None:
        net = local_network(model.model, groups)
        vshard = vshard_of(groups)
        docs = DocShard.place(model._host_data(data), groups,
                              lambda a: torch.as_tensor(a, device=model.device))
    net.train()
    batch, mask, rows = next(docs.steps(sched))
    eps = None if noise is None else window(torch.as_tensor(noise, device=model.device), rows)
    loss_fn = fused_batch_loss if model.fused_decoder else batch_loss
    loss = loss_fn(net, batch, mask, noise=eps, generator=model.generator, rows=rows,
                   vshard=vshard, beta_weight=model._beta_weight(),
                   data_group=docs.data_group)
    loss.backward()
    sum_gradients(net, docs.data_group)
    loss = loss.detach()
    if docs.data_group is not None:
        loss = sum_in_rank_order(loss, docs.data_group)
    grads = {name: p.grad for name, p in net.named_parameters()}
    stats = {name: b for name, b in net.named_buffers()}
    if groups is not None:
        grads = gather_state_dict(grads, groups, model.inference_type)
        stats = gather_state_dict(stats, groups, model.inference_type)
    out = (float(loss), {name: _np(g) for name, g in grads.items()})
    if with_stats:
        return (*out, {name: _np(b).copy() for name, b in stats.items()})
    return out


def trajectory(model: AVITM, X: np.ndarray, steps) -> tuple[list, list]:
    """Train a fresh ``model`` (dropout 0) on ``X`` step by step as its
    ``fit`` does — the same schedules, ``grad_step`` calls and generator
    draws — for ``max(steps) + 1`` global steps. Before each step in
    ``steps`` it records that step's index, the full state dict and the
    reparameterization noise the step then uses (drawn from the model's
    generator exactly as the network draws it). Returns the records and
    every step's loss, to hold against ``model.fit``'s ``step_losses``."""
    if model.dropout != 0:
        raise ValueError("trajectory: the recorded noise is the step's only draw with dropout 0")
    steps = sorted(set(steps))
    data = model._device_data(BowDataset(X=X))
    records, losses, step = [], [], 0
    while step <= steps[-1]:
        sched = make_epoch_schedule(len(X), model.batch_size, model._np_rng)
        for i in range(sched.steps_per_epoch):
            if step > steps[-1]:
                break
            idx = torch.as_tensor(sched.indices[i], device=model.device, dtype=torch.long)
            mask = torch.as_tensor(sched.mask[i], device=model.device, dtype=torch.float32)
            noise = None
            if step in steps:
                noise = torch.randn((len(sched.indices[i]), model.n_components),
                                    generator=model.generator, device=model.device)
                records.append({"step": step, "noise": _np(noise).copy(), "state": {
                    k: _np(v).copy() for k, v in model.model.state_dict().items()}})
            losses.append(float(grad_step(model.model, model.optimizer, take(data, idx), mask,
                                          model.fused_decoder, noise=noise,
                                          generator=model.generator)))
            step += 1
    return records, losses


def forced_steps(rank, device, dp: int, mp: int, avitm_kw: dict, X: np.ndarray,
                 records: list) -> list:
    """For each :func:`trajectory` record: the loss and gathered gradients of
    :func:`step_gradients` on this rank's V shard from the record's state,
    batch and noise (a fresh model per record). ``X`` as in :func:`corpus`."""
    groups = make_dp_mp_groups(dp, mp)
    X = corpus(X)
    return [step_gradients(AVITM(device=device, **avitm_kw), X, groups, state=r["state"],
                           step=r["step"], noise=r["noise"]) for r in records]


def fit(rank, device, dp: int, mp: int, avitm_kw: dict, X, init_state: dict | None = None,
        n_samples: int = 3, timing_steps: int = 0, X_val=None,
        save_dir: str | None = None, patience: int = 5, delta: float = 0.0,
        first_noise: np.ndarray | None = None) -> dict:
    """``fit_sharded`` of ``build_model(device, avitm_kw)`` on ``X`` (from
    ``init_state``, a full numpy state dict, when given), with the launch
    counters set to 0 just before and read just after. Returns the first
    step's loss and gradients on an identical model (``first_step``, the
    same on every rank, so only world rank 0 sends it back and the others
    return ``None``; its reparameterization draw is ``first_noise`` [B, K]
    when given), the
    launch counts (``launches``, ``eval_launches`` of them in eval mode, and
    ``rows_calls`` of K5's rows-sharded branch),
    epoch and step losses, the gathered model's state dict (``state``, world
    rank 0's only, ``None`` elsewhere) and every rank's
    :func:`state_digest` of it (``state_digest``), the rank-local network's
    shapes, ``get_topics(10)`` and the training documents' topic
    mixtures (``n_samples`` draws); then, with ``timing_steps``, the steady
    wall ms per step of ``fit_sharded``'s step and the bytes per step of its
    data-group collectives (``step_ms``, ``step_bytes``; :func:`_step_loop`).

    With ``X_val`` the fit validates every epoch (``save_dir``,
    ``patience``, ``delta`` as in ``fit_sharded``) and also returns its
    validation losses, last epoch run, and per validation a record of the
    gathered state, the generator state and the schedule it validated with
    (``validations``, for :func:`replay_validation`; world rank 0's only).

    ``X`` and ``X_val`` as in :func:`dataset`. ``entered_at`` and
    ``left_at`` are the host's ``time.time()`` when the rank entered and
    left, and ``seconds`` the wall seconds of the set-up (groups, corpus),
    the first step, the fit and the timed steps with the result's
    assembly (``setup``, ``first_step``, ``fit``, ``timing``), each ended
    by a device sync."""
    entered_at = clock = time.time()
    seconds = {}

    def lap(name):
        nonlocal clock
        _sync(device)
        seconds[name] = time.time() - clock
        clock = time.time()

    groups = make_dp_mp_groups(dp, mp)
    X, X_val = corpus(X), corpus(X_val)
    lap("setup")

    data = dataset(X, {i: f"wd{i}" for i in range(avitm_kw["input_size"])})

    def build(**over):
        model = build_model(device, {**avitm_kw, **over})
        if init_state is not None:
            model.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                         for k, v in init_state.items()})
        return model

    first_step = step_gradients(build(), X, groups, noise=first_noise)
    lap("first_step")
    model = build()
    validation, validations = None, []
    if X_val is not None:
        validation = dataset(X_val)
        validate = model._validation_loss

        def recording(net, x_val, vsched, vshard=None):
            record = {
                "state": {k: _np(v).copy() for k, v in
                          gather_state_dict(net.state_dict(), groups,
                                            model.inference_type).items()},
                "generator": _np(model.generator.get_state()),
                "indices": vsched.indices, "mask": vsched.mask,
            }
            record["val_loss"] = validate(net, x_val, vsched, vshard)
            validations.append(record)
            return record["val_loss"]

        model._validation_loss = recording
    fd.reset_launches()
    net = fit_sharded(model, data, groups, validation, save_dir, patience, delta,
                      n_samples=n_samples, device=device)
    lap("fit")
    state = {k: _np(v) for k, v in model.model.state_dict().items()}
    result = {
        "first_step": first_step if groups.is_root else None,
        "launches": dict(fd.LAUNCHES),
        "eval_launches": dict(fd.EVAL_LAUNCHES),
        "rows_calls": dict(fd.ROWS_CALLS),
        "epoch_losses": list(model.epoch_losses),
        "step_losses": list(model.step_losses),
        "state": state if groups.is_root else None,
        "state_digest": state_digest(state),
        "local_shapes": {k: tuple(v.shape) for k, v in net.state_dict().items()},
        "topics": model.get_topics(10),
        "theta": model.training_doc_topic_distributions,
    }
    if X_val is not None:
        result.update(validation_losses=list(model.validation_losses),
                      last_epoch=model.nn_epoch,
                      validations=validations if groups.is_root else None)
    if timing_steps:
        result["step_ms"], result["step_bytes"] = _step_loop(build(), X, groups)[1](
            timing_steps)
    lap("timing")
    result.update(entered_at=entered_at, left_at=time.time(), seconds=seconds)
    return result


def fit_each(rank, device, dp: int, mp: int, runs: list) -> list:
    """:func:`fit` of each tuple of its arguments after ``mp`` in ``runs``,
    one after the other in the same ranks, each with its own counters."""
    return [fit(rank, device, dp, mp, *args) for args in runs]


def run_each(rank, device, calls: list) -> list:
    """``fn(rank, device, *args)`` of each ``(fn, args)`` in ``calls``, one
    after the other in the same ranks: several programs at one layout pay
    for one rank group's start-up and teardown."""
    return [fn(rank, device, *args) for fn, args in calls]


def replay_validation(model: AVITM, X_val, record: dict) -> float:
    """The validation loss that an unsharded ``model.fit`` takes from one of
    :func:`fit`'s ``validations``: the record's state loaded into ``model``,
    its generator set to the record's state (so the reparameterization
    noise is the same draw) and the same schedule, through the unfused
    eval decode. ``X_val`` as in :func:`dataset`."""
    model.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                 for k, v in record["state"].items()})
    model.generator.set_state(torch.from_numpy(record["generator"]))
    model.validation_data = dataset(X_val)
    return model._validation_loss(model.model,
                                  DocShard(model._device_data(model.validation_data)),
                                  EpochSchedule(record["indices"], record["mask"]))


def fit_data(rank, device, dp: int, avitm_kw: dict, X, init_state: dict | None = None,
             n_samples: int = 3, X_val=None, save_dir: str | None = None,
             patience: int = 5, delta: float = 0.0, timing_steps: int = 0) -> dict:
    """``fit_data_sharded`` of an unfused ``build_model(device, avitm_kw)``
    over ``dp`` ranks (from ``init_state`` when given), with a validating
    ``MetricsLogger``. Returns the first step's loss and gradients on an
    identical model (``first_step``, world rank 0's only, as in
    :func:`fit`), the summary, epoch, step and validation
    losses, the last epoch run, the gathered state, the metrics records and
    the registry's snapshot; with ``timing_steps``, the steady wall ms per
    step of its step (:func:`_step_loop`) and the bytes per step of its
    batch gather and gradient sum. ``X`` and ``X_val`` as in
    :func:`dataset`."""
    groups = make_dp_mp_groups(dp, 1)
    X, X_val = corpus(X), corpus(X_val)

    def build():
        model = build_model(device, avitm_kw)
        if init_state is not None:
            model.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                         for k, v in init_state.items()})
        return model

    first_step = step_gradients(build(), X, groups)
    model = build()
    metrics = MetricsLogger(validate=True)
    data = dataset(X, {i: f"wd{i}" for i in range(avitm_kw["input_size"])})
    validation = None if X_val is None else dataset(X_val)
    summary = fit_data_sharded(model, data, groups, validation, metrics, save_dir, patience,
                               delta, n_samples, device)
    result = {
        "first_step": first_step if groups.is_root else None,
        "summary": summary,
        "epoch_losses": list(model.epoch_losses),
        "step_losses": list(model.step_losses),
        "validation_losses": list(model.validation_losses),
        "last_epoch": model.nn_epoch,
        "state": {k: _np(v) for k, v in model.model.state_dict().items()},
        "records": metrics.records,
        "snapshot": metrics.registry.snapshot(),
    }
    if timing_steps:
        result["step_ms"], result["step_bytes"] = _step_loop(build(), X, groups)[1](
            timing_steps)
    return result


def _step_loop(model: AVITM, X, groups: DpMpGroups):
    """The sharded fits' training step on this rank's network and corpus
    block, on the first epoch's batches of ``X`` (repeated), each batch
    gathered from the document blocks as in the fit: ``run(steps)`` takes
    ``steps`` of them and syncs the device; ``wall_ms(steps)`` warms up with
    ``run(steps)``, then times ``run(steps)`` between barriers and returns
    the wall ms per step and the bytes per step that the batch gather and
    the gradient sum put through the data group's ``all_reduce``. Set-up
    (copies of the network, the corpus upload, the state gather) is outside
    both."""
    device = model.device
    net = local_network(model.model, groups)
    optimizer = model.build_optimizer(net)
    data = dataset(X)
    docs = DocShard.place(model._host_data(data), groups,
                          lambda a: torch.as_tensor(a, device=device))
    sched = make_epoch_schedule(len(data), model.batch_size, model._np_rng)
    vshard = vshard_of(groups)

    def run(steps):
        done = 0
        while done < steps:
            for batch, mask, rows in docs.steps(sched):
                if done == steps:
                    break
                grad_step(net, optimizer, batch, mask, model.fused_decoder,
                          generator=model.generator, vshard=vshard, rows=rows,
                          data_group=docs.data_group, beta_weight=model._beta_weight())
                done += 1
        _sync(device)

    def wall_ms(steps):
        run(steps)  # warm
        dist.barrier()
        start = time.perf_counter()
        run(steps)
        dist.barrier()
        grad_bytes = 0
        if docs.data_group is not None:
            n_params = sum(p.numel() for p in net.parameters())
            grad_bytes = groups.dp * n_params * 4  # the gathered [dp, n] buffer
        bytes_per_step = {"batch_gather": docs.gather_bytes(model.batch_size),
                          "gradient_sum": grad_bytes}
        return (time.perf_counter() - start) / steps * 1e3, bytes_per_step

    return run, wall_ms


def profile_steps(rank, device, mp: int, avitm_kw: dict, X: np.ndarray,
                  steps: int) -> dict:
    """``steps`` V-sharded training steps (:func:`_step_loop`): the
    unprofiled wall ms per step between barriers, then the device ms per
    step by kernel group and the top device events of the same steps under
    ``torch.profiler``. ``X`` as in :func:`corpus`."""
    from torch.profiler import ProfilerActivity, profile

    from gfedntm_tpu_torch.profile_step import GROUPS, device_times

    run, step_ms = _step_loop(AVITM(device=device, **avitm_kw), corpus(X),
                              make_dp_mp_groups(1, mp))
    wall_ms = step_ms(steps)[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
    # No upload happens in these steps: host-device copies are gloo's
    # staging of the collectives.
    by_group, top = device_times(prof, steps, GROUPS[:-1] + (("collective copies",
                                                              ("memcpy",)),))
    device_ms = sum(by_group.values())
    return {
        "rank": rank, "steps": steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
        "ms_per_step_by_group": by_group, "top_device_events": top,
    }


def federated_fit(rank, device, avitm_kw: dict, corpora: list, trainer_kw: dict | None = None,
                  fit_kw: dict | None = None, slices: int = 0, metrics_path: str | None = None,
                  profile_dir: str | None = None) -> dict:
    """``FederatedTrainer(build_model(device, avitm_kw), mesh=layout).fit``
    of one client per corpus (:func:`dataset`) over the group: the 1-D
    client layout of every rank, or with ``slices`` the ``(slice, clients)``
    layout of ``slices`` rows. ``trainer_kw`` and ``fit_kw`` go to the
    trainer and to ``fit`` (``checkpoint_dir``, ``checkpoint_every``,
    ``resume``). World rank 0 logs the trainer's records into
    ``metrics_path`` (node ``simulate``, as the command line's) and, with
    ``profile_dir``, traces the fit there. Returns the losses, epoch
    losses, steps per epoch, sample counts, launch counts, the
    ``federated_mesh_devices`` gauge, the layout's ranks and padded count,
    every rank's :func:`state_digest` of every client and world rank 0's
    states (numpy; ``None`` elsewhere)."""
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.utils.observability import trace

    world = dist.get_world_size()
    if slices:
        layout = make_slice_client_mesh(slices, world // slices)
    else:
        layout, _ = make_client_mesh(len(corpora))
    datasets = [dataset(X, {i: f"wd{i}" for i in range(avitm_kw["input_size"])})
                for X in corpora]
    template = build_model(device, avitm_kw)
    metrics = MetricsLogger(metrics_path if rank == 0 else None, node="simulate")
    trainer = FederatedTrainer(template, n_clients=len(datasets), mesh=layout, device=device,
                               **(trainer_kw or {}))
    fd.reset_launches()
    if trainer.layout is not None and trainer.layout.rank < 0:
        return {"rank": -1, "launches": dict(fd.LAUNCHES)}
    with trace(profile_dir if rank == 0 else None, device):
        res = trainer.fit(datasets, metrics=metrics, **(fit_kw or {}))
    _sync(device)
    metrics.close()
    states = [{**{k: _np(v) for k, v in p.items()}, **{k: _np(v) for k, v in b.items()}}
              for p, b in zip(res.client_params, res.client_batch_stats)]
    return {
        "rank": rank,
        "ranks": 1 if trainer.layout is None else trainer.layout.ranks,
        "c_pad": trainer.c_pad,
        "losses": res.losses,
        "epoch_losses": res.epoch_losses,
        "steps_per_epoch": res.steps_per_epoch,
        "n_samples": res.n_samples,
        "launches": dict(fd.LAUNCHES),
        "mesh_devices": metrics.registry.snapshot()["federated_mesh_devices"]["value"],
        "digests": [state_digest(st) for st in states],
        "states": states if rank == 0 else None,
    }


def mesh_steps(rank, device, avitm_kw: dict, X, steps: int,
               init_state: dict | None = None, set_snapshot: dict | None = None,
               client_ranks: int = 0) -> dict:
    """One client's ``FederatedStepper`` over a data layout of every rank of
    the group (or, with ``client_ranks``, a mesh client's ``MeshStepper``
    over that many ranks of its own, built in this process beside its
    default group): ``pre_fit`` on the corpus ``X`` (:func:`dataset`), then
    ``steps`` exchanged steps, each set with its own snapshot
    (``delta_update_fit``); with ``set_snapshot``, one more step set with
    that snapshot instead, and this rank's snapshot read back. Returns the
    padded schedule's shape, the statuses, sample counts, losses, β after
    every step (world rank 0's), the snapshot's keys, shapes and dtypes,
    the launch counts, every rank's digest of the final state (a mesh
    client's: every one of its ranks', from ``rank_digests``) and the read
    back snapshot."""
    from gfedntm_tpu_torch.federated.stepper import FederatedStepper

    world = dist.get_world_size()
    model = build_model(device, avitm_kw)
    if init_state is not None:
        model.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                     for k, v in init_state.items()})
    if client_ranks:
        from gfedntm_tpu_torch.federation.mesh_client import MeshStepper
        from gfedntm_tpu_torch.models.params import SHARE_ALL

        kw = {k: v for k, v in avitm_kw.items() if k != "input_size"}
        stepper = MeshStepper(model, client_ranks, model.family, model.input_size, kw,
                              grads_to_share=SHARE_ALL)
    else:
        stepper = FederatedStepper(model, mesh=data_layout(world, dist.group.WORLD, rank))
    stepper.pre_fit(dataset(X, {i: f"wd{i}" for i in range(avitm_kw["input_size"])}))
    fd.reset_launches()
    statuses, samples, losses, betas, snap_meta = [], [], [], [], None
    for _ in range(steps):
        snap = stepper.train_mb_delta()
        snap_meta = {k: (tuple(v.shape), str(v.dtype)) for k, v in snap.items()}
        losses.append(stepper.loss)
        samples.append(stepper._last_batch_size)
        status = stepper.delta_update_fit(snap)
        statuses.append((status.current_mb, status.current_epoch, status.epoch_ended,
                         status.finished))
        if rank == 0:
            betas.append(_np(model.model.beta).copy())
    read_back = None
    if set_snapshot is not None:
        stepper.train_mb_delta()
        stepper.delta_update_fit(set_snapshot)
        read_back = stepper.get_gradients()
    _sync(device)
    state = {k: _np(v) for k, v in model.model.state_dict().items()}
    digests = None
    if client_ranks:
        digests = stepper.rank_digests()
        stepper.close()
    return {
        "schedule_shape": tuple(stepper._schedule.indices.shape),
        "statuses": statuses, "samples": samples, "losses": losses,
        "betas": betas, "snapshot": snap_meta, "launches": dict(fd.LAUNCHES),
        "digest": state_digest(state), "state": state if rank == 0 else None,
        "client_digests": digests, "read_back": read_back,
    }


def beside_default_group(results, init_method: str, fn, args: tuple) -> None:
    """Put ``fn(0, cpu, *args)`` on ``results``, run in a process that first
    initializes a default group of one rank at ``init_method``: a rank of
    a job whose own collectives must not be disturbed. Start it in a
    non-daemonic process (a mesh client's ``fn`` starts processes of its
    own); an error is put as ``("error", traceback)``."""
    import traceback

    try:
        dist.init_process_group("gloo", init_method=init_method, world_size=1, rank=0)
        try:
            out = fn(0, torch.device("cpu"), *args)
            probe = torch.ones(1)
            dist.all_reduce(probe)  # the default group still works
            results.put(("ok", out, float(probe)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the caller, which raises it
        results.put(("error", traceback.format_exc(), None))


def hold_mesh_client(pid_file: str, avitm_kw: dict, X, ranks: int, blocked: bool) -> None:
    """Build a mesh client's ``MeshStepper`` over ``ranks`` ranks on the CPU,
    take one step, write its followers' pids to ``pid_file`` and wait to be
    killed; with ``blocked``, the followers are first sent into a step that
    this rank never joins, so they wait inside its collective."""
    from gfedntm_tpu_torch.federation.mesh_client import MeshStepper
    from gfedntm_tpu_torch.models.params import SHARE_ALL

    model = build_model(torch.device("cpu"), avitm_kw)
    kw = {k: v for k, v in avitm_kw.items() if k != "input_size"}
    stepper = MeshStepper(model, ranks, model.family, model.input_size, kw,
                          grads_to_share=SHARE_ALL)
    stepper.pre_fit(dataset(X))
    stepper.train_mb_delta()
    stepper.advance_local()
    if blocked:
        stepper.mesh_ranks.send("train")
    tmp = pid_file + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(" ".join(str(p.pid) for p in stepper.mesh_ranks.procs))
    os.replace(tmp, pid_file)
    while True:
        time.sleep(60.0)
