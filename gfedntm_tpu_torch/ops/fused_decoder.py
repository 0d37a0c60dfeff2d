"""Fused ProdLDA decode + reconstruction loss: CUDA kernels and their plain
PyTorch versions.

Counterpart of ``gfedntm_tpu/ops/fused_decoder.py``. Per batch::

    z  = theta @ beta                       # [B, V]
    n  = batchnorm(z, affine=False)         # masked per-column batch stats
    p  = softmax(n, axis=V)
    rl = -sum(x_bow * log(p + 1e-10), axis=V)

without any [B, V] intermediate in device memory. Three hand-written CUDA
kernels (``csrc/fused_decoder.cu``) replace the JAX package's three Pallas
TPU kernels:

==========  ===========================  ==================================
wrapper     CUDA kernel                  TPU kernel replaced
==========  ===========================  ==================================
``stats``   ``stats_kernel`` + merge     ``_stats_kernel`` (:189-260)
``loss``    ``loss_kernel`` + sum        ``_loss_kernel`` (:266-317)
``grads``   ``grads_kernel`` + sum       ``_grads_kernel`` (:612-676)
==========  ===========================  ==================================

Each wrapper takes unpadded contiguous float32 tensors. On a CUDA tensor it
launches its kernel (and counts the launch in :data:`LAUNCHES`) or raises;
on a CPU tensor it runs its plain version (``stats_reference``,
``loss_reference``, ``grads_reference``), which repeats the kernel's
arithmetic. There is no fallback from the kernel to the plain version.

``storage_dtype="bfloat16"`` (the JAX package's bf16 storage, ``_pad_core``
:459-481) takes beta and x as bf16 and runs the kernels' bf16
instantiations: all math stays float32, only beta and x are stored in bf16.
:func:`store` writes them so, at a row pitch rounded up to 8 values (16
bytes), once per step; the wrappers re-pitch any other bf16 layout
themselves. The plain version of a bf16 kernel is the float32 one on
``beta.to(bfloat16).float()`` and ``x.to(bfloat16).float()``. Any other
storage name raises, as ``_storage_jnp`` (:320-327) does.

:class:`ProdLDAReconLoss` is the ``torch.autograd.Function`` around them
(forward: stats then loss; backward: grads), and
:func:`prodlda_recon_loss_reference` is the unfused oracle of the whole.

All three run their products on the tensor cores (3xTF32 ``mma.sync``, one
tile product shared by K1-K3); batches past the tensor-core layouts take
CUDA-core K1 and K2, chosen by shape alone (:func:`_route`). The source's
header states each kernel's bound on an H100 and what its design does about
it.

:func:`prodlda_recon_loss_vsharded` (K5) is the same loss with beta, x and
the running statistics split on V over a model group of ranks
(``torch.distributed``): K1-K3 run on each rank's shard, and only [B]-sized
softmax partials, the [B] loss and row-dot partials and the [B, K] g_theta
partial cross ranks (:mod:`gfedntm_tpu_torch.parallel.collectives`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gfedntm_tpu_torch.ops import _build
from gfedntm_tpu_torch.parallel.collectives import merge_softmax, sum_in_rank_order

#: Kernel launches per wrapper since the last reset — the proof that a run
#: went through the CUDA kernels. Plain ints; set them to 0 to reset.
#: ``vsharded`` counts forwards of K5's kernel branch (each launches K1 and
#: K2 on the rank's shard, and its backward K3). The ``_bf16`` keys count the
#: bf16-storage instantiations.
LAUNCHES = {"stats": 0, "loss": 0, "grads": 0, "vsharded": 0,
            "stats_bf16": 0, "loss_bf16": 0, "grads_bf16": 0, "vsharded_bf16": 0}
#: The eval-mode share of those launches: ``stats`` counts K1 launches with
#: ``training=False`` (its running-statistics branch), ``vsharded`` K5
#: forwards with ``training=False``, each of which launches K1 in eval mode
#: and K2 once (the V-sharded validation, ``train.steps.eval_loss``).
EVAL_LAUNCHES = {"stats": 0, "vsharded": 0, "stats_bf16": 0, "vsharded_bf16": 0}
#: Calls on CUDA tensors of K5's rows-sharded training branch
#: (:class:`VShardedRowsReconLoss`), which launches no kernel of its own: it
#: is plain tensor ops, as the JAX package's branch is plain XLA.
ROWS_CALLS = {"vsharded_rows": 0}

_NEG_INF = -1e30
_PLAN_KIND = {"stats": 0, "loss": 1, "grads": 2}
_BF16_KIND = 4  # fd_plan's and fd_route's kind bit for bf16 storage
_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_PITCH = 8  # bf16 values in the kernels' 16-byte copies
#: The profiler range of the bf16 cast and pad (``profile_step`` reads it).
STORE_RANGE = "fused_decoder.store"


def storage_torch_dtype(storage_dtype: str) -> torch.dtype:
    """The torch dtype of a storage name (``_storage_jnp``, :320-327): only
    ``"float32"`` and ``"bfloat16"``; any other name raises."""
    try:
        return _STORAGE[storage_dtype]
    except KeyError:
        raise ValueError(
            f"storage_dtype must be 'float32' or 'bfloat16', got {storage_dtype!r}"
        ) from None


def reset_launches() -> None:
    """Set every count of :data:`LAUNCHES`, :data:`EVAL_LAUNCHES` and
    :data:`ROWS_CALLS` to 0."""
    for counts in (LAUNCHES, EVAL_LAUNCHES, ROWS_CALLS):
        for key in counts:
            counts[key] = 0


def _counter(name, storage_dtype):
    return name if storage_dtype == "float32" else f"{name}_bf16"


#: The counts are bumped from every thread that launches: the federation
#: client steps on gRPC worker threads, two clients at once in one process.
_COUNT_LOCK = threading.Lock()


def _count(counts: dict, key: str) -> None:
    with _COUNT_LOCK:
        counts[key] += 1


def _pitched(t: torch.Tensor) -> torch.Tensor:
    """A [rows, n] bf16 view of ``t`` whose rows lie at a pitch of n rounded
    up to 8 values, 16-byte aligned, in a zero-filled buffer: ``t`` itself
    when it is laid out so, else a copy (which casts)."""
    rows, n = t.shape
    ld = -(-n // _PITCH) * _PITCH
    if t.dtype == torch.bfloat16 and t.stride() == (ld, 1) and t.data_ptr() % 16 == 0:
        return t
    buf = torch.empty((rows, ld), dtype=torch.bfloat16, device=t.device)
    buf[:, n:].zero_()
    buf[:, :n].copy_(t)
    return buf[:, :n]


def store(t: torch.Tensor, storage_dtype: str) -> torch.Tensor:
    """``beta`` or ``x`` as the kernels of ``storage_dtype`` read it: float32
    as it is; bf16 rounded to nearest and written at the padded pitch
    (:func:`_pitched`). The cast is a copy either way, so the padding costs
    no extra pass."""
    if storage_torch_dtype(storage_dtype) == torch.float32:
        return t
    with torch.profiler.record_function(STORE_RANGE):
        return _pitched(t)


def _upcast(t: torch.Tensor, storage_dtype: str) -> torch.Tensor:
    """The float32 values a kernel of ``storage_dtype`` computes with."""
    if storage_torch_dtype(storage_dtype) == torch.float32:
        return t
    return t.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the on-card comparison)
# ---------------------------------------------------------------------------
def stats_reference(theta, beta, mask, run_mean, run_var, training, eps=1e-5):
    """K1's arithmetic: ``(mean [V], var [V], m [B], s [B])``. Training uses
    the masked batch mean and biased variance; eval echoes the running
    stats. ``m``/``s`` are the softmax max and denominator over valid
    (mask > 0) rows; a fully-masked row keeps the (-1e30, 0) sentinel."""
    z = theta @ beta
    mk = mask[:, None]
    if training:
        cnt = torch.clamp_min(mask.sum(), 1.0)
        mean = (z * mk).sum(0) / cnt
        dev = (z - mean) * mk
        var = (dev * dev).sum(0) / cnt
    else:
        mean, var = run_mean.clone(), run_var.clone()
    n = (z - mean) * torch.rsqrt(var + eps)
    valid = mk > 0
    n = torch.where(valid, n, torch.full_like(n, _NEG_INF))
    m = n.max(dim=1).values
    safe_m = torch.clamp_min(m, 0.5 * _NEG_INF)
    e = torch.where(valid, torch.exp(n - safe_m[:, None]), torch.zeros_like(n))
    return mean, var, m, e.sum(1)


def _softmax_rows(theta, beta, mean, var, m, s, eps):
    """Recompute n and p from saved stats; fully-masked rows are forced
    finite (their loss rows are zeroed by the caller's sample mask)."""
    n = (theta @ beta - mean) * torch.rsqrt(var + eps)
    row_ok = s > 1e-20
    safe_m = torch.where(row_ok, m, torch.zeros_like(m))
    safe_s = torch.where(row_ok, s, torch.ones_like(s))
    p = torch.exp(torch.clamp_max(n - safe_m[:, None], 0.0)) / safe_s[:, None]
    return n, p, row_ok


def loss_reference(theta, beta, x, mean, var, m, s, eps=1e-5, floor=1e-10):
    """K2's arithmetic: ``(loss [B], rd [B])`` with
    ``loss = -sum_v x log(p + floor)`` (0 on fully-masked rows) and the
    softmax-backward row-dot ``rd = sum_v x p/(p + floor)``."""
    _, p, row_ok = _softmax_rows(theta, beta, mean, var, m, s, eps)
    contrib = torch.where(row_ok[:, None], x * torch.log(p + floor), torch.zeros_like(p))
    return -contrib.sum(1), (x * (p / (p + floor))).sum(1)


def grads_reference(theta, beta, x, mean, var, m, s, rd, g, mask, training,
                    eps=1e-5, floor=1e-10):
    """K3's arithmetic: ``(g_theta [B, K], g_beta [K, V])`` for the row
    cotangent ``g`` (already multiplied by the row mask), with the
    closed-form batch-norm backward of the JAX package's ``_bwd``."""
    n, p, _ = _softmax_rows(theta, beta, mean, var, m, s, eps)
    inv_std = torch.rsqrt(var + eps)
    xr = x * (p / (p + floor))
    gn = g[:, None] * (p * rd[:, None] - xr)
    if training:
        mk = mask[:, None]
        cnt = torch.clamp_min(mask.sum(), 1.0)
        sum_gn = (gn * mk).sum(0)
        sum_gnn = (gn * n * mk).sum(0)
        gz = inv_std * (gn - mk * (sum_gn / cnt) - n * mk * (sum_gnn / cnt))
    else:
        gz = gn * inv_std
    return gz @ beta.T, theta.T @ gz


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
def _check_inputs(name, theta, beta, storage_dtype="float32", **others):
    """Shapes, dtype, device and contiguity the kernels take: float32 and
    contiguous, except beta and x under bf16 storage, which are bf16 in any
    layout (the launch re-pitches them)."""
    stored = storage_torch_dtype(storage_dtype)
    if theta.dim() != 2 or beta.dim() != 2 or theta.shape[1] != beta.shape[0]:
        raise ValueError(
            f"{name}: theta [B, K] and beta [K, V] expected, got "
            f"{tuple(theta.shape)} and {tuple(beta.shape)}"
        )
    b, k = theta.shape
    v = beta.shape[1]
    if min(b, k, v) < 1:
        raise ValueError(f"{name}: empty input (B={b}, K={k}, V={v})")
    want = {"x": (b, v), "mask": (b,), "run_mean": (v,), "run_var": (v,),
            "mean": (v,), "var": (v,), "m": (b,), "s": (b,), "rd": (b,), "g": (b,)}
    for arg, t in {"theta": theta, "beta": beta, **others}.items():
        dtype = stored if arg in ("beta", "x") else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {str(dtype).removeprefix('torch.')}, "
                            f"got {t.dtype}")
        if t.device != theta.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, theta on {theta.device}")
        if dtype == torch.float32 and not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if arg in want and tuple(t.shape) != want[arg]:
            raise ValueError(f"{name}: {arg} must be {want[arg]}, got {tuple(t.shape)}")
    return b, k, v


def _kind(kind, storage_dtype):
    return _PLAN_KIND[kind] | (_BF16_KIND if storage_dtype == "bfloat16" else 0)


def _plan(lib, kind, b, k, v, storage_dtype="float32"):
    grid = ctypes.c_int(0)
    smem = ctypes.c_longlong(0)
    limit = ctypes.c_longlong(0)
    _raise_on(lib.fd_plan(_kind(kind, storage_dtype), b, k, v, ctypes.byref(grid),
                          ctypes.byref(smem), ctypes.byref(limit)), f"{kind} plan")
    if grid.value == 0:
        raise ValueError(
            f"fused decoder {kind} kernel: B={b}, K={k} needs {smem.value} bytes "
            f"of shared memory per block, more than the card's {limit.value}; "
            "use a smaller batch"
        )
    return grid.value


def _raise_on(code, what):
    if code != 0:
        raise RuntimeError(f"fused decoder {what}: CUDA error {code}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _empty(like, *shape):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _on_cuda(t):
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"fused decoder: unsupported device {t.device}")


def _route(lib, kind, b, k, storage_dtype="float32"):
    """A kernel's route at (B, K) and storage, chosen by shape alone: 32 or
    16 (the tensor-core tile width), 0 (the CUDA-core K1 or K2, for batches
    past the tensor-core layouts), -1 (nothing fits)."""
    route = ctypes.c_int(0)
    _raise_on(lib.fd_route(_kind(kind, storage_dtype), b, k, ctypes.byref(route)),
              f"{kind} route")
    return route.value


def stats(theta, beta, mask, run_mean, run_var, training, eps=1e-5,
          storage_dtype="float32"):
    """K1 (+ the merge of its per-block softmax partials)."""
    if not _on_cuda(theta):
        return stats_reference(theta, _upcast(beta, storage_dtype), mask, run_mean, run_var,
                               training, eps)
    out = _launch_stats(_build.load(), theta, beta, mask, run_mean, run_var, training, eps,
                        storage_dtype)
    _count(LAUNCHES, _counter("stats", storage_dtype))
    if not training:
        _count(EVAL_LAUNCHES, _counter("stats", storage_dtype))
    return out


def loss(theta, beta, x, mean, var, m, s, eps=1e-5, floor=1e-10, storage_dtype="float32"):
    """K2 (+ the ordered sum of its per-block partials)."""
    if not _on_cuda(theta):
        return loss_reference(theta, _upcast(beta, storage_dtype), _upcast(x, storage_dtype),
                              mean, var, m, s, eps, floor)
    out = _launch_loss(_build.load(), theta, beta, x, mean, var, m, s, eps, floor,
                       storage_dtype)
    _count(LAUNCHES, _counter("loss", storage_dtype))
    return out


def grads(theta, beta, x, mean, var, m, s, rd, g, mask, training, eps=1e-5,
          floor=1e-10, storage_dtype="float32"):
    """K3 (+ the ordered sum of its per-block g_theta partials)."""
    if not _on_cuda(theta):
        return grads_reference(theta, _upcast(beta, storage_dtype), _upcast(x, storage_dtype),
                               mean, var, m, s, rd, g, mask, training, eps, floor)
    out = _launch_grads(_build.load(), theta, beta, x, mean, var, m, s, rd, g, mask,
                        training, eps, floor, storage_dtype)
    _count(LAUNCHES, _counter("grads", storage_dtype))
    return out


def _operands(beta, x, storage_dtype):
    """beta and x as a launch passes them, and the extra C arguments: none
    for float32; for bf16 the row pitch, which both take."""
    if storage_dtype == "float32":
        return beta, x, ()
    beta = _pitched(beta)
    return beta, None if x is None else _pitched(x), (beta.stride(0),)


def _entry(lib, name, storage_dtype):
    return getattr(lib, name if storage_dtype == "float32" else f"{name}_bf16")


def _launch_stats(lib, theta, beta, mask, run_mean, run_var, training, eps,
                  storage_dtype="float32"):
    """K1 through the library ``lib``, uncounted."""
    b, k, v = _check_inputs("stats", theta, beta, storage_dtype, mask=mask,
                            run_mean=run_mean, run_var=run_var)
    beta, _, pitch = _operands(beta, None, storage_dtype)
    with torch.cuda.device(theta.device):
        grid = _plan(lib, "stats", b, k, v, storage_dtype)
        mean, var, m, s = (_empty(theta, n) for n in (v, v, b, b))
        m_part, s_part = _empty(theta, grid, b), _empty(theta, grid, b)
        _raise_on(_entry(lib, "fd_stats", storage_dtype)(
            _ptr(theta), _ptr(beta), _ptr(mask), _ptr(run_mean), _ptr(run_var),
            _ptr(mean), _ptr(var), _ptr(m_part), _ptr(s_part), _ptr(m), _ptr(s),
            b, k, v, *pitch, int(bool(training)), eps, grid, _stream(),
        ), "stats launch")
    return mean, var, m, s


def _launch_loss(lib, theta, beta, x, mean, var, m, s, eps, floor, storage_dtype="float32"):
    """K2 through the library ``lib``, uncounted."""
    b, k, v = _check_inputs("loss", theta, beta, storage_dtype, x=x, mean=mean, var=var,
                            m=m, s=s)
    beta, x, pitch = _operands(beta, x, storage_dtype)
    with torch.cuda.device(theta.device):
        grid = _plan(lib, "loss", b, k, v, storage_dtype)
        rl, rd = _empty(theta, b), _empty(theta, b)
        loss_part, rd_part = _empty(theta, grid, b), _empty(theta, grid, b)
        _raise_on(_entry(lib, "fd_loss", storage_dtype)(
            _ptr(theta), _ptr(beta), _ptr(x), _ptr(mean), _ptr(var), _ptr(m), _ptr(s),
            _ptr(loss_part), _ptr(rd_part), _ptr(rl), _ptr(rd),
            b, k, v, *pitch, eps, floor, grid, _stream(),
        ), "loss launch")
    return rl, rd


def _launch_grads(lib, theta, beta, x, mean, var, m, s, rd, g, mask, training, eps,
                  floor, storage_dtype="float32"):
    """K3 through the library ``lib`` (``_build.load()``, or another build of
    the source to compare with), uncounted."""
    b, k, v = _check_inputs("grads", theta, beta, storage_dtype, x=x, mean=mean, var=var,
                            m=m, s=s, rd=rd, g=g, mask=mask)
    beta, x, pitch = _operands(beta, x, storage_dtype)
    with torch.cuda.device(theta.device):
        grid = _plan(lib, "grads", b, k, v, storage_dtype)
        g_theta, g_beta = _empty(theta, b, k), _empty(theta, k, v)
        gth_part = _empty(theta, grid, b, k)
        _raise_on(_entry(lib, "fd_grads", storage_dtype)(
            _ptr(theta), _ptr(beta), _ptr(x), _ptr(mean), _ptr(var), _ptr(m), _ptr(s),
            _ptr(rd), _ptr(g), _ptr(mask), _ptr(gth_part), _ptr(g_theta), _ptr(g_beta),
            b, k, v, *pitch, int(bool(training)), eps, floor, grid, _stream(),
        ), "grads launch")
    return g_theta, g_beta


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class ProdLDAReconLoss(torch.autograd.Function):
    """``(rl [B], batch_mean [V], batch_var [V])`` with gradients to theta
    and beta only; the statistics outputs carry none (they feed the
    BatchNorm running-stat update). ``theta`` is float32; beta and x are
    stored once per call (:func:`store`), and the backward reuses that
    copy, as the JAX package's residuals keep the padded operands. g_beta
    takes beta's dtype (``_bwd``, :809-814)."""

    @staticmethod
    def forward(ctx, theta, beta, x, run_mean, run_var, mask, training, eps, floor,
                storage_dtype):
        beta_s, x_s = store(beta, storage_dtype), store(x, storage_dtype)
        mean, var, m, s = stats(theta, beta_s, mask, run_mean, run_var, training, eps,
                                storage_dtype)
        rl, rd = loss(theta, beta_s, x_s, mean, var, m, s, eps, floor, storage_dtype)
        ctx.save_for_backward(theta, beta_s, x_s, mask, mean, var, m, s, rd)
        ctx.training, ctx.eps, ctx.floor = training, eps, floor
        ctx.storage_dtype, ctx.beta_dtype = storage_dtype, beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return rl, mean, var

    @staticmethod
    def backward(ctx, g_rl, _g_mean, _g_var):
        theta, beta_s, x_s, mask, mean, var, m, s, rd = ctx.saved_tensors
        g = (g_rl * mask).contiguous()
        g_theta, g_beta = grads(theta, beta_s, x_s, mean, var, m, s, rd, g, mask,
                                ctx.training, ctx.eps, ctx.floor, ctx.storage_dtype)
        return g_theta, g_beta.to(ctx.beta_dtype), None, None, None, None, None, None, None, None


def _prepare(theta, mask, storage_dtype):
    """theta in float32 (autograd casts its gradient back to theta's dtype,
    as ``_bwd`` does) and the row mask, with the storage name checked."""
    storage_torch_dtype(storage_dtype)
    if mask is None:
        mask = torch.ones(theta.shape[0], device=theta.device)
    return theta.to(torch.float32), mask.to(torch.float32).contiguous()


def prodlda_recon_loss(theta, beta, x_bow, run_mean, run_var, mask=None,
                       training=True, eps=1e-5, floor=1e-10,
                       storage_dtype="float32"):
    """Fused ``-sum(x * log(softmax(batchnorm(theta @ beta)) + floor))``.

    Returns ``(rl [B], batch_mean [V], batch_var [V])``; in eval the stats
    echo ``run_mean``/``run_var``. Rows with ``mask == 0`` are excluded from
    the batch statistics; their rl rows are finite and meaningless (callers
    zero them with their sample mask). ``storage_dtype="bfloat16"`` stores
    beta and x in bf16 for the kernels (float32 math); theta is taken in
    float32 whatever its dtype, and its gradient comes back in that dtype."""
    theta, mask = _prepare(theta, mask, storage_dtype)
    return ProdLDAReconLoss.apply(
        theta, beta, x_bow, run_mean, run_var, mask, bool(training), float(eps),
        float(floor), storage_dtype,
    )


def prodlda_recon_loss_reference(theta, beta, x_bow, run_mean, run_var, mask=None,
                                 training=True, eps=1e-5, floor=1e-10):
    """Unfused composition with identical semantics — the oracle of the
    whole (gradients by autograd through plain ops)."""
    z = theta @ beta
    if training:
        if mask is None:
            mean = z.mean(0)
            var = torch.square(z - mean).mean(0)
        else:
            mk = mask.to(torch.float32)[:, None]
            cnt = torch.clamp_min(mk.sum(), 1.0)
            mean = (z * mk).sum(0) / cnt
            var = (torch.square(z - mean) * mk).sum(0) / cnt
    else:
        mean, var = run_mean, run_var
    p = torch.softmax((z - mean) * torch.rsqrt(var + eps), dim=-1)
    rl = -torch.sum(x_bow * torch.log(p + floor), dim=1)
    return rl, mean, var


# ---------------------------------------------------------------------------
# K5: the loss with beta and x split on V over a model group
# ---------------------------------------------------------------------------
class VShardedReconLoss(torch.autograd.Function):
    """Rows-replicated branch of K5 (``_vsharded_replicated_fwd``,
    ``gfedntm_tpu/ops/fused_decoder.py:878-909``, and the rows-replicated
    half of ``_vsharded_vjp_bwd``, ``:1057-1081``). Every rank of the model
    group holds the same rows.

    Forward: K1 on the local shard, the online-softmax merge of its
    ``(m, s)`` over the model group, K2 with the merged ``(m, l)``, and the
    loss and row-dot partials summed over the model group. Backward: K3 with
    the full row-dot gives the local g_beta and a g_theta partial, which is
    summed over the model group here, so everything upstream of theta sees
    the whole gradient on every rank. (The JAX backward's ``x axis_size``
    and its local-partial return are ``shard_map`` transpose conventions;
    autograd has neither.) ``plain`` runs the kernels' plain versions, on
    the float32 values of the stored beta and x. The local beta and x are
    stored once per call (:func:`store`), as in :class:`ProdLDAReconLoss`."""

    @staticmethod
    def forward(ctx, theta, beta, x, run_mean, run_var, mask, groups, training, eps,
                floor, storage_dtype, plain):
        beta_s, x_s = store(beta, storage_dtype), store(x, storage_dtype)
        group = groups.model_group
        if plain:
            beta_f, x_f = beta_s.float(), x_s.float()
            mean, var, m_loc, s_loc = stats_reference(theta, beta_f, mask, run_mean, run_var,
                                                      training, eps)
            m, l = merge_softmax(m_loc, s_loc, group)
            parts = loss_reference(theta, beta_f, x_f, mean, var, m, l, eps, floor)
        else:
            mean, var, m_loc, s_loc = stats(theta, beta_s, mask, run_mean, run_var, training,
                                            eps, storage_dtype)
            m, l = merge_softmax(m_loc, s_loc, group)
            parts = loss(theta, beta_s, x_s, mean, var, m, l, eps, floor, storage_dtype)
            if _on_cuda(theta):
                _count(LAUNCHES, _counter("vsharded", storage_dtype))
                if not training:
                    _count(EVAL_LAUNCHES, _counter("vsharded", storage_dtype))
        rl, rd = sum_in_rank_order(torch.stack(parts), group)
        ctx.save_for_backward(theta, beta_s, x_s, mask, mean, var, m, l, rd)
        ctx.groups, ctx.training, ctx.eps, ctx.floor, ctx.plain = (
            groups, training, eps, floor, plain)
        ctx.storage_dtype, ctx.beta_dtype = storage_dtype, beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return rl, mean, var

    @staticmethod
    def backward(ctx, g_rl, _g_mean, _g_var):
        theta, beta_s, x_s, mask, mean, var, m, l, rd = ctx.saved_tensors
        g = (g_rl * mask).contiguous()
        args = (mean, var, m, l, rd, g, mask, ctx.training, ctx.eps, ctx.floor)
        if ctx.plain:
            g_theta, g_beta = grads_reference(theta, beta_s.float(), x_s.float(), *args)
        else:
            g_theta, g_beta = grads(theta, beta_s, x_s, *args, ctx.storage_dtype)
        g_theta = sum_in_rank_order(g_theta, ctx.groups.model_group)
        return (g_theta, g_beta.to(ctx.beta_dtype), None, None, None, None, None, None, None,
                None, None, None)


class VShardedRowsReconLoss(torch.autograd.Function):
    """Rows-sharded training branch of K5 in plain tensor ops, as the JAX
    package computes it outside any Pallas kernel
    (``_vsharded_data_sharded_fwd``, ``:912-953``, and ``:1020-1055``). Rows
    are split over the data group and V over the model group.

    Forward: the masked column sums, sums of squares and row count are summed
    over the data group (mean by the rank-K shortcut, variance as
    E[z^2] - mean^2, as in the JAX package); the softmax partials merge over
    the model group; the loss partials sum over the model group.

    Backward, spelled out: the row-dot is summed over the model group; the
    count and the BatchNorm corrections ``sum_gn``, ``sum_gnn`` over the
    data group; g_theta over the model group. g_beta is this data rank's
    partial: a data-parallel trainer sums it over the data group with every
    other gradient. Under bf16 storage beta and x take their bf16-rounded
    values, as the kernels read them."""

    @staticmethod
    def forward(ctx, theta, beta, x, mask, groups, eps, floor, storage_dtype):
        if _on_cuda(theta):
            _count(ROWS_CALLS, "vsharded_rows")
        beta, x = _upcast(beta, storage_dtype), _upcast(x, storage_dtype)
        mk = mask[:, None]
        cnt = torch.clamp_min(sum_in_rank_order(mask.sum(), groups.data_group), 1.0)
        z = theta @ beta
        colsum, colsumsq = sum_in_rank_order(
            torch.stack([(mk * theta).sum(0) @ beta, (z * z * mk).sum(0)]),
            groups.data_group)
        mean = colsum / cnt
        var = torch.clamp_min(colsumsq / cnt - mean * mean, 0.0)
        _, _, m_loc, s_loc = stats_reference(theta, beta, mask, mean, var, False, eps)
        m, l = merge_softmax(m_loc, s_loc, groups.model_group)
        rl, rd = sum_in_rank_order(
            torch.stack(loss_reference(theta, beta, x, mean, var, m, l, eps, floor)),
            groups.model_group)
        ctx.save_for_backward(theta, beta, x, mask, mean, var, m, l, rd, cnt)
        ctx.groups, ctx.eps, ctx.floor = groups, eps, floor
        ctx.mark_non_differentiable(mean, var)
        return rl, mean, var

    @staticmethod
    def backward(ctx, g_rl, _g_mean, _g_var):
        theta, beta, x, mask, mean, var, m, l, rd, cnt = ctx.saved_tensors
        groups = ctx.groups
        n, p, _ = _softmax_rows(theta, beta, mean, var, m, l, ctx.eps)
        mk = mask[:, None]
        gn = (g_rl * mask)[:, None] * (p * rd[:, None] - x * (p / (p + ctx.floor)))
        sum_gn, sum_gnn = sum_in_rank_order(
            torch.stack([(gn * mk).sum(0), (gn * n * mk).sum(0)]), groups.data_group)
        gz = torch.rsqrt(var + ctx.eps) * (gn - mk * (sum_gn / cnt) - n * mk * (sum_gnn / cnt))
        g_theta = sum_in_rank_order(gz @ beta.T, groups.model_group)
        return g_theta, theta.T @ gz, None, None, None, None, None, None


def _vsharded(theta, beta_local, x_local, run_mean_local, run_var_local, mask, groups,
              training, eps, floor, storage_dtype, plain):
    theta, mask = _prepare(theta, mask, storage_dtype)
    if training and groups.data_group is not None:
        # Plain tensor ops in float32 on the values the storage holds (the
        # JAX package's branch ignores the storage; here a dp > 1 run
        # computes the function its single-device run computes).
        return VShardedRowsReconLoss.apply(theta, beta_local, x_local, mask, groups,
                                           float(eps), float(floor), storage_dtype)
    return VShardedReconLoss.apply(
        theta, beta_local, x_local, run_mean_local, run_var_local, mask, groups,
        bool(training), float(eps), float(floor), storage_dtype, plain,
    )


def prodlda_recon_loss_vsharded(theta, beta_local, x_local, run_mean_local,
                                run_var_local, mask=None, *, groups, training=True,
                                eps=1e-5, floor=1e-10, storage_dtype="float32"):
    """K5: the full-V fused loss with beta, x and the running statistics split
    on V over ``groups.model_group`` (``gfedntm_tpu/ops/fused_decoder.py:824``).

    ``groups`` is a :class:`~gfedntm_tpu_torch.parallel.mesh.DpMpGroups`.
    ``theta`` [B_local, K] and ``mask`` [B_local] are this rank's rows
    (all rows unless ``groups.data_group`` splits them); ``beta_local``
    [K, V_local], ``x_local`` [B_local, V_local] and the running statistics
    [V_local] are its columns. Returns ``(rl [B_local], mean [V_local],
    var [V_local])``: rl is the full-V loss, equal on every rank of the model
    group; the statistics are the shard's (eval: the running ones).

    Rows replicated over the model group (no data group, or eval): K1-K3 on
    the shard (:class:`VShardedReconLoss`). Rows split over a data group in
    training: plain tensor ops (:class:`VShardedRowsReconLoss`)."""
    return _vsharded(theta, beta_local, x_local, run_mean_local, run_var_local, mask,
                     groups, training, eps, floor, storage_dtype, plain=False)


def prodlda_recon_loss_vsharded_reference(theta, beta_local, x_local, run_mean_local,
                                          run_var_local, mask=None, *, groups,
                                          training=True, eps=1e-5, floor=1e-10,
                                          storage_dtype="float32"):
    """K5's plain version: the same composition on ``stats_reference``,
    ``loss_reference`` and ``grads_reference``, on any device (the on-card
    comparison calls it on CUDA tensors)."""
    return _vsharded(theta, beta_local, x_local, run_mean_local, run_var_local, mask,
                     groups, training, eps, floor, storage_dtype, plain=True)
