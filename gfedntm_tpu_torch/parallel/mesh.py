"""Process groups of a 2-D ``(data, model)`` layout.

Counterpart of ``make_dp_mp_mesh`` (``gfedntm_tpu/parallel/sharded.py:38-48``).
Rank r sits at (d, m) = (r // mp, r % mp), the order of
``np.array(devices).reshape(dp, mp)``:

- the ``mp`` ranks of one row (same d) hold the same rows and split the
  vocabulary: their *model group*;
- the ``dp`` ranks of one column (same m) hold the same vocabulary shard and
  split the rows: their *data group*.

A group of one rank is ``None`` (nothing to reduce), so a check across every
rank passes :attr:`DpMpGroups.world_group`, never ``None``. The default
process group must be initialized first, with the backend the caller chose;
nothing here picks one.

The client layouts (``gfedntm_tpu/parallel/mesh.py:113-247``) place the
*clients* of a federation over ranks, as the JAX ``clients`` mesh axis
places them over devices: :func:`make_client_mesh`,
:func:`distributed_client_mesh`, :func:`make_slice_client_mesh`,
:func:`distributed_slice_client_mesh` return a :class:`ClientLayout`, and
:func:`stack_and_pad` is a copy. Rank r of a layout holds the block of
clients ``[r L, (r + 1) L)``, L = padded count / ranks; the padded clients
carry zero FedAvg weight and no data, so they are exact no-ops. The JAX
``ensure_virtual_devices`` forces XLA's virtual CPU devices before its
backend starts; torch has no such switch (a rank is a process, and the CPU
runs as many as the caller spawns), so it has no counterpart here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from gfedntm_tpu_torch.parallel.collectives import gather_by_sum


@dataclass(frozen=True)
class DpMpGroups:
    """One rank's place in a ``dp x mp`` layout and its two groups."""

    dp: int
    mp: int
    rank: int
    model_group: object | None = None  # ProcessGroup of this rank's row
    data_group: object | None = None  # ProcessGroup of this rank's column

    @property
    def data_rank(self) -> int:
        return self.rank // self.mp

    @property
    def model_rank(self) -> int:
        return self.rank % self.mp

    def v_slice(self, vocab_size: int) -> slice:
        """This rank's vocabulary columns (an even split, as ``shard_map``
        makes it)."""
        return _even_slice(vocab_size, self.mp, self.model_rank, "vocabulary")

    def row_slice(self, n_rows: int) -> slice:
        """This rank's rows of a batch split over the data group."""
        return _even_slice(n_rows, self.dp, self.data_rank, "batch")

    @property
    def world_group(self):
        """Every rank of the layout (``None`` when it has one rank)."""
        return dist.group.WORLD if self.dp * self.mp > 1 else None

    @property
    def is_root(self) -> bool:
        """Data rank 0 and model rank 0: the rank that writes files."""
        return self.rank == 0


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (and >= m); copy of
    ``gfedntm_tpu/parallel/mesh.py:108-110``."""
    return max(1, -(-n // m)) * m


def _even_slice(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} size {n} does not split evenly over {parts} ranks")
    width = n // parts
    return slice(index * width, (index + 1) * width)


def make_dp_mp_groups(dp: int, mp: int) -> DpMpGroups:
    """Build every rank's model and data groups (each rank must call this,
    in the same order, since ``new_group`` is collective) and return this
    rank's."""
    if dp < 1 or mp < 1:
        raise ValueError(f"dp and mp must be >= 1, got {dp} x {mp}")
    world = dist.get_world_size()
    if dp * mp != world:
        raise ValueError(f"layout {dp} x {mp} needs {dp * mp} ranks, the world has {world}")
    rank = dist.get_rank()
    model_group = data_group = None
    if mp > 1:
        for d in range(dp):
            group = dist.new_group([d * mp + m for m in range(mp)])
            if d == rank // mp:
                model_group = group
    if dp > 1:
        for m in range(mp):
            group = dist.new_group([d * mp + m for d in range(dp)])
            if m == rank % mp:
                data_group = group
    return DpMpGroups(dp=dp, mp=mp, rank=rank, model_group=model_group,
                      data_group=data_group)


@dataclass(frozen=True)
class ClientLayout:
    """A federation's clients over ``ranks`` ranks: this process's place in
    it and the group its FedAvg spans.

    ``shape`` is the layout's grid, ``(ranks,)`` for the 1-D ``clients``
    layout and ``(slices, per slice)`` for the slice layout, whose FedAvg
    spans both axes (``group`` holds every rank of the grid; a rank's
    clients are its block of the grid in row-major order). ``rank`` is
    this process's rank in the layout, -1 on a rank of the default group
    that the layout does not use (more ranks than clients). ``group`` is
    ``None`` when the layout has one rank or no process group exists."""

    ranks: int
    c_pad: int
    rank: int = 0
    group: object | None = None
    shape: tuple = ()
    axis_names: tuple = ("clients",)

    @property
    def block_size(self) -> int:
        """Clients per rank, padding included."""
        return self.c_pad // self.ranks

    def block(self, rank: int | None = None) -> range:
        """The (padded) client indices of ``rank`` (default: this one); empty
        off the layout."""
        rank = self.rank if rank is None else rank
        if rank < 0:
            return range(0)
        return range(rank * self.block_size, (rank + 1) * self.block_size)

    def owner(self, client: int) -> int:
        """The rank that steps ``client``."""
        return client // self.block_size


def _world() -> tuple[int, int]:
    """(world size, rank) of the default group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _layout_group(n_used: int):
    """A group of the default group's first ``n_used`` ranks (every rank of
    the default group calls this: ``new_group`` is collective), ``None``
    for one rank or without a default group."""
    world, _ = _world()
    if n_used <= 1 or world == 1:
        return None
    if n_used == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n_used)))


def make_client_mesh(n_clients: int, ranks: int | None = None,
                     axis_name: str = "clients") -> tuple[ClientLayout, int]:
    """A 1-D layout over min(``ranks``, n_clients) ranks and the padded
    client count, a multiple of it (``make_client_mesh``, :113-122).
    ``ranks`` defaults to the default group's world size (1 without one);
    a count above it raises. With a default group every rank must call
    this (the layout's group is made collectively); a rank past the used
    ones gets ``rank=-1``."""
    world, me = _world()
    have = world if ranks is None else int(ranks)
    if have < 1 or (dist.is_available() and dist.is_initialized() and have > world):
        raise ValueError(f"ranks={have} out of range: the default group has {world}")
    n_used = max(1, min(have, n_clients))
    c_pad = -(-n_clients // n_used) * n_used
    group = _layout_group(n_used)
    rank = me if me < n_used else -1
    return ClientLayout(ranks=n_used, c_pad=c_pad, rank=rank, group=group,
                        shape=(n_used,), axis_names=(axis_name,)), c_pad


_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def distributed_client_mesh(n_clients: int, init_method: str | None = None,
                            world_size: int | None = None, rank: int | None = None,
                            backend: str = "gloo",
                            axis_name: str = "clients") -> tuple[ClientLayout, int]:
    """A client layout over every rank of a job started by a launcher
    (``distributed_client_mesh``, :125-161): the default group is
    initialized from ``init_method`` (with ``world_size`` and ``rank``),
    or from the environment a launcher such as ``torchrun`` sets
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), unless it exists already. Without either it is
    :func:`make_client_mesh` of this process alone, as the JAX variant
    falls back to the local devices."""
    if not dist.is_initialized():
        if init_method is not None:
            dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                    rank=rank)
        elif all(key in os.environ for key in _ENV_KEYS):
            dist.init_process_group(backend, init_method="env://")
    return make_client_mesh(n_clients, axis_name=axis_name)


def make_slice_client_mesh(n_slices: int, ranks_per_slice: int, ranks: int | None = None,
                           axis_names: tuple[str, str] = ("slice", "clients")) -> ClientLayout:
    """A 2-D ``(slice, clients)`` layout of the first ``n_slices x
    ranks_per_slice`` ranks (``make_slice_client_mesh``, :164-188): rank r
    sits in slice r // ranks_per_slice. FedAvg spans both axes: the
    layout's ``group`` holds every rank of the grid. The padded client
    count is set by the trainer, which takes the layout (a multiple of the
    grid's size).
    Raises when ``ranks`` (default: the default group's world size) is
    short of the grid."""
    world, me = _world()
    have = world if ranks is None else int(ranks)
    need = n_slices * ranks_per_slice
    if have < need:
        raise ValueError(f"need {need} ranks for a {n_slices}x{ranks_per_slice} "
                         f"(slice, clients) layout, have {have}")
    return ClientLayout(ranks=need, c_pad=need, rank=me if me < need else -1,
                        group=_layout_group(need), shape=(n_slices, ranks_per_slice),
                        axis_names=tuple(axis_names))


def host_index() -> int:
    """This process's host in a launched job: ``GROUP_RANK`` (``torchrun``'s
    node rank), else 0."""
    return int(os.environ.get("GROUP_RANK", "0"))


def distributed_slice_client_mesh(axis_names: tuple[str, str] = ("slice", "clients"),
                                  hosts: list | None = None,
                                  n_proc: int | None = None) -> ClientLayout:
    """The slice layout of a launched job: one slice per host, that host's
    ranks along the inner ``clients`` axis
    (``distributed_slice_client_mesh``, :191-234; JAX's processes are
    hosts, its devices ranks). ``hosts[r]`` is rank r's host index
    (default: every rank's :func:`host_index`, gathered; 0 without a
    default group) and ``n_proc`` the number of hosts (default: the
    distinct indices). Every host must contribute exactly ``len(hosts) //
    n_proc`` ranks, and its ranks must be consecutive: unequal
    contributions raise, as they do in the JAX function, since a slice
    would otherwise mix hosts."""
    world, me = _world()
    if hosts is None:
        if world == 1:
            hosts = [host_index()]
        else:
            mine = torch.tensor([float(host_index())])
            hosts = [int(h) for h in gather_by_sum(mine, dist.group.WORLD).flatten().tolist()]
    hosts = list(hosts)
    n_proc = max(1, len(set(hosts)) if n_proc is None else int(n_proc))
    if len(hosts) % n_proc != 0:
        raise ValueError(f"{len(hosts)} ranks do not divide evenly over {n_proc} processes")
    per_proc = len(hosts) // n_proc
    counts: dict[int, int] = {}
    for h in hosts:
        counts[h] = counts.get(h, 0) + 1
    if len(counts) != n_proc or any(c != per_proc for c in counts.values()):
        raise ValueError(
            f"every process must contribute exactly {per_proc} ranks for a {n_proc}-row "
            f"(slice, clients) layout, got per-process counts {dict(sorted(counts.items()))}"
            " — a slice would mix processes")
    if hosts != sorted(hosts):
        raise ValueError(f"ranks of a host must be consecutive for the slice layout, got "
                         f"hosts {hosts}")
    return make_slice_client_mesh(n_proc, per_proc, ranks=len(hosts) if world == 1 else None,
                                  axis_names=axis_names)


def stack_and_pad(arrays: list[np.ndarray], c_pad: int) -> np.ndarray:
    """Copy of ``gfedntm_tpu/parallel/mesh.py:stack_and_pad`` (:237-247):
    stack per-client arrays along a new leading axis, padding ragged doc
    counts with zero rows and missing clients with zero blocks."""
    n = len(arrays)
    d_max = max(a.shape[0] for a in arrays)
    trailing = arrays[0].shape[1:]
    out = np.zeros((c_pad, d_max) + trailing, dtype=arrays[0].dtype)
    for c, a in enumerate(arrays):
        out[c, : a.shape[0]] = a
    assert n <= c_pad
    return out


def data_layout(ranks: int, group, rank: int) -> DpMpGroups:
    """The ``dp x 1`` layout of one client's data-parallel step over a
    group of its own (the mesh client's, which the default group does not
    know): ``ranks`` ranks split each batch's rows, ``rank`` is this one."""
    return DpMpGroups(dp=ranks, mp=1, rank=rank, data_group=group if ranks > 1 else None)
