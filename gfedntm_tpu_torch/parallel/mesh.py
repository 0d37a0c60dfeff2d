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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


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
