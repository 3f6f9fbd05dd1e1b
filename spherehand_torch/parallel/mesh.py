"""Data parallelism over ranks: the group, the pad plan and the sums.

Counterpart of ``spherehand_tpu/parallel/mesh.py`` (its 1-D ``data`` mesh)
and of the JAX engine's padding (``Engine._pad_batch`` / ``_pad_idx``,
engine.py:432-490). Parameters and Adam state are replicated; each rank
takes a contiguous block of the batch's rows. A batch whose size the rank
count does not divide is padded up with rows repeated from its start at
loss weight 0, so the objective over the ranks is exactly the one-device
objective (``ops.reduce``). Where XLA inserts the ``psum``, the port does
three things itself:

- every weighted mean on a rank divides by the *global* weight total (the
  count of true rows, :attr:`RankRows.total`), so a rank's loss is its
  exact share of the global loss;
- the global gradient is the **sum** of the ranks' gradients
  (:meth:`RankGroup.sum_grads`, one flattened ``all_reduce``; DDP would
  average, dividing by the rank count);
- logged metrics are shares too, summed over the ranks
  (:meth:`RankGroup.sum_metrics`).

Backend by topology: NCCL when every rank of a host has a card of its own,
gloo when ranks share a card or run on the CPU (gloo runs ``all_reduce``,
``broadcast`` and ``barrier`` on CUDA tensors; NCCL refuses two ranks on
one device). A group that cannot form raises; nothing falls back.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


class RankRows(NamedTuple):
    """One rank's rows of a batch of ``total`` true rows: ``index`` into the
    unpadded batch (wraparound for pad rows), ``weights`` (0 on pad rows;
    None when the batch has no pad rows) and ``total``, the global weight
    sum the rank's means divide by (None on a single rank)."""

    index: np.ndarray
    weights: np.ndarray | None
    total: int | None


def pad_idx(idx: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray | None]:
    """``Engine._pad_idx`` (engine.py:432-446): ``idx`` grown to a multiple
    of ``n`` with wraparound duplicates from its start, and the weights
    (1 on true rows, 0 on pad rows; None when nothing is padded)."""
    idx = np.asarray(idx)
    b = idx.shape[0]
    pad = (-b) % n
    if not pad:
        return idx.astype(np.int32), None
    idxp = np.concatenate([idx, idx[np.arange(pad) % b]]).astype(np.int32)
    return idxp, np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])


def pad_batch(arrays, n: int) -> tuple[list[np.ndarray], np.ndarray | None]:
    """``Engine._pad_batch`` (engine.py:459-480): every array's leading
    axis grown to a multiple of ``n`` with wraparound duplicate rows, and
    the weights (None when nothing is padded)."""
    arrays = [np.asarray(x) for x in arrays]
    idx, weights = pad_idx(np.arange(arrays[0].shape[0]), n)
    return ([x[idx] for x in arrays] if weights is not None else arrays), weights


def rank_rows(b: int, rank: int, world: int) -> RankRows:
    """Rank ``rank``'s contiguous block of a batch of ``b`` rows padded to
    a multiple of ``world``."""
    idx, weights = pad_idx(np.arange(b), world)
    per = idx.shape[0] // world
    block = slice(rank * per, (rank + 1) * per)
    return RankRows(idx[block].astype(np.int64),
                    None if weights is None else weights[block],
                    b if world > 1 else None)


def sample_rows(rows: RankRows, views: int) -> np.ndarray:
    """The flat (sample x view) row indices of ``rows``' samples: a rank
    takes whole samples of ``views`` views."""
    return (rows.index[:, None] * views + np.arange(views)).reshape(-1)


def temporal_ranks(cfg, avail: int) -> int:
    """The rank count ``--temporal`` allows (engine.py:140-156): the
    largest one up to ``avail`` that divides the real, synthetic and eval
    batches, since padding would break the consecutive-row loss."""
    return max(n for n in range(1, avail + 1)
               if cfg.real_batch % n == 0 and cfg.synt_batch % n == 0
               and cfg.eval_batch % n == 0)


def temporal_message(n: int, avail: int) -> str:
    return (f"[engine] --temporal: data-parallel over {n}/{avail} devices (padding is "
            "incompatible with the consecutive-frame loss)")


@dataclasses.dataclass(frozen=True)
class RankPlan:
    """How a training run places its ranks: ``world`` ranks; ``launch`` is
    "single" (this process, no group), "join" (this process is one rank of
    a launcher's group, ``torchrun``'s environment) or "spawn" (start one
    process per card under ``torch.distributed.run``); ``note``: a line
    for the log, or None."""

    world: int
    launch: str
    note: str | None = None


def rank_plan(cfg, device: torch.device, device_count: int,
              environ: Mapping[str, str]) -> RankPlan:
    """The rank plan of a training run, a pure function of the engine
    configuration, the device, the host's card count and the environment.
    A launcher's group (``WORLD_SIZE`` set) is joined as it is; otherwise,
    on CUDA with ``data_parallel`` on and more than one card, one rank per
    card (under ``--temporal`` the largest count that divides every batch,
    as the JAX engine)."""
    if "WORLD_SIZE" in environ:
        world = int(environ["WORLD_SIZE"])
        if world > 1 and not cfg.data_parallel:
            raise ValueError(f"launched as one of {world} ranks, but --no_data_parallel "
                             "trains on one card: launch one process")
        if world > 1 and cfg.temporal and temporal_ranks(cfg, world) != world:
            raise ValueError(f"--temporal over {world} ranks: {world} does not divide "
                             f"real_batch {cfg.real_batch}, synt_batch {cfg.synt_batch} and "
                             f"eval_batch {cfg.eval_batch} (padding would break the loss)")
        return RankPlan(world, "join" if world > 1 else "single")
    if not cfg.data_parallel or device.type != "cuda" or device_count <= 1:
        return RankPlan(1, "single")
    world, note = device_count, None
    if cfg.temporal:
        world = temporal_ranks(cfg, device_count)
        if world < device_count:
            note = temporal_message(world, device_count)
    return RankPlan(world, "spawn" if world > 1 else "single", note)


def choose_backend(device_type: str, local_world: int, device_count: int) -> str:
    """NCCL when each of a host's ``local_world`` ranks has a card of its
    own; gloo when ranks share a card, or on the CPU."""
    if device_type != "cuda":
        return "gloo"
    if device_count < 1:
        raise RuntimeError("CUDA ranks requested, but no card is visible")
    return "nccl" if local_world <= device_count else "gloo"


@dataclasses.dataclass
class RankGroup:
    """One rank of a formed group: its rank, the rank count, the rank's
    device and the group's backend."""

    rank: int
    world: int
    device: torch.device
    backend: str
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, b: int) -> RankRows:
        """This rank's rows of a batch of ``b``."""
        return rank_rows(b, self.rank, self.world)

    def weights_on_device(self, rows: RankRows) -> torch.Tensor | None:
        """``rows.weights`` on the rank's device, uploaded once a plan."""
        if rows.weights is None:
            return None
        key = rows.weights.tobytes()
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(rows.weights, device=self.device)
        return self._on_device[key]

    # ------------------------------------------------------------ collectives
    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place."""
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        return tensor

    def sum_tensors(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The rank sums of ``tensors`` (one dtype), through one flattened
        ``all_reduce`` (on one rank too: the sum of one is the tensor)."""
        if not tensors:
            return tensors
        flat = self.all_reduce_(torch.cat([t.reshape(-1) for t in tensors]))
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                   tensors)]

    def sum_grads(self, params) -> None:
        """Replace every ``.grad`` of ``params`` with its sum over the ranks
        (a parameter without a gradient counts as zeros)."""
        params = list(params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for p, g in zip(params, self.sum_tensors([p.grad for p in params])):
            p.grad.copy_(g)

    def sum_metrics(self, metrics: dict) -> dict:
        """The rank sums of a dict of float32 scalars, one ``all_reduce``."""
        keys = list(metrics)
        total = self.all_reduce_(torch.stack([metrics[k].detach().float().reshape(())
                                              for k in keys]))
        return dict(zip(keys, total.unbind()))

    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` (one dtype) with rank ``src``'s, in one
        flattened broadcast."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src)
        for part, t in zip(flat.split([t.numel() for t in tensors]), tensors):
            t.data.copy_(part.view_as(t))

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def gather_objects(self, obj: Any) -> list | None:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out if self.is_main else None

    def barrier(self) -> None:
        dist.barrier()

    def rank_rows_of_last(self, last: torch.Tensor) -> torch.Tensor:
        """(world, *last.shape): every rank's ``last``, by one ``all_reduce``
        of a zero-filled stack (gloo has no all-gather on CUDA tensors)."""
        stack = torch.zeros((self.world, *last.shape), dtype=last.dtype, device=last.device)
        stack[self.rank] = last
        return self.all_reduce_(stack)


def form_group(rank: int, world: int, device_type: str, init_method: str,
               local_rank: int | None = None, local_world: int | None = None,
               backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> RankGroup:
    """Join a group of ``world`` ranks as ``rank`` through ``init_method``
    (``env://`` under a launcher, ``file://`` or ``tcp://``). The rank's
    device is ``cuda:{local_rank % device_count}`` on CUDA; the backend is
    :func:`choose_backend`'s unless given. Raises if the group cannot form
    or NCCL is asked for ranks that share a card."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("CUDA ranks requested, but no card is visible")
        device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
    else:
        count = 0
        device = torch.device(device_type)
    chosen = choose_backend(device_type, local_world, count)
    backend = chosen if backend is None else backend
    if backend == "nccl" and chosen != "nccl":
        raise ValueError(f"NCCL needs a card for each rank: {local_world} ranks on {count} "
                         "cards")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return RankGroup(rank, world, device, backend)


def join_launcher(device_type: str) -> RankGroup:
    """Join the group ``torchrun`` set up (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``PORT``)."""
    env = os.environ
    world = int(env["WORLD_SIZE"])
    return form_group(int(env["RANK"]), world, device_type, "env://",
                      local_rank=int(env.get("LOCAL_RANK", 0)),
                      local_world=int(env.get("LOCAL_WORLD_SIZE", world)))


def leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
