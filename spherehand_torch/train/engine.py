"""Training and eval engine: epochs over NYU shards, checkpoints, eval.

Counterpart of ``spherehand_tpu/train/engine.py`` (reference
``network/engine.py``, Engine :52-477), with the same run semantics: a
random 6-char run directory with ``loss_weights.txt``, ``config.json``,
``log.txt``, ``metrics.jsonl`` and ``images/``; three epoch modes
(synthetic-only, real-only, combined); StepLR by epoch; the ``is_mv``
curriculum window; a checkpoint per epoch plus a rolling latest; eval of
the denoised view-0 joints into ``result.npz``.

Built for eager PyTorch on one card:

- every step's draws come from one device generator seeded from
  ``(seed, epoch, it)`` alone (:func:`step_seed`, the counterpart of
  ``fold_in(fold_in(key, epoch), it)``), and the index plan from
  ``(seed, epoch)``, so a resumed epoch replays the same draws and batches;
- the host loader gathers from the memmaps in a thread, into pinned host
  tensors copied with ``non_blocking=True``: no step waits on a pageable
  copy. ``device_data`` instead uploads a split once and gathers each batch
  on the card by index, bit for bit the host loader's batch;
- metric sums stay on the device and are read once a log line
  (every :data:`LOG_EVERY` iterations);
- checkpoints are ``torch.save`` files. ``initial_model`` restores weights
  only; ``restore_from_model`` resumes fully, at the epoch after the one
  the checkpoint holds (the JAX engine restarts the epoch it holds, or
  epoch -1 from its rolling latest).

Data parallelism (``group``, a ``parallel.mesh.RankGroup``; the CLI forms
it): every rank builds the same global index plan, pads each batch to a
multiple of the rank count (rows repeated from its start at weight 0, the
JAX ``_pad_idx``) and gathers only its own block, from the host loader or
from its own resident split. Rank 0 alone names the run (and broadcasts
the name) and writes ``log.txt``, ``metrics.jsonl``, ``config.json``,
images, checkpoints and ``result.npz``; a barrier follows each checkpoint,
and every rank loads one. Eval gathers the denoised joints to rank 0 in
the global order and drops the pad rows. The metrics are the global
batch's (the steps sum them); steps/s is rank 0's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import string
import time
from typing import Any, Iterator

import numpy as np
import torch

from spherehand_torch import viz
from spherehand_torch.constants import Constants
from spherehand_torch.data.nyu import NyuDataset, NyuLoader
from spherehand_torch.device import resolve_device
from spherehand_torch.hand.assets import HandModel, load_hand_model
from spherehand_torch.losses.multitask import LOSS_WEIGHTS
from spherehand_torch.parallel.mesh import RankGroup, temporal_ranks
from spherehand_torch.train.config import EngineConfig
from spherehand_torch.train.steps import NUM_VIEWS, RealBatch, StepDraws, build_steps
from spherehand_torch.utils.profiling import StepTimer

_C = Constants()
LOG_EVERY = 100  # iterations between log lines and metric records
TRAIN_IMAGES_EVERY = 400  # combined-epoch image dumps (engine.py:656)


class RunningAverage:
    """Metric accumulator (reference engine.py:30-49): the sums stay on the
    device; :meth:`to_dict` reads them all with one copy."""

    def __init__(self):
        self.num = 0
        self.sums: dict[str, torch.Tensor] = {}

    def append(self, metrics: dict) -> None:
        for k, v in metrics.items():
            self.sums[k] = v if k not in self.sums else self.sums[k] + v
        self.num += 1

    def to_dict(self, count: int | None = None) -> dict[str, float]:
        """The means over ``count`` steps (default: the steps appended)."""
        if not self.sums:
            return {}
        keys = list(self.sums)
        vals = torch.stack([self.sums[k].detach().float().reshape(()) for k in keys]).cpu()
        n = self.num if count is None else count
        return {k: float(v) / n for k, v in zip(keys, vals.tolist())}


def _rand_name(n: int = 6) -> str:
    return "".join(random.choice(string.ascii_letters + string.digits) for _ in range(n))


def _fmt(avg: dict[str, float]) -> str:
    return " ".join(f"{k}: {v:.4f}" for k, v in avg.items())


def step_seed(seed: int, epoch: int, it: int) -> int:
    """The seed of step ``it`` of ``epoch``'s draws: a function of the three
    alone, mixed by ``numpy.random.SeedSequence`` (63 bits)."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFF, epoch, it]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) & 0x7FFFFFFF) << 32


def save_state(path: str, state, epoch: int) -> None:
    """A train state as the engine's checkpoint file (``torch.save``,
    written whole or not at all): the network and optimizer state, the
    step, the temporal-loss state and ``epoch``, the epoch it holds;
    ``infer.load_estimator`` serves it."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"network": state.network.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step, "prev_skel": state.prev_skel, "has_prev": state.has_prev,
                "epoch": epoch}, tmp)
    os.replace(tmp, path)


def _prefetch(iterable, depth: int = 2):
    """Background-thread prefetch: the loader's memmap gather runs while
    the previous step's device work is in flight. If the consumer abandons
    the generator mid-epoch (step exception, Ctrl-C), the worker notices
    via the stop event within 0.5 s and exits instead of blocking on the
    full queue forever."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()

    def _put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for x in iterable:
                if not _put(x):
                    return
            _put(sentinel)
        except BaseException as e:  # surface loader errors in the main thread
            _put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            x = q.get()
            if x is sentinel:
                return
            if isinstance(x, BaseException):
                raise x
            yield x
    finally:
        stop.set()


class Engine:
    """Training and eval of one run. ``device``: CUDA by default; ``hand``:
    a loaded hand model to share (loaded on ``device`` when None);
    ``group``: this process's rank of a data-parallel group (its device is
    the run's), or None for one device."""

    def __init__(self, cfg: EngineConfig, device: torch.device | str | None = None,
                 hand: HandModel | None = None, group: RankGroup | None = None):
        self.cfg = cfg
        self.group = group
        self.is_main = group is None or group.is_main
        self.device = group.device if group is not None else resolve_device(device)
        if group is not None and cfg.temporal and temporal_ranks(cfg, group.world) != group.world:
            raise ValueError(f"--temporal over {group.world} ranks needs every batch divisible "
                             f"by {group.world} (padding would break the consecutive-row loss)")
        # "lite": the decimated mesh (the same bones, keypoints and spheres;
        # only the synthetic raster sees fewer faces), engine.py:127-130.
        self.hand = (load_hand_model(device=self.device, lite=cfg.mesh == "lite")
                     if hand is None else hand)
        self.steps = build_steps(cfg, self.hand, device=self.device, group=group)
        # Initialised from a CPU generator: the same weights on every device
        # (under a group, rank 0's are broadcast and the ranks checked equal).
        self.state = self.steps.init_state(torch.Generator().manual_seed(cfg.seed + 1))
        self._gen = torch.Generator(device=self.device)
        self.starting_epoch = 0

        # Run directory (reference engine.py:102-117).
        if cfg.restore_from_model is not None:
            self.model_name = cfg.restore_from_model
            self.model_path = os.path.join(cfg.model_dir, self.model_name)
            self.load_checkpoint(cfg.restore_from_epoch)
        else:
            name = cfg.tag + _rand_name() if self.is_main else None
            self.model_name = name if group is None else group.broadcast_object(name)
            self.model_path = os.path.join(cfg.model_dir, self.model_name)
            if self.is_main:
                os.makedirs(self.model_path, exist_ok=True)
        self.log_file = os.path.join(self.model_path, "log.txt")
        self.metrics_file = os.path.join(self.model_path, "metrics.jsonl")
        self.image_dir = os.path.join(self.model_path, "images")
        if self.is_main:
            print(f"[engine] run dir: {self.model_path}")
            with open(os.path.join(self.model_path, "loss_weights.txt"), "w") as f:
                json.dump(LOSS_WEIGHTS, f)
            with open(os.path.join(self.model_path, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2)
            os.makedirs(self.image_dir, exist_ok=True)

        if cfg.initial_model is not None:
            self.load_checkpoint(cfg.initial_model, weights_only=True)
        if group is not None:
            self._log(f"[engine] data-parallel over {group.world} ranks ({group.backend}), "
                      f"rank 0 on {group.device}")
        if cfg.steps_per_call > 1:
            self._log(f"[engine] steps_per_call {cfg.steps_per_call}: runs as "
                      f"{cfg.steps_per_call} plain steps in a row, the same math as 1")

        # Real splits load lazily: synthetic-only runs need none.
        self._data: dict[bool, NyuDataset] = {}
        self._resident_data: dict[bool, dict | None] = {}
        # Steps per second of each epoch, by mode ("synt", "both", "real").
        self.steps_per_sec: dict[str, list[float]] = {}

    # ------------------------------------------------------------------ data
    def _split(self, train: bool) -> NyuDataset:
        if train not in self._data:
            subset = "train" if train else "test"
            self._data[train] = NyuDataset(os.path.join(self.cfg.dataset_dir, subset))
        return self._data[train]

    def index_plan(self, train: bool, batch_size: int, epoch: int = 0) -> list[np.ndarray]:
        """The epoch's batches as sample indices: shuffled by ``(seed,
        epoch)`` in training unless ``temporal`` (engine.py:326-327)."""
        shuffle = train and not self.cfg.temporal
        loader = NyuLoader(self._split(train), batch_size, shuffle, seed=self.cfg.seed,
                           epoch=epoch)
        return list(loader.iter_index_batches())

    def _resident(self, train: bool) -> dict | None:
        """The split held on the device, or None (the host loader's path).

        NYU at reference scale is ~3.5 GB and fits the card, so ``auto``
        uploads a split below ``device_data_max_gb`` once, shard by shard,
        and each step gathers its rows there by index: a step copies its
        index vector (~100 B) to the card instead of its batch (~1.2 MB)."""
        cfg = self.cfg
        if cfg.device_data == "off":
            return None
        if train in self._resident_data:
            return self._resident_data[train]
        ds = self._split(train)
        nbytes = sum(m.nbytes for m in ds.dms) + sum(
            a.nbytes for a in ds.joint_poses + ds.camera_poses + ds.inv_camera_poses)
        if nbytes > cfg.device_data_max_gb * 2**30:
            if cfg.device_data == "auto":
                self._resident_data[train] = None
                self._log(f"[engine] device_data auto: split is {nbytes / 2**30:.1f} GiB > "
                          f"{cfg.device_data_max_gb} GiB cap, using the host loader")
                return None
            self._log(f"[engine] device_data on: split is {nbytes / 2**30:.1f} GiB > the "
                      f"{cfg.device_data_max_gb} GiB auto cap, uploading anyway")

        def up(parts):
            on_dev = [torch.from_numpy(np.array(p)).to(self.device) for p in parts]
            return on_dev[0] if len(on_dev) == 1 else torch.cat(on_dev)

        t0 = time.time()
        arrays = {"dms": up(ds.dms), "joints": up(ds.joint_poses),
                  "poses": up(ds.camera_poses), "inv_poses": up(ds.inv_camera_poses)}
        self._resident_data[train] = arrays
        self._log(f"[engine] device-resident {'train' if train else 'test'} split: "
                  f"{nbytes / 2**20:.0f} MiB uploaded once in {time.time() - t0:.1f}s")
        return arrays

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _rank_rows(self, idx: np.ndarray) -> tuple[np.ndarray, torch.Tensor | None, int | None]:
        """This rank's sample indices of the global batch ``idx`` (padded to
        the rank count), their weights on the device and the global total."""
        if self.group is None:
            return idx, None, None
        rows = self.group.rows(len(idx))
        return idx[rows.index], self.group.weights_on_device(rows), rows.total

    def batches(self, train: bool, batch_size: int,
                epoch: int = 0) -> Iterator[tuple[np.ndarray, RealBatch]]:
        """The epoch's (global indices, this rank's batch on the device)
        pairs, from the host loader (a gather thread, pinned tensors,
        asynchronous copies) or from the device-resident split
        (``device_data``)."""
        plan = self.index_plan(train, batch_size, epoch)
        data = self._resident(train)
        if data is None:
            ds = self._split(train)
            gathered = ((idx, self._rank_rows(idx)) for idx in plan)
            hosted = ((idx, (w, total), [self._host_tensor(a) for a in ds.gather(rows)])
                      for idx, (rows, w, total) in gathered)
            for idx, (w, total), host in _prefetch(hosted):
                yield idx, RealBatch(*(t.to(self.device, non_blocking=True) for t in host),
                                     w, total)
        else:
            for idx in plan:
                rows, w, total = self._rank_rows(idx)
                rows = self._host_tensor(rows.astype(np.int64)).to(self.device, non_blocking=True)
                yield idx, RealBatch(data["dms"][rows], data["joints"][rows],
                                     data["poses"][rows], data["inv_poses"][rows], w, total)

    def step_draws(self, epoch: int, it: int, synt: bool = True, real: bool = True,
                   real_rows: int | None = None) -> StepDraws:
        """The draws of step ``it`` of ``epoch`` (see :func:`step_seed`)."""
        self._gen.manual_seed(step_seed(self.cfg.seed, epoch, it))
        return self.steps.draw(self._gen, synt=synt, real=real, real_rows=real_rows)

    # ------------------------------------------------------------- utilities
    def _log(self, text: str) -> None:
        if not self.is_main:
            return
        print(text)
        with open(self.log_file, "a") as f:
            f.write(text + "\n")

    def _log_metrics(self, record: dict) -> None:
        if not self.is_main:
            return
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    # ----------------------------------------------------------- checkpoints
    def _checkpoint_path(self, which: int) -> str:
        return os.path.join(self.model_path, f"model_{which}.pt")

    def save_checkpoint(self, which: int, epoch: int) -> None:
        """``model_{which}.pt``: the network and optimizer state, the step,
        the temporal-loss state and ``epoch``, the epoch it holds (the
        rolling latest is ``which`` = -1); ``model_{which}.meta.json``:
        ``{"epoch", "step"}``. Rank 0 writes; every rank waits for it."""
        if not self.is_main:
            self.group.barrier()
            return
        save_state(self._checkpoint_path(which), self.state, epoch)
        with open(os.path.join(self.model_path, f"model_{which}.meta.json"), "w") as f:
            json.dump({"epoch": epoch, "step": self.state.step}, f)
        if self.group is not None:
            self.group.barrier()

    def load_checkpoint(self, which: int | str, weights_only: bool = False) -> None:
        """int: that checkpoint of this run (full resume, from the epoch
        after the one it holds); str: a checkpoint file (weights only when
        ``weights_only``), as engine.py:446-460."""
        path = self._checkpoint_path(which) if isinstance(which, int) else which
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.state.network.load_state_dict(ckpt["network"])
        if weights_only:
            return
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        # Adam (not capturable) keeps its step counts on the CPU and reads
        # them there; on the card a count would cost a sync a parameter.
        for param_state in self.state.optimizer.state.values():
            param_state["step"] = param_state["step"].cpu()
        self.state.step = int(ckpt["step"])
        self.state.prev_skel = ckpt["prev_skel"]
        self.state.has_prev = ckpt["has_prev"]
        self.starting_epoch = int(ckpt["epoch"]) + 1

    # ---------------------------------------------------------------- epochs
    def combined_step(self, epoch: int, it: int, batch: RealBatch) -> tuple[dict, dict]:
        """Step ``it`` of a combined epoch: its draws, the epoch's learning
        rate and the curriculum's ``is_mv`` (engine.py:361)."""
        cfg = self.cfg
        self.state, metrics, vis = self.steps.combined_step(
            self.state, cfg.lr_at_epoch(epoch), self.step_draws(epoch, it), batch,
            it < cfg.mv_curriculum_iters)
        return metrics, vis

    def _epoch_synt(self, epoch: int) -> None:
        """Synthetic-only pretraining epoch (engine.py:265-316)."""
        cfg = self.cfg
        lr = cfg.lr_at_epoch(epoch)
        avg, timer = RunningAverage(), StepTimer(window=LOG_EVERY)
        metrics = None
        t0 = time.time()
        for it in range(cfg.synt_iters_per_epoch * cfg.num_stacks):
            self.state, metrics = self.steps.synt_step(
                self.state, lr, self.step_draws(epoch, it, real=False))
            avg.append(metrics)
            timer.tick(metrics["loss"])
            if it % LOG_EVERY == 0:
                means = avg.to_dict(it + 1)
                self._log(f"[{epoch}-{it}]: loss: {_fmt(means)} lr: {lr:.2e} "
                          f"time: {time.time() - t0:.2f}s")
                self._log_metrics({"epoch": epoch, "it": it, "mode": "synt", **means})
                t0 = time.time()
        self._close_rate("synt", timer, metrics)

    def _epoch_combined(self, epoch: int) -> None:
        """Mixed synthetic + real self-supervised epoch (engine.py:318-436)."""
        cfg = self.cfg
        lr = cfg.lr_at_epoch(epoch)
        avg, timer = RunningAverage(), StepTimer(window=LOG_EVERY)
        metrics = None
        t0 = time.time()
        for it, (_, batch) in enumerate(self.batches(True, cfg.real_batch, epoch)):
            metrics, vis = self.combined_step(epoch, it, batch)
            avg.append(metrics)
            timer.tick(metrics["loss"])  # syncs only at window edges
            if it % TRAIN_IMAGES_EVERY == 0:
                self._dump_train_images(epoch, it, vis)
            if it % LOG_EVERY == 0:
                means = avg.to_dict(it + 1)
                self._log(f"[{epoch}-{it}]: metric+loss: {_fmt(means)} lr: {lr:.2e} "
                          f"steps/s: {timer.steps_per_sec:.2f} time: {time.time() - t0:.2f}s")
                self._log_metrics({"epoch": epoch, "it": it, "mode": "both",
                                   "steps_per_sec": timer.steps_per_sec, **means})
                t0 = time.time()
        self._close_rate("both", timer, metrics)

    def _epoch_real_train(self, epoch: int) -> None:
        """Real-only self-supervised epoch at the eval batch (engine.py:150-263)."""
        cfg = self.cfg
        lr = cfg.lr_at_epoch(epoch)
        avg, timer = RunningAverage(), StepTimer(window=LOG_EVERY)
        metrics = None
        t0 = time.time()
        for it, (idx, batch) in enumerate(self.batches(True, cfg.eval_batch, epoch)):
            draws = self.step_draws(epoch, it, synt=False, real_rows=len(idx) * NUM_VIEWS)
            self.state, metrics, vis = self.steps.real_step(self.state, lr, draws, batch)
            avg.append(metrics)
            timer.tick(metrics["loss"])
            if it % LOG_EVERY == 0:
                self._dump_real_images(epoch, it, vis)
                means = avg.to_dict(it + 1)
                self._log(f"[{epoch}-{it}]: metric+loss: {_fmt(means)} lr: {lr:.2e} "
                          f"time: {time.time() - t0:.2f}s")
                self._log_metrics({"epoch": epoch, "it": it, "mode": "real", **means})
                t0 = time.time()
        self._close_rate("real", timer, metrics)

    def _close_rate(self, mode: str, timer: StepTimer, metrics: dict | None) -> None:
        sync = None if metrics is None else metrics["loss"]
        self.steps_per_sec.setdefault(mode, []).append(timer.finish(sync))

    def _dump_real_images(self, epoch: int, it: int, vis: dict) -> None:
        """Real-train-mode result grid every 100 its (reference
        engine.py:229-260)."""
        if not self.is_main:
            return
        try:
            img = viz.result_grid(
                _host(vis["real_dms"]).reshape(-1, 64, 64)[:6],
                _host(vis["real_uv_hms"]).reshape(-1, 41, 16, 16)[:6],
                _host(vis["real_xyz"]).reshape(-1, 41, 3)[:6],
            )
            viz.save_image(os.path.join(self.image_dir, f"Train_{epoch}_{it}.jpg"), img)
        except Exception as exc:  # visualization must never kill training
            self._log(f"[viz] dump failed: {exc!r}")

    def _dump_train_images(self, epoch: int, it: int, vis: dict) -> None:
        """Real + synthetic result grids (reference engine.py:386-434)."""
        if not self.is_main:
            return
        try:
            # hstack needs equal grid heights: cap all three panels to the
            # smaller of 6 / real rows / synt rows (tiny-batch runs).
            n = min(6, vis["synt_dms"].shape[0], int(np.prod(vis["real_dms"].shape[:-2])))
            synt_dms = _host(vis["synt_dms"])[:n]
            real = viz.result_grid(
                _host(vis["real_dms"]).reshape(-1, 64, 64)[:n],
                _host(vis["real_uv_hms"]).reshape(-1, 41, 16, 16)[:n],
                _host(vis["real_xyz"]).reshape(-1, 41, 3)[:n],
            )
            synt = viz.result_grid(synt_dms, _host(vis["synt_uv_hms"])[:n],
                                   _host(vis["synt_xyz"])[:n])
            gt = viz.result_grid(synt_dms, _host(vis["synt_gt_uv_hms"])[:n],
                                 _host(vis["synt_gt_xyz"])[:n])
            viz.save_image(os.path.join(self.image_dir, f"Train_{epoch}_{it}.jpg"),
                           np.hstack([real, synt, gt]))
        except Exception as exc:  # visualization must never kill training
            self._log(f"[viz] dump failed: {exc!r}")

    def _dump_eval_images(self, epoch: int, it: int, batch: RealBatch,
                          denoised: np.ndarray) -> None:
        if not self.is_main:
            return
        try:
            dms = _host(batch.dms[:, 0]) * _C.depth_scale
            img = viz.result_grid(dms, np.zeros((dms.shape[0], 41, 16, 16), np.float32),
                                  denoised, vis_indices=None)
            viz.save_image(os.path.join(self.image_dir, f"Eval_{epoch}_{it}.jpg"), img)
        except Exception as exc:  # visualization must never stop an eval
            self._log(f"[viz] dump failed: {exc!r}")

    def _epoch_real_eval(self, epoch: int, dump_images: bool = False) -> dict[str, float]:
        """Eval over the test split: the step's losses and the denoised
        view-0 joint error, and ``result.npz`` with ``gt`` (N, 36, 3, view
        0) and ``est`` (N, 41, 3, denoised) for the offline evaluator.
        Under a group, rank 0 gathers the ranks' joints in the global order
        and drops the pad rows; it alone writes the file."""
        cfg = self.cfg
        ds = self._split(train=False)
        avg = RunningAverage()
        all_gt, all_est = [], []
        for it, (idx, batch) in enumerate(self.batches(False, cfg.eval_batch)):
            draws = self.step_draws(epoch, it, synt=False, real_rows=len(idx) * NUM_VIEWS)
            metrics, denoised = self.steps.eval_step(self.state, draws, batch)
            avg.append(metrics)
            est = _host(denoised)
            if dump_images and it % LOG_EVERY == 0:
                self._dump_eval_images(epoch, it, batch, est)
            if self.group is not None:
                parts = self.group.gather_objects(est)
                est = None if parts is None else np.concatenate(parts)[:len(idx)]
            if self.is_main:
                all_gt.append(ds.gather_joints(idx)[:, 0])  # host memmap, no device copy
                all_est.append(est)
        result = avg.to_dict()
        self._log(f"[eval epoch {epoch}]: {_fmt(result)}")
        self._log_metrics({"epoch": epoch, "mode": "eval", **result})
        if self.is_main:
            np.savez_compressed(os.path.join(self.model_path, "result.npz"),
                                gt=np.concatenate(all_gt), est=np.concatenate(all_est))
        return result

    # ------------------------------------------------------------ public API
    def train(self) -> None:
        cfg = self.cfg
        for epoch in range(self.starting_epoch, cfg.epoch):
            if cfg.with_real and cfg.synthesize:
                self._epoch_combined(epoch)
            elif cfg.synthesize:
                self._epoch_synt(epoch)
            elif cfg.with_real:
                self._epoch_real_train(epoch)
            self.save_checkpoint(-1, epoch)
            self.save_checkpoint(epoch, epoch)

    def eval(self) -> dict[str, float]:
        return self._epoch_real_eval(0, dump_images=True)


def _host(t: Any) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
