"""Engine configuration: one dataclass, the fields of the CLI.

Counterpart of ``spherehand_tpu/train/config.py`` (reference
network/run_engine.py:9-31 flags, engine.py batch geometry): the same
fields with the same defaults. ``data_parallel`` trains over every card of
the host, one rank each (``parallel.mesh.rank_plan``, the CLI).
"""
from __future__ import annotations

import dataclasses

from spherehand_torch.losses.multitask import LossConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Loss toggles (run_engine.py:10-16; default-on except temporal).
    synthesize: bool = True
    mv_projection: bool = True
    mv_consistency: bool = True
    temporal: bool = False
    collision: bool = True
    bone_length: bool = True
    prior: bool = True

    # Run control (run_engine.py:17-30).
    mode: str = "Test"  # "Train" | "Test"
    model_dir: str = "runs"
    initial_model: str | None = None  # a checkpoint file: weights only
    restore_from_model: str | None = None  # a run name under model_dir: full resume
    restore_from_epoch: int = -1  # -1 = the rolling latest checkpoint
    num_stacks: int = 1
    epoch: int = 75
    dataset_dir: str = "data/nyu/npy-64"
    depth_resample: int = 0  # 0 = off, else the Gaussian kernel size, 3 or 5
    lr: float = 1e-3
    tag: str = ""

    # Batch geometry (engine.py:271-272,326-330).
    real_batch: int = 25
    synt_batch: int = 48
    eval_batch: int = 8
    synt_iters_per_epoch: int = 1000  # x num_stacks (engine.py:280)
    mv_curriculum_iters: int = 1500  # is_mv window per epoch (engine.py:361)

    seed: int = 0
    weight_decay: float = 1e-5
    data_parallel: bool = True  # one rank per card (the CLI); False: one card
    bf16: bool = False  # bfloat16 convolutions (parameters and losses float32)
    mesh: str = "full"  # "full" | "lite" (the decimated mesh for synthetic renders)
    # "default": PyTorch's float32 defaults in the eval step (cuDNN may use
    # TF32 on the GPU); "highest": TF32 off, batch-invariant eval numbers.
    eval_precision: str = "default"
    # Combined-epoch steps a call: K > 1 runs K plain steps in a row, the
    # same math as 1 (the JAX package scans K steps in one dispatch).
    steps_per_call: int = 1
    # "auto" | "on" | "off": hold each real split on the device (uploaded
    # once) and gather every batch there by index; batches equal the host
    # loader's bit for bit. "auto" = on when the split fits
    # device_data_max_gb.
    device_data: str = "auto"
    device_data_max_gb: float = 6.0

    @property
    def loss_config(self) -> LossConfig:
        return LossConfig(
            synthesized=self.synthesize,
            mv_projection=self.mv_projection,
            mv_consistency=self.mv_consistency,
            temporal=self.temporal,
            prior=self.prior,
            collision=self.collision,
            bone_length=self.bone_length,
        )

    @property
    def with_real(self) -> bool:
        """Any real-data loss enabled (engine.py:138-139)."""
        return any([self.mv_projection, self.mv_consistency, self.temporal, self.prior,
                    self.collision, self.bone_length])

    def lr_at_epoch(self, epoch: int) -> float:
        """StepLR: x0.1 every epoch // 3 epochs (engine.py:98-99)."""
        step_size = max(self.epoch // 3, 1)
        return self.lr * (0.1 ** (epoch // step_size))

