"""Engine configuration: the fields the train and eval steps read.

Counterpart of ``spherehand_tpu/train/config.py`` (reference
network/run_engine.py:9-31 flags, engine.py batch geometry). The engine's
run-control and data-path fields arrive with the engine.
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

    num_stacks: int = 1
    epoch: int = 75
    lr: float = 1e-3
    weight_decay: float = 1e-5

    # Batch geometry (engine.py:271-272,326-330).
    real_batch: int = 25
    synt_batch: int = 48

    # "default": PyTorch's float32 defaults in the eval step (cuDNN may use
    # TF32 on the GPU); "highest": TF32 off, batch-invariant eval numbers.
    eval_precision: str = "default"

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
