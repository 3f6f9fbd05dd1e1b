"""The evidence path: one module per workflow tool of the JAX package's
``tools/``, under the same name, each runnable as ``python -m
spherehand_torch.tools.<name>`` (CUDA by default, ``--device cpu`` for the
plain path).

  import_torch_checkpoint  a reference ``.pth`` -> the flat flax ``.npz``
  parity_eval              ``.pth`` or ``.npz`` -> eval over NYU shards ->
                           ``result.npz``, the offline evaluator, ``parity.json``
  train_synthetic_full     N synthetic steps at the StepLR thirds, a checkpoint,
                           the flat ``.npz`` and ``history.json``
  eval_synthetic           held-out noisy renders -> per-joint errors and the
                           max-error curve (``synthetic_eval.npz``)
  lite_mesh_e2e            train on the lite or full mesh, evaluate on full
  selfsup_demo             sensor-shifted pseudo-NYU shards, then the engine's
                           combined loop with no ground truth in any loss
  pole_study               the pole pixels of a pseudo-NYU draw, and the
                           adaptation without the samples that hold them
  measure_wobble           joints of one B = 1024 forward against eight of
                           B = 128, TF32 on and off, and what TF32 off costs
  make_lite_mesh           weld + QEM decimation of the full mesh into the
                           lite mesh's schema (``_qem_decimate``)
  inspect_model            the keypoint table, a 3D scatter, a synthetic-
                           against-NYU overlay
  interactive_viewer       pose sliders over the sphere and triangle renders

The tools that write a run's result (``selfsup_demo``, ``lite_mesh_e2e``,
``measure_wobble``) switch the process to deterministic algorithms first
(``utils.determinism``), and so do ``train_synthetic_full``,
``eval_synthetic`` and ``pole_study``. No tool writes a JAX record:
:func:`refuse_golden` refuses every file under ``tests/goldens/`` whose
name does not start with ``torch_``.
"""
from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDENS = os.path.join(ROOT, "tests", "goldens")


def refuse_golden(path: str) -> None:
    """Raise ValueError if ``path`` is a JAX record: a file under
    ``tests/goldens/`` not named ``torch_*``."""
    real, goldens = os.path.realpath(path), os.path.realpath(GOLDENS)
    if (os.path.commonpath([real, goldens]) == goldens
            and not os.path.basename(real).startswith("torch_")):
        raise ValueError(f"refusing to write {path}: tests/goldens/ holds the JAX package's "
                         "records; a port artifact is tests/goldens/torch_*.json")
