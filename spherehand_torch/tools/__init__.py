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
  reference_recipe         the stock recipe (lr 1e-3, 75 epochs) on pseudo-NYU at
                           reference scale, resumable; its trajectory of evals
  recipe_artifact          the stock and companion runs -> the port's record
  divergence_study         what drives the stock recipe's divergence: per-term
                           gradients, lr probes, term ablations, the is_mv window

The tools that write a run's result (``selfsup_demo``, ``lite_mesh_e2e``,
``measure_wobble``, ``reference_recipe``, ``recipe_artifact``,
``divergence_study``) switch the process to deterministic algorithms first
(``utils.determinism``), and so do ``train_synthetic_full``,
``eval_synthetic`` and ``pole_study``. The run-level tools print the port's
kernel launch counters (:func:`launch_counts`) as a JSON line. No tool writes a JAX record:
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


def launch_counts() -> dict[str, int]:
    """The port's kernel launch counters, by kernel."""
    from spherehand_torch.ops import upsample
    from spherehand_torch.render import raster_cuda, sphere_cuda
    return {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES, **upsample.LAUNCHES}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The kernels launched since ``before`` (a :func:`launch_counts`), and
    how often; the counters themselves are left as they are."""
    return {k: n - before.get(k, 0) for k, n in launch_counts().items() if n != before.get(k, 0)}
