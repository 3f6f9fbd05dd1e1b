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
"""
