"""spherehand_torch — the PyTorch + CUDA port of ``spherehand_tpu``.

Same layer layout as the JAX package, so each counterpart is easy to find:

  hand/        assets (full and lite mesh, PCA prior) + forward kinematics +
               linear blend skinning + skeleton-only FK
  data/        pose sampler, depth noise, synthetic batch generator, the NYU
               shards (offline crop pipeline, memmap loader, native binding)
  render/      triangle z-buffer (plain PyTorch + hand-written CUDA kernels
               in ``csrc/``), Gaussian joint heatmaps
  models/      hourglass CNN (float32 or bfloat16 convolutions), pose VAE and
               denoiser, estimator forward
  losses/      the multi-task loss stack, the PCA pose prior
  ops/         soft-argmax 3D recovery, joint-guided segmentation
  evaluation/  joint-error metrics, palm-pose adjustment, the offline evaluator
  train/       steps, engine (epochs, checkpoints, eval), config, CLI, the
               offline prior trainers
  utils/       step timing and tracing
  parallel/    data parallelism: rank groups, the zero-weight pad plan, the
               summed gradients; N ranks checked against one device
  tools/       the evidence path, one module a JAX tool of the same name:
               ``.pth`` import, parity drill, synthetic pretraining and
               held-out eval, lite against full, the self-supervision demo
  infer.py     ``PoseEstimator`` and ``load_estimator``, the serving surface
               (over several devices with ``devices=``)
  convert.py   carries the JAX package's weights across
  bench.py     ``python -m spherehand_torch.bench``: the one-line benchmark
  doctor.py    ``python -m spherehand_torch.doctor``: PASS/FAIL by layer

``python -m spherehand_torch`` trains and evaluates (``train/cli.py``).
Entry points default to ``torch.device("cuda")`` and raise on a machine
without a GPU; tests pass ``device="cpu"`` and run the plain PyTorch path.
Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from spherehand_torch.constants import Constants  # noqa: F401
