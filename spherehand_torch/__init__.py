"""spherehand_torch — the PyTorch + CUDA port of ``spherehand_tpu``.

Same layer layout as the JAX package, so each counterpart is easy to find:

  hand/        assets + forward kinematics + linear blend skinning
  data/        pose sampler, depth noise, synthetic batch generator
  render/      triangle z-buffer (plain PyTorch + hand-written CUDA kernels
               in ``csrc/``), Gaussian joint heatmaps
  models/      hourglass CNN, pose denoiser, estimator forward
  ops/         soft-argmax 3D recovery
  evaluation/  joint-error metrics, palm-pose adjustment
  infer.py     ``PoseEstimator``, the serving surface
  convert.py   carries the JAX package's weights across

Entry points default to ``torch.device("cuda")`` and raise on a machine
without a GPU; tests pass ``device="cpu"`` and run the plain PyTorch path.
Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from spherehand_torch.constants import Constants  # noqa: F401
