"""Neural models: stacked hourglass CNN, pose denoiser, estimator forward."""
