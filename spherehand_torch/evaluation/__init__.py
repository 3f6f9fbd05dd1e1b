"""Evaluation: joint-error metrics, palm-pose adjustment."""
