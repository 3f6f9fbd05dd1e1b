"""Heatmap post-processing ops: spatial softmax, soft-argmax 3D recovery."""
