"""Inference and evaluation entry points: the denoising CLI, the HTTP server,
the metrics, and SIDD validation with the Kaggle submission."""
