"""Command-line runs of the port, counterparts of the repo's ``scripts/``
under the same names without ``_tpu``: the accuracy protocol
(``train_accuracy``), the GAN accuracy runs (``train_gan_accuracy``) and
the comparative runner over trained checkpoints (``run_comparative_suite``).
Each is run as ``python -m vub_image_denoising_tpu_torch.scripts.<name>``
and imports torch, never JAX."""
