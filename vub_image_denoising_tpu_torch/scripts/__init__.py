"""Command-line runs of the port, counterparts of the repo's ``scripts/``
under the same names without ``_tpu``: the accuracy protocol
(``train_accuracy``), the GAN accuracy runs (``train_gan_accuracy``), the
comparative runner over trained checkpoints (``run_comparative_suite``),
SIDD evaluation per engine on synthetic blocks (``measure_sidd_eval``), the
searches (``run_search``, ``run_gan_search``) and the search winner's
retrain command (``c13_winner``).  Each is run as
``python -m vub_image_denoising_tpu_torch.scripts.<name>`` and imports
torch, never JAX."""
