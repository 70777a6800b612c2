"""Command-line runs of the port, counterparts of the repo's ``scripts/``
under the same names without ``_tpu``: the accuracy protocol
(``train_accuracy``), the GAN accuracy runs (``train_gan_accuracy``), the
comparative runner over trained checkpoints (``run_comparative_suite``),
SIDD evaluation per engine on synthetic blocks (``measure_sidd_eval``), the
searches (``run_search``, ``run_gan_search``), the search winner's
retrain command (``c13_winner``), the diffusion quality-gap sweep and its
promotion (``run_diffusion_gap``, ``run_diffusion_gap_stage2``), the
RCA-GAN grids (``run_rca_ablation``, ``run_rca_balance``; ``sweep`` runs
their grids), the artifact manifest (``regen_artifacts``) and the
training job launcher (``job``, the counterpart of ``tpu_job.sh``).  Each
is run as
``python -m vub_image_denoising_tpu_torch.scripts.<name>`` and imports
torch, never JAX."""
