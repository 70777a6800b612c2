"""The training job launcher: the diffusion trainer, the search, or the
supervised preset, on the card.

Counterpart of ``scripts/tpu_job.sh`` (itself the reference's SLURM job,
job.ssh:1-22):

    python -m vub_image_denoising_tpu_torch.scripts.job [diffusion|search|supervised] [args...]

- ``diffusion`` (the default): ``train.diffusion.main(args)``, the CLI;
- ``search``: the diffusion CLI's flags pick the data
  (``train.diffusion.load_data_for``), then ``run_search(n_trials=50,
  num_epochs=5)``;
- ``supervised``: ``train.presets.rdunet_supervised_main(image_folder)``.

Under torchrun (``WORLD_SIZE`` set) every rank joins the group
(``parallel.mesh.init_distributed``: nccl with a card per rank, gloo with
``--device cpu``) and the loaders fetch the rank's rows.  An unknown task
exits with code 2.
"""

import os
import sys

def _join(device):
    from ..parallel.mesh import init_distributed

    if "WORLD_SIZE" in os.environ:
        init_distributed("gloo" if str(device) == "cpu" else "nccl")


def diffusion(argv):
    from ..train.diffusion import main

    return main(argv)


def search(argv):
    from ..parallel.mesh import make_mesh
    from ..search.hyperparams import run_search
    from ..train.diffusion import build_arg_parser, load_data_for
    from ..utils.device import resolve_device

    args = build_arg_parser().parse_args(argv)
    _join(args.device)
    device = resolve_device(args.device)
    train_loader, val_loader = load_data_for(args, device=device, mesh=make_mesh(device=device))
    return run_search(train_loader, val_loader, n_trials=50, num_epochs=5,
                      trainer_kwargs={"device": device})


def supervised(argv):
    from ..train.presets import rdunet_supervised_main

    if len(argv) != 1:
        sys.exit("usage: job supervised <image_folder>")
    _join("cuda")
    return rdunet_supervised_main(argv[0])


TASKS = {"diffusion": diffusion, "search": search, "supervised": supervised}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    task, rest = (argv[0], argv[1:]) if argv else ("diffusion", [])
    if task not in TASKS:
        print(f"unknown task: {task} (expected {'|'.join(TASKS)})", file=sys.stderr)
        return 2
    TASKS[task](rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
