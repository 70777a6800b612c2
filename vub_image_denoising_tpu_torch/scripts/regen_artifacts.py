"""The manifest of the port's artifacts of record, and their regeneration.

Counterpart of ``scripts/regen_artifacts.py``, for what the port's scripts
write: the accuracy protocol's checkpoints (``runs/torch_accuracy_ckpt*``),
the diffusion-gap and GAN protocol checkpoints, the searches' CSVs and
the comparative suite's directories.  Every entry of the repo's manifest
but ``serve_sweep`` (a benchmark's) has one here, under its name or, for
the searches, without the ``_tpu``.  Each entry names the artifact, the liveness
marker that a finished run leaves, the command that writes it, its minutes
of training where a card run measured them, and the record it backs.

    python -m vub_image_denoising_tpu_torch.scripts.regen_artifacts --check
    python -m vub_image_denoising_tpu_torch.scripts.regen_artifacts --regen all
    python -m vub_image_denoising_tpu_torch.scripts.regen_artifacts --regen s25 --force

Liveness is the marker, not the directory: a cut run leaves its directory
(and a ``mid_*`` checkpoint, which no marker matches) behind, and
``--regen all`` must not skip it.  ``--regen`` runs the entries in turn
(they share one card), skips live ones unless ``--force``, and stops at the
first that fails.  Paths are relative to ``--root`` (default: the current
directory), where the commands run.
"""

import argparse
import glob
import json
import os
import shlex
import signal
import subprocess
import sys
import time

PKG = "python -m vub_image_denoising_tpu_torch.scripts."
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# the wall seconds a run may take so that it ends inside one chip call
CALL_BUDGET_S = 3000
PROTOCOL = ("--batch-size 128 --n-train 2048 --sched-steps-per-epoch 300 --device-data "
            "--eval-every 20")

# (name, artifact, liveness marker glob, command, minutes, record it backs)
MANIFEST = [
    ("s25", "runs/torch_accuracy_ckpt_s25",
     "runs/torch_accuracy_ckpt_s25/rdunet_denoising.pth",
     PKG + "train_accuracy --epochs 150 --batch-size 128 --lr 3e-4 "
     "--sched-steps-per-epoch 100 --device-data --ckpt-dir runs/torch_accuracy_ckpt_s25",
     f"6.2 min of training (600 steps, 373.9 s on an {CARD}; PERF.md §5)",
     "PERF.md, the accuracy protocol: RDUNet-32 supervised sigma = 25, 31.88 dB"),
    ("blind", "runs/torch_accuracy_ckpt",
     "runs/torch_accuracy_ckpt/rdunet_denoising.pth",
     PKG + "train_accuracy --epochs 150 --batch-size 128 --lr 3e-4 "
     "--sched-steps-per-epoch 100 --device-data --sigma-list 10,20,30,40,50 "
     "--ckpt-dir runs/torch_accuracy_ckpt",
     f"6.4 min of training (600 steps, 384.8 s on an {CARD}; PERF.md §6)",
     "PERF.md, the accuracy protocol: RDUNet-32 supervised blind, 31.03 dB"),
    ("flagship", "runs/torch_accuracy_ckpt_flagship",
     "runs/torch_accuracy_ckpt_flagship/rdunet_denoising.pth",
     PKG + "train_accuracy --base-filters 128 --epochs 150 --batch-size 8 --remat false "
     "--device-data --ckpt-dir runs/torch_accuracy_ckpt_flagship",
     f"40.7 min of training (9600 steps, 2444.3 s on an {CARD}; PERF.md §5)",
     "PERF.md, the accuracy protocol: RDUNet-128 flagship sigma = 25, 33.19 dB at the "
     "default lr 1e-4 (the JAX package's 37.14 does not reproduce from this command: "
     "ROADMAP.md, deliberate differences)"),
    ("flagship_blind", "runs/torch_accuracy_ckpt_flagship_blind",
     "runs/torch_accuracy_ckpt_flagship_blind/rdunet_denoising.pth",
     PKG + "train_accuracy --base-filters 128 --epochs 150 --batch-size 8 --remat false "
     "--device-data --sigma-list 10,20,30,40,50 --ckpt-dir runs/torch_accuracy_ckpt_flagship_blind",
     f"42.0 min of training (9600 steps, 2520.0 s on an {CARD}; with --epochs 50, 3200 "
     "steps in 929.8 s to the same 32.43 dB; PERF.md §6)",
     "PERF.md, the accuracy protocol: RDUNet-128 flagship blind, 32.43 dB mean (the JAX "
     "package's 36.93 does not reproduce from this command either)"),
    ("diffusion", "runs/torch_accuracy_ckpt_diffusion",
     "runs/torch_accuracy_ckpt_diffusion/diffusion_RDUNet_model_checkpointed_epoch_*.pth",
     PKG + "train_accuracy --algo diffusion --epochs 200 --batch-size 128 --n-train 2048 "
     "--lr 2e-4 --sched-steps-per-epoch 300 --device-data "
     "--ckpt-dir runs/torch_accuracy_ckpt_diffusion",
     f"29.0 min of training (3200 steps, 1739.1 and 1735.2 s on an {CARD}; PERF.md §5)",
     "PERF.md, the accuracy protocol: RDUNetT-32 diffusion (T = 20) at 3200 steps, 29.49 dB"),
    ("gan_attention", "runs/torch_accuracy_ckpt_gan_attention",
     "runs/torch_accuracy_ckpt_gan_attention/*_generator_*.pth",
     PKG + "train_gan_accuracy --algo attention --epochs 40",
     f"0.6 min of training (640 rounds, 37.2 s on an {CARD}; PERF.md §5)",
     "PERF.md, the accuracy protocol: attention GAN best 29.69 dB"),
    ("gap_stage1", "runs/torch_gap_*",
     "runs/torch_gap_ssim_biased/diffusion_RDUNet_model_checkpointed_epoch_*.pth",
     PKG + "run_diffusion_gap",
     "66.3 min of command in two calls through --only (2203.1 and 1777.5 s on an "
     f"{CARD}, the build and the 2048 + 64-image cache once a call): 640 steps a "
     "configuration, 0.5375 s a step at base 32, gap-bf64 1.156 s, 800.6 s of training; "
     "PERF.md §6",
     "the diffusion-gap grid: eight rows gap-* of runs/torch_accuracy_log.jsonl"),
    # the composed configuration as the repo's record trained it (SSIM 0.3 and
    # the biased t over the then-partial stage-1 grid), pinned: re-composing
    # over the whole grid would adopt gap-lr4 too and train another artifact,
    # which is gap_stage3
    ("gap_stage2", "runs/torch_gap_stage2",
     "runs/torch_gap_stage2/diffusion_RDUNet_model_checkpointed_epoch_*.pth",
     PKG + "train_accuracy --algo diffusion --epochs 200 " + PROTOCOL + " --lr 2e-4 "
     "--loss-weights 0,1,0.3 --t-dist biased --tag gap-stage2 --ckpt-dir runs/torch_gap_stage2",
     f"32.4 min of training (3200 steps, 1944.0 and 1858.2 s on an {CARD}; PERF.md §6)",
     "the diffusion-gap stage 2: the pinned composed configuration at 200 epochs, 30.21 dB"),
    # the budget is one chip call's (60 min, with the kernels' build and the
    # 2048-image cache inside it): the repo's 9000 s was its TPU queue's
    # window, and a run longer than a call is lost with the machine
    ("gap_stage3", "runs/torch_gap_stage3",
     "runs/torch_gap_stage3/diffusion_RDUNet_model_checkpointed_epoch_*.pth",
     PKG + "run_diffusion_gap_stage2 --tag gap-stage3 --ckpt-dir runs/torch_gap_stage3 "
     "--budget-s " + str(CALL_BUDGET_S),
     "not run; about 34 min of training projected at 100 epochs (gap-bf64's 1.156 s a step "
     f"with the SSIM term's 6.4% on an {CARD}) once gap-base is re-run: over the committed "
     "grid, whose gap-base row carries the kernels' build, it would run 200 epochs uncapped, "
     "about 67 min (ROADMAP.md queue 1)",
     "the diffusion-gap stage 3: the winner re-composed over the whole gap_stage1 grid, "
     "lr 4e-4, biased t, SSIM 0.3 and base 64 at T = 20"),
    ("rca_promoted", "runs/torch_accuracy_ckpt_rca_promoted",
     "runs/torch_accuracy_ckpt_rca_promoted/checkpoint_epoch_*.pth",
     PKG + "train_gan_accuracy --algo rca --lam-feat 0.05 --lam-content 100 "
     "--lam-texture 0.001 --lam-adv 1 --adv-ramp-steps 2560 --size 128 --n-train 2048 "
     "--n-val 64 --batch-size 16 --epochs 60 --eval-every 5 --tag rca-promoted "
     "--ckpt-dir runs/torch_accuracy_ckpt_rca_promoted",
     "not run whole; about 19 min of training projected (an epoch of 128 rounds, its "
     f"evaluation included, in 19.2 s on an {CARD}; PERF.md §6)",
     "RCA-GAN at the content-anchored G objective, 128^2, 2048 images"),
    ("hybrid_anchored", "runs/torch_accuracy_ckpt_hybrid_anchored",
     "runs/torch_accuracy_ckpt_hybrid_anchored/checkpoint_epoch_*.pth",
     PKG + "train_gan_accuracy --algo hybrid --lam-feat 0.05 --lam-content 100 "
     "--lam-texture 0.001 --lam-adv 1 --adv-ramp-steps 320 --epochs 40 --eval-every 5 "
     "--tag c17-anchored --ckpt-dir runs/torch_accuracy_ckpt_hybrid_anchored",
     f"1.2 min of training (640 rounds, 73.2 s on an {CARD}; PERF.md §6)",
     "the diffusion-GAN hybrid at the content-anchored G objective, best 19.33 dB"),
    ("comparative", "runs/torch_comparative", "runs/torch_comparative/summary.json",
     PKG + "run_comparative_suite --unet-ckpt runs/torch_accuracy_ckpt/rdunet_denoising.pth "
     "--diffusion-ckpt runs/torch_accuracy_ckpt_diffusion/"
     "diffusion_RDUNet_model_checkpointed_epoch_200.pth --epoch-label 200 "
     "--save-dir runs/torch_comparative",
     f"2.2 min (133.5 s of runner, BM3D 4.3 s an image on the host, on an {CARD}; "
     "PERF.md §6)",
     "the comparative suite on the blind and diffusion checkpoints (needs both): "
     "runs/torch_comparative_summary.json"),
    ("comparative_flagship", "runs/torch_comparative_flagship",
     "runs/torch_comparative_flagship/summary.json",
     PKG + "run_comparative_suite "
     "--unet-ckpt runs/torch_accuracy_ckpt_flagship_blind/rdunet_denoising.pth "
     "--unet-base-filters 128 --diffusion-ckpt "
     "runs/torch_gap_stage2/diffusion_RDUNet_model_checkpointed_epoch_200.pth "
     "--epoch-label 200 --save-dir runs/torch_comparative_flagship",
     "about 2.1 min (19.6 s of runner with --no-bm3d, and BM3D's 25 images at 4.3 s "
     f"as in the comparative entry, on an {CARD}; PERF.md §6)",
     "the comparative suite on the flagship blind and gap_stage2 checkpoints (needs both): "
     "runs/torch_comparative_flagship_summary.json"),
    ("search", "runs/torch_trial_results.csv", "runs/torch_trial_results.csv.study.json",
     PKG + "run_search --trials 4 --epochs 2",
     f"1.1 min (the study's 66 s on an {CARD}; PERF.md §6)", "the C13 search, the 4-trial demo"),
    ("search_ref_scale", "runs/torch_trial_results_ref_scale.csv",
     # the sidecar is written when the study completes: a killed study's
     # partial CSV reads as missing
     "runs/torch_trial_results_ref_scale.csv.study.json",
     PKG + "run_search --trials 25 --epochs 5 --size 256 --n-train 256 --n-val 16 "
     "--batch-size 16 --engine xla --bf16 --csv runs/torch_trial_results_ref_scale.csv",
     "not run whole; at most 16 min projected (a base-64 trial, the space's widest, in "
     f"37.3 s on an {CARD}; PERF.md §6)",
     "the C13 search at the reference's scale; c13_winner reads it"),
    ("gan_search", "runs/torch_gan_trial_results.csv", "runs/torch_gan_trial_results.csv",
     PKG + "run_gan_search --trials 8 --epochs 5",
     f"0.5 min (the study's 32 s on an {CARD}; PERF.md §6)", "the C16 GAN search"),
]


def live(marker, root="."):
    return bool(glob.glob(os.path.join(root, marker)))


def check(root="."):
    """Print each entry as live or missing (by its marker) and a JSON
    summary; returns the rows."""
    rows = [{"name": name, "artifact": artifact, "live": live(marker, root), "minutes": minutes,
             "record": record}
            for name, artifact, marker, _, minutes, record in MANIFEST]
    width = max(len(r["name"]) for r in rows)
    for r in rows:
        print(f"{'live   ' if r['live'] else 'MISSING'}  {r['name']:<{width}}  {r['artifact']}  "
              f"({r['minutes']})")
    missing = [r["name"] for r in rows if not r["live"]]
    print(json.dumps({"live": len(rows) - len(missing), "missing": missing}))
    return rows


def regen(names, force=False, root="."):
    """Run the named entries' commands (``["all"]``: every entry) in turn in
    ``root``; exits with the first failing command's code.  SIGTERM is
    passed on to the running child before this process exits."""
    known = [e[0] for e in MANIFEST]
    unknown = [n for n in names if n != "all" and n not in known]
    todo = [e for e in MANIFEST if "all" in names or e[0] in names]
    if unknown or not todo:
        sys.exit(f"no manifest entries named {unknown or names}; known: {known}")
    child = {"proc": None}

    def forward(signum, frame):
        p = child["proc"]
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        sys.exit(143)

    previous = signal.signal(signal.SIGTERM, forward)
    try:
        for name, artifact, marker, cmd, minutes, _ in todo:
            if live(marker, root) and not force:
                print(f"[skip] {name}: {artifact} is live (--force rebuilds it)")
                continue
            print(f"[regen] {name}: {cmd}  ({minutes})", flush=True)
            t0 = time.time()
            argv = shlex.split(cmd)
            child["proc"] = subprocess.Popen([sys.executable, *argv[1:]], cwd=root)
            rc = child["proc"].wait()
            child["proc"] = None
            print(f"[regen] {name}: rc={rc} in {time.time() - t0:.0f}s", flush=True)
            if rc != 0:
                sys.exit(rc)
    finally:
        signal.signal(signal.SIGTERM, previous)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="list the artifacts' state (default)")
    ap.add_argument("--regen", nargs="+", metavar="NAME",
                    help="rebuild the named artifacts (or 'all')")
    ap.add_argument("--force", action="store_true", help="rebuild live ones too")
    ap.add_argument("--root", default=".", help="the directory that holds runs/")
    args = ap.parse_args(argv)
    if args.regen:
        regen(args.regen, force=args.force, root=args.root)
    else:
        check(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
