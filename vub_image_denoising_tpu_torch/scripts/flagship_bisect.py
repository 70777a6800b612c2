"""Bisect the flagship protocol on the card: where does RDUNet-128 lose accuracy?

The manifest's ``flagship`` command (``regen_artifacts``: RDUNet(3, 128),
8 x 256^2, accumulation 4, bf16, StepLR(3, 0.5) on the bank's 64-step
epoch) is held apart along the axes that change with base 128:

1. ``step``: each engine's bf16 step on one batch of the flagship's shape,
   ms (mean of TIMED after WARMUP) and peak GiB, one engine at a time.
2. ``trajectory``: RDUNet(128) from one init, the same device-bank batches,
   TRAJ_STEPS protocol steps with the blocks of chosen widths through
   kernel 1 (the module path, ``"flax"``) and the others as the eager block
   (cuDNN convs, ``"xla"``'s block): all eager, all kernel, and each width
   alone in bf16; all eager and all kernel in f32 (TF32 off).  Prints each
   variant's losses and its parameter updates against the all-eager run's,
   per block width.
3. ``runs``: the manifest's command cut to RUN_CUT (1600 steps, where the
   recorded run's PSNR stops moving, with an evaluation every 5 epochs),
   once per engine (``--engine flax``, ``xla``, ``pallas``), one process
   each, started together on the one card while phase 2 runs.  Each writes
   its row to ``<out-dir>/rows_<engine>.jsonl`` and its log to
   ``<out-dir>/<engine>.log``.
4. ``score``: the ``"flax"`` run's checkpoint scored on the held-out pairs
   through the eager engine in f32 (TF32 off) and in bf16, and through the
   module path (kernel 1) in bf16, the training run's own evaluation.

    python -m vub_image_denoising_tpu_torch.scripts.flagship_bisect --out-dir <dir>

Every phase runs, on the card.  The summary goes to
``<out-dir>/summary.json`` and is printed last.
"""

import argparse
import json
import os
import shlex
import subprocess
import sys
import time
import types

import numpy as np

ENGINES = ("flax", "xla", "pallas")
RUN_CUT = ["--epochs", "25", "--eval-every", "5"]
WARMUP, TIMED = 2, 6
TRAJ_STEPS = 20
MODULE = "vub_image_denoising_tpu_torch.scripts.train_accuracy"


def flagship_flags():
    """The manifest's ``flagship`` flags (after ``python -m <module>``), then
    RUN_CUT's (argparse keeps the last of a repeated flag)."""
    from . import regen_artifacts

    command = shlex.split(dict((e[0], e[3]) for e in regen_artifacts.MANIFEST)["flagship"])
    if command[2] != MODULE:
        raise SystemExit(f"the manifest's flagship entry runs {command[2]}")
    return command[3:] + RUN_CUT


def block_width(block):
    return block.conv_0.weight.shape[1]


def eager_blocks(model, kernel_widths):
    """Run each DenoisingBlock of ``model`` whose width is not in
    ``kernel_widths`` as the eager block; the others keep their forward
    (kernel 1, trained through ``fused_block_trainable``)."""
    from ..models.fused_apply import _dense_block_xla
    from ..nn.blocks import DenoisingBlock

    def eager(self, x):
        return _dense_block_xla(dict(self.named_parameters()), x)

    for m in model.modules():
        if isinstance(m, DenoisingBlock) and block_width(m) not in kernel_widths:
            m.forward = types.MethodType(eager, m)


def step_times(torch, device, flags, steps_per_epoch):
    """Phase 1: each engine's bf16 step (ms, peak GiB) on one seeded batch."""
    from . import train_accuracy as ta

    out = {}
    for engine in ENGINES:
        args = ta.build_arg_parser().parse_args(flags + ["--engine", engine])
        trainer = ta.make_trainer(args, device, "")
        state = trainer.init(steps_per_epoch)
        gen = torch.Generator(device=device).manual_seed(27)
        clean = torch.rand(args.batch_size, 3, args.size, args.size, generator=gen,
                           device=device) * 2 - 1
        noisy = clean + 25 / 127.5 * torch.randn(clean.shape, generator=gen, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(WARMUP + TIMED):
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, noisy, clean)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[engine] = {"ms": sum(ms[WARMUP:]) / TIMED, "step_ms": [round(t, 2) for t in ms],
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "loss": loss.item()}
        print(f"step {engine}: {out[engine]['ms']:.2f} ms (mean of {TIMED} after {WARMUP}), "
              f"peak {out[engine]['peak_gib']} GiB", flush=True)
        del trainer, state
        torch.cuda.empty_cache()
    return out


def trajectories(torch, device, flags, train_clean, steps_per_epoch):
    """Phase 2: protocol steps from one init per (dtype, kernel widths);
    each variant's losses and the relative difference of its parameter
    updates from the all-eager run's of its dtype, per block width."""
    from ..data.resident import DeviceBankLoader
    from ..models.rdunet import RDUNet
    from ..nn.blocks import DenoisingBlock
    from . import train_accuracy as ta

    args = ta.build_arg_parser().parse_args(flags)
    widths = tuple(args.base_filters * 2 ** i for i in range(4))
    init = RDUNet(3, args.base_filters, generator=torch.Generator().manual_seed(0)).state_dict()
    loader = DeviceBankLoader(train_clean, args.batch_size,
                              transform=ta.make_transform(device, args.sigma, None),
                              steps_per_epoch=TRAJ_STEPS, device=device, seed=ta.LOADER_SEED)
    batches = list(loader)
    variants = [("bf16", ()), ("bf16", widths)] + [("bf16", (w,)) for w in widths]
    variants += [("f32", ()), ("f32", widths)]
    out, ref = {}, {}
    for dtype, kernel_widths in variants:
        torch.backends.cudnn.allow_tf32 = dtype == "bf16"
        trainer = ta.make_trainer(args, device, "")
        trainer.model.load_state_dict(init)
        groups = {}
        for prefix, m in trainer.model.named_modules():
            if isinstance(m, DenoisingBlock):
                groups.setdefault(block_width(m), []).append(prefix + ".")
        eager_blocks(trainer.model, kernel_widths)
        if dtype == "f32":
            trainer.compute_dtype = torch.float32
        state = trainer.init(steps_per_epoch)
        t0 = time.perf_counter()
        losses = []
        for noisy, clean in batches:
            state, loss = trainer.train_step(state, noisy, clean)
            losses.append(loss.item())
        sec = time.perf_counter() - t0
        delta = {k: v.detach().float().cpu() - init[k]
                 for k, v in trainer.model.state_dict().items()}
        name = f"{dtype} kernel at {list(kernel_widths) or 'no width'}"
        rec = {"losses": losses, "sec": sec}
        if not kernel_widths:
            ref[dtype] = (losses, delta)
        else:
            ref_losses, ref_delta = ref[dtype]
            rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))

            def rel(keys):
                d = sum(float((delta[k] - ref_delta[k]).norm() ** 2) for k in keys)
                n = sum(float(ref_delta[k].norm() ** 2) for k in keys)
                return (d / n) ** 0.5

            rec["update_rel"] = rel(list(delta))
            rec["update_rel_by_width"] = {
                w: rel([k for k in delta if any(k.startswith(p) for p in prefixes)])
                for w, prefixes in groups.items()}
        out[name] = rec
        print(f"trajectory {name}: {TRAJ_STEPS} steps in {sec:.1f} s; losses "
              f"{[round(v, 6) for v in losses]}"
              + ("" if not kernel_widths else
                 f"; against all eager: loss rel {rec['loss_rel']:.3e}, update rel "
                 f"{rec['update_rel']:.3e}, by width "
                 f"{ {w: round(v, 5) for w, v in rec['update_rel_by_width'].items()} }"),
              flush=True)
        del trainer, state, delta
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return out


def start_runs(flags, out_dir, ckpt_root, cache_dir):
    """Phase 3: one ``train_accuracy`` process per engine, all started now."""
    procs = {}
    for engine in ENGINES:
        run_flags = flags + [
            "--engine", engine, "--tag", f"bisect-{engine}",
            "--ckpt-dir", os.path.join(ckpt_root, engine), "--cache-dir", cache_dir,
            "--out", os.path.join(out_dir, f"rows_{engine}.jsonl")]
        log = open(os.path.join(out_dir, f"{engine}.log"), "w")
        procs[engine] = (subprocess.Popen([sys.executable, "-m", MODULE] + run_flags, stdout=log,
                                          stderr=subprocess.STDOUT), log, time.perf_counter())
        print(f"run {engine}: {MODULE} {' '.join(run_flags)}", flush=True)
    return procs


def finish_runs(procs, out_dir):
    """Wait for phase 3's processes; each run's PSNR and loss by epoch."""
    out = {}
    for engine, (proc, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        sec = time.perf_counter() - t0
        psnr, loss = {}, {}
        with open(os.path.join(out_dir, f"{engine}.log")) as f:
            for line in f:
                if line.startswith("epoch ") and " loss " in line:
                    epoch = int(line.split()[1].split("/")[0])
                    loss[epoch] = float(line.split(" loss ")[1].split()[0])
                    if " val PSNR " in line:
                        psnr[epoch] = float(line.split(" val PSNR ")[1].split()[0])
        out[engine] = {"rc": rc, "sec": sec, "psnr_by_epoch": psnr, "loss_by_epoch": loss}
        print(f"run {engine}: rc {rc} in {sec:.1f} s; PSNR by epoch {psnr}; last loss "
              f"{loss.get(max(loss), None) if loss else None}", flush=True)
    return out


def score(torch, device, ckpt, base_filters, val_clean, sigma):
    """Phase 4: one checkpoint's held-out PSNR through the eager engine in
    f32 (TF32 off) and bf16, and through the module path in bf16."""
    from ..models.fused_apply import rdunet_apply_fused
    from ..models.rdunet import RDUNet
    from ..utils.checkpoint import load_pth
    from . import train_accuracy as ta

    model, _ = load_pth(ckpt, RDUNet(3, base_filters))
    model.to(device, memory_format=torch.channels_last).eval()
    params = dict(model.state_dict())
    noisy_u8 = ta.heldout_noisy(val_clean, np.full((len(val_clean),), sigma, np.float32))
    paths = {
        "eager f32": (lambda x: rdunet_apply_fused(params, x.float(), engine="xla"), False),
        "eager bf16": (lambda x: rdunet_apply_fused(params, x.bfloat16(), engine="xla"), True),
        "kernel bf16": (lambda x: model(x.bfloat16()), True),
    }
    out = {}
    for name, (predict, tf32) in paths.items():
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.no_grad():
            per_image = ta.evaluate_psnr(predict, noisy_u8, val_clean,
                                         ta.EVAL_BATCH["supervised"], device)
        out[name] = float(np.mean(per_image))
        print(f"score {name}: {out[name]:.4f} dB", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="runs/torch_flagship_bisect")
    ap.add_argument("--ckpt-root", default="runs/torch_flagship_bisect")
    ap.add_argument("--cache-dir", default=None, help="synthetic images (train_accuracy's)")
    args = ap.parse_args(argv)

    import torch

    from ..utils.device import resolve_device
    from . import train_accuracy as ta

    device = resolve_device()
    flags = flagship_flags()
    cache = args.cache_dir or ta.CACHE_DIR
    os.makedirs(args.out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    fa = ta.build_arg_parser().parse_args(flags)
    train_clean, val_clean = ta.synth_train_val(fa.n_train, fa.n_val, fa.size, cache_dir=cache)
    steps_per_epoch = len(train_clean) // fa.batch_size
    summary = {"card": card, "flags": flags}
    t0 = time.perf_counter()
    summary["step"] = step_times(torch, device, flags, steps_per_epoch)
    procs = start_runs(flags, args.out_dir, args.ckpt_root, cache)
    summary["trajectory"] = trajectories(torch, device, flags, train_clean, steps_per_epoch)
    summary["runs"] = finish_runs(procs, args.out_dir)
    summary["score"] = score(torch, device, os.path.join(args.ckpt_root, "flax",
                                                         "rdunet_denoising.pth"),
                             fa.base_filters, val_clean, fa.sigma)
    summary["sec"] = time.perf_counter() - t0
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    failed = [e for e, r in summary["runs"].items() if r["rc"] != 0]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
