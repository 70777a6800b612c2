"""The protocol's supervised step at the flagship's widths: the port's against JAX's, by hand.

Not a test (it takes about 15 minutes and several GiB on the CPU).  It runs
the setup of test_torch_protocol_trajectory.py at RDUNet(3, 128): 32^2
patches of the protocol's synthetic images under sigma = 25, batch 8 in 4
micro-batches, AdamW(1e-4, wd 1e-5), clip 1.0, StepLR(3, 0.5) on one-step
epochs, 8 steps across two decays, in f32 (JAX at HIGHEST precision, TF32
off), from JAX's own init carried across with ``params_to_state_dict``.
It takes the steps four ways, JAX's ``SupervisedTrainer`` under the engines
``"xla"`` and ``"flax"`` and ``train_accuracy.make_trainer``'s trainer under
``"flax"`` and ``"xla"``, and holds every pair against each other: the
largest relative difference of their losses, of a parameter leaf (in norm)
and of a leaf's update (in the norm of the update), and the share of
elements outside rtol 2e-4.  JAX's two engines against each other give the
spread that f32 rounding alone reaches over these steps.

    PYTHONPATH=. python tests/torch_protocol_spread.py --out runs/torch_protocol_spread_128.json
"""

import argparse
import itertools
import json
import os
import tempfile
import time

import numpy as np

RTOL = 2e-4


def pair(a, b, init):
    """How far run ``a`` lies from run ``b``: losses, parameters, updates."""
    (la, pa), (lb, pb) = a, b
    leaf = update = dsq = usq = 0.0
    outside = total = 0
    for k, y in pb.items():
        x, y = pa[k].astype(np.float64), y.astype(np.float64)
        d = np.linalg.norm(x - y)
        du = np.linalg.norm(y - init[k])
        leaf = max(leaf, d / np.linalg.norm(y))
        if du > 0:
            update = max(update, d / du)
        dsq, usq = dsq + d * d, usq + du * du
        outside += int((np.abs(x - y) > RTOL * np.abs(y)).sum())
        total += y.size
    la, lb = np.asarray(la), np.asarray(lb)
    return {"loss_max_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
            "param_worst_leaf_rel": float(leaf), "update_worst_leaf_rel": float(update),
            "update_whole_rel": float(np.sqrt(dsq / usq)),
            "share_outside_rtol": outside / total}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=int, default=128)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="runs/torch_protocol_spread_128.json")
    a = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from vub_image_denoising_tpu import enable_strict_precision
    from vub_image_denoising_tpu.models import RDUNet as JRDUNet
    from vub_image_denoising_tpu.train import SupervisedTrainer as JSupervisedTrainer
    from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta
    from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

    enable_strict_precision()
    torch.backends.cudnn.allow_tf32 = False
    batch = 8
    rng = np.random.RandomState(0)
    clean = ta.synth_images(a.steps * batch, a.size, rng)
    noisy = np.clip(clean.astype(np.float32) + 25.0 * rng.randn(*clean.shape).astype(np.float32),
                    0, 255).astype(np.uint8)

    def norm(u):
        return (u.astype(np.float32) / 255.0 - 0.5) / 0.5

    batches = [(norm(noisy[i:i + batch]), norm(clean[i:i + batch]))
               for i in range(0, a.steps * batch, batch)]

    def state_dict(params):
        return {k: v.numpy().copy() for k, v in params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params)).items()}

    runs, seconds, init = {}, {}, None
    for engine in ("xla", "flax"):
        jt = JSupervisedTrainer(JRDUNet(channels=3, base_filters=a.base), lr=1e-4,
                                engine=engine, compute_dtype=jnp.float32)
        state = jt.init(jax.random.PRNGKey(0), jnp.zeros((batch, a.size, a.size, 3)),
                        steps_per_epoch=1)
        if init is None:
            init = state_dict(state.params)
        t0 = time.perf_counter()
        losses = []
        for n, c in batches:
            state, loss = jt._jit_step(state, jnp.asarray(n), jnp.asarray(c))
            losses.append(float(loss))
        seconds[f"jax {engine}"] = time.perf_counter() - t0
        runs[f"jax {engine}"] = (losses, state_dict(state.params))
        print(f"jax {engine}: {seconds[f'jax {engine}']:.1f} s, losses {losses}", flush=True)
        del jt, state

    init_t = {k: torch.from_numpy(v) for k, v in init.items()}
    for engine in ("flax", "xla"):
        args = ta.build_arg_parser().parse_args(
            ["--base-filters", str(a.base), "--engine", engine, "--device", "cpu"])
        with tempfile.TemporaryDirectory() as ckpt:
            trainer = ta.make_trainer(args, args.device, ckpt)
        trainer.compute_dtype = torch.float32  # the protocol trains in bf16
        trainer.model.load_state_dict(init_t, strict=True)
        st = trainer.init(1)
        t0 = time.perf_counter()
        losses = []
        for n, c in batches:
            st, loss = trainer.train_step(st, torch.from_numpy(n).permute(0, 3, 1, 2),
                                          torch.from_numpy(c).permute(0, 3, 1, 2))
            losses.append(loss.item())
        seconds[f"port {engine}"] = time.perf_counter() - t0
        runs[f"port {engine}"] = (losses, {k: v.detach().numpy().copy()
                                           for k, v in trainer.model.state_dict().items()})
        print(f"port {engine}: {seconds[f'port {engine}']:.1f} s, losses {losses}", flush=True)
        del trainer, st

    init64 = {k: v.astype(np.float64) for k, v in init.items()}
    pairs = {}
    for (na, ra), (nb, rb) in itertools.combinations(runs.items(), 2):
        pairs[f"{na} vs {nb}"] = pair(ra, rb, init64)
        print(f"{na} vs {nb}: {pairs[f'{na} vs {nb}']}", flush=True)
    out = {"setup": {"base": a.base, "size": a.size, "batch": batch, "accumulation": 4,
                     "steps": a.steps, "steps_per_epoch": 1, "dtype": "float32",
                     "torch_threads": torch.get_num_threads(),
                     "cpus": len(os.sched_getaffinity(0)),
                     "params": int(sum(v.size for v in init.values()))},
           "losses": {k: v[0] for k, v in runs.items()}, "seconds": seconds, "pairs": pairs}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
