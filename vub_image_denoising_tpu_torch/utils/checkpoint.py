"""Reference-layout ``.pth`` checkpoint IO, and the JAX param-tree converter.

The reference saves ``torch.save`` dicts: ``{model_state_dict, ...}`` or a bare
state_dict (evaluate_model.py:94-110 reads both).  The port's modules already
use the reference names and layouts, so a state_dict is written and read as
it is.  ``params_to_state_dict`` carries a param tree of the JAX package,
given as numpy arrays, across to the port:

- conv weight: HWIO kernel -> OIHW (transpose (3, 2, 0, 1));
- transpose conv (``conv_t``/``upconv*``): (kh, kw, ci, co) -> (ci, co, kh, kw);
- dense kernel (in, out) -> (out, in);
- PReLU ``alpha`` -> ``weight``; the JAX model's ``core`` level is dropped;
- BatchNorm (the GANs' ``TorchBatchNorm``, whose ``stats`` level is dropped):
  ``scale``/``bias`` -> ``weight``/``bias``, and from ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``, with
  ``num_batches_tracked`` = 0;
- LayerNorm (flax's ``nn.LayerNorm``): ``scale``/``bias`` -> ``weight``/``bias``;
- spectral norm (flax's ``nn.SpectralNorm``, whose u sits in ``batch_stats``
  as ``SpectralNorm_i/{layer}/kernel/u``, shape (1, cout)): -> the layer's
  ``weight_u``, shape (cout,); flax's ``sigma`` is recomputed by every
  forward and is not carried.

``optax_leaves_to_optimizer_state`` carries the optimizer state the JAX
trainers write (``optax_leaves``, the flattened optax state of
``optax_state_to_safe``) into a torch optimizer's ``state``.
"""

import os
import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _is_transpose_conv(path_names) -> bool:
    return any(n == "conv_t" or n.startswith("upconv") for n in path_names)


def _torch_key(names) -> str:
    leaf, mod = names[-1], list(names[:-1])
    if leaf in ("kernel", "alpha", "scale"):
        return ".".join(mod + ["weight"])
    if leaf == "mean":
        return ".".join(mod + ["running_mean"])
    if leaf == "var":
        return ".".join(mod + ["running_var"])
    return ".".join(mod + [leaf])


def _torch_key_and_array(names, leaf: np.ndarray):
    names = [n for n in names if n not in ("core", "stats")]
    key = _torch_key(names)
    if names[-1] == "kernel":
        if leaf.ndim == 2:
            return key, leaf.T
        if _is_transpose_conv(names):
            return key, leaf.transpose(2, 3, 0, 1)
        return key, leaf.transpose(3, 2, 0, 1)
    return key, leaf


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves; ``{'params': ..., 'batch_stats'?: ...}``
    or a bare param tree) -> state_dict."""
    trees = [tree["params"], tree.get("batch_stats", {})] if "params" in tree else [tree]
    out = {}
    for sub in trees:
        for names, leaf in _flatten(sub):
            names = list(names)
            if names[0].startswith("SpectralNorm_"):
                layer, *_, leafname = names[-1].split("/")
                if leafname == "u":
                    out[f"{layer}.weight_u"] = torch.from_numpy(
                        np.array(leaf, dtype=np.float32).reshape(-1))
                continue
            key, arr = _torch_key_and_array(names, np.asarray(leaf))
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
            if key.endswith("running_var"):
                out[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.long)
    return out


def _jax_names(key: str, params: Mapping[str, torch.Tensor]):
    """The JAX param path of state_dict key ``key`` below the model's
    ``core`` level: ``weight`` is a conv or dense ``kernel``, a norm's
    ``scale`` or a PReLU's ``alpha``."""
    *mod, leaf = key.split(".")
    if leaf == "weight":
        if params[key].dim() > 1:
            leaf = "kernel"
        else:
            leaf = "scale" if ".".join(mod + ["bias"]) in params else "alpha"
    return tuple(mod + [leaf])


# optax's state leaves per optimizer choice, as ``make_optimizer`` chains
# them behind clip_by_global_norm (whose state, like add_decayed_weights',
# has no leaves): [per-param moments ...] and their torch names, and
# whether a leading Adam count precedes them; the schedule's count is last
_OPTAX_MOMENTS = {"adam": (("exp_avg", "exp_avg_sq"), True),
                  "adamw": (("exp_avg", "exp_avg_sq"), True),
                  "adadelta": (("square_avg", "acc_delta"), False)}


def optax_leaves_to_optimizer_state(leaves, params: Mapping[str, torch.Tensor], choice: str):
    """The torch optimizer ``state`` (param index -> tensors) and the LR
    schedule's position held in ``leaves``, the ``optax_leaves`` of a
    checkpoint the JAX trainers wrote with optimizer ``choice``.

    ``params`` are the model's parameters in the optimizer's order.  The
    leaves follow optax's chain: for adam and adamw ``[count, mu..., nu...,
    schedule count]`` (``ScaleByAdamState``, ``ScaleByScheduleState``), for
    adadelta ``[e_g..., e_x..., schedule count]``; mu, nu, e_g and e_x hold
    one leaf per parameter in the JAX tree's order (dict keys sorted at
    every level) and layout, which are mapped back to the torch names and
    layouts of ``params_to_state_dict``.  Adam's count is torch's ``step``
    (the same bias correction); adadelta's step is the schedule's count.
    Raises ValueError on a leaf-count or shape mismatch, as
    ``safe_to_optax_state`` does."""
    if choice not in _OPTAX_MOMENTS:
        raise ValueError(f"no optax state mapping for optimizer {choice!r}")
    (first, second), has_count = _OPTAX_MOMENTS[choice]
    keys = list(params)
    n = len(keys)
    want = 2 * n + 1 + int(has_count)
    if len(leaves) != want:
        raise ValueError(f"checkpointed optax state has {len(leaves)} leaves but the "
                         f"{choice} optimizer over {n} params expects {want} — optimizer "
                         "configs differ")
    leaves = [np.asarray(v) for v in leaves]
    order = sorted(range(n), key=lambda i: _jax_names(keys[i], params))
    moments = leaves[int(has_count):int(has_count) + 2 * n]
    schedule_count = int(leaves[-1])
    step = float(leaves[0]) if has_count else float(schedule_count)

    def carried(leaf, i):
        key, arr = _torch_key_and_array(list(_jax_names(keys[i], params)), leaf)
        if key != keys[i] or tuple(arr.shape) != tuple(params[keys[i]].shape):
            raise ValueError(f"optax leaf for {keys[i]!r} has shape {leaf.shape}, want the "
                             f"JAX layout of {tuple(params[keys[i]].shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    state = {i: {"step": torch.tensor(step, dtype=torch.float32)} for i in range(n)}
    for j, i in enumerate(order):
        state[i][first] = carried(moments[j], i)
        state[i][second] = carried(moments[n + j], i)
    return state, schedule_count


def load_torch_payload(path: str, *, allow_pickle: bool = False):
    """torch.load with the safe ``weights_only=True`` path first; the unpickling
    fallback (which runs pickle code) only with ``allow_pickle=True``."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise ValueError(
                f"{path!r} failed the safe weights-only torch.load ({e}); refusing "
                "the unpickling fallback for a file not marked trusted "
                "(pass allow_pickle=True for a checkpoint you trust)."
            ) from e
        warnings.warn(f"{path!r}: safe weights-only load failed; falling back to full "
                      "unpickling (trusted files only)", stacklevel=2)
        return torch.load(path, map_location="cpu", weights_only=False)


def _atomic_torch_save(obj, path: str):
    """torch.save to a temp file, then os.replace: a kill mid-save leaves any
    existing checkpoint at ``path`` intact."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_pth(path: str, state_dict: Mapping[str, torch.Tensor], *, epoch: Optional[int] = None,
             prefix: str = "", extra: Optional[Mapping[str, Any]] = None, bare: bool = False):
    """Write a reference-layout ``.pth``: ``{'model_state_dict': ..., 'epoch'?,
    **extra}`` (``extra``: e.g. ``optimizer_state_dict`` and
    ``scheduler_state_dict``), or the bare state_dict with ``bare=True``.
    ``prefix`` goes in front of every key (``"unet."`` in the reference
    diffusion checkpoints).  Keep ``extra`` to tensors and plain Python
    values, so the file loads with ``torch.load(weights_only=True)``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    sd = {prefix + k: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in state_dict.items()}
    if bare:
        _atomic_torch_save(sd, path)
        return
    payload: Dict[str, Any] = {"model_state_dict": sd}
    if epoch is not None:
        payload["epoch"] = epoch
    if extra:
        payload.update(extra)
    _atomic_torch_save(payload, path)


def load_pth(path: str, model: torch.nn.Module, *, prefix: str = "",
             allow_pickle: bool = False):
    """Load a reference-layout ``.pth`` (dict-wrapped or bare) into ``model``
    with ``strict=True``.  ``prefix`` is stripped from every key, and a key
    without it is an error.  Returns ``(model, payload_dict_or_None)``."""
    payload = load_torch_payload(path, allow_pickle=allow_pickle)
    if isinstance(payload, dict) and "model_state_dict" in payload:
        sd = payload["model_state_dict"]
    else:
        sd, payload = payload, None
    if prefix:
        missing = [k for k in sd if not k.startswith(prefix)]
        if missing:
            raise KeyError(f"{path!r}: keys without the prefix {prefix!r}: {missing[:5]}")
        sd = {k[len(prefix):]: v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model, payload
