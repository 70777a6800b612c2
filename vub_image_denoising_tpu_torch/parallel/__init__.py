"""The multi-device layer: counterpart of ``vub_image_denoising_tpu/parallel``."""

from .fsdp import FullyShardedDataParallel, put_fsdp, sharded_fraction
from .mesh import (
    Mesh,
    all_processes_mean,
    init_distributed,
    make_global_batch,
    make_mesh,
    put_batch,
    put_replicated,
    replicate,
    shard_batch,
    shard_spatial,
)
from .pipeline import make_pp_mesh, pipeline_sample_fn, pipelined_sampling
from .tiles import denoise_large_image
from .tp import TensorParallel, make_tp_mesh, put_tp
