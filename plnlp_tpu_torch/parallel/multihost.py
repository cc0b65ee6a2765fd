"""Process-group initialization (port of plnlp_tpu/parallel/multihost.py).

The runtime is one process per card over ``torch.distributed``: NCCL on
the card, gloo only when the caller asks for the CPU.  :func:`init` reads
the env:// variables that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and is idempotent: with a
process group already up it returns this rank's device and starts nothing.

    torchrun --standalone --nproc_per_node=2 -m plnlp_tpu_torch --num_shards 2 ...

Across hosts, torchrun's ``--nnodes``/``--rdzv_endpoint`` give the same
variables; nothing else changes.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["init", "TIMEOUT"]

# Every process group gets a timeout: a rank that raises while the others
# sit in a collective then ends the run instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=600)


def _device(device) -> torch.device:
    from plnlp_tpu_torch import default_device

    if device is None and torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return default_device(device)


def init(device=None, timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group torchrun describes (NCCL on ``cuda:<LOCAL_RANK>``
    unless ``device`` is the CPU, then gloo); returns this rank's device."""
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group and no torchrun environment ({', '.join(missing)} unset): "
                "launch with torchrun --standalone --nproc_per_node=<ranks> ..."
            )
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="env://",
            world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]),
            timeout=timeout,
            device_id=dev if dev.type == "cuda" else None,
        )
    return dev
