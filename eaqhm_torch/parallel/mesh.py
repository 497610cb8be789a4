"""Device mesh for corpus-scale runs over ``torch.distributed``
(eaqhm_tpu/parallel/mesh.py).

PyTorch's idiom is one process per device, all running the same program
(SPMD), where JAX has one controller per host.  So the mesh here is a
``DeviceMesh`` over the ranks of the default process group, with dims
("data", "model"): utterance batches split over "data", frames (then
harmonics) of each utterance over "model" (``parallel.batch_engine``);
collectives go through ``mesh.get_group("data" | "model")``.

JAX's ``data_sharding`` and ``frame_sharding`` are placement specs of
global arrays; PyTorch has no counterpart.  What they say, which rows of a
[B, No] array a device holds, is index arithmetic in
``parallel.batch_engine`` (``_Shard``): data rank d holds utterances
[d*B/dp, (d+1)*B/dp), model rank m frames [m*No/mp, (m+1)*No/mp).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def make_mesh(n_devices: int | None = None,
              model_parallel: int | None = None) -> DeviceMesh:
    """A (data, model) mesh over the first n_devices ranks of the default
    process group (all of them by default); model_parallel defaults to 2
    when the count is even, else 1 (JAX's rule).  The device type follows
    the group's backend: "cuda" for NCCL, "cpu" otherwise.  Every rank of
    the group calls it (it creates the sub-groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(multihost_init, or init_process_group)")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"make_mesh: {n} devices asked, the group has "
                         f"{world} ranks")
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    data = n // model_parallel
    ranks = torch.arange(data * model_parallel).reshape(data,
                                                        model_parallel)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev, ranks, mesh_dim_names=AXES)


def multihost_init(required: bool = False,
                   timeout: datetime.timedelta = datetime.timedelta(
                       seconds=60)) -> bool:
    """Join the process group described by torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); returns True when a group
    was joined.  NCCL when CUDA is present, gloo otherwise; ``timeout``
    bounds the rendezvous and the collectives (PyTorch's default is 30
    min, so an unreachable peer would hang that long).

    Failure policy (JAX's): already initialized -> True; nothing configured
    (none of those variables set, and not required) -> False, single
    process; configured but failing (peer unreachable, bad variables) ->
    RuntimeError: going on as one process would analyze every utterance
    on every rank.
    """
    if dist.is_initialized():
        return True
    configured = required or any(k in os.environ for k in _ENV)
    if not configured:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if backend == "nccl" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return True
    except Exception as e:  # noqa: BLE001 (classified: always re-raised)
        raise RuntimeError(
            "multi-host init failed with a process group configured; "
            "refusing to fall back to one process (every rank would "
            f"analyze the whole corpus): {type(e).__name__}: {e}") from e
