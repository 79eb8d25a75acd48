"""Multi-process entry point of the port: one process per rank.

Counterpart of `distributed.py` of the JAX package, on `torch.distributed`.
Kept free of heavy imports at module level (torch is imported when the
function runs), like the JAX module, so a launcher can import it first:

    from stark_mlwe_tpu_torch.distributed import initialize_distributed
    initialize_distributed("10.0.0.1:1234", num_processes, process_id)
    from stark_mlwe_tpu_torch.parallel import make_mesh
    from stark_mlwe_tpu_torch.parallel.prover import prove_sharded
    proof = prove_sharded(witness, params, mesh=make_mesh())

The replicated Fiat-Shamir discipline (identical bytes in, identical
challenges out on every rank) is what makes the sharded prover agree
across processes.
"""

from __future__ import annotations

# A collective that waits longer than this raises instead of blocking.
TIMEOUT_SECONDS = 120


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None):
    """Set up the default process group of this rank; returns its device.

    The backend follows the device rule: `device=None` is NCCL on the card
    `cuda:{process_id % device_count}` (raises where there is no card),
    `device="cpu"` is gloo; nothing falls back from one to the other.

    `coordinator_address` is `host:port` (taken as `tcp://host:port`) or an
    init URL (`tcp://...`, `file:///path`: a store in a shared file).  One
    process needs no address: it gets a one-rank group on an in-memory
    store.  Unlike the JAX function, which does nothing for one process,
    this always sets up a group: the sharded code issues its collectives
    at every world size, and PyTorch's collectives need a group.
    """
    import datetime

    import torch
    import torch.distributed as dist

    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside 0..{world - 1}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: initialize_distributed() sets up NCCL on the "
                "card; pass device='cpu' for gloo on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no backend for device {device}")

    kwargs = dict(backend=backend, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=TIMEOUT_SECONDS))
    if coordinator_address is None:
        if world != 1:
            raise ValueError("more than one process needs a "
                             "coordinator_address")
        kwargs["store"] = dist.HashStore()
    elif "://" in coordinator_address:
        kwargs["init_method"] = coordinator_address
    else:
        kwargs["init_method"] = "tcp://" + coordinator_address
    dist.init_process_group(**kwargs)
    return device
