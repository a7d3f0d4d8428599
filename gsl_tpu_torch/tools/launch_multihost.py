"""One process of a multi-host distributed fit: set the ``env://``
rendezvous from the flags, then run the port's CLI in this process.

    python -m gsl_tpu_torch.tools.launch_multihost \\
        --coordinator 10.0.0.2:29500 --num-processes 8 --process-id $RANK \\
        fit --config gsl_tpu_torch/configs/colmap.yaml \\
        --config gsl_tpu_torch/configs/distributed.yaml \\
        --data.path /data/garden -n garden-mp

Counterpart of ``scripts/launch_multihost.py``, which initialises
``jax.distributed`` (one process per host, its chips the local devices).
A ``torch.distributed`` rank is one process with one device, so this
tool starts one rank: run it once per rank, on every host, as ``torchrun``
would. The flags become the variables ``env://`` reads:

    --coordinator HOST:PORT    MASTER_ADDR, MASTER_PORT (default
                               127.0.0.1 and a free port, for one process)
    --num-processes N          WORLD_SIZE
    --process-id I             RANK
    --local-rank L             LOCAL_RANK (default I: the device index on
                               its host is L % device_count)
    --local-world-size M       LOCAL_WORLD_SIZE (default N): the ranks of
                               this host, for the NCCL-or-gloo choice

The ``distributed:`` key of the config routes ``fit`` to
``gsl_tpu_torch/parallel/fit_distributed.py``; dp x mp must equal N. Put mp
inside a host (its all_to_all carries the splat exchange) and dp across
hosts (its only collective is the gradient sum): ranks are numbered
dp-major, so the mp peers of a rank are consecutive ranks.
"""
from __future__ import annotations

import argparse
import os
import socket


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(
        "launch_multihost",
        description="env:// rendezvous around the gsl_tpu_torch CLI")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's store")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-rank", type=int, default=None)
    ap.add_argument("--local-world-size", type=int, default=None)
    args, rest = ap.parse_known_args(argv)

    if args.coordinator is not None:
        host, _, port = args.coordinator.rpartition(":")
    elif args.num_processes == 1:
        host, port = "127.0.0.1", str(free_port())
    else:
        raise SystemExit("--coordinator HOST:PORT is needed for more than "
                         "one process")
    os.environ.update(
        MASTER_ADDR=host, MASTER_PORT=str(port),
        WORLD_SIZE=str(args.num_processes), RANK=str(args.process_id),
        LOCAL_RANK=str(args.process_id if args.local_rank is None
                       else args.local_rank),
        LOCAL_WORLD_SIZE=str(args.num_processes
                             if args.local_world_size is None
                             else args.local_world_size))

    import torch
    print(f"[multihost] process {args.process_id}/{args.num_processes} -- "
          f"{torch.cuda.device_count()} local CUDA devices, store "
          f"{host}:{port}", flush=True)

    from ..cli import main as cli_main
    return cli_main(rest)


if __name__ == "__main__":
    main()
