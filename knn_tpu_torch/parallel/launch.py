"""``mpiexec``-like launcher for the multi-process KNN worker.

Reference invocation (mpi.cpp:123)::

    mpiexec -np P ./mpi train.arff test.arff k

Equivalent here::

    python -m knn_tpu_torch.parallel.launch -np P train.arff test.arff k

Spawns P copies of ``knn_tpu_torch.parallel.multihost`` on this machine,
wires the rendezvous variables (``KNN_TPU_COORD_ADDR``,
``KNN_TPU_NUM_PROCS``, ``KNN_TPU_PROC_ID``: the role ``mpiexec`` plays for
``MPI_Init``), picks the process group's backend once, before any group
exists (``multihost.pick_backend``: ``nccl`` when every rank has a card of
its own, ``gloo`` when ranks share a card or run on the CPU), prints that
choice on stderr, and streams rank 0's output. Every process is waited
for, and killed if the launcher is interrupted. ``--device cpu`` runs the
ranks on the host (the kernels' plain versions); ``--devices-per-proc N``
gives each rank a local mesh of N logical shards.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    from knn_tpu_torch.parallel import multihost

    p = argparse.ArgumentParser(prog="knn_tpu_torch.parallel.launch")
    p.add_argument("-np", "--num-procs", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the ranks compute (cpu: the plain versions)")
    p.add_argument("--devices-per-proc", type=int, default=1,
                   help="logical shards in each rank's local mesh")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds to wait for the ranks before killing them")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="worker args: train.arff test.arff k [flags]")
    args = p.parse_args(argv)
    if not args.rest:
        p.error("missing worker args: train.arff test.arff k")
    if args.num_procs < 1 or args.devices_per_proc < 1:
        p.error("-np and --devices-per-proc must be >= 1")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: DeviceError: --device cuda asked for but "
                  "torch.cuda.is_available() is false; pass --device cpu "
                  "to run the ranks on the host", file=sys.stderr)
            return 1
    backend = multihost.pick_backend(args.num_procs, args.device)
    print(f"launch: {args.num_procs} ranks on {args.device}, process group "
          f"backend {backend}", file=sys.stderr, flush=True)
    port = free_port()
    procs = []
    try:
        for rank in range(args.num_procs):
            env = dict(
                os.environ,
                KNN_TPU_COORD_ADDR=f"127.0.0.1:{port}",
                KNN_TPU_NUM_PROCS=str(args.num_procs),
                KNN_TPU_PROC_ID=str(rank),
            )
            env[multihost.BACKEND_ENV] = backend
            env[multihost.DEVICE_ENV] = args.device
            env[multihost.LOCAL_SHARDS_ENV] = str(args.devices_per_proc)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "knn_tpu_torch.parallel.multihost",
                 *args.rest],
                env=env, cwd=REPO,
                stdout=None if rank == 0 else subprocess.DEVNULL,
                stderr=None if rank == 0 else subprocess.DEVNULL,
            ))
        rc = 0
        for proc in procs:
            rc = proc.wait(timeout=args.timeout) or rc
        return rc
    except subprocess.TimeoutExpired:
        print(f"error: the ranks did not finish within {args.timeout} s",
              file=sys.stderr)
        return 124
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    sys.exit(main())
