"""Coupled Lamb-dipole run pencil-distributed over ranks, on the PyTorch
port (``niwqg_tpu_torch``; the JAX package's
``examples/LambDipole_sharded.py``).

One process per rank over ``torch.distributed``: rank r takes card
r % (number of cards), or the host with ``--device cpu`` (gloo). Run every
rank yourself, with the same port::

  python examples/torch/LambDipole_sharded.py --rank R --nranks 4 --port 29500

or let the script start them::

  python examples/torch/LambDipole_sharded.py --nranks 4
  python examples/torch/LambDipole_sharded.py --nranks 4 --device cpu --nx 64

Only the CoupledModel runs on a mesh so far. With ``--checkpoint PATH``
(and h5py) the state is checkpointed at the end: a collective, which
rank 0 writes.
"""

import argparse
import os
import socket
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(rank, args):
    sys.path.insert(0, ROOT)
    import torch

    from niwqg_tpu_torch import CoupledModel as Model
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.parallel import multihost

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    multihost.initialize(f"localhost:{args.port}", args.nranks, rank,
                         device=args.device, timeout_s=300)
    mesh = multihost.global_mesh(device=args.device)
    if rank == 0:
        print(f"running on a {mesh.nP}-rank mesh ({mesh.device} on rank 0)")

    nx = args.nx
    f0 = 1.0e-4
    L = 2 * np.pi * 200e3
    k0 = 10 * (2 * np.pi / L)
    U = 1.0e-1
    Te = (U * k0) ** -1

    m = Model.Model(
        L=L, nx=nx, tmax=2 * Te, dt=0.025 * Te,
        m=2 * np.pi / 280, N=0.01, f=f0, twrite=20,
        nu4=5e11, nuw=50.0, use_filter=False, U=-U, tdiags=10, mesh=mesh,
        device=args.device,
    )

    q = ic.LambDipole(m, U=U, R=2 * np.pi / k0)  # the global field
    m.set_q(q)
    m.set_phi((np.ones_like(q) + 1j) * 2 * U / np.sqrt(2))
    if rank == 0:
        print("qh block on rank 0:", tuple(m.state.qh.shape))
    m.run()
    if args.checkpoint:
        m.save_checkpoint(args.checkpoint)  # collective
    q_end = m.q  # a gather: every rank takes part
    if rank == 0:
        print(f"done: {m.tc} steps, Ke={m.Ke:.4e}, Kw={m.Kw:.4e}, "
              f"max|q|={np.abs(q_end).max():.4e}")
    multihost.shutdown()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default: the CUDA cards")
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--nranks", type=int, default=4)
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank; omit to start all ranks")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        if args.port is None:
            ap.error("--rank needs --port (the same on every rank)")
        run(args.rank, args)
        return
    import torch.multiprocessing as mp

    if args.port is None:
        with socket.socket() as s:  # a free port for the rendezvous
            s.bind(("127.0.0.1", 0))
            args.port = s.getsockname()[1]
    mp.spawn(run, args=(args,), nprocs=args.nranks, join=True)


if __name__ == "__main__":
    main()
