"""Checkpoint and resume with the PyTorch port (``niwqg_tpu_torch``).

A checkpoint holds the full state (clock, step counter, the integrated
budgets) and the accumulated diagnostic series, so a run split across a
save and a load reproduces the uninterrupted run to the last bit. The
file is HDF5 in the JAX package's layout, so either package can resume
it (same q-side layout). Without h5py the checkpoint is held in memory
(``io.checkpoint_tree``/``io.restore_tree``).

Run, on the card or on the host:
  python examples/torch/Restart.py
  python examples/torch/Restart.py --device cpu --nx 32
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from niwqg_tpu_torch import CoupledModel  # noqa: E402
from niwqg_tpu_torch import InitialConditions as ic  # noqa: E402
from niwqg_tpu_torch import io  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None,
                help="'cpu' for the host; default: the first CUDA card")
ap.add_argument("--nx", type=int, default=128)
args = ap.parse_args()


def build(tmax_steps):
    U0 = 0.05
    m = CoupledModel.Model(nx=args.nx, use_filter=False, U=-U0, tdiags=2,
                           tmax=tmax_steps * 10000.0, device=args.device)
    k0 = 10 * (2 * np.pi / m.L)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    m.set_q(q)
    m.set_phi((np.ones_like(q) + 1j) * 5 * U0 / np.sqrt(2))
    return m


# --- uninterrupted control: 20 steps straight --------------------------
control = build(20)
control.run()

# --- interrupted run: 10 steps, checkpoint, a fresh model, resume, 10 more
first = build(10)
first.run()
try:
    import h5py  # noqa: F401
except ImportError:
    ckpt = io.checkpoint_tree(first)
    print(f"checkpointed at step {first.tc} in memory (no h5py)")
else:
    tmpdir = tempfile.TemporaryDirectory()  # removed when the script ends
    ckpt = os.path.join(tmpdir.name, "state.ckpt")
    first.save_checkpoint(ckpt)
    print(f"checkpointed at step {first.tc} -> {ckpt}")

resumed = build(20)           # a fresh model (a new process in real use)
if isinstance(ckpt, dict):
    io.restore_tree(resumed, ckpt)
else:
    resumed.load_checkpoint(ckpt)
assert resumed.tc == 10
resumed.run()                 # continues from step 10 to tmax

# --- bit-exact equivalence ---------------------------------------------
assert np.array_equal(control.q, resumed.q)
assert np.array_equal(control.phi, resumed.phi)
assert control.Ke == resumed.Ke and control.Kw == resumed.Kw
for name in ("ke_qg", "ke_niw", "pe_niw", "gamma_r"):
    a = control.diagnostics[name]["value"]
    b = resumed.diagnostics[name]["value"]
    assert np.array_equal(a, b), name
print("resume is bit-exact: fields, budgets and all diagnostic series "
      "match the uninterrupted run")
