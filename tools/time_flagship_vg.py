"""Time the flagship value+grad of tpu_gmrf_torch (chip_smoke.py's phase 4: the
batched Laplace marginal of AR1(500) + Poisson over 256 chains, float32,
value and θ-gradient) from the source tree given as the first argument;
needs a CUDA device.

To compare two trees on one card, unpack the other tree (``git archive``)
into a git-ignored directory and run both in turns on one card, in one command:

    for t in _checkout/parent . . _checkout/parent; do python3 tools/time_flagship_vg.py $t; done

Each run builds that tree's kernels, warms up with 3 calls and prints the
median, min and max of 7 timings of 3 calls each (host clock around work
that ends in ``torch.cuda.synchronize()``).
"""

import os
import sys
import time

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the tree's own script: its flagship setup)
from tpu_gmrf_torch.kernels import build  # noqa: E402
from tpu_gmrf_torch.samplers import value_and_grad  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_flagship_vg: no CUDA device", file=sys.stderr)
        return 1
    build.build()
    build.library()
    dev = torch.device("cuda")
    ld = cs.logdensity(cs.flagship_y())
    z = torch.tensor(np.random.default_rng(2).normal(scale=0.5, size=(cs.CHAINS, 2)), dtype=torch.float32, device=dev)
    for _ in range(3):
        value_and_grad(ld, z)
    ts = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            value_and_grad(ld, z)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) / 3 * 1e3)
    print(f"{os.path.relpath(root)}: flagship f32 value+grad median {np.median(ts):.2f} ms (min {min(ts):.2f}, "
          f"max {max(ts):.2f}) on {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
