"""The JAX package's float32 supernodal factorization at phase 25(b)'s four θ, on the CPU.

The other half of `tools/fault35_probe.py`: the same n=5741 Matérn prior (the port's mesh of chip_smoke.py's
63 x 63 grid, handed to the JAX package's `FEMDiscretization` and `MaternModel`), Q assembled by the JAX package
in float32, factored by its `supernodal_factorize` under `jax.jit`; prints per chain the boosted pivots and the
f32 logdet's distance from the f64 logdet of the port's plain path on CPU tensors. Also factors the port's f64 Q
rounded to float32. Runs on the CPU only (about a minute, most of it the compile):

    JAX_PLATFORMS=cpu python3 tools/fault35_reference.py
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tpu_gmrf_torch as tg  # noqa: E402

tg.set_default_device("cpu")

import chip_smoke as cs  # noqa: E402
from fault35_probe import precision, theta  # noqa: E402


def main() -> int:
    from tpu_gmrf.fem import FEMDiscretization, MaternModel, TriangleMesh
    from tpu_gmrf.solvers.supernodal import supernodal_factorize
    from tpu_gmrf.sparse.matrix import SparseMatrix as JSparse
    from tpu_gmrf_torch.solvers import supernodal as sn

    model = cs.spatial_model(cs.SP_GRID)
    p = theta()
    Q64 = precision(model, p, torch.float64, torch.device("cpu"))
    ref = sn._factorize(Q64, 2048, "auto", sn._PLAIN_OPS).logdet().numpy()
    mesh = model.disc.mesh
    jm = MaternModel(FEMDiscretization(TriangleMesh(mesh.vertices, mesh.triangles)), smoothness=1)

    pattern = jm.precision(tau=jnp.float32(1.0), range=jnp.float32(0.3)).pattern
    if not (np.array_equal(pattern.rows, Q64.pattern.rows) and np.array_equal(pattern.cols, Q64.pattern.cols)):
        raise AssertionError("the JAX package's pattern differs from the port's")

    @jax.jit
    def factor(data):
        f = supernodal_factorize(JSparse(data, pattern))
        return f.boost, f.logdet()

    for label, rows in (("Q assembled by the JAX package in f32", None), ("the port's f64 Q rounded to f32", 0)):
        for b in range(len(p)):
            if rows is None:
                data = jm.precision(tau=jnp.float32(np.exp(p[b, 0])), range=jnp.float32(np.exp(p[b, 1]))).data
            else:
                data = jnp.asarray(Q64.data[b].numpy().astype(np.float32))
            t0 = time.perf_counter()
            boost, ld = factor(data)
            rel = abs(float(ld) - ref[b]) / abs(ref[b])
            print(f"{label}, chain {b}: boosts {int(boost)}, f32 logdet rel distance from f64 {rel:.3e} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
