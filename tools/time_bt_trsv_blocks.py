"""Time both paths of K12's block entry `bt_trsv_blocks` (one block of threads
per right-hand side, and tiles of 64 right-hand sides) on the factor that
chip_smoke.py's phase 17 SPIKE solve gives it (4 chunks x 31 blocks of 450,
float64), at k = 1, 33, 34, 64 and 901 right-hand sides; needs a CUDA device.

    python3 tools/time_bt_trsv_blocks.py

For each k it prints the wrapper's time (the path it picks, see
`kernels.banded.TILE_WAVES`), then each path forced through the C entry, all
by CUDA events (mean of 3 calls after one warm-up), with the largest error
against the plain version relative to its largest value. The card's name and
power limit come first.
"""

import os
import subprocess
import sys

root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (phase 17's system and timing helpers)
from tpu_gmrf_torch import kernels  # noqa: E402
from tpu_gmrf_torch.kernels import build  # noqa: E402
from tpu_gmrf_torch.kernels.supernodal import SMEM_MAX  # noqa: E402
from tpu_gmrf_torch.kernels.tridiag import _fn, _stream  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_bt_trsv_blocks: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    build.build()
    build.library()
    dev = torch.device("cuda")
    system = cs.spike_system(cs.spatial_model(cs.DN_GRID), torch.float64, dev)
    (Pf, R), _ = cs.spike_kernel_calls(*system, cs.SPIKE_P)["bt_trsv_blocks"]
    B, K, s, _ = R.shape
    print(f"B={B} K={K} s={s}, {torch.cuda.get_device_properties(dev).multi_processor_count} SMs, "
          f"TILE_WAVES={kernels.banded.TILE_WAVES}")
    for k in (1, 33, 34, 64, 901):
        Rk = R[..., :k].contiguous()
        ref = kernels.bt_trsv_blocks_plain(Pf, Rk)
        scale = float(ref.abs().max())
        line = f"k={k}: wrapper {cs.cuda_ms(lambda: kernels.bt_trsv_blocks(Pf, Rk), 3, 1):.3f} ms"
        for tiles in (0, 1):
            out = torch.empty_like(Rk)
            work = Pf.new_empty(B * k, K * s) if not tiles and K * s * Pf.element_size() > SMEM_MAX else None

            def run():
                code = _fn("tg_bt_trsv_blocks", Pf.dtype)(
                    Pf.data_ptr(), K, s, Rk.data_ptr(), out.data_ptr(), k, B,
                    None if work is None else work.data_ptr(), tiles, _stream(Pf))
                build.check(code, "bt_trsv_blocks", f" at k={k} tiles={tiles}")

            ms = cs.cuda_ms(run, 3, 1)
            line += (f"; {'tiles' if tiles else 'per column'} {ms:.3f} ms "
                     f"(err {float((out - ref).abs().max()) / scale:.1e})")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
