#!/usr/bin/env python3
"""K1 (PnP) kernel and wrapper times on ``chip_smoke.py``'s PnP problem,
for one or more checkouts of this repository, on one CUDA card.

    python tools/time_pnp.py [ROOT ...] [--reps 20]

Each ROOT (default: this checkout) runs in a process of its own that
imports that checkout's ``vio360_tpu_torch`` and builds its kernels
there. The problem (M = 1024) and the timers are this checkout's:
``chip_smoke.pnp_problem``, ``chip_smoke.device_ms`` (median device
time of one ``pnp_kernel`` launch, torch.profiler) and
``chip_smoke.timed_ms`` (median CUDA-event time around ``pnp_solve``,
host work of the wrapper included). To compare two checkouts, give them
in mirrored order (A B B A) so drift between runs shows. Prints one JSON
line per root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _child(root: str, reps: int) -> None:
    sys.path.insert(0, str(HERE))
    import chip_smoke

    sys.path.insert(0, str(Path(root).resolve()))  # this root's vio360_tpu_torch comes first
    import torch

    from vio360_tpu_torch import device as device_mod
    from vio360_tpu_torch.solver import ba_cuda

    device_mod.pin_fp32()
    dev = torch.device("cuda:0")
    args = chip_smoke.pnp_problem(dev)
    out = ba_cuda.pnp_solve(*args)
    kernel = chip_smoke.device_ms(lambda: ba_cuda.pnp_solve(*args), "pnp_kernel", reps)
    wrapper = chip_smoke.timed_ms(lambda: ba_cuda.pnp_solve(*args), reps)
    print(json.dumps({"root": root, "package": str(Path(ba_cuda.__file__).resolve()),
                      "kernel_ms": kernel, "wrapper_ms": wrapper, "inliers": int(out[4]),
                      "t": [float(x) for x in out[1]]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[str(HERE)])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        _child(a.child, a.reps)
        return 0
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True)
    for root in a.roots:
        subprocess.run([sys.executable, __file__, "--child", root, "--reps", str(a.reps)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
