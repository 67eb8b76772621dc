#!/usr/bin/env python3
"""K1 (PnP) and K4 (per-feature LK) kernel and wrapper times on
``chip_smoke.py``'s problems, for one or more checkouts of this
repository, on one CUDA card.

    python tools/time_kernels.py [ROOT ...] [--reps 20]

Each ROOT (default: this checkout) runs in a process of its own that
imports that checkout's ``vio360_tpu_torch`` and builds its kernels
there. The problems and the timers are this checkout's:
``chip_smoke.pnp_problem`` (M = 1024) and ``chip_smoke.lk_problem``
(960x480, N = 1024, 4 and 3 levels); ``chip_smoke.device_ms`` (median
device time of one ``pnp_kernel`` / ``lk_kernel`` launch, torch.profiler;
K4 on buffers ``lk_cuda.prepare`` made once) and ``chip_smoke.timed_ms``
(median CUDA-event time around ``pnp_solve`` / ``lk_cuda.track``, host
work of the wrapper included). To compare two checkouts, give them in
mirrored order (A B B A) so drift between runs shows. Prints one JSON
line per root; ``pnp_sha`` is a digest of K1's outputs on the PnP
problem, so equal digests mean the checkouts' K1 return the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
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
    from vio360_tpu_torch.ops import lk_cuda
    from vio360_tpu_torch.solver import ba_cuda

    device_mod.pin_fp32()
    dev = torch.device("cuda:0")
    args = chip_smoke.pnp_problem(dev)
    out = ba_cuda.pnp_solve(*args)
    digest = hashlib.sha256(b"".join(x.detach().cpu().numpy().tobytes() for x in out)).hexdigest()
    rec = {"root": root, "package": str(Path(ba_cuda.__file__).resolve().parent.parent),
           "pnp_sha": digest[:16],
           "pnp_kernel_ms": chip_smoke.device_ms(lambda: ba_cuda.pnp_solve(*args), "pnp_kernel", reps),
           "pnp_wrapper_ms": chip_smoke.timed_ms(lambda: ba_cuda.pnp_solve(*args), reps),
           "pnp_inliers": int(out[4])}
    img0, img1, uv, valid = chip_smoke.lk_problem(dev)
    for num_levels in (3, 2):
        lk_args = (img0, img1, uv, valid, None, num_levels, 10, 30, 0.01)
        prep = lk_cuda.prepare(*lk_args[:6])
        tag = f"lk{num_levels + 1}"
        rec[f"{tag}_kernel_ms"] = chip_smoke.device_ms(lambda: lk_cuda.launch(prep, 10, 30, 0.01),
                                                       "lk_kernel", reps)
        rec[f"{tag}_wrapper_ms"] = chip_smoke.timed_ms(lambda: lk_cuda.track(*lk_args), reps)
        rec[f"{tag}_tracked"] = int(lk_cuda.track(*lk_args)[1].sum())
    print(json.dumps(rec), flush=True)


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
    failed = [root for root in a.roots if subprocess.run(
        [sys.executable, __file__, "--child", root, "--reps", str(a.reps)]).returncode != 0]
    if failed:
        print(f"error: timing failed for {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
