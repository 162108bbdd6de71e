#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 8 (SUMMA on one card) alone, with its
grid solves at operator edge N (default ``chip_smoke.SUMMA_SOLVE_N``):

    python3 summa_phase.py [N]

It builds the kernels, then runs the phase's gates and prints its lines
and the card's ``name, power.limit``; it exits non-zero if a gate fails.
The phase spawns four ranks, so this file keeps its work under the
``__main__`` guard.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    import chip_smoke as S
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        S.fail("summa_phase.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) > 1:
        S.SUMMA_SOLVE_N = int(sys.argv[1])
    ops.ensure_built()
    out = S.summa_phase(torch.Generator(device=S.DEVICE).manual_seed(88))
    print({k: v for k, v in out.items() if k != "panel"})
    print(S.smi_line())


if __name__ == "__main__":
    main()
