#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 15 (the mesh layer, four ranks sharing
one card over gloo) alone:

    python3 mesh_phase.py

It builds the kernels, then runs the phase's gates and prints its lines,
its seconds and the card's ``name, power.limit``; it exits non-zero if a
gate fails.  The phase spawns four ranks, so this file keeps its work
under the ``__main__`` guard.
"""
from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    import chip_smoke as S
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        S.fail("mesh_phase.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.ensure_built()
    t0 = time.perf_counter()
    print(S.mesh_phase())
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    print(S.smi_line())


if __name__ == "__main__":
    main()
