"""CPU drive of the reference-parity CLI surface (the /verify recipe).

Writes a 2-camera scene in the reference's on-disk format (OpenCV
FileStorage YAML config + calib + PNG images/masks, `CManageData.cpp:
26-66`), runs `python -m reconstruction_tpu config.yml` in-process on
the CPU backend, and checks the output PLY against the analytic surface
(chip_smoke.cli_check, the same check chip_smoke.py runs on the card).

Usage:  python tools/verify_cli.py [workdir]
Exit 0 = pipeline ran and interior RMSE < 0.25.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def main(workdir: str) -> int:
    import chip_smoke
    os.makedirs(workdir, exist_ok=True)
    print(f"[verify_cli] {chip_smoke.cli_check(workdir)} -> OK")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        sys.exit(main(sys.argv[1]))
    with tempfile.TemporaryDirectory() as wd:
        sys.exit(main(wd))
