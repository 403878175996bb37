#!/usr/bin/env python3
"""The LM phases of ``chip_smoke.py`` alone, on one card.

    python3 scripts/lm_card.py [PHASE ...]

PHASE is any of ``lm_record``, ``lm_full_width``, ``lm_serve``,
``lm_train_record``, ``lm_train_full_width``, ``lm_train``,
``lm_train_mesh``, ``lm_train_mesh_ssm`` and ``lm_serve_mesh`` (default:
all, in that order).  Each prints the JSON
lines ``chip_smoke.py`` prints
for it and fails as it does; the SPCA phases and the kernel table are not
run, so no kernel is built.  Then the card's name and power limit.
Exits non-zero without a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("lm_record", "lm_full_width", "lm_serve", "lm_train_record",
          "lm_train_full_width", "lm_train", "lm_train_mesh",
          "lm_train_mesh_ssm", "lm_serve_mesh")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("lm_card: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke

    names = argv or PHASES
    unknown = set(names) - set(PHASES)
    if unknown:
        print(f"lm_card: unknown phases {sorted(unknown)}; pick from "
              f"{PHASES}", file=sys.stderr)
        return 2
    for name in names:
        getattr(chip_smoke, f"phase_{name}")()
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
