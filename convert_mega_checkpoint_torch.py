"""Convert a reference MEGA detector checkpoint (mega_core, ``.pth``) into
the flat ``.npz`` of flax-keyed parameters that ``detect_torch.py
--ckpt_path`` reads.

The counterpart of ``tools/convert_mega_checkpoint.py`` on
``vrdone_tpu_torch`` (``convert_mega.py``, its copy of the conversion): the
same flags and the same tree (a flattened-crop fc0 is folded over its
spatial taps, with a warning on stderr), written as an ``.npz`` instead of
an orbax directory. It imports nothing of ``vrdone_tpu``.

    python convert_mega_checkpoint_torch.py --mega_ckpt MEGA_R_101.pth \
        --out mega_params.npz
    python detect_torch.py --frames_dir <dir> --out_dir <dir> \
        --ckpt_path mega_params.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from vrdone_tpu_torch.convert_mega import load_mega_params


def convert(mega_ckpt: str, out: str, groups: int = 16
            ) -> dict[str, np.ndarray]:
    """Convert ``mega_ckpt`` and write the parameters to ``out`` (an
    ``.npz``; ``np.savez`` adds the suffix when it is missing). Returns
    them, flattened."""
    flat = load_mega_params(mega_ckpt, groups=groups)
    np.savez(out, **flat)
    return flat


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mega_ckpt", required=True,
                   help="mega_core checkpoint (.pth, {'model': sd} or raw)")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--groups", type=int, default=16,
                   help="MEGA attention groups (reference "
                        "ATTENTION.GROUP default 16)")
    args = p.parse_args(argv)
    flat = convert(args.mega_ckpt, args.out, groups=args.groups)
    print(f"wrote {len(flat)} arrays to {args.out}")


if __name__ == "__main__":
    main()
