"""Convert a reference VrdONE / VrdONE-X checkpoint (``.pth``) into the
flat ``.npz`` of flax-keyed parameters that ``eval_torch.py --ckpt_path``
reads.

The counterpart of ``tools/convert_reference_checkpoint.py`` on
``vrdone_tpu_torch`` (``convert_reference.py``, its copy of the
conversion): the same flags, the reference's ``model_state_dict_ema``
(else ``model_state_dict``) mapped key by key onto the flax parameter
names, written as ``tools/export_params_npz.py`` writes a JAX checkpoint's
parameters instead of as an orbax directory. It imports nothing of
``vrdone_tpu``.

    python convert_reference_checkpoint_torch.py \
        --torch_ckpt model_epoch_15_vidvrd.pth --out vidvrd_params.npz
    python eval_torch.py --data_name vidvrd --cfg_path configs/vidvrd.yaml \
        --exp_dir exp --ckpt_path vidvrd_params.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from vrdone_tpu_torch.convert_reference import load_reference_params


def convert(torch_ckpt: str, out: str) -> dict[str, np.ndarray]:
    """Convert ``torch_ckpt`` (its EMA weights where it holds them) and
    write the parameters to ``out`` (an ``.npz``; ``np.savez`` adds the
    suffix when it is missing). Returns them, flattened."""
    flat = load_reference_params(torch_ckpt)
    np.savez(out, **flat)
    return flat


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out", required=True, help="output .npz path")
    # accepted so that command lines written for the JAX tool still run;
    # as there, it is on whether given or not: the EMA weights are taken
    # wherever the checkpoint holds them
    p.add_argument("--use_ema", action="store_true", default=True,
                   help="always on (kept for the JAX tool's command lines)")
    args = p.parse_args(argv)
    flat = convert(args.torch_ckpt, args.out)
    print(f"wrote {len(flat)} arrays to {args.out}")


if __name__ == "__main__":
    main()
