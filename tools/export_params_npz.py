"""Export a trained checkpoint's eval weights as a flat ``.npz``.

Reads an orbax checkpoint written by ``train.py`` with
``vrdone_tpu.train.checkpoint.restore_params_for_eval`` (EMA weights when
present, as ``eval.py`` does) and writes the flax parameter tree flattened
to ``/``-joined keys, e.g. ``backbone/stem_0/attn/query/kernel``. The
PyTorch port reads that file (``vrdone_tpu_torch.convert.load_npz``,
``eval_torch.py --ckpt_path``), so weights cross frameworks without the
port importing JAX or orbax.

    python tools/export_params_npz.py --ckpt_path exp/model_last.ckpt \
        --out exp/model_last.npz
"""

from __future__ import annotations

import argparse

import numpy as np


def flatten_params(tree) -> dict[str, np.ndarray]:
    """Nested param dict -> {"a/b/kernel": array}."""
    out = {}

    def walk(prefix, node):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            out[prefix] = np.asarray(node)

    walk("", tree)
    return out


def export(ckpt_path: str, out_path: str) -> dict[str, np.ndarray]:
    from vrdone_tpu.train.checkpoint import restore_params_for_eval
    flat = flatten_params(restore_params_for_eval(ckpt_path, None))
    np.savez(out_path, **flat)
    return flat


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_path", required=True,
                   help="orbax checkpoint directory written by train.py")
    p.add_argument("--out", required=True, help="output .npz path")
    args = p.parse_args()
    flat = export(args.ckpt_path, args.out)
    print(f"wrote {len(flat)} arrays to {args.out}")


if __name__ == "__main__":
    main()
