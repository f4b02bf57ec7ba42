"""Convert a torchvision ResNet ``.pth`` into the ``{"c4": ..., "c5": ...}``
pickle that seeds detector training (the counterpart of
``tools/convert_torch_resnet.py``, with the same flags and the same
output): ``train_detector_torch.py --backbone_pkl`` and
``tools/train_detector.py --backbone_pkl`` both read it.

    python convert_torch_resnet_torch.py --torch_ckpt resnet101.pth \
        --out r101.pkl [--layers 3,4,23,3]
"""

from __future__ import annotations

import argparse
import pickle

import torch

from vrdone_tpu_torch.convert_resnet import convert


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--torch_ckpt", required=True,
                   help=".pth state dict (torchvision resnet naming)")
    p.add_argument("--out", required=True, help="output pickle")
    p.add_argument("--layers", default="3,4,23,3")
    args = p.parse_args()

    sd = torch.load(args.torch_ckpt, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v.numpy() for k, v in sd.items()
          if hasattr(v, "numpy")}
    layers = tuple(int(x) for x in args.layers.split(","))
    out = convert(sd, layers)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
