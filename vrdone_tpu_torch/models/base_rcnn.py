"""The plain single-frame Faster R-CNN, the "base" video method
(counterpart of ``vrdone_tpu/models/base_rcnn.py``): ResNet-C4 -> RPN ->
RoIAlign -> C5 -> the two-FC head, on each frame alone. It is the baseline
every video method is measured against."""

from __future__ import annotations

import torch

from ..utils.precision import compute_dtype as dtype_of
from .detector import _cast, frames_on, stack_outputs
from .flownet import TwoFCDetector

Tensor = torch.Tensor


class BaseDetector(TwoFCDetector):
    """The base detector under the flax names ``backbone``, ``rpn``, ``c5``,
    ``head``."""

    def __init__(self, num_classes: int, resnet_layers=(3, 4, 23),
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__(num_classes, resnet_layers, stride_in_1x1,
                         device=device, generator=generator)
        self.eval()

    def detect_frame(self, image: Tensor, image_hw, *,
                     post_nms_top_n: int = 300,
                     compute_dtype: torch.dtype = torch.float32) -> dict:
        """image (H, W, 3) raw BGR pixels (uint8 fine; cast on the
        device)."""
        return self.detect_on(self.features(image[None], compute_dtype),
                              image_hw, post_nms_top_n=post_nms_top_n)


@torch.no_grad()
def base_detect_video(det: BaseDetector, images, image_hw, *,
                      post_nms_top_n: int = 300,
                      compute_dtype: str = "float32") -> dict:
    """Each frame detected alone (the base method has no temporal state).
    ``compute_dtype="bfloat16"`` runs the backbone and the RoI pass on a
    bf16 copy of the detector; box decode, NMS and the outputs stay fp32.
    Returns numpy arrays stacked over frames: proposals (T, P, 4),
    proposal_scores, valid, cls_logits (T, P, K+1), bbox_deltas."""
    dt = dtype_of(compute_dtype)
    cdet = _cast(det, dt)
    imgs = frames_on(images, det.device)
    return stack_outputs([cdet.detect_frame(img, image_hw,
                                            post_nms_top_n=post_nms_top_n,
                                            compute_dtype=dt)
                          for img in imgs])
