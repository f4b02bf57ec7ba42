"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip where no CUDA device is present. Run
them on a machine with a card (this file imports neither JAX nor the JAX
package, so the repository's JAX conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerance 2e-5 in fp32 with TF32 off: the kernel and cuBLAS sum the same
products in different orders.
"""

import numpy as np
import pytest
import torch

from vrdone_tpu_torch.config import ModelConfig, PredictorConfig
from vrdone_tpu_torch.models.layers import AffineDropPath
from vrdone_tpu_torch.models.maskvrd import MaskVRD
from vrdone_tpu_torch.ops import band_attention as ba
from vrdone_tpu_torch.ops import full_attention as fa

pytestmark = pytest.mark.cuda

TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def streams(seed, b, tq, tk, c, lens, device):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, c)).astype(np.float32)
    k = rng.standard_normal((b, tk, c)).astype(np.float32)
    v = rng.standard_normal((b, tk, c)).astype(np.float32)
    mask = np.arange(tk)[None] < np.asarray(lens)[:, None]
    return [torch.from_numpy(a).to(device) for a in (q, k, v, mask)]


def max_err(a, b):
    return (a - b).abs().max().item()


@pytest.mark.parametrize("t,w,d", [
    (96, 3, 128), (48, 3, 128), (24, 3, 128), (12, 3, 128), (768, 3, 128),
    (300, 4, 64), (37, 9, 32), (5, 3, 128), (3, 9, 16), (1, 3, 8),
    (100, 15, 256), (64, 0, 64)])
def test_band_kernel_matches_plain(cuda, t, w, d):
    """Slice shapes (d 128, w 3), T off the 16-row tile, T < 2w + 1, the
    widest band and head dim the kernel takes, and w = 0."""
    b, h = 4, 4
    q, k, v, mask = streams(t * 31 + w, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0], cuda)
    mask[0, t // 3] = False  # an invalid key inside a valid stretch
    before = ba.launches
    out = ba.band_attention_cuda(q, k, v, mask, n_head=h,
                                 window_size=2 * w + 1)
    torch.cuda.synchronize()
    assert ba.launches == before + 1
    ref = ba.band_attention_plain(q, k, v, mask, n_head=h,
                                  window_size=2 * w + 1)
    assert max_err(out, ref) <= TOL
    assert (out[3] == 0).all()  # no valid query (and no valid key)


@pytest.mark.parametrize("tq,tk,d", [
    (96, 96, 128), (96, 96, 64), (9, 9, 64), (9, 12, 64), (384, 384, 128),
    (384, 384, 64), (5, 100, 32), (40, 33, 256), (1, 1, 8)])
def test_full_kernel_matches_plain(cuda, tq, tk, d):
    """Slice shapes, Tq != Tk, Tk off the 32-key tile, and a batch row with
    no valid key, which both versions write as 0."""
    b, h = 4, 4
    q, k, v, mask = streams(tq * 7 + tk, b, tq, tk, h * d,
                            [tk, max(1, tk // 3), 1, 0], cuda)
    before = fa.launches
    out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.full_attention_plain(q, k, v, mask, n_head=h)
    assert torch.isfinite(out).all()
    assert max_err(out, ref) <= TOL
    assert (out[3] == 0).all()


def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, mask = streams(0, 2, 16, 16, 64, [16, 8], cuda)
    with pytest.raises(TypeError, match="float32"):
        ba.band_attention_cuda(q.double(), k, v, mask, n_head=4,
                               window_size=7)
    with pytest.raises(ValueError, match="contiguous"):
        fa.full_attention_cuda(q.transpose(0, 1), k, v, mask, n_head=4)
    with pytest.raises(ValueError, match="half window"):
        ba.band_attention_cuda(q, k, v, mask, n_head=4, window_size=33)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.full_attention_cuda(q, k, v, mask.cpu(), n_head=4)


def test_model_forward_on_card_matches_cpu(cuda):
    """A small MaskVRD: the CUDA forward (through both kernels) against the
    CPU forward (plain versions) on the same weights, and the launches."""
    cfg = ModelConfig(visual_dim=24, embd_dim=32, fpn_dim=16,
                      max_seq_len=48, predictor=PredictorConfig(
                          n_input=32, n_embd=16, n_hidden=64, num_layers=3))
    gen = torch.Generator().manual_seed(0)
    cpu = MaskVRD(cfg, device=torch.device("cpu"), generator=gen)
    with torch.no_grad():
        # drop-path scales near 1, so every attention branch moves the
        # output (the 1e-4 of the reference init would hide one)
        for m in cpu.modules():
            if isinstance(m, AffineDropPath):
                m.scale.uniform_(0.5, 1.5, generator=gen)
    gpu = MaskVRD(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (3, 48, 2 * 24 + 5 + 16)).astype(np.float32))
    mask = torch.from_numpy(np.arange(48)[None]
                            < np.array([48, 24, 11])[:, None])
    ba.launches = fa.launches = 0
    with torch.no_grad():
        out = gpu(x.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
        # band: 2 stem blocks x 2 streams + the branch blocks; full: self
        # and cross attention of each S/O mutual layer and decoder layer
        assert ba.launches == 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
        assert fa.launches == (4 * cfg.backbone_arch[1]
                               + 2 * cfg.predictor.num_layers)
        ref = cpu(x, mask)
    for key in ("pred_logits", "pred_masks"):
        assert max_err(out[key].cpu(), ref[key]) <= 5e-4, key
